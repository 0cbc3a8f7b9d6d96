"""Reproducible global sums — the reference repro_sum, on device.

The reference computes diagnostic global integrals with fixed-point
integer accumulation so the result is bit-for-bit identical across MPI
task and thread counts (reference: repro_sum_mod.F90:1-80 header,
global_norms_mod.F90:39 wiring).  This module gives the same guarantee —
strengthened to cross-PLATFORM bit-identity — by the same mechanism:

1. every addend is converted POINTWISE to a stack of integer windows
   (floor of the value scaled by a power of two — IEEE-exact operations,
   identical on any machine),
2. the windows are summed in int64 — integer addition is associative and
   exact, so ANY summation order, sharding, psum topology, or platform
   gives the same bits,
3. the windowed totals are reconstructed into an f64 in a fixed order.

Truncation below the last window is pointwise (step 1), so determinism
never depends on the window count; accuracy does.  With the default
4 x 32-bit windows the representation carries 128 bits below the column
maximum — far past f64's 53 — so the result lands within ~2 ulp of the
correctly-rounded sum (the final f64 reconstruction of the window totals
rounds once per window; verified against math.fsum in
tests/test_repro_sum.py, including adversarial cancellation).  The
reproducibility guarantee is unconditional; the ulp bound is the
accuracy statement.

Overflow headroom: each window value is < 2^32 in magnitude, so an int64
accumulator absorbs 2^31 addends — covers NE120's 8.6e9 gridpoint-tracer
column sums with element-axis partials to spare.

Requires x64 (int64/f64); the f32 perf path keeps the plain XLA
reduction (diagnostics are off there anyway).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

_WIDTH = 32
_NLEVELS = 4


def repro_sum(x, axis=None, nlevels: int = _NLEVELS):
    """Order-, sharding-, and platform-independent sum of an f64 array.

    Usable inside jit / shard_map (all jnp ops).  Returns f64 of the
    reduced shape.  Falls back to a plain sum when x64 is not enabled
    (int64 would silently truncate to int32).
    """
    x = jnp.asarray(x)
    if x.dtype != jnp.float64:
        return x.sum(axis)

    if axis is None:
        axis = tuple(range(x.ndim))
    if not isinstance(axis, tuple):
        axis = (axis,)

    # per-column scale anchor: 2^e >= max|x| (max is order-independent)
    m = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    _, e = jnp.frexp(m)                       # m = f * 2^e, f in [0.5, 1)
    e = jnp.where(m > 0, e, 0)

    e_out = jnp.squeeze(e, axis=axis)
    r = x
    S = []
    for j in range(nlevels):
        k = _WIDTH * (j + 1)
        s = jnp.ldexp(jnp.ones_like(m), k - e)          # 2^(k - e)
        q = jnp.floor(r * s)                            # |q| <= 2^WIDTH
        S.append(q.astype(jnp.int64).sum(axis=axis))    # exact, assoc.
        # r - q/s cancels r's leading bits exactly (q/s is r truncated
        # at bit k - e; the remainder's low bits are representable)
        r = r - q / s
    # carry-normalize so each window total fits f64's mantissa exactly
    # even for billions of addends (|S_j| can reach 2^32 * n)
    for j in range(nlevels - 1, 0, -1):
        carry = S[j] >> _WIDTH                          # floor shift
        S[j] = S[j] - (carry << _WIDTH)
        S[j - 1] = S[j - 1] + carry
    total = jnp.zeros(e_out.shape, jnp.float64)
    for j in range(nlevels):
        k = _WIDTH * (j + 1)
        total = total + S[j].astype(jnp.float64) \
            * jnp.ldexp(jnp.ones_like(total), e_out - k)
    return total


def repro_sum_host(x) -> float:
    """Correctly-rounded host-side sum (Shewchuk fsum) — the oracle the
    device path is tested against (also used for host-side grid
    constants)."""
    return math.fsum(np.asarray(x, np.float64).ravel().tolist())
