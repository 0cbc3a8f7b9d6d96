"""Monotone optimization-based limiter (HOMME "limiter 8") and helpers.

Branch-free, batched re-formulation of the reference iterative
clip-and-redistribute QP limiter (reference:
prim_advection_mod.F90:976 `limiter_optim_iter_full`; documented in
Guba, Taylor & St-Cyr, JCP 2014).  Semantics preserved exactly:

* bounds are first *relaxed* so the constrained problem is feasible
  (:1024-1029) — and the relaxed bounds are returned, because the reference
  passes qmin/qmax by reference and later RK stages see the relaxation;
* each iteration clips to [minp, maxp], accumulating the clipped mass
  `addmass`; if |addmass| <= tol*|mass| the loop exits *after the clip*;
  otherwise addmass is redistributed equally (weighted by c) over the
  non-saturated points (:1033-1081);
* at most np*np-1 = 15 iterations (or a smaller f32 cap, config.py
  limiter_iter_cap); if unconverged the result is the final
  redistribution (no trailing clip), exactly like the Fortran loop.

The batch formulation freezes converged rows with masks and runs a
`lax.while_loop` until every row in the batch is converged (or 15
iterations), which avoids paying for the worst case when the typical case
converges in 1-2 iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

TOL_LIMITER = 5e-14
MAX_ITER = 15  # np*np - 1


def limiter_optim_iter_full(ptens, sphweights, minp, maxp, dpmass,
                            chunks: int = 0, max_iter: int = 0):
    """Apply the limiter to Q = ptens/dpmass with weights sphweights*dpmass.

    Args:
      ptens:      [..., n2]  tracer mass (will be limited, mass-preserving)
      sphweights: [..., n2]  spectral element weights (spheremp)
      minp, maxp: [...]      bounds (relaxed in-place semantics: returned)
      dpmass:     [..., n2]  pseudo-density
      chunks:     split the flattened batch into this many groups, each
                  with its own convergence loop (`lax.map`), so one slow
                  column stalls only its group instead of the whole batch
                  (the global while_loop otherwise re-streams every row
                  per iteration — the dominant f64/CPU verification cost).
                  0/1 = single loop.  Results are identical either way
                  (per-row math is independent).
      max_iter:   iteration cap (0 = MAX_ITER, the reference's np*np-1).

    Returns (ptens_out, minp_out, maxp_out).
    """
    core = functools.partial(_limiter_core, max_iter=max_iter or MAX_ITER)
    batch = 1
    for s in ptens.shape[:-1]:
        batch *= s
    if chunks > 1 and batch % chunks == 0 and batch // chunks >= 1:
        n2 = ptens.shape[-1]
        bshape = ptens.shape[:-1]
        r2 = lambda a: a.reshape(chunks, batch // chunks, n2)
        r1 = lambda a: a.reshape(chunks, batch // chunks)
        out, mn, mx = jax.lax.map(
            lambda t: core(*t),
            (r2(ptens), r2(sphweights), r1(minp), r1(maxp), r2(dpmass)))
        return (out.reshape(ptens.shape), mn.reshape(bshape),
                mx.reshape(bshape))
    return core(ptens, sphweights, minp, maxp, dpmass)


def _limiter_core(ptens, sphweights, minp, maxp, dpmass, max_iter):
    c = sphweights * dpmass
    x = ptens / dpmass
    sumc = jnp.sum(c, axis=-1)
    mass = jnp.sum(c * x, axis=-1)

    # degenerate guard (sumc <= 0 "should never happen": skip limiting)
    valid = sumc > 0
    safe_sumc = jnp.where(valid, sumc, 1.0)

    # relax constraints for feasibility; relaxation persists (returned)
    minp = jnp.where(mass < minp * safe_sumc, mass / safe_sumc, minp)
    maxp = jnp.where(mass > maxp * safe_sumc, mass / safe_sumc, maxp)

    tol = TOL_LIMITER * jnp.abs(mass)
    lo = minp[..., None]
    hi = maxp[..., None]

    def body(state):
        it, x, done = state
        over = x > hi
        under = x < lo
        addmass = jnp.sum(jnp.where(over, (x - hi) * c, 0.0)
                          + jnp.where(under, (x - lo) * c, 0.0), axis=-1)
        xcl = jnp.clip(x, lo, hi)
        conv = jnp.abs(addmass) <= tol

        pos = addmass > 0
        free = jnp.where(pos[..., None], xcl < hi, xcl > lo)
        wsum = jnp.sum(jnp.where(free, c, 0.0), axis=-1)
        add = jnp.where(wsum > 0, addmass / jnp.where(wsum > 0, wsum, 1.0),
                        0.0)
        xred = xcl + jnp.where(free, add[..., None], 0.0)

        x_next = jnp.where(done[..., None], x,
                           jnp.where(conv[..., None], xcl, xred))
        return it + 1, x_next, done | conv

    def cond(state):
        it, _, done = state
        return (it < max_iter) & ~jnp.all(done)

    done0 = ~valid  # degenerate rows keep their input
    _, x, _ = jax.lax.while_loop(cond, body, (0, x, done0))

    ptens_out = jnp.where(valid[..., None], x * dpmass, ptens)
    return ptens_out, minp, maxp


def limiter2d_minmax(qdp, dp, spheremp, qmin, qmax):
    """Mass-conserving min/max limiter over each element level
    (prim_advection_mod.F90:1100 `limiter2d_minmax`, limiter_option 4).

    Defined-but-uncalled in the reference's shipped CPU euler_step (only
    option 8 dispatches there, :858); provided for capability parity.

    Args: qdp/dp/spheremp [..., n2]; qmin/qmax [...].
    Returns limited qdp (same total mass per level).
    """
    c = dp * spheremp
    q = qdp / dp
    mass = jnp.sum(qdp * spheremp, axis=-1)
    area = jnp.sum(c, axis=-1)

    def one_pass(q, bound, excess_mass, toward_bound):
        """Shared clip-and-rescale: toward_bound=+1 applies the max pass
        on (bound - q), -1 the min pass on (q - bound)."""
        work = toward_bound * (bound[..., None] - q)
        s = jnp.where(excess_mass < 0, -1.0, 1.0)
        w = work * s[..., None]
        wpos = jnp.maximum(w, 0.0)
        mass_new = jnp.sum(wpos * c, axis=-1)
        scale = jnp.where(mass_new > 0,
                          jnp.abs(excess_mass)
                          / jnp.where(mass_new > 0, mass_new, 1.0), 1.0)
        w = wpos * scale[..., None] * s[..., None]
        return bound[..., None] - toward_bound * w

    # max pass (original mass; the pass itself conserves it)
    over = q.max(axis=-1) > qmax
    q = jnp.where(over[..., None],
                  one_pass(q, qmax, area * qmax - mass, 1.0), q)
    # min pass reads the updated q but the top-of-routine mass (:1159)
    under = q.min(axis=-1) < qmin
    q = jnp.where(under[..., None],
                  one_pass(q, qmin, mass - area * qmin, -1.0), q)
    return q * dp


def limiter2d_zero(qdp_weighted):
    """Mass-conserving zero limiter over each element level
    (prim_advection_mod.F90:1188 `limiter2d_zero`).  Input is spheremp*Qdp
    flattened over the element, [..., n2]."""
    q = qdp_weighted
    mass = jnp.sum(q, axis=-1, keepdims=True)
    sgn = jnp.where(mass < 0, -1.0, 1.0)
    q = q * sgn
    qpos = jnp.maximum(q, 0.0)
    mass_new = jnp.sum(qpos, axis=-1, keepdims=True)
    scale = jnp.where(mass_new > 0, jnp.abs(mass) / jnp.where(mass_new > 0,
                                                              mass_new, 1.0),
                      0.0)
    return qpos * scale * sgn
