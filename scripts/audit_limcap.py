"""Audit the limiter_iter_cap knob: conservation + drift + overshoot + speed.

Runs the NE8 perf config (35 tracers, 72L, f32) for N subcycles at
several limiter iteration caps and reports, per cap:
  * per-tracer mass drift (gate: must stay at the f32 pipeline's own
    documented ~1e-4 level — any cap is mass-preserving by construction,
    every loop exit redistributes the clip residual)
  * max relative field difference vs the full-iteration run (the bound
    overshoot on columns that had not converged when the cap hit)
  * global tracer extrema (a cap can only widen them; the widening IS the
    overshoot, in physical units)
  * wall time of the window (ended by block_until_ready)
"""
import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import time
import jax, jax.numpy as jnp
import numpy as np
from transport_se_tpu.config import perf_config
from transport_se_tpu.model.core import (build_model, initial_qdp,
                                         make_subcycle_fn)

NSUB = int(os.environ.get("AUDIT_SUBCYCLES", "16"))
NE = int(os.environ.get("AUDIT_NE", "8"))
CAPS = [int(c) for c in os.environ.get("AUDIT_CAPS", "0,6,4,3,2").split(",")]


def run(cap):
    cfg = perf_config(NE, dtype="f32", limiter_iter_cap=cap)
    m = build_model(cfg)
    step = jax.jit(make_subcycle_fn(m, diagnostics=False))
    Qdp = jax.jit(lambda: initial_qdp(m))()
    sp = np.asarray(m.spheremp, np.float64)

    def mass(Q):
        return np.einsum("eqkij,eij->q", np.asarray(Q, np.float64), sp)

    nstep = jnp.asarray(0, jnp.int32)
    jax.block_until_ready(step(Qdp, nstep))        # compile
    m0 = mass(Qdp)
    t0 = time.perf_counter()
    Q = Qdp
    for _i in range(NSUB):
        Q, ps, nstep, _ = step(Q, nstep)
    jax.block_until_ready(Q)
    wall = time.perf_counter() - t0
    m1 = mass(Q)
    drift = np.abs(m1 - m0) / np.abs(m0)
    dp0 = np.asarray(m.dp0col, np.float64)
    q = np.asarray(Q, np.float64) / dp0[None, None, :, None, None]
    return np.asarray(Q, np.float64), drift, wall, q.min(), q.max()


ref = None
print(f"subcycles={NSUB} ne={NE}")
ok = True
for cap in CAPS:
    Q, drift, wall, qmn, qmx = run(cap)
    if ref is None:
        ref = Q
        rel = 0.0
    else:
        rel = np.abs(Q - ref).max() / np.abs(ref).max()
    label = cap if cap else "full(15)"
    print(f"cap={label:>8}: mass drift {drift.max():.3e}  "
          f"field rel diff vs full {rel:.3e}  "
          f"q in [{qmn:+.6e}, {qmx:.6f}]  wall {wall:.2f}s", flush=True)
    ok = ok and drift.max() < 2e-4
print("AUDIT", "PASS" if ok else "FAIL")
sys.exit(0 if ok else 1)
