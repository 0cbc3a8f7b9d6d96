"""Per-round conservation gate on the DEFAULT f32 perf path.

Runs the NE8 perf config (35 tracers, 72L, f32, audited limiter cap —
exactly what bench.py exercises) over the full 12-day DCMIP1-1
horizon and asserts the per-tracer relative mass drift stays <= 2e-4
(the f32 path's documented assembly-order roundoff level, VERIFICATION.md
~9e-5) — run it after perf changes so new knobs can't silently erode
conservation.

Reference check: the "Q, Q diss" conservation column (README:38-44).
"""
import sys, os; sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import time
import jax, jax.numpy as jnp
import numpy as np
from transport_se_tpu.config import perf_config
from transport_se_tpu.model.core import (build_model, initial_qdp,
                                         make_subcycle_fn)

NE = int(os.environ.get("AUDIT_NE", "8"))
DAYS = float(os.environ.get("AUDIT_DAYS", "12"))
GATE = 2e-4

cfg = perf_config(NE, dtype="f32")
nsub = int(DAYS * 86400.0 / cfg.tstep) // cfg.rsplit
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
for _i in range(nsub):
    Q, ps, nstep, mindp = step(Q, nstep)
jax.block_until_ready(Q)
wall = time.perf_counter() - t0
assert float(mindp) >= 0.0, "health check tripped (negative dp / window)"
m1 = mass(Q)
drift = np.abs(m1 - m0) / np.abs(m0)
print(f"default f32 path: ne={NE} days={DAYS} subcycles={nsub} "
      f"(limiter_iter_cap={cfg.limiter_iter_cap})")
print(f"per-tracer relative mass drift: max {drift.max():.3e} "
      f"median {np.median(drift):.3e}   wall {wall:.1f}s")
ok = drift.max() < GATE
print(f"DRIFT GATE ({GATE:.0e})", "PASS" if ok else "FAIL")
sys.exit(0 if ok else 1)
