#!/usr/bin/env python
"""One-GPU NE120 DCMIP1-2 norm check (64L, reduced tracers, f32).

A lean stepping loop (no driver conveniences); validates the north-star horizontal resolution end to end
against the published norms (README:148: 0.0363/0.0987/0.2775, q_max
0.9941).  Not yet run on a GPU.
"""
import gc
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
import jax, jax.numpy as jnp
import numpy as np
from transport_se_tpu.config import Config
from transport_se_tpu.model.core import (build_model, initial_qdp,
                                         make_subcycle_fn)
from transport_se_tpu.norms import dcmip_error_norms, grade_tracer, unique_columns
from transport_se_tpu.constants import SCALE_HEIGHT

TEST = os.environ.get("NE120_TEST", "dcmip1-2")
NDAYS = int(os.environ.get("NE120_DAYS", "1"))  # 1-1's period is 12
cfg = Config(ne=120, nlev=64, qsize=2, tstep=75.0, ndays=NDAYS, nu_q=1e13,
             test_case=TEST, dtype="f32", vcoord="dcmip64",
             dss_mode="face", elem_order="raster", disable_diagnostics=True)
m = build_model(cfg)
step = jax.jit(make_subcycle_fn(m, diagnostics=False), donate_argnums=0)
q0_host = None

Qdp = jax.jit(lambda: initial_qdp(m))()
q0_host = np.asarray(Qdp) / np.asarray(m.dp0col)[None, None, :, None, None]
state = Qdp
del Qdp; gc.collect()

nstep = jnp.asarray(0, jnp.int32)
t0 = time.time()
for i in range(cfg.nsteps // cfg.rsplit):
    state, ps_v, nstep, min_dp = step(state, nstep)
jax.block_until_ready(state)
print(f"run: {time.time()-t0:.1f}s  min_dp={float(min_dp):.2f}", flush=True)
assert float(min_dp) > 0

Qdp = np.asarray(state)
dp_ref = ((np.asarray(m.hyai[1:]) - np.asarray(m.hyai[:-1]))[None, :, None, None] * 1e5
          + (np.asarray(m.hybi[1:]) - np.asarray(m.hybi[:-1]))[None, :, None, None]
          * np.asarray(ps_v)[:, None])
qf = Qdp / dp_ref[:, None]
g = m.grid
tr = grade_tracer(cfg.test_case)
qi_c = unique_columns(g, q0_host, tr)
qf_c = unique_columns(g, qf, tr)
lat_col = g.lat.reshape(-1)[g.uniq_src]
zm = SCALE_HEIGHT * np.log(1.0 / np.asarray(m.etam))
print("NE120 64L:", dcmip_error_norms(qi_c, qf_c, lat_col, zm, ne=cfg.ne))
