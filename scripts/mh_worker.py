#!/usr/bin/env python
"""Multi-process worker for tests/test_multihost.py.

Usage: mh_worker.py PID NPROC PORT OUTDIR MODE
  MODE "run":    2 subcycles from the analytic IC; process 0 writes
                 mid.npy (after subcycle 1) and final.npy, canonical order.
  MODE "resume": load OUTDIR/mid.npy, run 1 subcycle, process 0 writes
                 final2.npy.

Total devices are fixed at 8 (8/NPROC per process) so the shard plan is
identical across process counts — results must be bitwise equal.
"""

import os
import sys

pid, nproc, port, outdir, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8 // nproc)
jax.config.update("jax_enable_x64", True)

from transport_se_tpu.parallel import multihost  # noqa: E402

if nproc > 1:
    multihost.init(f"localhost:{port}", num_processes=nproc, process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from transport_se_tpu.config import Config  # noqa: E402
from transport_se_tpu.model.core import build_model, initial_qdp  # noqa: E402
from transport_se_tpu.parallel.multihost import (gather_canonical,  # noqa: E402
                                                 global_mesh,
                                                 shard_qdp_multihost)
from transport_se_tpu.parallel.sharded import make_sharded_subcycle  # noqa: E402

assert jax.device_count() == 8, jax.device_count()
cfg = Config(ne=2, nlev=8, qsize=2, tstep=1200.0, vcoord="dcmip8",
             test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64")
m = build_model(cfg)
mesh = global_mesh()
runner = make_sharded_subcycle(m, mesh)

if mode == "run":
    Qdp_host = np.asarray(initial_qdp(m))
    Qdp = shard_qdp_multihost(runner, Qdp_host)
    nstep = jnp.asarray(0, jnp.int32)
    Qdp, ps, nstep, _ = runner.step(Qdp, nstep)
    mid = gather_canonical(Qdp)
    Qdp, ps, nstep, _ = runner.step(Qdp, nstep)
    fin = gather_canonical(Qdp)
    if pid == 0:
        np.save(os.path.join(outdir, "mid.npy"), mid)
        np.save(os.path.join(outdir, "final.npy"), fin)
elif mode == "resume":
    mid = np.load(os.path.join(outdir, "mid.npy"))
    Qdp = shard_qdp_multihost(runner, mid)
    Qdp, ps, nstep, _ = runner.step(Qdp, jnp.asarray(cfg.rsplit, jnp.int32))
    fin = gather_canonical(Qdp)
    if pid == 0:
        np.save(os.path.join(outdir, "final2.npy"), fin)
else:
    raise SystemExit(f"unknown mode {mode}")
print(f"[{pid}] done {mode}", flush=True)
