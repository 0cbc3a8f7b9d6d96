#!/usr/bin/env python
"""NE120 sharded-step check on a virtual CPU mesh.

Validates the north-star grid size end to end: grid + shard-plan build at
86400 elements, one remap interval through the sharded pipeline on 8
virtual devices, conservation check.  (The f32 NE120 field at 35 tracers
is ~14 GB; this check runs a reduced
vertical/tracer count to fit CPU memory while exercising the full
horizontal scale.)

Usage: python scripts/ne120_sharded_check.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp
import numpy as np

from transport_se_tpu.config import Config
from transport_se_tpu.model.core import build_model, initial_qdp
from transport_se_tpu.parallel.sharded import make_mesh, make_sharded_subcycle


def main():
    t0 = time.time()
    cfg = Config(ne=120, nlev=16, qsize=3, tstep=75.0, vcoord="dcmip16",
                 test_case="dcmip1-2", nu_q=1e13, nmax=3, dtype="f32")
    m = build_model(cfg)
    print(f"grid+model build: {time.time()-t0:.1f}s "
          f"(E={m.grid.nelem})", flush=True)

    t0 = time.time()
    mesh = make_mesh()
    runner = make_sharded_subcycle(m, mesh)
    print(f"shard plan ({mesh.devices.size} shards): "
          f"{time.time()-t0:.1f}s, nrounds={runner.plan.nrounds}, "
          f"nhalo={runner.plan.nhalo}", flush=True)

    t0 = time.time()
    Qdp0 = runner.shard_qdp(jax.jit(lambda: initial_qdp(m))())
    Qdp, ps_v, nstep, min_dp = runner.step(Qdp0, jnp.asarray(0, jnp.int32))
    jax.block_until_ready(Qdp)
    print(f"1 remap interval: {time.time()-t0:.1f}s", flush=True)

    sp = m.spheremp
    mass0 = np.asarray((Qdp0 * sp[:, None, None]).sum(axis=(0, 2, 3, 4)))
    mass1 = np.asarray((Qdp * sp[:, None, None]).sum(axis=(0, 2, 3, 4)))
    rel = np.abs(mass1 - mass0) / np.abs(mass0)
    assert float(min_dp) > 0, "health check failed"
    assert rel.max() < 1e-5, f"mass drift {rel.max()}"
    print(f"NE120 sharded check OK: mass drift {rel.max():.2e}, "
          f"min_dp/margin {float(min_dp):.1f} Pa")


if __name__ == "__main__":
    main()
