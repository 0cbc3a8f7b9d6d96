#!/usr/bin/env python
"""Headline benchmark: NE30 perf config (35 tracers, 72 levels, limiter 8,
hyperviscosity, diagnostics off) on one GPU, in f32 — PLUS the
NE120-shard-sized proxy (NE42: 6*42^2 = 10584 elements ~ one 8-way shard
of the NE120 production grid, run with the NE120 perf parameters
tstep=75 / nu=1e13).  Both land in the single JSON line.

The path is perf_config's own (the configuration users run).  The run
fails when JAX finds no GPU; it never falls back to the CPU.

Metric: gridpoint-tracers advanced per second =
    steps * E * 16 * nlev * qsize / wall.

vs_baseline compares against the reference's best published throughput —
the NE120 perf run on 40 Edison nodes / 960 cores: 48 steps of
86400*16*72*35 gridpoint-tracers in 42.643 s = 3.53e9 /s (BASELINE.md;
reference README:173-175, test/run_ne120_perf.sh).

Prints exactly one JSON line, with the device it ran on.
"""

import json
import os
import subprocess
import sys
import time

NE = int(os.environ.get("BENCH_NE", "30"))
QSIZE = int(os.environ.get("BENCH_QSIZE", "35"))
SUBCYCLES = int(os.environ.get("BENCH_SUBCYCLES", "24"))
# NE120-shard-sized proxy row (skippable for quick iteration)
PROXY = os.environ.get("BENCH_PROXY", "1") not in ("0", "", "off")
BASELINE = 3.53e9  # gridpoint-tracers/s, reference NE120 perf on 960 cores


def device_info():
    """Platform, kind, count and power limit of the card; exits when JAX
    finds no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's device is "
                 f"{devs[0].platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.splitlines()[0]}


def measure(ne, qsize, subcycles):
    """Gridpoint-tracers/s for one perf-config grid (best of two
    windows, each ended by block_until_ready)."""
    import jax
    import jax.numpy as jnp

    from transport_se_tpu.config import perf_config
    from transport_se_tpu.model.core import (build_model, initial_qdp,
                                             make_subcycle_fn)

    cfg = perf_config(ne, dtype="f32", qsize=qsize)
    m = build_model(cfg)
    step = jax.jit(make_subcycle_fn(m, diagnostics=False),
                   donate_argnums=0)

    Qdp = jax.jit(lambda: initial_qdp(m))()
    nstep = jnp.asarray(0, jnp.int32)

    # warmup through the chain (compilation lands here)
    Qdp, ps, nstep, _ = step(Qdp, nstep)
    Qdp, ps, nstep, _ = step(Qdp, nstep)
    jax.block_until_ready(Qdp)

    best = 0.0
    steps = subcycles * cfg.rsplit
    gpt = steps * m.grid.nelem * 16 * cfg.nlev * cfg.qsize
    for _w in range(2):
        t0 = time.perf_counter()
        for _ in range(subcycles):
            Qdp, ps, nstep, _ = step(Qdp, nstep)
        jax.block_until_ready(Qdp)
        best = max(best, gpt / (time.perf_counter() - t0))
    return best


def main():
    from transport_se_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = device_info()
    rate = measure(NE, QSIZE, SUBCYCLES)
    out = {
        "metric": f"NE{NE} {QSIZE}-tracer gridpoint-tracers/s per GPU",
        "value": rate,
        "unit": "gridpoint-tracers/s",
        "vs_baseline": rate / BASELINE,
        "device": dev,
    }
    if PROXY and NE != 42:
        prate = measure(42, QSIZE, SUBCYCLES)
        out["ne42_proxy_value"] = prate
        out["ne42_proxy_vs_baseline"] = prate / BASELINE
    print(json.dumps(out))


if __name__ == "__main__":
    main()
