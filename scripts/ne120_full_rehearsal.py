#!/usr/bin/env python
"""NE120 FULL-SIZE rehearsal: 35 tracers, 72 levels, 86,400 elements
through the sharded pipeline on an 8-way virtual CPU mesh.

The reference's headline perf config (reference README:160-192,
test/run_ne120_perf.sh) has 86400*16*72*35 ~ 3.5e9 gridpoint-tracers;
the f32 state alone is ~14 GB.  This rehearsal retires the memory-plan
and shapes-at-scale risk that reduced proxies cannot: the exact
production shapes, shard plan, halo tables and collectives run end to
end (one remap interval), with host peak-RSS and per-shard persistent
state accounting against one card's device memory.

Phase 2 exercises the banded face-shift sharded DSS (the production
multi-chip assembly, parallel/face_sharded.py) at the full 86,400-element
horizontal scale with a reduced vertical/tracer count (the
horizontal-scale table/plan structure is what phase 2 certifies).

Usage: python scripts/ne120_full_rehearsal.py [--phase 1|2|all]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def peak_rss_gb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) / 1e6
    return -1.0


def _mass_drift(Qdp0, Qdp, sp, qsize, nlev):
    """Per-tracer relative mass drift, shared by run_phase and the
    chunked phase-1 path."""
    import numpy as np
    w = sp[:, None, None]
    mass0 = np.asarray((Qdp0 * w).sum(axis=(0, 2, 3, 4)))
    mass1 = np.asarray((Qdp * w).sum(axis=(0, 2, 3, 4)))
    return np.abs(mass1 - mass0) / np.abs(mass0)


def run_phase(cfg_kwargs, tag, tol, accounting_only=False):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from transport_se_tpu.config import Config
    from transport_se_tpu.model.core import build_model, initial_qdp
    from transport_se_tpu.parallel.sharded import (make_mesh,
                                                   make_sharded_subcycle)

    t0 = time.time()
    cfg = Config(**cfg_kwargs)
    m = build_model(cfg)
    E = m.grid.nelem
    print(f"[{tag}] grid+model build: {time.time()-t0:.1f}s (E={E})",
          flush=True)

    t0 = time.time()
    mesh = make_mesh()
    S = mesh.devices.size
    runner = make_sharded_subcycle(m, mesh)
    print(f"[{tag}] shard plan ({S} shards): {time.time()-t0:.1f}s, "
          f"nrounds={runner.plan.nrounds}, nhalo={runner.plan.nhalo}, "
          f"eloc={runner.plan.eloc}", flush=True)

    # persistent per-shard state accounting (the device residents on a
    # card): Qdp + wind/metric/table slices
    bpe = 4 if cfg.dtype == "f32" else 8
    qdp_shard = runner.plan.eloc * 16 * cfg.qsize * cfg.nlev * bpe
    halo_shard = runner.plan.nhalo * 16 * cfg.qsize * cfg.nlev * bpe
    print(f"[{tag}] per-shard Qdp {qdp_shard/1e9:.2f} GB, halo slab "
          f"{halo_shard/1e9:.2f} GB", flush=True)

    t0 = time.time()
    Qdp0 = runner.shard_qdp(jax.jit(lambda: initial_qdp(m))())
    jax.block_until_ready(Qdp0)
    print(f"[{tag}] init state: {time.time()-t0:.1f}s, host peak RSS "
          f"{peak_rss_gb():.1f} GB", flush=True)

    if accounting_only:
        # full-size shapes/plan/memory certified; the remap interval
        # itself needs an hours-long window (see --phase 1 note below)
        out = dict(tag=tag + "-accounting", E=E, shards=S,
                   eloc=runner.plan.eloc, nrounds=int(runner.plan.nrounds),
                   nhalo=int(runner.plan.nhalo), qsize=cfg.qsize,
                   nlev=cfg.nlev, qdp_shard_gb=round(qdp_shard / 1e9, 3),
                   host_peak_rss_gb=round(peak_rss_gb(), 1))
        print(f"[{tag}] ACCOUNTING-ONLY OK " + json.dumps(out), flush=True)
        return out

    t0 = time.time()
    Qdp, ps_v, nstep, min_dp = runner.step(Qdp0, jnp.asarray(0, jnp.int32))
    jax.block_until_ready(Qdp)
    wall = time.time() - t0
    print(f"[{tag}] 1 remap interval: {wall:.1f}s, host peak RSS "
          f"{peak_rss_gb():.1f} GB", flush=True)

    sp = m.spheremp
    rel = _mass_drift(Qdp0, Qdp, sp, cfg.qsize, cfg.nlev)
    assert float(min_dp) > 0, "health check failed"
    assert rel.max() < tol, f"mass drift {rel.max()}"
    out = dict(tag=tag, E=E, shards=S, eloc=runner.plan.eloc,
               nrounds=int(runner.plan.nrounds),
               nhalo=int(runner.plan.nhalo), qsize=cfg.qsize,
               nlev=cfg.nlev, wall_interval_s=round(wall, 1),
               qdp_shard_gb=round(qdp_shard / 1e9, 3),
               host_peak_rss_gb=round(peak_rss_gb(), 1),
               mass_drift=float(rel.max()), dss=cfg.dss_mode)
    print(f"[{tag}] OK " + json.dumps(out), flush=True)
    return out


def run_phase1_chunked(rsplit, qchunk, out_path, tol=1e-5, max_chunks=0):
    """Full-size phase 1 with the 35 tracers advected in sequential
    q-chunks (separate XLA executions sharing one compiled program).

    Rationale: one full-shape [86400,16,72,35] interval under the 8-way
    time-sliced CPU mesh holds every shard's intermediates on the host
    simultaneously and OOMs at >125 GB (measured 2026-08-20: oom-kill at
    130 GB anon-rss during the first execution).  On 8 cards each
    shard's persistent state is 1.74 GB (accounting log) and no such
    aggregation exists.  Tracer blocking is also what
    the reference GPU path does (cuda_mod tracer blocking).

    Coverage note: each chunk re-initializes with qsize=qchunk, so every
    chunk advects the identical [checkerboard, layer, checkerboard]
    stack (dcmip1-2's fill is tracer 1 = checkerboard, tracer 2 = hadley
    layer, 3.. = checkerboard — model/dcmip.py initial_tracers).  That
    is *equivalent* coverage of the true 35-wide fill (34 checkerboards
    + 1 layer): both distinct fields run the full interval in every
    chunk.  ceil(35/qchunk)*qchunk tracer-intervals execute in total
    (reported as tracer_intervals; one more than 35 at qchunk=3).
    Conservation is checked per chunk and results append to disk
    incrementally so a killed window keeps its completed chunks.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from transport_se_tpu.config import Config
    from transport_se_tpu.model.core import build_model, initial_qdp
    from transport_se_tpu.parallel.sharded import (make_mesh,
                                                   make_sharded_subcycle)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    QTOT = 35
    tag = f"full-72L-35q-rsplit{rsplit}-qc{qchunk}"
    t0 = time.time()
    cfg = Config(ne=120, nlev=72, qsize=qchunk, tstep=75.0,
                 vcoord="acme72", test_case="dcmip1-2", nu_q=1e13,
                 nmax=3, dtype="f32", rsplit=rsplit)
    m = build_model(cfg)
    print(f"[{tag}] grid+model build: {time.time()-t0:.1f}s "
          f"(E={m.grid.nelem})", flush=True)
    t0 = time.time()
    mesh = make_mesh()
    runner = make_sharded_subcycle(m, mesh)
    print(f"[{tag}] shard plan ({mesh.devices.size} shards): "
          f"{time.time()-t0:.1f}s, nrounds={runner.plan.nrounds}, "
          f"nhalo={runner.plan.nhalo}, eloc={runner.plan.eloc}",
          flush=True)
    sp = m.spheremp
    nchunks = -(-QTOT // qchunk)
    if max_chunks:
        # chunks are bit-identical repeats of the [checkerboard, layer,
        # checkerboard] stack (see the coverage note above), so a
        # truncated run still exercises every distinct field at the full
        # shapes — used for the rsplit=3 production-schedule interval,
        # whose 12-chunk run would take ~6 h of single-core CPU
        nchunks = min(nchunks, max_chunks)
    init_fn = jax.jit(lambda: initial_qdp(m))
    chunks = []
    twall = 0.0
    worst = 0.0
    for ci in range(nchunks):
        t0 = time.time()
        Qdp0 = runner.shard_qdp(init_fn())
        jax.block_until_ready(Qdp0)
        tinit = time.time() - t0
        t0 = time.time()
        Qdp, ps_v, nstep, min_dp = runner.step(
            Qdp0, jnp.asarray(0, jnp.int32))
        jax.block_until_ready(Qdp)
        wall = time.time() - t0
        twall += wall
        rel = float(_mass_drift(Qdp0, Qdp, sp, qchunk, cfg.nlev).max())
        worst = max(worst, rel)
        assert float(min_dp) > 0, "health check failed"
        assert rel < tol, f"mass drift {rel}"
        rec = dict(tag=tag, chunk=ci, nchunks=nchunks,
                   wall_interval_s=round(wall, 1),
                   init_s=round(tinit, 1), mass_drift=rel,
                   host_peak_rss_gb=round(peak_rss_gb(), 1))
        chunks.append(rec)
        print(f"[{tag}] chunk {ci+1}/{nchunks}: interval {wall:.1f}s "
              f"(init {tinit:.1f}s), mass drift {rel:.3e}, peak RSS "
              f"{peak_rss_gb():.1f} GB", flush=True)
        with open(out_path, "w") as f:
            json.dump(chunks, f, indent=1)
    out = dict(tag=tag, E=m.grid.nelem, shards=int(mesh.devices.size),
               eloc=runner.plan.eloc, nrounds=int(runner.plan.nrounds),
               nhalo=int(runner.plan.nhalo), qsize_total=QTOT,
               qchunk=qchunk, chunks_run=nchunks,
               tracer_intervals=nchunks * qchunk,
               nlev=cfg.nlev, rsplit=rsplit,
               wall_total_s=round(twall, 1),
               wall_per_35_tracers_s=round(twall * QTOT
                                           / (nchunks * qchunk), 1),
               mass_drift=worst,
               host_peak_rss_gb=round(peak_rss_gb(), 1),
               dss=cfg.dss_mode)
    chunks.append(out)
    with open(out_path, "w") as f:
        json.dump(chunks, f, indent=1)
    print(f"[{tag}] ALL {nchunks} CHUNKS OK " + json.dumps(out),
          flush=True)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--phase", default="all", choices=["1", "2", "all"])
    p.add_argument("--out", default="artifacts/ne120_rehearsal.json")
    p.add_argument("--accounting-only", action="store_true",
                   help="stop after shard-plan + full-size state init + "
                        "per-shard memory accounting (minutes, not hours)")
    p.add_argument("--p1-qchunk", type=int, default=0,
                   help="advect the 35 tracers in sequential chunks of "
                        "this size (0 = one 35-wide execution; chunking "
                        "caps host intermediate memory under the "
                        "time-sliced CPU mesh — see run_phase1_chunked)")
    p.add_argument("--p1-chunks", type=int, default=0,
                   help="run only the first N tracer chunks (0 = all; "
                        "chunks are bit-identical repeats — see "
                        "run_phase1_chunked)")
    p.add_argument("--p1-rsplit", type=int, default=3,
                   help="rsplit for phase 1 (default 3 = the production "
                        "remap interval of 3 tracer steps; 1 runs a "
                        "complete 1-step interval at the exact same "
                        "per-op shapes in ~1/3 the single-core wall, for "
                        "windows too short to hold the 3-step interval)")
    args = p.parse_args()

    # At full size, one core time-slicing 8 virtual devices takes minutes
    # of compute between collectives; XLA's CPU rendezvous would abort the
    # process at its default 40 s termination timeout — raise it (these
    # are wall-clock guards, not correctness knobs).
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=86400"
        + " --xla_cpu_collective_call_terminate_timeout_seconds=172800"
        + " --xla_cpu_collective_timeout_seconds=172800")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    chunk_detail = []
    if args.phase in ("1", "all"):
        # phase 1: the FULL production size (the reference headline
        # config's exact shapes), XLA pipeline
        if args.p1_qchunk and not args.accounting_only:
            results.append(run_phase1_chunked(
                args.p1_rsplit, args.p1_qchunk, args.out,
                max_chunks=args.p1_chunks))
            # the chunked run wrote its per-chunk records (the
            # crash-resilience deliverable) to args.out — preserve them
            # in the final merged dump instead of overwriting
            try:
                with open(args.out) as f:
                    chunk_detail = [r for r in json.load(f) if "chunk" in r]
            except (OSError, ValueError):
                chunk_detail = []
        else:
            tag = ("full-72L-35q" if args.p1_rsplit == 3
                   else f"full-72L-35q-rsplit{args.p1_rsplit}")
            results.append(run_phase(
                dict(ne=120, nlev=72, qsize=35, tstep=75.0,
                     vcoord="acme72", test_case="dcmip1-2", nu_q=1e13,
                     nmax=3, dtype="f32", rsplit=args.p1_rsplit),
                tag, 1e-5, accounting_only=args.accounting_only))
    if args.phase in ("2", "all"):
        # phase 2: full horizontal scale through the banded face-shift
        # sharded DSS (dss_sum through the band assembly — halo.py
        # dss_sum; certified bitwise-equal at small ne by
        # tests/test_sharded_face.py)
        results.append(run_phase(
            dict(ne=120, nlev=8, qsize=2, tstep=75.0, vcoord="dcmip8",
                 test_case="dcmip1-2", nu_q=1e13, nmax=3, dtype="f32",
                 dss_mode="face",
                 elem_order="raster"),
            "face-sharded-8L-2q", 1e-5,
            accounting_only=args.accounting_only))
    with open(args.out, "w") as f:
        json.dump(chunk_detail + results, f, indent=1)
    print("rehearsal complete ->", args.out, flush=True)


if __name__ == "__main__":
    main()
