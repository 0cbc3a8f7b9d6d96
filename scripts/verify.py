#!/usr/bin/env python
"""End-to-end verification: run a DCMIP config and compare error norms to
the published reference numbers (BASELINE.md / reference README).

Usage:
  python scripts/verify.py --test dcmip1-1 --ne 8 [--platform cpu|cuda]
                           [--dtype f64|f32] [--days N] [--qsize N]

The reference targets (72L, rsplit=3, Skybridge; README:94-96):
  dcmip1-1 NE8:  L1=0.578151 L2=0.865526 Linf=0.883168
                 q_max=0.187204 q_min=-3.207090e-13
  dcmip1-2 NE8:  L1=0.307665 L2=0.622099 Linf=0.839133
                 q_max=0.813105 q_min=-9.385639e-06
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--test", default="dcmip1-1",
                   choices=["dcmip1-1", "dcmip1-2"])
    p.add_argument("--ne", type=int, default=8)
    p.add_argument("--platform", default=None)
    p.add_argument("--dtype", default="f64")
    p.add_argument("--days", type=float, default=None)
    p.add_argument("--qsize", type=int, default=4)
    p.add_argument("--tstep", type=float, default=None)
    p.add_argument("--nu_q", type=float, default=None)
    p.add_argument("--nlev", type=int, default=72,
                   help="72 (acme72 vcoord) or a DCMIP uniform-z level "
                        "count (e.g. 64 for the README's 64L rows)")
    p.add_argument("--dss", default=None,
                   choices=["gather", "segsum", "face"],
                   help="DSS mode (default: gather, the BFB oracle)")
    p.add_argument("--limcap", type=int, default=0,
                   help="limiter_iter_cap (f32 only; 0 = the reference's "
                        "full np*np-1 iteration)")
    args = p.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)

    from transport_se_tpu.config import Config
    from transport_se_tpu.model.driver import run_simulation
    from transport_se_tpu.norms import run_norms
    from transport_se_tpu.timing import timers

    tstep = args.tstep or {8: 400.0, 30: 300.0, 120: 75.0}[args.ne]
    nu = args.nu_q if args.nu_q is not None else \
        {8: 6e16, 30: 1e15, 120: 1e13}[args.ne]
    days = args.days if args.days is not None else \
        (12.0 if args.test == "dcmip1-1" else 1.0)
    dss = args.dss or "gather"
    vcoord = "acme72" if args.nlev == 72 else f"dcmip{args.nlev}"
    cfg = Config(ne=args.ne, test_case=args.test, tstep=tstep, ndays=days,
                 qsize=args.qsize, nu_q=nu, dtype=args.dtype, nlev=args.nlev,
                 vcoord=vcoord, dss_mode=dss,
                 elem_order="raster" if dss == "face" else "gilbert",
                 limiter_iter_cap=args.limcap,
                 statefreq=int(12 * 3600 / tstep) * 3)
    print(f"config: {cfg}")
    print(f"steps: {cfg.nsteps}  subcycles: {cfg.nsteps // cfg.rsplit}")

    t0 = time.time()
    res = run_simulation(cfg, verbose=True)
    print(f"\nwall: {res.wall_seconds:.2f}s (total {time.time()-t0:.2f}s)")
    print(timers.report())
    print(f"max relative mass drift: {res.log.max_relative_mass_drift():.3e}")

    norms = run_norms(res)
    print(f"\nDCMIP {args.test} NE{args.ne}: {norms}")


if __name__ == "__main__":
    main()
