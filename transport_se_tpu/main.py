"""The main program: namelist -> run -> history/restart/timing output.

Equivalent of the reference entry program (reference: src/prim_main.F90:5 —
MPI init, t_initf, readnl via prim_init1, main loop over output intervals
:142-175, movie + restart writes :163-174, timer dump t_prf :188).

Usage (mirrors `preqx < namelist.nl`):
    python -m transport_se_tpu.main namelist.nl
    python -m transport_se_tpu.main < namelist.nl
Extra flags select the JAX platform and precision without editing the
namelist (compile-time knobs in the reference's configure.sh).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("namelist", nargs="?", default=None,
                   help="namelist file (default: stdin)")
    p.add_argument("--platform", default=None, help="cpu|cuda")
    p.add_argument("--dtype", default="f64", choices=["f64", "f32"])
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from .io.namelist import config_from_namelist
    from .io.history import HistoryWriter
    from .io import restart as restart_io
    from .model.core import build_model
    from .model.driver import run_simulation
    from .timing import timers

    if args.namelist:
        text = open(args.namelist).read()
        nl_dir = os.path.dirname(os.path.abspath(args.namelist))
    else:
        text = sys.stdin.read()
        nl_dir = os.getcwd()
    rs = config_from_namelist(text, nl_dir=nl_dir)
    cfg = dataclasses.replace(rs.cfg, dtype=args.dtype)
    print(f"transport_se_tpu: ne={cfg.ne} nlev={cfg.nlev} qsize={cfg.qsize} "
          f"tstep={cfg.tstep} rsplit={cfg.rsplit} test={cfg.test_case} "
          f"nsteps={cfg.nsteps} platform={jax.devices()[0].platform}")

    m = build_model(cfg)

    # startup self-checks (prim_init2: test_global_integral :437, print_cfl
    # :673 — global_norms_mod.F90)
    from .diagnostics import print_cfl, test_global_integral
    area_err = test_global_integral(m)
    if area_err > 1e-10:
        raise RuntimeError(f"sphere area check failed: rel err {area_err:.2e}")
    dt_tracer_lim, dt_hv_lim = print_cfl(m, cfg, verbose=not args.quiet)

    init_state = None
    if rs.runtype in (1, 2):
        state = restart_io.read_restart(rs.restartfile)
        Qdp, ps_v, nstep0 = restart_io.resume(state, m, rs.runtype)
        init_state = (Qdp, nstep0)
        print(f"restart (runtype={rs.runtype}) from {rs.restartfile} "
              f"at nstep={nstep0}")

    history = None
    if rs.output_frequency > 0:
        os.makedirs(rs.output_dir, exist_ok=True)
        path = os.path.join(
            rs.output_dir, f"{cfg.test_case}1.nc")
        varnames = rs.output_varnames or ("ps", "Q", "u", "v", "geo")
        # tracer aliases: any 'Qn' request is covered by expanding 'Q'
        expanded = tuple(
            dict.fromkeys("Q" if v.startswith("Q") else v
                          for v in varnames))
        history = HistoryWriter(path, m, varnames=expanded,
                                output_frequency=rs.output_frequency,
                                output_timeunits=rs.output_timeunits)
        print(f"history output -> {path}")

    def restart_writer(model, nstep, Qdp, ps_v):
        restart_io.write_restart(rs.restartfile, model, Qdp, ps_v, nstep)
        print(f"wrote restart {rs.restartfile} at nstep={nstep}")

    result = run_simulation(
        cfg, model=m, verbose=not args.quiet, history=history,
        init_state=init_state,
        restartfreq=rs.restartfreq,
        restart_writer=restart_writer if rs.restartfreq > 0 else None)
    if history is not None:
        history.close()

    # timer dump (HommeTime_stats analog, prim_main.F90:188)
    print(timers.report())
    drift = result.log.max_relative_mass_drift() if result.log.masses else 0.0
    print(f"done: {result.nsteps} steps, wall {result.wall_seconds:.3f} s, "
          f"max relative tracer-mass drift {drift:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
