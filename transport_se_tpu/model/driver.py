"""Simulation driver: the prim_main / prim_run_subcycle loop.

Host-level loop over remap intervals with a jitted subcycle step
(reference: src/prim_main.F90:142-175 main loop;
prim_driver_mod.F90:701 `prim_run_subcycle`).  For benchmarking, a fully
on-device multi-interval step (lax.fori_loop over subcycles) is provided so
the whole run is one XLA program with zero host round-trips.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..constants import P0
from ..diagnostics import StateLog, tracer_diagnostics
from ..timing import timers
from .core import Model, build_model, initial_qdp, make_subcycle_fn


@dataclasses.dataclass
class RunResult:
    model: Model
    q_init: np.ndarray       # [E, q, k, n, n] mixing ratio at t=0
    q_final: np.ndarray      # [E, q, k, n, n] mixing ratio at end
    ps_final: np.ndarray
    nsteps: int
    log: StateLog
    wall_seconds: float


def reference_dp(m: Model, ps_v):
    return ((m.hyai[1:] - m.hyai[:-1])[None, :, None, None] * P0
            + (m.hybi[1:] - m.hybi[:-1])[None, :, None, None]
            * ps_v[:, None])


def run_simulation(cfg: Config, model: Optional[Model] = None,
                   verbose: bool = True,
                   history=None,
                   init_state=None,
                   restartfreq: int = 0,
                   restart_writer=None) -> RunResult:
    """Run cfg.nsteps tracer steps; returns initial/final mixing ratios.

    `history` is an optional HistoryWriter (io/history.py) that receives
    (model, nstep, Q, ps_v) at each output interval.
    `init_state` = (Qdp, nstep0) resumes from a restart (runtype 1/2 —
    prim_driver_mod.F90:512-534); the run continues to cfg.nsteps total.
    `restart_writer(model, nstep, Qdp, ps_v)` is called every `restartfreq`
    steps (prim_main.F90:172-174).
    """
    m = model if model is not None else build_model(cfg)
    nsteps = cfg.nsteps
    if nsteps % cfg.rsplit != 0:
        raise ValueError(f"nsteps={nsteps} not divisible by rsplit")

    with timers.time("prim_init"):
        if init_state is not None:
            Qdp, nstep0 = init_state
            # a copy: the step donates its state buffer
            Qdp = jnp.array(Qdp, m.lon.dtype)
        else:
            Qdp = jax.jit(lambda: initial_qdp(m))()
            nstep0 = 0
        # host-side divide: a device temp here costs a full field of
        # device memory exactly when it hurts (NE120 on one card)
        q_init = (np.asarray(Qdp)
                  / np.asarray(m.dp0col)[None, None, :, None, None])
        state = Qdp
        # the step donates the state buffer so XLA aliases it (a full
        # field — matters at NE120, where device memory is the bound)
        step = jax.jit(make_subcycle_fn(m, diagnostics=False),
                       donate_argnums=0)
    if (nsteps - nstep0) % cfg.rsplit != 0:
        raise ValueError("remaining steps not divisible by rsplit")
    n_subcycles = (nsteps - nstep0) // cfg.rsplit
    if n_subcycles <= 0:
        raise ValueError(
            f"nothing to run: restart nstep={nstep0} >= nmax={nsteps} "
            "(increase nmax/ndays to continue this run)")

    log = StateLog()
    if not cfg.disable_diagnostics:
        Q0 = Qdp / m.dp0col[None, None, :, None, None]
        mass, var, qmn, qmx = tracer_diagnostics(m, Qdp, Q0)
        log.record(0, mass, var, qmn, qmx, cfg.tstep, verbose)
    if history is not None and init_state is None:
        # initial record; on restart the t=0 record is in the original
        # run's history (and q_init/dp0col would be wrong mid-run anyway)
        extras0 = None
        if history.needs_extras():
            from ..diagnostics import flow_fields
            extras0 = flow_fields(m, 0)
        history.write(m, 0, q_init,
                      np.full((m.grid.nelem, 4, 4), P0), extras=extras0)

    del Qdp
    nstep = jnp.asarray(nstep0, jnp.int32)
    t0 = _time.perf_counter()
    ps_v = None
    for isub in range(n_subcycles):
        cur_before = int(nstep)
        check = (not cfg.disable_diagnostics
                 and ((cur_before + cfg.rsplit) % cfg.statefreq
                      < cfg.rsplit or isub == n_subcycles - 1))
        if check:
            # prim_diag_scalars n=1 sample at subcycle start (the RK2
            # path makes half-times 1,4 coincide at n0 and 2,3 at np1,
            # prim_state_mod.F90:573-657 with prim_driver calls :771-835)
            dp0 = (reference_dp(m, ps_v) if ps_v is not None
                   else m.dp0col[None, :, None, None])
            mass0, var0, _, _ = tracer_diagnostics(m, state,
                                                   state / dp0[:, None])
        with timers.time("prim_run"):
            state, ps_v, nstep, min_dp = step(state, nstep)
            # JAX dispatch is asynchronous; block so the timer measures
            # compute (like the reference's synchronous GPTL regions)
            jax.block_until_ready(state)
        cur = int(nstep)
        Qdp = state
        if check:
            if float(min_dp) < 0:
                raise RuntimeError(
                    "negative layer thickness or PPM fast-path interface "
                    "displacement > 2 cells. timestep or remap time too "
                    "large (prim_advection_mod.F90:1323; ops/ppm.py "
                    "ppm_fast_margin)")
            dp_ref = reference_dp(m, ps_v)
            Q = Qdp / dp_ref[:, None]
            mass, var, qmn, qmx = tracer_diagnostics(m, Qdp, Q)
            # printstate divides the subcycle difference by one tracer
            # step dt = tstep*qsplit (prim_state_mod.F90:157,381)
            log.record(cur, mass, var, qmn, qmx, cfg.dt_tracer, verbose,
                       prev=(mass0, var0))
        # the reference always writes at the run end: nextoutputstep is
        # capped at nEndStep (common_movie_mod.F90:173 init to nEndStep)
        if history is not None and (history.due(cur, cfg)
                                    or isub == n_subcycles - 1):
            dp_ref = reference_dp(m, ps_v)
            extras = None
            if history.needs_extras():
                from ..diagnostics import flow_fields
                extras = flow_fields(m, cur)
            history.write(m, cur, np.asarray(Qdp / dp_ref[:, None]),
                          np.asarray(ps_v), extras=extras)
        if (restart_writer is not None and restartfreq > 0
                and cur % restartfreq < cfg.rsplit):
            restart_writer(m, cur, np.asarray(Qdp), np.asarray(ps_v))
    jax.block_until_ready(state)
    wall = _time.perf_counter() - t0
    Qdp = state

    dp_ref = reference_dp(m, ps_v)
    q_final = np.asarray(Qdp / dp_ref[:, None])
    return RunResult(model=m, q_init=q_init, q_final=q_final,
                     ps_final=np.asarray(ps_v), nsteps=nsteps, log=log,
                     wall_seconds=wall)


def make_multi_interval_fn(m: Model, n_subcycles: int):
    """One XLA program advancing n_subcycles remap intervals (bench mode)."""
    step = make_subcycle_fn(m, diagnostics=False)

    def many(Qdp, nstep):
        def body(_, carry):
            Qdp, nstep, _ = carry
            Qdp, ps_v, nstep, min_dp = step(Qdp, nstep)
            return Qdp, nstep, ps_v
        ps0 = jnp.zeros(Qdp.shape[:1] + Qdp.shape[-2:], Qdp.dtype)
        Qdp, nstep, ps_v = jax.lax.fori_loop(
            0, n_subcycles, body, (Qdp, nstep, ps0))
        return Qdp, nstep, ps_v

    return many
