"""The tracer-transport core: RK-SSP3 horizontal advection + limiter +
hyperviscosity + vertically-Lagrangian PPM remap.

Functional re-design of the reference timestepping (reference:
prim_advection_mod.F90:579 `Prim_Advec_Tracers_remap_rk2`, :667 `euler_step`,
:645 `qdp_time_avg`, :1242 `vertical_remap`; driver loop
prim_driver_mod.F90:701 `prim_run_subcycle`, :858 `prim_step`;
prim_advance_mod.F90:70 `prim_advance_exp`).  No in-place time-level
pointers: each step maps Qdp -> Qdp'.

Semantics replicated exactly (they affect published norms):

* Stage structure: three forward-Euler stages with dt/2 and
  rhs_multiplier = 0,1,2, then Qdp <- (Qdp(n0) + 2*Qdp(stage3))/3.
* Stage-dependent limiter bounds: stage 0 computes element min/max of
  Q = Qdp/dp and takes neighbor min/max; stage 1 merges local min/max into
  the carried bounds; stage 2 recomputes local bounds and takes neighbor
  min/max fused with the biharmonic exchange (euler_step :764-827).
  Limiter bound relaxation persists across stages (the reference passes
  qmin/qmax by reference into limiter_optim_iter_full).
* divdp_proj: stage 0 DSSes div(vn0) alongside Qdp; stages 1-2 use the
  projected field in dp(stage) = dp - m*dt*divdp_proj (:846-848).
* dp_star for the limiter uses the UN-projected divdp (:862-866).
* Hyperviscosity only on stage 2 with rhs_viss=3 and dp0 scaling
  (:796-827); biharmonic = laplace -> DSS -> rspheremp -> laplace
  (viscosity_mod.F90:353).
* Prescribed winds are evaluated at time nstep*tstep into the np1 slot
  while the mean-flux accumulation reads the n0 slot, so the wind driving
  step n is the field at time max(n-1, 0)*tstep (prim_advance_mod.F90:
  115-149 with the leapfrog pointer rotation in time_mod.F90:111) — a
  one-step lag we reproduce because the published norms embed it.
* In the prescribed-wind tests ps == p0 for all time, so the layer
  thickness entering the tracer step is the constant analytic
  dp0(k) = p0*(etai(k+1)-etai(k)) (dcmip_wrapper_mod.F90:164-212 overwrites
  derived%dp each step).
* Vertical remap uses dt_remap with the LAST step's divdp_proj
  (prim_advection_mod.F90:1306-1326).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..constants import P0
from ..grid.cubesphere import Grid, build_grid
from ..grid.vcoord import HVCoord, hvcoord_acme72, hvcoord_dcmip
from ..ops import sphere_ops as so
from ..ops.dss import DssTables
# limiter2d_zero is re-exported for parity only: the reference's CPU
# euler_step never dispatches it (only option 8 is wired,
# prim_advection_mod.F90:858,880); it is kept as a tested op.
from ..ops.limiter import limiter_optim_iter_full, limiter2d_zero  # noqa: F401
from ..ops.ppm import remap_q_ppm
from . import dcmip


@dataclasses.dataclass(frozen=True)
class Model:
    """Static problem definition + device-resident constant data."""
    cfg: Config
    grid: Grid
    hv: HVCoord
    tables: DssTables
    # device arrays (model dtype)
    lon: Any
    lat: Any
    deriv: Any
    D: Any
    Dinv: Any
    metdet: Any
    rmetdet: Any
    spheremp: Any
    rspheremp: Any
    etam: Any           # [K]
    etai: Any           # [K+1]
    hyai: Any
    hybi: Any
    dp0col: Any         # [K] analytic layer thickness p0*(etai[k+1]-etai[k])
    dp0ref: Any         # [K] hyperviscosity dp0 (hvcoord.dp0) — identical
                        #     values, kept separate for clarity


def build_model(cfg: Config, grid: Optional[Grid] = None) -> Model:
    grid = grid if grid is not None else build_grid(cfg.ne,
                                                   order=cfg.elem_order)
    if cfg.vcoord == "acme72":
        hv = hvcoord_acme72()
    elif cfg.vcoord.startswith("dcmip"):
        hv = hvcoord_dcmip(int(cfg.vcoord[len("dcmip"):]))
    elif cfg.vcoord.startswith("files:"):
        from ..grid.vcoord import hvcoord_from_files
        hv = hvcoord_from_files(*cfg.vcoord.split(":")[1:])
    else:
        raise ValueError(cfg.vcoord)
    if hv.nlev != cfg.nlev:
        raise ValueError(f"vcoord nlev {hv.nlev} != cfg.nlev {cfg.nlev}")
    dt = cfg.np_dtype
    a = lambda x: jnp.asarray(x, dtype=dt)
    etai = hv.etai
    return Model(
        cfg=cfg, grid=grid, hv=hv,
        tables=DssTables.from_grid(grid, mode=cfg.dss_mode),
        lon=a(grid.lon), lat=a(grid.lat), deriv=a(grid.deriv),
        D=a(grid.D), Dinv=a(grid.Dinv), metdet=a(grid.metdet),
        rmetdet=a(grid.rmetdet), spheremp=a(grid.spheremp),
        rspheremp=a(grid.rspheremp),
        etam=a(hv.etam), etai=a(etai), hyai=a(hv.hyai), hybi=a(hv.hybi),
        dp0col=a(P0 * (etai[1:] - etai[:-1])),
        dp0ref=a(hv.dp0),
    )


# ---------------------------------------------------------------------------
# initial conditions
# ---------------------------------------------------------------------------

def initial_qdp(m: Model):
    """Qdp(0) = q * dp3d on the analytic levels (dcmip_wrapper:204-210)."""
    q = dcmip.initial_tracers(m.cfg.test_case, m.lon, m.lat, m.etam,
                              m.cfg.qsize)
    return q * m.dp0col[None, None, :, None, None]


def initial_q(m: Model):
    return dcmip.initial_tracers(m.cfg.test_case, m.lon, m.lat, m.etam,
                                 m.cfg.qsize)


# ---------------------------------------------------------------------------
# one forward-Euler stage
# ---------------------------------------------------------------------------

def _dss_scale(m: Model, x):
    """rspheremp * DSS(spheremp * x) with metric dims broadcast."""
    nd = x.ndim
    sp = m.spheremp.reshape((m.spheremp.shape[0],) + (1,) * (nd - 3)
                            + m.spheremp.shape[1:])
    rsp = m.rspheremp.reshape(sp.shape)
    return m.tables.dss_sum(x * sp) * rsp


def euler_step(m: Model, Qdp_n0, qmin, qmax, divdp, divdp_proj, vn0,
               dssvar, dt, rhs_multiplier: int):
    """One stage: Qdp' = DSS[Qdp - dt*div(Vstar Qdp) + hypervis], limited.

    rhs_multiplier is STATIC (0, 1, or 2) — the stage index controls both
    the dp offset and the min/max bookkeeping, exactly as in the reference.
    Returns (Qdp', qmin', qmax', dssvar') where dssvar' is the piggybacked
    DSS'd extra field (divdp_proj / eta_dot / omega).
    """
    cfg = m.cfg
    dp = m.dp0col[None, :, None, None] - rhs_multiplier * dt * divdp_proj
    Q = Qdp_n0 / dp[:, None]                          # [E,q,k,n,n]

    qmin_l = Q.min(axis=(-2, -1))                     # [E,q,k]
    qmax_l = Q.max(axis=(-2, -1))

    rhs_viss = 0
    Qtens_bih = None
    if rhs_multiplier == 0:
        qmin, qmax = m.tables.neighbor_minmax(qmin_l, qmax_l)
    elif rhs_multiplier == 1:
        qmin = jnp.minimum(qmin, qmin_l)
        qmax = jnp.maximum(qmax, qmax_l)
    else:  # rhs_multiplier == 2: biharmonic + fresh neighbor min/max
        rhs_viss = 3
        qmin, qmax = m.tables.neighbor_minmax(qmin_l, qmax_l)
        if cfg.nu_q > 0:
            lap1 = so.laplace_sphere_wk(Q, m.deriv, m.Dinv, m.spheremp)
            lap1 = m.tables.dss_sum(lap1) \
                * m.rspheremp[:, None, None, :, :]
            lap2 = so.laplace_sphere_wk(lap1, m.deriv, m.Dinv, m.spheremp)
            Qtens_bih = (-rhs_viss * dt * cfg.nu_q
                         * m.dp0ref[None, None, :, None, None] * lap2
                         / m.spheremp[:, None, None, :, :])

    # advection velocity from the mean flux (euler_step :845-852)
    Vstar = vn0 / dp[:, :, None]                      # [E,k,2,n,n]
    gradQ = Vstar[:, None] * Qdp_n0[:, :, :, None]    # [E,q,k,2,n,n]
    Qtens = Qdp_n0 - dt * so.divergence_sphere(
        gradQ, m.deriv, m.Dinv, m.metdet, m.rmetdet)
    if Qtens_bih is not None:
        Qtens = Qtens + Qtens_bih

    if cfg.limiter_option == 8:  # noqa: SIM114 (dispatch mirrors reference)
        # limiter on Q = Qtens/dp_star with the UN-projected divdp
        dp_star = dp - dt * divdp                     # [E,k,n,n]
        shp = Qtens.shape
        flat = shp[:-2] + (shp[-2] * shp[-1],)
        sp_flat = jnp.broadcast_to(
            m.spheremp[:, None, None], shp).reshape(flat)
        dps_flat = jnp.broadcast_to(
            dp_star[:, None], shp).reshape(flat)
        # convergence decoupling (ops/limiter.py): auto on the f64
        # verification path — chunk so a slow column stalls one group,
        # not the whole element x tracer x level batch
        chunks = cfg.limiter_chunks
        if chunks == 0 and cfg.dtype == "f64":
            batch = Qtens.shape[0] * Qtens.shape[1] * Qtens.shape[2]
            chunks = next((c for c in (64, 32, 16, 8, 4, 2, 1)
                           if batch % c == 0 and batch // c >= 256), 1)
        Qt_flat, qmin, qmax = limiter_optim_iter_full(
            Qtens.reshape(flat), sp_flat, qmin, qmax, dps_flat,
            chunks=chunks, max_iter=cfg.limiter_iter_cap)
        Qtens = Qt_flat.reshape(shp)
    else:
        # limiter_option 0 / 4: the reference's CPU euler_step applies NO
        # limiter for these (only option 8 dispatches in the stage loop,
        # prim_advection_mod.F90:858,880; limiter2d_zero/minmax exist but
        # are never called on the shipped path — see ops/limiter.py where
        # both are provided as tested ops for parity)
        pass

    Qdp_np1 = _dss_scale(m, Qtens)
    dssvar_out = _dss_scale(m, dssvar) if dssvar is not None else None
    return Qdp_np1, qmin, qmax, dssvar_out


def advect_rk2(m: Model, Qdp, vn0, dt_q, eta_dot=None, omega=None):
    """Prim_Advec_Tracers_remap_rk2 (:579-640).

    Returns (Qdp', divdp_proj, eta_dot', omega').  eta_dot/omega are
    optional piggyback-DSS diagnostics (stages 2 and 3); when None the
    corresponding DSS is skipped (perf mode).
    """
    divdp = so.divergence_sphere(vn0, m.deriv, m.Dinv, m.metdet, m.rmetdet)
    divdp_proj = divdp
    dt2 = dt_q / 2.0
    zero_minmax = jnp.zeros(Qdp.shape[:3], Qdp.dtype)

    Qdp1, qmin, qmax, divdp_proj = euler_step(
        m, Qdp, zero_minmax, zero_minmax, divdp, divdp_proj, vn0,
        divdp_proj, dt2, rhs_multiplier=0)
    Qdp2, qmin, qmax, eta_out = euler_step(
        m, Qdp1, qmin, qmax, divdp, divdp_proj, vn0,
        eta_dot, dt2, rhs_multiplier=1)
    Qdp3, qmin, qmax, omega_out = euler_step(
        m, Qdp2, qmin, qmax, divdp, divdp_proj, vn0,
        omega, dt2, rhs_multiplier=2)

    # qdp_time_avg (:645-662): u(t)/3 + 2/3 u(t+2)
    Qdp_new = (Qdp + 2.0 * Qdp3) / 3.0
    return Qdp_new, divdp_proj, eta_out, omega_out


# ---------------------------------------------------------------------------
# vertical remap
# ---------------------------------------------------------------------------

def vertical_remap(m: Model, Qdp, divdp_proj, dt_remap):
    """Remap Qdp from deformed Lagrangian levels to reference hybrid levels
    (prim_advection_mod.F90:1242-1330).

    Returns (Qdp', ps_v, dp_ref, min_dp_star).  min_dp_star < 0 signals the
    reference's 'negative layer thickness' abort condition (:1323) — checked
    on host by the driver.
    """
    dp_star = m.dp0col[None, :, None, None] - dt_remap * divdp_proj
    ps_v = m.hyai[0] * P0 + dp_star.sum(axis=1)       # [E,n,n]
    dp_ref = ((m.hyai[1:] - m.hyai[:-1])[None, :, None, None] * P0
              + (m.hybi[1:] - m.hybi[:-1])[None, :, None, None]
              * ps_v[:, None])
    # health: negative thickness OR fast-path window exceeded (both Pa);
    # ppm_search="general" demotes the window guard to advisory
    from ..ops.ppm import ppm_fast_margin, remap_q_ppm_general
    general = m.cfg.ppm_search == "general"
    d1 = jnp.moveaxis(dp_star, 1, 3)
    d2m = jnp.moveaxis(dp_ref, 1, 3)
    health = dp_star.min() if general else jnp.minimum(
        dp_star.min(), ppm_fast_margin(d1, d2m))
    min_dp = m.tables.global_min(health)

    # column layout for the PPM kernel: [..., Q, nlev]
    Qcol = jnp.moveaxis(Qdp, (1, 2), (3, 4))          # [E,n,n,q,k]
    d1 = jnp.moveaxis(dp_star, 1, 3)                  # [E,n,n,k]
    d2 = jnp.moveaxis(dp_ref, 1, 3)
    remap = remap_q_ppm_general if general else remap_q_ppm
    Qnew = remap(Qcol, d1, d2, alg=m.cfg.vert_remap_q_alg)
    Qdp_out = jnp.moveaxis(Qnew, (3, 4), (1, 2))
    return Qdp_out, ps_v, dp_ref, min_dp


# ---------------------------------------------------------------------------
# the remap-interval step (prim_run_subcycle)
# ---------------------------------------------------------------------------

def make_subcycle_fn(m: Model, diagnostics: bool = False):
    """Returns jittable fn(Qdp, nstep) -> (Qdp', ps_v, nstep', min_dp).

    One call advances rsplit tracer steps and performs one vertical remap
    (prim_driver_mod.F90:788-796).  nstep counts tracer steps.
    """
    cfg = m.cfg
    # Python floats: they bake into the trace as constants
    dt = float(cfg.tstep)
    dt_q = float(cfg.dt_tracer)
    dt_remap = float(cfg.dt_remap)
    # mean-flux weights for RK+LF per qsplit stage (ur_weights,
    # prim_advance_mod.F90:53-67): vn0 = w(mod(nstep,qsplit)+1) * v * dp.
    # qsplit=1 (every shipped namelist) gives w = [1].
    urw = np.zeros(cfg.qsplit)
    if cfg.qsplit % 2:
        urw[0] = 1.0 / cfg.qsplit
        urw[2::2] = 2.0 / cfg.qsplit
    else:
        urw[1::2] = 2.0 / cfg.qsplit
    ur_w = jnp.asarray(urw, cfg.np_dtype)

    def stage_weight(nstep):
        if cfg.qsplit == 1:
            return None
        return ur_w[nstep % cfg.qsplit]

    def step(Qdp, nstep):
        divdp_proj = None
        for _ in range(cfg.rsplit):
            # prescribed wind with the reference's one-step evaluation lag
            t_wind = jnp.maximum(nstep - 1, 0).astype(m.lon.dtype) * dt
            v = dcmip.winds(cfg.test_case, m.lon, m.lat, m.etam, t_wind)
            vn0 = v * m.dp0col[None, :, None, None, None]
            w = stage_weight(nstep)
            if w is not None:
                vn0 = vn0 * w
            if diagnostics:
                eta = dcmip.eta_dot_dpdn(cfg.test_case, m.lon, m.lat,
                                         m.etai, t_wind)[:, :cfg.nlev]
                # omega_p = (-g rho w)/p at midpoints (dcmip_wrapper:253,197)
                omg = dcmip.eta_dot_dpdn(cfg.test_case, m.lon, m.lat,
                                         m.etam, t_wind) \
                    / (P0 * m.etam[None, :, None, None])
                Qdp, divdp_proj, _, _ = advect_rk2(m, Qdp, vn0, dt_q,
                                                   eta, omg)
            else:
                Qdp, divdp_proj, _, _ = advect_rk2(m, Qdp, vn0, dt_q)
            nstep = nstep + 1
        Qdp, ps_v, dp_ref, min_dp = vertical_remap(m, Qdp, divdp_proj,
                                                   dt_remap)
        return Qdp, ps_v, nstep, min_dp

    return step
