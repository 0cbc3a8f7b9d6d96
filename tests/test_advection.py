"""Advection-core invariants (reference test strategy, SURVEY.md §4):
constant preservation (consistency), exact mass conservation, limiter
bounds, and the vertical remap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from transport_se_tpu.config import Config
from transport_se_tpu.model import core, dcmip
from transport_se_tpu.model.core import (build_model, initial_qdp,
                                         make_subcycle_fn, advect_rk2,
                                         vertical_remap)


@pytest.fixture(scope="module")
def M():
    cfg = Config(ne=4, nlev=72, qsize=2, tstep=1200.0, test_case="dcmip1-1",
                 nu_q=6e16, nmax=3)
    return build_model(cfg)


def _mass(m, Qdp):
    """Global tracer mass: sum over elements of spheremp * column Qdp."""
    return np.asarray(
        (Qdp * m.spheremp[:, None, None]).sum(axis=(0, 2, 3, 4)))


def test_constant_preservation(M):
    """Q == 1 must be exactly preserved through a full tracer step
    (consistent mass/tracer advection, prim_advection_mod.F90:6-51)."""
    E, q, k = M.grid.nelem, M.cfg.qsize, M.cfg.nlev
    Qdp = jnp.broadcast_to(M.dp0col[None, None, :, None, None],
                           (E, q, k, 4, 4)).astype(M.lon.dtype)
    t = jnp.asarray(0.0, M.lon.dtype)
    v = dcmip.winds("dcmip1-1", M.lon, M.lat, M.etam, t)
    vn0 = v * M.dp0col[None, :, None, None, None]
    Qdp1, divdp_proj, _, _ = advect_rk2(M, Qdp, vn0, M.cfg.dt_tracer)
    dp1 = M.dp0col[None, :, None, None] - M.cfg.dt_tracer * divdp_proj
    Qrel = np.asarray(Qdp1 / dp1[:, None]) - 1.0
    assert np.abs(Qrel).max() < 1e-12


def test_mass_conservation_one_subcycle(M):
    Qdp0 = initial_qdp(M)
    step = jax.jit(make_subcycle_fn(M))
    Qdp1, ps_v, nstep, min_dp = step(Qdp0, jnp.asarray(0, jnp.int32))
    m0, m1 = _mass(M, Qdp0), _mass(M, Qdp1)
    assert float(min_dp) > 0
    rel = np.abs(m1 - m0) / np.abs(m0)
    assert rel.max() < 1e-13


def test_limiter_bounds_hold(M):
    """After one full step, tracer concentrations stay near the global
    initial min/max.  Small over/undershoots are expected (the reference
    README reports them as graded diagnostics — the RK time average is a
    convex combination in mass, not mixing ratio), but the limiter must
    keep them tiny."""
    Qdp0 = initial_qdp(M)
    Q0 = np.asarray(Qdp0 / M.dp0col[None, None, :, None, None])
    step = jax.jit(make_subcycle_fn(M))
    Qdp, ps_v, nstep, _ = step(Qdp0, jnp.asarray(0, jnp.int32))
    dp_ref = ((M.hyai[1:] - M.hyai[:-1])[None, :, None, None] * 100000.0
              + (M.hybi[1:] - M.hybi[:-1])[None, :, None, None]
              * ps_v[:, None])
    Q1 = np.asarray(Qdp / dp_ref[:, None])
    for qi in range(M.cfg.qsize):
        lo, hi = Q0[:, qi].min(), Q0[:, qi].max()
        width = max(hi - lo, 1.0)
        assert Q1[:, qi].min() > lo - 5e-3 * width
        assert Q1[:, qi].max() < hi + 5e-3 * width


def test_vertical_remap_identity(M):
    """Remap with zero divergence is the identity (dp_star == dp_ref when
    ps stays p0 and divdp_proj == 0)."""
    Qdp0 = initial_qdp(M)
    divdp_proj = jnp.zeros_like(Qdp0[:, 0])
    Qdp1, ps_v, dp_ref, min_dp = vertical_remap(M, Qdp0, divdp_proj, 1200.0)
    # ps_v = p0 everywhere; analytic dp0col == hybrid dp at ps0 only if the
    # hybrid file's eta are consistent — they are by construction
    assert np.abs(np.asarray(ps_v) - 100000.0).max() < 1e-6
    assert np.abs(np.asarray(Qdp1 - Qdp0)).max() < 1e-10 * float(
        jnp.abs(Qdp0).max())


def test_mass_conservation_multi_step(M):
    Qdp = initial_qdp(M)
    m0 = _mass(M, Qdp)
    step = jax.jit(make_subcycle_fn(M))
    n = jnp.asarray(0, jnp.int32)
    for _ in range(3):
        Qdp, ps_v, n, min_dp = step(Qdp, n)
        assert float(min_dp) > 0
    m1 = _mass(M, Qdp)
    assert (np.abs(m1 - m0) / np.abs(m0)).max() < 1e-12


def test_capped_f32_subcycle_conserves_mass():
    """The f32 perf path with the audited limiter cap (perf_config) keeps
    tracer mass to f32 roundoff through a subcycle."""
    from transport_se_tpu.config import Config
    cfg = Config(ne=4, nlev=72, qsize=2, tstep=1200.0, nu_q=6e16, nmax=3,
                 dtype="f32", limiter_iter_cap=4)
    m = build_model(cfg)
    Qdp = initial_qdp(m)
    m0 = _mass(m, Qdp)
    Qdp1, _, _, min_dp = jax.jit(make_subcycle_fn(m))(
        Qdp, jnp.asarray(0, jnp.int32))
    assert Qdp1.dtype == jnp.float32 and float(min_dp) > 0
    m1 = _mass(m, Qdp1)
    assert (np.abs(m1 - m0) / np.abs(m0)).max() < 1e-5


def test_run_simulation_leaves_callers_state_intact(M):
    """The driver's step donates its state buffer; a restart state passed
    in by the caller must survive the run."""
    from transport_se_tpu.model.driver import run_simulation
    Qdp = jax.jit(lambda: initial_qdp(M))()
    before = np.asarray(Qdp).copy()
    run_simulation(M.cfg, model=M, verbose=False, init_state=(Qdp, 0))
    np.testing.assert_array_equal(np.asarray(Qdp), before)


@pytest.mark.gpu
def test_gpu_f32_subcycle_tracks_f64(gpu):
    """On the card: an f32 subcycle (limiter cap 4) stays within f32
    roundoff plus the cap's overshoot of the f64 subcycle from the same
    initial state (no TF32 anywhere; chip_smoke.py does this at NE30)."""
    import dataclasses
    from transport_se_tpu.config import Config
    cfg = Config(ne=4, nlev=72, qsize=2, tstep=1200.0, nu_q=6e16, nmax=3,
                 dtype="f32", limiter_iter_cap=4)
    m32 = build_model(cfg)
    m64 = build_model(dataclasses.replace(cfg, dtype="f64",
                                          limiter_iter_cap=0))
    Q0 = np.asarray(initial_qdp(m32))
    n0 = jnp.asarray(0, jnp.int32)
    q32 = np.asarray(jax.jit(make_subcycle_fn(m32))(jnp.asarray(Q0), n0)[0])
    q64 = np.asarray(jax.jit(make_subcycle_fn(m64))(
        jnp.asarray(Q0, jnp.float64), n0)[0])
    assert np.abs(q32 - q64).max() < 1e-3 * np.abs(q64).max()
