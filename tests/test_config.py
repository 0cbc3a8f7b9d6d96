"""Run configuration: the perf deployments and option validation."""

import dataclasses

import pytest

from transport_se_tpu.config import Config, dcmip12_ne8, perf_config


@pytest.mark.parametrize("ne,tstep,nu", [(8, 1200.0, 6e16),
                                         (30, 300.0, 1e15),
                                         (42, 75.0, 1e13),
                                         (120, 75.0, 1e13)])
def test_perf_config_matches_reference_runs(ne, tstep, nu):
    """test/run_ne*_perf.sh: 35 tracers, 72 levels, rsplit 3, limiter 8,
    hyperviscosity; f32 with the audited limiter cap of 4."""
    cfg = perf_config(ne, dtype="f32")
    assert (cfg.ne, cfg.tstep, cfg.nu_q) == (ne, tstep, nu)
    assert (cfg.qsize, cfg.nlev, cfg.rsplit) == (35, 72, 3)
    assert cfg.limiter_option == 8 and cfg.limiter_iter_cap == 4
    assert cfg.dss_mode == "face" and cfg.elem_order == "raster"
    assert cfg.disable_diagnostics


def test_perf_config_overrides():
    cfg = perf_config(30, dtype="f32", qsize=3, dss_mode="gather",
                      limiter_iter_cap=6)
    assert (cfg.qsize, cfg.dss_mode, cfg.limiter_iter_cap) == (3, "gather",
                                                               6)


def test_f64_perf_config_iterates_to_convergence():
    assert perf_config(30, dtype="f64").limiter_iter_cap == 0


def test_limiter_cap_is_f32_only():
    """The f64 verification limiter always runs the reference's full
    iteration; a cap there is refused, not ignored."""
    with pytest.raises(ValueError, match="limiter_iter_cap"):
        dcmip12_ne8(dtype="f64", limiter_iter_cap=4)
    with pytest.raises(ValueError, match="limiter_iter_cap"):
        dataclasses.replace(Config(dtype="f32"), limiter_iter_cap=-1)
