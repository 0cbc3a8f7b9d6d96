"""Limiter-8 unit tests (prim_advection_mod.F90:976 semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from transport_se_tpu.ops.limiter import limiter_optim_iter_full


def _run(ptens, w, lo, hi, dp):
    out, lo2, hi2 = limiter_optim_iter_full(
        jnp.asarray(ptens), jnp.asarray(w), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(dp))
    return np.asarray(out), np.asarray(lo2), np.asarray(hi2)


def test_mass_exactly_preserved():
    rng = np.random.default_rng(0)
    n = 64
    ptens = rng.uniform(0.0, 2.0, (n, 16))
    w = rng.uniform(0.5, 1.5, (n, 16))
    dp = rng.uniform(0.8, 1.2, (n, 16))
    lo = np.full(n, 0.4)
    hi = np.full(n, 1.2)
    out, _, _ = _run(ptens, w, lo, hi, dp)
    m0 = (ptens * w).sum(-1)
    m1 = (out * w).sum(-1)
    assert np.abs((m1 - m0) / m0).max() < 1e-13


def test_bounds_enforced():
    rng = np.random.default_rng(1)
    n = 128
    ptens = rng.uniform(-0.5, 2.5, (n, 16))
    w = rng.uniform(0.5, 1.5, (n, 16))
    dp = np.ones((n, 16))
    lo = np.full(n, 0.0)
    hi = np.full(n, 1.5)
    out, lo2, hi2 = _run(ptens, w, lo, hi, dp)
    q = out / dp
    # bounds (possibly relaxed for feasibility) must hold to tolerance
    assert (q >= lo2[:, None] - 1e-12).all()
    assert (q <= hi2[:, None] + 1e-12).all()


def test_no_op_when_within_bounds():
    rng = np.random.default_rng(2)
    ptens = rng.uniform(0.4, 0.6, (8, 16))
    w = np.ones((8, 16))
    dp = np.ones((8, 16))
    out, _, _ = _run(ptens, w, np.zeros(8), np.ones(8), dp)
    assert np.abs(out - ptens).max() == 0.0


def test_bound_relaxation_returned():
    # element mean above maxp: maxp must be relaxed to the mean
    ptens = np.full((1, 16), 2.0)
    w = np.ones((1, 16))
    dp = np.ones((1, 16))
    out, lo2, hi2 = _run(ptens, w, np.zeros(1), np.ones(1), dp)
    assert abs(hi2[0] - 2.0) < 1e-14   # relaxed from 1.0 to mass/sumc = 2.0
    assert np.abs(out - 2.0).max() < 1e-14


def test_linear_correlation_friendly_redistribution():
    # clipping one high point redistributes equally over free points
    ptens = np.array([[3.0] + [0.5] * 15])
    w = np.ones((1, 16))
    dp = np.ones((1, 16))
    out, _, _ = _run(ptens, w, np.zeros(1), np.ones(1), dp)
    assert out[0, 0] <= 1.0 + 1e-12
    # mass preserved
    assert abs(out.sum() - ptens.sum()) < 1e-12
    # the freed mass spread over the other 15 points equally
    assert np.ptp(out[0, 1:]) < 1e-12


def _rough_problem(seed=3, n=96):
    """Columns far outside tight bounds: several clip/redistribute trips
    are needed before they converge."""
    rng = np.random.default_rng(seed)
    ptens = rng.uniform(-1.0, 3.0, (n, 16))
    w = rng.uniform(0.5, 1.5, (n, 16))
    dp = rng.uniform(0.8, 1.2, (n, 16))
    lo = np.full(n, 0.6)
    hi = np.full(n, 1.0)
    return ptens, w, lo, hi, dp


def _capped(args, max_iter, chunks=0):
    out, lo2, hi2 = limiter_optim_iter_full(
        *map(jnp.asarray, args), chunks=chunks, max_iter=max_iter)
    return np.asarray(out), np.asarray(lo2), np.asarray(hi2)


@pytest.mark.parametrize("cap", [1, 2, 3, 4])
def test_iteration_cap_is_mass_preserving(cap):
    """Any cap preserves each column's mass (every exit redistributes the
    clip residual) and relaxes the bounds exactly as the full run does."""
    args = _rough_problem()
    ptens, w = args[0], args[1]
    full, flo, fhi = _capped(args, 0)
    out, lo2, hi2 = _capped(args, cap)
    np.testing.assert_allclose((out * w).sum(-1), (ptens * w).sum(-1),
                               rtol=1e-13)
    np.testing.assert_array_equal(lo2, flo)
    np.testing.assert_array_equal(hi2, fhi)
    # a low cap stops before these columns converge
    if cap == 1:
        assert np.abs(out - full).max() > 1e-6


def test_cap_beyond_convergence_is_exact():
    """A cap above the trips the batch needs changes nothing."""
    args = _rough_problem()
    np.testing.assert_array_equal(_capped(args, 14)[0],
                                  _capped(args, 0)[0])


def test_chunked_capped_matches_unchunked():
    """Chunked convergence groups honour the same cap (per-row math is
    independent; XLA may vectorize the row sums differently: roundoff)."""
    args = _rough_problem(n=128)
    for a, b in zip(_capped(args, 3, chunks=4), _capped(args, 3)):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14)
