"""PPM vertical remap unit tests (vertremap semantics, see ops/ppm.py)."""

import jax.numpy as jnp
import numpy as np

from transport_se_tpu.ops.ppm import remap_q_ppm


def _remap(qdp, d1, d2):
    return np.asarray(remap_q_ppm(jnp.asarray(qdp), jnp.asarray(d1),
                                  jnp.asarray(d2)))


def test_identity_when_grids_equal():
    rng = np.random.default_rng(0)
    nlev, n, q = 72, 5, 3
    d = rng.uniform(0.5, 2.0, (n, nlev))
    qdp = rng.uniform(0.0, 1.0, (n, q, nlev)) * d[:, None]
    out = _remap(qdp, d, d)
    assert np.abs(out - qdp).max() < 1e-13 * np.abs(qdp).max()


def test_column_mass_conserved():
    rng = np.random.default_rng(1)
    nlev, n, q = 72, 7, 4
    d1 = rng.uniform(0.5, 2.0, (n, nlev))
    # small deformation (never exceeds one cell, like the model)
    d2 = d1 * (1.0 + 0.2 * rng.uniform(-1, 1, (n, nlev)))
    d2 *= (d1.sum(-1) / d2.sum(-1))[:, None]   # same column totals
    qdp = rng.uniform(0.0, 1.0, (n, q, nlev)) * d1[:, None]
    out = _remap(qdp, d1, d2)
    m0 = qdp.sum(-1)
    m1 = out.sum(-1)
    assert np.abs((m1 - m0) / m0).max() < 1e-12


def test_monotone_no_new_extrema():
    """The monotone reconstruction keeps remapped mixing ratios within the
    source column's range."""
    rng = np.random.default_rng(2)
    nlev, n = 72, 6
    d1 = np.ones((n, nlev))
    shift = 0.3 * rng.uniform(-1, 1, (n, nlev))
    d2 = d1 + np.diff(np.pad(shift, ((0, 0), (1, 0))), axis=-1)
    d2 *= (d1.sum(-1) / d2.sum(-1))[:, None]
    q = np.where(np.arange(nlev)[None, :] % 7 < 3, 1.0, 0.0)
    q = np.broadcast_to(q, (n, nlev))[:, None, :]
    qdp = q * d1[:, None]
    out = _remap(qdp, d1, d2)
    mix = out / d2[:, None]
    assert mix.min() > -1e-12
    assert mix.max() < 1.0 + 1e-12


def test_constant_mixing_ratio_preserved():
    rng = np.random.default_rng(3)
    nlev, n = 72, 4
    d1 = rng.uniform(0.5, 2.0, (n, nlev))
    d2 = d1 * (1.0 + 0.1 * rng.uniform(-1, 1, (n, nlev)))
    d2 *= (d1.sum(-1) / d2.sum(-1))[:, None]
    qdp = 0.7 * d1[:, None, :] * np.ones((n, 2, nlev))
    out = _remap(qdp, d1, d2)
    assert np.abs(out / d2[:, None] - 0.7).max() < 1e-13


def test_fast_path_matches_general():
    """The select-based fast path equals the search-based path whenever the
    grid deforms less than one cell — the regime the model (and the
    reference's own walking search) operates in."""
    from transport_se_tpu.ops.ppm import remap_q_ppm_general
    rng = np.random.default_rng(7)
    nlev, n, q = 72, 9, 5
    d1 = rng.uniform(0.5, 2.0, (n, nlev))
    # interface displacement bounded by 0.45 * min layer thickness
    eps = 0.45 * d1.min() * rng.uniform(-1, 1, (n, nlev - 1))
    pio = np.concatenate([np.zeros((n, 1)), np.cumsum(d1, -1)], -1)
    pin = pio.copy()
    pin[:, 1:-1] += eps
    d2 = np.diff(pin, axis=-1)
    qdp = rng.uniform(0.0, 1.0, (n, q, nlev)) * d1[:, None]
    fast = _remap(qdp, d1, d2)
    gen = np.asarray(remap_q_ppm_general(
        jnp.asarray(qdp), jnp.asarray(d1), jnp.asarray(d2)))
    assert np.abs(fast - gen).max() < 1e-13 * np.abs(qdp).max()


def test_alg2_no_bc_variant():
    """vert_remap_q_alg=2: piecewise-constant boundary cells, conservative,
    identical to alg 0 in the interior (prim_advection_mod.F90:336-342)."""
    import numpy as np
    import jax.numpy as jnp
    from transport_se_tpu.ops.ppm import remap_q_ppm, remap_q_ppm_general

    rng = np.random.default_rng(5)
    nlev, Q = 24, 3
    dp1 = jnp.asarray(rng.uniform(0.8, 1.2, (7, nlev)))
    shift = jnp.asarray(rng.uniform(-0.3, 0.3, (7, nlev - 1)))
    # target grid: same column total, interfaces perturbed < 1 cell
    p1 = jnp.cumsum(dp1, axis=-1)
    pin_int = p1[..., :-1] + shift * jnp.minimum(dp1[..., :-1], dp1[..., 1:])
    pin = jnp.concatenate([jnp.zeros_like(p1[..., :1]), pin_int,
                           p1[..., -1:]], axis=-1)
    dp2 = jnp.diff(pin, axis=-1)
    qdp = jnp.asarray(rng.uniform(0.0, 1.0, (7, Q, nlev))) * dp1[:, None]

    out0 = remap_q_ppm(qdp, dp1, dp2, alg=0)
    out2 = remap_q_ppm(qdp, dp1, dp2, alg=2)
    out2g = remap_q_ppm_general(qdp, dp1, dp2, alg=2)

    # conservation for both algorithms
    np.testing.assert_allclose(np.asarray(out2.sum(-1)),
                               np.asarray(qdp.sum(-1)), rtol=1e-12)
    # fast path == search path for alg 2 as well
    np.testing.assert_allclose(np.asarray(out2), np.asarray(out2g),
                               rtol=1e-12, atol=1e-14)
    # interior (cells >= 3 from each boundary) unaffected by the bc choice
    np.testing.assert_allclose(np.asarray(out0[..., 3:-3]),
                               np.asarray(out2[..., 3:-3]),
                               rtol=1e-12, atol=1e-14)
    # the variants genuinely differ at the boundary
    assert float(jnp.abs(out0 - out2).max()) > 0


def test_fast_matches_general_2cell():
    """The select fast path must handle interfaces displaced up to TWO
    source cells (DCMIP 1-2's Hadley circulation reaches +-2 at
    NE8/acme-72/dt_remap=1200 s; a 1-cell-only select silently corrupts
    the remap and blows the run up — regression test)."""
    import numpy as np
    import jax.numpy as jnp
    from transport_se_tpu.ops.ppm import remap_q_ppm, remap_q_ppm_general

    rng = np.random.default_rng(11)
    nlev, Q, N = 40, 3, 50
    dp1 = jnp.asarray(rng.uniform(0.5, 1.5, (N, nlev)))
    pio = jnp.concatenate([jnp.zeros_like(dp1[..., :1]),
                           jnp.cumsum(dp1, -1)], -1)
    # prescribe a smooth displacement pattern d(k) in {-2..2}: interior
    # target interface k sits inside source cell k + d(k)
    k = np.arange(1, nlev)
    d = np.round(2.0 * np.sin(2.0 * np.pi * k / nlev)).astype(int)
    src = np.clip(k + d, 0, nlev - 1)
    frac = 0.2 + 0.01 * k / nlev + 0.005 * np.arange(k.size) / k.size
    pin_int = (np.asarray(pio)[:, src]
               + (0.2 + 0.01 * np.arange(k.size)) / 1.0
               * np.asarray(dp1)[:, src] * 0.5)
    pin = np.concatenate([np.zeros((N, 1)), pin_int,
                          np.asarray(pio)[:, -1:]], axis=-1)
    assert (np.diff(pin, axis=-1) > 0).all()
    dp2 = jnp.asarray(np.diff(pin, axis=-1))
    assert int(np.abs(d).max()) == 2
    qdp = jnp.asarray(rng.uniform(0.0, 1.0, (N, Q, nlev))) * dp1[:, None]

    fast = remap_q_ppm(qdp, dp1, dp2)
    gen = remap_q_ppm_general(qdp, dp1, dp2)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(gen),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(fast.sum(-1)),
                               np.asarray(qdp.sum(-1)), rtol=1e-12)


def test_fast_margin_guard():
    """ppm_fast_margin flags >2-cell interface displacement (the fast
    path's silent-wrong-mass regime) while staying positive for small
    deformation."""
    from transport_se_tpu.ops.ppm import ppm_fast_margin
    nlev = 12
    dp1 = jnp.ones((3, nlev))
    # mild deformation: +-20% — well within the window
    wiggle = 1.0 + 0.2 * jnp.sin(jnp.arange(nlev))
    d1 = dp1 * wiggle
    d1 = d1 * (nlev / d1.sum(-1, keepdims=True))
    assert float(ppm_fast_margin(d1, dp1)) > 0
    # severe: all the source mass concentrated in the first cells so the
    # later target interfaces fall > 2 source cells away
    d_bad = jnp.concatenate(
        [jnp.full((3, 4), (nlev - 0.4 * (nlev - 4)) / 4),
         jnp.full((3, nlev - 4), 0.4)], axis=-1)
    assert float(ppm_fast_margin(d_bad, dp1)) < 0
    # the guard must fire exactly when fast disagrees with the oracle
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.uniform(0.2, 1.0, (3, 2, nlev))) * d_bad[:, None]
    from transport_se_tpu.ops.ppm import remap_q_ppm_general
    fast = remap_q_ppm(q, d_bad, dp1)
    gen = remap_q_ppm_general(q, d_bad, dp1)
    assert float(jnp.abs(fast - gen).max()) > 1e-6


def test_fast_matches_general_down2():
    """The -2 shift level (DCMIP1-2's thin-layer downdraft regime) must
    agree with the unbounded search exactly."""
    from transport_se_tpu.ops.ppm import (ppm_fast_margin,
                                          remap_q_ppm_general)
    nlev = 16
    rng = np.random.default_rng(7)
    # thin cells in the middle so a modest interface displacement spans
    # 2 source cells downward
    w1 = np.ones(nlev)
    w1[6:10] = 0.15
    d1 = jnp.asarray(np.tile(w1, (4, 1)))
    d1 = d1 * (nlev / d1.sum(-1, keepdims=True))
    # target grid uniform, same total
    d2 = jnp.full((4, nlev), 1.0) * (d1.sum(-1, keepdims=True) / nlev)
    assert float(ppm_fast_margin(d1, d2)) >= 0
    q = jnp.asarray(rng.uniform(0.2, 1.0, (4, 3, nlev))) * d1[:, None]
    fast = remap_q_ppm(q, d1, d2)
    gen = remap_q_ppm_general(q, d1, d2)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(gen),
                               rtol=1e-12, atol=1e-13)
