"""Face-shift DSS (ops/dss_face.py) vs the partner-table DSS.

The face formulation reassociates sums (direction order instead of partner
order), so sums match to roundoff; min/max match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from transport_se_tpu.grid.cubesphere import build_grid
from transport_se_tpu.ops.dss import DssTables


@pytest.fixture(scope="module", params=[2, 4])
def grids(request):
    ne = request.param
    g = build_grid(ne, order="raster")
    return g, DssTables.from_grid(g, mode="gather"), \
        DssTables.from_grid(g, mode="face")


def test_dss_sum_t_matches(grids):
    g, tg, tf = grids
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, (g.nelem, 16, 7)))
    a = tg.dss_sum_t(x)
    b = tf.dss_sum_t(x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=0, atol=1e-13)


def test_dss_sum_standard_layout(grids):
    g, tg, tf = grids
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(-1, 1, (g.nelem, 3, 5, 4, 4)))
    a = tg.dss_sum(x)
    b = tf.dss_sum(x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=0, atol=1e-13)


def test_dss_multiplicity(grids):
    """DSS of a constant-1 field counts coincident slots: 2 on edges,
    4 at regular corners, 3 at the 8 cube vertices, 1 inside."""
    g, tg, tf = grids
    ones = jnp.ones((g.nelem, 16, 1))
    m = np.asarray(tf.dss_sum_t(ones))[..., 0]
    mg = np.asarray(tg.dss_sum_t(ones))[..., 0]
    np.testing.assert_array_equal(m, mg)
    vals, counts = np.unique(m.reshape(-1), return_counts=True)
    assert set(vals.astype(int)) == {1, 2, 3, 4}
    # exactly 8 cube vertices, each represented by 3 slots
    assert counts[list(vals).index(3.0)] == 24


def test_neighbor_minmax_matches(grids):
    g, tg, tf = grids
    rng = np.random.default_rng(2)
    qmin = jnp.asarray(rng.uniform(-1, 1, (g.nelem, 3, 4)))
    qmax = jnp.asarray(rng.uniform(-1, 1, (g.nelem, 3, 4)))
    a_min, a_max = tg.neighbor_minmax(qmin, qmax)
    b_min, b_max = tf.neighbor_minmax(qmin, qmax)
    np.testing.assert_array_equal(np.asarray(a_min), np.asarray(b_min))
    np.testing.assert_array_equal(np.asarray(a_max), np.asarray(b_max))


def test_raster_grid_equivalence():
    """Raster and gilbert orders hold identical per-element data (the
    order is a permutation; physical content must agree)."""
    gr = build_grid(2, order="raster")
    gg = build_grid(2, order="gilbert")
    # match elements by (face, ex, ey)
    key_r = gr.face * 10000 + gr.ey * 100 + gr.ex
    key_g = gg.face * 10000 + gg.ey * 100 + gg.ex
    pr, pg = np.argsort(key_r), np.argsort(key_g)
    np.testing.assert_allclose(gr.spheremp[pr], gg.spheremp[pg], rtol=1e-15)
    np.testing.assert_allclose(gr.lon[pr], gg.lon[pg], rtol=0, atol=1e-14)
    np.testing.assert_allclose(gr.rspheremp[pr], gg.rspheremp[pg],
                               rtol=1e-15)


def test_face_dss_is_linear(grids):
    """DSS(a x + b y) == a DSS(x) + b DSS(y) for the face assembly."""
    g, tg, tf = grids
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((g.nelem, 16, 5)))
    y = jnp.asarray(rng.standard_normal((g.nelem, 16, 5)))
    lhs = tf.dss_sum_t(2.5 * x - 0.75 * y)
    rhs = 2.5 * tf.dss_sum_t(x) - 0.75 * tf.dss_sum_t(y)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs),
                               rtol=0, atol=1e-13)


def test_face_projection_is_idempotent(grids):
    """rspheremp * DSS(spheremp * x) (make_C0) is a projection: applying
    it twice changes nothing beyond roundoff."""
    from transport_se_tpu.ops.dss import dss_scale
    g, tg, tf = grids
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.standard_normal((g.nelem, 3, 4, 4)))
    sp, rsp = jnp.asarray(g.spheremp), jnp.asarray(g.rspheremp)
    once = dss_scale(x, sp, rsp, tf)
    twice = dss_scale(once, sp, rsp, tf)
    np.testing.assert_allclose(np.asarray(twice), np.asarray(once),
                               rtol=0, atol=1e-13)
