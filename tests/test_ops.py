"""Spherical operator and DSS tests.

Key identity (stated in the reference, derivative_mod.F90:2035-2036):
after DSS, divergence_sphere and divergence_sphere_wk agree to roundoff.
Also: gradient of smooth analytic fields matches closed forms; DSS
reproduces the host-side scatter-add reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from transport_se_tpu.constants import REARTH
from transport_se_tpu.grid.cubesphere import build_grid
from transport_se_tpu.ops import sphere_ops as so
from transport_se_tpu.ops.dss import (DssTables, dss_sum, dss_sum_np,
                                      dss_scale, neighbor_minmax)


@pytest.fixture(scope="module")
def G():
    return build_grid(6)


@pytest.fixture(scope="module")
def T(G):
    return DssTables.from_grid(G)


def _metric(G):
    return dict(deriv=jnp.asarray(G.deriv), Dinv=jnp.asarray(G.Dinv),
                D=jnp.asarray(G.D), metdet=jnp.asarray(G.metdet),
                rmetdet=jnp.asarray(G.rmetdet),
                spheremp=jnp.asarray(G.spheremp),
                rspheremp=jnp.asarray(G.rspheremp))


def test_gradient_of_sphere_harmonic(G):
    m = _metric(G)
    lon, lat = jnp.asarray(G.lon), jnp.asarray(G.lat)
    # f = sin(lat): grad = (0, cos(lat)/a)
    f = jnp.sin(lat)
    g = so.gradient_sphere(f, m['deriv'], m['Dinv'])
    # SE derivative of a smooth non-polynomial field: O(dx^(np-1))
    # truncation, ~1e-3 relative at ne=6/np=4
    assert np.abs(g[:, 0] - 0).max() < 1e-2 / REARTH
    assert np.abs(g[:, 1] - jnp.cos(lat) / REARTH).max() < 1e-2 / REARTH


def test_divergence_of_solid_body(G):
    m = _metric(G)
    lon, lat = jnp.asarray(G.lon), jnp.asarray(G.lat)
    # solid body rotation u = U0 cos(lat): divergence-free
    u = jnp.cos(lat)
    v = jnp.stack([u, jnp.zeros_like(u)], axis=1)
    div = so.divergence_sphere(v, m['deriv'], m['Dinv'], m['metdet'],
                               m['rmetdet'])
    # analytically divergence-free; SE truncation ~5e-3/a at ne=6/np=4
    assert np.abs(div).max() < 2e-2 / REARTH


def test_weak_strong_divergence_dss_identity(G, T):
    """DSS(spheremp*div_strong) == DSS(div_wk), both scaled by rspheremp.

    Holds for C0 input fields (derivative_mod.F90:2035-2036), so project the
    random field into the continuous space first.
    """
    m = _metric(G)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((G.nelem, 2, 4, 4)))
    v = dss_scale(v, m['spheremp'], m['rspheremp'], T)  # make C0
    div_s = so.divergence_sphere(v, m['deriv'], m['Dinv'], m['metdet'],
                                 m['rmetdet'])
    div_w = so.divergence_sphere_wk(v, m['deriv'], m['Dinv'], m['spheremp'])
    a = dss_scale(div_s, m['spheremp'], m['rspheremp'], T)
    rsp = m['rspheremp']
    b = dss_sum(div_w, T) * rsp
    # v is discontinuous so the identity holds only for the assembled values
    scale = np.abs(np.asarray(a)).max()
    assert np.abs(np.asarray(a - b)).max() < 1e-12 * max(scale, 1.0)


def test_dss_matches_host_reference(G, T):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((G.nelem, 3, 4, 4))
    got = np.asarray(dss_sum(jnp.asarray(x), T))
    want = np.stack([dss_sum_np(x[:, b], G.gid, G.ngid)
                     for b in range(3)], axis=1)
    assert np.abs(got - want).max() < 1e-13


def test_dss_idempotent_on_continuous_field(G, T):
    # C0 projection of an already-continuous field is the identity
    lat = jnp.asarray(G.lat)
    f = jnp.sin(3 * lat) * jnp.cos(lat)
    sp = jnp.asarray(G.spheremp)
    rsp = jnp.asarray(G.rspheremp)
    g = dss_scale(f, sp, rsp, T)
    assert np.abs(np.asarray(g - f)).max() < 1e-13


def test_neighbor_minmax(G, T):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((G.nelem, 5))
    gmin, gmax = neighbor_minmax(jnp.asarray(q), jnp.asarray(q), T)
    # brute force via neighbor sets
    for e in [0, 7, G.nelem // 2, G.nelem - 1]:
        nbrs = set(int(n) for n in G.nbr[e])
        want_min = min(q[n].min() for n in nbrs)  # noqa: vectorized below
        got = np.asarray(gmin[e])
        want = np.min([q[n] for n in nbrs], axis=0)
        assert np.allclose(got, want)
        wantx = np.max([q[n] for n in nbrs], axis=0)
        assert np.allclose(np.asarray(gmax[e]), wantx)


def test_laplacian_of_constant_is_zero_after_dss(G, T):
    m = _metric(G)
    f = jnp.ones((G.nelem, 4, 4))
    lap = so.laplace_sphere_wk(f, m['deriv'], m['Dinv'], m['spheremp'])
    assembled = dss_sum(lap, T) * m['rspheremp']
    assert np.abs(np.asarray(assembled)).max() < 1e-18 * REARTH


def test_dss_segsum_matches_gather():
    """segsum assembly == partner-gather assembly (up to f64 roundoff) and
    the T-layout variant matches the standard layout exactly."""
    import jax.numpy as jnp
    from transport_se_tpu.grid.cubesphere import build_grid
    from transport_se_tpu.ops.dss import DssTables

    g = build_grid(3)
    E = g.nelem
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-1, 1, (E, 5, 4, 4)))

    tg = DssTables.from_grid(g, mode="gather")
    ts = DssTables.from_grid(g, mode="segsum")
    a = np.asarray(tg.dss_sum(x))
    b = np.asarray(ts.dss_sum(x))
    np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-15)

    xt = jnp.moveaxis(x.reshape(E, 5, 16), -1, 1)    # [E, 16, 5]
    at = np.asarray(tg.dss_sum_t(xt))
    bt = np.asarray(ts.dss_sum_t(xt))
    want_t = np.moveaxis(a.reshape(E, 5, 16), -1, 1)
    np.testing.assert_array_equal(at, np.asarray(
        jnp.moveaxis(jnp.asarray(a).reshape(E, 5, 16), -1, 1)))
    np.testing.assert_allclose(bt, want_t, rtol=1e-14, atol=1e-15)


def _dot_precisions(fn, *args):
    """Precision of every dot_general in fn's jaxpr (nested jaxprs too)."""
    import jax
    from jax.extend import core as jex_core

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn.params["precision"]
            for v in eqn.params.values():
                if isinstance(v, jex_core.ClosedJaxpr):
                    yield from walk(v.jaxpr)
                elif isinstance(v, jex_core.Jaxpr):
                    yield from walk(v)

    return list(walk(jax.make_jaxpr(fn)(*args).jaxpr))


@pytest.mark.parametrize("op", ["gradient", "divergence", "divergence_wk",
                                "laplace", "vorticity"])
def test_contractions_ask_for_highest_precision(G, op):
    """Every 4x4 contraction asks for HIGHEST precision, so a GPU never
    runs the float32 operators in TF32 (about three decimal digits)."""
    import jax
    m = _metric(G)
    E = G.nelem
    s = jnp.ones((E, 2, 4, 4), jnp.float32)
    v = jnp.ones((E, 2, 2, 4, 4), jnp.float32)
    d = {k: x.astype(jnp.float32) for k, x in m.items()}
    fn, arg = {
        "gradient": (lambda a: so.gradient_sphere(a, d["deriv"], d["Dinv"]),
                     s),
        "divergence": (lambda a: so.divergence_sphere(
            a, d["deriv"], d["Dinv"], d["metdet"], d["rmetdet"]), v),
        "divergence_wk": (lambda a: so.divergence_sphere_wk(
            a, d["deriv"], d["Dinv"], d["spheremp"]), v),
        "laplace": (lambda a: so.laplace_sphere_wk(
            a, d["deriv"], d["Dinv"], d["spheremp"]), s),
        "vorticity": (lambda a: so.vorticity_sphere(
            a, d["deriv"], d["D"], d["rmetdet"]), v),
    }[op]
    precs = _dot_precisions(fn, arg)
    assert precs, "no contraction found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(x == hi for x in p), p
