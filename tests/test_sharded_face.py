"""Sharded banded face-shift DSS: bitwise-equal to the single-device face
DSS at any shard count (the one-production-path discipline of the
reference's edge pack/exchange/unpack — edge_mod.F90:366/648,
bndry_mod.F90:21)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from transport_se_tpu.config import Config
from transport_se_tpu.grid.cubesphere import build_grid
from transport_se_tpu.ops.dss_face import build_face_tables, dss_sum_t_face
from transport_se_tpu.parallel.face_sharded import (
    build_sharded_face_tables, tables_from_stack)
from transport_se_tpu.parallel.halo import ShardedDssTables, \
    build_shard_plan
from transport_se_tpu.parallel.sharded import make_mesh


def _band_dss_sharded(grid, S, x_t):
    ft = build_face_tables(grid)
    plan = build_shard_plan(grid, S)
    ftabs = build_sharded_face_tables(grid, plan, ft)
    dims = ftabs.pop("_dims")
    tabs = {k: jnp.asarray(v) for k, v in ftabs.items()}
    tabs.update(send_elem=jnp.asarray(plan.send_elem),
                send_mask=jnp.asarray(plan.send_mask),
                recv_slot=jnp.asarray(plan.recv_slot),
                recv_mask=jnp.asarray(plan.recv_mask),
                part_idx=jnp.asarray(plan.part_idx),
                part_mask=jnp.asarray(plan.part_mask),
                nbr=jnp.asarray(plan.nbr))
    mesh = make_mesh(jax.devices()[:S])

    def body(x, t):
        face = tables_from_stack(
            {k: t[k][0] for k in t if k.startswith("f_")}, dims)
        tables = ShardedDssTables(
            axis_name="e", eloc=plan.eloc, nhalo=plan.nhalo,
            perms=plan.perms, face=face,
            **{k: t[k][0] for k in t if not k.startswith("f_")})
        return tables.dss_sum_t(x)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("e"), {k: P("e") for k in tabs}),
        out_specs=P("e"), check_vma=False))
    return np.asarray(fn(x_t, tabs))


@pytest.mark.parametrize("ne,S", [(4, 2), (4, 4), (4, 8), (6, 8), (8, 4)])
def test_band_dss_bitwise_vs_global_face(ne, S):
    """Chunks cut mid-row at (6, 8) and (8, 4)+ alignments; all cases must
    reproduce the global face DSS bit for bit."""
    grid = build_grid(ne, order="raster")
    E = grid.nelem
    rng = np.random.default_rng(ne * 100 + S)
    x = jnp.asarray(rng.standard_normal((E, 16, 24)))
    ft = build_face_tables(grid)
    want = np.asarray(dss_sum_t_face(x, ft))
    got = _band_dss_sharded(grid, S, x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ne,S", [(6, 1), (4, 8), (6, 8)])
def test_sharded_neighbor_minmax_matches_single(ne, S):
    """ShardedDssTables.neighbor_minmax (halo-extended per-element bounds)
    == the single-device face tables' neighbor_minmax, exactly (min and
    max do not round)."""
    from transport_se_tpu.ops.dss import DssTables

    grid = build_grid(ne, order="raster")
    E = grid.nelem
    rng = np.random.default_rng(ne * 17 + S)
    qmin = jnp.asarray(rng.standard_normal((E, 2, 5)))
    qmax = qmin + jnp.asarray(rng.uniform(0.0, 1.0, (E, 2, 5)))
    want = DssTables.from_grid(grid, mode="face").neighbor_minmax(qmin,
                                                                 qmax)
    plan = build_shard_plan(grid, S)
    tabs = dict(send_elem=jnp.asarray(plan.send_elem),
                send_mask=jnp.asarray(plan.send_mask),
                recv_slot=jnp.asarray(plan.recv_slot),
                recv_mask=jnp.asarray(plan.recv_mask),
                part_idx=jnp.asarray(plan.part_idx),
                part_mask=jnp.asarray(plan.part_mask),
                nbr=jnp.asarray(plan.nbr))
    mesh = make_mesh(jax.devices()[:S])

    def body(a, b, t):
        tables = ShardedDssTables(
            axis_name="e", eloc=plan.eloc, nhalo=plan.nhalo,
            perms=plan.perms, **{k: v[0] for k, v in t.items()})
        return tables.neighbor_minmax(a, b)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("e"), P("e"), {k: P("e") for k in tabs}),
        out_specs=(P("e"), P("e")), check_vma=False))
    got = fn(qmin, qmax, tabs)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g_), np.asarray(w))


@pytest.mark.parametrize("ne,S", [(4, 4), (6, 8)])
def test_sharded_face_pipeline_matches_single(ne, S):
    """Full subcycle with dss_mode='face' under shard_map == single-device
    face pipeline.  ne=4/S=4 is row-aligned (eloc=24); ne=6/S=8 cuts
    shards mid-row (eloc=27) so the integrated path inherits the band
    unit test's hardest alignment."""
    from transport_se_tpu.model.core import (build_model, initial_qdp,
                                             make_subcycle_fn)
    from transport_se_tpu.parallel.sharded import make_sharded_subcycle

    cfg = Config(ne=ne, nlev=8, qsize=2, tstep=1200.0, vcoord="dcmip8",
                 test_case="dcmip1-1", nu_q=6e16, nmax=3, dtype="f64",
                 dss_mode="face", elem_order="raster")
    m = build_model(cfg)
    Qdp = initial_qdp(m)
    single, *_ = jax.jit(make_subcycle_fn(m))(Qdp,
                                              jnp.asarray(0, jnp.int32))

    mesh = make_mesh(jax.devices()[:S])
    runner = make_sharded_subcycle(m, mesh)
    assert runner.plan.halo_gid is not None
    Qs = runner.shard_qdp(Qdp)
    sharded, ps, _, min_dp = runner.step(Qs, jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(np.asarray(sharded),
                               np.asarray(single),
                               rtol=1e-12, atol=1e-13)
    assert float(min_dp) > 0


def test_sharded_std_layout_dss_sum_face_bitwise():
    """ShardedDssTables.dss_sum (std layout [E, B.., 4, 4]) dispatches
    through the banded face assembly when face tables are present
    (halo.py dss_sum) — bitwise vs the single-device face DSS.  This is
    the path the sharded pipeline takes, e.g. the NE120 phase-2
    rehearsal."""
    ne, S = 6, 8
    grid = build_grid(ne, order="raster")
    E = grid.nelem
    rng = np.random.default_rng(17)
    x = jnp.asarray(rng.standard_normal((E, 3, 5, 4, 4)))
    ft = build_face_tables(grid)
    xt = jnp.moveaxis(x.reshape(E, 15, 16), 1, 2)
    want = np.moveaxis(np.asarray(dss_sum_t_face(xt, ft)), 2, 1) \
        .reshape(E, 3, 5, 4, 4)

    plan = build_shard_plan(grid, S)
    ftabs = build_sharded_face_tables(grid, plan, ft)
    dims = ftabs.pop("_dims")
    tabs = {k: jnp.asarray(v) for k, v in ftabs.items()}
    tabs.update(send_elem=jnp.asarray(plan.send_elem),
                send_mask=jnp.asarray(plan.send_mask),
                recv_slot=jnp.asarray(plan.recv_slot),
                recv_mask=jnp.asarray(plan.recv_mask),
                part_idx=jnp.asarray(plan.part_idx),
                part_mask=jnp.asarray(plan.part_mask),
                nbr=jnp.asarray(plan.nbr))
    mesh = make_mesh(jax.devices()[:S])

    def body(xs, t):
        face = tables_from_stack(
            {k: t[k][0] for k in t if k.startswith("f_")}, dims)
        tables = ShardedDssTables(
            axis_name="e", eloc=plan.eloc, nhalo=plan.nhalo,
            perms=plan.perms, face=face,
            **{k: t[k][0] for k in t if not k.startswith("f_")})
        return tables.dss_sum(xs)

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("e"), {k: P("e") for k in tabs}),
        out_specs=P("e"), check_vma=False))
    got = np.asarray(fn(x, tabs))
    np.testing.assert_array_equal(got, want)
