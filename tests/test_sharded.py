"""Multi-chip sharding: results must be invariant under shard count
(the reference's BFB-across-task-count property, README:46-48)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from transport_se_tpu.config import Config
from transport_se_tpu.model.core import build_model, initial_qdp, \
    make_subcycle_fn
from transport_se_tpu.parallel.halo import build_shard_plan
from transport_se_tpu.parallel.sharded import make_mesh, \
    make_sharded_subcycle


@pytest.fixture(scope="module")
def M():
    cfg = Config(ne=4, nlev=72, qsize=2, tstep=1200.0, nu_q=6e16, nmax=3)
    return build_model(cfg)


def test_shard_plan_consistency(M):
    plan = build_shard_plan(M.grid, 8)
    assert plan.eloc * 8 == M.grid.nelem
    # every send has a matching recv slot
    assert plan.send_mask.sum() == plan.recv_mask.sum()
    # halo coverage: all remote neighbors present
    for s in range(8):
        local = set(range(s * plan.eloc, (s + 1) * plan.eloc))
        need = set()
        for e in local:
            need.update(int(n) for n in M.grid.nbr[e])
        assert len(need - local) <= plan.nhalo


@pytest.mark.parametrize("nshards", [2, 8])
def test_sharded_matches_single_device(M, nshards):
    devices = jax.devices()[:nshards]
    assert len(devices) == nshards
    mesh = make_mesh(devices)

    Qdp0 = jax.jit(lambda: initial_qdp(M))()
    n0 = jnp.asarray(0, jnp.int32)

    ref_step = jax.jit(make_subcycle_fn(M))
    Qref, ps_ref, n_ref, mindp_ref = ref_step(Qdp0, n0)
    Qref, ps_ref = np.asarray(Qref), np.asarray(ps_ref)

    runner = make_sharded_subcycle(M, mesh)
    Qs = runner.shard_qdp(Qdp0)
    Qsh, ps_sh, n_sh, mindp_sh = runner.step(Qs, n0)
    Qsh, ps_sh = np.asarray(Qsh), np.asarray(ps_sh)

    scale = np.abs(Qref).max()
    assert np.abs(Qsh - Qref).max() < 1e-13 * scale
    assert np.abs(ps_sh - ps_ref).max() < 1e-9
    assert abs(float(mindp_sh) - float(mindp_ref)) < 1e-9
    assert int(n_sh) == int(n_ref) == 3


def test_sharded_multi_step_invariance(M):
    mesh = make_mesh(jax.devices()[:4])
    Qdp0 = jax.jit(lambda: initial_qdp(M))()
    n = jnp.asarray(0, jnp.int32)

    ref_step = jax.jit(make_subcycle_fn(M))
    runner = make_sharded_subcycle(M, mesh)

    Qr = Qdp0
    Qs = runner.shard_qdp(Qdp0)
    nr = ns = n
    for _ in range(2):
        Qr, _, nr, _ = ref_step(Qr, nr)
        Qs, _, ns, _ = runner.step(Qs, ns)
    diff = np.abs(np.asarray(Qs) - np.asarray(Qr)).max()
    assert diff < 1e-12 * float(jnp.abs(Qr).max())
