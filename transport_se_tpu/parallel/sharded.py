"""SPMD execution over a device mesh: the whole subcycle under shard_map.

The element axis is sharded in canonical SFC order over a 1-D mesh
('e' axis); levels and tracers stay local batch dims (the reference's
COLUMN_OPENMP / tracer-dimension parallelism collapse into XLA batching —
SURVEY.md §2.5).  Inside shard_map the model core runs unchanged against
per-shard metric slices and a ShardedDssTables whose halo exchanges are
`lax.ppermute` rounds (parallel/halo.py), which XLA hands to NCCL on GPUs.

This replaces the reference's MPI rank decomposition (one rank = one shard;
prim_main.F90 + bndry_mod.F90); results are invariant under the shard count
(the reference's BFB-under-task-count property, README:46-48) — tested in
tests/test_sharded.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..model.core import Model, make_subcycle_fn
from .halo import ShardPlan, ShardedDssTables, build_shard_plan

AXIS = "e"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


@dataclasses.dataclass(frozen=True)
class ShardedRunner:
    """Holds the mesh, plan, and the jitted sharded subcycle step."""
    model: Model
    mesh: Mesh
    plan: ShardPlan
    step: object          # fn(Qdp, nstep) -> (Qdp, ps_v, nstep, min_dp)
    qdp_sharding: object

    def shard_qdp(self, Qdp):
        """Qdp [E, q, k, 4, 4] -> the sharded step's input state."""
        return jax.device_put(Qdp, self.qdp_sharding)


def make_sharded_subcycle(m: Model, mesh: Mesh,
                          diagnostics: bool = False) -> ShardedRunner:
    S = mesh.devices.size
    plan = build_shard_plan(m.grid, S)
    use_face = (m.cfg.dss_mode == "face"
                and getattr(m.tables, "face", None) is not None)
    table_arrays = dict(
        send_elem=jnp.asarray(plan.send_elem),
        send_mask=jnp.asarray(plan.send_mask),
        recv_slot=jnp.asarray(plan.recv_slot),
        recv_mask=jnp.asarray(plan.recv_mask),
        part_idx=jnp.asarray(plan.part_idx),
        part_mask=jnp.asarray(plan.part_mask),
        nbr=jnp.asarray(plan.nbr),
    )
    face_dims = None
    if use_face:
        from .face_sharded import build_sharded_face_tables
        ftabs = build_sharded_face_tables(m.grid, plan, m.tables.face)
        face_dims = ftabs.pop("_dims")
        table_arrays.update({k: jnp.asarray(v) for k, v in ftabs.items()})
    elem_arrays = dict(lon=m.lon, lat=m.lat, D=m.D, Dinv=m.Dinv,
                       metdet=m.metdet, rmetdet=m.rmetdet,
                       spheremp=m.spheremp, rspheremp=m.rspheremp)

    tab_keys = list(table_arrays)
    el_keys = list(elem_arrays)

    def body(Qdp, nstep, tabs, els):
        # shard_map keeps rank: table arrays arrive as [1, ...] blocks
        face = None
        if face_dims is not None:
            from .face_sharded import tables_from_stack
            face = tables_from_stack(
                {k: tabs[k][0] for k in tab_keys if k.startswith("f_")},
                face_dims)
        tables = ShardedDssTables(
            axis_name=AXIS, eloc=plan.eloc, nhalo=plan.nhalo,
            perms=plan.perms, face=face,
            **{k: tabs[k][0] for k in tab_keys
               if not k.startswith("f_")})
        ml = dataclasses.replace(m, tables=tables,
                                 **{k: els[k] for k in el_keys})
        step = make_subcycle_fn(ml, diagnostics=diagnostics)
        Qdp, ps_v, nstep, min_dp = step(Qdp, nstep)
        min_dp = jax.lax.pmin(min_dp, AXIS)
        return Qdp, ps_v, nstep, min_dp

    eshard = P(AXIS)
    rep = P()
    tab_specs = {k: P(AXIS) for k in tab_keys}
    el_specs = {k: P(AXIS) for k in el_keys}

    smapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(eshard, rep, tab_specs, el_specs),
        out_specs=(eshard, eshard, rep, rep),
        check_vma=False)

    @jax.jit
    def step(Qdp, nstep):
        return smapped(Qdp, nstep, table_arrays, elem_arrays)

    return ShardedRunner(model=m, mesh=mesh, plan=plan, step=step,
                         qdp_sharding=NamedSharding(mesh, P(AXIS)))
