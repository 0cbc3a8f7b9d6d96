"""Multi-chip domain decomposition: halo-exchange plan + sharded DSS.

Device replacement for the reference's MPI communication stack
(reference: metagraph_mod.F90:228 `initMetaGraph`, schedule_mod.F90:36
`genEdgeSched`, bndry_mod.F90:21 `bndry_exchangeV`).  The element axis is
sharded over the device mesh in canonical SFC order (contiguous chunks, the
`genspacepart` discipline, spacecurve_mod.F90:1218); inter-shard coupling is
a *halo of whole elements*: each shard receives, once per exchange, the
field data of every remote element that shares at least one GLL point with
one of its local elements.

Key structural properties carried over from the reference (SURVEY.md §5):
* all traffic between a shard pair is ONE aggregated message per exchange
  (the FindBufferSlot discipline) — here one `lax.ppermute` payload;
* exchanges are scheduled in rounds (a greedy edge coloring of the shard
  traffic graph); each round is a partial permutation, so every round is a
  single collective-permute;
* the combine operation (sum for DSS, min/max for limiter bounds) is applied
  locally against tables whose *partner order is identical to the
  single-device tables*, so results are bitwise independent of the shard
  count (the BFB-under-task-count property, reference README:46-48).

The plan is built once on host (numpy) — the analog of prim_init1's schedule
generation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side description of the decomposition (numpy arrays).

    All `[S, ...]` arrays are sharded over the mesh axis when entering
    shard_map, so each shard sees its own row.
    """
    nshards: int
    eloc: int                 # elements per shard
    nhalo: int                # max halo elements over shards (padded size)
    nrounds: int              # exchange rounds (max shard degree)
    maxsend: int              # max elements per message (padded)
    # exchange schedule
    send_peer: np.ndarray     # [S, R] int32 peer shard (or -1: idle round)
    send_elem: np.ndarray     # [S, R, C] int32 local element idx to send
    send_mask: np.ndarray     # [S, R, C] bool
    recv_slot: np.ndarray     # [S, R, C] int32 halo slot for received elems
    recv_mask: np.ndarray     # [S, R, C] bool
    perms: tuple              # tuple over rounds of ((src,dst), ...) pairs
    # local tables against the extended (local + halo) element array
    part_idx: np.ndarray      # [S, eloc*16, 3] int32 into (eloc+nhalo)*16
    part_mask: np.ndarray     # [S, eloc*16, 3] bool
    nbr: np.ndarray           # [S, eloc, 9] int32 into eloc+nhalo
    # halo membership (global element ids per halo slot; face-DSS builder)
    halo_gid: np.ndarray = None   # [S, nhalo] int64 (-1 = unused slot)


def build_shard_plan(grid, nshards: int) -> ShardPlan:
    """Contiguous chunks of the element order, one per shard."""
    E = grid.nelem
    if E % nshards != 0:
        raise ValueError(f"nelem {E} not divisible by {nshards} shards")
    eloc = E // nshards
    shard_of = np.arange(E) // eloc
    local_of = np.arange(E) % eloc

    # halo sets per shard, ordered by global element id (determinism)
    halos = []
    for s in range(nshards):
        h = set()
        for e in range(s * eloc, (s + 1) * eloc):
            for n in grid.nbr[e]:
                if shard_of[n] != s:
                    h.add(int(n))
        halos.append(sorted(h))
    nhalo = max((len(h) for h in halos), default=0)
    nhalo = max(nhalo, 1)

    # halo position lookup: halo_pos[s][global_e] -> slot
    halo_pos = [dict((e, i) for i, e in enumerate(h)) for h in halos]

    # traffic: src shard -> dst shard carries elements sorted by global id
    traffic = {}
    for d in range(nshards):
        for e in halos[d]:
            traffic.setdefault((int(shard_of[e]), d), []).append(e)

    # greedy edge coloring into rounds: each round a partial permutation
    pairs = sorted(traffic.keys())
    rounds: list[list] = []
    for (s, d) in pairs:
        placed = False
        for r in rounds:
            if all(ss != s and dd != d for ss, dd in r):
                r.append((s, d))
                placed = True
                break
        if not placed:
            rounds.append([(s, d)])
    nrounds = len(rounds)   # 0 when there is no cross-shard traffic (S=1)
    maxsend = max((len(v) for v in traffic.values()), default=1)

    send_peer = np.full((nshards, nrounds), -1, np.int32)
    send_elem = np.zeros((nshards, nrounds, maxsend), np.int32)
    send_mask = np.zeros((nshards, nrounds, maxsend), bool)
    recv_slot = np.zeros((nshards, nrounds, maxsend), np.int32)
    recv_mask = np.zeros((nshards, nrounds, maxsend), bool)
    perms = []
    for r, pr in enumerate(rounds):
        perms.append(tuple(pr))
        for (s, d) in pr:
            elems = traffic[(s, d)]
            send_peer[s, r] = d
            for c, e in enumerate(elems):
                send_elem[s, r, c] = local_of[e]
                send_mask[s, r, c] = True
                recv_slot[d, r, c] = halo_pos[d][e]
                recv_mask[d, r, c] = True

    # extended tables: remap global partner/neighbor ids to local/halo ids
    def ext_id(s, e):
        if shard_of[e] == s:
            return local_of[e]
        return eloc + halo_pos[s][int(e)]

    part_idx = np.zeros((nshards, eloc * 16, 3), np.int32)
    part_mask = np.zeros((nshards, eloc * 16, 3), bool)
    nbr = np.zeros((nshards, eloc, 9), np.int32)
    for s in range(nshards):
        base = s * eloc
        for ge in range(base, base + eloc):
            el = int(local_of[ge])
            for k in range(9):
                nbr[s, el, k] = ext_id(s, int(grid.nbr[ge, k]))
            for slot in range(16):
                gf = ge * 16 + slot
                lf = el * 16 + slot
                for c in range(3):
                    if grid.part_mask[gf, c]:
                        pg = int(grid.part_idx[gf, c])
                        pe, ps_ = divmod(pg, 16)
                        part_idx[s, lf, c] = ext_id(s, pe) * 16 + ps_
                        part_mask[s, lf, c] = True
                    else:
                        part_idx[s, lf, c] = lf
    halo_gid = np.full((nshards, nhalo), -1, np.int64)
    for s in range(nshards):
        for i, e in enumerate(halos[s]):
            halo_gid[s, i] = e

    return ShardPlan(nshards=nshards, eloc=eloc, nhalo=nhalo,
                     nrounds=nrounds, maxsend=maxsend,
                     send_peer=send_peer, send_elem=send_elem,
                     send_mask=send_mask, recv_slot=recv_slot,
                     recv_mask=recv_mask, perms=tuple(perms),
                     part_idx=part_idx, part_mask=part_mask, nbr=nbr,
                     halo_gid=halo_gid)


# ---------------------------------------------------------------------------
# device-side tables (the per-shard slices live inside shard_map)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedDssTables:
    """Per-shard view used INSIDE shard_map.  Arrays carry the local slice
    (leading [S] axis consumed by the shard_map in_specs)."""
    axis_name: str
    eloc: int
    nhalo: int
    perms: tuple              # static
    send_elem: jnp.ndarray    # [R, C]
    send_mask: jnp.ndarray    # [R, C]
    recv_slot: jnp.ndarray    # [R, C]
    recv_mask: jnp.ndarray    # [R, C]
    part_idx: jnp.ndarray     # [eloc*16, 3]
    part_mask: jnp.ndarray    # [eloc*16, 3]
    nbr: jnp.ndarray          # [eloc, 9]
    face: object = None       # ShardedFaceTables: banded face-shift
                              # assembly (parallel/face_sharded.py) in
                              # place of the partner-table gathers

    # -- halo exchange of whole-element slabs ------------------------------
    def _halo_rounds(self, src):
        """Permute rounds gathering the send slabs of `src` [eloc, ...]."""
        R, C = self.send_elem.shape
        halo = jnp.zeros((self.nhalo,) + src.shape[1:], src.dtype)
        for r in range(R):
            payload = src[self.send_elem[r]]                  # [C, B...]
            mask = self.send_mask[r].reshape(
                (C,) + (1,) * (src.ndim - 1))
            payload = jnp.where(mask, payload, 0)
            recv = jax.lax.ppermute(payload, self.axis_name,
                                    perm=list(self.perms[r]))
            rmask = self.recv_mask[r].reshape(mask.shape)
            # scatter-ADD into halo slots: masked lanes contribute 0, so
            # duplicate padded indices (slot 0) stay correct
            halo = halo.at[self.recv_slot[r]].add(
                jnp.where(rmask, recv, 0))
        return halo

    def halo_extend(self, x):
        """x: [eloc, ...] -> [eloc+nhalo, ...]: the local elements, then
        the halo elements (fields or per-element values)."""
        return jnp.concatenate([x, self._halo_rounds(x)], axis=0)

    # -- same combine semantics as ops/dss.py ------------------------------
    def dss_sum(self, x):
        if self.face is not None:
            # banded face assembly for the std layout too (one production
            # assembly at any layout/rank count — edge_mod.F90:366/648,
            # mirroring DssTables.dss_sum's face-mode T-view round trip)
            E = x.shape[0]
            nn = x.shape[-1] * x.shape[-2]
            xt = jnp.moveaxis(x.reshape(E, -1, nn), 1, 2)     # [E, nn, B]
            out = self.dss_sum_t(xt)
            return jnp.moveaxis(out, 2, 1).reshape(x.shape)
        xe = self.halo_extend(x)
        E1 = xe.shape[0]
        nn = x.shape[-1] * x.shape[-2]
        xf = xe.reshape(E1, -1, nn)
        xf = jnp.moveaxis(xf, 0, 1).reshape(-1, E1 * nn)      # [B, E1*nn]
        own = xf[:, :self.eloc * nn]
        partners = xf[:, self.part_idx]                       # [B, eloc*nn, 3]
        contrib = jnp.where(self.part_mask, partners, 0).sum(axis=-1)
        out = own + contrib
        out = out.reshape(-1, self.eloc, nn)
        out = jnp.moveaxis(out, 1, 0)
        return out.reshape(x.shape)

    def dss_sum_t(self, x_t):
        """DSS on T-layout fields [eloc, 16, B] (point axis second)."""
        halo = self._halo_rounds(x_t)
        if self.face is not None:
            from .face_sharded import dss_sum_t_face_band
            ext = jnp.concatenate([x_t, halo], axis=0)
            return dss_sum_t_face_band(x_t, ext, self.face)
        return self._dss_from(x_t, halo)

    def _dss_from(self, x_t, halo):
        xe = jnp.concatenate([x_t, halo], axis=0)             # [eloc+h,16,B]
        E1 = xe.shape[0]
        B = x_t.shape[-1]
        xf = xe.reshape(E1 * 16, B)
        own = xf[:self.eloc * 16]
        partners = xf[self.part_idx]                          # [eloc*16,3,B]
        contrib = jnp.where(self.part_mask[..., None], partners, 0)
        return (own + contrib.sum(axis=1)).reshape(x_t.shape)

    def global_min(self, x):
        return jax.lax.pmin(x.min(), self.axis_name)

    def neighbor_minmax(self, qmin, qmax):
        qmin_e = self.halo_extend(qmin)
        qmax_e = self.halo_extend(qmax)
        gmin = jnp.min(qmin_e[self.nbr], axis=1)
        gmax = jnp.max(qmax_e[self.nbr], axis=1)
        return gmin, gmax
