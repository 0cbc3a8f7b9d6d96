"""Sharded face-shift DSS: the fast assembly, per shard, for any shard count.

The face-shift DSS (ops/dss_face.py) works on the whole cubed sphere;
without this module the sharded pipeline would fall back to partner-table
gathers — a different program than the single-device one.  This module
carries the shifted-slice assembly into the sharded path so there is
ONE production assembly at any shard count — the discipline of the
reference, whose edge pack/exchange/unpack is the same code at every rank
count (reference: edge_mod.F90:366/648 + bndry_mod.F90:21; cuda_mod.F90:
932-1009 unifies device and MPI assembly the same way).

Design: elements are sharded as contiguous chunks of the raster face order
(index = face*ne^2 + ey*ne + ex) — chunk boundaries may cut mid-row.  Each
shard rebuilds a row-aligned *band* view of its chunk:

    band = dynamic_slice(concat([head, x_local, tail]), o)      # rows
         -> [nr, ne, 16, B]   (nr whole element rows, incl. one ghost row
                               above and below the chunk)

where `head`/`tail` are small gathers (2ne/3ne elements) from the halo-
extended array (the whole-element halo exchange of parallel/halo.py already
delivers every point-sharing remote element), and `o` is a per-shard
row-alignment offset carried as data (shard_map is SPMD: shapes are
uniform, per-shard differences ride in tables).  On the band, the DSS is
the exact shifted-slice assembly of ops/dss_face.py: +-x partners are
in-row shifts with seam ghost columns, +-y partners are row shifts masked
at face transitions (y-seam ghost strips patched in at the transitions via
dynamic row updates), corner diagonals one small gather.  Contributions are
summed in the SAME order as the single-device face DSS, so the result is
bitwise identical to it at any shard count (tested).

The ppermute halo machinery is unchanged — it only supplies the seams; the
O(field) work is streaming shifted adds, not gathers.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ShardedFaceTables", "build_sharded_face_tables",
           "dss_sum_t_face_band"]


@dataclasses.dataclass(frozen=True)
class ShardedFaceTables:
    """Per-shard band tables.  Built host-side as [S, ...] stacks; inside
    shard_map each shard sees its own slice (leading axis consumed)."""
    ne: int
    eloc: int
    nr: int                   # band rows (whole element rows incl. ghosts)
    npatch: int               # y-seam patch slots
    band_o: jnp.ndarray       # [1] int32 row-alignment offset into
                              #     concat([head, x, tail])
    head_idx: jnp.ndarray     # [2ne] int32 into ext elements
    head_mask: jnp.ndarray    # [2ne] bool
    tail_idx: jnp.ndarray     # [3ne]
    tail_mask: jnp.ndarray
    gpx_idx: jnp.ndarray      # [nr, 4] int32 into ext flat slots (e*16+s)
    gpx_mask: jnp.ndarray
    gmx_idx: jnp.ndarray
    gmx_mask: jnp.ndarray
    ysame_up: jnp.ndarray     # [nr] bool: row r+1 is the same face
    ysame_dn: jnp.ndarray     # [nr] bool: row r-1 is the same face
    pa_pos: jnp.ndarray       # [P] int32 band row of an above-patch
    pa_idx: jnp.ndarray       # [P, ne, 4] int32 into ext flat slots
    pa_mask: jnp.ndarray      # [P, ne, 4] bool
    pb_pos: jnp.ndarray       # [P] below-patches
    pb_idx: jnp.ndarray
    pb_mask: jnp.ndarray
    diag_idx: jnp.ndarray     # [eloc, 4] int32 into ext flat slots
    diag_mask: jnp.ndarray    # [eloc, 4] bool
    # static (python-int) band offset when identical on every shard
    # (row-aligned eloc) — enables static band/output slicing; None
    # when shards cut mid-row (offsets then differ per shard)
    band_o_static: int | None = None


def build_sharded_face_tables(grid, plan, ft) -> dict:
    """Build [S, ...] table stacks for the banded face DSS.

    grid: cubesphere Grid in raster order; plan: ShardPlan;
    ft: global FaceTables (ops/dss_face.py).  Returns dict of numpy arrays
    plus the static dims, for sharded.py to thread through shard_map.
    """
    ne = grid.ne
    E = grid.nelem
    S = plan.nshards
    eloc = plan.eloc
    if eloc < 2 * ne:
        raise ValueError(f"face-sharded DSS needs >= 2 rows per shard "
                         f"(eloc {eloc} < 2*ne {2 * ne})")
    nrows_all = 6 * ne
    nr = (eloc + 4 * ne - 1) // ne

    g_px = np.asarray(ft.ghost_px)        # [6, ne, 4] global flat slots
    g_mx = np.asarray(ft.ghost_mx)
    g_py = np.asarray(ft.ghost_py)
    g_my = np.asarray(ft.ghost_my)
    g_diag = np.asarray(ft.diag_idx)      # [E, 4]
    g_diag_mask = np.asarray(ft.diag_mask)
    halo_gid = plan.halo_gid

    # patch slots: band face transitions + sphere edges
    P = 0
    per_shard = []
    for s in range(S):
        g0 = s * eloc
        a0 = g0 % ne
        o = (ne - a0) % ne
        bs = g0 - 2 * ne + o              # band global start (row-aligned)
        emap = {g0 + l: l for l in range(eloc)}
        for i, e in enumerate(halo_gid[s]):
            if e >= 0:
                emap[int(e)] = eloc + i

        def eidx(g):
            """global element -> (ext element id, valid)"""
            if 0 <= g < E and g in emap:
                return emap[g], True
            return 0, False

        def sidx(flat):
            """global flat slot -> (ext flat slot, valid)"""
            e, s16 = divmod(int(flat), 16)
            i, ok = eidx(e)
            return i * 16 + s16, ok

        head_idx = np.zeros(2 * ne, np.int32)
        head_mask = np.zeros(2 * ne, bool)
        for j in range(2 * ne):
            head_idx[j], head_mask[j] = eidx(g0 - 2 * ne + j)
        tail_idx = np.zeros(3 * ne, np.int32)
        tail_mask = np.zeros(3 * ne, bool)
        for j in range(3 * ne):
            tail_idx[j], tail_mask[j] = eidx(g0 + eloc + j)

        gpx_idx = np.zeros((nr, 4), np.int32)
        gpx_mask = np.zeros((nr, 4), bool)
        gmx_idx = np.zeros((nr, 4), np.int32)
        gmx_mask = np.zeros((nr, 4), bool)
        ysame_up = np.zeros(nr, bool)
        ysame_dn = np.zeros(nr, bool)
        pa = []                            # (pos, idx [ne,4], mask)
        pb = []
        row0 = bs // ne
        for r in range(nr):
            gr = row0 + r
            if not (0 <= gr < nrows_all):
                continue
            f, ey = divmod(gr, ne)
            for i in range(4):
                gpx_idx[r, i], gpx_mask[r, i] = sidx(g_px[f, ey, i])
                gmx_idx[r, i], gmx_mask[r, i] = sidx(g_mx[f, ey, i])
            ysame_up[r] = (gr + 1 < nrows_all) and ((gr + 1) // ne == f)
            ysame_dn[r] = (gr - 1 >= 0) and ((gr - 1) // ne == f)
            if ey == ne - 1:               # face-top row: +y seam strip
                idx = np.zeros((ne, 4), np.int32)
                msk = np.zeros((ne, 4), bool)
                for k in range(ne):
                    for i in range(4):
                        idx[k, i], msk[k, i] = sidx(g_py[f, k, i])
                pa.append((r, idx, msk))
            if ey == 0:                    # face-bottom row: -y seam strip
                idx = np.zeros((ne, 4), np.int32)
                msk = np.zeros((ne, 4), bool)
                for k in range(ne):
                    for i in range(4):
                        idx[k, i], msk[k, i] = sidx(g_my[f, k, i])
                pb.append((r, idx, msk))

        diag_idx = np.zeros((eloc, 4), np.int32)
        diag_mask = np.zeros((eloc, 4), bool)
        for l in range(eloc):
            for c in range(4):
                if g_diag_mask[g0 + l, c]:
                    diag_idx[l, c], diag_mask[l, c] = sidx(g_diag[g0 + l, c])

        P = max(P, len(pa), len(pb))
        per_shard.append(dict(band_o=np.asarray([o], np.int32),
                              head_idx=head_idx, head_mask=head_mask,
                              tail_idx=tail_idx, tail_mask=tail_mask,
                              gpx_idx=gpx_idx, gpx_mask=gpx_mask,
                              gmx_idx=gmx_idx, gmx_mask=gmx_mask,
                              ysame_up=ysame_up, ysame_dn=ysame_dn,
                              pa=pa, pb=pb,
                              diag_idx=diag_idx, diag_mask=diag_mask))

    P = max(P, 1)
    out = {}
    for k in ("band_o", "head_idx", "head_mask", "tail_idx", "tail_mask",
              "gpx_idx", "gpx_mask", "gmx_idx", "gmx_mask",
              "ysame_up", "ysame_dn", "diag_idx", "diag_mask"):
        out["f_" + k] = np.stack([d[k] for d in per_shard])
    for name, key in (("pa", "pa"), ("pb", "pb")):
        pos = np.zeros((S, P), np.int32)
        idx = np.zeros((S, P, ne, 4), np.int32)
        msk = np.zeros((S, P, ne, 4), bool)
        for s, d in enumerate(per_shard):
            for p, (r, pidx, pmsk) in enumerate(d[key]):
                pos[s, p] = r
                idx[s, p] = pidx
                msk[s, p] = pmsk
        out["f_" + name + "_pos"] = pos
        out["f_" + name + "_idx"] = idx
        out["f_" + name + "_mask"] = msk
    # uniform row-alignment offset (eloc % ne == 0, e.g. S=1 or the
    # NE120/S=8 production split): every shard's band offset is the same
    # static value, so the band/output slicing can be static python
    # slices instead of dynamic_slice copies
    o_all = {int(d["band_o"][0]) for d in per_shard}
    out["_dims"] = dict(ne=ne, eloc=eloc, nr=nr, npatch=P,
                        band_o_static=(o_all.pop() if len(o_all) == 1
                                       else None))
    return out


def tables_from_stack(stack_slices: dict, dims: dict) -> ShardedFaceTables:
    """Assemble the per-shard dataclass inside shard_map (each value is
    this shard's slice of the [S, ...] stack, leading axis stripped)."""
    g = lambda k: stack_slices["f_" + k]
    return ShardedFaceTables(
        ne=dims["ne"], eloc=dims["eloc"], nr=dims["nr"],
        npatch=dims["npatch"],
        band_o=g("band_o"), head_idx=g("head_idx"),
        head_mask=g("head_mask"), tail_idx=g("tail_idx"),
        tail_mask=g("tail_mask"), gpx_idx=g("gpx_idx"),
        gpx_mask=g("gpx_mask"), gmx_idx=g("gmx_idx"),
        gmx_mask=g("gmx_mask"), ysame_up=g("ysame_up"),
        ysame_dn=g("ysame_dn"), pa_pos=g("pa_pos"), pa_idx=g("pa_idx"),
        pa_mask=g("pa_mask"), pb_pos=g("pb_pos"), pb_idx=g("pb_idx"),
        pb_mask=g("pb_mask"), diag_idx=g("diag_idx"),
        diag_mask=g("diag_mask"),
        band_o_static=dims.get("band_o_static"))


def dss_sum_t_face_band(x, ext, t: ShardedFaceTables):
    """Banded face-shift DSS for one shard.

    x: [eloc, 16, B] local T-layout field; ext: [eloc+nhalo, 16, B] =
    concat([x, halo]).  Returns the assembled [eloc, 16, B], bitwise equal
    to the single-device ops/dss_face.py dss_sum_t_face on this chunk.
    """
    ne, nr, eloc = t.ne, t.nr, t.eloc
    B = x.shape[-1]
    f = x.dtype
    extf = ext.reshape(-1, B)

    head = jnp.where(t.head_mask[:, None, None],
                     ext[t.head_idx].astype(f), 0)
    tail = jnp.where(t.tail_mask[:, None, None],
                     ext[t.tail_idx].astype(f), 0)
    bandfull = jnp.concatenate([head, x, tail], axis=0)  # [eloc+5ne, 16, B]
    o = t.band_o[0]
    z = jnp.zeros((), o.dtype)
    band = jax.lax.dynamic_slice(bandfull, (o, z, z), (nr * ne, 16, B))
    b4 = band.reshape(nr, ne, 16, B)
    bv = band.reshape(nr, ne, 4, 4, B)

    # +-x edge partners (in-row shifts; seam ghost columns)
    gpx = jnp.where(t.gpx_mask[..., None], extf[t.gpx_idx].astype(f), 0)
    gmx = jnp.where(t.gmx_mask[..., None], extf[t.gmx_idx].astype(f), 0)
    S_px = jnp.concatenate([b4[:, 1:, 0:4, :], gpx[:, None]], axis=1)
    S_mx = jnp.concatenate([gmx[:, None], b4[:, :-1, 12:16, :]], axis=1)
    z12 = jnp.zeros((nr, ne, 12, B), f)
    t_px = jnp.concatenate([z12, S_px], axis=2)
    t_mx = jnp.concatenate([S_mx, z12], axis=2)

    # +-y sources: neighbor row's j=0 / j=3 points ([nr, ne, 4(i), B]),
    # masked at face transitions; seam strips patched in at those rows
    zrow = jnp.zeros((1, ne, 4, B), f)
    up = jnp.concatenate([bv[1:, :, :, 0, :], zrow], axis=0)
    dn = jnp.concatenate([zrow, bv[:-1, :, :, 3, :]], axis=0)
    up = jnp.where(t.ysame_up[:, None, None, None], up, 0)
    dn = jnp.where(t.ysame_dn[:, None, None, None], dn, 0)

    def patch(rows, pos, idx, mask):
        for p in range(t.npatch):
            strip = jnp.where(mask[p][..., None],
                              extf[idx[p]].astype(f), 0)   # [ne, 4, B]
            zp = jnp.zeros((), pos.dtype)
            cur = jax.lax.dynamic_slice(
                rows, (pos[p], zp, zp, zp), (1, ne, 4, B))
            rows = jax.lax.dynamic_update_slice(
                rows, cur + strip[None], (pos[p], zp, zp, zp))
        return rows

    up = patch(up, t.pa_pos, t.pa_idx, t.pa_mask)
    dn = patch(dn, t.pb_pos, t.pb_idx, t.pb_mask)

    z3 = jnp.zeros((nr, ne, 4, 3, B), f)
    t_py = jnp.concatenate([z3, up[..., None, :]], axis=3) \
        .reshape(nr, ne, 16, B)
    t_my = jnp.concatenate([dn[..., None, :], z3], axis=3) \
        .reshape(nr, ne, 16, B)

    # same summation order as ops/dss_face.py (bitwise-equal results)
    out = b4 + t_px + t_mx + t_py + t_my
    outf = out.reshape(nr * ne, 16, B)
    pos0 = 2 * ne - o
    loc = jax.lax.dynamic_slice(outf, (pos0, z, z), (eloc, 16, B))

    # corner diagonals (slots 0, 3, 12, 15)
    dvals = jnp.where(t.diag_mask[..., None], extf[t.diag_idx].astype(f), 0)
    dv = dvals.reshape(eloc, 2, 2, B)
    zc = jnp.zeros((eloc, 2, 2, B), f)
    rows = jnp.concatenate([dv[:, :, 0:1], zc, dv[:, :, 1:2]], axis=2)
    zi = jnp.zeros((eloc, 1, 4, B), f)
    cor = jnp.concatenate([rows[:, 0:1], zi, zi, rows[:, 1:2]], axis=1) \
        .reshape(eloc, 16, B)
    return loc + cor
