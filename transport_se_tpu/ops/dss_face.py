"""Face-shift DSS: direct stiffness summation as dense shifted-slice adds.

The cubed sphere is 6 regular ne x ne element grids; with elements stored in
face-major raster order (index = face*ne^2 + ey*ne + ex), every *within-face*
edge contribution of the DSS (reference: edge_mod.F90:366 `edgeVpack`,
:648 `edgeVunpack`) is a static shifted slice of the field — no gather, no
scatter, pure streaming concats/adds that XLA fuses with neighboring
elementwise work.  Crossing the 12 cube seams needs
only a small gathered ghost strip per face side (ne x 4 point rows, pre-
permuted for orientation — the analog of the reference's edge `reverse`
flags, edge_mod.F90:78-95, derived from global point identity instead of
orientation bookkeeping).  Corner-point diagonal partners (1 row per element
corner) come from a single [E,4]-row gather that uniformly covers in-face
diagonals, seam diagonals, and the partnerless cube-vertex corners.

Summation order differs from the partner-table path by roundoff only;
BFB-critical configs keep mode="gather".

Point-slot convention: slot = i*4 + j, i along ex (face x1), j along ey
(face x2); see grid/cubesphere.py build_grid.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

__all__ = ["FaceTables", "build_face_tables", "dss_sum_t_face",
           "neighbor_minmax_face"]


@dataclasses.dataclass(frozen=True)
class FaceTables:
    """Seam + corner tables for the face-shift DSS (host-built).

    ghost_* are flat point-slot indices (element*16 + slot) into the
    flattened field [E*16, B]; row r of side strip position k holds the
    source slot coincident with the edge element's point:
      +x side: my (i=3, j=r)   -x side: my (i=0, j=r)
      +y side: my (i=r, j=3)   -y side: my (i=r, j=0)
    diag_idx[e, c] (c over corner slots 0,3,12,15) is the flat slot of the
    corner's *diagonal* partner (the one not covered by edge terms);
    diag_mask is False at cube vertices (3-way corners, no diagonal).
    src_* are the seam neighbor *elements* (for neighbor min/max).
    """
    ne: int
    ghost_px: jnp.ndarray   # [6, ne, 4] int32
    ghost_mx: jnp.ndarray
    ghost_py: jnp.ndarray
    ghost_my: jnp.ndarray
    diag_idx: jnp.ndarray   # [E, 4] int32
    diag_mask: jnp.ndarray  # [E, 4] bool
    src_px: jnp.ndarray     # [6, ne] int32 seam neighbor element
    src_mx: jnp.ndarray
    src_py: jnp.ndarray
    src_my: jnp.ndarray


def _partner_slots(grid, fs: int):
    """All flat partner slots of flat point slot fs."""
    return [int(grid.part_idx[fs, c]) for c in range(3)
            if grid.part_mask[fs, c]]


def build_face_tables(grid) -> FaceTables:
    """Derive seam ghost + corner-diagonal tables from point identity.

    Requires raster element order (build_grid(..., order="raster")).
    """
    ne = grid.ne
    E = grid.nelem
    if ne < 2:
        raise ValueError("face DSS needs ne >= 2")
    idx = np.arange(E)
    if not (np.array_equal(grid.ex, idx % (ne * ne) % ne)
            and np.array_equal(grid.ey, idx % (ne * ne) // ne)):
        raise ValueError("face DSS requires raster element order "
                         "(build_grid order='raster')")

    def elem(f, ey, ex):
        return f * ne * ne + ey * ne + ex

    gid = grid.gid.reshape(E, 16)

    def side_table(f, side):
        gh = np.zeros((ne, 4), np.int64)
        src = np.zeros(ne, np.int64)
        for k in range(ne):
            if side == "px":
                e, myslots = elem(f, k, ne - 1), [12 + j for j in range(4)]
            elif side == "mx":
                e, myslots = elem(f, k, 0), [0 + j for j in range(4)]
            elif side == "py":
                e, myslots = elem(f, ne - 1, k), [i * 4 + 3 for i in range(4)]
            else:
                e, myslots = elem(f, 0, k), [i * 4 + 0 for i in range(4)]
            mid = e * 16 + myslots[1]     # non-corner edge point: 1 partner
            ps = _partner_slots(grid, mid)
            assert len(ps) == 1
            s = ps[0] // 16
            src[k] = s
            for r, ms in enumerate(myslots):
                cands = [p for p in _partner_slots(grid, e * 16 + ms)
                         if p // 16 == s]
                assert len(cands) == 1, (f, side, k, r, cands)
                gh[k, r] = cands[0]
                assert gid.reshape(-1)[cands[0]] == gid[e, ms]
        return gh, src

    g = {}
    s = {}
    for f in range(6):
        for side in ("px", "mx", "py", "my"):
            gh, sr = side_table(f, side)
            g.setdefault(side, []).append(gh)
            s.setdefault(side, []).append(sr)
    g = {k: np.stack(v) for k, v in g.items()}
    s = {k: np.stack(v) for k, v in s.items()}

    # per-element edge-sharing neighbor sets (in-face or seam src)
    edge_nbr = np.zeros((E, 4), np.int64)
    face_of = idx // (ne * ne)
    for e in range(E):
        f, ey, ex = int(face_of[e]), int(grid.ey[e]), int(grid.ex[e])
        edge_nbr[e, 0] = elem(f, ey, ex + 1) if ex < ne - 1 \
            else s["px"][f, ey]
        edge_nbr[e, 1] = elem(f, ey, ex - 1) if ex > 0 else s["mx"][f, ey]
        edge_nbr[e, 2] = elem(f, ey + 1, ex) if ey < ne - 1 \
            else s["py"][f, ex]
        edge_nbr[e, 3] = elem(f, ey - 1, ex) if ey > 0 else s["my"][f, ex]

    # corner diagonal partners: the partner not in an edge-sharing element
    diag_idx = np.zeros((E, 4), np.int64)
    diag_mask = np.zeros((E, 4), bool)
    for e in range(E):
        en = set(int(v) for v in edge_nbr[e])
        for c, slot in enumerate((0, 3, 12, 15)):
            others = [p for p in _partner_slots(grid, e * 16 + slot)
                      if p // 16 not in en]
            assert len(others) <= 1, (e, slot, others)
            if others:
                diag_idx[e, c] = others[0]
                diag_mask[e, c] = True

    a32 = lambda x: jnp.asarray(np.asarray(x).astype(np.int32))
    return FaceTables(ne=ne,
                      ghost_px=a32(g["px"]), ghost_mx=a32(g["mx"]),
                      ghost_py=a32(g["py"]), ghost_my=a32(g["my"]),
                      diag_idx=a32(diag_idx),
                      diag_mask=jnp.asarray(diag_mask),
                      src_px=a32(s["px"]), src_mx=a32(s["mx"]),
                      src_py=a32(s["py"]), src_my=a32(s["my"]))


def dss_sum_t_face(x_t, ft: FaceTables):
    """DSS on T-layout fields x_t [E, 16, B], E in raster face order.

    out[p] = sum over all slots coincident with p.  Edge partners are
    concat-shifted slices (placed into their slot rows by zero-padding
    concats — no scatter, no strided update); corner diagonals are one
    [E,4]-row gather.
    """
    ne = ft.ne
    E, nn, B = x_t.shape
    f = x_t.dtype
    x6 = x_t.reshape(6, ne, ne, nn, B)       # [f, ey, ex, slot, B]
    x6v = x_t.reshape(6, ne, ne, 4, 4, B)    # slot -> (i, j)
    xf = x_t.reshape(E * nn, B)

    gpx = xf[ft.ghost_px].astype(f)          # [6, ne(ey), 4(j), B]
    gmx = xf[ft.ghost_mx].astype(f)
    gpy = xf[ft.ghost_py].astype(f)          # [6, ne(ex), 4(i), B]
    gmy = xf[ft.ghost_my].astype(f)

    z12 = jnp.zeros((6, ne, ne, 12, B), f)

    # +x partner: my (3, j) += nbr (0, j); nbr = (ex+1) or +x ghost
    S = jnp.concatenate([x6[:, :, 1:, 0:4], gpx[:, :, None]], axis=2)
    t_px = jnp.concatenate([z12, S], axis=3)
    # -x partner: my (0, j) += nbr (3, j)
    S = jnp.concatenate([gmx[:, :, None], x6[:, :, :-1, 12:16]], axis=2)
    t_mx = jnp.concatenate([S, z12], axis=3)

    z3 = jnp.zeros((6, ne, ne, 4, 3, B), f)
    # +y partner: my (i, 3) += nbr (i, 0)
    S = jnp.concatenate([x6v[:, 1:, :, :, 0, :], gpy[:, None]], axis=1)
    t_py = jnp.concatenate([z3, S[..., None, :]], axis=4).reshape(x6.shape)
    # -y partner: my (i, 0) += nbr (i, 3)
    S = jnp.concatenate([gmy[:, None], x6v[:, :-1, :, :, 3, :]], axis=1)
    t_my = jnp.concatenate([S[..., None, :], z3], axis=4).reshape(x6.shape)

    out = x6 + t_px + t_mx + t_py + t_my

    # corner diagonals: rows {0, 3, 12, 15} <- gathered partner rows
    dvals = jnp.where(ft.diag_mask[..., None], xf[ft.diag_idx].astype(f), 0)
    dvals = dvals.reshape(6, ne, ne, 2, 2, B)     # [.., i-half, j-half, B]
    zc = jnp.zeros((6, ne, ne, 2, 2, B), f)
    # j placement: (c, z, z, c) along j for each of i in {0, 3}
    rows = jnp.concatenate([dvals[..., 0:1, :], zc[..., :], dvals[..., 1:2, :]],
                           axis=4)                # [6,ne,ne,2,4,B]
    zi = jnp.zeros((6, ne, ne, 1, 4, B), f)
    cor = jnp.concatenate([rows[..., 0:1, :, :], zi, zi,
                           rows[..., 1:2, :, :]], axis=3)   # [6,ne,ne,4,4,B]
    out = out + cor.reshape(x6.shape)

    return out.reshape(E, nn, B)


def neighbor_minmax_face(qmin, qmax, ft: FaceTables):
    """Min/max over each element and its point-sharing neighbors.

    qmin/qmax: [E, batch...] per-element values (element-level — no point
    permutation involved, so seams only need the neighbor *element*).
    Equivalent to ops/dss.py neighbor_minmax (viscosity_mod.F90:748-816).
    """
    ne = ft.ne
    E = qmin.shape[0]
    orig_shape = qmin.shape
    # flatten trailing batch dims into one axis
    qmin = qmin.reshape(E, -1)
    qmax = qmax.reshape(E, -1)
    bshape = qmin.shape[1:]

    def reduce_one(q, op, pad):
        q6 = q.reshape((6, ne, ne) + bshape)
        qe = q.reshape((E,) + bshape)

        # seam strips [6, ne, batch...]
        spx, smx = qe[ft.src_px], qe[ft.src_mx]
        spy, smy = qe[ft.src_py], qe[ft.src_my]

        def shx(a, d, ghost):
            """shift along ex, filling the open column from the ghost."""
            gcol = ghost[:, :, None]
            if d == 1:
                return jnp.concatenate([a[:, :, 1:], gcol], axis=2)
            return jnp.concatenate([gcol, a[:, :, :-1]], axis=2)

        def shy(a, d, ghost):
            grow = ghost[:, None]
            if d == 1:
                return jnp.concatenate([a[:, 1:], grow], axis=1)
            return jnp.concatenate([grow, a[:, :-1]], axis=1)

        def sh_strip(st, d):
            pp = jnp.full_like(st[:, :1], pad)
            if d == 1:
                return jnp.concatenate([st[:, 1:], pp], axis=1)
            return jnp.concatenate([pp, st[:, :-1]], axis=1)

        xp = shx(q6, 1, spx)
        xm = shx(q6, -1, smx)
        r = op(op(q6, xp), xm)
        r = op(r, shy(q6, 1, spy))
        r = op(r, shy(q6, -1, smy))
        # diagonals: shift the x-shifted fields along y; the open row is
        # the +-1-shifted seam strip of the *y* side for in-row elements,
        # and the +-1-shifted x strips for the open column — both reduce
        # to: y-shift with a ghost row built from the shifted y strip,
        # whose open-corner entry (cube vertex) has no diagonal: pad.
        # diagonals: y-shift the x-shifted fields.  The x-seam columns'
        # diagonal partners (strip positions ey+-1) ride along inside
        # xp/xm; the open ghost row supplies the y-seam diagonals
        # (shifted y strip; its open corner = cube vertex: pad).
        r = op(r, shy(xp, 1, sh_strip(spy, 1)))
        r = op(r, shy(xp, -1, sh_strip(smy, 1)))
        r = op(r, shy(xm, 1, sh_strip(spy, -1)))
        r = op(r, shy(xm, -1, sh_strip(smy, -1)))
        return r.reshape(q.shape)

    gmin = reduce_one(qmin, jnp.minimum, jnp.inf)
    gmax = reduce_one(qmax, jnp.maximum, -jnp.inf)
    return gmin.reshape(orig_shape), gmax.reshape(orig_shape)
