"""Direct Stiffness Summation (DSS) and neighbor min/max as gathers.

Device replacement for the reference's edge pack / MPI exchange / unpack
machinery (reference: edge_mod.F90:366 `edgeVpack`, :648 `edgeVunpack`,
:965 `edgeVunpackMin/Max`, bndry_mod.F90:21 `bndry_exchangeV`,
viscosity_mod.F90:748 `neighbor_minmax`).

On a single device the assembly is three masked gathers over a precomputed
partner table (each GLL point has at most 3 coincident partner slots: 2 edge
neighbors + 1 corner neighbor; 4-way sharing at regular corners, 3-way at the
8 cube vertices).  The sharded variant lives in parallel/halo.py.

Data layout: fields are [E, batch..., np, np]; the partner table indexes the
flattened (E*np*np) point axis.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DssTables:
    """Device-resident assembly tables built from grid.cubesphere.

    The methods (dss_sum / neighbor_minmax / global_min) are the interface
    the model core programs against; parallel/halo.py provides a sharded
    implementation of the same interface for use inside shard_map.

    mode selects the assembly algorithm:
      "gather" (default): 3 masked partner gathers, summed in fixed partner
        order — bitwise identical to the sharded path (BFB-under-shard-count
        invariance, reference README:46-48).
      "segsum": scatter-add by global point id then gather back —
        associates the sum differently (roundoff-level difference).
      "face": shifted-slice assembly on raster-ordered elements
        (ops/dss_face.py; roundoff-level difference; the perf configs).
    """
    part_idx: jnp.ndarray    # [E*16, 3] int32
    part_mask: jnp.ndarray   # [E*16, 3] bool
    nbr: jnp.ndarray         # [E, 9] int32 (self first, self-padded)
    nelem: int
    gid: jnp.ndarray = None  # [E*16] int32 (segsum mode)
    ngid: int = 0
    mode: str = "gather"
    face: object = None      # FaceTables (mode "face")

    @staticmethod
    def from_grid(grid, mode: str = "gather") -> "DssTables":
        face = None
        if mode == "face":
            from .dss_face import build_face_tables
            face = build_face_tables(grid)
        return DssTables(
            part_idx=jnp.asarray(grid.part_idx),
            part_mask=jnp.asarray(grid.part_mask),
            nbr=jnp.asarray(grid.nbr),
            nelem=grid.nelem,
            gid=jnp.asarray(grid.gid.reshape(-1)),
            ngid=grid.ngid,
            mode=mode,
            face=face,
        )

    def dss_sum(self, x):
        if self.mode == "face":
            # [E, B..., n, n] -> T layout -> face DSS -> back
            from .dss_face import dss_sum_t_face
            E = x.shape[0]
            nn = x.shape[-1] * x.shape[-2]
            xt = jnp.moveaxis(x.reshape(E, -1, nn), 1, 2)
            out = dss_sum_t_face(xt, self.face)
            return jnp.moveaxis(out, 2, 1).reshape(x.shape)
        if self.mode == "segsum":
            return dss_sum_segsum(x, self)
        return dss_sum(x, self)

    def dss_sum_t(self, x_t):
        """DSS on T-layout fields x_t [E, 16, B] (point axis second)."""
        if self.mode == "face":
            from .dss_face import dss_sum_t_face
            return dss_sum_t_face(x_t, self.face)
        E, nn, B = x_t.shape
        xf = x_t.reshape(E * nn, B)
        if self.mode == "segsum":
            import jax
            acc = jax.ops.segment_sum(xf, self.gid,
                                      num_segments=self.ngid)
            return acc[self.gid].reshape(x_t.shape)
        partners = xf[self.part_idx]                    # [E*nn, 3, B]
        contrib = jnp.where(self.part_mask[..., None], partners, 0)
        return (xf + contrib.sum(axis=1)).reshape(x_t.shape)

    def neighbor_minmax(self, qmin, qmax):
        if self.mode == "face":
            from .dss_face import neighbor_minmax_face
            return neighbor_minmax_face(qmin, qmax, self.face)
        return neighbor_minmax(qmin, qmax, self)

    def global_min(self, x):
        return x.min()


def _flatten_points(x):
    """[E, B..., n, n] -> ([BB, E*n*n], restore_fn)."""
    E = x.shape[0]
    nn = x.shape[-1] * x.shape[-2]
    batch_shape = x.shape[1:-2]
    xf = x.reshape(E, -1, nn)            # [E, BB, nn]
    xf = jnp.moveaxis(xf, 0, 1).reshape(-1, E * nn)

    def restore(y):
        y = y.reshape(-1, E, nn)
        y = jnp.moveaxis(y, 1, 0)
        return y.reshape(x.shape)

    return xf, restore


def dss_sum(x, tables: DssTables):
    """out[p] = sum over all slots coincident with p (including p itself)."""
    xf, restore = _flatten_points(x)
    partners = xf[:, tables.part_idx]                   # [BB, E*nn, 3]
    contrib = jnp.where(tables.part_mask, partners, 0).sum(axis=-1)
    return restore(xf + contrib)


def dss_sum_segsum(x, tables: DssTables):
    """Segment-sum assembly: scatter-add by gid, gather back (perf mode)."""
    import jax
    E = x.shape[0]
    nn = x.shape[-1] * x.shape[-2]
    xf = x.reshape(E, -1, nn)
    xf = jnp.moveaxis(xf, 2, 1).reshape(E * nn, -1)     # [E*nn, BB]
    acc = jax.ops.segment_sum(xf, tables.gid, num_segments=tables.ngid)
    out = acc[tables.gid]
    out = jnp.moveaxis(out.reshape(E, nn, -1), 1, 2)
    return out.reshape(x.shape)


def dss_scale(x, spheremp, rspheremp, tables: DssTables):
    """The assembled projection: rspheremp * DSS(spheremp * x).

    This is the make-C0 operation used after every advection stage
    (prim_advection_mod.F90:898-960, viscosity_mod.F90:445 `make_C0`).
    """
    nd = x.ndim
    sp = spheremp.reshape(spheremp.shape[:1] + (1,) * (nd - 3)
                          + spheremp.shape[1:])
    rsp = rspheremp.reshape(sp.shape)
    return dss_scale_pre(x * sp, rsp, tables)


def dss_scale_pre(xw, rsp, tables: DssTables):
    return dss_sum(xw, tables) * rsp


def neighbor_minmax(qmin, qmax, tables: DssTables):
    """Min/max over each element and its (up to 8) point-sharing neighbors.

    Equivalent to the reference's constant-field pack / unpackMin/Max /
    corner-read trick (viscosity_mod.F90:748-816): because the packed field
    is constant per element, the corner values after unpack equal the min/max
    over self plus all neighbors.  qmin/qmax are [E, batch...].
    """
    gmin = jnp.min(qmin[tables.nbr], axis=1)
    gmax = jnp.max(qmax[tables.nbr], axis=1)
    return gmin, gmax


# ---------------------------------------------------------------------------
# host-side reference implementation (numpy), used by tests
# ---------------------------------------------------------------------------

def dss_sum_np(x: np.ndarray, gid: np.ndarray, ngid: int) -> np.ndarray:
    """Scatter-add by global point id then gather back (any [E, n, n] x)."""
    flat = x.reshape(-1)
    acc = np.zeros(ngid, dtype=x.dtype)
    np.add.at(acc, gid.reshape(-1), flat)
    return acc[gid.reshape(-1)].reshape(x.shape)
