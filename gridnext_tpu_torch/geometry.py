"""Visium lattice geometry: coordinate transforms and hex stencil taps.

The 10x Genomics Visium array is a hexagonally packed lattice of 78 rows x 64
spots/row (4,992 spots). Spaceranger reports spot locations in a "pseudo-hex"
scheme: ``array_col`` in [0, 127] and ``array_row`` in [0, 77], where
``array_col + array_row`` is always even.

Three coordinate systems:

* **pseudo-hex** ``(col, row)`` -- Spaceranger native (col in [0,127]).
* **odd-right (oddr)** ``(x, y)`` -- dense square-grid storage: ``x`` in
  [0, 63], ``y`` in [0, 77]; odd rows implicitly shifted one half-unit right.
  All grid tensors of this package are odd-right indexed: ``grid[y, x]``.
* **Cartesian** -- physical positions with unit neighbor distance.

Host-side numpy only; the same integer semantics as the JAX package's
``gridnext_tpu.geometry``, of which this is the port's own copy.
"""

from __future__ import annotations

import numpy as np

VISIUM_H_ST = 78  # number of rows
VISIUM_W_ST = 64  # spots per row

SQRT3_OVER_2 = np.sqrt(3.0) / 2.0


def pseudo_hex_to_oddr(col, row):
    """Pseudo-hex (Visium ``array_col``/``array_row``) -> odd-right (x, y)."""
    col = np.asarray(col)
    row = np.asarray(row)
    x = (col - (row % 2)) // 2
    if x.ndim == 0:
        return int(x), int(row)
    return x.astype(np.int64), row.astype(np.int64)


def oddr_to_pseudo_hex(col, row):
    """Odd-right (x, y) -> pseudo-hex (``array_col``, ``array_row``)."""
    col = np.asarray(col)
    row = np.asarray(row)
    x = 2 * col + (row % 2)
    if x.ndim == 0:
        return int(x), int(row)
    return x.astype(np.int64), row.astype(np.int64)


def pseudo_to_true_hex(col, row):
    """Pseudo-hex -> Cartesian with unit neighbour spacing (x = col / 2,
    y = row * sqrt(3) / 2)."""
    col = np.asarray(col, dtype=np.float64)
    row = np.asarray(row, dtype=np.float64)
    x = col / 2.0
    y = row * SQRT3_OVER_2
    if x.ndim == 0:
        return float(x), float(y)
    return x, y


def hex_neighbor_table(h_st: int = VISIUM_H_ST, w_st: int = VISIUM_W_ST):
    """Dense neighbor index table of the odd-right lattice: ``(neighbors,
    valid)``, ``neighbors`` int32 ``(h_st, w_st, 6)`` holding the flat index
    ``y * w_st + x`` of each of the 6 hex neighbors (in
    :data:`HEX_TAPS_R1`'s order, -1 outside the array) and ``valid`` the
    bool mask of the neighbors inside it."""
    rows = np.arange(h_st)[:, None, None]
    cols = np.arange(w_st)[None, :, None]
    taps = np.array(HEX_TAPS_R1[1:], dtype=np.int64)  # (6, 3), the centre left out
    dr = taps[:, 0][None, None, :]
    dc = np.where((rows % 2) == 0, taps[:, 1][None, None, :], taps[:, 2][None, None, :])
    nr = rows + dr
    nc = cols + dc
    valid = (nr >= 0) & (nr < h_st) & (nc >= 0) & (nc < w_st)
    neighbors = np.where(valid, nr * w_st + nc, -1).astype(np.int32)
    return neighbors, valid


def pairwise_distances(points) -> np.ndarray:
    """Condensed upper-triangle pairwise Euclidean distances of (n, d)
    points, in (i < j) row-major order."""
    points = np.asarray(points, dtype=np.float64)
    iu, ju = np.triu_indices(len(points), k=1)
    diff = points[iu] - points[ju]
    return np.sqrt((diff * diff).sum(axis=-1))


def oddr_to_cartesian(col, row):
    """Odd-right -> Cartesian (odd rows shifted +0.5; rows scaled sqrt(3)/2)."""
    col = np.asarray(col, dtype=np.float64)
    row = np.asarray(row, dtype=np.float64)
    x = col + 0.5 * (np.asarray(row) % 2)
    y = row * SQRT3_OVER_2
    if x.ndim == 0:
        return float(x), float(y)
    return x, y


# Each stencil tap is (dr, dc_even, dc_odd): the column offset depends on the
# parity of the *source* row. Canonical radius-1 order, center first; the hex
# kernels' weight layout (7, C_in, C_out) follows it.
HEX_TAPS_R1 = (
    # (dr, dc_even, dc_odd)
    (0, 0, 0),    # C  (center)
    (0, -1, -1),  # W
    (0, 1, 1),    # E
    (-1, -1, 0),  # NW
    (-1, 0, 1),   # NE
    (1, -1, 0),   # SW
    (1, 0, 1),    # SE
)


def _oddr_to_cube(col, row):
    """Odd-r offset -> cube coordinates (q, r, s) for hex-distance math."""
    q = col - (row - (row & 1)) // 2
    r = row
    return q, r, -q - r


def _cube_to_oddr(q, r):
    col = q + (r - (r & 1)) // 2
    return col, r


def hex_taps(radius: int):
    """All stencil taps within hex distance ``radius`` as (dr, dc_even, dc_odd).

    Ordered by (hex ring, then dr, then dc_even); radius 1 returns
    :data:`HEX_TAPS_R1` (kept explicit for a stable weight layout). Cell
    count is ``1 + 3*radius*(radius+1)``.
    """
    if radius == 1:
        return HEX_TAPS_R1
    taps = []
    for dq in range(-radius, radius + 1):
        for dr in range(max(-radius, -dq - radius), min(radius, -dq + radius) + 1):
            dist = max(abs(dq), abs(dr), abs(-dq - dr))
            if dist > radius:
                continue
            q0e, r0e, _ = _oddr_to_cube(0, 0)
            ce, _ = _cube_to_oddr(q0e + dq, r0e + dr)
            q0o, r0o, _ = _oddr_to_cube(0, 1)
            co, _ = _cube_to_oddr(q0o + dq, r0o + dr)
            taps.append((dist, dr, ce, co))
    taps.sort()
    return tuple((dr, ce, co) for _, dr, ce, co in taps)
