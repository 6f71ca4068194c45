"""Count grids from unified count caches (the annotation readers wait for
the training slice).

``read_annotated_starray`` places one array's unified counts into the
(H, W, n_genes) odd-right grid, as the JAX package's
``io/annotations.read_annotated_starray`` does without annotations.
"""

from __future__ import annotations

import numpy as np

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.unify import read_count_matrix


def read_annotated_starray(count_file, select_genes=None,
                           h_st: int = geometry.VISIUM_H_ST,
                           w_st: int = geometry.VISIUM_W_ST, Visium: bool = True):
    """Read one array's unified count file into dense grids.

    Spot columns named ``{array_col}_{array_row}`` are placed through
    :func:`~gridnext_tpu_torch.geometry.pseudo_hex_to_oddr` (``Visium``)
    or at their rounded coordinates. ``select_genes`` picks and orders the
    gene rows by name.

    Returns:
      counts_grid: (h_st, w_st, n_genes) float64, odd-right indexed (zeros
        for an array without spots).
      annots_grid: (h_st, w_st) int zeros (no annotations are read).
    """
    genes, columns, values = read_count_matrix(count_file)
    if select_genes is not None:
        row = {g: i for i, g in enumerate(genes)}
        missing = [g for g in select_genes if g not in row]
        if missing:
            raise KeyError(f"genes not in {count_file}: {missing[:5]}")
        values = values[[row[g] for g in select_genes]]
    annots_grid = np.zeros((h_st, w_st), dtype=int)
    counts_grid = np.zeros((h_st, w_st, values.shape[0]), dtype=float)
    if not columns:
        return counts_grid, annots_grid
    coords = np.array([list(map(float, c.split("_"))) for c in columns])
    if Visium:
        x, y = geometry.pseudo_hex_to_oddr(coords[:, 0].astype(int),
                                           coords[:, 1].astype(int))
    else:
        x = np.rint(coords[:, 0]).astype(int)
        y = np.rint(coords[:, 1]).astype(int)
    counts_grid[y, x] = values.T
    return counts_grid, annots_grid
