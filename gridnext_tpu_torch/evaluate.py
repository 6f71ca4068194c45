"""Loupe export of registered label grids."""

from __future__ import annotations

import csv
import os
from typing import Optional, Sequence

import numpy as np

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.spaceranger import read_positions_file


def to_loupe_annots(annot_grid, position_file, output_file,
                    annot_names: Optional[Sequence[str]] = None,
                    zero_bg: bool = True):
    """Write a Loupe-format (Barcode, AARs) CSV from an odd-right label grid.

    ``annot_grid`` is (H, W) integer labels (foreground 1..N when
    ``zero_bg``, else 0..N-1); unlabeled in-tissue spots export as ''. The
    file is byte-identical to the JAX package's (pandas ``to_csv`` with
    ``index=False``: minimal quoting, ``os.linesep`` line ends).
    """
    positions = read_positions_file(position_file)
    annot_grid = np.asarray(annot_grid).squeeze()

    keep = positions["in_tissue"].astype(int) == 1
    barcodes = [b for b, k in zip(positions.barcodes, keep) if k]
    x, y = geometry.pseudo_hex_to_oddr(positions["array_col"][keep],
                                       positions["array_row"][keep])
    x, y = np.atleast_1d(x), np.atleast_1d(y)
    # an out-of-grid index would raise a bare IndexError, and a negative one
    # (malformed col/row parity -> x = -1) would wrap to the last column
    if len(y) and (int(y.max()) >= annot_grid.shape[0]
                   or int(x.max()) >= annot_grid.shape[1]
                   or int(x.min()) < 0 or int(y.min()) < 0):
        raise ValueError(
            f"positions map to odd-right extent "
            f"({int(y.min())}..{int(y.max())}, "
            f"{int(x.min())}..{int(x.max())}) but the label grid is "
            f"{annot_grid.shape[:2]} -- the array's lattice exceeds "
            "the model's grid (or a position row has invalid "
            "array_col/array_row parity)")

    with open(output_file, "w", newline="", encoding="utf-8") as fh:
        writer = csv.writer(fh, lineterminator=os.linesep)
        writer.writerow(["Barcode", "AARs"])
        for bc, xi, yi in zip(barcodes, x, y):
            a = int(annot_grid[yi, xi]) - int(zero_bg)
            if a < 0:
                annot = ""
            elif annot_names is not None:
                annot = annot_names[a]
            else:
                annot = a
            writer.writerow([bc, annot])
