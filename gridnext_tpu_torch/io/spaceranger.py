"""Spaceranger tissue-position readers (v1 and v2 CSV), pandas-free.

* v1: headerless ``tissue_positions_list.csv``;
* v2: headered ``tissue_positions.csv`` (Spaceranger >= 2.0).

The version is sniffed from the first line, as the JAX package does. Rows
keep file order; ``Positions`` holds the barcodes and one numpy column per
field.
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass

import numpy as np

_V1_COLUMNS = ("in_tissue", "array_row", "array_col",
               "pxl_row_in_fullres", "pxl_col_in_fullres")
_INT_COLUMNS = ("in_tissue", "array_row", "array_col")


@dataclass
class Positions:
    """Spot positions of one array: ``barcodes`` plus numpy columns.

    ``positions["array_row"]`` returns the column; the integer fields are
    int64 and the full-resolution pixel fields float64.
    """

    barcodes: list
    columns: dict

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]


def find_position_file(spaceranger_dir) -> str:
    """Locate the tissue-positions CSV below a Spaceranger directory.

    Sorted glob: when a directory holds both layouts, v2's
    ``tissue_positions.csv`` sorts before v1's ``tissue_positions_list.csv``.
    """
    for pos_path in sorted(glob.glob(os.path.join(str(spaceranger_dir),
                                                  "**", "*.csv"),
                                     recursive=True)):
        if "tissue_positions" in os.path.basename(pos_path):
            return pos_path
    raise ValueError(f"Cannot locate position file for {spaceranger_dir}")


def read_positions_file(position_file) -> Positions:
    """Read a v1 or v2 positions CSV into :class:`Positions`."""
    with open(str(position_file), newline="") as fh:
        rows = [r for r in csv.reader(fh) if r]
    if rows and rows[0][0].startswith("barcode"):  # Spaceranger >= 2.0
        header, rows = rows[0], rows[1:]
        idx = [header.index(c) for c in _V1_COLUMNS]
    else:
        idx = [1, 2, 3, 4, 5]
    barcodes = [r[0] for r in rows]
    columns = {}
    for name, i in zip(_V1_COLUMNS, idx):
        vals = [r[i] for r in rows]
        columns[name] = (np.asarray([int(float(v)) for v in vals], np.int64)
                         if name in _INT_COLUMNS
                         else np.asarray([float(v) for v in vals], np.float64))
    return Positions(barcodes, columns)


def read_positions(spaceranger_dir) -> Positions:
    """Positions of an array: find + read in one call."""
    return read_positions_file(find_position_file(spaceranger_dir))
