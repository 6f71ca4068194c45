"""Spaceranger tissue-position readers, pandas-free.

* v1: headerless ``tissue_positions_list.csv``;
* v2: headered ``tissue_positions.csv`` (Spaceranger >= 2.0);
* Visium HD: ``outs/binned_outputs/<binning>/spatial/tissue_positions.parquet``
  (:mod:`~gridnext_tpu_torch.io.parquet`).

The CSV version is sniffed from the first line, as the JAX package does.
Rows keep file order; ``Positions`` holds the barcodes and one numpy column
per field.
"""

from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from gridnext_tpu_torch.io.parquet import read_parquet

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


def find_position_file(spaceranger_dir, hd_binning: Optional[str] = None) -> str:
    """Locate the tissue-positions file of a Spaceranger directory.

    With ``hd_binning`` (e.g. ``"square_016um"``): the Visium HD parquet of
    that binning. Else the CSV below the directory, by sorted glob: when a
    directory holds both layouts, v2's ``tissue_positions.csv`` sorts
    before v1's ``tissue_positions_list.csv``.
    """
    if hd_binning is not None:
        pos_path = os.path.join(str(spaceranger_dir), "outs", "binned_outputs",
                                hd_binning, "spatial", "tissue_positions.parquet")
        if not os.path.exists(pos_path):
            raise ValueError(f"Cannot locate position file for {hd_binning} binning "
                             f"of {spaceranger_dir}")
        return pos_path
    for pos_path in sorted(glob.glob(os.path.join(str(spaceranger_dir),
                                                  "**", "*.csv"),
                                     recursive=True)):
        if "tissue_positions" in os.path.basename(pos_path):
            return pos_path
    raise ValueError(f"Cannot locate position file for {spaceranger_dir}")


def read_positions_file(position_file) -> Positions:
    """Read a v1 or v2 positions CSV, or a Visium HD positions parquet, into
    :class:`Positions`."""
    if str(position_file).endswith(".parquet"):
        table = read_parquet(str(position_file), ("barcode",) + _V1_COLUMNS)
        columns = {name: np.asarray(table[name],
                                    np.int64 if name in _INT_COLUMNS else np.float64)
                   for name in _V1_COLUMNS}
        return Positions(list(table["barcode"]), columns)
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


def read_positions(spaceranger_dir, hd_binning: Optional[str] = None) -> Positions:
    """Positions of an array: find + read in one call."""
    return read_positions_file(find_position_file(spaceranger_dir, hd_binning))


def hd_lattice_dims(spaceranger_dir, hd_binning: str) -> tuple:
    """(h, w) of an HD square bin lattice: (max row + 1, max col + 1) over
    every position, in tissue or not (the JAX package's grid dims for
    ``grid_dims='auto'``)."""
    pos = read_positions(spaceranger_dir, hd_binning)
    return int(pos["array_row"].max()) + 1, int(pos["array_col"].max()) + 1


def cohort_hd_lattice_dims(spaceranger_dirs, hd_binning: str) -> tuple:
    """Cohort-max (h, w) over every array's :func:`hd_lattice_dims`."""
    h = w = 0
    for srd in spaceranger_dirs:
        hh, ww = hd_lattice_dims(srd, hd_binning)
        h, w = max(h, hh), max(w, ww)
    return h, w
