"""Spaceranger tissue-position readers, pandas-free.

* v1: headerless ``tissue_positions_list.csv``;
* v2: headered ``tissue_positions.csv`` (Spaceranger >= 2.0);
* Visium HD: ``outs/binned_outputs/<binning>/spatial/tissue_positions.parquet``
  (:mod:`~gridnext_tpu_torch.io.parquet`).

The CSV version is sniffed from the first line, as the JAX package does.
Rows keep file order; ``Positions`` holds the barcodes and one numpy column
per field.

The feature-barcode matrix (the MEX triplet ``matrix.mtx.gz``,
``features.tsv.gz``, ``barcodes.tsv.gz``) is found below the directory (or
under ``binned_outputs/<binning>/filtered_feature_bc_matrix`` for Visium
HD) and read with the standard library's ``gzip``/``csv`` and
``scipy.io.mmread``.
"""

from __future__ import annotations

import csv
import glob
import gzip
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


def coord_string(array_col, array_row) -> str:
    """The ``'{array_col}_{array_row}'`` spot key of the unified caches,
    the one formatter of the key every annotation and count join matches
    on."""
    return f"{int(array_col)}_{int(array_row)}"


def positions_to_coord_strings(positions: Positions, barcodes) -> list:
    """Barcodes -> ``'{array_col}_{array_row}'`` coordinate strings of
    their rows of ``positions`` (a ``KeyError`` for a barcode without a
    row, as the JAX package's ``positions.loc`` raises)."""
    where = {b: i for i, b in enumerate(positions.barcodes)}
    idx = np.asarray([where[b] for b in barcodes], np.int64)
    return [coord_string(c, r) for c, r in zip(positions["array_col"][idx].tolist(),
                                               positions["array_row"][idx].tolist())]


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
        columns = {name: np.asarray(table[name], np.float64) for name in _V1_COLUMNS}
        _integral(columns, position_file)
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


def _integral(columns: dict, path) -> None:
    """Cast a parquet's integer columns to int64 in place. A null there
    raises a ``ValueError`` naming the column, as the JAX route's pandas
    ``astype(int)`` raises on it (``in_tissue`` wherever positions are
    filtered, ``array_row`` / ``array_col`` in ``hd_lattice_dims``). Null
    pixel coordinates stay NaN."""
    for name in _INT_COLUMNS:
        null = int(np.isnan(columns[name]).sum())
        if null:
            raise ValueError(f"{path}: column {name!r} holds {null} null values: cannot "
                             "convert non-finite values (NA or inf) to integer")
        columns[name] = columns[name].astype(np.int64)


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


_MEX_FILES = {"matrix": "matrix.mtx.gz", "features": "features.tsv.gz",
              "barcodes": "barcodes.tsv.gz"}


def find_feature_matrix_files(spaceranger_dir, hd_binning: Optional[str] = None) -> dict:
    """Locate the ``{matrix, features, barcodes}`` MEX files of an array.

    With ``hd_binning``: that binning's ``filtered_feature_bc_matrix``.
    Else the first match below the directory in sorted order, paths under
    a ``filtered_feature_bc_matrix`` first (a real ``outs/`` also holds the
    raw matrix, whose out-of-tissue barcodes must not shadow the filtered
    one). Raises ValueError when a file is missing.
    """
    found = {}
    if hd_binning is not None:
        mat_dir = os.path.join(str(spaceranger_dir), "outs", "binned_outputs",
                               hd_binning, "filtered_feature_bc_matrix")
        for key, name in _MEX_FILES.items():
            path = os.path.join(mat_dir, name)
            if os.path.exists(path):
                found[key] = path
    else:
        paths = sorted(glob.glob(os.path.join(str(spaceranger_dir), "**"), recursive=True),
                       key=lambda s: ("filtered_feature_bc_matrix" not in s, s))
        for key, name in _MEX_FILES.items():
            match = next((p for p in paths if name in p), None)
            if match is not None:
                found[key] = match
    if len(found) == len(_MEX_FILES):
        return found
    raise ValueError(f"Cannot locate matrix files for {spaceranger_dir}")


def _tsv_rows(path) -> list:
    with gzip.open(str(path), "rt", newline="") as fh:
        return [row for row in csv.reader(fh, delimiter="\t")]


def read_feature_names(spaceranger_dir=None, individual_files=None,
                       hd_binning: Optional[str] = None) -> dict:
    """Feature ID -> gene symbol, from the first two columns of
    ``features.tsv.gz`` (a repeated ID keeps its last symbol)."""
    if individual_files is None:
        individual_files = find_feature_matrix_files(spaceranger_dir, hd_binning)
    return {row[0]: row[1] for row in _tsv_rows(individual_files["features"])}


def read_feature_matrix(spaceranger_dir=None, individual_files=None,
                        hd_binning: Optional[str] = None, barcodes=None):
    """``(counts, feature_ids, barcodes)`` of an array's MEX matrix: the
    dense (genes, barcodes) counts in the matrix's dtype, the feature IDs
    and the column barcodes.

    ``barcodes``: the columns to keep, in that order (only they are made
    dense); a barcode the matrix lacks raises KeyError. Default: every
    column in file order.
    """
    import scipy.io

    if individual_files is None:
        individual_files = find_feature_matrix_files(spaceranger_dir, hd_binning)
    mat = scipy.io.mmread(individual_files["matrix"]).tocsc()
    feature_ids = [row[0] for row in _tsv_rows(individual_files["features"])]
    columns = [row[0] for row in _tsv_rows(individual_files["barcodes"])]
    if barcodes is None:
        return mat.toarray(), feature_ids, columns
    index = {b: j for j, b in enumerate(columns)}
    barcodes = list(barcodes)
    keep = [index[b] for b in barcodes]
    return mat[:, keep].toarray(), feature_ids, barcodes
