"""The unified count caches (``<array>.unified.tsv.gz``), read without pandas.

The JAX package's ``prepare`` writes one gzip TSV per Spaceranger directory:
a header ``Gene<TAB>x_y<TAB>...`` (one ``{array_col}_{array_row}`` column
per spot) and one row of counts per gene. Its native writer emits
multi-member gzip, which the standard library's ``gzip`` reads. The naming
rules and the readers here are the port's copies of ``io/unify.py``.
"""

from __future__ import annotations

import gzip
import os
import warnings
from typing import Optional

import numpy as np


def array_name(srd) -> str:
    """The per-array name: the Spaceranger dir's basename (through abspath,
    so trailing slashes and '.' still give the directory's name)."""
    return os.path.basename(os.path.abspath(str(srd)))


def unified_count_suffix(hd_binning=None, base: str = ".unified.tsv.gz") -> str:
    """Cache-file suffix for unified counts; bin-specific for Visium HD."""
    return f".{hd_binning}{base}" if hd_binning else base


def unified_cache_path(srd, hd_binning=None, base: str = ".unified.tsv.gz") -> str:
    """Path of ``srd``'s unified count cache: ``<srd>/<dirname><suffix>``."""
    srd = str(srd)
    return os.path.join(srd, array_name(srd) + unified_count_suffix(hd_binning, base))


def _open_text(path):
    path = str(path)
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_unified_genes(count_file) -> list:
    """Gene axis (the first column) of one unified cache, without parsing
    the counts."""
    with _open_text(count_file) as fh:
        fh.readline()                                   # header
        return [line.split(b"\t", 1)[0].decode() for line in fh if line.strip()]


def _row_values(fields: bytes, n: int) -> np.ndarray:
    """One row's tab-separated numbers as float64; an empty cell is NaN (as
    pandas reads it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            values = np.fromstring(fields, dtype=np.float64, sep="\t")
        except (DeprecationWarning, ValueError):
            values = None
    if values is not None and len(values) == n:
        return values
    cells = fields.split(b"\t")
    if len(cells) != n:
        raise ValueError(f"a row has {len(cells)} values for {n} columns")
    return np.array([float(c) if c.strip() else np.nan for c in cells], np.float64)


def read_count_matrix(count_file):
    """``(genes, columns, values)`` of a unified cache: the gene names, the
    spot column names and the (genes, spots) float64 counts."""
    with _open_text(count_file) as fh:
        header = fh.readline().rstrip(b"\r\n").split(b"\t")
        columns = [c.decode() for c in header[1:]]
        genes, rows = [], []
        for line in fh:
            line = line.rstrip(b"\r\n")
            if not line:
                continue
            name, _, fields = line.partition(b"\t")
            genes.append(name.decode())
            rows.append(_row_values(fields, len(columns)) if columns
                        else np.zeros(0, np.float64))
    values = np.stack(rows) if rows else np.zeros((0, len(columns)), np.float64)
    return genes, columns, values


def validated_unified_cache(srd, hd_binning=None, genes: Optional[list] = None) -> str:
    """Path of ``srd``'s unified count cache, verified to exist and (when
    ``genes`` is given, a trained model's recorded gene axis) to carry
    exactly that gene set and order. Raises ``FileNotFoundError`` /
    ``ValueError`` with the JAX package's messages."""
    cfile = unified_cache_path(srd, hd_binning)
    if not os.path.exists(cfile):
        raise FileNotFoundError(
            f"{cfile} not found -- run `python -m gridnext_tpu prepare "
            f"--spaceranger {srd}` first")
    if genes is not None and read_unified_genes(cfile) != list(genes):
        raise ValueError(
            f"{cfile} has a different gene set/order than the model was "
            "trained on -- regenerate the unified counts with the training "
            "cohort's settings")
    return cfile
