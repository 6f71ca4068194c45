"""Annotation files (Loupe and Splotch formats) and the count grids of one
array, with numpy and the standard library (the card has no pandas).

The port of ``gridnext_tpu/io/annotations.py``:

* Loupe format: a ``Barcode,<annotation>`` CSV exported from Loupe
  Browser, joined against a positions file to get array coordinates. Blank
  cells (pandas' default NA strings) are unannotated; a column whose every
  label is a number renders integral ones as ints (``'1'``, never
  ``'1.0'``), as pandas' numeric parse and the JAX package's ``_label_str``
  do, and a column with any other label keeps the strings as written.
* Splotch format: an (annotations x ``'{x}_{y}'`` spot coords) one-hot TSV;
  spots whose column sums to other than 1 are dropped.

:func:`read_annotated_starray` places one array's unified counts into the
(H, W, n_genes) odd-right grid beside its annotation grid: strings (bg
``''``) for Loupe annotations, ints (bg 0, labels 1..N) for Splotch.
:func:`to_splotch_annots` converts Loupe CSVs to Splotch TSVs.
"""

from __future__ import annotations

import csv
from typing import Optional, Sequence

import numpy as np

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.spaceranger import coord_string, read_positions_file
from gridnext_tpu_torch.io.unify import read_count_matrix

# pandas.read_csv's default missing-value strings
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _is_number(v: str) -> bool:
    try:
        float(v)
    except ValueError:
        return False
    return True


def _label_strings(values: Sequence[str]) -> list:
    """One canonical string per label: a column of numbers renders each as
    pandas' parse would (integral floats as ints), any other column keeps
    its strings."""
    if values and all(_is_number(v) for v in values):
        out = []
        for v in values:
            f = float(v)
            out.append(str(int(f)) if f.is_integer() else str(f))
        return out
    return list(values)


def _read_table(afile, delim: str):
    with open(str(afile), newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter=delim) if r]
    return rows[0], rows[1:]


def read_annotfile(afile, position_file=None, afile_delim: str = ",", Visium: bool = True):
    """Paired (coord_strings, annotations) of one array.

    Loupe (``Visium=True``): annotations as strings (encoded once the union
    over arrays is known), barcodes without a position row dropped.
    Splotch: integer argmax labels over the one-hot matrix.
    """
    header, rows = _read_table(afile, afile_delim)
    if Visium:
        rows = [r for r in rows if len(r) > 1 and r[1] not in _NA]
        labels = _label_strings([r[1] for r in rows])
        pos = read_positions_file(position_file)
        where = {b: i for i, b in enumerate(pos.barcodes)}
        cols, rws = pos["array_col"], pos["array_row"]
        coords, annots = [], []
        for r, label in zip(rows, labels):
            i = where.get(r[0])
            if i is not None:
                coords.append(coord_string(cols[i], rws[i]))
                annots.append(label)
        return coords, np.array(annots)
    mat = np.array([[float(v) for v in r[1:]] for r in rows], dtype=float)
    spots = header[1:]
    keep = mat.sum(axis=0) == 1
    return [s for s, k in zip(spots, keep) if k], np.argmax(mat[:, keep], axis=0)


def union_classes(annot_files: Sequence, position_files: Sequence,
                  afile_delim: str = ",") -> np.ndarray:
    """Sorted union of annotation names across arrays: the label encoding
    (code i is ``classes[i]``)."""
    all_annots = np.array([])
    for afile, pfile in zip(annot_files, position_files):
        _, annot_strs = read_annotfile(afile, position_file=pfile, afile_delim=afile_delim)
        all_annots = np.union1d(all_annots, annot_strs)
    return all_annots


def encode_labels(values, classes: np.ndarray) -> np.ndarray:
    """Annotation strings -> integer codes in ``classes`` order."""
    idx = np.searchsorted(classes, values)
    if np.any(classes[np.clip(idx, 0, len(classes) - 1)] != np.asarray(values)):
        missing = set(np.asarray(values)) - set(classes)
        raise ValueError(f"labels not in class list: {missing}")
    return idx


def encode_annot_grid(annots_grid: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """String annotation grid -> int grid with bg 0, classes 1..N."""
    if annots_grid.dtype.kind in "iu":
        return annots_grid.astype(np.int64)
    flat = annots_grid.ravel()
    out = np.zeros(flat.shape, dtype=np.int64)
    fg = flat != ""
    out[fg] = encode_labels(flat[fg], classes) + 1
    return out.reshape(annots_grid.shape)


def read_annotated_starray(count_file, annot_file=None, select_genes=None,
                           h_st: int = geometry.VISIUM_H_ST,
                           w_st: int = geometry.VISIUM_W_ST, Visium: bool = True,
                           position_file=None, afile_delim: str = "\t",
                           loupe_delim: str = ","):
    """Read one array's unified count file (and annotations) into grids.

    ``count_file``: a cache path, or its ``read_count_matrix`` tuple read
    before. Spot columns named ``{array_col}_{array_row}`` are placed
    through :func:`~gridnext_tpu_torch.geometry.pseudo_hex_to_oddr`
    (``Visium``) or at their rounded coordinates. ``select_genes`` picks and orders the
    gene rows by name. With ``annot_file`` only annotated spots are placed:
    a Loupe CSV (``position_file`` given, ``loupe_delim``) or a Splotch
    TSV (``afile_delim``).

    Returns:
      counts_grid: (h_st, w_st, n_genes) float64, odd-right indexed.
      annots_grid: (h_st, w_st): strings (bg ``''``) for Loupe annotations,
        ints (bg 0) for Splotch or without annotations.
    """
    genes, columns, values = (count_file if isinstance(count_file, tuple)
                              else read_count_matrix(count_file))
    if select_genes is not None:
        row = {g: i for i, g in enumerate(genes)}
        missing = [g for g in select_genes if g not in row]
        if missing:
            raise KeyError(f"genes not in {count_file}: {missing[:5]}")
        values = values[[row[g] for g in select_genes]]
    adict = None
    if annot_file is not None:
        if position_file is not None:
            coord_strs, annot_strs = read_annotfile(annot_file, position_file=position_file,
                                                    afile_delim=loupe_delim)
            str_len = max((len(a) for a in annot_strs), default=1)
            annots_grid = np.full((h_st, w_st), "", dtype=f"U{str_len}")
        else:
            coord_strs, annot_strs = read_annotfile(annot_file, Visium=False,
                                                    afile_delim=afile_delim)
            annots_grid = np.zeros((h_st, w_st), dtype=int)
        adict = dict(zip(coord_strs, annot_strs))
    else:
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
    if adict is None:
        counts_grid[y, x] = values.T
        return counts_grid, annots_grid
    keep = np.fromiter((c in adict for c in columns), dtype=bool, count=len(columns))
    counts_grid[y[keep], x[keep]] = values.T[keep]
    lbls = np.asarray([adict[c] for c, k in zip(columns, keep) if k])
    if annots_grid.dtype.kind in "iu" and len(lbls):
        lbls = lbls + 1                                   # 0 = background
    annots_grid[y[keep], x[keep]] = lbls
    return counts_grid, annots_grid


def to_splotch_annots(loupe_annotations: Sequence, spaceranger_dirs: Sequence, dest_dir,
                      include_annots: Optional[Sequence[str]] = None) -> None:
    """Convert Loupe annotation CSVs to Splotch one-hot TSVs
    (``io/annotations.py:216-257``): one ``<csv stem>.tsv`` per CSV in
    ``dest_dir``, rows the classes ``include_annots`` (default: the sorted
    union of the labels, 'undefined' aside), columns every CSV barcode's
    ``'{array_col}_{array_row}'``, 1 where the barcode carries the class.
    A barcode without a position row raises ValueError."""
    from pathlib import Path

    from gridnext_tpu_torch.io.spaceranger import read_positions

    def labels(rows):
        present = [r[1] for r in rows if len(r) > 1 and r[1] not in _NA]
        rendered = iter(_label_strings(present))
        return [next(rendered) if len(r) > 1 and r[1] not in _NA else None for r in rows]

    tables = [_read_table(afile, ",") for afile in loupe_annotations]
    if include_annots is None:
        found = {a for _, rows in tables for a in labels(rows)
                 if a and a.lower() != "undefined"}
        include_annots = sorted(found)
    include_annots = list(include_annots)
    for afile, srd, (_, rows) in zip(loupe_annotations, spaceranger_dirs, tables):
        pos = read_positions(srd)
        where = {b: i for i, b in enumerate(pos.barcodes)}
        missing = [r[0] for r in rows if r[0] not in where]
        if missing:
            raise ValueError(
                f"{len(missing)} annotation barcodes in {afile} have no row "
                f"in {srd}'s positions file (first: {missing[0]!r}) -- the "
                "Loupe export and Spaceranger dir are mismatched")
        mat = np.zeros((len(include_annots), len(rows)), dtype=int)
        coords = []
        for i, (r, a) in enumerate(zip(rows, labels(rows))):
            j = where[r[0]]
            coords.append(coord_string(pos["array_col"][j], pos["array_row"][j]))
            if a in include_annots:
                mat[include_annots.index(a), i] = 1
        outfile = Path(dest_dir) / Path(afile).with_suffix(".tsv").name
        with open(outfile, "w", newline="") as fh:
            writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
            writer.writerow([""] + coords)
            for name, line in zip(include_annots, mat.tolist()):
                writer.writerow([name] + line)
