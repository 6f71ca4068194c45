"""The unified count caches (``<array>.unified.tsv.gz``), without pandas.

``prepare`` (:func:`prepare_count_files`) writes one gzip TSV per
Spaceranger directory: a header ``Gene<TAB>x_y<TAB>...`` (one
``{array_col}_{array_row}`` column per spot) and one row of integer counts
per gene of the cohort's union gene axis, in the ``GX`` member chain of
:mod:`~gridnext_tpu_torch.io.tsv_codec`. The naming rules, the readers, the
gene-axis checks and the writer are the port's copies of the JAX package's
``io/unify.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from gridnext_tpu_torch.io.spaceranger import (positions_to_coord_strings, read_feature_matrix,
                                               read_positions)
from gridnext_tpu_torch.io.tsv_codec import read_row_names, read_tsv_matrix, write_tsv_matrix


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


def assert_gene_axis_match(genes, genes0, cf, cf0):
    """Raise the misaligned-gene-axis ``ValueError`` when ``genes !=
    genes0``, with the JAX package's message (``io/unify.py:55-76``)."""
    if genes != genes0:
        if all(".unified" in str(f) for f in (cf, cf0)):
            remedy = ("(unified caches prepared in separate runs?). Delete "
                      "the *.unified.tsv.gz caches and regenerate them over "
                      "the full cohort in one prepare_count_files/"
                      "create_visium_dataset call, or pass select_genes to "
                      "align by name.")
        else:
            remedy = ("Pass select_genes to align the files by gene name, "
                      "or rebuild them over one shared gene axis.")
        raise ValueError(
            f"count files do not share a gene axis: {cf} differs from "
            f"{cf0}. {remedy}")


def read_unified_genes(count_file) -> list:
    """Gene axis (the first column) of one unified cache, without parsing
    the counts."""
    return read_row_names(count_file)


def read_count_matrix(count_file):
    """``(genes, columns, values)`` of a unified cache: the gene names, the
    spot column names and the (genes, spots) float64 counts
    (:func:`~gridnext_tpu_torch.io.tsv_codec.read_tsv_matrix`)."""
    return read_tsv_matrix(count_file)


def validated_unified_cache(srd, hd_binning=None, genes: Optional[list] = None) -> str:
    """Path of ``srd``'s unified count cache, verified to exist and (when
    ``genes`` is given, a trained model's recorded gene axis) to carry
    exactly that gene set and order. Raises ``FileNotFoundError`` /
    ``ValueError`` with the JAX package's messages."""
    cfile = unified_cache_path(srd, hd_binning)
    if not os.path.exists(cfile):
        raise FileNotFoundError(
            f"{cfile} not found -- run `python -m gridnext_tpu_torch prepare "
            f"--spaceranger {srd}` first")
    if genes is not None and read_unified_genes(cfile) != list(genes):
        raise ValueError(
            f"{cfile} has a different gene set/order than the model was "
            "trained on -- regenerate the unified counts with the training "
            "cohort's settings")
    return cfile


def check_unified_gene_axis(count_files: Sequence) -> list:
    """Assert that unified caches share one gene axis; return it.

    Caches written by separate :func:`prepare_count_files` runs over
    different cohorts have different detection-rate-filtered gene sets;
    training over them would mix misaligned gene axes (``io/unify.py:109-124``).
    """
    genes0 = None
    for cf in count_files:
        genes = read_unified_genes(cf)
        if genes0 is None:
            genes0 = genes
        else:
            assert_gene_axis_match(genes, genes0, cf, count_files[0])
    return genes0


def _coord_columns(srd, barcodes, hd_binning) -> list:
    """The ``{array_col}_{array_row}`` names of ``barcodes`` (KeyError for a
    barcode without a position row, as ``positions.loc`` raises)."""
    return positions_to_coord_strings(read_positions(srd, hd_binning), barcodes)


def prepare_count_files(spaceranger_dirs: Sequence, suffix: Optional[str] = None,
                        minimum_detection_rate: Optional[float] = 0.02,
                        verbose: bool = True, hd_binning: Optional[str] = None,
                        timer=None) -> list:
    """Write each Spaceranger directory's unified count cache; returns the
    written paths in input order (``io/unify.py:127-191``).

    Each array's MEX matrix (:func:`~gridnext_tpu_torch.io.read_feature_matrix`)
    gets ``{array_col}_{array_row}`` columns from its positions; the cohort's
    gene axis is the sorted union of the feature IDs (as ``pd.concat(...,
    sort=True)`` sorts it, also for one array), missing genes 0; genes
    detected (count > 0) in no more than ``minimum_detection_rate`` of all
    the cohort's spots are dropped (None: no filter). ``hd_binning`` reads
    that Visium HD binning; ``suffix`` defaults to its cache suffix.
    ``timer``: an optional
    :class:`~gridnext_tpu_torch.observability.StageTimer` that times the
    stages ``"MEX read"``, ``"union and filter"`` and ``"write"``.
    """
    from gridnext_tpu_torch.observability import stage

    if suffix is None:
        suffix = unified_count_suffix(hd_binning)
    arrays, stems = [], []
    with stage(timer, "MEX read"):
        for srd in spaceranger_dirs:
            counts, ids, barcodes = read_feature_matrix(srd, hd_binning=hd_binning)
            if len(set(ids)) != len(ids):
                raise ValueError(f"{srd}: repeated feature IDs in features.tsv.gz")
            arrays.append((counts, ids, _coord_columns(srd, barcodes, hd_binning)))
            stems.append(os.path.join(str(srd), array_name(srd)))
    with stage(timer, "union and filter"):
        genes = sorted(set().union(*(ids for _, ids, _ in arrays)))
        row = {g: i for i, g in enumerate(genes)}
        frames, detected = [], np.zeros(len(genes), np.int64)
        for counts, ids, _ in arrays:
            if ids == genes:
                full = counts.astype(np.int64, copy=False)
            else:
                full = np.zeros((len(genes), counts.shape[1]), np.int64)
                full[[row[g] for g in ids]] = counts
            frames.append(full)
            detected += np.count_nonzero(full > 0, axis=1)
        n_spots = sum(f.shape[1] for f in frames)
        if verbose:
            print(f"unified gene axis: {len(genes)} genes across "
                  f"{len(frames)} arrays")
        keep = np.ones(len(genes), bool)
        if minimum_detection_rate is not None:
            with np.errstate(invalid="ignore", divide="ignore"):
                keep = (detected / float(n_spots)) > minimum_detection_rate
            if verbose:
                pct = 100.0 * minimum_detection_rate
                print(f"detection-rate filter (<{pct:.2f}% of spots): "
                      f"{int(keep.sum())} genes kept")
        if not keep.all():
            frames = [f[keep] for f in frames]
            genes = [g for g, k in zip(genes, keep) if k]
        if verbose:
            depth = np.concatenate([f.sum(axis=0) for f in frames])
            print(f"median depth: {int(np.median(depth))} counts/spot")
    written = []
    with stage(timer, "write"):
        for stem, frame, (_, _, columns) in zip(stems, frames, arrays):
            path = stem + suffix
            write_tsv_matrix(path, genes, columns, frame, index_name="Gene", force_int=True)
            written.append(path)
    return written
