"""Highly-variable-gene selection (register_hvgs.ipynb workflow), scanpy-free:
the port's copy of the JAX package's ``workflows/hvg.py``, numpy float64.

Implements the Seurat-flavor dispersion-based HVG ranking scanpy's
``sc.pp.highly_variable_genes`` performs on log-normalized data: per-gene
mean/dispersion, dispersions z-scored within mean bins, top-N by normalized
dispersion. Operates on (spots x genes) arrays so it composes with
``workflows.pca.filtered_norm_logcounts``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def highly_variable_genes(X: np.ndarray, n_top_genes: int = 2000,
                          n_bins: int = 20) -> Tuple[np.ndarray, dict]:
    """Rank genes by binned normalized dispersion (Seurat flavor).

    Args:
      X: (spots, genes) log-normalized expression.

    Returns:
      (mask, info): boolean gene mask selecting the top ``n_top_genes`` and a
      dict of per-gene statistics {means, dispersions, dispersions_norm}.
    """
    X = np.asarray(X, np.float64)
    # Seurat computes stats on the expm1 (de-logged) values
    Xe = np.expm1(X)
    mean = Xe.mean(axis=0)
    var = Xe.var(axis=0, ddof=1)
    mean_safe = np.where(mean == 0, 1e-12, mean)
    dispersion = var / mean_safe
    # log-space like scanpy
    disp_log = np.log(np.where(dispersion == 0, np.nan, dispersion))
    mean_log = np.log1p(mean)

    df_bins = np.digitize(mean_log, np.linspace(mean_log.min(), mean_log.max(),
                                                n_bins + 1)[1:-1])
    disp_norm = np.full_like(disp_log, np.nan)
    for b in np.unique(df_bins):
        in_bin = df_bins == b
        vals = disp_log[in_bin]
        mu = np.nanmean(vals)
        n_valid = np.sum(~np.isnan(vals))
        sd = np.nanstd(vals, ddof=1) if n_valid > 1 else np.nan
        if not np.isfinite(sd) or sd == 0:
            # scanpy's singleton-bin fallback: normalize by the bin mean so
            # lone high-expression genes stay selectable (dispersion/mean)
            sd, mu = mu if np.isfinite(mu) and mu != 0 else 1.0, 0.0
        disp_norm[in_bin] = (vals - mu) / sd

    order = np.argsort(np.nan_to_num(disp_norm, nan=-np.inf))[::-1]
    mask = np.zeros(X.shape[1], bool)
    mask[order[:n_top_genes]] = True
    return mask, {"means": mean, "dispersions": dispersion,
                  "dispersions_norm": disp_norm}


def select_hvgs_from_count_files(count_files: Sequence, n_top_genes: int = 2000,
                                 min_counts: int = 100,
                                 target_sum: float = 1e4,
                                 n_bins: int = 20) -> list:
    """Gene names of the top HVGs across a cohort of unified count files.

    Use ``n_bins=1`` for small curated gene panels, where mean-binning has
    too few genes per bin to z-score stably.
    """
    from gridnext_tpu_torch.workflows.pca import filtered_norm_logcounts

    blocks, genes = [], None
    for cf in count_files:
        df = filtered_norm_logcounts(cf, min_counts, target_sum)
        if genes is None:
            genes = list(df.genes)
        elif list(df.genes) != genes:
            raise ValueError(
                f"count file {cf} has a different gene list/order than the "
                "first file; unify the cohort first (io.prepare_count_files)")
        blocks.append(df.values.T)
    X = np.vstack(blocks)
    mask, _ = highly_variable_genes(X, n_top_genes=n_top_genes, n_bins=n_bins)
    return [g for g, m in zip(genes, mask) if m]
