"""PCA-reduced count registration workflow: the port's copy of the JAX
package's ``workflows/pca.py``, without pandas or scikit-learn.

Drop spots under ``min_counts`` UMIs, depth-normalize to 1e4, log1p,
z-scale each gene by the *training cohort's* statistics, clip at 10, fit
PCA, and pick the PC count explaining a target variance fraction.

* Count tables are :class:`CountTable` records (a (genes, spots) float64
  matrix with its gene and barcode lists) in place of the JAX package's
  DataFrames; caches are read by
  :func:`~gridnext_tpu_torch.io.unify.read_count_matrix`.
* :func:`fit_pca` fits on the device of its input with ``torch.linalg``
  (on the card cuSOLVER's ``gesvd``) in float32 (the JAX package casts to
  float32 before scikit-learn's ``PCA``) and returns a :class:`PCAFit`
  with ``PCA``'s fitted attributes, signs fixed by scikit-learn's rule
  (``svd_flip(u_based_decision=False)``: each component's largest-magnitude
  loading is positive). ``outfile``
  writes the fit as a ``.npz`` record (:func:`load_pca` reads it back),
  not a pickled scikit-learn object.
* :func:`pca_transform` is one matmul on the device of its input (an
  array goes to the card, as in :func:`fit_pca`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CountTable:
    """A (genes, spots) matrix with its row and column names: what the JAX
    package keeps in a DataFrame (``index`` genes, ``columns`` barcodes)."""

    values: np.ndarray
    genes: list
    barcodes: list


@dataclasses.dataclass
class PCAFit:
    """scikit-learn ``PCA``'s fitted attributes, as torch tensors on the
    device of the fit (``components_`` (n_components, genes), ``mean_``
    (genes,), ``explained_variance_``, ``explained_variance_ratio_``,
    ``singular_values_`` (n_components,)), and the counts."""

    components_: torch.Tensor
    mean_: torch.Tensor
    explained_variance_: torch.Tensor
    explained_variance_ratio_: torch.Tensor
    singular_values_: torch.Tensor
    n_components_: int
    n_samples_: int
    noise_variance_: float


def _load_counts(count_file) -> CountTable:
    if isinstance(count_file, CountTable):
        return count_file
    from gridnext_tpu_torch.io.unify import read_count_matrix

    genes, barcodes, values = read_count_matrix(str(count_file))
    return CountTable(np.asarray(values, np.float64), list(genes), list(barcodes))


def filtered_norm_logcounts(count_file, min_counts: int = 100,
                            target_sum: float = 1e4) -> CountTable:
    """(genes x spots) count file or :class:`CountTable` -> depth-normalized
    log1p :class:`CountTable` (float64). Spots with fewer than
    ``min_counts`` total UMIs are dropped."""
    df = _load_counts(count_file)
    depths = df.values.sum(axis=0)
    keep = depths >= min_counts
    X = df.values[:, keep] / depths[keep][None, :] * target_sum
    return CountTable(np.log1p(X), list(df.genes),
                      [b for b, k in zip(df.barcodes, keep) if k])


def _check_gene_axes(frames, files):
    """Refuse to stack count tables whose gene axes differ: per-gene
    statistics over misaligned rows would be silently wrong
    (:func:`~gridnext_tpu_torch.io.unify.assert_gene_axis_match`)."""
    genes0, f0 = None, None
    for df, cf in zip(frames, files):
        genes = list(df.genes)
        if genes0 is None:
            genes0, f0 = genes, cf
        elif genes != genes0:
            from gridnext_tpu_torch.io.unify import assert_gene_axis_match

            assert_gene_axis_match(genes, genes0, str(cf), str(f0))


def _scaler_from_normed(frames, files) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene (mean, std) over normalized tables -- the one scaler
    (:func:`fit_cohort_scaler` and :func:`preprocess_cohorts` share it)."""
    _check_gene_axes(frames, files)
    allcounts = np.hstack([df.values for df in frames])
    return allcounts.mean(axis=1), allcounts.std(axis=1)


def fit_cohort_scaler(count_files: Sequence, min_counts: int = 100,
                      target_sum: float = 1e4) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene (mean, std) over a training cohort's normalized log counts."""
    frames = [filtered_norm_logcounts(cf, min_counts, target_sum)
              for cf in count_files]
    return _scaler_from_normed(frames, count_files)


def scale_logcounts(df: CountTable, mean: np.ndarray, std: np.ndarray,
                    clip: float = 10.0) -> CountTable:
    """Z-scale genes by cohort statistics and clip above at ``clip``."""
    std = np.where(std == 0, 1.0, std)
    X = (df.values - mean[:, None]) / std[:, None]
    return CountTable(np.minimum(X, clip), list(df.genes), list(df.barcodes))


def fit_pca(X, n_components: Optional[int] = None, outfile=None,
            device=None) -> PCAFit:
    """Fit PCA on (spots x genes) scaled data in float32.

    ``X``: a tensor (the fit runs on its device) or an array (the fit runs
    on ``device``, default ``cuda``). ``n_components`` None keeps
    ``min(spots, genes)`` components. The full SVD of the centred data,
    scikit-learn's ``full`` solver: where scikit-learn picks another solver
    (``covariance_eigh`` for tall inputs of at most 1,000 genes,
    ``randomized`` for a small ``n_components``) the fits agree to that
    solver's precision. ``outfile``: write the fit as an ``.npz`` record.
    """
    from gridnext_tpu_torch.serving import resolve_device

    if torch.is_tensor(X):
        x = X.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(X, np.float32),
                            device=resolve_device("cuda" if device is None else device))
    n_samples, n_features = x.shape
    k = min(n_samples, n_features) if n_components is None else int(n_components)
    if not 0 <= k <= min(n_samples, n_features):
        raise ValueError(f"n_components={k} must be between 0 and "
                         f"min(n_samples, n_features)={min(n_samples, n_features)}")
    mean = x.mean(0)
    # cuSOLVER's default Jacobi driver stops short of float32's precision
    # (explained variance ratios 1e-4 off a float64 fit at 5,544 x 2,000);
    # its QR driver, as LAPACK's, reaches it
    kw = {"driver": "gesvd"} if x.is_cuda else {}
    _, s, vt = torch.linalg.svd(x - mean, full_matrices=False, **kw)
    # svd_flip(u_based_decision=False): each row's largest |loading| positive
    rows = torch.arange(vt.shape[0], device=vt.device)
    vt = vt * torch.sign(vt[rows, vt.abs().argmax(1)])[:, None]
    var = s ** 2 / (n_samples - 1)
    ratio = var / var.sum()
    noise = float(var[k:].mean()) if k < min(n_features, n_samples) else 0.0
    pca = PCAFit(vt[:k].contiguous(), mean, var[:k].clone(), ratio[:k].clone(),
                 s[:k].clone(), k, int(n_samples), noise)
    if outfile is not None:
        with open(outfile, "wb") as fh:
            np.savez(fh, **{f.name: _host(getattr(pca, f.name))
                            for f in dataclasses.fields(PCAFit)})
    return pca


def _host(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def load_pca(path, device="cpu") -> PCAFit:
    """Read a :func:`fit_pca` ``outfile`` record onto ``device``."""
    with np.load(path) as z:
        kw = {f.name: z[f.name] for f in dataclasses.fields(PCAFit)}
    for name in ("n_components_", "n_samples_"):
        kw[name] = int(kw[name])
    kw["noise_variance_"] = float(kw["noise_variance_"])
    return PCAFit(**{k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
                     else v for k, v in kw.items()})


def n_pcs_for_variance(pca, fraction: float = 0.5) -> int:
    """Smallest PC count explaining > ``fraction`` of the variance; all of
    them when the fitted components never reach ``fraction``."""
    ratio = _host(pca.explained_variance_ratio_)
    above = np.where(np.cumsum(ratio) > fraction)[0]
    if len(above) == 0:
        return int(len(ratio))
    return int(above[0]) + 1


def pca_transform(X, components, mean, n_pcs: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """PCA projection ``(..., genes) -> (..., n_pcs)``: one matmul.

    ``X``: a tensor (the projection runs on its device) or an array (it
    runs on ``device``, default ``cuda``), as :func:`fit_pca`. Pass
    ``pca.components_`` / ``pca.mean_`` from :func:`fit_pca`."""
    from gridnext_tpu_torch.serving import resolve_device

    if torch.is_tensor(X):
        x = X
    else:
        x = torch.as_tensor(np.asarray(X),
                            device=resolve_device("cuda" if device is None else device))
    comp = torch.as_tensor(components if n_pcs is None else components[:n_pcs],
                           device=x.device)
    mean = torch.as_tensor(mean, device=x.device)
    dtype = torch.promote_types(torch.promote_types(x.dtype, comp.dtype), mean.dtype)
    return (x.to(dtype) - mean.to(dtype)) @ comp.to(dtype).T


def preprocess_cohorts(train_count_files: Sequence, all_count_files: Sequence,
                       min_counts: int = 100, target_sum: float = 1e4,
                       clip: float = 10.0, variance_fraction: float = 0.5,
                       pca_outfile=None, device="cuda"):
    """The whole workflow in memory: normalize every file once, fit the
    scaler on the training files, scale every file, fit PCA on every
    training file's spots (on ``device``).

    Returns a dict with the scaler (``mean``, ``std``), the fitted
    ``pca``, ``n_pcs`` at the variance target, and per-file scaled
    :class:`CountTable` records keyed by the input path string (or
    ``id()`` for :class:`CountTable` inputs): every file of
    ``all_count_files`` and ``train_count_files`` gets an entry.
    """
    def _key(cf):
        return id(cf) if isinstance(cf, CountTable) else str(cf)

    normed = {_key(cf): filtered_norm_logcounts(cf, min_counts, target_sum)
              for cf in all_count_files}
    for cf in train_count_files:  # train files need not be in all_count_files
        if _key(cf) not in normed:
            normed[_key(cf)] = filtered_norm_logcounts(cf, min_counts, target_sum)
    every = list(all_count_files) + [cf for cf in train_count_files
                                     if _key(cf) not in
                                     {_key(c) for c in all_count_files}]
    _check_gene_axes([normed[_key(cf)] for cf in every], every)

    train_norm = [normed[_key(cf)] for cf in train_count_files]
    mean, std = _scaler_from_normed(train_norm, train_count_files)

    scaled = {k: scale_logcounts(df, mean, std, clip) for k, df in normed.items()}
    X_train = np.vstack([scaled[_key(cf)].values.T for cf in train_count_files])
    if X_train.shape[0] == 0:
        raise ValueError(
            "no training spots survived the min_counts filter "
            f"(min_counts={min_counts}); lower it or check the count files")
    pca = fit_pca(X_train, outfile=pca_outfile, device=device)
    return {
        "mean": mean, "std": std, "pca": pca,
        "n_pcs": n_pcs_for_variance(pca, variance_fraction),
        "scaled": scaled,
    }
