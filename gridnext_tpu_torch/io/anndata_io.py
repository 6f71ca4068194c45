"""AnnData builders and consumers (the JAX package's ``io/anndata_io.py``).

The frame assembly needs no pandas, by design: a :class:`Frame` (row names
and named numpy columns) stands for an ``obs`` / ``var`` DataFrame and a
:class:`CountFrame` (a values matrix with row and column names) for the
counts, as ``workflows/pca.CountTable`` stands for a count DataFrame.
Positions and features come from :mod:`~gridnext_tpu_torch.io.spaceranger`,
Loupe CSVs from :mod:`~gridnext_tpu_torch.io.annotations`' reader, with the
JAX package's rules: in-tissue barcodes, blank Loupe cells dropped, rows
indexed ``{array}_{x}_{y}``, the outer join over genes in first-occurrence
order with 0 fill, and ``var``'s first non-missing value. Annotation values
are typed as pandas' ``read_csv`` types them (strings, or int64 / float64
for a column of numbers); pixel coordinates are float64.

Only :func:`create_visium_anndata` and :func:`create_visium_anndata_img`
build an ``AnnData``; they need the optional ``anndata`` package (and the
pandas it brings) and raise the JAX package's ``ImportError`` without it.
The consumers are duck-typed (``.X``, ``.obs[...]``, ``.obsm``,
``adata[mask]``). Image patches are read by the port's JPEG codec and land
as float32 tensors on ``device`` (default the card); patch caches missing
from :func:`resolve_imgpatch_dirs` are written by
:func:`~gridnext_tpu_torch.pipeline.save_visium_patches` (one gather launch
an array) under the names the dataset factory uses.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.annotations import _NA, _is_number, _read_table
from gridnext_tpu_torch.io.spaceranger import (read_feature_matrix, read_feature_names,
                                               read_positions)


def _require_anndata():
    try:
        import anndata as ad
        return ad
    except ImportError as e:
        raise ImportError(
            "this function requires the optional 'anndata' package") from e


@dataclasses.dataclass
class Frame:
    """A small table: row names ``index`` and ``columns``, an ordered dict of
    numpy arrays with one value a row (an ``obs`` or ``var`` DataFrame)."""

    index: list
    columns: dict

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __len__(self) -> int:
        return len(self.index)

    def take(self, rows) -> "Frame":
        """The rows ``rows`` (positions or a boolean mask)."""
        rows = np.flatnonzero(rows) if np.asarray(rows).dtype == bool else np.asarray(rows, int)
        return Frame([self.index[i] for i in rows.tolist()],
                     {k: v[rows] for k, v in self.columns.items()})


@dataclasses.dataclass
class CountFrame:
    """A (spots, genes) count matrix ``values`` with its row names ``index``
    and gene IDs ``columns``."""

    values: np.ndarray
    index: list
    columns: list

    def __len__(self) -> int:
        return len(self.index)

    def take(self, rows) -> "CountFrame":
        rows = np.flatnonzero(rows) if np.asarray(rows).dtype == bool else np.asarray(rows, int)
        return CountFrame(self.values[rows], [self.index[i] for i in rows.tolist()],
                          list(self.columns))


def _loupe_labels(afile) -> tuple:
    """``({barcode: row}, labels)`` of a Loupe CSV's first column, blank
    cells dropped, the labels typed as pandas' ``read_csv`` types the
    column: int64 when every cell is an integer, float64 when every cell is
    a number or blank, else strings."""
    _, rows = _read_table(afile, ",")
    cells = [(r[0], r[1] if len(r) > 1 else "") for r in rows]
    kept = [(b, v) for b, v in cells if v not in _NA]
    values = [v for _, v in kept]
    if values and all(_is_number(v) for v in values):
        def integer(v):
            try:
                int(v)
            except ValueError:
                return False
            return True
        if len(kept) == len(cells) and all(integer(v) for v in values):
            labels = np.asarray([int(v) for v in values], np.int64)
        else:
            labels = np.asarray([float(v) for v in values], np.float64)
    else:
        labels = np.asarray(values, dtype=object)
    return {b: i for i, (b, _) in enumerate(kept)}, labels


def assemble_visium_frames(spaceranger_dirs: Sequence,
                           annot_files: Optional[Sequence] = None,
                           hd_binning: Optional[str] = None) -> list:
    """Per-array ``(counts, obs, var)``: the assembly of
    :func:`create_visium_anndata`, without anndata or pandas.

    - counts: a :class:`CountFrame` over the array's in-tissue barcodes (in
      positions order), kept only where the annotation file labels them when
      one is given (blank Loupe cells dropped);
    - obs: a :class:`Frame` with x / y (array_col / array_row), x_px / y_px,
      the array name and ``annotation``, indexed ``{array}_{x}_{y}``;
    - var: a :class:`Frame` with ``gene_symbol``, indexed by gene ID.

    One triple per array, in input order.
    """
    frames = []
    for i, srd in enumerate(spaceranger_dirs):
        pos = read_positions(srd, hd_binning=hd_binning)
        in_tissue = np.asarray(pos["in_tissue"]).astype(int) == 1
        rows = np.flatnonzero(in_tissue)
        annot = None
        if annot_files is not None:
            annot, labels = _loupe_labels(annot_files[i])
            rows = np.asarray([r for r in rows.tolist() if pos.barcodes[r] in annot], int)
        barcodes = [pos.barcodes[r] for r in rows.tolist()]
        counts, gene_ids, _ = read_feature_matrix(srd, hd_binning=hd_binning,
                                                  barcodes=barcodes)
        symbols = read_feature_names(srd, hd_binning=hd_binning)
        arr = Path(srd).stem
        columns = {"x": pos["array_col"][rows], "y": pos["array_row"][rows],
                   "x_px": pos["pxl_col_in_fullres"][rows],
                   "y_px": pos["pxl_row_in_fullres"][rows],
                   "array": np.asarray([arr] * len(rows), dtype=object)}
        if annot is not None:
            columns["annotation"] = labels[np.asarray([annot[b] for b in barcodes], int)]
        index = [f"{arr}_{x}_{y}" for x, y in zip(columns["x"].tolist(),
                                                   columns["y"].tolist())]
        var = Frame(list(gene_ids), {"gene_symbol": np.asarray(
            [symbols[g] for g in gene_ids], dtype=object)})
        frames.append((CountFrame(np.ascontiguousarray(counts.T), index, list(gene_ids)),
                       Frame(index, columns), var))
    return frames


def concat_visium_frames(frames) -> tuple:
    """Outer-join concatenation of per-array ``(counts, obs, var)``: spot
    rows stacked in array order; the gene axis the union of the arrays'
    genes in first-occurrence order, a gene an array lacks counted 0;
    ``var`` each gene's first row (``ad.concat(join='outer',
    merge='first')``). Returns ``(X, obs, var)``."""
    gene_order = list(dict.fromkeys(g for counts, _, _ in frames for g in counts.columns))
    where = {g: j for j, g in enumerate(gene_order)}
    dtype = np.result_type(*[c.values.dtype for c, _, _ in frames]) if frames else np.float64
    X = np.zeros((sum(len(c) for c, _, _ in frames), len(gene_order)), dtype)
    index, start = [], 0
    for counts, _, _ in frames:
        cols = np.asarray([where[g] for g in counts.columns], int)
        X[start:start + len(counts)][:, cols] = counts.values
        start += len(counts)
        index += counts.index
    names = list(dict.fromkeys(k for _, obs, _ in frames for k in obs.columns))
    obs = Frame([r for _, o, _ in frames for r in o.index], {
        k: np.concatenate([o.columns[k] if k in o.columns else np.full(len(o), np.nan)
                           for _, o, _ in frames]) if frames else np.zeros(0)
        for k in names})
    first = {}
    for _, _, var in frames:
        for i, g in enumerate(var.index):
            first.setdefault(g, (var, i))
    var_names = list(dict.fromkeys(k for _, _, v in frames for k in v.columns))
    var = Frame(list(gene_order), {
        k: np.asarray([first[g][0].columns[k][first[g][1]] if k in first[g][0].columns
                       else np.nan for g in gene_order], dtype=object)
        for k in var_names})
    return CountFrame(X, index, gene_order), obs, var


def _anndata_of(ad, X: CountFrame, obs: Frame, var: Frame, destfile):
    """The ``AnnData`` of concatenated frames (``obs`` and ``var`` turned into
    pandas here, behind the anndata gate: anndata brings pandas)."""
    import pandas as pd
    from scipy import sparse

    adata = ad.AnnData(X=sparse.csr_matrix(X.values.astype(np.float32)),
                       obs=pd.DataFrame(dict(obs.columns), index=list(obs.index)),
                       var=pd.DataFrame(dict(var.columns), index=list(var.index)))
    if destfile is not None:
        adata.write(destfile, compression="gzip")
    return adata


def create_visium_anndata(spaceranger_dirs: Sequence, annot_files: Optional[Sequence] = None,
                          destfile=None, hd_binning: Optional[str] = None):
    """Annotated multi-array count AnnData: :func:`assemble_visium_frames`
    and :func:`concat_visium_frames`, then one ``AnnData`` (X a float32 CSR
    matrix), written to ``destfile`` when given. Needs ``anndata``."""
    ad = _require_anndata()
    frames = assemble_visium_frames(spaceranger_dirs, annot_files=annot_files,
                                    hd_binning=hd_binning)
    return _anndata_of(ad, *concat_visium_frames(frames), destfile)


def attach_imgpaths(frames, imgpatch_dirs) -> list:
    """Each array's ``obs['imgpath']`` (``<dir>/{array}_{x}_{y}.jpg``), rows
    whose patch file does not exist dropped from counts and obs."""
    out = []
    for (counts, obs, var), pdir in zip(frames, imgpatch_dirs):
        arrs = list(dict.fromkeys(obs["array"].tolist()))
        assert len(arrs) == 1, "one array per assembled frame"
        arr = arrs[0]
        imfiles = [os.path.join(str(pdir), f"{arr}_{x}_{y}.jpg")
                   for x, y in zip(obs["x"].tolist(), obs["y"].tolist())]
        obs = Frame(list(obs.index), {**obs.columns,
                                      "imgpath": np.asarray(imfiles, dtype=object)})
        keep = np.array([os.path.exists(im) for im in imfiles], bool)
        out.append((counts.take(keep), obs.take(keep), var))
    return out


def resolve_imgpatch_dirs(spaceranger_dirs: Sequence, fullres_image_files,
                          patch_size_px: Optional[int] = None,
                          patch_size_um: Optional[float] = 100.0,
                          save_patches_to=None, hd_binning=None, device="cuda") -> list:
    """The arrays' patch-cache directories, named by the shared
    ``patch_cache_suffix`` (the dataset factory's names; HD caches carry the
    cohort's largest lattice), beside each Spaceranger directory or under
    ``save_patches_to``. A missing one is written from its fullres image by
    ``save_visium_patches`` on ``device``."""
    from gridnext_tpu_torch.io.spaceranger import cohort_hd_lattice_dims
    from gridnext_tpu_torch.io.unify import array_name
    from gridnext_tpu_torch.pipeline import (distance_um_to_px, patch_cache_suffix,
                                             save_visium_patches)

    if patch_size_px is None and patch_size_um is None:
        raise ValueError("Must specify patch size in pixels "
                         "(patch_size_px) or microns (patch_size_um)")
    dims = (cohort_hd_lattice_dims(spaceranger_dirs, hd_binning)
            if hd_binning is not None else None)
    suffix = patch_cache_suffix(patch_size_px, patch_size_um, hd_binning=hd_binning,
                                hd_dims=dims)
    root = None
    if save_patches_to is not None:
        root = str(save_patches_to)
        os.makedirs(root, exist_ok=True)
    imgpatch_dirs = [os.path.join(root or str(srd), array_name(srd) + suffix)
                     for srd in spaceranger_dirs]
    for imfile, pdir, srd in zip(fullres_image_files, imgpatch_dirs, spaceranger_dirs):
        if not os.path.exists(pdir):
            if not os.path.exists(imfile):
                raise ValueError(f"Could not find image file: {imfile}")
            ps = (patch_size_px if patch_size_px is not None
                  else distance_um_to_px(srd, patch_size_um, hd_binning=hd_binning))
            save_visium_patches(imfile, srd, pdir, patch_size=ps, hd_binning=hd_binning,
                                h_st=dims[0] if dims else None,
                                w_st=dims[1] if dims else None, device=device)
    return imgpatch_dirs


def create_visium_anndata_img(spaceranger_dirs: Sequence, imgpatch_dirs=None,
                              fullres_image_files=None, annot_files=None,
                              destfile=None, patch_size_px: Optional[int] = None,
                              patch_size_um: Optional[float] = 100.0,
                              save_patches_to=None, hd_binning=None, device="cuda"):
    """Count AnnData with each spot's patch path (``obs['imgpath']``):
    :func:`assemble_visium_frames`, :func:`resolve_imgpatch_dirs` (when no
    ``imgpatch_dirs`` are given), :func:`attach_imgpaths`,
    :func:`concat_visium_frames`, then one ``AnnData``. Needs ``anndata``."""
    ad = _require_anndata()
    frames = assemble_visium_frames(spaceranger_dirs, annot_files=annot_files,
                                    hd_binning=hd_binning)
    if imgpatch_dirs is None and fullres_image_files is None:
        raise ValueError("Must provide either patched image directories or fullres images")
    if imgpatch_dirs is None:
        imgpatch_dirs = resolve_imgpatch_dirs(
            spaceranger_dirs, fullres_image_files, patch_size_px=patch_size_px,
            patch_size_um=patch_size_um, save_patches_to=save_patches_to,
            hd_binning=hd_binning, device=device)
    frames = attach_imgpaths(frames, imgpatch_dirs)
    return _anndata_of(ad, *concat_visium_frames(frames), destfile)


# -- consumers (duck-typed AnnData) ----------------------------------------------


def _dense(X) -> np.ndarray:
    return np.asarray(X.todense()) if hasattr(X, "todense") else np.asarray(X)


def _features(adata, use_pcs) -> np.ndarray:
    return np.asarray(adata.obsm["X_pca"][:, :use_pcs] if use_pcs else _dense(adata.X))


def anndata_to_grids(adata, labels, obs_x: str = "x", obs_y: str = "y",
                     h_st: int = 78, w_st: int = 64, use_pcs=False,
                     vis_coords: bool = True) -> tuple:
    """One array's AnnData -> ``((h, w, features) float32, (h, w) int64)``
    numpy grids, labels shifted +1 (0 the background)."""
    dat = _features(adata, use_pcs)
    counts_grid = np.zeros((h_st, w_st, dat.shape[1]), np.float32)
    labels_grid = np.zeros((h_st, w_st), np.int64)
    xs = np.asarray(adata.obs[obs_x], dtype=int)
    ys = np.asarray(adata.obs[obs_y], dtype=int)
    if vis_coords:
        xs, ys = geometry.pseudo_hex_to_oddr(xs, ys)
    labels_grid[ys, xs] = np.asarray(labels) + 1
    counts_grid[ys, xs] = dat
    return counts_grid, labels_grid


def anndata_to_spot_arrays(adata, obs_label: str, use_pcs=False) -> tuple:
    """``(X float32, y int64, classes)`` spot arrays, labels encoded over the
    sorted classes."""
    labels_raw = np.asarray(adata.obs[obs_label])
    classes = np.unique(labels_raw)
    y = np.searchsorted(classes, labels_raw).astype(np.int64)
    return np.asarray(_features(adata, use_pcs), np.float32), y, classes


def _patches(paths, transform, device) -> torch.Tensor:
    from gridnext_tpu_torch.data.datasets import _load_patches

    return _load_patches([str(p) for p in paths], transform, torch.device(device))


class MMAnnSpotDataset:
    """Spot items ``((x_image, x_count), y)`` over an AnnData with patch paths:
    the ``(P, P, 3)`` float32 patch (``/ 255``, then ``img_transforms`` of
    the batch) on ``device``, the float32 count row (``adata.X``, or the
    first ``use_pcs`` columns of ``obsm['X_pca']``) and the int64 label over
    the sorted ``obs[obs_label]`` classes. :meth:`batch` decodes a batch in
    one call."""

    def __init__(self, adata, obs_label: str, obs_img: str = "imgpath",
                 use_pcs=None, img_transforms: Optional[Callable] = None, device="cuda"):
        labels_raw = np.asarray(adata.obs[obs_label])
        self.classes = np.unique(labels_raw)
        self.annotations = np.searchsorted(self.classes, labels_raw).astype(np.int64)
        self._X = np.asarray(_features(adata, use_pcs), np.float32)
        self.imgfiles = [str(p) for p in adata.obs[obs_img]]
        self.transform = img_transforms
        self.device = torch.device(device)

    def __len__(self):
        return len(self.imgfiles)

    def batch(self, indices):
        idx = np.asarray(indices, np.int64)
        imgs = _patches([self.imgfiles[i] for i in idx.tolist()], self.transform, self.device)
        return (imgs, self._X[idx]), self.annotations[idx]

    def __getitem__(self, idx):
        (img, cnt), y = self.batch([idx])
        return (img[0], cnt[0]), y[0]

    def sample_item(self):
        (img, cnt), _ = self[0]
        return (torch.zeros_like(img), np.zeros_like(cnt))

    def materialize(self):
        return self.batch(np.arange(len(self)))


def anndata_mm_to_grid_arrays(adata, obs_label: str, obs_arr: str,
                              obs_img: str = "imgpath", obs_x="x", obs_y="y",
                              h_st: int = 78, w_st: int = 64, use_pcs=False,
                              vis_coords: bool = True, img_transforms=None,
                              device="cuda") -> tuple:
    """Multimodal AnnData -> ``((X_img, X_count), Y, classes)``: per array (in
    order of appearance) the ``(h, w, P, P, 3)`` float32 patch grid on
    ``device`` (each array's patches decoded in one call), the count grid
    and the label grid (numpy)."""
    labels_raw = np.asarray(adata.obs[obs_label])
    classes = np.unique(labels_raw)
    arr_of = np.asarray(adata.obs[obs_arr])
    xi_list, xc_list, y_list = [], [], []
    for arr in dict.fromkeys(arr_of.tolist()):
        adata_arr = adata[arr_of == arr]
        lbls = np.searchsorted(classes, np.asarray(adata_arr.obs[obs_label]))
        cg, lg = anndata_to_grids(adata_arr, lbls, obs_x=obs_x, obs_y=obs_y, h_st=h_st,
                                  w_st=w_st, use_pcs=use_pcs, vis_coords=vis_coords)
        xs = np.asarray(adata_arr.obs[obs_x], dtype=int)
        ys = np.asarray(adata_arr.obs[obs_y], dtype=int)
        if vis_coords:
            xs, ys = geometry.pseudo_hex_to_oddr(xs, ys)
        patches = _patches(np.asarray(adata_arr.obs[obs_img]).tolist(), img_transforms, device)
        grid = torch.zeros((h_st, w_st) + tuple(patches.shape[1:]), dtype=patches.dtype,
                           device=patches.device)
        grid[torch.as_tensor(np.atleast_1d(ys), device=grid.device),
             torch.as_tensor(np.atleast_1d(xs), device=grid.device)] = patches
        xi_list.append(grid)
        xc_list.append(cg)
        y_list.append(lg)
    return (torch.stack(xi_list), np.stack(xc_list)), np.stack(y_list), classes


def anndata_to_grid_arrays(adata, obs_label: str, obs_arr: str, obs_x="x",
                           obs_y="y", h_st: int = 78, w_st: int = 64,
                           use_pcs=False, vis_coords: bool = True,
                           arrays_ordered=None) -> tuple:
    """``(X, Y, classes)`` count and label grids of every array (numpy),
    stacked in order of appearance or ``arrays_ordered``."""
    labels_raw = np.asarray(adata.obs[obs_label])
    classes = np.unique(labels_raw)
    arr_of = np.asarray(adata.obs[obs_arr])
    if arrays_ordered is None:
        arrays_ordered = list(dict.fromkeys(arr_of.tolist()))
    xs, ys = [], []
    for arr in arrays_ordered:
        adata_arr = adata[arr_of == arr]
        if len(adata_arr) == 0:
            print(f"Warning: no spots found for array {arr}")
            continue
        lbls = np.searchsorted(classes, np.asarray(adata_arr.obs[obs_label]))
        cg, lg = anndata_to_grids(adata_arr, lbls, obs_x=obs_x, obs_y=obs_y,
                                  h_st=h_st, w_st=w_st, use_pcs=use_pcs,
                                  vis_coords=vis_coords)
        xs.append(cg)
        ys.append(lg)
    return np.stack(xs), np.stack(ys), classes
