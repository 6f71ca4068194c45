"""Datasets of the port: annotated count and patch grids and spots, and the
factory that builds them for a cohort.

The counterparts of the JAX package's ``data/datasets.py``:

* :class:`CountGridDataset` -- per-array ``(H, W, n_genes)`` count grids
  from unified count caches, with ``(H, W)`` label grids (0 background,
  1..N the classes of the cohort's annotations);
* :class:`CountSpotDataset` -- the annotated spots' ``(n_genes,)`` count
  vectors with labels in ``[0, N)``;
* :class:`PatchGridDataset` and :class:`PatchSpotDataset` -- the patch
  grids and spot patches of the ``_patches*`` JPEG caches
  (``{array}_{col}_{row}.jpg``), decoded on the host by the port's codec
  to Pillow's pixels and moved to the device: what the JAX package's
  classes of those names read;
* :class:`SlideGridDataset` and :class:`SlideSpotDataset` -- the same
  grids and annotated spot patches cropped losslessly from the fullres
  slides on the card by the gather kernel instead: a grid in one launch, a
  batch of spots in one launch (:meth:`SlideSpotDataset.batch`). No file
  is written;
* :class:`MMStackDataset` pairs an image and a count grid dataset,
  :class:`MMSpotDataset` an annotated spot's patch (from a cache or a
  slide) and count vector, :class:`Subset` is a split's view, and
  :func:`create_visium_dataset` is the factory, which writes missing count
  caches (``prepare``) and, on its cache route, missing patch caches
  (``prepare --images``);
* :func:`load_count_dataset` and :func:`load_count_grid_dataset` load
  Splotch-annotated spots and grids eagerly.

Labels follow the JAX package: Loupe CSVs joined to the positions by
barcode, classes the sorted union over the cohort. The spot datasets keep
the JAX package's item order (each array's spots in the sorted order of
their cache file names). One difference by design: the JAX caches skip a
spot whose patch is all zero pixels; the slide datasets keep it.
"""

from __future__ import annotations

import collections
import os
import re
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import geometry, ingest
from gridnext_tpu_torch.io.annotations import (encode_annot_grid, encode_labels,
                                               read_annotated_starray, read_annotfile,
                                               union_classes)
from gridnext_tpu_torch.io.jpeg import decode_jpeg, decode_jpeg_batch, jpeg_info
from gridnext_tpu_torch.io.spaceranger import find_position_file, read_positions
from gridnext_tpu_torch.io.tsv_codec import read_tsv_matrix
from gridnext_tpu_torch.io.unify import (array_name, assert_gene_axis_match,
                                         check_unified_gene_axis, prepare_count_files,
                                         unified_count_suffix)
from gridnext_tpu_torch.observability import stage
from gridnext_tpu_torch.pipeline import (edge_pad, patch_cache_suffix, patch_grid,
                                         resize_matrices, resize_patches, save_visium_patches,
                                         spot_pixel_arrays)
from gridnext_tpu_torch.ops.patch_gather_cuda import gather_patches

_MATRICES = collections.OrderedDict()
_MATRICES_MAX = 4                # (path, mtime_ns, size) -> read_count_matrix tuple
_MATRICES_LOCK = threading.Lock()


def _count_matrix(path):
    """``read_count_matrix`` of ``path`` through a least-recently-used
    cache of four, keyed on ``(path, mtime_ns, size)`` so a rewritten file
    is read anew (the JAX package's ``_read_count_frame``,
    ``data/datasets.py:81-134``).

    Migrate-on-first-read: a ``.unified*.tsv.gz`` cache without the ``GX``
    member chain (single-member gzip, e.g. pandas') is rewritten in the
    chain by the read that parses it, and keyed on the rewritten file, so
    later reads inflate on the thread pool; ``GNX_CACHE_MIGRATE=0`` opts
    out. Other count files are never rewritten."""
    path = str(path)
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    with _MATRICES_LOCK:
        if key in _MATRICES:
            _MATRICES.move_to_end(key)
            return _MATRICES[key]
    migrate = (".unified" in os.path.basename(path) and path.endswith(".tsv.gz")
               and os.environ.get("GNX_CACHE_MIGRATE", "1") != "0")
    matrix = read_tsv_matrix(path, migrate=migrate)
    if migrate:
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
    with _MATRICES_LOCK:
        _MATRICES[key] = matrix
        _MATRICES.move_to_end(key)
        while len(_MATRICES) > _MATRICES_MAX:
            _MATRICES.popitem(last=False)
    return matrix


def _annot_codes(annot_file, position_file, classes, afile_delim: str = ",") -> dict:
    """{'{col}_{row}': class code} of one array's annotations: a Loupe CSV
    joined to its positions (codes in ``classes``), or without a position
    file Splotch's one-hot matrix (its argmax)."""
    if position_file is None:
        coords, codes = read_annotfile(annot_file, Visium=False, afile_delim=afile_delim)
        return dict(zip(coords, codes))
    coords, names = read_annotfile(annot_file, position_file=position_file,
                                   afile_delim=afile_delim)
    return dict(zip(coords, encode_labels(names, classes) if len(names) else names))


class _GridBase:
    """One item per array: ``source_ids()`` names each item's source path
    (the array's directory or count cache), which lets a split route whole
    arrays (the CLI's ``--val-arrays``)."""

    def __len__(self):
        return len(self.source_ids())

    def source_ids(self):
        return list(self.spaceranger_dirs)

    def materialize(self):
        xs, ys = zip(*(self[i] for i in range(len(self))))
        stack = torch.stack if torch.is_tensor(xs[0]) else np.stack
        return stack(list(xs)), np.stack(ys)


class CountGridDataset(_GridBase):
    """Per-array (H, W, n_genes) float32 count grids and (H, W) int64 label
    grids (zeros without ``annot_files``).

    ``annot_format='loupe'``: ``annot_files`` are Loupe CSVs joined to
    ``position_files``, classes the sorted union over the arrays
    (:attr:`classes`); ``'splotch'``: one-hot TSVs, labels inline, no
    position files. ``timer``: an optional
    :class:`~gridnext_tpu_torch.observability.StageTimer` that times each
    cache read as ``"count read"``. Caches of more than one array must share
    a gene axis (``check_gene_axis``, unless ``select_genes`` aligns them by
    name): ``ValueError`` otherwise, as the JAX package raises.
    """

    def __init__(self, count_files: Sequence, Visium: bool = True,
                 select_genes: Optional[Sequence[str]] = None,
                 h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST,
                 timer=None, annot_files: Optional[Sequence] = None,
                 position_files: Optional[Sequence] = None, annot_format: str = "loupe",
                 check_gene_axis: bool = True):
        if annot_files is not None and len(annot_files) != len(count_files):
            raise ValueError("Length of data files and annot_files must match.")
        if annot_format not in ("loupe", "splotch"):
            raise ValueError(f"annot_format must be 'loupe' or 'splotch'; got {annot_format!r}")
        self.count_files = [str(c) for c in count_files]
        self.Visium = Visium
        self.select_genes = select_genes
        self.h_st, self.w_st = h_st, w_st
        self.timer = timer
        self.annot_format = annot_format
        self.annot_files = list(annot_files) if annot_files is not None else None
        self.position_files = (list(position_files)
                               if position_files is not None and annot_format == "loupe"
                               else None)
        self.classes = None
        if self.annot_files is not None and self.position_files is not None:
            self.classes = union_classes(self.annot_files, self.position_files)
        if (check_gene_axis and len(self.count_files) > 1 and select_genes is None
                and all(os.path.exists(cf) for cf in self.count_files)):
            check_unified_gene_axis(self.count_files)

    def source_ids(self):
        return list(self.count_files)

    def __getitem__(self, idx):
        with stage(self.timer, "count read"):
            af = self.annot_files[idx] if self.annot_files is not None else None
            pf = self.position_files[idx] if self.position_files is not None else None
            counts, annots = read_annotated_starray(
                _count_matrix(self.count_files[idx]), af, select_genes=self.select_genes,
                h_st=self.h_st, w_st=self.w_st, Visium=self.Visium, position_file=pf)
            if annots.dtype.kind not in "iu":
                annots = encode_annot_grid(annots, self.classes)
            return counts.astype(np.float32), annots.astype(np.int64)


_COORD = re.compile(r"\d+_\d+")


def _gene_rows(genes, select_genes):
    row = {g: i for i, g in enumerate(genes)}
    return [row[g] for g in select_genes]


def _count_vector(count_file, j, select_genes) -> np.ndarray:
    """Column ``j`` of a cache as float32, its genes picked by name."""
    genes, _, values = _count_matrix(count_file)
    col = values[:, j]
    if select_genes is not None:
        col = col[_gene_rows(genes, select_genes)]
    return col.astype(np.float32)


class CountSpotDataset:
    """The annotated spots: ``(n_genes,)`` float32 count vectors with int64
    labels in ``[0, N)`` (without ``annot_files``: every ``x_y`` column of
    the caches, label 0). Items in file order, each file's in column order.
    The caches must share a gene axis unless ``select_genes`` is given."""

    def __init__(self, count_files: Sequence, annot_files: Optional[Sequence] = None,
                 position_files: Optional[Sequence] = None,
                 select_genes: Optional[Sequence[str]] = None):
        self.count_files = [str(c) for c in count_files]
        self.select_genes = select_genes
        self.classes = None
        if annot_files is not None:
            self.classes = union_classes(annot_files, position_files)
        self._index, self.annotations = [], []     # (file, column), label
        genes0 = None
        for i, cf in enumerate(self.count_files):
            genes, columns, _ = _count_matrix(cf)
            if select_genes is None:
                if genes0 is None:
                    genes0 = genes
                else:
                    assert_gene_axis_match(genes, genes0, cf, self.count_files[0])
            codes = (_annot_codes(annot_files[i], position_files[i], self.classes)
                     if annot_files is not None else None)
            for j, c in enumerate(columns):
                if codes is None:
                    if _COORD.fullmatch(c):
                        self._index.append((cf, j))
                elif c in codes:
                    self._index.append((cf, j))
                    self.annotations.append(int(codes[c]))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx):
        label = self.annotations[idx] if self.annotations else 0
        return _count_vector(*self._index[idx], self.select_genes), np.int64(label)

    def materialize(self):
        xs = np.stack([_count_vector(cf, j, self.select_genes) for cf, j in self._index])
        ys = np.array(self.annotations if self.annotations else np.zeros(len(self)),
                      dtype=np.int64)
        return xs, ys

    def source_ids(self):
        return [cf for cf, _ in self._index]


def to_device_slide(wsi: np.ndarray, device) -> torch.Tensor:
    """A decoded (H, W, 3) uint8 slide on ``device`` (a read-only decode is
    copied first: torch cannot share it)."""
    return torch.from_numpy(np.require(wsi, requirements="W")).to(device)


def _grid_labels(annot_file, position_file, classes, oy, ox, hex_coords, h_st, w_st):
    """(h_st, w_st) int64 labels: code + 1 at each annotated cell (oy, ox)."""
    labels = np.zeros((h_st, w_st), np.int64)
    if annot_file is None:
        return labels
    codes = _annot_codes(annot_file, position_file, classes)
    cols, rows = (geometry.oddr_to_pseudo_hex(ox, oy) if hex_coords else (ox, oy))
    for y, x, c, r in zip(oy, ox, np.asarray(cols), np.asarray(rows)):
        code = codes.get(f"{int(c)}_{int(r)}")
        if code is not None:
            labels[y, x] = int(code) + 1
    return labels


class SlideGridDataset(_GridBase):
    """Per-array ``(H, W, P, P, 3)`` float32 patch grids on ``device``,
    cropped from the fullres slides
    (:func:`~gridnext_tpu_torch.pipeline.patch_grid`: edge padding, one
    gather launch, the cubic resize where ``window_size`` differs from
    ``patch_size``, ``/255``), with (H, W) int64 label grids from
    ``annot_files`` (Loupe CSVs; zeros without).

    Slides decode with :func:`gridnext_tpu_torch.ingest.decode_slide` and
    are freed once cropped. ``hd_binning`` reads that binning's positions parquet and
    indexes the grid by (array_row, array_col); pass the square lattice as
    ``h_st``/``w_st``. ``timer`` times ``"decode"`` and ``"crop + grid"``
    (the card synchronised at its end).
    """

    def __init__(self, image_files: Sequence, spaceranger_dirs: Sequence, *,
                 patch_size: int, window_size: Optional[int] = None,
                 hd_binning: Optional[str] = None, h_st: int = geometry.VISIUM_H_ST,
                 w_st: int = geometry.VISIUM_W_ST, device="cuda", timer=None,
                 annot_files: Optional[Sequence] = None):
        if len(image_files) != len(spaceranger_dirs):
            raise ValueError("need one spaceranger dir per image file")
        self.image_files = [str(f) for f in image_files]
        self.spaceranger_dirs = [str(s) for s in spaceranger_dirs]
        self.patch_size, self.window_size = int(patch_size), window_size
        self.hd_binning = hd_binning
        self.h_st, self.w_st = int(h_st), int(w_st)
        self.device = torch.device(device)
        self.timer = timer
        self.annot_files = list(annot_files) if annot_files is not None else None
        self.position_files = [find_position_file(s, hd_binning)
                               for s in self.spaceranger_dirs]
        self.classes = (union_classes(self.annot_files, self.position_files)
                        if self.annot_files is not None else None)

    def __getitem__(self, idx):
        with stage(self.timer, "decode"):
            wsi = ingest.decode_slide(self.image_files[idx])
        hex_coords = self.hd_binning is None
        with stage(self.timer, "crop + grid", self.device):
            positions = read_positions(self.spaceranger_dirs[idx], self.hd_binning)
            grid = patch_grid(to_device_slide(wsi, self.device), positions,
                              self.patch_size, self.window_size, self.h_st, self.w_st,
                              hex_coords=hex_coords)
        oy, ox, _, _ = spot_pixel_arrays(positions, self.h_st, self.w_st, hex_coords)
        af = self.annot_files[idx] if self.annot_files is not None else None
        return grid, _grid_labels(af, self.position_files[idx], self.classes, oy, ox,
                                  hex_coords, self.h_st, self.w_st)


class SlideSpotDataset:
    """The annotated spots' ``(P, P, 3)`` float32 patches on ``device``,
    cropped from the fullres slides, with int64 labels in ``[0, N)``.

    The spots are each array's in-tissue spots inside the lattice that
    ``annot_files`` labels (every such spot, label 0, without), in the
    order of the JAX package's cache file names. The slides decode once,
    on first use, into one edge-padded ``(S, H, W, 3)`` uint8 stack on the
    device (padded by ``window // 2`` and to the largest slide), so
    :meth:`batch` crops any batch of spots in one gather launch (resized
    to ``patch_size`` where ``window_size`` differs, ``/255``).
    """

    def __init__(self, image_files: Sequence, spaceranger_dirs: Sequence, *,
                 patch_size: int, window_size: Optional[int] = None,
                 annot_files: Optional[Sequence] = None, hd_binning: Optional[str] = None,
                 h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST,
                 device="cuda", timer=None):
        if len(image_files) != len(spaceranger_dirs):
            raise ValueError("need one spaceranger dir per image file")
        self.image_files = [str(f) for f in image_files]
        self.spaceranger_dirs = [str(s) for s in spaceranger_dirs]
        self.patch_size = int(patch_size)
        self.window = int(window_size or patch_size)
        self.device = torch.device(device)
        self.timer = timer
        position_files = [find_position_file(s, hd_binning) for s in self.spaceranger_dirs]
        self.classes = (union_classes(annot_files, position_files)
                        if annot_files is not None else None)
        hex_coords = hd_binning is None
        slide, ys, xs, labels, sources, spot_keys = [], [], [], [], [], []
        for i, srd in enumerate(self.spaceranger_dirs):
            positions = read_positions(srd, hd_binning)
            oy, ox, y_px, x_px = spot_pixel_arrays(positions, h_st, w_st, hex_coords)
            cols, rows = geometry.oddr_to_pseudo_hex(ox, oy) if hex_coords else (ox, oy)
            keys = [f"{int(c)}_{int(r)}" for c, r in zip(np.asarray(cols), np.asarray(rows))]
            codes = (_annot_codes(annot_files[i], position_files[i], self.classes)
                     if annot_files is not None else None)
            stem = os.path.splitext(os.path.basename(os.path.normpath(srd)))[0]
            for j in sorted(range(len(keys)), key=lambda j: f"{stem}_{keys[j]}.jpg"):
                if codes is not None and keys[j] not in codes:
                    continue
                slide.append(i)
                ys.append(y_px[j])
                xs.append(x_px[j])
                labels.append(int(codes[keys[j]]) if codes is not None else 0)
                sources.append(srd)
                spot_keys.append(keys[j])
        self.slide = np.asarray(slide, np.int64)
        self.y0, self.x0 = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
        self.annotations = labels
        self.keys = spot_keys                      # each spot's '{col}_{row}'
        self._sources = sources
        self._stack = None
        self._matrices = None

    def __len__(self):
        return len(self.slide)

    def source_ids(self):
        return list(self._sources)

    def _slides(self) -> torch.Tensor:
        if self._stack is None:
            pad = self.window // 2
            with stage(self.timer, "decode"):
                wsis = [ingest.decode_slide(f) for f in self.image_files]
            h = max(w.shape[0] for w in wsis) + 2 * pad
            w_ = max(w.shape[1] for w in wsis) + 2 * pad
            stack = torch.zeros((len(wsis), h, w_, 3), dtype=torch.uint8, device=self.device)
            for i, wsi in enumerate(wsis):
                padded = edge_pad(to_device_slide(wsi, self.device), pad)
                stack[i, :padded.shape[0], :padded.shape[1]] = padded
            self._stack = stack
            if self.window != self.patch_size:
                self._matrices = resize_matrices(self.window, self.window, self.patch_size,
                                                 self.device)
        return self._stack

    def batch(self, indices):
        """``((n, P, P, 3) float32 patches on the device, (n,) int64 labels)``
        of the spots ``indices``, cropped in one gather launch."""
        idx = np.asarray(indices, np.int64)
        slides = self._slides()
        dev = self.device
        with stage(self.timer, "crop", dev):
            crops = gather_patches(slides, torch.as_tensor(self.y0[idx], device=dev),
                                   torch.as_tensor(self.x0[idx], device=dev), self.window,
                                   torch.as_tensor(self.slide[idx], device=dev))
            if self.window != self.patch_size:
                crops = resize_patches(crops, self.patch_size, self._matrices)
            x = crops.float() / 255.0
        y = (np.asarray(self.annotations, np.int64)[idx] if self.annotations
             else np.zeros(len(idx), np.int64))
        return x, y

    def __getitem__(self, idx):
        x, y = self.batch([idx])
        return x[0], y[0]

    def materialize(self):
        return self.batch(np.arange(len(self)))


_PATCH_RXP_TMPL = r".*_(\d+)_(\d+)\.%s"


def _matched_patch_files(imdir: str, img_ext: str):
    """(names, coords) of the patch-cache files in ``imdir``: the sorted
    listing of the ``*_{col}_{row}.{ext}`` file names (fullmatch, so stray
    ``...jpg.bak`` files are never patches) and their parsed coordinates."""
    rxp = re.compile(_PATCH_RXP_TMPL % re.escape(img_ext))
    names, coords = [], []
    for f in sorted(os.listdir(imdir)):
        m = rxp.fullmatch(f)
        if m is not None:
            names.append(f)
            coords.append((int(m.group(1)), int(m.group(2))))
    return names, coords


def _is_jpeg_name(path) -> bool:
    return str(path).lower().endswith((".jpg", ".jpeg"))


def _decode_patch_batch(paths) -> Optional[np.ndarray]:
    """(n, P, P, 3) uint8 of a batch of square RGB JPEG patches, decoded
    into one buffer across a thread pool
    (:func:`~gridnext_tpu_torch.io.jpeg.decode_jpeg_batch`, the JAX
    package's ``native/patchio.cpp`` route); None when the first file is not
    a square RGB JPEG (the caller then decodes file by file)."""
    if not paths or not _is_jpeg_name(paths[0]):
        return None
    info = jpeg_info(paths[0])
    if info["components"] != 3 or info["width"] != info["height"]:
        return None
    return decode_jpeg_batch(paths, info["width"])


def _read_patch(path) -> np.ndarray:
    """One cache file's uint8 pixels: a JPEG by the port's codec, another
    image by :func:`~gridnext_tpu_torch.ingest.decode_slide` (PIL, RGB)."""
    return decode_jpeg(path, n_threads=1) if _is_jpeg_name(path) else ingest.decode_slide(path)


def _load_patches(paths, transform: Optional[Callable], device) -> torch.Tensor:
    """Cache files -> ``(n, ...)`` float32 tensor on ``device``: the pixels
    ``/ 255`` (as the JAX package scales them), then ``transform`` of the
    whole batch."""
    raw = _decode_patch_batch(paths)
    if raw is None:
        raw = np.stack([_read_patch(p) for p in paths])
    x = torch.from_numpy(raw).to(device).float() / 255.0
    return transform(x) if transform is not None else x


def _check_lengths(files, annot_files, position_files, Visium):
    if annot_files is not None and len(files) != len(annot_files):
        raise ValueError("Length of data files and annot_files must match.")
    if Visium and annot_files is not None and position_files is None:
        raise ValueError(
            "Must provide Spaceranger position files mapping barcodes to array locations.")
    if (annot_files is not None and position_files is not None
            and len(position_files) != len(annot_files)):
        raise ValueError(
            "Number of Spaceranger position files does not match number of annotation files.")


class PatchGridDataset(_GridBase):
    """Per-array ``(H, W, P, P, 3)`` float32 patch grids on ``device`` read
    from ``_patches*`` JPEG caches, with ``(H, W)`` int64 label grids: the
    JAX package's ``PatchGridDataset`` (``data/datasets.py:368-449``).

    Each directory's ``*_{array_col}_{array_row}.{img_ext}`` files decode
    on the host (one thread pool call, Pillow's pixels), move to the device
    and scale to [0, 1]; ``img_transforms`` maps the ``(n, P, P, 3)`` batch
    of an array's patches (the JAX package calls it a patch at a time).
    Each patch lands at its odd-right cell (``Visium=True``) or at (row,
    col) directly; empty cells are zero. Labels: ``annot_files`` joined to
    ``position_files`` (Loupe, classes the sorted union, code + 1 at each
    patch's cell), or without position files Splotch's one-hot TSVs
    (``afile_delim``); zeros without annotations. ``timer`` times
    ``"decode"`` and ``"grid"``.
    """

    def __init__(self, img_dirs: Sequence, annot_files: Optional[Sequence] = None,
                 position_files: Optional[Sequence] = None, Visium: bool = True,
                 img_transforms: Optional[Callable] = None, afile_delim: str = ",",
                 img_ext: str = "jpg", h_st: int = geometry.VISIUM_H_ST,
                 w_st: int = geometry.VISIUM_W_ST, device="cuda", timer=None):
        _check_lengths(img_dirs, annot_files, position_files, Visium)
        self.img_dirs = [str(d) for d in img_dirs]
        self.annot_files = list(annot_files) if annot_files is not None else None
        self.position_files = list(position_files) if position_files is not None else None
        self.Visium = Visium
        self.transform = img_transforms
        self.afile_delim = afile_delim
        self.img_ext = img_ext
        self.h_st, self.w_st = int(h_st), int(w_st)
        self.device = torch.device(device)
        self.timer = timer
        self.classes = None
        if self.annot_files is not None and self.position_files is not None:
            self.classes = union_classes(self.annot_files, self.position_files, afile_delim)

    def source_ids(self):
        return list(self.img_dirs)

    def _files(self, idx):
        names, coords = _matched_patch_files(self.img_dirs[idx], self.img_ext)
        if not names:
            raise ValueError(f"No patches found in {self.img_dirs[idx]}")
        return [os.path.join(self.img_dirs[idx], f) for f in names], coords

    def __getitem__(self, idx):
        paths, coords = self._files(idx)
        codes = None
        if self.annot_files is not None:
            pf = self.position_files[idx] if self.position_files is not None else None
            codes = _annot_codes(self.annot_files[idx], pf, self.classes, self.afile_delim)
        with stage(self.timer, "decode", self.device):
            x = _load_patches(paths, self.transform, self.device)
        a_x = np.asarray([c[0] for c in coords])
        a_y = np.asarray([c[1] for c in coords])
        xs, ys = geometry.pseudo_hex_to_oddr(a_x, a_y) if self.Visium else (a_x, a_y)
        with stage(self.timer, "grid", self.device):
            grid = torch.zeros((self.h_st, self.w_st) + tuple(x.shape[1:]), dtype=torch.float32,
                               device=self.device)
            grid[torch.as_tensor(np.asarray(ys), dtype=torch.int64, device=self.device),
                 torch.as_tensor(np.asarray(xs), dtype=torch.int64, device=self.device)] = x
        labels = np.zeros((self.h_st, self.w_st), np.int64)
        if codes is not None:
            for (cx, cy), y, x_ in zip(coords, np.atleast_1d(ys), np.atleast_1d(xs)):
                code = codes.get(f"{cx}_{cy}")
                if code is not None:
                    labels[y, x_] = int(code) + 1      # 0 is the background
        return grid, labels

    def sample_item(self) -> torch.Tensor:
        """A zero grid of the items' shape on the device, from one decoded
        patch (its shape after ``img_transforms``) instead of an array's
        thousands: the cheap model-init sample."""
        paths, _ = self._files(0)
        x = _load_patches(paths[:1], self.transform, self.device)
        return torch.zeros((self.h_st, self.w_st) + tuple(x.shape[1:]), dtype=torch.float32,
                           device=self.device)


class PatchSpotDataset:
    """Individual spot patches from ``_patches*`` JPEG caches: ``(P, P, 3)``
    float32 tensors on ``device`` with int64 labels in ``[0, N)``, the JAX
    package's ``PatchSpotDataset`` (``data/datasets.py:452-510``). Items in
    each directory's sorted file order; with ``annot_files`` only the
    annotated spots (Loupe CSVs joined to ``position_files``, or Splotch
    TSVs without them), else every cache file, label 0. :meth:`batch`
    decodes a batch on a thread pool in one call and applies
    ``img_transforms`` to the ``(n, P, P, 3)`` batch."""

    def __init__(self, img_dirs: Sequence, annot_files: Optional[Sequence] = None,
                 position_files: Optional[Sequence] = None, Visium: bool = True,
                 img_transforms: Optional[Callable] = None, afile_delim: str = ",",
                 img_ext: str = "jpg", device="cuda", timer=None):
        _check_lengths(img_dirs, annot_files, position_files, Visium)
        self.transform = img_transforms
        self.device = torch.device(device)
        self.timer = timer
        self.imgpath_mapping, self.annotations = [], []
        self.keys, slide = [], []                  # each item's '{col}_{row}', array
        self.classes = None
        if annot_files is not None and Visium:
            self.classes = union_classes(annot_files, position_files, afile_delim)
        for i, imdir in enumerate(img_dirs):
            codes = None
            if annot_files is not None:
                pf = position_files[i] if Visium else None
                codes = _annot_codes(annot_files[i], pf, self.classes, afile_delim)
            names, coords = _matched_patch_files(str(imdir), img_ext)
            for name, (cx, cy) in zip(names, coords):
                key = f"{cx}_{cy}"
                if codes is not None:
                    if key not in codes:
                        continue
                    self.annotations.append(int(codes[key]))
                self.imgpath_mapping.append(os.path.join(str(imdir), name))
                self.keys.append(key)
                slide.append(i)
        self.slide = np.asarray(slide, np.int64)

    def __len__(self):
        return len(self.imgpath_mapping)

    def batch(self, indices):
        """``((n, P, P, 3) float32 patches on the device, (n,) int64 labels)``
        of the items ``indices``."""
        idx = np.asarray(indices, np.int64)
        with stage(self.timer, "decode", self.device):
            x = _load_patches([self.imgpath_mapping[i] for i in idx.tolist()], self.transform,
                              self.device)
        y = (np.asarray(self.annotations, np.int64)[idx] if self.annotations
             else np.zeros(len(idx), np.int64))
        return x, y

    def __getitem__(self, idx):
        x, y = self.batch([idx])
        return x[0], y[0]

    def materialize(self):
        return self.batch(np.arange(len(self)))

    def source_ids(self):
        return list(self.imgpath_mapping)


class MMSpotDataset:
    """Spot-level multimodal items ``((x_image, x_count), y)``: each
    annotated spot's ``(P, P, 3)`` float32 patch on the device beside its
    ``(n_genes,)`` float32 count vector from the array's unified cache (a
    numpy array), and its int64 label in ``[0, N)``.

    The JAX package's ``MMSpotDataset`` (``data/datasets.py:512-618``):
    spots are keyed on their ``'{array_col}_{array_row}'`` string per
    array, and only keys present in both the image side and the cache's
    columns (and annotated, with ``annot_files``) are items, in the image
    side's order. The caches must share a gene axis unless
    ``select_genes`` is given. :meth:`batch` builds a batch in one call.

    Two forms of the image side: the patch caches (``img_dirs``, one
    ``_patches*`` directory per count file, with ``position_files``, as the
    JAX package reads them: a :class:`PatchSpotDataset`), or the fullres
    slides cropped on the card (``image_files`` and ``spaceranger_dirs``:
    a :class:`SlideSpotDataset`, one gather launch a batch).
    """

    def __init__(self, count_files: Sequence, image_files: Optional[Sequence] = None,
                 spaceranger_dirs: Optional[Sequence] = None, *,
                 patch_size: Optional[int] = None,
                 window_size: Optional[int] = None, annot_files: Optional[Sequence] = None,
                 select_genes: Optional[Sequence[str]] = None, hd_binning: Optional[str] = None,
                 h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST,
                 device="cuda", timer=None, img_dirs: Optional[Sequence] = None,
                 position_files: Optional[Sequence] = None, Visium: bool = True,
                 img_transforms: Optional[Callable] = None, img_ext: str = "jpg",
                 afile_delim: str = ","):
        self.count_files = [str(c) for c in count_files]
        self.select_genes = select_genes
        if img_dirs is not None:
            if len(count_files) != len(img_dirs):
                raise ValueError("need one patch dir per count file")
            self.images = PatchSpotDataset(img_dirs, annot_files, position_files, Visium,
                                           img_transforms, afile_delim, img_ext,
                                           device=device, timer=timer)
        else:
            if image_files is None or len(count_files) != len(image_files):
                raise ValueError("need one image file per count file")
            self.images = SlideSpotDataset(image_files, spaceranger_dirs,
                                           patch_size=patch_size, window_size=window_size,
                                           annot_files=annot_files, hd_binning=hd_binning,
                                           h_st=h_st, w_st=w_st, device=device, timer=timer)
        self.classes = self.images.classes
        columns, genes0 = [], None
        for cf in self.count_files:
            genes, cols, _ = _count_matrix(cf)
            if select_genes is None:
                if genes0 is None:
                    genes0 = genes
                else:
                    assert_gene_axis_match(genes, genes0, cf, self.count_files[0])
            columns.append({c: j for j, c in enumerate(cols)})
        self._index = []                           # (image spot, count file, column)
        for i, (s, key) in enumerate(zip(self.images.slide.tolist(), self.images.keys)):
            j = columns[s].get(key)
            if j is not None:
                self._index.append((i, self.count_files[s], j))
        if not self._index:
            raise ValueError(
                "no spots shared between count and patch caches -- were they "
                "generated from the same Spaceranger runs?")
        spots = np.asarray([i for i, _, _ in self._index], np.int64)
        self.annotations = ([self.images.annotations[i] for i in spots]
                            if annot_files is not None else [])
        self._spots = spots

    def __len__(self):
        return len(self._index)

    def batch(self, indices):
        """``(((n, P, P, 3) patches on the device, (n, n_genes) counts),
        (n,) labels)`` of the items ``indices``."""
        idx = np.asarray(indices, np.int64)
        x_image, _ = self.images.batch(self._spots[idx])
        x_count = np.stack([_count_vector(cf, j, self.select_genes) for _, cf, j in
                            (self._index[i] for i in idx.tolist())])
        y = (np.asarray(self.annotations, np.int64)[idx] if self.annotations
             else np.zeros(len(idx), np.int64))
        return (x_image, x_count), y

    def __getitem__(self, idx):
        (xi, xc), y = self.batch([idx])
        return (xi[0], xc[0]), y[0]

    def materialize(self):
        return self.batch(np.arange(len(self)))

    def source_ids(self):
        return [cf for _, cf, _ in self._index]


class MMStackDataset(_GridBase):
    """Pairs an image and a count grid dataset: items ``((x_image,
    x_count), y)``, the labels zeroed where the two disagree."""

    def __init__(self, image_dataset, count_dataset):
        if len(image_dataset) != len(count_dataset):
            raise ValueError("Datasets must be of the same length!")
        self.image_dataset = image_dataset
        self.count_dataset = count_dataset
        self.classes = getattr(image_dataset, "classes", None)

    def __getitem__(self, idx):
        x1, y1 = self.image_dataset[idx]
        x2, y2 = self.count_dataset[idx]
        return (x1, x2), np.where(y1 != y2, 0, y1)

    def source_ids(self):
        return self.count_dataset.source_ids()

    def materialize(self):
        items = [self[i] for i in range(len(self))]
        xi = [x[0] for x, _ in items]
        stack = torch.stack if torch.is_tensor(xi[0]) else np.stack
        return ((stack(xi), np.stack([x[1] for x, _ in items])),
                np.stack([y for _, y in items]))


class Subset:
    """Index-subset view of a map-style dataset, with an optional transform
    of the inputs: the trainers stream a split through it. A dataset with
    ``batch`` keeps it (one call per batch)."""

    def __init__(self, dataset, indices, transform: Optional[Callable] = None):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.transform = transform
        if hasattr(dataset, "batch"):
            self.batch = self._batch

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        x, y = self.dataset[int(self.indices[i])]
        return (self.transform(x) if self.transform is not None else x), y

    def _batch(self, idx):
        x, y = self.dataset.batch(self.indices[np.asarray(idx, np.int64)])
        return (self.transform(x) if self.transform is not None else x), y


def _lattice_dims(spaceranger_dirs, hd_binning, grid_dims):
    if grid_dims is None:
        return geometry.VISIUM_H_ST, geometry.VISIUM_W_ST
    if isinstance(grid_dims, str):
        if grid_dims != "auto":
            raise ValueError(f"grid_dims must be 'auto' or (h, w); got {grid_dims!r}")
        from gridnext_tpu_torch.io.spaceranger import cohort_hd_lattice_dims

        return cohort_hd_lattice_dims(spaceranger_dirs, hd_binning)
    return int(grid_dims[0]), int(grid_dims[1])


def create_visium_dataset(spaceranger_dirs: Sequence, use_image: bool = True,
                          fullres_image_files: Optional[Sequence] = None,
                          patch_size_px: Optional[int] = None,
                          window_size_px: Optional[int] = None,
                          hd_binning: Optional[str] = None, grid_dims=None,
                          device="cuda", timer=None, *, use_count: bool = True,
                          spatial: bool = True, annot_files: Optional[Sequence] = None,
                          select_genes: Optional[Sequence[str]] = None,
                          count_suffix: str = ".unified.tsv.gz",
                          minimum_detection_rate: Optional[float] = 0.02,
                          patch_size_um: Optional[float] = 100.0,
                          img_transforms: Optional[Callable] = None,
                          save_patches_to=None):
    """The datasets of a cohort: the JAX package's factory
    (``data/datasets.py:717-893``).

    ``spatial=True`` (grids): a :class:`MMStackDataset` of image and count
    grids, or the image grids (``use_count=False``) or the
    :class:`CountGridDataset` (``use_image=False``). ``spatial=False``
    (spots): the :class:`MMSpotDataset`, the image spots
    (``use_count=False``) or the :class:`CountSpotDataset`
    (``use_image=False``). ``annot_files``: one Loupe CSV per directory.
    ``grid_dims`` (``(h, w)`` or ``'auto'``, with ``hd_binning``) indexes
    the grids of a square Visium HD lattice by (array_row, array_col).

    Missing unified count caches (``<dir>/<name><count_suffix>``) are
    written first, over the whole cohort, by
    :func:`~gridnext_tpu_torch.io.unify.prepare_count_files` with
    ``minimum_detection_rate``; caches that exist must share a gene axis
    (``ValueError`` otherwise). The patch size is ``patch_size_px``, else
    ``patch_size_um`` converted per array by
    :func:`~gridnext_tpu_torch.pipeline.distance_um_to_px`.

    The image side takes one of two routes:

    * the JPEG patch caches, as the JAX package's factory reads them, when
      ``save_patches_to`` is given (the caches live there, and missing ones
      are written first by
      :func:`~gridnext_tpu_torch.pipeline.save_visium_patches` on
      ``device`` from ``fullres_image_files``) or ``fullres_image_files`` is
      None (the caches beside each Spaceranger directory, which must
      exist: ``ValueError`` otherwise). Directories are named by
      :func:`~gridnext_tpu_torch.pipeline.patch_cache_suffix`; the datasets
      are :class:`PatchGridDataset`, :class:`PatchSpotDataset` and the cache
      form of :class:`MMSpotDataset`, with ``img_transforms``;
    * otherwise (``fullres_image_files`` and no ``save_patches_to``) the
      patches are cropped from the slides on ``device`` and no file is
      written or read: :class:`SlideGridDataset`, :class:`SlideSpotDataset`
      and the crop form of :class:`MMSpotDataset`, which take no
      ``img_transforms`` (``ValueError``).
    """
    if not (use_count or use_image):
        raise ValueError("Must utilize at least one data modality")
    if use_image and not (patch_size_px or patch_size_um):
        raise ValueError("Must specify patch size in pixels (int) or um (float)")
    if grid_dims is not None and hd_binning is None:
        raise ValueError("grid_dims is only meaningful with hd_binning")
    if hd_binning is not None and use_image and grid_dims is None:
        raise NotImplementedError(
            "hd_binning with use_image=True needs grid_dims (the square "
            "HD bin lattice the patch grid is indexed by)")
    spaceranger_dirs = [str(s) for s in spaceranger_dirs]
    square = grid_dims is not None
    h_st, w_st = _lattice_dims(spaceranger_dirs, hd_binning, grid_dims)
    count_files = None
    if use_count:
        suffix = unified_count_suffix(hd_binning, count_suffix)
        count_files = [os.path.join(srd, array_name(srd) + suffix) for srd in spaceranger_dirs]
        if not all(os.path.exists(cf) for cf in count_files):
            print(f"No unified countfiles detected (*{suffix}) -- generating...")
            prepare_count_files(spaceranger_dirs, suffix, minimum_detection_rate,
                                hd_binning=hd_binning)
        elif len(count_files) > 1:
            check_unified_gene_axis(count_files)
    patch_dirs = None
    if use_image and (save_patches_to is not None or fullres_image_files is None):
        patch_dirs = _patch_caches(spaceranger_dirs, fullres_image_files, save_patches_to,
                                   patch_size_px, patch_size_um, window_size_px, hd_binning,
                                   (h_st, w_st) if square else None, device)
    position_files = [find_position_file(s, hd_binning) for s in spaceranger_dirs]
    counts = None
    if use_count:
        if not spatial and not use_image:
            return CountSpotDataset(count_files, annot_files, position_files, select_genes)
        if spatial:
            counts = CountGridDataset(count_files, Visium=not square, select_genes=select_genes,
                                      h_st=h_st, w_st=w_st, timer=timer,
                                      annot_files=annot_files,
                                      position_files=position_files if annot_files else None,
                                      check_gene_axis=False)
            if not use_image:
                return counts
    if patch_dirs is not None:
        kw = dict(img_transforms=img_transforms, device=device, timer=timer)
        if spatial:
            images = PatchGridDataset(patch_dirs, annot_files, position_files,
                                      Visium=not square, h_st=h_st, w_st=w_st, **kw)
            return images if counts is None else MMStackDataset(images, counts)
        if use_count:
            return MMSpotDataset(count_files, img_dirs=patch_dirs, annot_files=annot_files,
                                 position_files=position_files, select_genes=select_genes, **kw)
        return PatchSpotDataset(patch_dirs, annot_files, position_files, **kw)
    if img_transforms is not None:
        raise ValueError("img_transforms applies to the patch caches (save_patches_to, or "
                         "fullres_image_files=None); the slide crops take none")
    for imfile in fullres_image_files:
        if not os.path.exists(imfile):
            raise ValueError(f"Could not find image file: {imfile}")
    if patch_size_px is None:
        from gridnext_tpu_torch.pipeline import distance_um_to_px

        sizes = sorted({distance_um_to_px(srd, patch_size_um, hd_binning=hd_binning)
                        for srd in spaceranger_dirs})
        if len(sizes) > 1:
            raise ValueError(f"patch_size_um={patch_size_um} spans {sizes} px across the "
                             "arrays; one dataset crops one patch size (pass patch_size_px)")
        patch_size_px = sizes[0]
    kw = dict(patch_size=patch_size_px, window_size=window_size_px, device=device,
              timer=timer, annot_files=annot_files)
    if not spatial:
        if use_count:
            return MMSpotDataset(count_files, fullres_image_files, spaceranger_dirs,
                                 select_genes=select_genes, hd_binning=hd_binning,
                                 h_st=h_st, w_st=w_st, **kw)
        return SlideSpotDataset(fullres_image_files, spaceranger_dirs, hd_binning=hd_binning,
                                h_st=h_st, w_st=w_st, **kw)
    images = SlideGridDataset(fullres_image_files, spaceranger_dirs, hd_binning=hd_binning,
                              h_st=h_st, w_st=w_st, **kw)
    return images if counts is None else MMStackDataset(images, counts)


def _patch_caches(spaceranger_dirs, fullres_image_files, save_patches_to, patch_size_px,
                  patch_size_um, window_size_px, hd_binning, hd_dims, device) -> list:
    """The cohort's ``_patches*`` directories, the missing ones written
    first from ``fullres_image_files`` (the JAX package's factory,
    ``data/datasets.py:821-860``)."""
    suffix = patch_cache_suffix(patch_size_px=patch_size_px, patch_size_um=patch_size_um,
                                window_size_px=window_size_px, hd_binning=hd_binning,
                                hd_dims=hd_dims)
    root = None
    if save_patches_to is not None:
        root = str(save_patches_to)
        os.makedirs(root, exist_ok=True)
    dirs = [os.path.join(root or srd, array_name(srd) + suffix) for srd in spaceranger_dirs]
    missing = [i for i, d in enumerate(dirs) if not os.path.exists(d)]
    if missing:
        print(f"No extracted image patches detected for {len(missing)} "
              f"array(s) (*{suffix}) -- generating...")
        if fullres_image_files is None:
            raise ValueError("Must provide fullres_image_files to extract image patches")
        for i in missing:
            imfile = fullres_image_files[i]
            if not os.path.exists(imfile):
                raise ValueError(f"Could not find image file: {imfile}")
            if patch_size_px is not None:
                ps = patch_size_px
            else:
                from gridnext_tpu_torch.pipeline import distance_um_to_px

                ps = distance_um_to_px(spaceranger_dirs[i], patch_size_um, hd_binning=hd_binning)
            save_visium_patches(imfile, spaceranger_dirs[i], dirs[i], patch_size=ps,
                                window_size=window_size_px, hd_binning=hd_binning,
                                h_st=hd_dims[0] if hd_dims else None,
                                w_st=hd_dims[1] if hd_dims else None, device=device)
    return dirs


def load_count_dataset(count_files, annot_files=None, select_genes=None):
    """Eagerly load annotated spots with Splotch annotations: ``(X, y)``,
    the (n_spots, n_genes) float32 count vectors and int64 labels (the
    argmax of each spot's one-hot Splotch column; spots whose column does
    not sum to 1 are skipped). ``data/datasets.py:659-695``."""
    xs, ys = [], []
    genes0 = cf0 = None
    for i, cf in enumerate(count_files):
        genes, columns, values = _count_matrix(cf)
        if select_genes is None:
            if genes0 is None:
                genes0, cf0 = genes, cf
            else:
                assert_gene_axis_match(genes, genes0, cf, cf0)
        labels = None
        if annot_files is not None:
            coords, codes = read_annotfile(annot_files[i], Visium=False, afile_delim="\t")
            labels = dict(zip(coords, codes))
        rows = _gene_rows(genes, select_genes) if select_genes is not None else None
        for j, c in enumerate(columns):
            if labels is not None and c not in labels:
                continue
            col = values[:, j] if rows is None else values[rows, j]
            xs.append(col.astype(np.float32))
            ys.append(int(labels[c]) if labels is not None else 0)
    return np.stack(xs), np.asarray(ys, np.int64)


def load_count_grid_dataset(count_files, annot_files=None, select_genes=None,
                            h_st=geometry.VISIUM_H_ST, w_st=geometry.VISIUM_W_ST,
                            Visium=True):
    """Eagerly load per-array grids with Splotch annotations: ``(X, Y)``,
    the (N, h, w, n_genes) float32 count grids and (N, h, w) int64 label
    grids (0 background, 1..N). ``data/datasets.py:698-715``."""
    xs, ys = [], []
    for i, cf in enumerate(count_files):
        af = annot_files[i] if annot_files is not None else None
        counts, annots = read_annotated_starray(_count_matrix(cf), af,
                                                select_genes=select_genes, h_st=h_st,
                                                w_st=w_st, Visium=Visium)
        xs.append(counts.astype(np.float32))
        ys.append(annots.astype(np.int64))
    return np.stack(xs), np.stack(ys)
