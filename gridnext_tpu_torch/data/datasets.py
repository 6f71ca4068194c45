"""Grid datasets for ``register``: count grids from unified count caches,
patch grids cropped from fullres slides on the card, and the two paired.

:class:`CountGridDataset` is the JAX package's ``data/datasets.py``
``CountGridDataset`` without annotations; :class:`SlideGridDataset` builds
what the JAX package's ``PatchGridDataset`` reads from its ``_patches*``
JPEG caches, but crops the slide losslessly on the card and writes no
file; :class:`MMStackDataset` pairs them, and
:func:`create_visium_dataset` is the JAX package's factory for the grids
``register`` reads. The annotated grids and the spot datasets wait for
the training slice.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import geometry, ingest
from gridnext_tpu_torch.io.annotations import read_annotated_starray
from gridnext_tpu_torch.io.spaceranger import read_positions
from gridnext_tpu_torch.io.unify import unified_cache_path
from gridnext_tpu_torch.observability import stage
from gridnext_tpu_torch.pipeline import patch_grid


class CountGridDataset:
    """Per-array (H, W, n_genes) float32 count grids, with (H, W) int64 zero
    label grids beside them. ``timer``: an optional
    :class:`~gridnext_tpu_torch.observability.StageTimer` that times each
    cache read as ``"count read"``."""

    def __init__(self, count_files: Sequence, Visium: bool = True,
                 select_genes: Optional[Sequence[str]] = None,
                 h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST,
                 timer=None):
        self.count_files = list(count_files)
        self.Visium = Visium
        self.select_genes = select_genes
        self.h_st, self.w_st = h_st, w_st
        self.timer = timer

    def __len__(self):
        return len(self.count_files)

    def __getitem__(self, idx):
        with stage(self.timer, "count read"):
            counts, annots = read_annotated_starray(
                self.count_files[idx], select_genes=self.select_genes,
                h_st=self.h_st, w_st=self.w_st, Visium=self.Visium)
            return counts.astype(np.float32), annots.astype(np.int64)


def to_device_slide(wsi: np.ndarray, device) -> torch.Tensor:
    """A decoded (H, W, 3) uint8 slide on ``device`` (a read-only decode is
    copied first: torch cannot share it)."""
    return torch.from_numpy(np.require(wsi, requirements="W")).to(device)


class SlideGridDataset:
    """Per-array ``(H, W, P, P, 3)`` float32 patch grids on ``device``,
    cropped from the fullres slides
    (:func:`~gridnext_tpu_torch.pipeline.patch_grid`: edge padding, the
    gather kernel, the cubic resize where ``window_size`` differs from
    ``patch_size``, ``/255``), with (H, W) int64 zero label grids beside
    them.

    Slides decode with :func:`gridnext_tpu_torch.ingest.decode_slide` and
    are freed once cropped. ``hd_binning`` reads that binning's positions
    parquet and indexes the grid by (array_row, array_col); pass the
    square lattice as ``h_st``/``w_st``. ``timer`` times ``"decode"`` and
    ``"crop + grid"`` (the card synchronised at its end).
    """

    def __init__(self, image_files: Sequence, spaceranger_dirs: Sequence, *,
                 patch_size: int, window_size: Optional[int] = None,
                 hd_binning: Optional[str] = None, h_st: int = geometry.VISIUM_H_ST,
                 w_st: int = geometry.VISIUM_W_ST, device="cuda", timer=None):
        if len(image_files) != len(spaceranger_dirs):
            raise ValueError("need one spaceranger dir per image file")
        self.image_files = [str(f) for f in image_files]
        self.spaceranger_dirs = [str(s) for s in spaceranger_dirs]
        self.patch_size, self.window_size = int(patch_size), window_size
        self.hd_binning = hd_binning
        self.h_st, self.w_st = int(h_st), int(w_st)
        self.device = torch.device(device)
        self.timer = timer

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx):
        with stage(self.timer, "decode"):
            wsi = ingest.decode_slide(self.image_files[idx])
        with stage(self.timer, "crop + grid", self.device):
            positions = read_positions(self.spaceranger_dirs[idx], self.hd_binning)
            grid = patch_grid(to_device_slide(wsi, self.device), positions,
                              self.patch_size, self.window_size, self.h_st, self.w_st,
                              hex_coords=self.hd_binning is None)
        return grid, np.zeros((self.h_st, self.w_st), np.int64)


class MMStackDataset:
    """Pairs an image and a count grid dataset: items ``((x_image,
    x_count), y)``, the labels zeroed where the two disagree."""

    def __init__(self, image_dataset, count_dataset):
        if len(image_dataset) != len(count_dataset):
            raise ValueError("Datasets must be of the same length!")
        self.image_dataset = image_dataset
        self.count_dataset = count_dataset

    def __len__(self):
        return len(self.count_dataset)

    def __getitem__(self, idx):
        x1, y1 = self.image_dataset[idx]
        x2, y2 = self.count_dataset[idx]
        return (x1, x2), np.where(y1 != y2, 0, y1)


def create_visium_dataset(spaceranger_dirs: Sequence, use_image: bool = True,
                          fullres_image_files: Optional[Sequence] = None,
                          patch_size_px: Optional[int] = None,
                          window_size_px: Optional[int] = None,
                          hd_binning: Optional[str] = None, grid_dims=None,
                          device="cuda", timer=None):
    """The grid datasets of a cohort: the JAX package's
    ``create_visium_dataset(spatial=True)`` without annotations.

    Returns a :class:`MMStackDataset` of image and count grids, or with
    ``use_image=False`` the :class:`CountGridDataset`. ``grid_dims`` (an
    ``(h, w)``, with ``hd_binning``) indexes the grids of a square Visium
    HD lattice by (array_row, array_col).

    Unlike the JAX factory, nothing is written into the Spaceranger
    directories: a missing unified count cache raises FileNotFoundError
    (run ``python -m gridnext_tpu prepare`` first), the caches are read as
    they are (``register`` validates their gene axis first), and the image
    grids are cropped from the slides on ``device`` each time, with no
    ``_patches*`` JPEG cache.
    """
    if use_image and not patch_size_px:
        raise ValueError("Must specify patch size in pixels")
    if grid_dims is not None and hd_binning is None:
        raise ValueError("grid_dims is only meaningful with hd_binning")
    if hd_binning is not None and use_image and grid_dims is None:
        raise NotImplementedError(
            "hd_binning with use_image=True needs grid_dims (the square "
            "HD bin lattice the patch grid is indexed by)")
    spaceranger_dirs = [str(s) for s in spaceranger_dirs]
    square = grid_dims is not None
    h_st, w_st = ((int(grid_dims[0]), int(grid_dims[1])) if square
                  else (geometry.VISIUM_H_ST, geometry.VISIUM_W_ST))
    count_files = [unified_cache_path(srd, hd_binning) for srd in spaceranger_dirs]
    for srd, cfile in zip(spaceranger_dirs, count_files):
        if not os.path.exists(cfile):
            raise FileNotFoundError(
                f"{cfile} not found -- run `python -m gridnext_tpu prepare "
                f"--spaceranger {srd}` first")
    counts = CountGridDataset(count_files, Visium=not square, h_st=h_st, w_st=w_st,
                              timer=timer)
    if not use_image:
        return counts
    if fullres_image_files is None:
        raise ValueError("Must provide fullres_image_files to extract image patches")
    for imfile in fullres_image_files:
        if not os.path.exists(imfile):
            raise ValueError(f"Could not find image file: {imfile}")
    return MMStackDataset(
        SlideGridDataset(fullres_image_files, spaceranger_dirs, patch_size=patch_size_px,
                         window_size=window_size_px, hd_binning=hd_binning, h_st=h_st,
                         w_st=w_st, device=device, timer=timer),
        counts)
