"""Dense-ingest patch grids of Visium HD square lattices, for ``register``.

The port's counterpart of the JAX package's ``DenseWSIGridDataset``
(``data/dense_ingest.py``) without annotations: where the in-tissue bins
tile the slide at an integer pitch equal to the patch size (an
``"exact"`` plan of :func:`~gridnext_tpu_torch.serving.fit_dense_lattice`),
each bin's patch is the slide's tile at ``origin + index * pitch``.

The JAX package reshapes the slide's tiled extent into the grid on the
host and zeroes the background bins. Here the gather kernel crops the
in-tissue bins' tiles on the card (window = pitch, corners from the plan)
and scatters them into a zero grid: the same pixels, since the plan keeps
every tile inside the slide, with only the in-tissue bins read and
written, and the same code as the per-bin grids
(:func:`~gridnext_tpu_torch.pipeline.crop_grid`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import ingest
from gridnext_tpu_torch.data.datasets import to_device_slide
from gridnext_tpu_torch.io.spaceranger import read_positions
from gridnext_tpu_torch.observability import stage
from gridnext_tpu_torch.pipeline import crop_grid
from gridnext_tpu_torch.serving import fit_dense_lattice


class DenseWSIGridDataset:
    """Per-array ``(H, W, P, P, 3)`` float32 patch grids on ``device``, tiled
    from the fullres slides, with (H, W) int64 zero label grids beside them.

    Args:
      image_files: fullres slides, one per array (decoded with
        :func:`gridnext_tpu_torch.ingest.decode_slide`).
      spaceranger_dirs: matching Spaceranger dirs (positions per array).
      patch_size: the bins' patch side in pixels; must equal the lattice
        pitch (an array whose lattice is not an exact integer tiling at
        this pitch inside its slide raises ValueError).
      grid_dims: the ``(h_st, w_st)`` bin lattice.
      hd_binning: the Visium HD binning whose positions parquet to read.
      device: where the grids are built.
      timer: optional StageTimer: ``"decode"`` and ``"crop + grid"``.

    Background bins (not listed, or not in tissue) are zero patches.
    """

    def __init__(self, image_files: Sequence, spaceranger_dirs: Sequence, *,
                 patch_size: int, grid_dims, hd_binning: Optional[str] = None,
                 device="cuda", timer=None):
        if len(image_files) != len(spaceranger_dirs):
            raise ValueError("need one spaceranger dir per image file")
        self.image_files = [str(f) for f in image_files]
        self.spaceranger_dirs = [str(s) for s in spaceranger_dirs]
        self.patch_size = int(patch_size)
        self.hd_binning = hd_binning
        self.h_st, self.w_st = int(grid_dims[0]), int(grid_dims[1])
        self.device = torch.device(device)
        self.timer = timer

    def __len__(self):
        return len(self.image_files)

    def _plan(self, idx, wsi_shape):
        pos = read_positions(self.spaceranger_dirs[idx], self.hd_binning)
        plan = fit_dense_lattice(pos, self.h_st, self.w_st, self.patch_size, wsi_shape)
        if plan is None or plan[0] != "exact":
            raise ValueError(
                f"{self.spaceranger_dirs[idx]}: positions are not an exact "
                f"integer {self.patch_size}px-pitch lattice inside the "
                f"image -- dense ingest needs pitch == patch_size exactly; "
                "use the cache-based pipeline (create_visium_dataset) for "
                "fractional-pitch or irregular cohorts")
        return plan

    def __getitem__(self, idx):
        p = self.patch_size
        with stage(self.timer, "decode"):
            wsi = ingest.decode_slide(self.image_files[idx])
        with stage(self.timer, "crop + grid", self.device):
            _, oy0, ox0, fg, _, _ = self._plan(idx, wsi.shape)
            oy, ox = np.nonzero(fg)
            grid = crop_grid(to_device_slide(wsi, self.device), oy, ox, oy0 + oy * p,
                             ox0 + ox * p, p, p, self.h_st, self.w_st)
        return grid, np.zeros((self.h_st, self.w_st), np.int64)
