"""Grid datasets over unified count caches.

:class:`CountGridDataset` is the JAX package's ``data/datasets.py``
``CountGridDataset`` without annotations (as ``register`` uses it); the
annotated grids and the spot datasets wait for the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.annotations import read_annotated_starray


class CountGridDataset:
    """Per-array (H, W, n_genes) float32 count grids, with (H, W) int64 zero
    label grids beside them."""

    def __init__(self, count_files: Sequence, Visium: bool = True,
                 select_genes: Optional[Sequence[str]] = None,
                 h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST):
        self.count_files = list(count_files)
        self.Visium = Visium
        self.select_genes = select_genes
        self.h_st, self.w_st = h_st, w_st

    def __len__(self):
        return len(self.count_files)

    def __getitem__(self, idx):
        counts, annots = read_annotated_starray(
            self.count_files[idx], select_genes=self.select_genes,
            h_st=self.h_st, w_st=self.w_st, Visium=self.Visium)
        return counts.astype(np.float32), annots.astype(np.int64)
