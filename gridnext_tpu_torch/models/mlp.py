"""Fully-connected spot classifier over count vectors.

Port of ``gridnext_tpu/models/mlp.py`` (the count tutorial's f-network):

  Linear(in, 500) -> Linear(500, 100) -> BN -> ReLU ->
  Linear(100, 100) -> Linear(100, 50) -> BN -> ReLU -> Linear(50, n_classes)

The back-to-back linear pairs are kept for checkpoint compatibility.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gridnext_tpu_torch.models.layers import BatchNorm


class CountMLP(nn.Module):
    """Spot classifier ``f`` over 1-D expression vectors.

    Args:
      n_genes: input width (flax infers it from the first input; torch's
        ``Linear`` needs it up front).
      n_classes: output width.
      hidden: widths of the four hidden linear layers.
      batch_norm: BatchNorm after the 2nd and 4th linear layer (the
        tutorial's topology); False is the stateless distilled student.
        flax's BatchNorm (:class:`~gridnext_tpu_torch.models.layers.BatchNorm`:
        momentum 0.9, eps 1e-5, the biased running variance in train mode).
    """

    def __init__(self, n_genes: int, n_classes: int,
                 hidden: Sequence[int] = (500, 100, 100, 50), batch_norm: bool = True):
        super().__init__()
        h1, h2, h3, h4 = hidden
        self.batch_norm = batch_norm
        self.dense = nn.ModuleList(nn.Linear(i, o) for i, o in
                                   ((n_genes, h1), (h1, h2), (h2, h3), (h3, h4),
                                    (h4, n_classes)))
        self.norms = (nn.ModuleList(BatchNorm(w) for w in (h2, h4))
                      if batch_norm else None)

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.norms[i](x) if self.batch_norm else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self._norm(0, self.dense[1](self.dense[0](x))))
        x = torch.relu(self._norm(1, self.dense[3](self.dense[2](x))))
        return self.dense[4](x)
