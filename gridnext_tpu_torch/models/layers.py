"""Shared layers: the hex convolution module."""

from __future__ import annotations

import math

import torch
from torch import nn

from gridnext_tpu_torch.ops.hexconv import hex_conv, num_taps


class HexConv(nn.Module):
    """Hexagonal convolution layer over odd-right ``(..., H, W, C)`` grids.

    Weights are per-tap full matrices ``kernel (T, C_in, C_out)`` in
    ``geometry.hex_taps(radius)`` order, the JAX package's layout, so a
    flax ``HexConv`` kernel loads unchanged. Init: xavier-uniform over the
    full ``(T*C_in, C_out)`` tap fan, zero bias, as the flax layer does.
    """

    def __init__(self, in_features: int, features: int, radius: int = 1):
        super().__init__()
        self.radius = radius
        t = num_taps(radius)
        bound = math.sqrt(6.0 / (t * in_features + features))
        self.kernel = nn.Parameter(
            torch.empty(t, in_features, features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hex_conv(x, self.kernel, self.bias, radius=self.radius)
