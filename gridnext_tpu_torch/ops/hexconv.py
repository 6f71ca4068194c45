"""Hexagonal convolution over Visium odd-right grids, in plain PyTorch.

A hex convolution with ``T`` stencil taps sums, over the taps, the
row-parity-correct shifted feature map (zero outside the grid) times that
tap's ``(C_in, C_out)`` weight matrix. Odd rows are shifted half a unit
right, so a tap's column offset depends on the parity of the output row.

Weight layout: ``kernel[t, ci, co]`` with taps ordered by
:func:`gridnext_tpu_torch.geometry.hex_taps` (radius 1: C, W, E, NW, NE, SW,
SE). This is the plain version behind the CUDA hex-corrector kernel
(:mod:`gridnext_tpu_torch.ops.hexcorrector_cuda`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gridnext_tpu_torch import geometry


def num_taps(radius: int) -> int:
    """Stencil size of a hex kernel: 1 + 3r(r+1) cells within distance r."""
    return 1 + 3 * radius * (radius + 1)


def hex_conv(x: torch.Tensor, kernel: torch.Tensor,
             bias: torch.Tensor | None = None, radius: int = 1) -> torch.Tensor:
    """Hexagonal convolution on an odd-right grid.

    Args:
      x: (..., H, W, C_in) feature map, odd-right indexed.
      kernel: (T, C_in, C_out) tap weights, taps ordered per
        ``geometry.hex_taps(radius)``.
      bias: optional (C_out,).
      radius: hex stencil radius (1 => the 7-cell kernel).

    Returns:
      (..., H, W, C_out), accumulated in float32 and cast back to the
      promoted input dtype.
    """
    t_expected = num_taps(radius)
    if kernel.shape[0] != t_expected:
        raise ValueError(
            f"kernel has {kernel.shape[0]} taps, expected {t_expected} for radius {radius}")
    out_dtype = torch.promote_types(x.dtype, kernel.dtype)
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x.float(), (0, 0, radius, radius, radius, radius))
    k = kernel.float()
    odd_row = (torch.arange(h, device=x.device) % 2 == 1).view(h, 1, 1)

    def tap_slice(dr: int, dc: int) -> torch.Tensor:
        return xp[..., radius + dr:radius + dr + h, radius + dc:radius + dc + w, :]

    out = None
    for t, (dr, ce, co) in enumerate(geometry.hex_taps(radius)):
        tap_map = tap_slice(dr, ce)
        if ce != co:
            tap_map = torch.where(odd_row, tap_slice(dr, co), tap_map)
        term = tap_map @ k[t]
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)
