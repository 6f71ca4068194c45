"""Patch preprocessing: ImageNet normalization and spot pixel boxes.

The window == patch crop is the only extraction of this port so far (the
crop itself is :mod:`gridnext_tpu_torch.ops.patch_gather_cuda`); the cubic
antialiased resize of ``window != patch`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from gridnext_tpu_torch import geometry

# ImageNet normalization used with pretrained image classifiers
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img):
    """Normalize a float [0,1] channels-last image tensor or batch."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def _spot_pixel_boxes(positions, window: int):
    """In-tissue spots -> (oddr_x, oddr_y, x_px, y_px) int arrays.

    Pixel coords are rounded (fractional coords occur rarely) and offset by
    the edge padding of ``window//2``. ``positions`` is a
    :class:`~gridnext_tpu_torch.io.spaceranger.Positions` (any table whose
    ``positions[name]`` gives a column works).
    """
    keep = np.asarray(positions["in_tissue"]).astype(int) == 1
    x_ind, y_ind = geometry.pseudo_hex_to_oddr(
        np.asarray(positions["array_col"])[keep],
        np.asarray(positions["array_row"])[keep])
    x_px = np.rint(np.asarray(positions["pxl_col_in_fullres"])[keep]
                   .astype(float)).astype(int) + window // 2
    y_px = np.rint(np.asarray(positions["pxl_row_in_fullres"])[keep]
                   .astype(float)).astype(int) + window // 2
    return np.asarray(x_ind), np.asarray(y_ind), x_px, y_px
