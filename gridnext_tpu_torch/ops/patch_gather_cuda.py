"""Patch gather: one ``window x window x 3`` uint8 crop per spot.

:func:`gather_patches` replaces the TPU kernel
``gridnext_tpu/ops/patch_gather_pallas.py::gather_patches``. On a CUDA
tensor it launches the CUDA kernel ``csrc/patch_gather.cu``; on a CPU
tensor it runs :func:`gather_patches_plain`, the same crop in plain
PyTorch indexing. There is no fallback from one to the other.

What bounds the kernel on the card: bytes. Every crop is read once and
written once (2 * N * window^2 * 3 bytes) with no arithmetic; the kernel
runs one block per (spot, 8-row group) with consecutive threads on
consecutive bytes of each row, so each warp moves whole 32-byte sectors.
The TPU kernel's RGBX int32 packing and its ``window % 128`` limit existed
only for the TPU's lanes, so this port reads the raw ``(B, H, W, 3)``
uint8 slide stack directly and takes any window.
"""

from __future__ import annotations

import torch

from gridnext_tpu_torch.ops import _cuda

# Number of kernel launches made by gather_patches (a plain integer; a run
# resets it and reads it to show the kernel was used).
launches = 0


def _checked(imgs: torch.Tensor, y0, x0, window: int, slide):
    """Shared argument checks of the kernel and the plain version."""
    if imgs.dim() == 3:
        imgs = imgs.unsqueeze(0)
    if imgs.dtype != torch.uint8 or imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) uint8 slides, got "
                         f"{tuple(imgs.shape)} {imgs.dtype}")
    b, h, w = imgs.shape[:3]
    if h < window or w < window:
        raise ValueError(f"slide ({h}x{w}) smaller than the {window}px "
                         f"window; cannot crop")
    if y0.dim() != 1 or x0.shape != y0.shape or (
            slide is not None and slide.shape != y0.shape):
        raise ValueError("y0, x0 (and slide) must be (N,) index tensors")
    for name, t in (("y0", y0), ("x0", x0), ("slide", slide)):
        if t is not None and (t.dtype.is_floating_point or t.dtype == torch.bool):
            raise ValueError(f"{name} must be an integer tensor, got {t.dtype}")
    return imgs, b, h, w


def gather_patches_plain(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                         window: int, slide: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch crop: the same function as the kernel, by indexing.

    Corners clamp into ``[0, H - window] x [0, W - window]`` (as
    ``lax.dynamic_slice`` clamps) and slide indices into ``[0, B - 1]``.
    """
    imgs, b, h, w = _checked(imgs, y0, x0, window, slide)
    n = y0.shape[0]
    if n == 0:
        return imgs.new_zeros((0, window, window, 3))
    dev = imgs.device
    yy = y0.to(dev, torch.int64).clamp(0, h - window)
    xx = x0.to(dev, torch.int64).clamp(0, w - window)
    s = (torch.zeros_like(yy) if slide is None
         else slide.to(dev, torch.int64).clamp(0, b - 1))
    offs = torch.arange(window, device=dev)
    rows = (s * h + yy)[:, None] + offs                        # (N, w)
    lin = (rows * w)[:, :, None] + (xx[:, None] + offs)[:, None, :]
    return imgs.reshape(b * h * w, 3)[lin]                     # (N, w, w, 3)


def gather_patches(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                   window: int, slide: torch.Tensor | None = None) -> torch.Tensor:
    """Gather ``(N, window, window, 3)`` uint8 patches.

    Args:
      imgs: ``(B, H, W, 3)`` uint8 slides (a single ``(H, W, 3)`` slide is
        promoted to B=1).
      y0, x0: ``(N,)`` integer top-left corners in pixel coordinates,
        clamped into the slide like ``lax.dynamic_slice``.
      window: crop side in pixels.
      slide: ``(N,)`` slide index per spot, clamped into ``[0, B-1]``
        (default: all 0).

    On a CUDA tensor this launches the CUDA kernel ``csrc/patch_gather.cu``
    (and raises if it cannot); on a CPU tensor it runs
    :func:`gather_patches_plain`. Replaces the TPU kernel
    ``gridnext_tpu/ops/patch_gather_pallas.py::gather_patches``; bound by
    bytes, with one block per (spot, 8 rows) copying whole rows (module
    docstring).
    """
    global launches
    if imgs.device.type == "cpu":
        return gather_patches_plain(imgs, y0, x0, window, slide)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    imgs, b, h, w = _checked(imgs, y0, x0, window, slide)
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    n = y0.shape[0]
    out = torch.empty((n, window, window, 3), dtype=torch.uint8,
                      device=imgs.device)
    if n == 0:
        return out
    dev = imgs.device
    y0 = y0.to(dev, torch.int32).contiguous()
    x0 = x0.to(dev, torch.int32).contiguous()
    slide = None if slide is None else slide.to(dev, torch.int32).contiguous()
    lib = _cuda.library("patch_gather")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_patches_u8(
            imgs.data_ptr(), b, h, w, y0.data_ptr(), x0.data_ptr(),
            None if slide is None else slide.data_ptr(), n, int(window),
            out.data_ptr(), stream)
    _cuda.check(lib, err, "gather_patches")
    launches += 1
    return out
