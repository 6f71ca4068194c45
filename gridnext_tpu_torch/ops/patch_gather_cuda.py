"""Patch gather: one ``window x window x 3`` uint8 crop per spot.

:func:`gather_patches` replaces the TPU kernel
``gridnext_tpu/ops/patch_gather_pallas.py::gather_patches``. On a CUDA
tensor it launches the CUDA kernel ``csrc/patch_gather.cu``; on a CPU
tensor it runs :func:`gather_patches_plain`, the same crop in plain
PyTorch indexing. There is no fallback from one to the other.

What bounds the kernel on the card: bytes. Every crop is read once and
written once (2 * N * window^2 * 3 bytes) with no arithmetic. Where a row
is a multiple of 16 bytes (``window % 16 == 0``, as the 128- and 160-px
windows are) the wrapper launches ``gather_bulk_kernel``: one CTA per
crop, each row's 16-byte-aligned covering span copied into shared memory
by a Hopper 1D bulk copy (a source row starts at any byte, so no TMA
tensor map can describe the slide, but a bulk copy needs none), realigned
there by the row's source offset and written with 16-byte stores, rows in
double-buffered stages of 32. Other windows launch
``gather_bytes_kernel``, consecutive threads on consecutive bytes. The TPU kernel's RGBX int32 packing and its
``window % 128`` limit existed only for the TPU's lanes, so this port reads
the raw ``(B, H, W, 3)`` uint8 slide stack directly and takes any window.
"""

from __future__ import annotations

import torch

from gridnext_tpu_torch.ops import _cuda

# Number of kernel launches made by gather_patches (a plain integer; a run
# resets it and reads it to show the kernel was used), and how many of them
# took the byte path.
launches = 0
byte_launches = 0

_STAGE_ROWS = 32              # csrc/patch_gather.cu kStageRows
_MAX_SMEM = 200 * 1024        # csrc/patch_gather.cu kMaxSmem


def bulk(window: int) -> bool:
    """Whether ``window`` takes the bulk-copy kernel (rows of a multiple of
    16 bytes whose two stages of 32 rows fit its shared memory; csrc's
    bulk_ok); other windows take the byte kernel."""
    row = window * 3
    return row % 16 == 0 and 2 * _STAGE_ROWS * (row // 16 + 1) * 16 <= _MAX_SMEM


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


def _gather_patches_cuda(imgs: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                         window: int, slide: torch.Tensor | None) -> torch.Tensor:
    """One launch of ``csrc/patch_gather.cu`` (the op's CUDA implementation)."""
    global launches, byte_launches
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
    use_bulk = bulk(window) and out.data_ptr() % 16 == 0
    lib = _cuda.library("patch_gather")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_patches_u8(
            imgs.data_ptr(), b, h, w, y0.data_ptr(), x0.data_ptr(),
            None if slide is None else slide.data_ptr(), n, int(window),
            int(use_bulk), out.data_ptr(), stream)
    _cuda.check(lib, err, "gather_patches")
    launches += 1
    byte_launches += not use_bulk
    return out


# The crop as the custom op ``gridnext::gather_patches``: torch.export records
# it as one node, so an exported registration program launches the kernel.
# CPU tensors take the plain version, CUDA tensors the kernel; the fake
# implementation gives only the output's shape and dtype.
gather_patches_op = _cuda.custom_op(
    "gather_patches", "(Tensor imgs, Tensor y0, Tensor x0, int window, Tensor? slide) -> Tensor",
    cpu=gather_patches_plain, cuda=_gather_patches_cuda,
    fake=lambda imgs, y0, x0, window, slide: imgs.new_empty(
        (y0.shape[0], window, window, 3), dtype=torch.uint8))


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
    :func:`gather_patches_plain`. Both go through the custom op
    ``gridnext::gather_patches``. Replaces the TPU kernel
    ``gridnext_tpu/ops/patch_gather_pallas.py::gather_patches``; bound by
    bytes, with bulk copies into shared memory and 16-byte stores where the
    row allows (module docstring).
    """
    if imgs.dim() == 3:
        imgs = imgs.unsqueeze(0)
    dev = imgs.device
    y0, x0 = y0.to(dev), x0.to(dev)
    slide = None if slide is None else slide.to(dev)
    return gather_patches_op(imgs, y0, x0, int(window), slide)
