"""Patch preprocessing: ImageNet normalization, the window resize, the
lattice resample, spot pixel boxes, the patch grids of whole slides and
the JPEG patch caches.

The crop itself is :mod:`gridnext_tpu_torch.ops.patch_gather_cuda`; when
the crop window differs from the patch size, :func:`resize_patches`
resamples it as ``jax.image.resize(method="cubic")`` does in the JAX
package (``pipeline.resize_patches_device``). Visium HD lattices of a
fractional pixel pitch resample straight to patch scale with
:func:`scale_and_translate_linear` (``jax.image.scale_and_translate``,
linear). :func:`patch_grid` builds an array's ``(H, W, P, P, 3)`` float
grid on the slide's device, as the JAX package's ``grid_from_wsi_visium``
builds it on the host. :func:`augment_patches` draws one of the 8
flips/rotations per patch on the card for training (``--augment``).
:func:`remove_color_cast` is SpaCell's colour-cast removal of a slide on
the host. :func:`distance_um_to_px` converts a distance on the tissue to
pixels of an array's fullres image (the patch size of ``patch_size_um``).

The JPEG patch caches (``<array>_patches{N}px/{array}_{col}_{row}.jpg``):
:func:`save_visium_patches` writes one array's, byte-equal to the JAX
package's writer: the crop by the gather kernel on the slide's device,
Pillow's bicubic resample (:func:`pil_resample`, exact on either device)
where the window differs from the patch size, and the port's JPEG encoder
(:mod:`gridnext_tpu_torch.io.jpeg`) at Pillow's quality 75.
:func:`patch_cache_suffix` names the cache directories and
:func:`make_imagenet_transform` is the image tutorial's Resize ->
CenterCrop -> Normalize for the cache readers' ``img_transforms``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.observability import stage
from gridnext_tpu_torch.ops.patch_gather_cuda import gather_patches
from gridnext_tpu_torch.parallel.collectives import draw_rows

# Crops resized at a time in crop_grid (a chunk's float intermediates stay
# near 0.6 GB at 160-px windows).
_RESIZE_CHUNK = 1024

# ImageNet normalization used with pretrained image classifiers
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def hd_bin_um(hd_binning: str) -> float:
    """Bin edge length in um of a Visium HD binning name
    (``'square_008um'`` -> 8.0)."""
    import re

    m = re.search(r"(\d+(?:\.\d+)?)\s*um$", str(hd_binning))
    if m is None:
        raise ValueError(f"Cannot parse bin size from binning {hd_binning!r}")
    return float(m.group(1))


def distance_um_to_px(spaceranger_dir, distance_um: float, hd_binning=None) -> int:
    """Pixels spanning ``distance_um`` on the fullres image of an array.

    The pixel distance per lattice step is the mean ratio of pixel to
    lattice distances over 10 positions (Visium spots are 100 um apart;
    HD bins ``hd_bin_um(hd_binning)`` um, on direct row/col indices). The
    10 rows are those pandas' ``DataFrame.sample(n=10, random_state=0)``
    picks in the JAX package (``pipeline.py:85-112``):
    ``RandomState(0).choice(n, 10, replace=False)``; all rows where there
    are at most 10.
    """
    from gridnext_tpu_torch.io.spaceranger import read_positions

    pos = read_positions(spaceranger_dir, hd_binning)
    rows = np.arange(len(pos.barcodes))
    if len(rows) > 10:
        rows = np.random.RandomState(0).choice(len(rows), 10, replace=False)
    col = pos["array_col"][rows].astype(np.float64)
    row = pos["array_row"][rows].astype(np.float64)
    if hd_binning is not None:
        cart = np.stack([col, row], axis=1)
        lattice_um = hd_bin_um(hd_binning)
    else:
        cart = np.stack(geometry.pseudo_to_true_hex(col, row), axis=1)
        lattice_um = 100.0
    px = np.stack([pos["pxl_col_in_fullres"][rows], pos["pxl_row_in_fullres"][rows]],
                  axis=1).astype(float)
    d_unit = np.mean(geometry.pairwise_distances(px) / geometry.pairwise_distances(cart))
    return int(np.rint(distance_um * d_unit / lattice_um))


def imagenet_normalize(img):
    """Normalize a float [0,1] channels-last image tensor or batch."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


# Pillow's resample (libImaging/Resample.c): filter support and kernel, and
# the fixed-point precision of its 8-bit coefficients
_PIL_FILTERS = {"bilinear": 1.0, "bicubic": 2.0}
_PIL_PRECISION_BITS = 32 - 8 - 2


def _pil_kernel(name: str, x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    if name == "bilinear":
        return np.where(x < 1.0, 1.0 - x, 0.0)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def pil_resample_coefficients(in_size: int, out_size: int, filter: str = "bicubic") -> np.ndarray:
    """``(out_size, in_size)`` int64 matrix of Pillow's fixed-point resample
    coefficients along one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): output pixel ``i`` samples the input at
    ``(i + 1/2) * scale`` with the filter's support widened by ``scale``
    when downsampling, over the input pixels ``[xmin, xmin + n)`` that
    Pillow picks by rounding, its float64 weights normalised to sum to 1
    and rounded half away from zero to 22 fractional bits."""
    if filter not in _PIL_FILTERS:
        raise ValueError(f"filter must be one of {sorted(_PIL_FILTERS)}; got {filter!r}")
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _PIL_FILTERS[filter] * filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _pil_kernel(filter, (np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in w:                    # Pillow's left-to-right float64 sum
            ww += v
        if ww != 0.0:
            w = w / ww
        fixed = w * (1 << _PIL_PRECISION_BITS)
        out[i, xmin:xmin + xmax] = np.where(w < 0, fixed - 0.5, fixed + 0.5).astype(np.int64)
    return out


def _pil_pass(x: torch.Tensor, coeff: np.ndarray, dim: int) -> torch.Tensor:
    """One axis of :func:`pil_resample`: float64 products of the integer
    coefficients (exact: every partial sum stays below 2**40), then
    Pillow's rounding (add half, shift right by 22) and clip to 0..255."""
    k = torch.as_tensor(coeff, dtype=torch.float64, device=x.device)
    y = torch.tensordot(x, k, dims=([dim], [1])).movedim(-1, dim)
    y = torch.floor((y + (1 << (_PIL_PRECISION_BITS - 1))) / (1 << _PIL_PRECISION_BITS))
    return y.clamp_(0, 255)


def pil_resample(img: torch.Tensor, size, filter: str = "bicubic") -> torch.Tensor:
    """``(..., H, W, C)`` uint8 images -> ``(..., oh, ow, C)`` uint8, bit for
    bit what Pillow's ``Image.resize((ow, oh), filter)`` gives each image
    (``"bicubic"``, a = -0.5, its default, or ``"bilinear"``): the
    horizontal pass first, clipped to uint8, then the vertical, each with
    :func:`pil_resample_coefficients`, on the images' device. An axis that
    keeps its size is not resampled, as Pillow skips it."""
    oh, ow = (int(v) for v in size)
    h, w = img.shape[-3], img.shape[-2]
    out = img.to(torch.float64)
    if ow != w:
        out = _pil_pass(out, pil_resample_coefficients(w, ow, filter), img.dim() - 2)
    if oh != h:
        out = _pil_pass(out, pil_resample_coefficients(h, oh, filter), img.dim() - 3)
    return out.to(torch.uint8)


def make_imagenet_transform(resize: int = 256, crop: int = 224):
    """The image tutorial's per-patch transform, Resize(``resize``) ->
    CenterCrop(``crop``) -> Normalize(ImageNet): the JAX package's
    ``make_imagenet_transform`` for the cache readers' ``img_transforms``.

    Takes float [0, 1] channels-last patches ``(..., P, P, 3)`` (a batch
    or one patch) on any device and returns float32: each is truncated to
    uint8 (``clip(x * 255)``), its shorter side resized to ``resize``
    keeping the aspect (Pillow's bilinear, :func:`pil_resample`), centre
    cropped to ``crop`` and ImageNet-normalised.
    """
    def transform(img: torch.Tensor) -> torch.Tensor:
        u8 = torch.clamp(img * 255.0, 0, 255).to(torch.uint8)
        h, w = u8.shape[-3], u8.shape[-2]
        if w <= h:
            new_w, new_h = resize, int(round(h * resize / w))
        else:
            new_w, new_h = int(round(w * resize / h)), resize
        out = pil_resample(u8, (new_h, new_w), "bilinear")
        top, left = (new_h - crop) // 2, (new_w - crop) // 2
        out = out[..., top:top + crop, left:left + crop, :]
        return imagenet_normalize(out.to(torch.float32) / 255.0)

    return transform


def cubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 resampling matrix of
    ``jax.image.resize(..., method="cubic")`` along one axis.

    ``jax.image.scale_and_translate``'s formulas: the Keys cubic kernel with
    a = -0.5 (``F.interpolate(mode="bicubic")`` uses a = -0.75), half-pixel
    centres, and when downsampling the kernel widened by 1/scale
    (antialias); each output's weights are normalised to sum to 1, and an
    output whose sample falls outside the input gets none. Computed in
    float32, as JAX computes it.
    """
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))   # antialias: widen when downsampling
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_matrices(h: int, w: int, patch_size: int, device) -> tuple:
    """(rows, columns) :func:`cubic_resize_weights` of an (h, w) window as
    float32 tensors on ``device``, for :func:`resize_patches`."""
    return tuple(torch.from_numpy(cubic_resize_weights(n, patch_size)).to(device)
                 for n in (h, w))


def resize_patches(crops: torch.Tensor, patch_size: int,
                   matrices: tuple | None = None) -> torch.Tensor:
    """(N, w, w, C) crops -> (N, patch_size, patch_size, C).

    A no-op when the crops are patch-sized. Otherwise the cubic antialiased
    resize of the JAX package's ``resize_patches_device``: two float32
    matrix products with :func:`cubic_resize_weights` (rows, then
    columns), and for integer crops a requantisation (round half to even,
    clip to [0, 255]) to the input type. With TF32 matmuls enabled the
    products lose precision; run with TF32 off for parity.

    ``matrices``: the crops' :func:`resize_matrices`, built once by a
    caller that resizes many chunks; built here when None.
    """
    n, h, w, _ = crops.shape
    if h == patch_size and w == patch_size:
        return crops
    wy, wx = matrices or resize_matrices(h, w, patch_size, crops.device)
    out = torch.einsum("nhwc,hp->npwc", crops.float(), wy)
    out = torch.einsum("npwc,wq->npqc", out, wx)
    if not crops.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255).to(crops.dtype)
    return out


def linear_taps(in_size: int, out_size: int, scale: float, translation):
    """Sparse taps of ``jax.image.scale_and_translate(method="linear",
    antialias=True)`` along one axis: ``(indices, weights)``, each
    ``(..., out_size, T)``, int64 and float64, one set per translation
    (``translation`` a scalar or an array, in output pixels).

    Input coordinate u maps to ``scale * u + translation``. Each output
    pixel's sample position is ``(o + 1/2) / scale - translation / scale -
    1/2``; its weights are the triangle ``max(0, 1 - |sample - i| / k)``
    over the input pixels i, with ``k = max(1/scale, 1)`` (widened when
    downsampling), normalised to sum to 1 over the pixels inside the input,
    and zero where the sample falls outside the input. These are the
    formulas of the float64 oracle that the JAX package's tests hold its
    resample against, evaluated in float64; only the pixels the triangle
    reaches are kept (``T = ceil(2k) + 1`` taps, zero-weight taps point at
    pixel 0).
    """
    inv = 1.0 / float(scale)
    ks = max(inv, 1.0)
    tr = np.asarray(translation, np.float64)[..., None]
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv - tr * inv - 0.5
    n_taps = int(np.ceil(2 * ks)) + 1
    idx = np.floor(sample - ks)[..., None].astype(np.int64) + 1 + np.arange(n_taps)
    w = np.maximum(0.0, 1.0 - np.abs(sample[..., None] - idx) / ks)
    w = np.where((idx >= 0) & (idx < in_size), w, 0.0)
    total = w.sum(-1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[..., None], w, 0.0)
    return np.where(w > 0, idx, 0), w


def scale_and_translate_linear(images: torch.Tensor, out_hw, scale, translation_y,
                               translation_x: float) -> torch.Tensor:
    """``(B, H, W, C)`` images -> ``(B, oh, ow, C)`` float32: what
    ``jax.image.scale_and_translate(image, (oh, ow, C), (0, 1), scale,
    (ty, tx), method="linear")`` computes for each image (antialiased),
    with the weights of :func:`linear_taps`.

    ``scale``: (sy, sx); ``translation_y``: one ty per image, or one for
    all; ``translation_x``: one tx for all (the images are bands of one
    slide: each starts at its own row, all at the same column). The
    weights are applied as sparse taps, columns first (an ``index_select``
    of the shared column taps), then rows, float32 products accumulated tap
    by tap; integer images are read as they are and become float32 after
    the column gather.
    """
    b, h, w, _ = images.shape
    dev = images.device
    ty = np.broadcast_to(np.asarray(translation_y, np.float64), (b,))
    iy, wy = linear_taps(h, out_hw[0], scale[0], ty)           # (B, oh, Ty)
    ix, wx = linear_taps(w, out_hw[1], scale[1], translation_x)  # (ow, Tx)
    iy, ix = torch.as_tensor(iy, device=dev), torch.as_tensor(ix, device=dev)
    wy = torch.as_tensor(wy, dtype=torch.float32, device=dev)
    wx = torch.as_tensor(wx, dtype=torch.float32, device=dev)
    cols = None
    for t in range(ix.shape[-1]):                             # (B, H, ow, C) per tap
        term = images.index_select(2, ix[:, t]).float() * wx[:, t, None]
        cols = term if cols is None else cols + term
    bidx = torch.arange(b, device=dev)[:, None]
    out = None
    for t in range(iy.shape[-1]):                             # (B, oh, ow, C) per tap
        term = cols[bidx, iy[..., t]] * wy[..., t, None, None]
        out = term if out is None else out + term
    return out


def _spot_pixel_boxes(positions, window: int, hex_coords: bool = True):
    """In-tissue spots -> (oddr_x, oddr_y, x_px, y_px) int arrays.

    Pixel coords are rounded (fractional coords occur rarely) and offset by
    the edge padding of ``window//2``. ``positions`` is a
    :class:`~gridnext_tpu_torch.io.spaceranger.Positions` (any table whose
    ``positions[name]`` gives a column works). ``hex_coords=False`` (Visium
    HD square bins) indexes the grid directly by (array_row, array_col)
    instead of the pseudo-hex -> odd-right map.
    """
    keep = np.asarray(positions["in_tissue"]).astype(int) == 1
    col = np.asarray(positions["array_col"])[keep]
    row = np.asarray(positions["array_row"])[keep]
    if hex_coords:
        x_ind, y_ind = geometry.pseudo_hex_to_oddr(col, row)
    else:
        x_ind, y_ind = col.astype(int), row.astype(int)
    x_px = np.rint(np.asarray(positions["pxl_col_in_fullres"])[keep]
                   .astype(float)).astype(int) + window // 2
    y_px = np.rint(np.asarray(positions["pxl_row_in_fullres"])[keep]
                   .astype(float)).astype(int) + window // 2
    return np.asarray(x_ind), np.asarray(y_ind), x_px, y_px


def spot_pixel_arrays(positions, h_st: int = geometry.VISIUM_H_ST,
                      w_st: int = geometry.VISIUM_W_ST, hex_coords: bool = True,
                      warn: bool = False):
    """Positions -> (oddr_y, oddr_x, y_px, x_px) arrays over in-tissue spots
    inside the lattice (pixel coords not yet offset for padding).
    ``hex_coords=False`` (Visium HD square bins) indexes the grid directly
    by (array_row, array_col). ``warn`` prints the JAX package's one line
    (``grid_from_wsi_visium``) about the spots dropped outside the lattice,
    in the positions file's (array_col, array_row)."""
    ox, oy, x_px, y_px = _spot_pixel_boxes(positions, window=0, hex_coords=hex_coords)
    # lower bounds too: a malformed-parity spot's odd-right x of -1 must not
    # land on the last grid column
    keep = (oy >= 0) & (ox >= 0) & (oy < h_st) & (ox < w_st)
    if warn and not keep.all():
        bx, by = ox[~keep], oy[~keep]
        ac, ar = geometry.oddr_to_pseudo_hex(bx, by) if hex_coords else (bx, by)
        first = list(zip(np.atleast_1d(ac)[:5].tolist(), np.atleast_1d(ar)[:5].tolist()))
        print(f"Warning: {int((~keep).sum())} spots outside the {h_st}x{w_st} grid dropped "
              f"(first (array_col, array_row): {first})")
    return (oy[keep], ox[keep],
            y_px[keep].astype(np.int32), x_px[keep].astype(np.int32))


def edge_pad(wsi: torch.Tensor, pad: int) -> torch.Tensor:
    """(H, W, C) -> (H + 2 pad, W + 2 pad, C), repeating the edge pixels
    (``np.pad(mode="edge")``), on the slide's device."""
    h, w = wsi.shape[:2]
    rows = torch.arange(-pad, h + pad, device=wsi.device).clamp_(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=wsi.device).clamp_(0, w - 1)
    return wsi.index_select(0, rows).index_select(1, cols)


def crop_grid(wsi: torch.Tensor, oy, ox, y0, x0, window: int, patch_size: int,
              h_st: int, w_st: int, *, dtype=torch.float32, pil_filter: Optional[str] = None,
              timer=None) -> torch.Tensor:
    """(h_st, w_st, P, P, 3) grid on the slide's device: the ``window`` crop
    at each corner (y0, x0) of the (H, W, 3) uint8 slide
    (:func:`~gridnext_tpu_torch.ops.patch_gather_cuda.gather_patches`),
    resized to ``patch_size`` where they differ, at its cell (oy, ox),
    zeros elsewhere.

    ``dtype`` float32 (the trainers' and registrars' grids): ``/255``.
    ``dtype`` uint8 (the patch caches): the pixels as they are. The resize
    is :func:`resize_patches` (the JAX package's cubic, requantised to
    uint8), or with ``pil_filter`` Pillow's (:func:`pil_resample`).
    ``timer`` times ``"crop"``, ``"resample"`` and ``"grid"``.
    """
    dev = wsi.device
    with stage(timer, "crop", dev):
        crops = gather_patches(wsi, torch.as_tensor(y0, device=dev),
                               torch.as_tensor(x0, device=dev), window)
    if window != patch_size:
        with stage(timer, "resample", dev):
            if pil_filter is None:
                mats = resize_matrices(window, window, patch_size, dev)
                parts = (resize_patches(part, patch_size, mats)
                         for part in torch.split(crops, _RESIZE_CHUNK))
            else:
                parts = (pil_resample(part, (patch_size, patch_size), pil_filter)
                         for part in torch.split(crops, _RESIZE_CHUNK))
            crops = torch.cat(list(parts))
    with stage(timer, "grid", dev):
        grid = torch.zeros((h_st, w_st, patch_size, patch_size, 3), dtype=dtype, device=dev)
        grid[torch.as_tensor(oy, device=dev, dtype=torch.int64),
             torch.as_tensor(ox, device=dev, dtype=torch.int64)] = \
            crops if dtype == torch.uint8 else crops.float() / 255.0
    return grid


def patch_grid(wsi: torch.Tensor, positions, patch_size: int, window_size=None,
               h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST,
               hex_coords: bool = True) -> torch.Tensor:
    """The ``(h_st, w_st, P, P, 3)`` float32 patch grid of one array on the
    slide's device: the JAX package's ``grid_from_wsi_visium`` (``/255``)
    for an (H, W, 3) uint8 slide tensor.

    The slide is edge-padded by ``window // 2`` (``window_size``, default
    ``patch_size``) and each in-tissue spot inside the lattice cropped
    from its rounded center, so a spot near the border reads repeated edge
    pixels (a clamped corner would read other pixels), then resized to
    ``patch_size`` where the window differs. ``hex_coords=False`` (Visium
    HD square bins) indexes the grid by (array_row, array_col).
    """
    w = window_size or patch_size
    oy, ox, y_px, x_px = spot_pixel_arrays(positions, h_st, w_st, hex_coords)
    # padded by w // 2, the slide's window around a center starts at it
    return crop_grid(edge_pad(wsi, w // 2), oy, ox, y_px, x_px, w, patch_size, h_st, w_st)


def patch_cache_suffix(patch_size_px: Optional[int] = None,
                       patch_size_um: Optional[float] = None,
                       window_size_px: Optional[int] = None,
                       hd_binning: Optional[str] = None,
                       hd_dims: Optional[tuple] = None) -> str:
    """The patch-cache directory suffix, shared by the dataset factory and
    ``prepare --images`` (a mismatch orphans a prepared cache):
    ``_patches{px}px`` or ``_patches{um}um``, ``_w{px}`` for a resized
    window, and for Visium HD ``_{binning}_{h}x{w}`` in front (the writer
    drops spots outside the lattice, so a cache is dims-specific). The JAX
    package's ``pipeline.patch_cache_suffix``."""
    s = (f"_patches{patch_size_px}px" if patch_size_px is not None
         else f"_patches{int(patch_size_um)}um")
    if window_size_px is not None:
        s += f"_w{window_size_px}"
    if hd_binning is not None:
        if hd_dims is None:
            raise ValueError("HD patch caches are dims-specific: "
                             "patch_cache_suffix needs hd_dims with "
                             "hd_binning")
        s = f"_{hd_binning}_{hd_dims[0]}x{hd_dims[1]}{s}"
    return s


def save_visium_patches(img_file, spaceranger_dir, dest_dir, patch_size: int = 256,
                        window_size=None, hd_binning: Optional[str] = None,
                        h_st: Optional[int] = None, w_st: Optional[int] = None, *,
                        device="cuda", timer=None) -> int:
    """Write one array's JPEG patch cache: ``{array}_{col}_{row}.jpg`` under
    ``dest_dir``, one file a spot whose patch has a nonzero pixel, byte-equal
    to the JAX package's ``save_visium_patches``. Returns the file count.

    The slide decodes on the host (:func:`gridnext_tpu_torch.ingest.decode_slide`)
    and moves to ``device``, where it is edge-padded by ``window // 2``
    (``window_size``: pixels, a float share of the slide's width, or None
    for ``patch_size``), every in-tissue spot inside the lattice is cropped
    from its rounded centre in one gather launch and, where the window
    differs from ``patch_size``, resampled by Pillow's bicubic
    (:func:`pil_resample`) -- all uint8 (:func:`crop_grid`). Spots outside
    the lattice are dropped with the JAX package's warning. File names carry
    pseudo-hex (array_col, array_row), or the direct coordinates for Visium
    HD (``hd_binning``; the lattice defaults to the array's
    ``hd_lattice_dims``). The patches are encoded on the host's cores at
    quality 75 (:func:`~gridnext_tpu_torch.io.jpeg.encode_jpeg_batch`) into
    a temporary directory renamed to ``dest_dir`` at the end, so an
    interrupted run leaves no partial cache (an existing ``dest_dir`` is
    replaced). ``timer`` times ``"decode"``, ``"crop"``, ``"resample"``,
    ``"grid"`` and ``"encode"``.
    """
    from gridnext_tpu_torch import ingest
    from gridnext_tpu_torch.io.jpeg import encode_jpeg_batch
    from gridnext_tpu_torch.io.spaceranger import hd_lattice_dims, read_positions

    if hd_binning is not None and (h_st is None or w_st is None):
        dims = hd_lattice_dims(spaceranger_dir, hd_binning)
        h_st = dims[0] if h_st is None else h_st
        w_st = dims[1] if w_st is None else w_st
    h_st = geometry.VISIUM_H_ST if h_st is None else int(h_st)
    w_st = geometry.VISIUM_W_ST if w_st is None else int(w_st)
    dev = torch.device(device)
    with stage(timer, "decode"):
        wsi = ingest.decode_slide(img_file)
    if window_size is None:
        window = patch_size
    elif isinstance(window_size, float):
        window = int(window_size * wsi.shape[1])
    elif isinstance(window_size, int):
        window = window_size
    else:
        raise ValueError("Window size must be a float or int")
    hex_coords = hd_binning is None
    oy, ox, y_px, x_px = spot_pixel_arrays(read_positions(spaceranger_dir, hd_binning), h_st,
                                           w_st, hex_coords, warn=True)
    slide = torch.from_numpy(np.require(wsi, requirements="W")).to(dev)
    del wsi
    # padded by window // 2, the slide's window around a centre starts at it
    grid = crop_grid(edge_pad(slide, window // 2), oy, ox, y_px, x_px, window, patch_size,
                     h_st, w_st, dtype=torch.uint8, pil_filter="bicubic", timer=timer)
    del slide
    with stage(timer, "encode"):
        fg = (grid.reshape(h_st, w_st, -1).amax(-1) > 0).nonzero().cpu().numpy()
        patches = grid[torch.as_tensor(fg[:, 0], device=dev),
                       torch.as_tensor(fg[:, 1], device=dev)].cpu().numpy()
        del grid
        fy, fx = fg[:, 0], fg[:, 1]
        cols, rows = geometry.oddr_to_pseudo_hex(fx, fy) if hex_coords else (fx, fy)
        name = str(Path(spaceranger_dir).stem)
        tmp_dir = f"{dest_dir}.tmp-{os.getpid()}"
        os.makedirs(tmp_dir, exist_ok=True)
        encode_jpeg_batch(patches, [os.path.join(tmp_dir, f"{name}_{int(c)}_{int(r)}.jpg")
                                    for c, r in zip(np.atleast_1d(cols), np.atleast_1d(rows))],
                          quality=75)
        if os.path.isdir(str(dest_dir)):   # the caller asked to (re)write this cache
            import shutil

            shutil.rmtree(str(dest_dir))
        os.replace(tmp_dir, str(dest_dir))
    return len(fg)


def save_visium_patches_all(wsi_files, spaceranger_dirs, dest_dir, patch_size: int = 256,
                            window_size=None, *, device="cuda"):
    """:func:`save_visium_patches` of several arrays, each into
    ``dest_dir/<image stem>`` (the JAX package's ``save_visium_patches_all``)."""
    os.makedirs(dest_dir, exist_ok=True)
    for img_file, srd in zip(wsi_files, spaceranger_dirs):
        print(f"{img_file} : {srd} ...")
        save_visium_patches(img_file, srd, os.path.join(str(dest_dir), str(Path(img_file).stem)),
                            patch_size, window_size, device=device)


def remove_color_cast(img: np.ndarray) -> np.ndarray:
    """SpaCell colour-cast removal: scale each RGB channel so its 99th
    percentile maps to white, truncating as PIL's ``Image.point`` does.
    (H, W, >=3) uint8 in, uint8 out; channels past RGB (e.g. PNG alpha)
    pass through untouched. Raises ValueError on any other shape (a 2-D
    image would otherwise treat its first three columns as channels).
    The JAX package's ``pipeline.remove_color_cast``, in numpy on the host."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[-1] < 3:
        raise ValueError(f"expected an (H, W, >=3) RGB image; got shape "
                         f"{img.shape}")
    out = img.copy()
    for c in range(3):
        p = np.percentile(img[..., c].ravel(), q=99)
        out[..., c] = np.minimum(img[..., c].astype(np.float64) * (255.0 / p),
                                 255).astype(np.uint8)
    return out


def _dihedral(patches: torch.Tensor, transpose, flip_r, flip_c) -> torch.Tensor:
    """Per-patch (transpose?, flip rows?, flip columns?) of ``(..., P, P, C)``
    patches, the bits broadcast over the leading axes, applied in that
    order."""
    def bit(b):
        return torch.as_tensor(b, device=patches.device)[(...,) + (None,) * 3]

    out = torch.where(bit(transpose), patches.transpose(-2, -3), patches)
    out = torch.where(bit(flip_r), out.flip(-3), out)
    return torch.where(bit(flip_c), out.flip(-2), out)


def dihedral_transform(patches: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k``-th (0..7) dihedral transform of ``(..., P, P, C)`` patches:
    bit 0 transposes, bit 1 flips the rows, bit 2 the columns (the JAX
    package's convention)."""
    if not 0 <= k < 8:
        raise ValueError(f"dihedral k must be in 0..7; got {k}")
    if patches.dim() < 3 or patches.shape[-2] != patches.shape[-3]:
        raise ValueError("dihedral_transform wants (..., P, P, C) square "
                         f"patches; got shape {tuple(patches.shape)}")
    return _dihedral(patches, bool(k & 1), bool(k & 2), bool(k & 4))


def augment_patches(generator: torch.Generator, patches: torch.Tensor, *,
                    flips: bool = True, rotations: bool = True,
                    brightness: float = 0.0, contrast: float = 0.0) -> torch.Tensor:
    """Random augmentation of ``(..., P, P, C)`` float patches on their
    device: each patch draws one of the 8 dihedral transforms (flips and
    rotations; the 4 rotations alone or the 4 flips alone when one is
    off) from ``generator`` (a generator on the patches' device), and
    optionally a brightness shift ``u * brightness`` and a contrast scale
    ``1 + u * contrast`` around the patch mean, u ~ U[-1, 1]. The JAX
    package's ``augment_patches``; torch draws other bits than JAX. On a
    mesh a rank draws its rows of the global batch's draws
    (:func:`~gridnext_tpu_torch.parallel.collectives.draw_rows`)."""
    if patches.dim() < 3 or patches.shape[-2] != patches.shape[-3]:
        raise ValueError("augment_patches wants (..., P, P, C) square "
                         f"patches; got shape {tuple(patches.shape)}")
    lead = tuple(patches.shape[:-3])
    dev = patches.device

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    def coin():
        return draw_rows(rand, lead) < 0.5

    zeros = torch.zeros(lead, dtype=torch.bool, device=dev)
    transpose = flip_r = flip_c = zeros
    if flips and rotations:
        transpose, flip_r, flip_c = coin(), coin(), coin()
    elif flips:
        flip_r, flip_c = coin(), coin()
    elif rotations:
        k90 = draw_rows(lambda shape: torch.randint(0, 4, shape, generator=generator,
                                                    device=dev), lead)
        transpose, flip_r, flip_c = k90 % 2 == 1, k90 >= 2, (k90 == 1) | (k90 == 2)
    out = _dihedral(patches, transpose, flip_r, flip_c)

    def expand(v):
        return v[(...,) + (None,) * 3].to(out.dtype)

    if brightness:
        u = draw_rows(rand, lead) * 2 - 1
        out = out + expand(u * brightness)
    if contrast:
        u = draw_rows(rand, lead) * 2 - 1
        mean = out.mean(dim=(-1, -2, -3), keepdim=True)
        out = (out - mean) * expand(1.0 + u * contrast) + mean
    return out


def make_train_augment(brightness: float = 0.0, contrast: float = 0.0):
    """The trainers' augmentation hook ``fn(generator, x)``: a bare patch
    batch augments whole; a multimodal ``(image, counts)`` pair augments
    its image only (``--augment``)."""
    def augment(generator, x):
        if isinstance(x, (tuple, list)):
            return type(x)((augment_patches(generator, x[0], brightness=brightness,
                                            contrast=contrast),) + tuple(x[1:]))
        return augment_patches(generator, x, brightness=brightness, contrast=contrast)

    return augment
