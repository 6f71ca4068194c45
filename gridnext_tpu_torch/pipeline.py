"""Patch preprocessing: ImageNet normalization, the window resize, the
lattice resample, spot pixel boxes and the patch grids of whole slides.

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
:func:`distance_um_to_px` converts a distance on the tissue to pixels of
an array's fullres image (the patch size of ``patch_size_um``).
"""

from __future__ import annotations

import numpy as np
import torch

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.ops.patch_gather_cuda import gather_patches

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
                      w_st: int = geometry.VISIUM_W_ST, hex_coords: bool = True):
    """Positions -> (oddr_y, oddr_x, y_px, x_px) arrays over in-tissue spots
    inside the lattice (pixel coords not yet offset for padding).
    ``hex_coords=False`` (Visium HD square bins) indexes the grid directly
    by (array_row, array_col)."""
    ox, oy, x_px, y_px = _spot_pixel_boxes(positions, window=0, hex_coords=hex_coords)
    # lower bounds too: a malformed-parity spot's odd-right x of -1 must not
    # land on the last grid column
    keep = (oy >= 0) & (ox >= 0) & (oy < h_st) & (ox < w_st)
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
              h_st: int, w_st: int) -> torch.Tensor:
    """(h_st, w_st, P, P, 3) float32 grid on the slide's device: the
    ``window`` crop at each corner (y0, x0) of the (H, W, 3) uint8 slide
    (:func:`~gridnext_tpu_torch.ops.patch_gather_cuda.gather_patches`),
    resized to ``patch_size`` where they differ (:func:`resize_patches`,
    requantised to uint8), ``/255`` at its cell (oy, ox), zeros elsewhere.
    """
    dev = wsi.device
    crops = gather_patches(wsi, torch.as_tensor(y0, device=dev),
                           torch.as_tensor(x0, device=dev), window)
    if window != patch_size:
        mats = resize_matrices(window, window, patch_size, dev)
        crops = torch.cat([resize_patches(part, patch_size, mats)
                           for part in torch.split(crops, _RESIZE_CHUNK)])
    grid = torch.zeros((h_st, w_st, patch_size, patch_size, 3), dtype=torch.float32,
                       device=dev)
    grid[torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)] = \
        crops.float() / 255.0
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
    package's ``augment_patches``; torch draws other bits than JAX."""
    if patches.dim() < 3 or patches.shape[-2] != patches.shape[-3]:
        raise ValueError("augment_patches wants (..., P, P, C) square "
                         f"patches; got shape {tuple(patches.shape)}")
    lead = tuple(patches.shape[:-3])
    dev = patches.device

    def coin():
        return torch.rand(lead, generator=generator, device=dev) < 0.5

    zeros = torch.zeros(lead, dtype=torch.bool, device=dev)
    transpose = flip_r = flip_c = zeros
    if flips and rotations:
        transpose, flip_r, flip_c = coin(), coin(), coin()
    elif flips:
        flip_r, flip_c = coin(), coin()
    elif rotations:
        k90 = torch.randint(0, 4, lead, generator=generator, device=dev)
        transpose, flip_r, flip_c = k90 % 2 == 1, k90 >= 2, (k90 == 1) | (k90 == 2)
    out = _dihedral(patches, transpose, flip_r, flip_c)

    def expand(v):
        return v[(...,) + (None,) * 3].to(out.dtype)

    if brightness:
        u = torch.rand(lead, generator=generator, device=dev) * 2 - 1
        out = out + expand(u * brightness)
    if contrast:
        u = torch.rand(lead, generator=generator, device=dev) * 2 - 1
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
