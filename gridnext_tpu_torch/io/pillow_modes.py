"""Pillow's pixel modes and its ``convert("RGB")``, in one place.

The JAX package reads a slide with ``np.asarray(Image.open(f).convert("RGB"))``.
Pillow first unpacks the file's samples into one of its modes (a *raw mode*
names the unpacking: bit depth, byte order, inversion, premultiplied
alpha), then converts that mode to RGB. The port's readers (``io/jpeg.py``,
``io/tiff.py``, ``io/png.py``) decode a file to its samples and call
:func:`unpack` with the raw mode Pillow would use; ``ingest.decode_slide``
then calls :func:`to_rgb` once. Both follow Pillow 12 (``Unpack.c``,
``Convert.c``), checked against it on seeded arrays of every value.

The edge cases that decide bits:

- 16-bit samples of an RGB, RGBA or CMYK image keep their high byte
  (``v >> 8``: ``RGB;16``, ``RGBA;16``, ``CMYK;16``, ``LA;16``), but a
  16-bit gray image is mode ``I;16``, whose conversion *clips*
  (``min(v, 255)``), and a signed one (``I;16S``) is mode ``I``, clipped to
  0..255;
- ``F`` (32-bit float) truncates toward zero after clipping to 0..255
  (``0.99 -> 0``, ``254.9 -> 254``); NaN gives 0;
- ``1`` converts to 0 or 255; MinIsWhite (``1;I``, ``L;I``, ``L;2I``, ``L;4I``)
  inverts, and 2- and 4-bit gray scale by 85 and 17;
- ``RGBa`` (associated alpha) is divided out, ``c * 255 // a`` clipped, 0
  where a = 0;
- CMYK converts as ``255 - k - (c * (255 - k) + 128) * 257 >> 16``
  (``MULDIV255``), clipped; a JPEG's CMYK is inverted first (``CMYK;I``,
  Adobe's convention, which Pillow assumes for every CMYK JPEG);
- a palette index past the palette gives black; ``LA``, ``RGBA`` and
  ``PA`` drop their alpha.

- ``LAB``'s array holds L and then a* and b* as two's-complement bytes
  (TIFF's samples; Pillow keeps them offset by 128 inside and packs them
  back); it converts through LittleCMS's Lab -> sRGB transform, a 33^3
  table of 16-bit nodes interpolated tetrahedrally, which
  :func:`lab_table` and :func:`lab_to_rgb` reproduce node for node.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

# raw mode -> the mode Pillow unpacks it into
RAW_MODES = {
    "1": "1", "1;I": "1", "L;2": "L", "L;2I": "L", "L;4": "L", "L;4I": "L", "L": "L",
    "L;I": "L", "LA": "LA", "P": "P", "PA": "PA", "PX": "P", "I;12": "I;16", "I;16": "I;16",
    "I;16B": "I;16B", "I;16S": "I", "I;32": "I", "F;32F": "F", "RGB": "RGB", "RGBX": "RGB",
    "RGBA": "RGBA", "RGBa": "RGBA", "RGB;16": "RGB", "RGBX;16": "RGB", "RGBA;16": "RGBA",
    "RGBa;16": "RGBA", "LA;16": "RGBA", "CMYK": "CMYK", "CMYK;16": "CMYK", "CMYK;I": "CMYK",
    "LAB": "LAB",
}


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpacking: each colour ``c * 255 // a``, clipped to
    255; 0 where ``a`` is 0."""
    a = rgba[..., 3:].astype(np.uint32)
    rgb = np.minimum(rgba[..., :3] * np.uint32(255) // np.maximum(a, 1), 255)
    out = rgba.copy()
    out[..., :3] = np.where(a == 0, 0, rgb)
    return out


def unpack(rawmode: str, samples: np.ndarray) -> tuple:
    """``(mode, pixels)`` Pillow unpacks ``samples`` into under ``rawmode``.

    ``samples`` holds the decoded sample values, one array element a
    sample, in the dtype of the bit depth: ``(H, W)`` or ``(H, W, c)``
    uint8 for 1 to 8 bits (a 1-, 2- or 4-bit sample as its value), uint16
    for 12 and 16 (in native order: the reader swaps), int16 for ``I;16S``, int32
    for ``I;32``,
    float32 for ``F;32F``. ``pixels`` is the array ``np.asarray`` gives of
    the image: bool for ``1``; uint8 for ``L``, ``LA``, ``P``, ``PA``,
    ``RGB``, ``RGBA`` and ``CMYK``; uint16 for ``I;16`` / ``I;16B``; int32
    for ``I``; float32 for ``F``."""
    if rawmode not in RAW_MODES:
        raise ValueError(f"raw mode {rawmode!r} has no unpacking here")
    mode = RAW_MODES[rawmode]
    base, _, flags = rawmode.partition(";")
    if rawmode in ("1", "1;I"):
        return mode, (samples == 0) if rawmode == "1;I" else (samples != 0)
    if base == "L" and flags[:1] in ("2", "4"):
        px = (samples * (85 if flags[0] == "2" else 17)).astype(np.uint8)
        return mode, (255 - px if flags.endswith("I") else px)
    if rawmode == "L;I":
        return mode, 255 - samples
    if rawmode in ("I;12", "I;16", "I;16B"):
        return mode, samples.astype(np.uint16)
    if rawmode in ("I;16S", "I;32"):
        return mode, samples.astype(np.int32)
    if rawmode == "F;32F":
        return mode, samples.astype(np.float32)
    if flags == "16":                     # 16-bit colour samples: the high byte
        samples = (samples >> 8).astype(np.uint8)
        if base == "LA":                  # Pillow reads 16-bit gray + alpha as RGBA
            return mode, np.ascontiguousarray(samples[..., [0, 0, 0, 1]])
    if base == "RGBX":
        return mode, np.ascontiguousarray(samples[..., :3])
    if base == "RGBa":
        return mode, _unpremultiply(samples)
    if rawmode == "PX":
        return mode, np.ascontiguousarray(samples[..., 0])
    if rawmode == "CMYK;I":
        return mode, 255 - samples
    return mode, samples


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tmp = a * b + 128
    return ((tmp >> 8) + tmp) >> 8


def to_rgb(mode: str, pixels: np.ndarray, palette=None, n_threads: int = 0) -> np.ndarray:
    """Pillow's ``Image.convert("RGB")`` of a ``mode`` image: ``(H, W, 3)``
    uint8, C-contiguous. ``palette`` ((n, 3) uint8) for ``P`` and ``PA``;
    ``n_threads`` for ``LAB`` (0: all cores)."""
    if mode == "RGB":
        return np.ascontiguousarray(pixels, np.uint8)
    if mode in ("RGBA", "RGBX"):
        return np.ascontiguousarray(pixels[..., :3])
    if mode in ("LA", "PA"):
        return to_rgb(mode[0], pixels[..., 0], palette)
    if mode in ("P",):
        lut = np.zeros((256, 3), np.uint8)       # an index past the palette: black
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
        return lut[pixels]
    if mode == "1":
        gray = np.where(pixels, 255, 0)
    elif mode == "L":
        gray = pixels
    elif mode in ("I;16", "I;16B"):
        gray = np.minimum(pixels, 255).astype(np.uint8)
    elif mode == "I":
        gray = np.clip(pixels, 0, 255).astype(np.uint8)
    elif mode == "F":                            # Convert.c f2l, NaN to 0
        f = np.nan_to_num(pixels.astype(np.float32), nan=0.0, posinf=255.0, neginf=0.0)
        gray = np.clip(f, 0, 255).astype(np.uint8)
    elif mode == "LAB":
        return lab_to_rgb(pixels, n_threads)
    elif mode == "CMYK":                         # Convert.c cmyk2rgb
        p = pixels.astype(np.int32)
        nk = 255 - p[..., 3:]
        return np.clip(nk - _muldiv255(p[..., :3], nk), 0, 255).astype(np.uint8)
    else:
        raise ValueError(f"no RGB conversion of Pillow mode {mode!r} here")
    return np.repeat(np.asarray(gray, np.uint8)[..., None], 3, axis=-1)


# ---- LAB: LittleCMS's Lab -> sRGB transform -----------------------------------
#
# Pillow converts LAB with ImageCms.buildTransform(createProfile("LAB"),
# createProfile("sRGB"), "LAB", "RGB"): LittleCMS 2 links the Lab (D50, V2)
# profile to the sRGB matrix-shaper (Lab -> XYZ, the inverse of sRGB's
# D50-adapted colorant matrix, the inverse sRGB curve) and, for 8-bit data,
# resamples that float32 pipeline into a 33 x 33 x 33 table of 16-bit nodes
# (cmsopt.c OptimizeByResampling; the white point falls between nodes, so no
# node is patched), evaluated by tetrahedral interpolation in 16.16 fixed
# point. lab_table() recomputes the nodes; csrc/raster_codec.cpp's
# lab_to_rgb interpolates. tools/check_lab_conversion.py holds the result to
# Pillow on all 2^24 inputs.

LAB_GRID = 33
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0          # XYZ's 1.15 fixed-point range


def _inverse3(a):
    """lcms's _cmsMAT3inverse, term for term."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _times(a, b):
    """a @ b (3 x 3 by 3 x 3, or by a 3-vector), summed as lcms sums."""
    if not isinstance(b[0], list):
        return [a[i][0] * b[0] + a[i][1] * b[1] + a[i][2] * b[2] for i in range(3)]
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _srgb_to_xyz() -> list:
    """cmsCreate_sRGBProfile's colorant matrix: Rec. 709 primaries and the
    D65 white, Bradford-adapted to D50 (_cmsBuildRGB2XYZtransferMatrix)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _times(_inverse3([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg,
                                                            1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1 - xr - yr), coef[1] * (1 - xg - yg), coef[2] * (1 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                [0.0389, -0.0685, 1.0296]]
    src = _times(bradford, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _times(bradford, list(_D50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0],
            [0.0, 0.0, dst[2] / src[2]]]
    return _times(_times(_inverse3(bradford), _times(cone, bradford)), m)


def _lab_pipeline(x: np.ndarray) -> np.ndarray:
    """The linked pipeline on float32 inputs in [0, 1] (L, a, b in V4
    encoding): double arithmetic inside each stage, float32 between them,
    as cmsPipelineEvalFloat runs it."""
    f32 = lambda v: v.astype(np.float32).astype(np.float64)        # noqa: E731
    x = x.astype(np.float64)
    y = (x[..., 0] * 100.0 + 16.0) / 116.0
    t = np.stack([y + 0.002 * (x[..., 1] * 255.0 - 128.0), y,
                  y - 0.005 * (x[..., 2] * 255.0 - 128.0)], -1)
    xyz = f32(np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)
              * np.asarray(_D50) / _MAX_XYZ)
    inv = np.asarray(_inverse3(_srgb_to_xyz())) * _MAX_XYZ
    rgb = f32(xyz[..., 0:1] * inv[:, 0] + xyz[..., 1:2] * inv[:, 1]
              + xyz[..., 2:3] * inv[:, 2])
    # the inverse of sRGB's parametric curve (lcms type -4)
    g, a, b, c, d = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045
    with np.errstate(invalid="ignore"):
        hi = (np.power(np.maximum(rgb, 0.0), 1.0 / g) - b) / a
    return f32(np.where(rgb >= (a * d + b) ** g, hi, rgb / c))


@functools.lru_cache(maxsize=1)
def lab_table() -> np.ndarray:
    """The 33^3 x 3 uint16 nodes (L, a, b order, C-contiguous) of
    LittleCMS's resampled Lab -> sRGB transform: node i at input
    round(i * 65535 / 32), the pipeline's output saturated to 16 bits as
    _cmsQuickSaturateWord does (+0.5, its 16.16 floor)."""
    q = np.floor(np.arange(LAB_GRID) * 65535.0 / (LAB_GRID - 1) + 0.5)
    grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1)
    out = _lab_pipeline((grid / 65535.0).astype(np.float32)) * 65535.0 + 0.5
    fixed = np.round((out - 32767.0) * 65536.0)          # the 2^36 "magic" add
    words = np.floor(fixed / 65536.0) + 32767
    return np.ascontiguousarray(np.where(out <= 0, 0, np.where(out >= 65535.0, 65535, words)),
                                np.uint16)


def lab_to_rgb(pixels: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of ``LAB`` pixels ((H, W, 3) uint8 as
    ``np.asarray`` gives them: L, then a* and b* as two's-complement
    bytes), by csrc/raster_codec.cpp on ``n_threads`` threads."""
    from gridnext_tpu_torch.io import tiff

    px = np.ascontiguousarray(pixels, np.uint8)
    out = np.empty(px.shape[:-1] + (3,), np.uint8)
    err = ctypes.create_string_buffer(256)
    if tiff._lib().lab_to_rgb(px.ctypes.data, px.size // 3, lab_table().ctypes.data,
                              out.ctypes.data, int(n_threads), err, 256):
        raise ValueError(f"Lab conversion: {err.value.decode()}")
    return out
