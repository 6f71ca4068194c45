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

Pillow converts ``LAB`` through LittleCMS (an optimised 3-D lookup table),
which the port does not reproduce: the readers refuse Lab.
"""

from __future__ import annotations

import numpy as np

# raw mode -> the mode Pillow unpacks it into
RAW_MODES = {
    "1": "1", "1;I": "1", "L;2": "L", "L;2I": "L", "L;4": "L", "L;4I": "L", "L": "L",
    "L;I": "L", "LA": "LA", "P": "P", "PA": "PA", "PX": "P", "I;12": "I;16", "I;16": "I;16",
    "I;16B": "I;16B", "I;16S": "I", "I;32": "I", "F;32F": "F", "RGB": "RGB", "RGBX": "RGB",
    "RGBA": "RGBA", "RGBa": "RGBA", "RGB;16": "RGB", "RGBX;16": "RGB", "RGBA;16": "RGBA",
    "RGBa;16": "RGBA", "LA;16": "RGBA", "CMYK": "CMYK", "CMYK;16": "CMYK", "CMYK;I": "CMYK",
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


def to_rgb(mode: str, pixels: np.ndarray, palette=None) -> np.ndarray:
    """Pillow's ``Image.convert("RGB")`` of a ``mode`` image: ``(H, W, 3)``
    uint8, C-contiguous. ``palette`` ((n, 3) uint8) for ``P`` and ``PA``."""
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
    elif mode == "CMYK":                         # Convert.c cmyk2rgb
        p = pixels.astype(np.int32)
        nk = 255 - p[..., 3:]
        return np.clip(nk - _muldiv255(p[..., :3], nk), 0, 255).astype(np.uint8)
    else:
        raise ValueError(f"no RGB conversion of Pillow mode {mode!r} here")
    return np.repeat(np.asarray(gray, np.uint8)[..., None], 3, axis=-1)
