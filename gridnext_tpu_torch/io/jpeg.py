"""JPEG on the host without libjpeg or PIL (``csrc/jpeg_codec.cpp``).

The JAX package reads and writes JPEG through libjpeg: Pillow's
``Image.save(..., "JPEG")`` writes its patch caches and simulated slides,
and ``native/patchio.cpp`` decodes the caches. The card's machine has
neither, so the port carries a codec of its own, held to Pillow bit for
bit: :func:`encode_jpeg` writes Pillow's bytes at a quality (4:2:0, the
standard tables, a JFIF header) and :func:`decode_jpeg` gives the pixels
``np.asarray(Image.open(path))`` gives for baseline, extended sequential
and progressive files, Huffman- or arithmetic-coded (SOF0-2, SOF9-10, DAC
conditioning), and for lossless files (SOF3, predictors 1-7, point
transforms): 1, 3 or 4 components (gray, YCbCr or RGB, CMYK or YCCK), any
integral chroma sampling of 1 to 4 per axis, restart markers, libjpeg-turbo's
block smoothing of progressive files whose scans leave low coefficients
unrefined. A 4-component file gives Pillow's
``CMYK`` array: Pillow reads every CMYK JPEG as Adobe writes it, inverted
(its ``CMYK;I`` raw mode), and so does :func:`read_jpeg`. A data segment
that ends early at a marker decodes as libjpeg decodes it (zeros for the
rest of the restart interval; an arithmetic decoder reads zero bytes), and
a corrupt one through the same arithmetic as Pillow's SIMD inverse DCT.
What Pillow refuses raises ``ValueError`` naming the file and what it
holds: 12-bit, arithmetic lossless (SOF11), hierarchical (SOF5-7, SOF13-15),
lossless with a colour transform, and a file that ends inside its data.

The library builds at first use with the host C++ compiler
(:mod:`gridnext_tpu_torch.ops._host`); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from gridnext_tpu_torch.io import pillow_modes

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = (
    # data, size, info[5], err, errlen
    ("jpeg_probe", (_VP, _LL, _VP, ctypes.c_char_p, _I), _I),
    # data, size, out, out_size, n_threads, err, errlen
    ("jpeg_decode", (_VP, _LL, _VP, _LL, _I, ctypes.c_char_p, _I), _I),
    # paths, n, side, out, n_threads, err, errlen
    ("jpeg_decode_files", (_VP, _LL, _LL, _VP, _I, ctypes.c_char_p, _I), _I),
    # px, h, w, c, quality, n_threads, out**, err, errlen
    ("jpeg_encode", (_VP, _I, _I, _I, _I, _I, _VP, ctypes.c_char_p, _I), _LL),
    ("jpeg_free", (_VP,), None),
    # px, n, h, w, c, paths, quality, n_threads, err, errlen
    ("jpeg_encode_files", (_VP, _LL, _I, _I, _I, _VP, _I, _I, ctypes.c_char_p, _I), _I),
    # tables, tables_len, base, offsets, counts, geom, n, colour, out, W, oc,
    # kind, n_threads, err, errlen
    ("jpeg_decode_segments", (_VP, _LL, _VP, _VP, _VP, _VP, _LL, _I, _VP, _I, _I,
                              ctypes.c_char_p, _I, ctypes.c_char_p, _I), _I),
)
_SOF = {0: "baseline", 1: "extended sequential", 2: "progressive", 3: "lossless",
        9: "arithmetic sequential", 10: "arithmetic progressive"}
_ERRLEN = 1024


def _lib():
    from gridnext_tpu_torch.ops import _host

    return _host.library("jpeg_codec", _SIGNATURES)


def _err():
    return ctypes.create_string_buffer(_ERRLEN)


def _paths(paths):
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(str(p)) for p in paths])
    return arr


def _read(path_or_bytes) -> tuple:
    """(bytes, name for messages) of a path or of the bytes themselves."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return bytes(path_or_bytes), "<bytes>"
    with open(path_or_bytes, "rb") as fh:
        return fh.read(), str(path_or_bytes)


def _probe(data: bytes, name: str) -> np.ndarray:
    info = np.zeros(5, np.int32)
    err = _err()
    if _lib().jpeg_probe(data, len(data), info.ctypes.data, err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return info


def is_jpeg_file(path) -> bool:
    """Whether the file starts as a JPEG does (SOI and a marker)."""
    with open(path, "rb") as fh:
        return fh.read(3) == b"\xff\xd8\xff"


def jpeg_info(path_or_bytes) -> dict:
    """A header probe: ``{"width", "height", "components", "sof"}`` (sof
    ``"baseline"``, ``"extended sequential"``, ``"progressive"``,
    ``"lossless"``, ``"arithmetic sequential"`` or ``"arithmetic
    progressive"``). Raises
    ``ValueError`` on a JPEG the codec does not decode."""
    data, name = _read(path_or_bytes)
    info = _probe(data, name)
    return {"width": int(info[0]), "height": int(info[1]), "components": int(info[2]),
            "sof": _SOF[int(info[3])]}


_MODES = {1: "L", 3: "RGB"}


def read_jpeg(path_or_bytes, n_threads: int = 0) -> tuple:
    """``(mode, pixels)`` of a JPEG file (a path or its bytes), as Pillow
    opens it: ``"L"`` ``(H, W)``, ``"RGB"`` ``(H, W, 3)`` or ``"CMYK"``
    ``(H, W, 4)`` uint8. The inverse DCT and colour conversion run on
    ``n_threads`` threads (0: all cores); the pixels do not depend on the
    count."""
    data, name = _read(path_or_bytes)
    info = _probe(data, name)
    oc = int(info[4])
    shape = (int(info[1]), int(info[0])) + ((oc,) if oc > 1 else ())
    out = np.empty(shape, np.uint8)
    err = _err()
    if _lib().jpeg_decode(data, len(data), out.ctypes.data, out.size, int(n_threads), err,
                          _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    if oc == 4:                 # Pillow reads every CMYK JPEG as Adobe's inverted CMYK
        return pillow_modes.unpack("CMYK;I", out)
    return _MODES[oc], out


def decode_jpeg(path_or_bytes, n_threads: int = 0) -> np.ndarray:
    """Decode a JPEG file (a path or its bytes) to ``(H, W, 3)`` uint8 RGB,
    ``(H, W)`` for a grayscale file or ``(H, W, 4)`` CMYK for a
    4-component one: the pixels Pillow decodes (:func:`read_jpeg`)."""
    return read_jpeg(path_or_bytes, n_threads)[1]


def decode_jpeg_batch(paths: Sequence, side: int, n_threads: int = 0) -> np.ndarray:
    """Decode ``paths`` (each a ``side x side`` RGB JPEG) into one ``(n,
    side, side, 3)`` uint8 array, one file a thread over ``n_threads``
    threads (0: all cores), as the JAX package's ``native/patchio.cpp``
    decodes a patch cache. Raises ``ValueError`` naming the first file that
    fails or has another shape."""
    out = np.empty((len(paths), side, side, 3), np.uint8)
    if not len(paths):
        return out
    err = _err()
    if _lib().jpeg_decode_files(_paths(paths), len(paths), int(side), out.ctypes.data,
                                int(n_threads), err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out


def decode_jpeg_segments(tables: bytes, base: np.ndarray, offsets: np.ndarray,
                         counts: np.ndarray, geom: np.ndarray, out: np.ndarray, colour: int,
                         kind: str, name: str, n_threads: int = 0) -> None:
    """Decode a TIFF's JPEG strips or tiles into ``out`` (``(H, W, oc)``
    uint8), one a thread over ``n_threads`` threads (0: all cores). Segment
    ``i`` is ``base[offsets[i]:offsets[i] + counts[i]]``, an abbreviated
    stream decoded after ``tables`` (the JPEGTables, without their EOI; may
    be empty); its top-left ``geom[i, 2] x geom[i, 3]`` pixels land at
    ``(geom[i, 0], geom[i, 1])``. ``colour`` 1 takes three components as
    stored (Photometric RGB), 0 as YCbCr. Raises ``ValueError`` naming
    ``name`` and the segment."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    geom = np.ascontiguousarray(geom[:, :4], np.int32)
    err = _err()
    if _lib().jpeg_decode_segments(tables, len(tables), base.ctypes.data, offsets.ctypes.data,
                                   counts.ctypes.data, geom.ctypes.data, len(offsets),
                                   int(colour), out.ctypes.data, out.shape[1], out.shape[2],
                                   kind.encode(), int(n_threads), err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")


def _pixels(img) -> np.ndarray:
    if hasattr(img, "detach"):        # a torch tensor, of any device
        img = img.detach().cpu().numpy()
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG pixels must be uint8; got {img.dtype}")
    return img


def encode_jpeg(img, quality: int = 75) -> bytes:
    """JFIF bytes of an ``(H, W, 3)`` RGB or ``(H, W)`` gray uint8 image
    (numpy or a tensor): ``Image.save(buf, "JPEG", quality=quality)``'s
    bytes (4:2:0 chroma, Pillow's default). The colour conversion and the
    forward DCT run on all cores; the entropy coding is serial."""
    img = _pixels(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) pixels; got {img.shape}")
    c = 1 if img.ndim == 2 else 3
    buf = ctypes.c_void_p()
    err = _err()
    lib = _lib()
    n = lib.jpeg_encode(img.ctypes.data, img.shape[0], img.shape[1], c, int(quality), 0,
                        ctypes.byref(buf), err, _ERRLEN)
    if n < 0:
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(buf, n)
    finally:
        lib.jpeg_free(buf)


def encode_jpeg_batch(arrays, paths: Sequence, quality: int = 75, n_threads: int = 0) -> None:
    """Write each ``(h, w, 3)`` image of ``arrays`` (an ``(n, h, w, 3)``
    uint8 array or tensor) to its path in ``paths`` as :func:`encode_jpeg`
    encodes it, one image a thread over ``n_threads`` threads (0: all
    cores)."""
    arrays = _pixels(arrays)
    if arrays.ndim != 4 or arrays.shape[3] not in (1, 3):
        raise ValueError(f"encode_jpeg_batch takes (n, h, w, 3) pixels; got {arrays.shape}")
    if len(paths) != arrays.shape[0]:
        raise ValueError(f"{arrays.shape[0]} images but {len(paths)} paths")
    if not len(paths):
        return
    err = _err()
    if _lib().jpeg_encode_files(arrays.ctypes.data, arrays.shape[0], arrays.shape[1],
                                arrays.shape[2], arrays.shape[3], _paths(paths), int(quality),
                                int(n_threads), err, _ERRLEN):
        raise ValueError(err.value.decode())
