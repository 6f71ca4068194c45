"""PNG slides without libpng or PIL (``csrc/raster_codec.cpp``).

The JAX package opens a slide with ``Image.open(path).convert("RGB")``;
the card's machine has no PIL, so the port reads PNG itself: the chunks
IHDR, PLTE, IDAT and IEND, each chunk's CRC checked (tRNS and the
ancillary chunks are skipped, as ``convert("RGB")`` ignores them), the
joined IDAT data inflated with the standard library's ``zlib`` and the row
filters (None, Sub, Up, Average, Paeth) undone by the C library. Every
colour type at every depth PNG allows (Pillow's ``_MODES``): gray at 1, 2,
4, 8 and 16 bits, palette at 1, 2, 4 and 8, RGB, gray + alpha and RGBA at
8 and 16; non-interlaced (inflated and unfiltered a band of rows at a
time) or Adam7-interlaced (each of the seven passes unfiltered on its own
and scattered into the image). :func:`read_png` gives Pillow's mode and
array (``io/pillow_modes.py``: 16-bit gray is ``I;16``, which converts by
clipping; 16-bit colour keeps its high byte), :func:`decode_png` its RGB
conversion.

Anything else raises ``ValueError`` naming the file and what it holds: a
colour type / bit depth pair PNG does not define, a bad CRC, truncated or
corrupt image data.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from gridnext_tpu_torch.io import pillow_modes

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = (
    # src, src_len, rows, row_bytes, bpp, prev, out, err, errlen
    ("png_unfilter", (_VP, _LL, _LL, _LL, _I, _VP, _VP, ctypes.c_char_p, _I), _I),
)
_ERRLEN = 1024
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples a pixel, {bit depth: Pillow's raw mode})
_COLOUR = {0: ("gray", 1, {1: "1", 2: "L;2", 4: "L;4", 8: "L", 16: "I;16"}),
           2: ("RGB", 3, {8: "RGB", 16: "RGB;16"}),
           3: ("palette", 1, {1: "P", 2: "P", 4: "P", 8: "P"}),
           4: ("gray + alpha", 2, {8: "LA", 16: "LA;16"}),
           6: ("RGBA", 4, {8: "RGBA", 16: "RGBA;16"})}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))
_BAND_BYTES = 8 << 20          # inflated bytes a band of rows
_FEED_BYTES = 64 << 10         # compressed bytes fed to the inflater at a time


def _lib():
    from gridnext_tpu_torch.ops import _host

    return _host.library("raster_codec", _SIGNATURES)


def is_png_file(path) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as fh:
        return fh.read(8) == SIGNATURE


def _read(path_or_bytes) -> tuple:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return bytes(path_or_bytes), "<bytes>"
    with open(path_or_bytes, "rb") as fh:
        return fh.read(), str(path_or_bytes)


def _chunks(data: bytes, name: str):
    """Yield ``(type, payload)`` of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (no PNG signature)")
    view = memoryview(data)
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG: chunk {ctype!r} is cut")
        payload = view[pos + 8:end]
        if zlib.crc32(payload, zlib.crc32(ctype)) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{name}: broken PNG: bad CRC in chunk {ctype.decode('latin-1')}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _header(data: bytes, name: str) -> dict:
    ctype, payload = next(_chunks(data, name))
    if ctype != b"IHDR" or len(payload) != 13:
        raise ValueError(f"{name}: broken PNG: the first chunk is not IHDR")
    w, h, depth, colour, method, filt, interlace = struct.unpack(">IIBBBBB", payload)
    return {"width": w, "height": h, "depth": depth, "colour": colour, "method": method,
            "filter": filt, "interlace": interlace}


def _pieces(chunks, size: int):
    """Memoryview slices of at most ``size`` bytes over ``chunks``."""
    for c in chunks:
        view = memoryview(c)
        for i in range(0, len(view), size):
            yield view[i:i + size]


def _unfilter(lib, src, rows, row_bytes, bpp, prev, out, err, name, y) -> None:
    status = lib.png_unfilter(src.ctypes.data, src.size, rows, row_bytes, bpp,
                              prev.ctypes.data, out.ctypes.data, err, _ERRLEN)
    if status:
        raise ValueError(f"{name}: broken PNG: {err.value.decode()} (rows from {y})")


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines ((h, row bytes) uint8) as (h, w, channels)
    sample values: uint8 up to 8 bits, native uint16 at 16."""
    h = rows.shape[0]
    if depth == 16:
        vals = rows[:, :w * channels * 2].view(">u2").astype(np.uint16)
    elif depth == 8:
        vals = rows[:, :w * channels]
    else:
        b = np.unpackbits(rows, axis=1)[:, :w * channels * depth]
        b = b.reshape(h, w * channels, depth)
        vals = (b * (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)).sum(-1,
                                                                            dtype=np.uint8)
    return vals.reshape(h, w, channels)


def png_info(path_or_bytes) -> dict:
    """``{"height", "width", "samples", "compression"}`` from the IHDR
    chunk alone (no decoding), as :func:`~gridnext_tpu_torch.io.tiff.tiff_info`
    gives them; samples counts the bands of the image Pillow opens (16-bit
    gray + alpha opens as RGBA), compression is ``"deflate"``."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data, name = bytes(path_or_bytes[:33]), "<bytes>"
    else:
        with open(path_or_bytes, "rb") as fh:
            data, name = fh.read(33), str(path_or_bytes)      # signature and IHDR
    hdr = _header(data, name)
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(hdr["colour"], 0)
    if hdr["colour"] == 4 and hdr["depth"] == 16:
        samples = 4
    return {"height": hdr["height"], "width": hdr["width"], "samples": samples,
            "compression": "deflate"}


def read_png(path_or_bytes) -> tuple:
    """``(mode, pixels, palette)`` of a PNG (a path or its bytes): Pillow's
    mode and ``np.asarray(Image.open(path))``'s array; ``palette`` ((n, 3)
    uint8, PLTE's entries) for ``P``, else None. Raises ``ValueError``
    naming the file on a PNG it does not read (module docstring)."""
    data, name = _read(path_or_bytes)
    hdr = _header(data, name)
    h, w, colour, depth = hdr["height"], hdr["width"], hdr["colour"], hdr["depth"]
    if colour not in _COLOUR:
        raise ValueError(f"{name}: bad PNG colour type {colour}")
    what, channels, rawmodes = _COLOUR[colour]
    if depth not in rawmodes:
        raise ValueError(f"{name}: bad PNG: bit depth {depth} for {what} (PNG allows "
                         f"{sorted(rawmodes)})")
    if hdr["method"] or hdr["filter"] or hdr["interlace"] > 1 or h <= 0 or w <= 0:
        raise ValueError(f"{name}: bad PNG header")
    idat, palette = [], None
    for ctype, payload in _chunks(data, name):
        if ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"PLTE":
            if len(payload) % 3 or not 0 < len(payload) <= 768:
                raise ValueError(f"{name}: broken PNG: PLTE of {len(payload)} bytes")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: broken PNG: a palette image without PLTE")
    bits = channels * depth
    bpp = max(1, bits // 8)                         # the filters' unit: a pixel's bytes
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    try:
        if hdr["interlace"]:
            samples = _adam7(lib, idat, h, w, channels, depth, bits, bpp, err, name)
        else:
            samples = _samples(_rows(lib, idat, h, -(-w * bits // 8), bpp, err, name), w,
                               channels, depth)
    except zlib.error as e:
        raise ValueError(f"{name}: broken PNG: corrupt image data ({e})") from None
    if channels == 1:
        samples = samples[..., 0]
    mode, pixels = pillow_modes.unpack(rawmodes[depth], samples)
    return mode, pixels, palette


def _rows(lib, idat, h, row_bytes, bpp, err, name) -> np.ndarray:
    """The unfiltered scanlines of a non-interlaced image, (h, row_bytes):
    the IDAT data fed to the inflater in small pieces (an inflated piece is
    at most ~1,000 times its size) and whole rows unfiltered a band at a
    time as they arrive."""
    stride = row_bytes + 1
    out = np.empty((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    d = zlib.decompressobj()
    band = max(1, _BAND_BYTES // stride)
    pending = bytearray()
    y = 0

    def unfilter(rows):
        src = np.frombuffer(pending, np.uint8, rows * stride)
        _unfilter(lib, src, rows, row_bytes, bpp, prev, out[y:], err, name, y)
        del src                     # the view pins ``pending``, which the caller trims

    for piece in _pieces(idat, _FEED_BYTES):
        pending += d.decompress(piece)
        rows = min(len(pending) // stride, h - y)
        if rows >= band or (rows and y + rows == h):
            unfilter(rows)
            del pending[:rows * stride]
            y += rows
        if y == h:
            break
    else:
        pending += d.flush()
        rows = min(len(pending) // stride, h - y)
        if rows:
            unfilter(rows)
            y += rows
    if y < h:
        raise ValueError(f"{name}: truncated PNG: image data ends in row {y} of {h}")
    return out


def _adam7(lib, idat, h, w, channels, depth, bits, bpp, err, name) -> np.ndarray:
    """The samples of an Adam7-interlaced image: the whole IDAT data
    inflated, each pass's scanlines unfiltered on their own (a pass starts
    from a zero row) and scattered to its pixels."""
    data = np.frombuffer(zlib.decompress(b"".join(bytes(c) for c in idat)), np.uint8)
    dtype = np.uint16 if depth == 16 else np.uint8
    out = np.zeros((h, w, channels), dtype)
    pos = 0
    for k, (y0, x0, dy, dx) in enumerate(_ADAM7):
        ph, pw = -(-(h - y0) // dy) if h > y0 else 0, -(-(w - x0) // dx) if w > x0 else 0
        if not ph or not pw:                         # an empty pass has no scanlines
            continue
        row_bytes = -(-pw * bits // 8)
        size = ph * (row_bytes + 1)
        if pos + size > data.size:
            raise ValueError(f"{name}: truncated PNG: image data ends in Adam7 pass {k + 1}")
        rows = np.empty((ph, row_bytes), np.uint8)
        _unfilter(lib, data[pos:pos + size], ph, row_bytes, bpp, np.zeros(row_bytes, np.uint8),
                  rows, err, name, 0)
        out[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        pos += size
    return out


def decode_png(path_or_bytes) -> np.ndarray:
    """Decode a PNG (a path or its bytes) to ``(H, W, 3)`` uint8:
    ``np.asarray(Image.open(path).convert("RGB"))``'s pixels
    (:func:`read_png`, then ``pillow_modes.to_rgb``)."""
    return pillow_modes.to_rgb(*read_png(path_or_bytes))
