"""PNG slides without libpng or PIL (``csrc/raster_codec.cpp``).

The JAX package opens a slide with ``Image.open(path).convert("RGB")``;
the card's machine has no PIL, so the port reads PNG itself: the chunks
IHDR, PLTE, IDAT and IEND, each chunk's CRC checked (tRNS and the
ancillary chunks are skipped, as ``convert("RGB")`` ignores them), the
joined IDAT data inflated with the standard library's ``zlib`` a band of
rows at a time and the row filters (None, Sub, Up, Average, Paeth) undone
by the C library straight into the ``(H, W, 3)`` array. Non-interlaced 8-bit
images: gray, gray + alpha, RGB, RGBA and palette, gray repeated to three
channels, alpha dropped, a palette mapped through PLTE.

Anything else raises ``ValueError`` naming the file and what it holds: an
interlaced (Adam7) PNG, bit depths 1, 2, 4 and 16, a bad CRC, truncated
image data.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = (
    # src, src_len, rows, row_bytes, channels, prev, out, oc, err, errlen
    ("png_unfilter", (_VP, _LL, _LL, _LL, _I, _VP, _VP, _I, ctypes.c_char_p, _I), _I),
)
_ERRLEN = 1024
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, bytes a pixel at 8 bits, channels kept)
_COLOUR = {0: ("gray", 1, 1), 2: ("RGB", 3, 3), 3: ("palette", 1, 1),
           4: ("gray + alpha", 2, 1), 6: ("RGBA", 4, 3)}
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


def _unfilter(lib, pending: bytearray, rows, row_bytes, channels, prev, out, oc, err, name,
              y) -> None:
    src = np.frombuffer(pending, np.uint8, rows * (row_bytes + 1))
    status = lib.png_unfilter(src.ctypes.data, src.size, rows, row_bytes, channels,
                              prev.ctypes.data, out.ctypes.data, oc, err, _ERRLEN)
    del src                         # the view pins ``pending``, which the caller trims
    if status:
        raise ValueError(f"{name}: broken PNG: {err.value.decode()} (rows from {y})")


def png_info(path_or_bytes) -> dict:
    """``{"height", "width", "samples", "compression"}`` from the IHDR
    chunk alone (no decoding), as :func:`~gridnext_tpu_torch.io.tiff.tiff_info`
    gives them; compression is ``"deflate"``."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data, name = bytes(path_or_bytes[:33]), "<bytes>"
    else:
        with open(path_or_bytes, "rb") as fh:
            data, name = fh.read(33), str(path_or_bytes)      # signature and IHDR
    hdr = _header(data, name)
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(hdr["colour"], 0)
    return {"height": hdr["height"], "width": hdr["width"], "samples": samples,
            "compression": "deflate"}


def decode_png(path_or_bytes) -> np.ndarray:
    """Decode a PNG (a path or its bytes) to ``(H, W, 3)`` uint8:
    ``np.asarray(Image.open(path).convert("RGB"))``'s pixels. Raises
    ``ValueError`` naming the file on a PNG it does not read (module
    docstring)."""
    data, name = _read(path_or_bytes)
    hdr = _header(data, name)
    h, w, colour = hdr["height"], hdr["width"], hdr["colour"]
    if colour not in _COLOUR:
        raise ValueError(f"{name}: bad PNG colour type {colour}")
    if hdr["depth"] != 8:
        raise ValueError(f"{name}: unsupported PNG: bit depth {hdr['depth']} "
                         f"({_COLOUR[colour][0]}; only 8-bit)")
    if hdr["interlace"]:
        raise ValueError(f"{name}: unsupported PNG: interlaced (Adam7)")
    if hdr["method"] or hdr["filter"] or h <= 0 or w <= 0:
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
    _, channels, oc = _COLOUR[colour]
    row_bytes = w * channels
    stride = row_bytes + 1
    out = np.empty((h, w, oc), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = _lib()
    d = zlib.decompressobj()
    band = max(1, _BAND_BYTES // stride)
    pending = bytearray()
    y = 0
    try:
        # feed the IDAT data in small pieces (an inflated piece is at most
        # ~1,000 times its size) and unfilter whole rows as they arrive
        for piece in _pieces(idat, _FEED_BYTES):
            pending += d.decompress(piece)
            rows = min(len(pending) // stride, h - y)
            if rows >= band or (rows and y + rows == h):
                _unfilter(lib, pending, rows, row_bytes, channels, prev, out[y:], oc, err,
                          name, y)
                del pending[:rows * stride]
                y += rows
            if y == h:
                break
        else:
            pending += d.flush()
            rows = min(len(pending) // stride, h - y)
            if rows:
                _unfilter(lib, pending, rows, row_bytes, channels, prev, out[y:], oc, err,
                          name, y)
                y += rows
    except zlib.error as e:
        raise ValueError(f"{name}: broken PNG: corrupt image data ({e})") from None
    if y < h:
        raise ValueError(f"{name}: truncated PNG: image data ends in row {y} of {h}")
    if colour == 3:
        # Pillow's palette: PLTE's entries, then black (an index past PLTE)
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette
        return lut[out[..., 0]]
    return np.repeat(out, 3, axis=2) if oc == 1 else out
