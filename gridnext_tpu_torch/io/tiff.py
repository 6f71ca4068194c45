"""TIFF slides without libtiff or PIL (``csrc/raster_codec.cpp``).

The JAX package opens a slide with ``Image.open(path).convert("RGB")``,
and Pillow reads TIFF through libtiff. The card's machine has neither, so
the port reads the first page of a TIFF or BigTIFF itself (a scanner's
pyramid puts full resolution there; Pillow reads frame 0) and gives the
pixels Pillow gives:

- classic and BigTIFF headers, both byte orders;
- strips (the last one short) and tiles (edge tiles cropped), placed into
  one preallocated ``(H, W, 3)`` array;
- compression none, PackBits and LZW (decoded by the C library on
  ``n_threads`` threads), Deflate (8 and 32946: the standard library's
  ``zlib`` on a thread pool, which inflates without the GIL) and JPEG (7:
  the port's codec, ``io/jpeg.py``, each strip or tile spliced after the
  JPEGTables; three components are YCbCr under Photometric YCbCr and taken
  as stored under Photometric RGB, as libtiff does);
- Predictor 2 under LZW and Deflate;
- 8-bit samples: gray (MinIsWhite inverted), RGB, palette (the 16-bit
  ColorMap taken ``>> 8``), extra samples dropped (associated alpha first
  divided out, as Pillow's ``RGBa`` unpacking does), interleaved or one
  plane a sample; the Orientation tag applied as Pillow's
  ``exif_transpose`` applies it.

Anything else raises ``ValueError`` naming the file and what it holds:
other bit depths and sample formats, CMYK, Lab, YCbCr outside JPEG,
FillOrder 2, Predictor 3, old-style JPEG (6), JPEG 2000 and other
compressions, and JPEG strips the codec refuses (progressive, ...).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gridnext_tpu_torch.io.jpeg import decode_jpeg_segments

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = (
    # codec, base, offsets, counts, geom, n, stored_w, seg_spp, predictor,
    # out, W, oc, kind, n_threads, err, errlen
    ("raster_decode", (_I, _VP, _VP, _VP, _VP, _LL, _I, _I, _I, _VP, _I, _I, ctypes.c_char_p,
                       _I, ctypes.c_char_p, _I), _I),
)
_ERRLEN = 1024
HEADERS = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")   # classic, BigTIFF; II, MM

COMPRESSION = {1: "none", 5: "lzw", 6: "old-style jpeg", 7: "jpeg", 8: "deflate",
               32946: "deflate", 32773: "packbits", 33003: "jpeg 2000", 33005: "jpeg 2000",
               34712: "jpeg 2000"}
_DECODED = (1, 5, 7, 8, 32946, 32773)
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
                4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr", 8: "CIELab",
                9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

# tag numbers
(_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTO, _FILLORDER, _STRIP_OFFSETS, _ORIENTATION,
 _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP, _TILE_W, _TILE_H,
 _TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _SAMPLE_FORMAT, _JPEG_TABLES, _YCBCR_SUB) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324,
    325, 338, 339, 347, 530)
_TAGS = {_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTO, _FILLORDER, _STRIP_OFFSETS,
         _ORIENTATION, _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP,
         _TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _SAMPLE_FORMAT, _JPEG_TABLES,
         _YCBCR_SUB}
# field type -> (numpy code, bytes a value, values an item)
_FIELD = {1: ("u1", 1, 1), 2: ("u1", 1, 1), 3: ("u2", 2, 1), 4: ("u4", 4, 1),
          5: ("u4", 8, 2), 6: ("i1", 1, 1), 7: ("u1", 1, 1), 8: ("i2", 2, 1),
          9: ("i4", 4, 1), 10: ("i4", 8, 2), 11: ("f4", 4, 1), 12: ("f8", 8, 1),
          13: ("u4", 4, 1), 16: ("u8", 8, 1), 17: ("i8", 8, 1), 18: ("u8", 8, 1)}
# Pillow's ImageOps.exif_transpose, per Orientation value
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: np.rot90(a, 1)}


def _lib():
    from gridnext_tpu_torch.ops import _host

    return _host.library("raster_codec", _SIGNATURES)


def is_tiff_file(path) -> bool:
    """Whether the file starts with a TIFF or BigTIFF header."""
    with open(path, "rb") as fh:
        return fh.read(4) in HEADERS


class _Page:
    """The tags of a file's first IFD, over the file's bytes ``buf``."""

    def __init__(self, buf: np.ndarray, name: str):
        self.name = name
        head = bytes(buf[:16])
        if len(head) < 8 or head[:4] not in HEADERS:
            raise ValueError(f"{name}: not a TIFF file (no TIFF or BigTIFF header)")
        self.order = "<" if head[:2] == b"II" else ">"
        self.big = head[2:4] in (b"+\0", b"\0+")
        u = lambda off, code: int(np.frombuffer(buf, self.order + code, 1, off)[0])  # noqa: E731
        if self.big:
            if len(head) < 16 or u(4, "u2") != 8:
                raise ValueError(f"{name}: bad BigTIFF header")
            ifd, count_code, entry, value_bytes = u(8, "u8"), "u8", 20, 8
        else:
            ifd, count_code, entry, value_bytes = u(4, "u4"), "u2", 12, 4
        count_size = 8 if self.big else 2
        if ifd + count_size > buf.size:
            raise ValueError(f"{name}: truncated TIFF: the first IFD lies past the end")
        n = u(ifd, count_code)
        if ifd + count_size + n * entry > buf.size:
            raise ValueError(f"{name}: truncated TIFF: the first IFD is cut")
        self.tags = {}
        for k in range(n):
            at = ifd + count_size + k * entry
            tag, ftype = u(at, "u2"), u(at + 2, "u2")
            if tag not in _TAGS or ftype not in _FIELD:
                continue
            count = u(at + 4, "u8" if self.big else "u4")
            code, size, per = _FIELD[ftype]
            nbytes = count * size
            off = at + 4 + (8 if self.big else 4)
            if nbytes > value_bytes:
                off = u(off, "u8" if self.big else "u4")
            if off + nbytes > buf.size:
                raise ValueError(f"{name}: truncated TIFF: tag {tag}'s values lie past the end")
            if tag == _JPEG_TABLES:
                self.tags[tag] = bytes(buf[off:off + nbytes])
            else:
                self.tags[tag] = np.frombuffer(buf, self.order + code, count * per, off)

    def get(self, tag, default=None):
        v = self.tags.get(tag)
        return default if v is None else v

    def one(self, tag, default=None):
        v = self.tags.get(tag)
        return default if v is None or not len(v) else int(v[0])


def _open(path):
    """(mmap or None, uint8 view of the file's bytes, name)."""
    if isinstance(path, (bytes, bytearray, memoryview)):
        return None, np.frombuffer(bytes(path), np.uint8), "<bytes>"
    with open(path, "rb") as fh:
        size = os.fstat(fh.fileno()).st_size
        if size == 0:
            raise ValueError(f"{path}: not a TIFF file (empty)")
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    return mm, np.frombuffer(mm, np.uint8), str(path)


def _close(mm) -> None:
    if mm is not None:
        try:
            mm.close()
        except BufferError:     # a view still held (an exception's frame): the GC closes it
            pass


def tiff_info(path) -> dict:
    """``{"height", "width", "samples", "compression"}`` of a TIFF's first
    page, from its header alone (no decoding), height and width as the
    decoded image has them (swapped by an Orientation of 5 to 8, as
    Pillow's ``size``); compression as a name
    (``"none"``, ``"lzw"``, ``"deflate"``, ``"packbits"``, ``"jpeg"``, ...)
    or the tag's number for one without a name."""
    mm, buf, name = _open(path)
    try:
        page = _Page(buf, name)
        c = page.one(_COMPRESSION, 1)
        h, w = page.one(_LENGTH, 0), page.one(_WIDTH, 0)
        if page.one(_ORIENTATION, 1) in (5, 6, 7, 8):     # turned a quarter, as Pillow's size
            h, w = w, h
        info = {"height": h, "width": w, "samples": page.one(_SPP, 1),
                "compression": COMPRESSION.get(c, c)}
        del page
    finally:
        del buf
        _close(mm)
    return info


def _layout(page: _Page, h: int, w: int, spp: int, planar: int):
    """(kind, offsets, counts, geom (n, 6): y0, x0, rows, cols, plane,
    stored rows; stored width, samples a segment)."""
    name = page.name
    planes = spp if planar == 2 else 1
    seg_spp = 1 if planar == 2 else spp
    if _TILE_OFFSETS in page.tags:
        kind = "tile"
        tw, th = page.one(_TILE_W, 0), page.one(_TILE_H, 0)
        if tw <= 0 or th <= 0:
            raise ValueError(f"{name}: bad TIFF tile size {tw}x{th}")
        offsets, counts = page.get(_TILE_OFFSETS), page.get(_TILE_COUNTS)
        across, down = -(-w // tw), -(-h // th)
        y0 = np.repeat(np.arange(down) * th, across)
        x0 = np.tile(np.arange(across) * tw, down)
        rows, cols = np.minimum(th, h - y0), np.minimum(tw, w - x0)
        stored = np.full_like(y0, th)
        stored_w = tw
    elif _STRIP_OFFSETS in page.tags:
        kind = "strip"
        rps = min(page.one(_ROWS_PER_STRIP, 2 ** 32 - 1), h)
        if rps <= 0:
            raise ValueError(f"{name}: bad TIFF RowsPerStrip {rps}")
        offsets, counts = page.get(_STRIP_OFFSETS), page.get(_STRIP_COUNTS)
        y0 = np.arange(-(-h // rps)) * rps
        x0 = np.zeros_like(y0)
        rows = np.minimum(rps, h - y0)
        cols = np.full_like(y0, w)
        stored = rows
        stored_w = w
    else:
        raise ValueError(f"{name}: TIFF without strips or tiles")
    per_plane = len(y0)
    n = per_plane * planes
    if counts is None and page.one(_COMPRESSION, 1) == 1:       # uncompressed: implied
        counts = np.tile(stored, planes).astype(np.int64) * stored_w * seg_spp
    if counts is None or len(offsets) < n or len(counts) < n:
        raise ValueError(f"{name}: TIFF lists {len(offsets)} {kind}s with "
                         f"{0 if counts is None else len(counts)} byte counts; "
                         f"{h}x{w} needs {n}")
    offsets = np.ascontiguousarray(offsets[:n], np.int64)
    counts = np.ascontiguousarray(counts[:n], np.int64)
    plane = np.repeat(np.arange(planes) if planar == 2 else np.array([-1]), per_plane)
    geom = np.stack([np.tile(y0, planes), np.tile(x0, planes), np.tile(rows, planes),
                     np.tile(cols, planes), plane, np.tile(stored, planes)], 1)
    return kind, offsets, counts, np.ascontiguousarray(geom, np.int32), stored_w, seg_spp


def decode_tiff(path, n_threads: int = 0) -> np.ndarray:
    """Decode a TIFF's first page (a path or its bytes) to ``(H, W, 3)``
    uint8: ``np.asarray(Image.open(path).convert("RGB"))``'s pixels. Strips
    and tiles decode on ``n_threads`` threads (0: all cores); the pixels do
    not depend on the count. Raises ``ValueError`` naming the file on a
    TIFF it does not read (module docstring)."""
    mm, buf, name = _open(path)
    try:
        page = _Page(buf, name)
        out = _decode_page(page, buf, name, n_threads)
        del page
    finally:
        del buf
        _close(mm)
    return out


def _check(page: _Page, name: str):
    """(h, w, spp, photometric, compression, planar, predictor, extra)
    of a page the reader decodes; raises on any other."""
    h, w = page.one(_LENGTH, 0), page.one(_WIDTH, 0)
    if h <= 0 or w <= 0:
        raise ValueError(f"{name}: bad TIFF size {w}x{h}")
    compression = page.one(_COMPRESSION, 1)
    if compression not in _DECODED:
        what = COMPRESSION.get(compression, "unknown")
        raise ValueError(f"{name}: unsupported TIFF compression {compression} ({what}); "
                         "read: none, LZW, Deflate, PackBits, JPEG")
    photo = page.one(_PHOTO, 0)
    spp = page.one(_SPP, 1)
    bits = [int(b) for b in page.get(_BITS, [1])]
    if any(b != 8 for b in bits):
        raise ValueError(f"{name}: unsupported TIFF: {max(set(bits), key=bits.count)}-bit "
                         f"samples (BitsPerSample {tuple(bits)}; only 8-bit)")
    formats = {int(f) for f in page.get(_SAMPLE_FORMAT, [1])}
    if formats != {1}:
        raise ValueError(f"{name}: unsupported TIFF: SampleFormat {sorted(formats)} (signed or "
                         "floating-point samples; only unsigned 8-bit)")
    need = {0: 1, 1: 1, 2: 3, 3: 1, 6: 3}.get(photo)
    if need is None:
        raise ValueError(f"{name}: unsupported TIFF photometric interpretation {photo} "
                         f"({_PHOTOMETRIC.get(photo, 'unknown')})")
    if spp < need:
        raise ValueError(f"{name}: TIFF of photometric {_PHOTOMETRIC[photo]} with {spp} "
                         "samples a pixel")
    planar = page.one(_PLANAR, 1)
    if planar not in (1, 2):
        raise ValueError(f"{name}: bad TIFF PlanarConfiguration {planar}")
    if photo == 6 and (compression != 7 or planar != 1):
        raise ValueError(f"{name}: unsupported TIFF: YCbCr samples outside JPEG compression "
                         "(only JPEG-compressed YCbCr is read)")
    if compression == 7 and planar == 2:
        raise ValueError(f"{name}: unsupported TIFF: JPEG with PlanarConfiguration 2")
    if photo == 3 and (_COLORMAP not in page.tags or len(page.tags[_COLORMAP]) < 3 * 256):
        raise ValueError(f"{name}: palette TIFF without a 256-entry ColorMap")
    if page.one(_FILLORDER, 1) != 1:
        raise ValueError(f"{name}: unsupported TIFF FillOrder {page.one(_FILLORDER)} "
                         "(bits least-significant first)")
    predictor = page.one(_PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise ValueError(f"{name}: unsupported TIFF Predictor {predictor}"
                         + (" (floating point)" if predictor == 3 else ""))
    orientation = page.one(_ORIENTATION, 1)
    if orientation not in range(1, 9):
        raise ValueError(f"{name}: bad TIFF Orientation {orientation}")
    extra = [int(e) for e in page.get(_EXTRA, [])]
    return h, w, spp, photo, compression, planar, predictor, extra


def _decode_page(page: _Page, buf: np.ndarray, name: str, n_threads: int) -> np.ndarray:
    h, w, spp, photo, compression, planar, predictor, extra = _check(page, name)
    kind, offsets, counts, geom, stored_w, seg_spp = _layout(page, h, w, spp, planar)
    if int((offsets + counts).max(initial=0)) > buf.size:
        bad = int(np.argmax(offsets + counts > buf.size))
        raise ValueError(f"{name}: truncated TIFF: {kind} {bad} lies past the end of the file")
    if int(counts.min(initial=1)) <= 0:
        raise ValueError(f"{name}: TIFF {kind} {int(np.argmin(counts))} is empty")
    # channels kept: gray/palette 1, RGB 3, RGB with associated alpha 4
    premultiplied = photo == 2 and spp >= 4 and extra[:1] == [1]
    oc = 4 if premultiplied else (1 if photo in (0, 1, 3) else 3)
    out = np.zeros((h, w, oc), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if compression == 7:
        tables = page.tags.get(_JPEG_TABLES, b"")
        decode_jpeg_segments(tables, buf, offsets, counts, geom, out,
                             colour=1 if photo == 2 else 0, kind=kind, name=name,
                             n_threads=n_threads)
    elif compression in (8, 32946):
        _inflate_segments(buf, offsets, counts, geom, stored_w, seg_spp, predictor, out, kind,
                          name, n_threads)
    else:
        if _lib().raster_decode(compression, buf.ctypes.data, offsets.ctypes.data,
                                counts.ctypes.data, geom.ctypes.data, len(offsets), stored_w,
                                seg_spp, predictor, out.ctypes.data, w, oc, kind.encode(),
                                int(n_threads), err, _ERRLEN):
            raise ValueError(f"{name}: {err.value.decode()}")
    if premultiplied:      # Pillow's RGBa unpacking: c * 255 // a, clipped; a = 0 gives 0
        a = out[..., 3:].astype(np.uint32)
        rgb = np.minimum(out[..., :3] * np.uint32(255) // np.maximum(a, 1), 255)
        out = np.where(a == 0, 0, rgb).astype(np.uint8)
    if photo == 0:
        np.subtract(255, out, out=out)
    if photo == 3:
        cmap = page.tags[_COLORMAP][:3 * 256].reshape(3, 256)
        out = (cmap.T >> 8).astype(np.uint8)[out[..., 0]]
    elif oc == 1:
        out = np.repeat(out, 3, axis=2)
    orientation = page.one(_ORIENTATION, 1)
    if orientation != 1:
        out = np.ascontiguousarray(_ORIENT[orientation](out))
    return out


def _inflate_segments(buf, offsets, counts, geom, stored_w, seg_spp, predictor, out, kind,
                      name, n_threads) -> None:
    """Deflate strips or tiles: each task inflates a run of segments with
    ``zlib`` (no GIL while it inflates) and places them with the C library's
    uncompressed route (its predictor undone there), so at most a run's
    inflated bytes a thread are held at once."""
    lib = _lib()
    want = geom[:, 5].astype(np.int64) * stored_w * seg_spp
    # runs of about 4 MB of pixels, at least 4 runs a thread when there are enough
    n = len(offsets)
    threads = n_threads if n_threads > 0 else (os.cpu_count() or 1)
    per_run = max(1, min(int((4 << 20) // max(1, int(want.max()))), -(-n // (4 * threads))))
    runs = [range(i, min(n, i + per_run)) for i in range(0, n, per_run)]
    w, oc = out.shape[1:]

    def run(segs):
        err = ctypes.create_string_buffer(_ERRLEN)
        zero = np.zeros(1, np.int64)
        for i in segs:
            d = zlib.decompressobj()
            try:
                data = d.decompress(buf[offsets[i]:offsets[i] + counts[i]], int(want[i]))
            except zlib.error as e:
                raise ValueError(f"{name}: {kind} {i}: corrupt Deflate data ({e})") from None
            if len(data) < want[i]:
                raise ValueError(f"{name}: {kind} {i}: Deflate data ends after {len(data)} of "
                                 f"{int(want[i])} bytes")
            size = np.array([len(data)], np.int64)
            if lib.raster_decode(1, data, zero.ctypes.data, size.ctypes.data,
                                 geom[i].ctypes.data, 1, stored_w, seg_spp, predictor,
                                 out.ctypes.data, w, oc, kind.encode(), 1, err, _ERRLEN):
                raise ValueError(f"{name}: {kind} {i}: {err.value.decode()}")

    if threads == 1 or len(runs) == 1:
        for r in runs:
            run(r)
        return
    with ThreadPoolExecutor(min(threads, len(runs))) as pool:
        for f in [pool.submit(run, r) for r in runs]:
            f.result()
