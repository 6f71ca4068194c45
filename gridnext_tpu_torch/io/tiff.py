"""TIFF slides without libtiff or PIL (``csrc/raster_codec.cpp``).

The JAX package opens a slide with ``Image.open(path).convert("RGB")``,
and Pillow reads TIFF through libtiff. The card's machine has neither, so
the port reads the first page of a TIFF or BigTIFF itself (a scanner's
pyramid puts full resolution there; Pillow reads frame 0) and gives the
pixels Pillow gives:

- classic and BigTIFF headers, both byte orders;
- strips (the last one short) and tiles (edge tiles cropped), placed into
  one preallocated raster of the file's stored bytes;
- compression none, PackBits, LZW and CCITT fax (2, 3 and 4, decoded as
  libtiff decodes them; the C library on ``n_threads`` threads), Deflate
  (8 and 32946: the standard library's ``zlib`` on a thread pool, which
  inflates without the GIL) and JPEG (7: the port's codec, ``io/jpeg.py``,
  each strip or tile spliced after the JPEGTables, baseline or
  progressive; three components are YCbCr under Photometric YCbCr and
  taken as stored under Photometric RGB, as libtiff does);
- Predictor 2 under LZW and Deflate on 8-, 16- and 32-bit samples;
  FillOrder 2 (each stored byte's bits reversed before its codec, as
  libtiff does);
- every sample layout Pillow 12 has a mode for (its ``OPEN_INFO`` table,
  copied here as :data:`_RAW_MODES`): 1-, 2-, 4- and 8-bit gray
  (MinIsWhite inverted, except at 16 bits, where Pillow does not), 12-bit
  gray (little-endian files), 16-bit gray in either byte order and signed,
  32-bit float and integer gray, 8- and 16-bit RGB and RGBA (extra
  samples dropped, associated alpha divided out), 1- to 8-bit palette (the
  16-bit ColorMap taken ``>> 8``), gray + alpha, 8- and 16-bit CMYK; YCbCr
  outside JPEG at every subsampling libtiff converts (Pillow reads it
  through libtiff's RGBA interface: its float tables, its short reads of
  4x4 strips and its skew of 4x4 edge tiles are copied); interleaved or
  one plane a sample; the Orientation tag applied as Pillow's
  ``exif_transpose`` applies it. Where Pillow's own decoder misreads a
  layout (big-endian signed, float or 32-bit gray through libtiff, read
  byte-swapped), the reader gives Pillow's pixels all the same.

:func:`read_tiff` gives Pillow's mode and array (``io/pillow_modes.py``);
:func:`decode_tiff` its RGB conversion. Anything else raises
``ValueError`` naming the file and what it holds: layouts Pillow has no
mode for (signed RGB, big-endian 12-bit, ...) or fails on (uncompressed
YCbCr; uncompressed FillOrder 2 of some layouts), ICCLab and ITULab
(Photometric 9 and 10, which Pillow has no mode for), uncompressed planes
of more than 8 bits (Pillow reads them as 8-bit samples), YCbCr under
Predictor 2 or an Orientation, Predictor 3, old-style JPEG (6), JPEG 2000
and other compressions, and JPEG strips the codec refuses (12-bit,
hierarchical, ...). CIELab (Photometric 8) reads as Pillow's ``LAB`` and
converts as LittleCMS does (``io/pillow_modes.py``).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gridnext_tpu_torch.io import pillow_modes
from gridnext_tpu_torch.io.jpeg import decode_jpeg_segments

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = (
    # codec, base, offsets, counts, geom, n, stored_row, sample_bytes, spp,
    # predictor, big, reverse, fax_options, fax_width, out, out_row,
    # plane_bytes, kind, n_threads, err, errlen
    ("raster_decode", (_I, _VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _VP, _LL,
                       _LL, ctypes.c_char_p, _I, ctypes.c_char_p, _I), _I),
    # lab, n, table, rgb, n_threads, err, errlen
    ("lab_to_rgb", (_VP, _LL, _VP, _VP, _I, ctypes.c_char_p, _I), _I),
)
_ERRLEN = 1024
HEADERS = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")   # classic, BigTIFF; II, MM

COMPRESSION = {1: "none", 2: "ccitt rle", 3: "ccitt group 3", 4: "ccitt group 4", 5: "lzw",
               6: "old-style jpeg", 7: "jpeg", 8: "deflate", 32946: "deflate",
               32773: "packbits", 33003: "jpeg 2000", 33005: "jpeg 2000", 34712: "jpeg 2000"}
_DECODED = (1, 2, 3, 4, 5, 7, 8, 32946, 32773)
_FAX = (2, 3, 4)
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
                4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr", 8: "CIELab",
                9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

# tag numbers
(_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTO, _FILLORDER, _STRIP_OFFSETS, _ORIENTATION,
 _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP, _TILE_W, _TILE_H,
 _TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _SAMPLE_FORMAT, _JPEG_TABLES, _YCBCR_SUB,
 _T4_OPTIONS, _T6_OPTIONS, _YCBCR_COEFFICIENTS, _REFERENCE_BLACK_WHITE) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323, 324,
    325, 338, 339, 347, 530, 292, 293, 529, 532)
_TAGS = {_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTO, _FILLORDER, _STRIP_OFFSETS,
         _ORIENTATION, _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP,
         _TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_COUNTS, _EXTRA, _SAMPLE_FORMAT, _JPEG_TABLES,
         _YCBCR_SUB, _T4_OPTIONS, _T6_OPTIONS, _YCBCR_COEFFICIENTS, _REFERENCE_BLACK_WHITE}
# field type -> (numpy code, bytes a value, values an item)
_FIELD = {1: ("u1", 1, 1), 2: ("u1", 1, 1), 3: ("u2", 2, 1), 4: ("u4", 4, 1),
          5: ("u4", 8, 2), 6: ("i1", 1, 1), 7: ("u1", 1, 1), 8: ("i2", 2, 1),
          9: ("i4", 4, 1), 10: ("i4", 8, 2), 11: ("f4", 4, 1), 12: ("f8", 8, 1),
          13: ("u4", 4, 1), 16: ("u8", 8, 1), 17: ("i8", 8, 1), 18: ("u8", 8, 1)}
# Pillow's ImageOps.exif_transpose, per Orientation value (on the first two axes)
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a.swapaxes(0, 1)[::-1, ::-1], 8: lambda a: np.rot90(a, 1)}

# Pillow 12's TiffImagePlugin.OPEN_INFO, the layouts the reader decodes:
# (photometric, SampleFormat, FillOrder, BitsPerSample, ExtraSamples) ->
# raw mode (io/pillow_modes.py), for both byte orders unless the key has
# one ("<" II, ">" MM) first. Byte order and FillOrder are undone by the
# decoder, so a raw mode here names only the unpacking.
_RAW_MODES = {}


def _open_info(photo, fmt, fills, bps, extra, rawmode, orders="<>"):
    for order in orders:
        for fill in fills:
            _RAW_MODES[(order, photo, fmt, fill, bps, extra)] = rawmode


for _photo, _inv in ((0, "I"), (1, "")):
    _open_info(_photo, (1,), (1, 2), (1,), (), "1;I" if _inv else "1")
    _open_info(_photo, (1,), (1, 2), (2,), (), "L;2" + _inv)
    _open_info(_photo, (1,), (1, 2), (4,), (), "L;4" + _inv)
    _open_info(_photo, (1,), (1, 2), (8,), (), "L;I" if _inv else "L")
_open_info(1, (2,), (1,), (8,), (), "L")
_open_info(1, (1,), (1,), (12,), (), "I;12", "<")
_open_info(0, (1,), (1,), (16,), (), "I;16", "<")          # MinIsWhite: not inverted
_open_info(1, (1,), (1,), (16,), (), "I;16", "<")
_open_info(1, (1,), (2,), (16,), (), "I;16", "<")
_open_info(1, (1,), (1,), (16,), (), "I;16B", ">")
_open_info(1, (2,), (1,), (16,), (), "I;16S")
_open_info(0, (3,), (1,), (32,), (), "F;32F")
_open_info(1, (3,), (1,), (32,), (), "F;32F")
_open_info(1, (1,), (1,), (32,), (), "I;32", "<")
_open_info(1, (2,), (1,), (32,), (), "I;32")
_open_info(1, (1,), (1,), (8, 8), (2,), "LA")
_open_info(2, (1,), (1, 2), (8, 8, 8), (), "RGB")
for _extra, _raw in (((), "RGBA"), ((0,), "RGBX"), ((0, 0), "RGBX"), ((0, 0, 0), "RGBX"),
                     ((1,), "RGBa"), ((1, 0), "RGBa"), ((1, 0, 0), "RGBa"), ((2,), "RGBA"),
                     ((2, 0), "RGBA"), ((2, 0, 0), "RGBA"), ((999,), "RGBA")):
    _open_info(2, (1,), (1,), (8,) * (4 + max(0, len(_extra) - 1)), _extra, _raw)
_open_info(2, (1,), (1,), (16,) * 3, (), "RGB;16")
for _extra, _raw in (((), "RGBA;16"), ((0,), "RGBX;16"), ((1,), "RGBa;16"), ((2,), "RGBA;16")):
    _open_info(2, (1,), (1,), (16,) * 4, _extra, _raw)
for _bits in (1, 2, 4):
    _open_info(3, (1,), (1, 2), (_bits,), (), "P")
_open_info(3, (1,), (1, 2), (8,), (), "P")
_open_info(3, (1,), (1,), (8, 8), (0,), "PX")
_open_info(3, (1,), (1,), (8, 8), (2,), "PA")
_open_info(5, (1,), (1,), (8,) * 4, (), "CMYK")
_open_info(5, (1,), (1,), (8,) * 5, (0,), "CMYK")
_open_info(5, (1,), (1,), (8,) * 6, (0, 0), "CMYK")
_open_info(5, (1,), (1,), (16,) * 4, (), "CMYK;16")
_open_info(6, (1,), (1,), (8,), (), "L")                   # one-sample YCbCr: gray
_open_info(6, (1,), (1,), (8, 8, 8), (), "YCbCr")          # JPEG only (libtiff converts)
_open_info(8, (1,), (1,), (8, 8, 8), (), "LAB")
# Pillow reads an uncompressed planar (PlanarConfiguration 2) file with its
# own decoder, each plane unpacked by one letter of the raw mode: right for
# these 8-bit layouts only (16-bit planes, say, read as 8-bit samples)
_RAW_PLANAR_OK = {"L", "P", "LA", "PA", "RGB", "RGBA", "CMYK"}
# Pillow's raw modes of these big-endian layouts (I;16BS, I;32BS, F;32BF)
# stay big-endian on libtiff's host-order output (compressed files): their
# values read byte-swapped, and the reader swaps them as Pillow does
_LIBTIFF_SWAPPED = {"I;16S", "I;32", "F;32F"}
# YCbCr subsamplings libtiff's RGBA reader converts outside JPEG (hs, vs)
_YCBCR_BLOCKS = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
# uncompressed FillOrder 2 layouts Pillow's own (non-libtiff) decoder has no
# unpacker for (L;IR, P;1R, P;2R, P;4R): (photometric, bits)
_RAW_FILL2_REFUSED = {(0, 8), (3, 1), (3, 2), (3, 4)}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


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


def _layout(page: _Page, h: int, w: int, spp: int, planar: int, bits: int,
            block=(1, 1), height=None):
    """(kind, offsets, counts, geom (n, 6): y0, x0 (bytes), rows, cols
    (bytes), plane, stored rows; stored row bytes, raster row bytes).
    ``block`` (hs, vs): subsampled YCbCr, laid out in data units of hs x vs
    pixels, each a "pixel" of ``spp`` bytes here (h and w count units,
    ``height`` the image's rows)."""
    name = page.name
    hs, vs = block
    height = h if height is None else height
    planes = spp if planar == 2 else 1
    seg_spp = 1 if planar == 2 else spp
    row_bytes = lambda px: -(-px * seg_spp * bits // 8)  # noqa: E731  (rows start on a byte)
    if _TILE_OFFSETS in page.tags:
        kind = "tile"
        tw, th = page.one(_TILE_W, 0), page.one(_TILE_H, 0)
        if tw <= 0 or th <= 0 or tw % hs or th % vs:
            raise ValueError(f"{name}: bad TIFF tile size {tw}x{th}")
        tw, th = tw // hs, th // vs
        if tw * seg_spp * bits % 8:
            raise ValueError(f"{name}: TIFF tiles of {tw} px do not start on a byte")
        offsets, counts = page.get(_TILE_OFFSETS), page.get(_TILE_COUNTS)
        across, down = -(-w // tw), -(-h // th)
        y0 = np.repeat(np.arange(down) * th, across)
        x0 = np.tile(np.arange(across) * tw, down)
        rows, cols = np.minimum(th, h - y0), np.minimum(tw, w - x0)
        stored = np.full_like(y0, th)
        stored_w = tw
    elif _STRIP_OFFSETS in page.tags:
        kind = "strip"
        rps = min(page.one(_ROWS_PER_STRIP, 2 ** 32 - 1), height)
        if rps <= 0:
            raise ValueError(f"{name}: bad TIFF RowsPerStrip {rps}")
        rps = -(-rps // vs)                  # a strip's unit rows (each strip starts a unit)
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
    stored_row = row_bytes(stored_w)
    if counts is None and page.one(_COMPRESSION, 1) == 1:       # uncompressed: implied
        counts = np.tile(stored, planes).astype(np.int64) * stored_row
    if counts is None or len(offsets) < n or len(counts) < n:
        raise ValueError(f"{name}: TIFF lists {len(offsets)} {kind}s with "
                         f"{0 if counts is None else len(counts)} byte counts; "
                         f"{h}x{w} needs {n}")
    offsets = np.ascontiguousarray(offsets[:n], np.int64)
    counts = np.ascontiguousarray(counts[:n], np.int64)
    plane = np.repeat(np.arange(planes) if planar == 2 else np.array([-1]), per_plane)
    x0_bytes = x0 * seg_spp * bits // 8
    cols_bytes = np.minimum(-(-cols * seg_spp * bits // 8), stored_row)
    geom = np.stack([np.tile(y0, planes), np.tile(x0_bytes, planes), np.tile(rows, planes),
                     np.tile(cols_bytes, planes), plane, np.tile(stored, planes)], 1)
    return (kind, offsets, counts, np.ascontiguousarray(geom, np.int32), stored_row,
            row_bytes(w))


def read_tiff(path, n_threads: int = 0) -> tuple:
    """``(mode, pixels, palette)`` of a TIFF's first page (a path or its
    bytes): Pillow's mode and ``np.asarray(Image.open(path))``'s array,
    Orientation applied; ``palette`` ((n, 3) uint8) for ``P`` and ``PA``,
    else None. Strips and tiles decode on ``n_threads`` threads (0: all
    cores); the pixels do not depend on the count. Raises ``ValueError``
    naming the file on a TIFF it does not read (module docstring)."""
    mm, buf, name = _open(path)
    try:
        page = _Page(buf, name)
        out = _decode_page(page, buf, name, n_threads)
        del page
    finally:
        del buf
        _close(mm)
    return out


def decode_tiff(path, n_threads: int = 0) -> np.ndarray:
    """Decode a TIFF's first page (a path or its bytes) to ``(H, W, 3)``
    uint8: ``np.asarray(Image.open(path).convert("RGB"))``'s pixels
    (:func:`read_tiff`, then ``pillow_modes.to_rgb``)."""
    return pillow_modes.to_rgb(*read_tiff(path, n_threads), n_threads=n_threads)


def _format(page: _Page, name: str) -> dict:
    """What the reader needs of a page it decodes (Pillow's key of it, its
    raw mode, the codec's parameters); raises on any other page."""
    h, w = page.one(_LENGTH, 0), page.one(_WIDTH, 0)
    if h <= 0 or w <= 0:
        raise ValueError(f"{name}: bad TIFF size {w}x{h}")
    compression = page.one(_COMPRESSION, 1)
    if compression not in _DECODED:
        what = COMPRESSION.get(compression, "unknown")
        raise ValueError(f"{name}: unsupported TIFF compression {compression} ({what}); "
                         "read: none, CCITT, LZW, Deflate, PackBits, JPEG")
    photo = page.one(_PHOTO, 0)
    fill = page.one(_FILLORDER, 1)
    # Pillow's key (TiffImagePlugin._setup): SampleFormat of all 1s is (1,),
    # one BitsPerSample value stands for every sample, extra ones are cut
    fmt = tuple(int(f) for f in page.get(_SAMPLE_FORMAT, [1]))
    if len(fmt) > 1 and set(fmt) == {1}:
        fmt = (1,)
    spp = page.one(_SPP, 1)
    bps = tuple(int(b) for b in page.get(_BITS, [1]))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    extra = tuple(int(e) for e in page.get(_EXTRA, []))
    rawmode = _RAW_MODES.get((page.order, photo, fmt, fill, bps, extra))
    if len(bps) != spp or rawmode is None:
        raise ValueError(
            f"{name}: unsupported TIFF: photometric {photo} "
            f"({_PHOTOMETRIC.get(photo, 'unknown')}), BitsPerSample {bps}, SampleFormat "
            f"{fmt}, ExtraSamples {extra}, FillOrder {fill} (a layout Pillow has no mode for)")
    if fill == 2 and compression == 1 and (photo, bps[0]) in _RAW_FILL2_REFUSED:
        raise ValueError(f"{name}: unsupported TIFF: uncompressed FillOrder 2 "
                         f"{_PHOTOMETRIC.get(photo, photo)} {bps[0]}-bit samples (Pillow has "
                         "no unpacking for them)")
    planar = page.one(_PLANAR, 1)
    if compression == 1 and planar == 2 and rawmode not in _RAW_PLANAR_OK:
        raise ValueError(f"{name}: unsupported TIFF: uncompressed PlanarConfiguration 2 of "
                         f"{bps} samples (Pillow reads each plane as 8-bit samples)")
    if planar not in (1, 2):
        raise ValueError(f"{name}: bad TIFF PlanarConfiguration {planar}")
    if compression == 7:
        if planar == 2:
            raise ValueError(f"{name}: unsupported TIFF: JPEG with PlanarConfiguration 2")
        if rawmode not in ("L", "RGB", "YCbCr") or photo == 0:
            raise ValueError(f"{name}: unsupported TIFF: JPEG-compressed "
                             f"{_PHOTOMETRIC.get(photo, photo)} samples {bps}")
    elif compression in _FAX and rawmode not in ("1", "1;I"):
        raise ValueError(f"{name}: unsupported TIFF: CCITT compression {compression} of "
                         f"{bps} samples (fax is 1-bit gray)")
    elif rawmode == "YCbCr" and (compression == 1 or planar == 2):
        raise ValueError(f"{name}: unsupported TIFF: YCbCr samples outside JPEG compression, "
                         f"{'uncompressed' if compression == 1 else 'one plane a sample'} "
                         "(Pillow's decoder fails on them)")
    if photo == 3 and _COLORMAP not in page.tags:
        raise ValueError(f"{name}: palette TIFF without a ColorMap")
    predictor = page.one(_PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise ValueError(f"{name}: unsupported TIFF Predictor {predictor}"
                         + (" (floating point)" if predictor == 3 else ""))
    bits = bps[0]
    block = (1, 1)
    if rawmode == "YCbCr" and compression != 7:
        block = tuple(int(v) for v in page.get(_YCBCR_SUB, [2, 2])[:2])
        if block not in _YCBCR_BLOCKS or predictor != 1 or page.one(_ORIENTATION, 1) != 1:
            raise ValueError(f"{name}: unsupported TIFF: YCbCr subsampling {block}, Predictor "
                             f"{predictor}, Orientation {page.one(_ORIENTATION, 1)} outside "
                             "JPEG (libtiff reads subsamplings 1, 2 and 4 only, and the port "
                             "no predictor or Orientation there)")
    if predictor == 2 and bits not in (8, 16, 32):
        raise ValueError(f"{name}: unsupported TIFF: Predictor 2 on {bits}-bit samples")
    fax_options = page.one(_T4_OPTIONS if compression == 3 else _T6_OPTIONS, 0)
    if compression in (3, 4) and fax_options & 2:
        raise ValueError(f"{name}: unsupported TIFF: CCITT uncompressed mode")
    orientation = page.one(_ORIENTATION, 1)
    if orientation not in range(1, 9):
        raise ValueError(f"{name}: bad TIFF Orientation {orientation}")
    return {"h": h, "w": w, "spp": spp, "photo": photo, "compression": compression,
            "planar": planar, "predictor": predictor, "bits": bits, "fmt": fmt[0],
            "rawmode": rawmode, "reverse": fill == 2 and compression != 7,
            "swap": compression != 1 and page.order == ">" and rawmode in _LIBTIFF_SWAPPED,
            "fax_options": fax_options if compression == 3 else 0, "block": block,
            "orientation": orientation}


def _samples(raster: np.ndarray, f: dict, order: str) -> np.ndarray:
    """The raster's stored bytes ((planes, H, row bytes)) as sample values
    (H, W, spp) in the dtype :func:`pillow_modes.unpack` takes."""
    h, w, bits = f["h"], f["w"], f["bits"]
    per = 1 if f["planar"] == 2 else f["spp"]
    if bits not in (8, 16, 32):                # packed MSB first: 1, 2, 4 or 12 bits
        b = np.unpackbits(raster, axis=-1)[..., :w * per * bits]
        b = b.reshape(raster.shape[0], h, w * per, bits)
        dtype = np.uint8 if bits < 8 else np.uint16
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(dtype)
        vals = (b * weights).sum(-1, dtype=dtype)
    elif bits == 8:
        vals = raster[..., :w * per]
    else:
        code = {(16, 1): "u2", (16, 2): "i2", (32, 1): "u4", (32, 2): "i4", (32, 3): "f4"}
        raw = raster[..., :w * per * bits // 8]
        if f["swap"]:                        # as Pillow reads them (_LIBTIFF_SWAPPED)
            order = "<"
        vals = np.ascontiguousarray(raw).view(order + code[(bits, f["fmt"])])
        vals = vals.astype(vals.dtype.newbyteorder("="), copy=False)
        if bits == 32 and f["fmt"] == 1:     # Pillow's I;32N: unsigned read as int32
            vals = vals.view(np.int32)
    if f["planar"] == 2:                     # (planes, H, W) -> (H, W, planes)
        return np.ascontiguousarray(np.moveaxis(vals, 0, -1))
    return vals.reshape(h, w, per)


def _decode_page(page: _Page, buf: np.ndarray, name: str, n_threads: int) -> tuple:
    f = _format(page, name)
    h, w, spp, planar, bits = f["h"], f["w"], f["spp"], f["planar"], f["bits"]
    hs, vs = f["block"]
    if f["rawmode"] == "YCbCr" and f["compression"] != 7:   # data units of hs x vs pixels
        period = f["h"] if _TILE_OFFSETS in page.tags else min(
            page.one(_ROWS_PER_STRIP, f["h"]), f["h"])
        f["period"] = period if period % vs else None         # rows a unit grid restarts at
        last = f["h"] - (-(-f["h"] // period) - 1) * period
        h = (-(-f["h"] // period) - 1) * -(-period // vs) + -(-last // vs)
        w, spp = -(-w // hs), hs * vs + 2
    kind, offsets, counts, geom, stored_row, out_row = _layout(page, h, w, spp, planar, bits,
                                                               (hs, vs), f["h"])
    seg_w = page.one(_TILE_W, w) if kind == "tile" else w
    if int((offsets + counts).max(initial=0)) > buf.size:
        bad = int(np.argmax(offsets + counts > buf.size))
        raise ValueError(f"{name}: truncated TIFF: {kind} {bad} lies past the end of the file")
    if int(counts.min(initial=1)) <= 0:
        raise ValueError(f"{name}: TIFF {kind} {int(np.argmin(counts))} is empty")
    compression, rawmode = f["compression"], f["rawmode"]
    if compression == 7:
        oc = 1 if rawmode == "L" else 3
        out = np.zeros((h, w, oc), np.uint8)
        px = geom.copy()                     # the codec places pixels, not bytes
        px[:, 1] //= spp
        px[:, 3] //= spp
        decode_jpeg_segments(page.tags.get(_JPEG_TABLES, b""), buf, offsets, counts, px,
                             out, colour=1 if f["photo"] == 2 else 0, kind=kind, name=name,
                             n_threads=n_threads)
        mode, pixels = ("L", out[..., 0]) if oc == 1 else ("RGB", out)
    else:
        planes = spp if planar == 2 else 1
        raster = np.zeros((planes, h, out_row), np.uint8)
        params = (stored_row, bits // 8, 1 if planar == 2 else spp, f["predictor"],
                  int(page.order == ">"), int(f["reverse"]), f["fax_options"], seg_w)
        _decode_segments(compression, buf, offsets, counts, geom, params, raster, kind, name,
                         n_threads)
        if rawmode == "YCbCr":
            if (hs, vs) == (4, 4):
                _libtiff_4x4_quirks(compression, buf, offsets, counts, geom, params, raster,
                                    kind, name, page.one(_TILE_W, 0))
            mode, pixels = "RGB", _libtiff_ycbcr_rgb(raster[0], page, f)
        else:
            samples = _samples(raster, f, page.order)[..., :len(rawmode.split(";")[0])]
            if samples.shape[-1] == 1:       # the samples the raw mode names
                samples = samples[..., 0]
            mode, pixels = pillow_modes.unpack(rawmode, samples)
        del raster
    palette = None
    if mode in ("P", "PA"):                  # Pillow's RGB;L palette of the ColorMap, >> 8
        cmap = page.tags[_COLORMAP]
        n = len(cmap) // 3
        palette = (cmap[:3 * n].reshape(3, n).T >> 8).astype(np.uint8)
    if f["orientation"] != 1:
        pixels = _ORIENT[f["orientation"]](pixels)
    return mode, np.ascontiguousarray(pixels), palette


def _decode_segments(compression, buf, offsets, counts, geom, params, raster, kind, name,
                     n_threads) -> None:
    """Strips or tiles of a codec other than JPEG into ``raster`` ((planes,
    rows, row bytes)): Deflate through ``zlib`` on a pool, the rest in the C
    library. ``params``: the C library's stored_row, sample_bytes, spp,
    predictor, big, reverse, fax_options, fax_width."""
    if compression in (8, 32946):
        _inflate_segments(buf, offsets, counts, geom, params, raster, kind, name, n_threads)
        return
    out_row = raster.shape[2]
    err = ctypes.create_string_buffer(_ERRLEN)
    if _lib().raster_decode(compression, buf.ctypes.data, offsets.ctypes.data,
                            counts.ctypes.data, geom.ctypes.data, len(offsets), *params,
                            raster.ctypes.data, out_row, raster.shape[1] * out_row,
                            kind.encode(), int(n_threads), err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")


def _libtiff_4x4_quirks(compression, buf, offsets, counts, geom, params, raster, kind, name,
                        tile_w) -> None:
    """What libtiff's RGBA reader does to 4x4-subsampled YCbCr (units of
    18 bytes), and Pillow shows: a strip is read as its rows times a
    scanline of floor(unit row bytes / 4), so the strip's last bytes stay
    zero; a tile cut by the image's right edge skips ``(tw - w) / 4`` units
    of 10 bytes, not 18, after each unit row (tif_getimage.c's
    putcontig8bitYCbCr44tile), so its later unit rows start early."""
    stored_row = params[0]
    if kind == "strip":
        if stored_row % 4:
            for y0, rows in geom[:, [0, 2]]:
                strip = raster[0, y0:y0 + rows].reshape(-1)
                strip[rows * 4 * (stored_row // 4):] = 0
        return
    for i in np.flatnonzero(geom[:, 3] < stored_row):          # tiles cut on the right
        y0, x0, rows, cols, _, stored = (int(v) for v in geom[i])
        whole = np.zeros((1, stored, stored_row), np.uint8)    # the tile's own unit rows
        one = np.array([[0, 0, stored, stored_row, -1, stored]], np.int32)
        _decode_segments(compression, buf, offsets[i:i + 1], counts[i:i + 1], one, params,
                         whole, kind, name, 1)
        stream = whole.reshape(-1)
        skip = (tile_w - cols // 18 * 4) // 4 * 10 if cols // 18 * 4 < tile_w else 0
        pitch = cols + skip
        for r in range(rows):
            raster[0, y0 + r, x0:x0 + cols] = stream[r * pitch:r * pitch + cols]


def _libtiff_ycbcr_tables(luma, ref) -> tuple:
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c) in its float32 arithmetic:
    (Y, Cr_r, Cb_b, Cr_g, Cb_g) tables of 256 int64 each."""
    f32 = np.float32
    red, green, blue = (f32(v) for v in luma)

    def fix(x):                     # (int32_t)((x) * (1L << 16) + 0.5): float, then double
        return int(float(f32(x) * f32(65536)) + 0.5)

    def clamp(x, lo, hi):
        return lo if x < lo else hi if x > hi else x

    def code2v(c, rb, rw, cr):      # ((c - (int32_t)RB) * (float)CR) / (float)(RW - RB)
        span = f32(rw) - f32(rb)
        return f32(f32(c - int(rb)) * f32(cr)) / (span if span != 0 else f32(1))

    f1 = f32(2) - f32(2) * red
    f2 = red * f1 / green
    f3 = f32(2) - f32(2) * blue
    f4 = blue * f3 / green
    d1, d2 = fix(clamp(f1, f32(0), f32(2))), -fix(clamp(f2, f32(0), f32(2)))
    d3, d4 = fix(clamp(f3, f32(0), f32(2))), -fix(clamp(f4, f32(0), f32(2)))
    lim = f32(128 * 32)
    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, f32(ref[4]) - f32(128), f32(ref[5]) - f32(128), 127), -lim, lim))
        cb = int(clamp(code2v(x, f32(ref[2]) - f32(128), f32(ref[3]) - f32(128), 127), -lim, lim))
        tabs[:, i] = (int(clamp(code2v(x + 128, f32(ref[0]), f32(ref[1]), 255), -lim, lim)),
                      (d1 * cr + (1 << 15)) >> 16, (d3 * cb + (1 << 15)) >> 16, d2 * cr,
                      d4 * cb + (1 << 15))
    return tuple(tabs)


def _rationals(page: _Page, tag: int, default) -> list:
    v = page.get(tag)
    if v is None:
        return default
    v = np.asarray(v, np.float64).reshape(-1, 2)
    return [float(np.float32(n / d)) if d else 0.0 for n, d in v]


def _libtiff_ycbcr_rgb(units: np.ndarray, page: _Page, f: dict) -> np.ndarray:
    """Pillow's pixels of subsampled YCbCr outside JPEG, which it reads
    through libtiff's RGBA interface: each data unit's hs x vs Y samples
    with the unit's Cb and Cr (no interpolation, as tif_getimage.c's
    putcontig8bitYCbCr tiles), converted by TIFFYCbCrtoRGB's tables from
    the YCbCrCoefficients and ReferenceBlackWhite tags (or their
    defaults)."""
    hs, vs = f["block"]
    rows, cols = units.shape[0], units.shape[1] // (hs * vs + 2)
    u = units[:, :cols * (hs * vs + 2)].reshape(rows, cols, hs * vs + 2)
    y = np.arange(f["h"])
    if f.get("period"):             # strips of rows not a multiple of vs: a grid a strip
        period = f["period"]
        unit_row = y // period * -(-period // vs) + y % period // vs
        sub = y % period % vs
    else:
        unit_row, sub = y // vs, y % vs
    ys = u[..., :hs * vs].reshape(rows, cols, vs, hs)[unit_row, :, sub]
    y = ys.reshape(f["h"], cols * hs)[:, :f["w"]]
    cb = np.repeat(u[unit_row, :, hs * vs], hs, 1)[:, :f["w"]]
    cr = np.repeat(u[unit_row, :, hs * vs + 1], hs, 1)[:, :f["w"]]
    ytab, cr_r, cb_b, cr_g, cb_g = _libtiff_ycbcr_tables(
        _rationals(page, _YCBCR_COEFFICIENTS, [0.299, 0.587, 0.114]),
        _rationals(page, _REFERENCE_BLACK_WHITE, [0, 255, 128, 255, 128, 255]))
    yy = ytab[y]
    rgb = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _inflate_segments(buf, offsets, counts, geom, params, raster, kind, name,
                      n_threads) -> None:
    """Deflate strips or tiles: each task inflates a run of segments with
    ``zlib`` (no GIL while it inflates) and places them with the C library's
    uncompressed route (its predictor undone there), so at most a run's
    inflated bytes a thread are held at once. ``params``: the C library's
    stored_row, sample_bytes, spp, predictor, big, reverse, fax_options,
    fax_width."""
    lib = _lib()
    stored_row, reverse = params[0], params[5]
    params = params[:5] + (0,) + params[6:]  # the bits are reversed here, before zlib
    want = geom[:, 5].astype(np.int64) * stored_row
    # runs of about 4 MB of pixels, at least 4 runs a thread when there are enough
    n = len(offsets)
    threads = n_threads if n_threads > 0 else (os.cpu_count() or 1)
    per_run = max(1, min(int((4 << 20) // max(1, int(want.max()))), -(-n // (4 * threads))))
    runs = [range(i, min(n, i + per_run)) for i in range(0, n, per_run)]
    out_row = raster.shape[2]
    plane_bytes = raster.shape[1] * out_row

    def run(segs):
        err = ctypes.create_string_buffer(_ERRLEN)
        zero = np.zeros(1, np.int64)
        for i in segs:
            d = zlib.decompressobj()
            seg = buf[offsets[i]:offsets[i] + counts[i]]
            if reverse:
                seg = _REVERSED[seg]
            try:
                data = d.decompress(seg, int(want[i]))
            except zlib.error as e:
                raise ValueError(f"{name}: {kind} {i}: corrupt Deflate data ({e})") from None
            if len(data) < want[i]:
                raise ValueError(f"{name}: {kind} {i}: Deflate data ends after {len(data)} of "
                                 f"{int(want[i])} bytes")
            size = np.array([len(data)], np.int64)
            if lib.raster_decode(1, data, zero.ctypes.data, size.ctypes.data,
                                 geom[i].ctypes.data, 1, *params, raster.ctypes.data, out_row,
                                 plane_bytes, kind.encode(), 1, err, _ERRLEN):
                raise ValueError(f"{name}: {kind} {i}: {err.value.decode()}")

    if threads == 1 or len(runs) == 1:
        for r in runs:
            run(r)
        return
    with ThreadPoolExecutor(min(threads, len(runs))) as pool:
        for f in [pool.submit(run, r) for r in runs]:
            f.result()
