#!/usr/bin/env python3
"""Write the TIFF and PNG readers' fixtures: small seeded slides, written
by Pillow or assembled here, and the pixels Pillow decodes from them.

    python tools/make_tiff_fixtures.py        # writes tests/data/tiff/

The port's readers (``gridnext_tpu_torch/io/tiff.py``, ``io/png.py``) are
held to Pillow where Pillow is absent (a GPU machine) through these
files: ``chip_smoke.py`` phase 22 (a) and ``tests/test_torch_cuda.py``
decode each file to its ``decoded_<name>``, which is
``np.asarray(Image.open(f).convert("RGB"))``. ``tests/test_torch_tiff.py``
runs :func:`fixtures` again and checks the committed files still equal
it.

Pillow writes stripped TIFF (none, LZW, Deflate, PackBits, JPEG with
JPEGTables, BigTIFF) and PNG with its own filter choice. What Pillow
cannot write is assembled by :func:`assemble_tiff` from segments that
Pillow's libtiff encodes (:func:`pillow_segment`: one strip of a file
Pillow writes), and every assembled file is read back by Pillow before it
is kept: tiles (64 px, edge tiles cropped), a big-endian file, YCbCr JPEG
tiles with shared JPEGTables, the old Deflate code 32946, one plane a
sample, a MinIsWhite page and an Orientation tag; and, held to Pillow's
other modes, 1-, 2-, 4- and 16-bit, signed, float and CMYK samples in
either byte order (:func:`pack_samples`, :func:`horizontal_differences`,
:func:`packbits`), FillOrder 2 and progressive JPEG tiles.
:func:`assemble_png` writes PNGs of every colour type and depth whose rows
cycle through all five filter types, Adam7-interlaced on request (Pillow
cannot write Adam7).
"""

from __future__ import annotations

import io
import json
import os
import struct
import sys
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                   "data", "tiff")


def wide(shape, seed: int, dtype=np.uint16) -> np.ndarray:
    """A seeded 16- or 32-bit test image: ``image`` in the high byte and
    noise below (so both the ``>> 8`` and the clipping conversions show),
    with a corner of small values (0 to 300, where clipping and ``>> 8``
    differ most)."""
    rng = np.random.default_rng(seed)
    hi = image(shape, seed).astype(np.int64)
    if np.dtype(dtype).kind == "f":
        out = (hi * 1.6 - 60 + rng.random(hi.shape)).astype(dtype)
    else:
        out = hi << 8 | rng.integers(0, 256, hi.shape)
        if np.dtype(dtype).kind == "i":
            out = out - 32768
    out = out.astype(dtype)
    corner = (np.arange(8).reshape(2, 4) * 43)[:out.shape[0], :out.shape[1]]
    out[:2, :4] = corner[(...,) + (None,) * (out.ndim - 2)]
    return out


def pack_samples(samples: np.ndarray, bits: int, order: str = "<") -> np.ndarray:
    """Rows of stored bytes ((h, row bytes) uint8) of ``samples`` ((h, w) or
    (h, w, c)) at ``bits`` a sample: sub-byte samples packed MSB first,
    each row starting on a byte (also 12-bit ones); 16- and 32-bit ones in
    byte ``order``."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if bits not in (8, 16, 32):
        b = (flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1
        return np.packbits(b.reshape(h, -1).astype(np.uint8), axis=1)
    if bits == 8:
        return np.ascontiguousarray(flat, np.uint8)
    return np.ascontiguousarray(flat.astype(flat.dtype.newbyteorder(order))).view(np.uint8)


def horizontal_differences(samples: np.ndarray) -> np.ndarray:
    """TIFF Predictor 2 of integer ``samples`` ((h, w, c)): each sample minus
    the one to its left, modulo its range."""
    out = samples.copy()
    out[:, 1:] = samples[:, 1:] - samples[:, :-1]
    return out


def ycbcr_units(samples: np.ndarray, hs: int, vs: int) -> bytes:
    """TIFF's subsampled YCbCr data units of ``samples`` ((h, w, 3): Y, Cb,
    Cr): for each hs x vs block, row-major, its hs * vs Y samples and the
    block's first Cb and Cr, the image edge-padded to whole blocks."""
    h, w = samples.shape[:2]
    p = np.pad(samples, ((0, -h % vs), (0, -w % hs), (0, 0)), mode="edge")
    rows, cols = p.shape[0] // vs, p.shape[1] // hs
    blocks = p.reshape(rows, vs, cols, hs, 3).transpose(0, 2, 1, 3, 4)
    units = np.concatenate([blocks[..., 0].reshape(rows, cols, vs * hs),
                            blocks[:, :, 0, 0, 1:]], -1)
    return units.astype(np.uint8).tobytes()


def packbits(data: bytes) -> bytes:
    """PackBits (TIFF 32773) of ``data``: runs of 3 or more equal bytes
    repeated, the rest as literals of at most 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def image(shape, seed: int) -> np.ndarray:
    """A seeded uint8 test image of ``(h, w)`` or ``(h, w, c)`` (c up to 4):
    gradients plus uniform noise."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * x // 5 + y) % 256, (y * 11) % 256,
                     (x * 13 + 40) % 256], -1)
    img = ((base + rng.integers(0, 64, (h, w, 4))) % 256).astype(np.uint8)
    return img[..., 0] if len(shape) == 2 else np.ascontiguousarray(img[..., :shape[2]])


# ---- TIFF ----------------------------------------------------------------

_PIL_COMPRESSION = {1: "raw", 5: "tiff_lzw", 8: "tiff_adobe_deflate", 32773: "packbits",
                    7: "jpeg"}


def pillow_segment(pixels: np.ndarray, compression: int, predictor: int = 1,
                   quality: int = 75) -> tuple:
    """``(bytes, jpegtables or None)``: ``pixels`` ((h, w) or (h, w, c))
    encoded by Pillow's libtiff as the one strip of a file, to be placed as
    a strip or a tile of an assembled file."""
    from PIL import Image

    if pixels.ndim == 3 and pixels.shape[2] == 1:
        pixels = pixels[..., 0]
    mode = "L" if pixels.ndim == 2 else {3: "RGB", 4: "RGBA"}[pixels.shape[2]]
    info = {278: pixels.shape[0]}
    if predictor != 1:
        info[317] = predictor
    buf = io.BytesIO()
    kw = {"quality": quality} if compression == 7 else {}
    Image.fromarray(pixels, mode).save(buf, "TIFF", compression=_PIL_COMPRESSION[compression],
                                       tiffinfo=info, **kw)
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        (off,), (count,) = im.tag_v2[273], im.tag_v2[279]
        if im.tag_v2.get(317, 1) != predictor:
            raise RuntimeError("Pillow did not write the predictor")
        tables = im.tag_v2.get(347)
    return buf.getvalue()[off:off + count], tables


def assemble_tiff(shape, segments, *, compression: int, photometric: int, tile=None,
                  rows_per_strip=None, bigtiff: bool = False, byteorder: str = "<",
                  extra=(), predictor: int = 1, planar: int = 1, colormap=None,
                  jpegtables=None, ycbcr_subsampling=None, orientation=None,
                  bits: int = 8, sample_format=None, fill_order=None, more_tags=None) -> bytes:
    """The bytes of a one-page TIFF of ``shape`` ((h, w, samples)) whose
    strips (``rows_per_strip``) or tiles (``tile`` = (width, length)) are
    ``segments`` in order (per plane for ``planar`` 2), each already
    encoded. Classic or BigTIFF, ``"<"`` (II) or ``">"`` (MM)."""
    h, w, spp = shape
    o = byteorder
    off_type, off_code = (16, "Q") if bigtiff else (4, "I")
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in colormap])
    if jpegtables is not None:
        tags[347] = (7, jpegtables)
    if ycbcr_subsampling is not None:
        tags[530] = (3, list(ycbcr_subsampling))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if fill_order is not None:
        tags[266] = (3, [fill_order])
    tags.update(more_tags or {})         # {tag: (type, values)}; RATIONAL (5) as pairs
    header = (b"II" if o == "<" else b"MM") + (
        struct.pack(o + "HHHQ", 43, 8, 0, 0) if bigtiff else struct.pack(o + "HI", 42, 0))
    data = bytearray(header)
    offsets, counts = [], []
    for seg in segments:
        offsets.append(len(data))
        counts.append(len(seg))
        data += seg
        if len(data) % 2:
            data += b"\0"
    if tile is not None:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (off_type, offsets),
                     325: (off_type, counts)})
    else:
        tags.update({273: (off_type, offsets), 278: (4, [rows_per_strip or h]),
                     279: (off_type, counts)})
    code = {3: "H", 4: "I", 5: "II", 16: "Q"}
    inline = 8 if bigtiff else 4
    entries = []
    for tag in sorted(tags):
        ftype, values = tags[tag]
        flat = [v for pair in values for v in pair] if ftype == 5 else values
        raw = bytes(values) if ftype == 7 else struct.pack(o + code[ftype] * len(values), *flat)
        if len(raw) > inline:
            ref = len(data)
            data += raw + (b"\0" if len(raw) % 2 else b"")
            raw = struct.pack(o + off_code, ref)
        entries.append((tag, ftype, len(values), raw.ljust(inline, b"\0")))
    ifd = len(data)
    count_fmt, n_fmt = ("Q", "Q") if bigtiff else ("I", "H")
    data += struct.pack(o + n_fmt, len(entries))
    for tag, ftype, count, raw in entries:
        data += struct.pack(o + "HH" + count_fmt, tag, ftype, count) + raw
    data += struct.pack(o + off_code, 0)
    struct.pack_into(o + off_code, data, 8 if bigtiff else 4, ifd)
    return bytes(data)


def set_short_tag(data: bytes, tag: int, value: int) -> bytes:
    """A classic little-endian TIFF with the first page's SHORT ``tag`` (one
    value, already present) set to ``value``."""
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    out = bytearray(data)
    for k in range(n):
        at = ifd + 2 + 12 * k
        if struct.unpack("<HHI", data[at:at + 8]) == (tag, 3, 1):
            struct.pack_into("<H", out, at + 8, value)
            return bytes(out)
    raise KeyError(f"no SHORT tag {tag}")


def tiles_of(pixels: np.ndarray, tw: int, th: int):
    """Row-major tiles of ``pixels`` (h, w, c), edge tiles zero-padded to
    tw x th (as libtiff pads them)."""
    h, w = pixels.shape[:2]
    for y in range(0, h, th):
        for x in range(0, w, tw):
            t = np.zeros((th, tw) + pixels.shape[2:], np.uint8)
            part = pixels[y:y + th, x:x + tw]
            t[:part.shape[0], :part.shape[1]] = part
            yield t


def split_jpeg_tables(stream: bytes) -> tuple:
    """``(tables, abbreviated)`` of a JFIF stream: its DQT and DHT segments
    as a tables-only stream (SOI ... EOI), and the stream without them and
    without APPn segments (SOI, SOF, SOS, data, EOI)."""
    tables, rest = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    pos = 2
    while True:
        marker = stream[pos + 1]
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        seg = stream[pos:pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        pos += 2 + length
        if marker == 0xDA:
            rest += stream[pos:]
            return bytes(tables + b"\xff\xd9"), bytes(rest)


def jpeg_tiles(pixels: np.ndarray, tw: int, th: int, quality: int = 75) -> tuple:
    """``(jpegtables, segments)``: each tile of ``pixels`` as a 4:2:0 YCbCr
    JPEG by Pillow, its tables moved to one shared JPEGTables (Pillow's
    standard tables: equal across tiles)."""
    from PIL import Image

    tables, segs = None, []
    for t in tiles_of(pixels, tw, th):
        buf = io.BytesIO()
        Image.fromarray(t).save(buf, "JPEG", quality=quality)
        tab, seg = split_jpeg_tables(buf.getvalue())
        if tables not in (None, tab):
            raise RuntimeError("tiles with different JPEG tables")
        tables = tab
        segs.append(seg)
    return tables, segs


# ---- PNG -----------------------------------------------------------------

def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(payload, zlib.crc32(ctype))))


def png_filter(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG scanlines of ``rows`` ((h, row_bytes) uint8), row y filtered with
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, n = rows.shape
    x = rows.astype(np.int32)
    out = bytearray()
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros(n, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros(n, np.int32)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(f)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    return bytes(out)


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def assemble_png(pixels: np.ndarray, colour: int, filters=(0, 1, 2, 3, 4), palette=None,
                 trns=None, depth: int = 8, interlace: int = 0, idat_parts: int = 2) -> bytes:
    """A PNG of ``pixels`` ((h, w) or (h, w, c) samples: uint8 up to 8 bits,
    uint16 at 16) of colour type ``colour`` at ``depth`` bits, its rows
    cycling through ``filters`` (each Adam7 pass anew when ``interlace``),
    the zlib stream split over ``idat_parts`` IDAT chunks; PLTE from
    ``palette`` ((n, 3)), a tRNS chunk of ``trns`` bytes."""
    h, w = pixels.shape[:2]
    c = 1 if pixels.ndim == 2 else pixels.shape[2]
    bpp = max(1, c * depth // 8)

    def scanlines(px):
        return png_filter(pack_samples(px, depth, ">"), bpp, filters)

    if interlace:
        raw = b"".join(scanlines(pixels[y0::dy, x0::dx]) for y0, x0, dy, dx in ADAM7
                       if h > y0 and w > x0)
    else:
        raw = scanlines(pixels)
    data = zlib.compress(raw, 6)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                               0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    step = -(-len(data) // idat_parts)
    for i in range(0, len(data), step):
        out += _chunk(b"IDAT", data[i:i + step])
    return out + _chunk(b"IEND", b"")


# ---- the fixtures ----------------------------------------------------------

def _pillow_tiff(pixels, mode, compression, info=None, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(pixels)
    if im.mode != mode:
        im = Image.fromarray(pixels, mode)
    if mode == "P":
        im.putpalette(list(image((16, 48), 99).reshape(-1)))
    im.save(buf, "TIFF", compression=compression, tiffinfo=info or {}, **kw)
    return buf.getvalue()


def _pillow_png(pixels, mode) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(pixels)
    (im if im.mode == mode else Image.fromarray(pixels, mode)).save(buf, "PNG")
    return buf.getvalue()


def _cases() -> dict:
    """{name: (file bytes, what it holds)}."""
    cases = {}
    rgb = image((33, 33, 3), 1)
    odd = image((17, 40, 3), 2)
    cases["rgb17x40_raw.tif"] = (_pillow_tiff(odd, "RGB", "raw", {278: 5}),
                                 "RGB, uncompressed, 5-row strips (the last short)")
    cases["rgb33_lzw.tif"] = (_pillow_tiff(rgb, "RGB", "tiff_lzw"), "RGB, LZW, one strip")
    cases["rgb33_lzw_pred.tif"] = (_pillow_tiff(rgb, "RGB", "tiff_lzw", {317: 2, 278: 8}),
                                   "RGB, LZW, Predictor 2, 8-row strips")
    cases["rgb17x40_deflate.tif"] = (_pillow_tiff(odd, "RGB", "tiff_adobe_deflate", {278: 4}),
                                     "RGB, Adobe Deflate (8), 4-row strips")
    cases["rgb40x17_packbits.tif"] = (
        _pillow_tiff(np.ascontiguousarray(odd.transpose(1, 0, 2)), "RGB", "packbits",
                     {278: 7}), "RGB, PackBits, 7-row strips")
    cases["rgb48x40_jpeg.tif"] = (
        _pillow_tiff(image((48, 40, 3), 3), "RGB", "jpeg", {278: 16}, quality=80),
        "JPEG, Photometric RGB, JPEGTables, 16-row strips")
    cases["gray45x31_lzw.tif"] = (_pillow_tiff(image((45, 31), 4), "L", "tiff_lzw", {278: 10}),
                                  "gray, LZW, 10-row strips")
    cases["rgba33_deflate.tif"] = (_pillow_tiff(image((33, 33, 4), 5), "RGBA",
                                                "tiff_adobe_deflate"),
                                   "RGBA (unassociated alpha), Deflate")
    cases["pal33_packbits.tif"] = (_pillow_tiff(image((33, 33), 6), "P", "packbits"),
                                   "palette (16-bit ColorMap), PackBits")
    cases["big33_lzw.tif"] = (_pillow_tiff(rgb, "RGB", "tiff_lzw", {278: 11}, big_tiff=True),
                              "BigTIFF, RGB, LZW")
    # assembled: tiles, the other byte order, YCbCr JPEG tiles, 32946, planes
    tiled = image((90, 100, 3), 7)
    segs = [pillow_segment(t, 5, predictor=2)[0] for t in tiles_of(tiled, 64, 64)]
    cases["rgb90x100_tiled_lzw_pred.tif"] = (
        assemble_tiff(tiled.shape, segs, compression=5, photometric=2, tile=(64, 64),
                      predictor=2), "RGB, 64-px tiles (edge tiles cropped), LZW, Predictor 2")
    segs = [zlib.compress(t.tobytes()) for t in tiles_of(tiled[:70], 64, 64)]
    cases["big70x100_tiled_deflate.tif"] = (
        assemble_tiff((70, 100, 3), segs, compression=32946, photometric=2, tile=(64, 64),
                      bigtiff=True), "BigTIFF, 64-px tiles, Deflate (32946)")
    mm = image((33, 33, 3), 8)
    segs = [pillow_segment(mm[y:y + 12], 5)[0] for y in range(0, 33, 12)]
    cases["rgb33_bigendian_lzw.tif"] = (
        assemble_tiff(mm.shape, segs, compression=5, photometric=2, rows_per_strip=12,
                      byteorder=">"), "big-endian (MM), RGB, LZW, 12-row strips")
    ycc = image((100, 90, 3), 9)
    tables, segs = jpeg_tiles(ycc, 64, 64)
    cases["ycbcr100x90_jpeg_tiled.tif"] = (
        assemble_tiff(ycc.shape, segs, compression=7, photometric=6, tile=(64, 64),
                      jpegtables=tables, ycbcr_subsampling=(2, 2)),
        "JPEG, Photometric YCbCr 4:2:0, 64-px tiles, shared JPEGTables")
    planes = image((21, 26, 3), 10)
    segs = [zlib.compress(planes[y:y + 8, :, c].tobytes())
            for c in range(3) for y in range(0, 21, 8)]
    cases["rgb21x26_planar_deflate.tif"] = (
        assemble_tiff(planes.shape, segs, compression=8, photometric=2, rows_per_strip=8,
                      planar=2), "RGB, one plane a sample (PlanarConfiguration 2), Deflate")
    white = image((19, 23), 11)
    cases["gray19x23_miniswhite.tif"] = (
        assemble_tiff((19, 23, 1), [white.tobytes()], compression=1, photometric=0),
        "gray MinIsWhite, uncompressed")
    turned = image((24, 37, 3), 12)
    cases["rgb24x37_orient6.tif"] = (
        assemble_tiff(turned.shape, [zlib.compress(turned.tobytes())], compression=8,
                      photometric=2, orientation=6), "RGB, Deflate, Orientation 6")
    # PNG: every filter type, and Pillow's own
    cases["gray17x40.png"] = (assemble_png(image((17, 40), 13), 0), "gray, filters 0-4")
    cases["rgb33.png"] = (assemble_png(image((33, 33, 3), 14), 2), "RGB, filters 0-4")
    cases["rgba33.png"] = (assemble_png(image((33, 33, 4), 15), 6, filters=(4, 3, 2, 1, 0)),
                           "RGBA, filters 4-0")
    cases["graya20x21.png"] = (assemble_png(image((20, 21, 2), 16), 4), "gray + alpha")
    pal = image((60, 3), 17)
    idx = image((33, 33), 18)                        # indices past the 60 entries occur
    cases["pal33.png"] = (assemble_png(idx, 3, palette=pal, trns=bytes(range(10))),
                          "palette of 60 entries (indices past it), tRNS, filters 0-4")
    cases["rgb31x29_pillow.png"] = (_pillow_png(image((31, 29, 3), 19), "RGB"),
                                    "RGB, Pillow's filters")
    cases.update(_mode_cases())
    return cases


def _tiff_of(samples, bits, *, compression=1, photometric, order="<", predictor=1, extra=(),
             sample_format=None, fill_order=None, rows_per_strip=None, tile=None,
             colormap=None) -> bytes:
    """An assembled TIFF of ``samples`` ((h, w, c)) at ``bits``: raw,
    PackBits or Deflate strips (or tiles), the predictor and FillOrder
    applied to the stored bytes as a writer would."""
    h, w, c = samples.shape
    if predictor == 2:
        samples = horizontal_differences(samples)
    parts = ([(0, h, samples)] if tile is None and rows_per_strip is None else
             [(y, y + rows_per_strip, samples[y:y + rows_per_strip])
              for y in range(0, h, rows_per_strip)] if tile is None else None)
    if tile is not None:
        padded = np.zeros((-(-h // tile[1]) * tile[1], -(-w // tile[0]) * tile[0], c),
                          samples.dtype)
        padded[:h, :w] = samples
        pieces = [padded[y:y + tile[1], x:x + tile[0]] for y in range(0, h, tile[1])
                  for x in range(0, w, tile[0])]
    else:
        pieces = [p for _, _, p in parts]
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    segs = []
    for piece in pieces:
        raw = pack_samples(piece, bits, order).tobytes()
        seg = {1: raw, 8: zlib.compress(raw), 32773: packbits(raw)}[compression]
        if fill_order == 2:
            seg = rev[np.frombuffer(seg, np.uint8)].tobytes()
        segs.append(seg)
    return assemble_tiff((h, w, c), segs, compression=compression, photometric=photometric,
                         byteorder=order, predictor=predictor, extra=extra, bits=bits,
                         sample_format=sample_format, fill_order=fill_order,
                         rows_per_strip=rows_per_strip, tile=tile, colormap=colormap)


def _mode_cases() -> dict:
    """The files of Pillow's other modes: bit depths 1 to 32, CMYK, FillOrder
    2, progressive JPEG tiles; PNG at every depth and Adam7."""
    from PIL import Image

    cases = {}
    g16 = wide((23, 30), 40)
    cases["gray16_raw.tif"] = (_pillow_tiff(g16, "I;16", "raw"), "16-bit gray (I;16), raw")
    cases["gray16_lzw_pred.tif"] = (_pillow_tiff(g16, "I;16", "tiff_lzw", {317: 2, 278: 8}),
                                    "16-bit gray, LZW, Predictor 2")
    cases["gray16_be_deflate_pred.tif"] = (
        _tiff_of(g16[..., None], 16, compression=8, photometric=1, order=">", predictor=2,
                 rows_per_strip=7), "16-bit gray big-endian (I;16B), Deflate, Predictor 2")
    cases["gray16_signed_be.tif"] = (
        _tiff_of(wide((17, 21), 41, np.int16)[..., None], 16, photometric=1, order=">",
                 sample_format=2), "16-bit signed gray big-endian (I;16BS), raw")
    f32 = wide((19, 26), 42, np.float32)
    cases["float32_lzw.tif"] = (_pillow_tiff(f32, "F", "tiff_lzw"), "32-bit float gray, LZW")
    cases["float32_be.tif"] = (_tiff_of(f32[..., None], 32, photometric=1, order=">",
                                        sample_format=3), "32-bit float gray big-endian, raw")
    cases["gray32_uint.tif"] = (_tiff_of(wide((9, 13), 43, np.uint32)[..., None], 32,
                                         photometric=1), "32-bit unsigned gray (I;32N), raw")
    cases["gray8_signed.tif"] = (_tiff_of(image((9, 14, 1), 44), 8, photometric=1,
                                          sample_format=2), "8-bit signed gray (read as L)")
    rgb16 = wide((21, 33, 3), 45)
    cases["rgb16_deflate_pred.tif"] = (
        _tiff_of(rgb16, 16, compression=8, photometric=2, predictor=2, rows_per_strip=5),
        "16-bit RGB, Deflate, Predictor 2, 5-row strips")
    cases["rgb16_be_packbits_tiled.tif"] = (
        _tiff_of(rgb16, 16, compression=32773, photometric=2, order=">", tile=(16, 16)),
        "16-bit RGB big-endian, PackBits, 16-px tiles")
    rgba16 = wide((18, 20, 4), 46)
    cases["rgba16_raw.tif"] = (_tiff_of(rgba16, 16, photometric=2, extra=(2,)),
                               "16-bit RGBA (unassociated), raw")
    cases["rgba16_assoc_be_deflate.tif"] = (
        _tiff_of(rgba16, 16, compression=8, photometric=2, order=">", extra=(1,)),
        "16-bit RGBA associated alpha, big-endian, Deflate")
    cmyk = np.asarray(Image.fromarray(image((20, 27, 3), 47)).convert("CMYK"))
    cases["cmyk_lzw.tif"] = (_pillow_tiff(cmyk, "CMYK", "tiff_lzw"), "CMYK, LZW")
    cases["cmyk16_be_deflate.tif"] = (
        _tiff_of(wide((15, 19, 4), 48), 16, compression=8, photometric=5, order=">"),
        "16-bit CMYK big-endian, Deflate")
    bilevel = image((27, 37), 49) > 127
    cases["bilevel_raw.tif"] = (_pillow_tiff(bilevel, "1", "raw"), "1-bit, raw")
    cases["bilevel_white_packbits.tif"] = (
        _tiff_of(bilevel[..., None].astype(np.uint8), 1, compression=32773, photometric=0,
                 rows_per_strip=10), "1-bit MinIsWhite, PackBits, 10-row strips")
    cases["bilevel_deflate_fill2.tif"] = (
        _tiff_of(bilevel[..., None].astype(np.uint8), 1, compression=8, photometric=1,
                 fill_order=2), "1-bit, Deflate, FillOrder 2")
    cases["gray2_deflate.tif"] = (_tiff_of(image((13, 22, 1), 50) >> 6, 2, compression=8,
                                           photometric=1), "2-bit gray, Deflate")
    cases["gray4_white_raw.tif"] = (_tiff_of(image((13, 23, 1), 51) >> 4, 4, photometric=0),
                                    "4-bit gray MinIsWhite, raw")
    pal = image((16, 3), 52).astype(np.uint16) * 257
    cases["pal4_packbits.tif"] = (
        _tiff_of(image((17, 19, 1), 53) >> 4, 4, compression=32773, photometric=3,
                 colormap=pal.T.reshape(-1)), "4-bit palette (16-entry ColorMap), PackBits")
    cases["rgb_fill2_raw.tif"] = (_tiff_of(image((11, 14, 3), 54), 8, photometric=2,
                                           fill_order=2), "RGB, raw, FillOrder 2")
    cases["gray_fill2_deflate.tif"] = (
        _tiff_of(image((12, 15, 1), 55), 8, compression=8, photometric=1, fill_order=2),
        "gray, Deflate, FillOrder 2")
    prog = image((70, 90, 3), 56)
    tiles = []
    for t in tiles_of(prog, 32, 32):
        buf = io.BytesIO()
        Image.fromarray(t).save(buf, "JPEG", quality=80, progressive=True)
        tiles.append(buf.getvalue())
    cases["ycbcr_prog_jpeg_tiles.tif"] = (
        assemble_tiff(prog.shape, tiles, compression=7, photometric=6, tile=(32, 32),
                      ycbcr_subsampling=(2, 2)), "JPEG, YCbCr, progressive 32-px tiles")
    fax = image((45, 61), 73) > 110
    for comp, info, name, what in (
            ("group4", {}, "bilevel_g4.tif", "1-bit, CCITT Group 4"),
            ("group3", {278: 16}, "bilevel_g3.tif", "1-bit, CCITT Group 3 1-D, 16-row strips"),
            ("group3", {292: 5}, "bilevel_g3_2d.tif",
             "1-bit, CCITT Group 3 2-D, EOLs byte-aligned"),
            ("tiff_ccitt", {}, "bilevel_ccitt_rle.tif", "1-bit, CCITT Modified Huffman (2)"),
            ("group4", {266: 2}, "bilevel_g4_fill2.tif", "1-bit, CCITT Group 4, FillOrder 2")):
        cases[name] = (_pillow_tiff(fax, "1", comp, info), what)
    cases["bilevel_g4_white.tif"] = (
        set_short_tag(_pillow_tiff(fax, "1", "group4"), 262, 0),
        "1-bit MinIsWhite, CCITT Group 4 (bits as decoded: 1 black)")
    ycc = image((29, 37, 3), 74)
    cases["ycbcr22_deflate.tif"] = (
        assemble_tiff(ycc.shape, [zlib.compress(ycbcr_units(ycc[y:y + 8], 2, 2))
                                  for y in range(0, 29, 8)], compression=8, photometric=6,
                      rows_per_strip=8, ycbcr_subsampling=(2, 2)),
        "YCbCr 2x2 outside JPEG (libtiff's RGBA route), Deflate, 8-row strips")
    tiles = [packbits(ycbcr_units(t, 4, 4)) for t in tiles_of(ycc, 16, 16)]
    cases["ycbcr44_tiled_packbits.tif"] = (
        assemble_tiff(ycc.shape, tiles, compression=32773, photometric=6, tile=(16, 16),
                      ycbcr_subsampling=(4, 4)),
        "YCbCr 4x4, PackBits, 16-px tiles (libtiff's skew of the right edge tiles)")
    # PNG at every depth, and Adam7
    cases["gray1_pillow.png"] = (_pillow_png(bilevel, "1"), "1-bit gray (Pillow)")
    p2 = Image.fromarray(image((19, 21), 57) % 4, "P")
    p2.putpalette([0, 0, 0, 90, 30, 200, 180, 180, 40, 255, 255, 255])
    buf = io.BytesIO()
    p2.save(buf, "PNG")
    cases["pal2_pillow.png"] = (buf.getvalue(), "2-bit palette (Pillow)")
    cases["gray2.png"] = (assemble_png(image((11, 13), 58) >> 6, 0, depth=2), "2-bit gray")
    cases["gray4.png"] = (assemble_png(image((16, 16), 59) >> 4, 0, depth=4), "4-bit gray")
    cases["pal4_trns.png"] = (assemble_png(image((14, 17), 60) >> 4, 3, depth=4,
                                           palette=image((12, 3), 61), trns=b"\0\x80"),
                              "4-bit palette of 12 (indices past it), tRNS")
    cases["gray16_pillow.png"] = (_pillow_png(wide((15, 18), 62), "I;16"),
                                  "16-bit gray (Pillow's I;16: clipped)")
    cases["rgb16.png"] = (assemble_png(wide((13, 17, 3), 63), 2, depth=16), "16-bit RGB")
    cases["rgba16.png"] = (assemble_png(wide((12, 15, 4), 64), 6, depth=16), "16-bit RGBA")
    cases["graya16.png"] = (assemble_png(wide((14, 11, 2), 65), 4, depth=16),
                            "16-bit gray + alpha (Pillow: RGBA)")
    cases["adam7_rgb.png"] = (assemble_png(image((16, 16, 3), 66), 2, interlace=1),
                              "RGB, Adam7")
    cases["adam7_gray1_5x9.png"] = (assemble_png(image((5, 9), 67) >> 7, 0, depth=1,
                                                 interlace=1), "1-bit gray, Adam7, 5x9")
    cases["adam7_pal4.png"] = (assemble_png(image((21, 19), 68) >> 4, 3, depth=4, interlace=1,
                                            palette=image((16, 3), 69)),
                               "4-bit palette, Adam7")
    cases["adam7_rgba16_10x7.png"] = (assemble_png(wide((10, 7, 4), 70), 6, depth=16,
                                                   interlace=1), "16-bit RGBA, Adam7")
    cases["adam7_graya_1x1.png"] = (assemble_png(image((1, 1, 2), 71), 4, interlace=1),
                                    "gray + alpha, Adam7, 1x1 (six empty passes)")
    cases["adam7_gray16_3x2.png"] = (assemble_png(wide((3, 2), 72), 0, depth=16, interlace=1),
                                     "16-bit gray, Adam7, 3x2")
    cases.update(_lab_cases())
    return cases


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """8-bit CIELab samples of sRGB pixels as a TIFF stores them (L * 255 /
    100, then a* and b* as two's-complement bytes): the sRGB curve (a
    table), the D50-adapted sRGB matrix and CIE's Lab formula in float32,
    rounding. Any encoder serves: what is held is the readers' conversion
    of these samples."""
    c = np.arange(256) / 255.0
    curve = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)
    m = np.array([[0.4360747, 0.3850649, 0.1430804], [0.2225045, 0.7168786, 0.0606169],
                  [0.0139322, 0.0971045, 0.7141733]]) / np.array([[0.9642], [1.0], [0.8249]])
    xyz = curve[rgb.reshape(-1, 3)] @ m.T.astype(np.float32)
    f = np.where(xyz > np.float32(216 / 24389), np.cbrt(xyz),
                 (np.float32(24389 / 27) * xyz + 16) / 116)
    out = np.empty(xyz.shape, np.uint8)
    out[:, 0] = np.clip(np.rint((116 * f[:, 1] - 16) * np.float32(2.55)), 0, 255)
    ab = np.stack([500 * (f[:, 0] - f[:, 1]), 200 * (f[:, 1] - f[:, 2])], -1)
    out[:, 1:] = np.clip(np.rint(ab), -128, 127).astype(np.int8).view(np.uint8)
    return out.reshape(rgb.shape)


def _lab_cases() -> dict:
    """CIELab (Photometric 8) files: random samples over the whole cube
    (out of gamut too), Pillow's own Lab TIFF, Predictor 2, tiles, and a
    smooth image through :func:`rgb_to_lab`."""
    from PIL import Image

    cases = {}
    cube = image((23, 29, 3), 75)
    cases["lab_raw.tif"] = (_tiff_of(cube, 8, photometric=8), "CIELab, uncompressed")
    buf = io.BytesIO()
    Image.fromarray(image((26, 21, 3), 76), "LAB").save(buf, "TIFF",
                                                       compression="tiff_adobe_deflate")
    cases["lab_pillow_deflate.tif"] = (buf.getvalue(), "CIELab written by Pillow, Deflate")
    cases["lab_deflate_pred.tif"] = (
        _tiff_of(image((19, 31, 3), 77), 8, compression=8, photometric=8, predictor=2,
                 rows_per_strip=7), "CIELab, Deflate, Predictor 2, 7-row strips")
    cases["lab_tiled_packbits_be.tif"] = (
        _tiff_of(image((40, 37, 3), 78), 8, compression=32773, photometric=8, order=">",
                 tile=(16, 16)), "CIELab, big-endian, PackBits, 16-px tiles")
    cases["lab_from_rgb.tif"] = (_tiff_of(rgb_to_lab(image((32, 32, 3), 79)), 8,
                                          compression=8, photometric=8),
                                 "CIELab of an RGB image (rgb_to_lab), Deflate")
    return cases


def fixtures() -> dict:
    """``{name: {"data": bytes, "decoded": Pillow's RGB pixels, "what"}}``;
    raises if Pillow does not read an assembled file."""
    import warnings

    from PIL import Image

    out = {}
    for name, (data, what) in _cases().items():
        with Image.open(io.BytesIO(data)) as im, warnings.catch_warnings():
            warnings.simplefilter("ignore")          # the palette PNG's tRNS
            decoded = np.asarray(im.convert("RGB"))
        out[name] = {"data": data, "decoded": decoded, "what": what}
    return out


def load(directory: str = OUT) -> dict:
    """The committed fixtures, in :func:`fixtures`' form (no PIL needed)."""
    with open(os.path.join(directory, "cases.json")) as fh:
        cases = json.load(fh)
    arrays = np.load(os.path.join(directory, "pixels.npz"))
    out = {}
    for name, what in cases.items():
        with open(os.path.join(directory, name), "rb") as fh:
            out[name] = {"data": fh.read(), "decoded": arrays[f"decoded_{name}"], "what": what}
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    fx = fixtures()
    for name, f in fx.items():
        with open(os.path.join(OUT, name), "wb") as fh:
            fh.write(f["data"])
    np.savez_compressed(os.path.join(OUT, "pixels.npz"),
                        **{f"decoded_{name}": f["decoded"] for name, f in fx.items()})
    with open(os.path.join(OUT, "cases.json"), "w") as fh:
        json.dump({name: f["what"] for name, f in fx.items()}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {len(fx)} fixtures to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
