#!/usr/bin/env python3
"""Write the JPEG codec's fixtures: small JPEGs encoded by Pillow or made
here, the pixels they encode and the pixels Pillow decodes from them.

    python tools/make_jpeg_fixtures.py        # writes tests/data/jpeg/

The port's codec (``gridnext_tpu_torch/io/jpeg.py``) is held to Pillow
where Pillow is absent (a GPU machine) through these files:
``chip_smoke.py`` phase 21 (a) and ``tests/test_torch_cuda.py`` decode
each ``<name>.jpg`` to its ``decoded_<name>`` and encode the
``pixels_<name>`` of the 4:2:0 and gray cases without restart markers
(what the encoder writes: Pillow's defaults) to the file's bytes.
``tests/test_torch_jpeg.py`` runs
:func:`fixtures` again and checks the committed files still equal
Pillow's output. The images are seeded numpy patterns: smooth gradients
under noise, so every DCT band and Huffman code length occurs.

Pillow writes baseline and progressive files (libjpeg's simple
progression) at 4:4:4, 4:2:2 and 4:2:0, gray and CMYK. The rest is made
by ``tools/jpeg_transcode.cpp`` (built with ``g++`` at first use into
``tools/_build/``): :func:`write_coefficients` entropy-codes quantised
DCT coefficients that :func:`coefficients` computes here (sampling factors
h1v2, h4v1, h4v2, YCCK and RGB under an Adobe marker), and
:func:`transcode` rewrites a file's own coefficients under another scan
script (unrefined and DC-only scripts, spectral selection with one DC
scan a component and restart markers), as ``jpegtran`` does. Pillow's
decode of every file is recorded beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(TOOLS), "tests", "data", "jpeg")

# name, shape, quality, subsampling (the codec's name; Pillow's number),
# restart_marker_blocks (0: none)
CASES = (
    ("rgb33_q75", (33, 33, 3), 75, "4:2:0", 0),
    ("rgb128_q75", (128, 128, 3), 75, "4:2:0", 0),
    ("rgb100x64_q95_444", (100, 64, 3), 95, "4:4:4", 0),
    ("rgb17x40_q75_422", (17, 40, 3), 75, "4:2:2", 0),
    ("gray45x31_q75", (45, 31), 75, "4:2:0", 0),
    ("rgb48_q90_rst3", (48, 48, 3), 90, "4:2:0", 3),
)
_PIL_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def image(shape, seed: int) -> np.ndarray:
    """A seeded uint8 test image: gradients plus uniform noise."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * x // 5 + y) % 256, (y * 11) % 256], -1)
    img = ((base + rng.integers(0, 64, (h, w, 3))) % 256).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


# ---- the coefficient writer and transcoder (tools/jpeg_transcode.cpp) ----

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def transcoder():
    """The loaded ``tools/jpeg_transcode.cpp``, built with ``$CXX`` or
    ``g++`` into ``tools/_build/`` at first use (the name carries a hash of
    the source)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = os.path.join(TOOLS, "jpeg_transcode.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    build = os.path.join(TOOLS, "_build")
    lib = os.path.join(build, f"libjpeg_transcode-{digest}.so")
    if not os.path.exists(lib):
        os.makedirs(build, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        res = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o",
                              tmp, src],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"build of jpeg_transcode.cpp failed:\n{res.stderr}")
        os.replace(tmp, lib)
    _LIB = ctypes.CDLL(lib)
    _LIB.jt_transcode.argtypes = [_VP, _LL, _I, _I, _VP, _VP, _VP, ctypes.c_char_p, _I]
    _LIB.jt_write.argtypes = [_I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _I,
                              _I, _VP, _VP, _VP, ctypes.c_char_p, _I]
    _LIB.jt_write_lossless.argtypes = [_VP, _I, _I, _I, _VP, _I, _I, _I, _I, _VP, _LL, _VP,
                                       _VP, ctypes.c_char_p, _I]
    _LIB.jt_free.argtypes = [_VP]
    return _LIB


_LIB = None


def _bytes_of(lib, status, out, n, err) -> bytes:
    if status:
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jt_free(out)


#: libjpeg's default arithmetic conditioning: (L, U, Kx) of tables 0 and 1
DAC_DEFAULT = (0, 1, 5, 0, 1, 5)


def transcode(data: bytes, script: int, restart: int = 0, arith=None) -> bytes:
    """A sequential Huffman JPEG's coefficients rewritten under scan
    ``script`` (``tools/jpeg_transcode.cpp``: 0 sequential, 1 libjpeg's
    simple progression, 2 unrefined, 3 DC only below AC 10, 4 spectral
    selection with one DC scan a component) with a restart marker every
    ``restart`` MCUs: the same pixels, other bytes. ``arith``: arithmetic
    coding (SOF9 or SOF10, as ``jpegtran -arithmetic`` writes) with
    :data:`DAC_DEFAULT` (True) or the given (L, U, Kx) of tables 0 and 1
    (component 0 codes with table 0, the others with table 1)."""
    lib = transcoder()
    out, n, err = ctypes.c_void_p(), ctypes.c_longlong(), ctypes.create_string_buffer(512)
    dac = np.ascontiguousarray(DAC_DEFAULT if arith is True else (arith or DAC_DEFAULT),
                               np.int32)
    status = lib.jt_transcode(data, len(data), script, restart,
                              dac.ctypes.data if arith else None, ctypes.byref(out),
                              ctypes.byref(n), err, 512)
    return _bytes_of(lib, status, out, n, err)


def write_lossless(pixels: np.ndarray, predictor: int, pt: int = 0, restart_rows: int = 0,
                   interleaved: bool = True, ids=None, app: bytes = b"") -> bytes:
    """A lossless (SOF3) JPEG of (H, W) or (H, W, C) uint8 ``pixels``
    (``tools/jpeg_transcode.cpp``'s own writer: libjpeg-turbo 2.1 cannot
    write one): ``predictor`` 1-7, point transform ``pt``, a restart every
    ``restart_rows`` rows, one scan or one a component, component ``ids``
    (default 1, 2, ...), ``app`` after SOI."""
    lib = transcoder()
    px = np.ascontiguousarray(pixels, np.uint8)
    h, w = px.shape[:2]
    nc = 1 if px.ndim == 2 else px.shape[2]
    ids = np.ascontiguousarray(ids or range(1, nc + 1), np.int32)
    out, n, err = ctypes.c_void_p(), ctypes.c_longlong(), ctypes.create_string_buffer(512)
    status = lib.jt_write_lossless(px.ctypes.data, h, w, nc, ids.ctypes.data, predictor, pt,
                                   restart_rows, int(interleaved), app, len(app),
                                   ctypes.byref(out), ctypes.byref(n), err, 512)
    return _bytes_of(lib, status, out, n, err)


def adobe_segment(transform: int) -> bytes:
    """An APP14 Adobe segment (version 100, no flags) naming ``transform``
    (0 none: RGB or CMYK; 1 YCbCr; 2 YCCK)."""
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
           23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40,
         57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35,
         55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
         100, 103, 99)
_CHROMA = (17, 18, 24, 47) + (99,) * 4 + (18, 21, 26, 66) + (99,) * 4 + (24, 26, 56) + \
    (99,) * 5 + (47, 66) + (99,) * 38


def quant_table(basic, quality: int) -> np.ndarray:
    """An Annex K table (natural order) under the IJG quality scaling."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(basic, np.int64) * scale + 50) // 100, 1, 255).astype(np.uint16)


def coefficients(planes, factors, tables, tq) -> list:
    """Quantised DCT blocks of full-resolution component ``planes`` (each
    (H, W) of sample values 0-255) at sampling ``factors`` ((h, v) each):
    each component box-downsampled, edge-replicated to whole MCUs, the
    orthonormal 8x8 DCT of (sample - 128) divided by its table ``tables[tq[c]]``
    and rounded. Returns the components as ``write_coefficients`` takes
    them."""
    H, W = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    if len(planes) == 1:
        hmax = vmax = 1
        factors = [(1, 1)]
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.where(
        k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    comps = []
    for c, (plane, (h, v)) in enumerate(zip(planes, factors)):
        sy, sx = vmax // v, hmax // h
        dh, dw = -(-H * v // vmax), -(-W * h // hmax)
        padded = np.pad(np.asarray(plane, np.float64), ((0, dh * sy - H), (0, dw * sx - W)),
                        mode="edge")
        small = padded.reshape(dh, sy, dw, sx).mean(axis=(1, 3))
        bh, bw = mcuy * v, mcux * h
        full = np.pad(small, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge") - 128
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        dct = np.einsum("ui,abij,vj->abuv", basis, blocks, basis)
        q = tables[tq[c]].reshape(8, 8).astype(np.float64)
        comps.append({"id": c + 1, "h": h, "v": v, "tq": tq[c],
                      "coef": np.rint(dct / q).astype(np.int16).reshape(bh, bw, 64)})
    return comps


def write_coefficients(width: int, height: int, comps, tables, app: bytes = JFIF,
                       script: int = 0, restart: int = 0, arith=None) -> bytes:
    """A JPEG of ``comps`` (dicts of ``id``, ``h``, ``v``, ``tq`` and
    ``coef``, ``(bh, bw, 64)`` int16 in natural order) under ``tables``
    ({table number: 64 values, natural order}), ``app`` copied after SOI,
    written under scan ``script`` and ``arith`` (as :func:`transcode`)."""
    lib = transcoder()
    n = len(comps)
    ints = lambda key: np.array([c[key] for c in comps], np.int32)  # noqa: E731
    ids, h, v, tq = ints("id"), ints("h"), ints("v"), ints("tq")
    coefs = [np.ascontiguousarray(c["coef"], np.int16) for c in comps]
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in coefs])
    qt = np.zeros((4, 64), np.uint16)
    used = np.zeros(4, np.int32)
    for t, table in tables.items():
        qt[t] = table
        used[t] = 1
    out, size, err = ctypes.c_void_p(), ctypes.c_longlong(), ctypes.create_string_buffer(512)
    dac = np.ascontiguousarray(DAC_DEFAULT if arith is True else (arith or DAC_DEFAULT),
                               np.int32)
    status = lib.jt_write(width, height, n, ids.ctypes.data, h.ctypes.data, v.ctypes.data,
                          tq.ctypes.data, ptrs, qt.ctypes.data, used.ctypes.data, app, len(app),
                          script, restart, dac.ctypes.data if arith else None,
                          ctypes.byref(out), ctypes.byref(size), err, 512)
    return _bytes_of(lib, status, out, size, err)


def ycbcr(rgb: np.ndarray) -> list:
    """JFIF's YCbCr planes (float) of an (H, W, 3) image."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def _made(shape, seed, factors, quality, colour="ycbcr", script=0, restart=0) -> tuple:
    """(bytes, source pixels) of a file this tool writes: ``colour``
    "ycbcr" (JFIF), "rgb" (Adobe 0), "cmyk" (Adobe 0) or "ycck" (Adobe 2)."""
    c = 4 if colour in ("cmyk", "ycck") else 3
    pixels = image(shape[:2] + (3,), seed)
    if c == 4:
        pixels = np.concatenate([pixels, image(shape[:2], seed + 1)[..., None]], -1)
    if colour == "ycbcr":
        planes, app = ycbcr(pixels), JFIF
    elif colour == "ycck":       # YCbCr of the inverted C, M, Y, and K
        planes, app = ycbcr(255 - pixels[..., :3]) + [pixels[..., 3]], adobe_segment(2)
    else:
        planes, app = [pixels[..., i] for i in range(c)], adobe_segment(0)
    tables = {0: quant_table(_LUMA, quality), 1: quant_table(_CHROMA, quality)}
    tq = [0] + [1] * (c - 1) if colour in ("ycbcr", "ycck") else [0] * c
    if colour == "ycck":
        tq[3] = 0
    comps = coefficients(planes, factors, tables, tq)
    return write_coefficients(shape[1], shape[0], comps, {t: tables[t] for t in set(tq)}, app,
                              script, restart), pixels


def _pillow(pixels, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _more_cases() -> dict:
    """{name: (bytes, source pixels, what)}: the files beyond baseline
    YCbCr and gray."""
    from PIL import Image

    out = {}
    rgb = image((40, 48, 3), 20)
    out["prog_rgb40x48_q80"] = (_pillow(rgb, quality=80, progressive=True), rgb,
                                "progressive (Pillow: simple progression), 4:2:0")
    gray = image((33, 35), 21)
    out["prog_gray33x35_q75"] = (_pillow(gray, progressive=True), gray, "progressive gray")
    odd = image((35, 29, 3), 22)
    out["prog_rgb35x29_444_rst2"] = (
        _pillow(odd, quality=90, subsampling=0, progressive=True, restart_marker_blocks=2),
        odd, "progressive 4:4:4, restart markers every 2 MCUs")
    cmyk = np.asarray(Image.fromarray(image((24, 30, 3), 23)).convert("CMYK"))
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=85)
    out["cmyk24x30_q85"] = (buf.getvalue(), cmyk, "CMYK (Pillow: Adobe, inverted)")
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=70, progressive=True)
    out["prog_cmyk24x30_q70"] = (buf.getvalue(), cmyk, "progressive CMYK")
    for name, shape, factors in (("h1v2_rgb37x30", (37, 30), [(1, 2), (1, 1), (1, 1)]),
                                 ("h4v1_rgb19x45", (19, 45), [(4, 1), (1, 1), (1, 1)]),
                                 ("h4v2_rgb35x41", (35, 41), [(4, 2), (1, 1), (1, 1)]),
                                 ("h2v2_cb1x2_rgb26x34", (26, 34), [(2, 2), (1, 2), (2, 1)])):
        data, px = _made(shape, len(out) + 30, factors, 80)
        out[name] = (data, px, f"YCbCr, sampling {factors} (written here)")
    data, px = _made((30, 26), 40, [(2, 2), (1, 1), (1, 1), (2, 2)], 85, "ycck")
    out["ycck_h2v2_30x26"] = (data, px, "YCCK (Adobe 2), Y and K 2x2 (written here)")
    data, px = _made((21, 27), 41, [(1, 1)] * 4, 90, "cmyk", script=1)
    out["prog_cmyk_adobe_21x27"] = (data, px, "progressive CMYK, Adobe 0 (written here)")
    data, px = _made((25, 33), 42, [(2, 1), (1, 1), (1, 1)], 85, "rgb")
    out["rgb_adobe0_h2v1_25x33"] = (data, px, "RGB components (Adobe 0), 2x1 (written here)")
    data, px = _made((35, 41), 43, [(4, 2), (1, 1), (1, 1)], 75, script=1)
    out["prog_h4v2_rgb35x41"] = (data, px, "progressive, sampling 4x2 (written here)")
    base = _pillow(image((48, 56, 3), 44), quality=75)
    px = image((48, 56, 3), 44)
    out["unrefined_rgb48x56"] = (transcode(base, 2), px,
                                 "progressive, AC 1-5 left at Al 1: block smoothing")
    out["dconly_rgb48x56"] = (transcode(base, 3), px,
                              "progressive, AC 1-9 never sent: smoothing with DC interpolation")
    out["spectral_rst_rgb48x56"] = (
        transcode(base, 4, restart=3), px,
        "progressive, spectral selection only, a DC scan a component, restart every 3 MCUs")
    g = _pillow(image((41, 39), 45), quality=60)
    out["unrefined_gray41x39"] = (transcode(g, 2, restart=5), image((41, 39), 45),
                                  "progressive gray, unrefined, restart every 5 MCUs")
    out.update(_arithmetic_cases())
    out.update(_lossless_cases())
    out.update(_damaged_cases())
    return out


#: non-default DAC conditioning: (L, U, Kx) of tables 0 and 1
DAC_WIDE = (2, 4, 2, 1, 3, 30)


def _arithmetic_cases() -> dict:
    """Arithmetic-coded files (SOF9, SOF10): the coefficients of Huffman
    files rewritten by the transcoder (each decodes as its Huffman twin)."""
    out = {}
    px = image((32, 40, 3), 50)
    b420 = _pillow(px, quality=80)
    b444 = _pillow(px, quality=70, subsampling=0)
    gray = _pillow(px[..., 1], quality=75)
    cases = (("arith_seq_420", b420, 0, 0, True, "sequential, 4:2:0"),
             ("arith_prog_420", b420, 1, 0, True, "progressive (simple progression), 4:2:0"),
             ("arith_seq_444_rst2", b444, 0, 2, True, "sequential, 4:4:4, restart every 2 MCUs"),
             ("arith_prog_444_rst3", b444, 1, 3, True, "progressive, 4:4:4, restart every 3"),
             ("arith_seq_gray_dac", gray, 0, 0, DAC_WIDE, "sequential gray, DAC L 2 U 4 Kx 2"),
             ("arith_prog_420_dac", b420, 1, 0, DAC_WIDE, "progressive, DAC on both tables"),
             ("arith_unrefined_gray_rst5", gray, 2, 5, True,
              "progressive gray, unrefined (block smoothing), restart every 5"),
             ("arith_spectral_420_rst3", b420, 4, 3, DAC_WIDE,
              "progressive, spectral selection, a DC scan a component, restart every 3"))
    for name, base, script, restart, arith, what in cases:
        out[name] = (transcode(base, script, restart, arith), px, f"arithmetic {what}")
    data, cmyk = _made((24, 30), 51, [(1, 1)] * 4, 85, "cmyk")
    for script, kind in ((0, "seq"), (1, "prog")):
        out[f"arith_{kind}_cmyk"] = (transcode(data, script, 0, True), cmyk,
                                     f"arithmetic {kind} CMYK, Adobe 0 (written here)")
    return out


def _lossless_cases() -> dict:
    """Lossless (SOF3) files of the transcoder's own writer: predictors 1-7,
    point transforms, restarts, one scan a component, gray, RGB by
    component ids and CMYK."""
    out = {}
    rgb = image((24, 30, 3), 60)
    for psv in range(1, 8):
        out[f"lossless_p{psv}_rgb"] = (write_lossless(rgb, psv), rgb,
                                       f"lossless, predictor {psv}, RGB (ids 1 2 3)")
    gray = image((27, 22), 61)
    out["lossless_p4_pt1_gray"] = (write_lossless(gray, 4, pt=1), gray,
                                   "lossless gray, predictor 4, Pt 1")
    out["lossless_p7_pt1_rst4"] = (write_lossless(rgb, 7, pt=1, restart_rows=4), rgb,
                                   "lossless, predictor 7, Pt 1, restart every 4 rows")
    out["lossless_p6_scans_rgbids"] = (
        write_lossless(rgb, 6, interleaved=False, ids=[82, 71, 66]), rgb,
        "lossless, predictor 6, a scan a component, ids R G B")
    cmyk = image((20, 18, 3), 62)
    cmyk = np.concatenate([cmyk, cmyk[..., :1] ^ 0x5A], -1)
    out["lossless_p5_cmyk"] = (write_lossless(cmyk, 5, restart_rows=3), cmyk,
                               "lossless CMYK, predictor 5, restart every 3 rows")
    return out


def cut_scan(data: bytes, fraction: float, last: bool = True) -> bytes:
    """``data`` with the entropy-coded data of its last (or first) scan cut
    at ``fraction`` and the rest of the file kept from the next marker on:
    a data segment that ends early, which libjpeg decodes with a warning."""
    sos = data.rindex(b"\xff\xda") if last else data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    end = start
    while not (data[end] == 0xFF and data[end + 1] not in (0x00, 0xFF)):
        end += 1
    return data[:start + int((end - start) * fraction)] + data[end:]


def garbled(data: bytes, fraction: float, n: int = 12, value: int = 0x13) -> bytes:
    """``data`` with ``n`` bytes of its last scan's data overwritten."""
    sos = data.rindex(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    i = start + int((len(data) - 2 - start) * fraction)
    return data[:i] + bytes([value]) * n + data[i + n:]


def _damaged_cases() -> dict:
    """Files whose entropy-coded data ends early at a marker or is
    overwritten: Pillow decodes them (libjpeg warns) and so must the port."""
    px = image((32, 40, 3), 50)
    b420 = _pillow(px, quality=80)
    prog = _pillow(px, quality=80, progressive=True)
    rst = _pillow(px, quality=80, restart_marker_blocks=2)
    arith = transcode(b420, 0, 0, True)
    arith_prog = transcode(b420, 1, 0, True)
    arith_rst = transcode(b420, 0, 2, True)
    first = rst.index(b"\xff\xd1")
    arith_first = arith_rst.index(b"\xff\xd1")
    cases = (("cut_huffman", cut_scan(b420, 0.6), "Huffman data cut at 60 %, then EOI"),
             ("cut_huffman_rst", rst[:first - 9] + rst[first:],
              "Huffman restart interval cut short before RST1"),
             ("cut_progressive_first", cut_scan(prog, 0.5, last=False),
              "progressive, the first scan cut at 50 %"),
             ("cut_arith", cut_scan(arith, 0.6), "arithmetic data cut at 60 %, then EOI"),
             ("cut_arith_rst", arith_rst[:arith_first - 20] + arith_rst[arith_first:],
              "arithmetic restart interval cut short before RST1"),
             ("cut_arith_prog_first", cut_scan(arith_prog, 0.5, last=False),
              "arithmetic progressive, the first scan cut at 50 %"),
             ("garbled_huffman", garbled(b420, 0.5), "12 Huffman data bytes overwritten"),
             ("garbled_arith", garbled(arith, 0.5), "12 arithmetic data bytes overwritten"))
    return {name: (data, px, what) for name, data, what in cases}


def refused() -> dict:
    """``{name: (bytes, pattern)}``: files Pillow refuses too, and what the
    port's message must say: truncated files (no EOI: Pillow's "image file
    is truncated" or "broken data stream"), arithmetic lossless (SOF11),
    hierarchical (SOF13), lossless YCbCr and 12-bit samples."""
    px = image((32, 40, 3), 50)
    b420 = _pillow(px, quality=80)
    arith = transcode(b420, 0, 0, True)
    lossless = write_lossless(px, 1)
    sof = b420.index(b"\xff\xc0")
    return {
        "truncated_huffman": (cut_scan(b420, 0.6)[:-2], "truncated"),
        "truncated_arith": (cut_scan(arith, 0.6)[:-2], "truncated"),
        "truncated_no_eoi": (b420[:-2], "no EOI"),
        "sof11_arith_lossless": (lossless.replace(b"\xff\xc3", b"\xff\xcb", 1),
                                 r"arithmetic-coded lossless \(SOF11\)"),
        "sof13_hierarchical": (arith.replace(b"\xff\xc9", b"\xff\xcd", 1),
                               r"differential sequential \(SOF13\)"),
        "lossless_ycbcr": (write_lossless(px, 1, app=JFIF), "lossless with a colour transform"),
        "bits12": (b420[:sof + 4] + b"\x0c" + b420[sof + 5:], "12-bit samples"),
    }


def fixtures() -> dict:
    """``{name: {"jpeg": bytes, "pixels": ..., "decoded": ..., "quality",
    "subsampling", "restart_blocks"}}``, Pillow's encoding and decoding of
    each case; the files beyond Pillow's baseline YCbCr and gray ones carry
    what they hold under "subsampling", quality 0 and no source pixels."""
    from PIL import Image

    out = {}
    for i, (name, shape, quality, sub, rst) in enumerate(CASES):
        pixels = image(shape, seed=i)
        kw = {"quality": quality}
        if pixels.ndim == 3:       # Pillow's gray files keep 1x1 unless asked
            kw["subsampling"] = _PIL_SUBSAMPLING[sub]
        if rst:
            kw["restart_marker_blocks"] = rst
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        decoded = np.asarray(Image.open(io.BytesIO(data)))
        out[name] = {"jpeg": data, "pixels": pixels, "decoded": decoded, "quality": quality,
                     "subsampling": sub, "restart_blocks": rst}
    for name, (data, _, what) in _more_cases().items():     # source pixels not kept
        decoded = np.asarray(Image.open(io.BytesIO(data)))
        out[name] = {"jpeg": data, "pixels": None, "decoded": decoded, "quality": 0,
                     "subsampling": what, "restart_blocks": 0}
    return out


def load(directory: str = OUT) -> dict:
    """The committed fixtures, in :func:`fixtures`' form (no PIL needed)."""
    with open(os.path.join(directory, "cases.json")) as fh:
        cases = json.load(fh)
    arrays = np.load(os.path.join(directory, "pixels.npz"))
    out = {}
    for name, meta in cases.items():
        with open(os.path.join(directory, f"{name}.jpg"), "rb") as fh:
            data = fh.read()
        pixels = arrays[f"pixels_{name}"] if f"pixels_{name}" in arrays else None
        out[name] = {"jpeg": data, "pixels": pixels, "decoded": arrays[f"decoded_{name}"],
                     **meta}
    return out


def load_refused(directory: str = OUT) -> dict:
    """The committed refused files: ``{name: (bytes, pattern)}``."""
    with open(os.path.join(directory, "refused.json")) as fh:
        patterns = json.load(fh)
    out = {}
    for name, pattern in patterns.items():
        with open(os.path.join(directory, f"{name}.jpg"), "rb") as fh:
            out[name] = (fh.read(), pattern)
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    fx = fixtures()
    arrays = {}
    for name, f in fx.items():
        with open(os.path.join(OUT, f"{name}.jpg"), "wb") as fh:
            fh.write(f["jpeg"])
        if f["pixels"] is not None:
            arrays[f"pixels_{name}"] = f["pixels"]
        arrays[f"decoded_{name}"] = f["decoded"]
    np.savez_compressed(os.path.join(OUT, "pixels.npz"), **arrays)
    with open(os.path.join(OUT, "cases.json"), "w") as fh:
        json.dump({name: {k: f[k] for k in ("quality", "subsampling", "restart_blocks")}
                   for name, f in fx.items()}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    bad = refused()
    for name, (data, _) in bad.items():
        with open(os.path.join(OUT, f"{name}.jpg"), "wb") as fh:
            fh.write(data)
    with open(os.path.join(OUT, "refused.json"), "w") as fh:
        json.dump({name: pattern for name, (_, pattern) in bad.items()}, fh, indent=1,
                  sort_keys=True)
        fh.write("\n")
    print(f"wrote {len(fx)} fixtures and {len(bad)} refused files to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
