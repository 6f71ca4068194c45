"""Every slide that Pillow decodes, the port decodes: the port's
``ingest.decode_slide`` against the JAX package's (``np.asarray(Image.open(f)
.convert("RGB"))``), bit for bit, with ``PIL`` blocked in ``sys.modules``
while the port decodes.

Covered:

- ``io/pillow_modes.py``: each raw mode's unpacking and each mode's RGB
  conversion against Pillow's ``frombytes`` / ``convert`` on seeded arrays
  holding every edge value (clipping against ``>> 8``, float truncation,
  NaN, associated alpha of 0 and 255, CMYK);
- the JPEG fixtures beyond baseline (``tools/make_jpeg_fixtures.py``):
  progressive (Pillow's simple progression, an unrefined and a DC-only scan
  script that libjpeg-turbo smooths, spectral selection with one DC scan a
  component and restart markers), CMYK and YCCK, sampling h1v2, h4v1, h4v2
  and mixed chroma, RGB under an Adobe marker;
- fresh Pillow-written progressive and CMYK JPEGs at several sizes,
  samplings and qualities;
- fresh Pillow-written TIFFs of modes ``1`` (every CCITT codec, FillOrder 2,
  strips), ``I;16``, ``F`` and ``CMYK`` under every codec Pillow writes,
  and assembled ones Pillow cannot write: 16-bit RGB, RGBA and CMYK in both
  byte orders under Predictor 2, tiles and one plane a sample, 2- and
  4-bit gray and palette, MinIsWhite fax, FillOrder 2 under every codec,
  32-bit integer and float gray, an Orientation on a 1-bit page;
- PNGs of every colour type and depth, plain and Adam7-interlaced, down to
  1 x 1 (six empty passes);
- YCbCr outside JPEG under every subsampling libtiff converts, as Pillow
  reads it through libtiff's RGBA route (libtiff's arithmetic, its short
  reads of 4x4 strips and its skew of 4x4 edge tiles);
- CIELab TIFFs through LittleCMS's transform (``pillow_modes.lab_to_rgb``,
  on a lattice of Lab triplets), arithmetic-coded and lossless JPEGs; the
  formats that stay refused (ICCLab, ITULab, 12-bit and hierarchical
  JPEG) raise ``ValueError`` naming the file, as Pillow refuses them, and
  none of these files reaches PIL;
- ``register`` (both packages' commands) of one array whose slide is a
  progressive JPEG and a 16-bit TIFF: equal Loupe CSVs.
"""

import importlib.util
import io
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gridnext_tpu.ingest import decode_slide as jax_decode_slide
from gridnext_tpu_torch import ingest
from gridnext_tpu_torch.io import jpeg, pillow_modes, png, tiff

REPO = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TT = _tool("make_tiff_fixtures")
JT = _tool("make_jpeg_fixtures")
JPEG_NAMES = sorted(n for n, m in json.loads(
    (REPO / "tests" / "data" / "jpeg" / "cases.json").read_text()).items() if not m["quality"])


def _block_pil(monkeypatch):
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, mod, None)


def _pil(image, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _hold_to_jax(cases: dict, tmp_path, monkeypatch) -> None:
    """Write each ``{name: bytes}``, decode it with the JAX package, then with
    PIL blocked through the port: equal arrays."""
    wants = {}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        wants[name] = jax_decode_slide(str(tmp_path / name))
    _block_pil(monkeypatch)
    for name in cases:
        got = ingest.decode_slide(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.flags.c_contiguous, name
        np.testing.assert_array_equal(got, wants[name], err_msg=name)
    monkeypatch.undo()


# ---- Pillow's modes ---------------------------------------------------------

def _pillow_raw_cases():
    """(name, Pillow mode, Pillow raw mode, bytes, the port's raw mode, samples)."""
    rng = np.random.default_rng(7)
    h, w = 6, 16
    out = []
    bits1 = rng.integers(0, 2, (h, w)).astype(np.uint8)
    for raw in ("1", "1;I"):
        out.append((raw, "1", raw, np.packbits(bits1, axis=1).tobytes(), raw, bits1))
    for bits in (2, 4):
        s = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
        for inv in ("", "I"):
            raw = f"L;{bits}{inv}"
            out.append((raw, "L", raw, TT.pack_samples(s, bits).tobytes(), raw, s))
    s8 = rng.integers(0, 256, (h, w)).astype(np.uint8)
    out.append(("L;I", "L", "L;I", s8.tobytes(), "L;I", s8))
    g16 = TT.wide((h, w), 1)
    out.append(("I;16", "I;16", "I;16", g16.astype("<u2").tobytes(), "I;16", g16))
    out.append(("I;16B", "I;16B", "I;16B", g16.astype(">u2").tobytes(), "I;16B", g16))
    i16 = TT.wide((h, w), 2, np.int16)
    out.append(("I;16S", "I", "I;16S", i16.astype("<i2").tobytes(), "I;16S", i16))
    out.append(("I;16BS", "I", "I;16BS", i16.astype(">i2").tobytes(), "I;16S", i16))
    i32 = TT.wide((h, w), 3, np.uint32).view(np.int32)
    out.append(("I;32N", "I", "I;32N", i32.tobytes(), "I;32", i32))
    f32 = TT.wide((h, w), 4, np.float32)
    f32[1, :6] = [0.99, 254.9, 255.0, -0.5, np.nan, np.inf]
    out.append(("F;32F", "F", "F;32F", f32.astype("<f4").tobytes(), "F;32F", f32))
    out.append(("F;32BF", "F", "F;32BF", f32.astype(">f4").tobytes(), "F;32F", f32))
    for c, raw, mode in ((3, "RGB;16", "RGB"), (4, "RGBA;16", "RGBA"), (4, "RGBX;16", "RGB"),
                         (4, "RGBa;16", "RGBA"), (4, "CMYK;16", "CMYK")):
        s = TT.wide((h, w, c), 5 + c)
        s[0, :3, -1] = [0, 255 * 256, 65535]
        for order, suffix in (("<", "L"), (">", "B")):
            out.append((raw + suffix, mode, raw + suffix, s.astype(order + "u2").tobytes(), raw,
                        s))
    la = TT.wide((h, w, 2), 11)
    out.append(("LA;16B", "RGBA", "LA;16B", la.astype(">u2").tobytes(), "LA;16", la))
    for c, raw, mode in ((4, "RGBa", "RGBA"), (4, "RGBX", "RGB"), (4, "CMYK", "CMYK"),
                         (4, "CMYK;I", "CMYK"), (2, "LA", "LA"), (4, "RGBA", "RGBA"),
                         (2, "PX", "P"), (2, "PA", "PA"), (1, "P", "P")):
        s = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        s[0, :3, -1] = [0, 255, 1]
        s = s[..., 0] if c == 1 else s
        out.append((raw, mode, raw, s.tobytes(), raw, s))
    return out


RAW_CASES = {c[0]: c for c in _pillow_raw_cases()}


@pytest.mark.parametrize("name", sorted(RAW_CASES))
def test_pillow_modes_match_pillow(name):
    _, mode, raw, data, port_raw, samples = RAW_CASES[name]
    h, w = samples.shape[:2]
    im = Image.frombytes(mode, (w, h), data, "raw", raw)
    palette = np.random.default_rng(8).integers(0, 256, (40, 3)).astype(np.uint8)
    if mode in ("P", "PA"):
        im.putpalette(palette.reshape(-1).tolist())
    got_mode, pixels = pillow_modes.unpack(port_raw, samples)
    assert got_mode == im.mode
    want = np.asarray(im)
    np.testing.assert_array_equal(pixels, want, err_msg=name)
    assert pixels.dtype == want.dtype.newbyteorder("=")      # I;16B: big-endian in Pillow
    np.testing.assert_array_equal(pillow_modes.to_rgb(got_mode, pixels, palette),
                                  np.asarray(im.convert("RGB")), err_msg=name)


# ---- JPEG --------------------------------------------------------------------

@pytest.mark.parametrize("name", JPEG_NAMES)
def test_jpeg_fixture_matches_jax(name, monkeypatch):
    path = REPO / "tests" / "data" / "jpeg" / f"{name}.jpg"
    want = jax_decode_slide(str(path))
    _block_pil(monkeypatch)
    np.testing.assert_array_equal(ingest.decode_slide(str(path)), want)
    mode, _ = jpeg.read_jpeg(path)
    assert mode == ("CMYK" if "cmyk" in name or "ycck" in name else "RGB" if "gray" not in name
                    else "L")


def test_fresh_progressive_and_cmyk_jpegs(tmp_path, monkeypatch):
    cases = {}
    for k, (h, w) in enumerate([(1, 1), (9, 7), (33, 35), (64, 48)]):
        rgb = TT.image((h, w, 3), 800 + k)
        for sub in (0, 1, 2):
            for q in (40, 90):
                cases[f"p{k}_{sub}_{q}.jpg"] = _pil(Image.fromarray(rgb), "JPEG", quality=q,
                                                    subsampling=sub, progressive=True)
        cases[f"pg{k}.jpg"] = _pil(Image.fromarray(rgb[..., 0]), "JPEG", progressive=True)
        cmyk = Image.fromarray(rgb).convert("CMYK")
        cases[f"c{k}.jpg"] = _pil(cmyk, "JPEG", quality=80)
        cases[f"cp{k}.jpg"] = _pil(cmyk, "JPEG", progressive=True, restart_marker_blocks=1)
    _hold_to_jax(cases, tmp_path, monkeypatch)
    assert jpeg.jpeg_info(cases["p2_2_90.jpg"])["sof"] == "progressive"


def test_transcoded_scripts_match_pillow():
    """Every scan script of the transcoder on a 4:2:0, a 4:4:4 and a gray
    file, with and without restart markers: Pillow's pixels."""
    rgb = TT.image((37, 45, 3), 810)
    for base in (_pil(Image.fromarray(rgb), "JPEG", quality=85),
                 _pil(Image.fromarray(rgb), "JPEG", quality=60, subsampling=0),
                 _pil(Image.fromarray(rgb[..., 1]), "JPEG", quality=70)):
        for script in range(5):
            for restart in (0, 2):
                data = JT.transcode(base, script, restart)
                want = np.asarray(Image.open(io.BytesIO(data)))
                np.testing.assert_array_equal(jpeg.decode_jpeg(data), want,
                                              err_msg=f"script {script}, restart {restart}")
        # the simple progression is the file's own coefficients: its pixels
        np.testing.assert_array_equal(jpeg.decode_jpeg(JT.transcode(base, 1)),
                                      jpeg.decode_jpeg(base))


def test_refused_jpegs_raise_naming_the_file(tmp_path, monkeypatch):
    """The arithmetic-coded and lossless slides once refused decode as
    JAX's ``decode_slide`` (Pillow) does; what Pillow refuses (12-bit,
    hierarchical, lossless YCbCr) raises naming the file."""
    rgb = TT.image((16, 16, 3), 820)
    base = _pil(Image.fromarray(rgb), "JPEG")
    sof = base.index(b"\xff\xc0")
    arith = JT.transcode(base, 0, arith=True)
    _hold_to_jax({"arith.jpg": arith, "lossless.jpg": JT.write_lossless(rgb, 4)}, tmp_path,
                 monkeypatch)
    cases = {"bits12.jpg": (base[:sof + 4] + b"\x0c" + base[sof + 5:], "12-bit samples"),
             "sof13.jpg": (arith.replace(b"\xff\xc9", b"\xff\xcd", 1), r"\(SOF13\)"),
             "ycbcr.jpg": (JT.write_lossless(rgb, 1, app=JT.JFIF), "lossless with a colour")}
    for name, (data, pattern) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=rf"{name}.*{pattern}"):
            ingest.decode_slide(str(tmp_path / name))
        with pytest.raises((OSError, SyntaxError)):
            Image.open(io.BytesIO(data)).load()


# ---- TIFF --------------------------------------------------------------------

@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits",
                                         "group3", "group4", "tiff_ccitt"])
def test_fresh_pillow_tiffs_of_other_modes(compression, tmp_path, monkeypatch):
    cases = {}
    for k, (h, w) in enumerate([(1, 1), (19, 37), (40, 9)]):
        bilevel = TT.image((h, w), 830 + k) > 100
        for info in ({}, {278: 7}, {266: 2}, {292: 5} if compression == "group3" else {278: 3}):
            cases[f"b{k}_{len(cases)}.tif"] = _pil(Image.fromarray(bilevel), "TIFF",
                                                   compression=compression, tiffinfo=info)
        if compression in ("group3", "group4", "tiff_ccitt"):
            continue
        for pixels in (TT.wide((h, w), 840 + k), TT.wide((h, w), 850 + k, np.float32),
                       np.asarray(Image.fromarray(TT.image((h, w, 3), 860 + k)).convert("CMYK"))):
            im = Image.fromarray(pixels) if pixels.ndim == 2 else Image.fromarray(pixels,
                                                                                  "CMYK")
            for info in ({}, {278: 5}, {317: 2}):
                if 317 in info and (compression not in ("tiff_lzw", "tiff_adobe_deflate")
                                    or im.mode == "F"):
                    continue
                cases[f"{im.mode.replace(';', '')}{k}_{len(cases)}.tif"] = _pil(
                    im, "TIFF", compression=compression, tiffinfo=info)
    _hold_to_jax(cases, tmp_path, monkeypatch)


def _assembled_tiffs() -> dict:
    cases = {}
    for order in "<>":
        o = "le" if order == "<" else "be"
        for comp in (1, 8, 32773):
            rgb16 = TT.wide((21, 35, 3), 900 + comp)
            rgba16 = TT.wide((13, 18, 4), 901 + comp)
            pred = 2 if comp == 8 else 1
            cases[f"rgb16_{o}_{comp}.tif"] = TT._tiff_of(
                rgb16, 16, compression=comp, photometric=2, order=order, predictor=pred,
                rows_per_strip=4)
            cases[f"rgb16_{o}_{comp}_tiled.tif"] = TT._tiff_of(
                rgb16, 16, compression=comp, photometric=2, order=order, tile=(16, 16))
            for extra in ((), (0,), (1,), (2,)):
                cases[f"rgba16_{o}_{comp}_{extra}.tif"] = TT._tiff_of(
                    rgba16, 16, compression=comp, photometric=2, order=order, extra=extra,
                    predictor=pred)
            cases[f"cmyk16_{o}_{comp}.tif"] = TT._tiff_of(
                TT.wide((11, 14, 4), 902), 16, compression=comp, photometric=5, order=order)
            cases[f"gray16_{o}_{comp}.tif"] = TT._tiff_of(
                TT.wide((15, 22, 1), 903), 16, compression=comp, photometric=1, order=order,
                predictor=pred)
            cases[f"sgray16_{o}_{comp}.tif"] = TT._tiff_of(
                TT.wide((15, 22, 1), 904, np.int16), 16, compression=comp, photometric=1,
                order=order, sample_format=2, predictor=pred)
            cases[f"float_{o}_{comp}.tif"] = TT._tiff_of(
                TT.wide((9, 12, 1), 905, np.float32), 32, compression=comp, photometric=1,
                order=order, sample_format=3)
            cases[f"int32_{o}_{comp}.tif"] = TT._tiff_of(
                TT.wide((9, 12, 1), 906, np.int32), 32, compression=comp, photometric=1,
                order=order, sample_format=2)
            for fill in (1, 2):
                for bits, photo in ((1, 0), (1, 1), (2, 1), (4, 0), (8, 0), (8, 1)):
                    if (comp, fill, photo, bits) == (1, 2, 0, 8):   # refused, as Pillow does
                        continue
                    g = TT.image((17, 29, 1), 910 + bits) >> (8 - bits)
                    cases[f"g{bits}_{photo}_{o}_{comp}_{fill}.tif"] = TT._tiff_of(
                        g, bits, compression=comp, photometric=photo, order=order,
                        fill_order=fill, rows_per_strip=6)
                for bits in (1, 2, 4, 8):
                    if (comp, fill) == (1, 2) and bits < 8:        # refused, as Pillow does
                        continue
                    n = 1 << bits
                    cmap = (TT.image((n, 3), 920 + bits).astype(np.uint16) * 257).T.reshape(-1)
                    cases[f"p{bits}_{o}_{comp}_{fill}.tif"] = TT._tiff_of(
                        TT.image((14, 19, 1), 921 + bits) >> (8 - bits), bits,
                        compression=comp, photometric=3, order=order, fill_order=fill,
                        colormap=cmap)
            # one plane a sample at 16 bits (compressed: Pillow reads
            # uncompressed planes as 8-bit samples, and the port refuses those)
            if comp == 1:
                continue
            planes = TT.wide((10, 13, 3), 930)
            segs = [TT.pack_samples(planes[..., c], 16, order).tobytes() for c in range(3)]
            cases[f"planar16_{o}_{comp}.tif"] = TT.assemble_tiff(
                planes.shape, [{1: s, 8: zlib.compress(s), 32773: TT.packbits(s)}[comp]
                               for s in segs], compression=comp, photometric=2, planar=2,
                byteorder=order, bits=16)
    for comp in (1, 8):
        cases[f"gray12_{comp}.tif"] = TT._tiff_of(TT.wide((11, 15, 1), 935) >> 4, 12,
                                                  compression=comp, photometric=1)
    bilevel = TT.image((12, 21, 1), 940) >> 7
    cases["b_orient6.tif"] = TT.assemble_tiff(
        (12, 21, 1), [TT.pack_samples(bilevel, 1).tobytes()], compression=1, photometric=1,
        orientation=6, bits=1)
    return cases


def test_assembled_tiffs_of_other_modes(tmp_path, monkeypatch):
    _hold_to_jax(_assembled_tiffs(), tmp_path, monkeypatch)


def test_ycbcr_outside_jpeg_as_libtiff_converts_it(tmp_path, monkeypatch):
    """Subsampled YCbCr under Deflate or PackBits, which Pillow reads through
    libtiff's RGBA route: every subsampling libtiff converts, strips (one
    and several, rows a multiple of the block or not) and tiles (cut by
    the right and bottom edges), other YCbCrCoefficients and
    ReferenceBlackWhite."""
    cases = {}
    coefficients = {529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
                    532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])}
    for k, (h, w) in enumerate([(5, 3), (17, 23), (40, 50)]):
        ycc = TT.image((h, w, 3), 990 + k)
        for hs, vs in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
            for comp in (8, 32773):
                enc = zlib.compress if comp == 8 else TT.packbits
                for rows in (h, 4 * vs, 3):
                    cases[f"s{k}_{hs}{vs}_{comp}_{rows}.tif"] = TT.assemble_tiff(
                        ycc.shape, [enc(TT.ycbcr_units(ycc[y:y + rows], hs, vs))
                                    for y in range(0, h, rows)], compression=comp,
                        photometric=6, rows_per_strip=rows, ycbcr_subsampling=(hs, vs),
                        more_tags=coefficients if rows == h else None)
                if k:
                    cases[f"t{k}_{hs}{vs}_{comp}.tif"] = TT.assemble_tiff(
                        ycc.shape, [enc(TT.ycbcr_units(t, hs, vs))
                                    for t in TT.tiles_of(ycc, 16, 16)], compression=comp,
                        photometric=6, tile=(16, 16), ycbcr_subsampling=(hs, vs))
    _hold_to_jax(cases, tmp_path, monkeypatch)


def test_refused_tiffs_raise_naming_the_file(tmp_path, monkeypatch):
    """The CIELab files once refused decode as JAX's ``decode_slide``
    (Pillow, through LittleCMS) does; ICCLab, ITULab and the layouts Pillow
    has no mode for stay refused, naming the file, and Pillow refuses them."""
    rgb = Image.fromarray(TT.image((16, 16, 3), 950))
    _hold_to_jax({"lab.tif": _pil(rgb.convert("LAB"), "TIFF"),
                  "lab_lzw.tif": _pil(rgb.convert("LAB"), "TIFF", compression="tiff_lzw")},
                 tmp_path, monkeypatch)
    lab = TT.image((8, 8, 3), 957)
    cases = {"icclab.tif": (TT._tiff_of(lab, 8, photometric=9), r"photometric 9 \(ICCLab\)"),
             "itulab.tif": (TT._tiff_of(lab, 8, photometric=10), r"photometric 10 \(ITULab\)"),
             "rgba_fill2.tif": (TT._tiff_of(TT.image((8, 8, 4), 951), 8, photometric=2,
                                            fill_order=2), "FillOrder 2"),
             "gray16_white_be.tif": (TT._tiff_of(TT.wide((8, 8, 1), 952), 16, photometric=0,
                                                 order=">"), "BitsPerSample"),
             "gray12_be.tif": (TT._tiff_of(TT.wide((8, 8, 1), 953) >> 4, 12, photometric=1,
                                           order=">"), r"BitsPerSample \(12,\)"),
             "pal4_raw_fill2.tif": (TT._tiff_of(TT.image((8, 8, 1), 955) >> 4, 4, photometric=3,
                                                fill_order=2, colormap=np.zeros(48, np.uint16)),
                                    "uncompressed FillOrder 2"),
             "ycbcr_raw.tif": (TT.assemble_tiff((8, 8, 3), [TT.ycbcr_units(
                 TT.image((8, 8, 3), 956), 2, 2)], compression=1, photometric=6),
                 "YCbCr samples outside JPEG compression, uncompressed"),
             "planar16_raw.tif": (TT.assemble_tiff(
                 (4, 5, 3), [bytes(40)] * 3, compression=1, photometric=2, planar=2, bits=16),
                 "uncompressed PlanarConfiguration 2"),
             "pred2_bits4.tif": (TT._tiff_of(TT.image((8, 8, 1), 954) >> 4, 4, compression=8,
                                             photometric=1, predictor=2),
                                 "Predictor 2 on 4-bit")}
    for name, (data, pattern) in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=rf"{name}.*{pattern}"):
            ingest.decode_slide(str(tmp_path / name))
    for name in ("icclab.tif", "itulab.tif"):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(cases[name][0])).load()


@pytest.mark.parametrize("step", [17])
def test_lab_conversion_matches_pillow_on_a_lattice(step):
    """``pillow_modes.lab_to_rgb`` against Pillow's ``convert("RGB")`` (its
    LittleCMS transform) on every ``step``-th 8-bit (L, a*, b*) triplet and
    the cube's faces (``tools/check_lab_conversion.py`` runs all 2^24)."""
    v = np.unique(np.r_[np.arange(0, 256, step), 1, 127, 128, 129, 254, 255]).astype(np.uint8)
    lab = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1)
    want = np.asarray(Image.fromarray(lab.reshape(-1, len(v), 3), "LAB").convert("RGB"))
    got = pillow_modes.lab_to_rgb(lab.reshape(-1, len(v), 3))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pillow_modes.lab_to_rgb(lab, n_threads=1).reshape(got.shape),
                                  want)


# ---- PNG ---------------------------------------------------------------------

def test_pngs_of_every_depth_and_adam7(tmp_path, monkeypatch):
    cases = {}
    for k, (h, w) in enumerate([(1, 1), (3, 2), (5, 9), (17, 23)]):
        for colour, depths, c in ((0, (1, 2, 4, 8, 16), 1), (2, (8, 16), 3), (3, (1, 2, 4, 8), 1),
                                  (4, (8, 16), 2), (6, (8, 16), 4)):
            for depth in depths:
                s = (TT.wide((h, w, c), 960 + k) if depth == 16
                     else TT.image((h, w, c), 970 + k) >> (8 - depth))
                s = s[..., 0] if c == 1 else s
                pal = TT.image((max(1, (1 << depth) - 3), 3), k) if colour == 3 else None
                for interlace in (0, 1):
                    cases[f"c{colour}_d{depth}_{k}_i{interlace}.png"] = TT.assemble_png(
                        s, colour, depth=depth, interlace=interlace, palette=pal,
                        filters=(4, 1, 3, 0, 2), idat_parts=1 + k)
    for k, mode in enumerate(("1", "I;16", "P")):
        px = {"1": TT.image((13, 11), 980) > 90, "I;16": TT.wide((13, 11), 981),
              "P": TT.image((13, 11), 982) % 3}[mode]
        im = Image.fromarray(px) if mode != "P" else Image.fromarray(px, "P")
        if mode == "P":
            im.putpalette([10, 20, 30, 200, 100, 0, 255, 255, 255])
        cases[f"pillow_{k}.png"] = _pil(im, "PNG")
    _hold_to_jax(cases, tmp_path, monkeypatch)
    assert png.read_png(cases["c0_d16_3_i1.png"])[0] == "I;16"


def test_slide_formats_never_reach_pil(tmp_path, monkeypatch):
    """PIL installed but its ``open`` fails: every new kind still decodes."""
    rgb = TT.image((20, 24, 3), 990)
    files = {"prog.jpg": _pil(Image.fromarray(rgb), "JPEG", progressive=True),
             "cmyk.jpg": _pil(Image.fromarray(rgb).convert("CMYK"), "JPEG"),
             "g16.tif": _pil(Image.fromarray(TT.wide((20, 24), 991)), "TIFF"),
             "g4.tif": _pil(Image.fromarray(rgb[..., 0] > 99), "TIFF", compression="group4"),
             "f.tif": _pil(Image.fromarray(TT.wide((20, 24), 992, np.float32)), "TIFF"),
             "adam7.png": TT.assemble_png(TT.wide((20, 24, 3), 993), 2, depth=16, interlace=1),
             "arith.jpg": JT.transcode(_pil(Image.fromarray(rgb), "JPEG"), 1, arith=True),
             "lossless.jpg": JT.write_lossless(rgb, 7, pt=1),
             "cut.jpg": JT.cut_scan(JT.transcode(_pil(Image.fromarray(rgb), "JPEG"), 0,
                                                 arith=True), 0.5),
             "lab.tif": TT._tiff_of(TT.rgb_to_lab(rgb), 8, compression=8, photometric=8)}
    wants = {}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        wants[name] = jax_decode_slide(str(tmp_path / name))

    def refuse(*args, **kw):
        raise AssertionError("PIL was asked to open a slide")

    monkeypatch.setattr(Image, "open", refuse)
    for name in files:
        np.testing.assert_array_equal(ingest.decode_slide(str(tmp_path / name)), wants[name])


# ---- register ----------------------------------------------------------------

def _simulated_array(tmp_path):
    """(Spaceranger outs directory, slide pixels) of one simulated array."""
    from gridnext_tpu.data import simulate_spaceranger_dir

    sim = simulate_spaceranger_dir(tmp_path / "a0", seed=3, n_genes=5, n_classes=3, image=True,
                                   spot_spacing_px=10, tissue_fraction=0.4)
    return (str(Path(sim["spaceranger_dir"]) / "outs"),
            np.asarray(Image.open(sim["image_file"]).convert("RGB")))


def _register_both(tmp_path, srd: str, slides) -> None:
    """``register`` through both packages' commands of the array ``srd``
    once a slide of ``slides``, with one seeded image model directory:
    equal Loupe CSVs."""
    import jax
    import jax.numpy as jnp

    from gridnext_tpu.cli import main as jax_main
    from gridnext_tpu.models import GridNetHex, TpuPatchClassifier
    from gridnext_tpu.train import create_train_state, make_gridwise_optimizer, save_checkpoint
    from gridnext_tpu_torch.cli import main as port_main

    g = GridNetHex(patch_classifier=TpuPatchClassifier(n_classes=3, stages=((32, 1),),
                                                       stem_patch=8), n_classes=3)
    state = create_train_state(g, jax.random.key(0), jnp.zeros((1, 2, 2, 16, 16, 3)),
                               make_gridwise_optimizer(1e-3))
    rng = np.random.default_rng(5)
    moved = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 1.5, x.shape) if str(getattr(p[-1], "key", "")) == "var"
                      else np.asarray(x) + 0.03 * rng.standard_normal(x.shape)
                      ).astype(np.float32),
        {"params": state.params, "batch_stats": state.batch_stats})
    model = tmp_path / "model"
    model.mkdir()
    save_checkpoint(str(model / "g_state.msgpack"), state.replace(**moved))
    meta = {"classes": ["A", "B", "C"], "patch_px": 16, "window_px": None,
            "model": "GridNetHex+TpuPatchClassifier",
            "tpu_f": {"stages": [[32, 1]], "stem_patch": 8, "norm": "rms"}, "image_f": "tpu",
            "hd_binning": None, "grid_dims": None, "patch_chunk": 256, "dense_ingest": False}
    (model / "model.json").write_text(json.dumps(meta))
    args = ["register", "--model", str(model), "--images", *map(str, slides),
            "--spaceranger", *[srd] * len(slides)]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    port_main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    csvs = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(csvs) == len(slides)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == csvs
    for name in csvs:
        jax_csv = (tmp_path / "jax" / name).read_bytes()
        assert jax_csv.count(b"\n") > 100
        assert (tmp_path / "port" / name).read_bytes() == jax_csv, name


def test_register_progressive_jpeg_and_16bit_tiff_slides_match_jax(tmp_path):
    """One ``register`` through both packages' commands of one array twice:
    its slide as a progressive JPEG and as a 16-bit RGB TIFF (Deflate,
    Predictor 2, ``v << 8 | noise``). Equal Loupe CSVs."""
    srd, pixels = _simulated_array(tmp_path)
    prog = tmp_path / "slide_prog.jpg"
    prog.write_bytes(_pil(Image.fromarray(pixels), "JPEG", quality=90, progressive=True))
    noise = np.random.default_rng(9).integers(0, 256, pixels.shape)
    wide = TT._tiff_of(pixels.astype(np.uint16) << 8 | noise.astype(np.uint16), 16,
                       compression=8, photometric=2, predictor=2, rows_per_strip=16)
    slide16 = tmp_path / "slide16.tif"
    slide16.write_bytes(wide)
    assert np.array_equal(ingest.decode_slide(str(slide16)), pixels)
    _register_both(tmp_path, srd, [prog, slide16])


def test_register_arithmetic_lossless_jpeg_and_lab_tiff_slides_match_jax(tmp_path):
    """The same with three slides of the array: an arithmetic-coded
    progressive JPEG (the transcoder's rewrite of a quality-90 file), a
    lossless JPEG (predictor 4) and a CIELab TIFF (``rgb_to_lab``,
    Deflate). Equal Loupe CSVs."""
    srd, pixels = _simulated_array(tmp_path)
    arith = tmp_path / "slide_arith.jpg"
    arith.write_bytes(JT.transcode(_pil(Image.fromarray(pixels), "JPEG", quality=90), 1,
                                   arith=True))
    lossless = tmp_path / "slide_lossless.jpg"
    lossless.write_bytes(JT.write_lossless(pixels, 4))
    lab = tmp_path / "slide_lab.tif"
    lab.write_bytes(TT._tiff_of(TT.rgb_to_lab(pixels), 8, compression=8, photometric=8,
                                rows_per_strip=16))
    assert np.array_equal(ingest.decode_slide(str(lossless)), pixels)
    _register_both(tmp_path, srd, [arith, lossless, lab])


def test_png_info_counts_pillow_bands():
    data = TT.assemble_png(TT.wide((4, 5, 2), 995), 4, depth=16)
    with Image.open(io.BytesIO(data)) as im:
        assert png.png_info(data)["samples"] == len(im.getbands()) == 4
    assert tiff.tiff_info(_pil(Image.fromarray(TT.image((4, 5), 996) > 9), "TIFF",
                               compression="group4"))["compression"] == "ccitt group 4"
