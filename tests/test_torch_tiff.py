"""The port's TIFF and PNG readers (``io/tiff.py``, ``io/png.py`` over
``csrc/raster_codec.cpp``) against Pillow and the JAX package.

Covered, bit for bit, with ``PIL`` blocked in ``sys.modules`` while the
port decodes:

- every committed fixture of ``tools/make_tiff_fixtures.py`` through the
  port's ``ingest.decode_slide`` equals the JAX package's ``decode_slide``
  (Pillow) and the stored pixels; a fresh run of the tool equals the
  committed files;
- fresh Pillow-written TIFFs (every codec, gray, RGB, RGBA, palette, LA,
  predictor, strip heights) and PNGs, assembled TIFFs of every Orientation,
  associated alpha, tiles in both byte orders and BigTIFF, Pillow-made
  JPEG tiles in both colour interpretations;
- 1 thread and many give equal pixels;
- every refused case raises ``ValueError`` naming the file (the cases once
  refused that Pillow decodes now decode to the JAX package's pixels), and
  a TIFF or PNG never reaches PIL even where PIL is installed; other
  formats do;
- ``tiff_info`` / ``png_info`` against Pillow's size; a failed build raises;
- ``pseudo_visium_from_image`` on a TIFF writes what the JAX package's
  writes, and ``register`` of a TIFF slide through both packages' commands.
"""

import importlib.util
import io
import json
import os
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate as jax_simulate
from gridnext_tpu.ingest import decode_slide as jax_decode_slide
from gridnext_tpu_torch import ingest
from gridnext_tpu_torch.cli import main as port_main
from gridnext_tpu_torch.data import simulate
from gridnext_tpu_torch.io import png, tiff

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "tiff"


def _tool():
    spec = importlib.util.spec_from_file_location("make_tiff_fixtures",
                                                  REPO / "tools" / "make_tiff_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
NAMES = sorted(json.loads((FIXTURES / "cases.json").read_text()))


def _block_pil(monkeypatch):
    """``import PIL`` (and its modules) raises ImportError until the test ends."""
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, mod, None)


def _port(path, **kw):
    return ingest.decode_slide(str(path), **kw)


def _pillow(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _write(tmp_path, name, data) -> Path:
    p = tmp_path / name
    p.write_bytes(data)
    return p


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_jax_and_pillow(name, monkeypatch):
    path = FIXTURES / name
    want = np.load(FIXTURES / "pixels.npz")[f"decoded_{name}"]
    np.testing.assert_array_equal(jax_decode_slide(str(path)), want)
    _block_pil(monkeypatch)
    got = _port(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_committed_fixtures_equal_a_fresh_run():
    fresh, committed = TOOL.fixtures(), TOOL.load()
    assert sorted(fresh) == sorted(committed) == NAMES
    for name, f in fresh.items():
        assert committed[name]["data"] == f["data"], name
        assert committed[name]["what"] == f["what"], name
        np.testing.assert_array_equal(committed[name]["decoded"], f["decoded"])


_MODES = {"RGB": 3, "L": 1, "RGBA": 4, "LA": 2, "P": 1}


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate",
                                         "tiff_deflate", "packbits", "jpeg"])
def test_fresh_pillow_tiffs(compression, tmp_path, monkeypatch):
    cases = []
    for k, (h, w) in enumerate([(29, 57), (64, 64), (73, 31)]):
        for mode, c in _MODES.items():
            if compression == "jpeg" and mode not in ("RGB", "L"):
                continue
            for info in ({}, {278: 8}, {317: 2, 278: 16}):
                if 317 in info and compression not in ("tiff_lzw", "tiff_adobe_deflate"):
                    continue
                a = TOOL.image((h, w, c), 100 + k)
                im = Image.fromarray(a[..., 0] if c == 1 else a, "L" if mode == "P" else mode)
                if mode == "P":
                    im = Image.fromarray(a[..., 0], "P")
                    im.putpalette(list(TOOL.image((16, 48), k).reshape(-1)))
                buf = io.BytesIO()
                im.save(buf, "TIFF", compression=compression, tiffinfo=info)
                cases.append((f"{mode}_{h}x{w}_{len(cases)}.tif", buf.getvalue()))
    wants = {}
    for name, data in cases:
        wants[name] = jax_decode_slide(str(_write(tmp_path, name, data)))
        np.testing.assert_array_equal(wants[name], _pillow(data))
    _block_pil(monkeypatch)
    for name, _ in cases:
        np.testing.assert_array_equal(_port(tmp_path / name), wants[name], err_msg=name)


def test_fresh_pngs(tmp_path, monkeypatch):
    cases = []
    for k, (h, w) in enumerate([(1, 1), (2, 9), (37, 50)]):
        for mode, c in _MODES.items():
            a = TOOL.image((h, w, c), 200 + k)
            if mode == "P":
                im = Image.fromarray(a[..., 0], "P")
                im.putpalette(list(TOOL.image((16, 48), k).reshape(-1)))
            else:
                im = Image.fromarray(a[..., 0] if c == 1 else a, mode)
            buf = io.BytesIO()
            im.save(buf, "PNG", compress_level=k * 4)
            cases.append((f"pil_{mode}_{k}.png", buf.getvalue()))
            colour = {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}[mode]
            pal = TOOL.image((k * 90 + 1, 3), k) if mode == "P" else None
            for filters in ((0,), (1,), (2,), (3,), (4,), (4, 1, 3, 0, 2)):
                cases.append((f"asm_{mode}_{k}_{''.join(map(str, filters))}.png",
                               TOOL.assemble_png(a[..., 0] if c == 1 else a, colour,
                                                 filters=filters, palette=pal,
                                                 idat_parts=1 + k)))
    wants = {}
    for name, data in cases:
        wants[name] = jax_decode_slide(str(_write(tmp_path, name, data)))
        np.testing.assert_array_equal(wants[name], _pillow(data))
    _block_pil(monkeypatch)
    for name, _ in cases:
        np.testing.assert_array_equal(_port(tmp_path / name), wants[name], err_msg=name)


def _assembled_cases():
    """Files Pillow cannot write: ({name: bytes}, a big-endian BigTIFF of
    the ``tiled_packbits_big_<`` case's tiles, which Pillow cannot read)."""
    out = {}
    a = TOOL.image((21, 34, 3), 300)
    for o in range(1, 9):                                     # every Orientation
        out[f"orient{o}.tif"] = TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1,
                                                   photometric=2, orientation=o)
    rgba = TOOL.image((19, 22, 4), 301)
    rgba[0, :5, 3] = 0                                        # fully transparent
    rgba[1, :5, 3] = 255
    for extra in (1, 2, 0):                                   # associated, unassociated, none
        out[f"rgba_extra{extra}.tif"] = TOOL.assemble_tiff(
            rgba.shape, [zlib.compress(rgba.tobytes())], compression=8, photometric=2,
            extra=(extra,))
    gray = TOOL.image((40, 70), 302)
    segs = [TOOL.pillow_segment(t, 32773)[0] for t in TOOL.tiles_of(gray[..., None], 32, 16)]
    for bigtiff, order in ((False, "<"), (False, ">"), (True, "<")):
        out[f"tiled_packbits_{'big' if bigtiff else 'classic'}_{order}.tif"] = \
            TOOL.assemble_tiff((40, 70, 1), segs, compression=32773, photometric=1,
                               tile=(32, 16), bigtiff=bigtiff, byteorder=order)
    mm = TOOL.assemble_tiff((40, 70, 1), segs, compression=32773, photometric=1,
                            tile=(32, 16), bigtiff=True, byteorder=">")
    rgb = TOOL.image((70, 90, 3), 303)
    tables, segs = TOOL.jpeg_tiles(rgb, 32, 32, quality=90)
    out["ycbcr_tiles_tables.tif"] = TOOL.assemble_tiff(
        rgb.shape, segs, compression=7, photometric=6, tile=(32, 32), jpegtables=tables,
        ycbcr_subsampling=(2, 2))
    full = []
    for t in TOOL.tiles_of(rgb, 32, 32):
        buf = io.BytesIO()
        Image.fromarray(t).save(buf, "JPEG", quality=60, subsampling=0)
        full.append(buf.getvalue())
    out["ycbcr_tiles_444_no_tables.tif"] = TOOL.assemble_tiff(
        rgb.shape, full, compression=7, photometric=6, tile=(32, 32), ycbcr_subsampling=(1, 1))
    segs, tables = [], None
    for t in TOOL.tiles_of(rgb, 32, 32):
        seg, tables = TOOL.pillow_segment(t, 7, quality=85)
        segs.append(seg)
    out["rgb_jpeg_tiles.tif"] = TOOL.assemble_tiff(rgb.shape, segs, compression=7,
                                                   photometric=2, tile=(32, 32),
                                                   jpegtables=tables)
    return out, mm


def test_assembled_tiffs_match_jax(tmp_path, monkeypatch):
    cases, mm = _assembled_cases()
    wants = {name: jax_decode_slide(str(_write(tmp_path, name, data)))
             for name, data in cases.items()}
    assert wants["orient6.tif"].shape == (34, 21, 3)
    _block_pil(monkeypatch)
    for name in cases:
        np.testing.assert_array_equal(_port(tmp_path / name), wants[name], err_msg=name)
    # a big-endian BigTIFF (Pillow 12 takes its header for a classic one: it
    # tests the third byte for 43) reads as the little-endian one
    np.testing.assert_array_equal(tiff.decode_tiff(mm), wants["tiled_packbits_big_<.tif"])
    # tiff_info reports the turned shape, as Pillow's size
    assert tiff.tiff_info(tmp_path / "orient6.tif")["height"] == 34


def test_threads_give_equal_pixels(tmp_path):
    big = TOOL.image((300, 257, 3), 400)
    segs = [zlib.compress(big[y:y + 3].tobytes()) for y in range(0, 300, 3)]
    deflate = TOOL.assemble_tiff(big.shape, segs, compression=8, photometric=2,
                                 rows_per_strip=3)
    tiles = [TOOL.pillow_segment(t, 5, predictor=2)[0] for t in TOOL.tiles_of(big, 64, 48)]
    lzw = TOOL.assemble_tiff(big.shape, tiles, compression=5, photometric=2, tile=(64, 48),
                             predictor=2)
    tables, segs = TOOL.jpeg_tiles(big, 64, 64)
    jpg = TOOL.assemble_tiff(big.shape, segs, compression=7, photometric=6, tile=(64, 64),
                             jpegtables=tables, ycbcr_subsampling=(2, 2))
    for data in (deflate, lzw, jpg):
        one = tiff.decode_tiff(data, n_threads=1)
        np.testing.assert_array_equal(one, tiff.decode_tiff(data, n_threads=7))
        np.testing.assert_array_equal(one, _pillow(data))
    np.testing.assert_array_equal(tiff.decode_tiff(deflate), big)


def _fillorder2(data: bytes) -> bytes:
    """A classic little-endian TIFF with a FillOrder of 2 added to its IFD
    (a new IFD at the end, the header pointed at it)."""
    import struct

    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    entries = [data[ifd + 2 + 12 * k: ifd + 14 + 12 * k] for k in range(n)]
    entries.append(struct.pack("<HHII", 266, 3, 1, 2))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    return (data[:4] + struct.pack("<I", len(data)) + data[8:] + struct.pack("<H", n + 1)
            + b"".join(entries) + b"\0\0\0\0")


def _pil_file(img: Image.Image, fmt: str = "TIFF", **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _refused_cases():
    """{name: (bytes, message pattern)}: files Pillow fails on too ("lab.tif"
    is ICCLab, Photometric 9: the CIELab file it once held now decodes, in
    :func:`_formerly_refused_cases`)."""
    a = TOOL.image((16, 16, 3), 500)
    out = {"lab.tif": (TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1,
                                          photometric=9), "ICCLab")}
    out["signed.tif"] = (TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1,
                                            photometric=2, sample_format=2), "SampleFormat")
    out["pred3.tif"] = (TOOL.assemble_tiff(a.shape, [zlib.compress(a.tobytes())],
                                           compression=8, photometric=2, predictor=3),
                        "Predictor 3")
    for comp, what in ((6, "old-style jpeg"), (33003, "jpeg 2000"), (33005, "jpeg 2000"),
                       (34712, "jpeg 2000"), (50000, "unknown")):
        out[f"comp{comp}.tif"] = (TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=comp,
                                                     photometric=2),
                                  f"compression {comp} \\({what}\\)")
    out["jpeg_planar2.tif"] = (TOOL.assemble_tiff(a.shape, [b"\xff\xd8"] * 3, compression=7,
                                                  photometric=2, planar=2),
                               "JPEG with PlanarConfiguration 2")
    out["ycbcr_raw.tif"] = (TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1,
                                               photometric=6), "YCbCr samples outside JPEG")
    raw = TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1, photometric=2)
    lzw = TOOL.pillow_segment(a, 5)[0]
    out["truncated_lzw.tif"] = (TOOL.assemble_tiff(a.shape, [lzw[:len(lzw) // 2]],
                                                   compression=5, photometric=2),
                                "strip 0: LZW data ends")
    out["old_lzw.tif"] = (TOOL.assemble_tiff(a.shape, [b"\x00\x01" + lzw[2:]], compression=5,
                                             photometric=2), "old-style")
    out["cut.tif"] = (raw[:100], "truncated TIFF")
    good = TOOL.assemble_png(a, 2)
    out.update({
        "badcrc.png": (good[:40] + bytes([good[40] ^ 1]) + good[41:], "bad CRC"),
        "cut.png": (good[:len(good) // 2], "truncated PNG")})
    return out


REFUSED = sorted(_refused_cases())


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_naming_the_file(name, tmp_path, monkeypatch):
    data, pattern = _refused_cases()[name]            # Pillow writes some
    _block_pil(monkeypatch)
    path = _write(tmp_path, name, data)
    with pytest.raises(ValueError, match=rf"{name}.*({pattern})"):
        _port(path)


def _formerly_refused_cases():
    """{name: bytes}: the files this test once held refused that Pillow
    decodes, now held to the JAX package's pixels (16-bit, 1-bit, float,
    CMYK, FillOrder 2, a progressive JPEG tile; 1-, 2-, 4- and 16-bit and
    Adam7 PNGs, the last two now valid files)."""
    a = TOOL.image((16, 16, 3), 500)
    rgb = Image.fromarray(a)
    wide = Image.fromarray(np.arange(256, dtype=np.uint16).reshape(16, 16) * 200)
    raw = TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1, photometric=2)
    pal = Image.fromarray(a[..., 0] % 4, "P")
    pal.putpalette([0, 0, 0, 90, 90, 90, 180, 180, 180, 255, 255, 255])
    return {"bits16.tif": _pil_file(wide),
            "bits1.tif": _pil_file(rgb.convert("1"), compression="group4"),
            "bits1_raw.tif": _pil_file(rgb.convert("1")),
            "float.tif": _pil_file(Image.fromarray(np.ones((8, 8), np.float32), "F")),
            "cmyk.tif": _pil_file(rgb.convert("CMYK")),
            "fillorder2.tif": _fillorder2(raw),
            "progressive_tile.tif": TOOL.assemble_tiff(
                a.shape, [_pil_file(rgb, "JPEG", progressive=True)], compression=7,
                photometric=6, tile=(16, 16)),
            "adam7.png": TOOL.assemble_png(a, 2, interlace=1),
            "lab.tif": _pil_file(rgb.convert("LAB")),
            "png1.png": _pil_file(rgb.convert("1"), "PNG"),
            "png2.png": _pil_file(pal, "PNG"),
            "png4.png": TOOL.assemble_png(a[..., 0] >> 4, 0, depth=4),
            "png16.png": _pil_file(wide, "PNG")}


FORMERLY_REFUSED = sorted(_formerly_refused_cases())


@pytest.mark.parametrize("name", FORMERLY_REFUSED)
def test_formerly_refused_files_decode_as_jax(name, tmp_path, monkeypatch):
    path = _write(tmp_path, name, _formerly_refused_cases()[name])
    want = jax_decode_slide(str(path))
    _block_pil(monkeypatch)
    got = _port(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_tiff_and_png_never_reach_pil(tmp_path, monkeypatch):
    """PIL installed but its ``open`` fails: TIFF and PNG slides still
    decode, an unsupported one raises the reader's ``ValueError``, and a
    BMP goes to PIL (and without PIL raises ``ImportError`` naming it)."""
    a = TOOL.image((12, 10, 3), 600)
    good = _write(tmp_path, "good.tif", TOOL.assemble_tiff(a.shape, [a.tobytes()],
                                                           compression=1, photometric=2))
    pngf = _write(tmp_path, "good.png", TOOL.assemble_png(a, 2))
    bad = _write(tmp_path, "bad.tif", TOOL.assemble_tiff(a.shape, [a.tobytes()],
                                                         compression=33003, photometric=2))
    bmp = tmp_path / "slide.bmp"
    Image.fromarray(a).save(bmp)

    def refuse(*args, **kw):
        raise AssertionError("PIL was asked to open a slide")

    monkeypatch.setattr(Image, "open", refuse)
    np.testing.assert_array_equal(_port(good), a)
    np.testing.assert_array_equal(_port(pngf), a)
    with pytest.raises(ValueError, match=r"bad\.tif.*jpeg 2000"):
        _port(bad)
    with pytest.raises(AssertionError, match="PIL was asked"):
        _port(bmp)
    monkeypatch.undo()
    np.testing.assert_array_equal(_port(bmp), a)
    _block_pil(monkeypatch)
    with pytest.raises(ImportError, match=r"slide\.bmp"):
        _port(bmp)


@pytest.mark.parametrize("name", NAMES)
def test_info_matches_pillow_size(name):
    path = FIXTURES / name
    with Image.open(path) as im:
        w, h = im.size
        samples = len(im.getbands())
    info = (tiff.tiff_info if name.endswith(".tif") else png.png_info)(path)
    assert (info["height"], info["width"]) == (h, w)
    assert info["samples"] >= 1 and (info["samples"] == samples or name.endswith(".tif"))
    assert info["compression"] in ("none", "lzw", "deflate", "packbits", "jpeg",
                                   "ccitt rle", "ccitt group 3", "ccitt group 4")
    assert (tiff.is_tiff_file(path), png.is_png_file(path)) == \
        (name.endswith(".tif"), name.endswith(".png"))


def test_failed_build_raises(tmp_path, monkeypatch):
    from gridnext_tpu_torch.ops import _host

    monkeypatch.setattr(_host, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host build of raster_codec.cpp failed"):
        _host.build("raster_codec")
    assert not list(tmp_path.iterdir())


def test_pseudo_visium_from_image_tiff_matches_jax(tmp_path, monkeypatch):
    """The image's first dimension comes from the TIFF's or PNG's header."""
    a = TOOL.image((160, 120, 3), 700)
    files = {"roi.tif": TOOL.assemble_tiff(a.shape, [zlib.compress(a.tobytes())],
                                           compression=8, photometric=2),
             "roi6.tif": TOOL.assemble_tiff(a.shape, [a.tobytes()], compression=1,
                                            photometric=2, orientation=6),
             "roi.png": TOOL.assemble_png(a, 2)}
    paths = {name: _write(tmp_path, name, data) for name, data in files.items()}
    for name, path in paths.items():
        jax_simulate.pseudo_visium_from_image(path, tmp_path / "jax" / name)
    _block_pil(monkeypatch)
    for name, path in paths.items():
        simulate.pseudo_visium_from_image(path, tmp_path / "port" / name)
    n = 0
    for root, _, names in os.walk(tmp_path / "jax"):
        for f in names:
            rel = os.path.relpath(os.path.join(root, f), tmp_path / "jax")
            assert (tmp_path / "port" / rel).read_bytes() == \
                (tmp_path / "jax" / rel).read_bytes(), rel
            n += 1
    assert n == 2 * len(files)


def test_register_tiff_slide_matches_jax(tmp_path):
    """One small ``register`` of a TIFF slide through both packages'
    commands: equal Loupe CSVs."""
    from gridnext_tpu.data import simulate_spaceranger_dir
    from gridnext_tpu.models import GridNetHex, TpuPatchClassifier
    from gridnext_tpu.train import create_train_state, make_gridwise_optimizer, save_checkpoint

    sim = simulate_spaceranger_dir(tmp_path / "a0", seed=3, n_genes=5, n_classes=3, image=True,
                                   spot_spacing_px=10, tissue_fraction=0.4)
    srd = str(Path(sim["spaceranger_dir"]) / "outs")
    pixels = np.asarray(Image.open(sim["image_file"]).convert("RGB"))
    slide = tmp_path / "slide.tif"
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "TIFF", compression="tiff_lzw", tiffinfo={317: 2, 278: 16})
    slide.write_bytes(buf.getvalue())
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
    args = ["register", "--model", str(model), "--images", str(slide), "--spaceranger", srd]
    jax_main(args + ["--out", str(tmp_path / "jax.csv")])
    port_main(args + ["--out", str(tmp_path / "port.csv"), "--device", "cpu"])
    jax_csv = (tmp_path / "jax.csv").read_bytes()
    assert jax_csv.count(b"\n") > 100
    assert (tmp_path / "port.csv").read_bytes() == jax_csv
