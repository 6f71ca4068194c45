"""The port's JPEG codec (``gridnext_tpu_torch/io/jpeg.py``) and Pillow's
resample (``pipeline.pil_resample``) against Pillow itself.

Covered, all bit for bit:

- decoding Pillow-written files (sides 32, 33, 100 and 128, qualities 75
  and 95, 4:2:0, 4:2:2, 4:4:4 and grayscale, and restart markers) to
  ``np.asarray(Image.open(...))``;
- encoding to ``Image.save(..., "JPEG")``'s bytes (4:2:0 and grayscale)
  at the default quality and at ``quality=95`` on the same sides, and at
  qualities 1 to 100 on tiny images;
- progressive and CMYK files decoded to Pillow's pixels (the progressive,
  CMYK and sampling cases at large are ``tests/test_torch_slide_formats.py``);
  arithmetic-coded files (SOF9, SOF10, DAC) decoded as their Huffman twins
  and as Pillow; lossless files (SOF3, predictors 1-7, point transforms,
  restarts) as Pillow; data segments cut short or overwritten as Pillow
  decodes them; the files Pillow refuses (12-bit, SOF11, SOF13, lossless
  YCbCr, truncated) refused with a ``ValueError`` naming the file; a
  failed build raising;
- ``decode_jpeg_batch`` with 1 thread and with many, ``encode_jpeg_batch``
  against ``encode_jpeg``, a slide's decode on 1 thread and on many;
- ``pil_resample`` against ``Image.resize`` (bicubic 160 -> 128, 97 -> 32,
  48 -> 32; bilinear 128 -> 256) and ``make_imagenet_transform`` against
  the JAX package's;
- the committed fixtures of ``tools/make_jpeg_fixtures.py`` against a
  fresh run of it.
"""

import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import pipeline as jax_pipeline
from gridnext_tpu_torch import pipeline
from gridnext_tpu_torch.io import jpeg

REPO = Path(__file__).resolve().parents[1]
SIDES = (32, 33, 100, 128)
PIL_SUB = {"4:2:0": 2, "4:2:2": 1, "4:4:4": 0}


def _tool():
    spec = importlib.util.spec_from_file_location("make_jpeg_fixtures",
                                                  REPO / "tools" / "make_jpeg_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _image(h, w, seed, gray=False):
    img = _tool().image((h, w) if gray else (h, w, 3), seed)
    return img


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("side", SIDES)
def test_decode_matches_pil(side, quality):
    for seed, (h, w) in enumerate([(side, side), (side, side + 7)]):
        for sub in ("4:2:0", "4:2:2", "4:4:4"):
            data = _pil_jpeg(_image(h, w, seed), quality=quality, subsampling=PIL_SUB[sub])
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_pixels(data),
                                          err_msg=f"{h}x{w} {sub}")
        data = _pil_jpeg(_image(h, w, seed, gray=True), quality=quality)
        got = jpeg.decode_jpeg(data)
        assert got.shape == (h, w)
        np.testing.assert_array_equal(got, _pil_pixels(data))


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                                {"restart_marker_rows": 1}], ids=["blocks1", "blocks5", "rows1"])
def test_decode_restart_markers(kw):
    for side in (33, 100):
        data = _pil_jpeg(_image(side, side, 3), **kw)
        assert b"\xff\xdd" in data                          # a DRI marker
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_pixels(data))


@pytest.mark.parametrize("side", SIDES)
def test_encode_matches_pil(side):
    for seed, (h, w) in enumerate([(side, side), (side + 5, side)]):
        img = _image(h, w, seed)
        assert jpeg.encode_jpeg(img) == _pil_jpeg(img)                   # quality 75
        assert jpeg.encode_jpeg(img, quality=95) == _pil_jpeg(img, quality=95)
        gray = _image(h, w, seed, gray=True)
        assert jpeg.encode_jpeg(gray, quality=95) == _pil_jpeg(gray, quality=95)
    # a tensor encodes as its pixels do
    assert jpeg.encode_jpeg(torch.from_numpy(img)) == jpeg.encode_jpeg(img)


def test_tiny_and_extreme_images_match_pil():
    for h, w in ((1, 1), (2, 3), (3, 2), (4, 5), (9, 17)):
        for q in (1, 50, 100):
            img = _image(h, w, h * w + q)
            data = _pil_jpeg(img, quality=q)
            assert jpeg.encode_jpeg(img, quality=q) == data, (h, w, q)
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_pixels(data))
    for value in (0, 255):
        img = np.full((24, 24, 3), value, np.uint8)
        assert jpeg.encode_jpeg(img) == _pil_jpeg(img)


def _pil_refuses(data: bytes) -> bool:
    try:
        Image.open(io.BytesIO(data)).load()
    except (OSError, SyntaxError):
        return True
    return False


def test_unsupported_files_raise_naming_the_file(tmp_path):
    """The arithmetic-coded progressive file once refused decodes as Pillow;
    12-bit samples, SOF11 and a file cut in half raise naming the file, as
    Pillow refuses them."""
    data = _pil_jpeg(_image(32, 32, 0))
    sof = data.index(b"\xff\xc0")
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(_tool().transcode(data, 1, arith=True))
    assert arith.read_bytes()[sof:sof + 2] == b"\xff\xca"
    np.testing.assert_array_equal(jpeg.decode_jpeg(arith), _pil_pixels(arith.read_bytes()))
    assert jpeg.jpeg_info(arith)["sof"] == "arithmetic progressive"
    bits12 = tmp_path / "bits12.jpg"
    bits12.write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    with pytest.raises(ValueError, match=r"bits12\.jpg.*12-bit samples"):
        jpeg.decode_jpeg(bits12)
    sof11 = tmp_path / "sof11.jpg"
    sof11.write_bytes(_tool().write_lossless(_image(16, 24, 1), 1).replace(b"\xff\xc3",
                                                                           b"\xff\xcb", 1))
    with pytest.raises(ValueError, match=r"sof11\.jpg.*arithmetic-coded lossless"):
        jpeg.jpeg_info(sof11)
    assert _pil_refuses(bits12.read_bytes()) and _pil_refuses(sof11.read_bytes())
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG not a jpeg")
    data = _pil_jpeg(_image(64, 64, 2))
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:len(data) // 2])
    assert _pil_refuses(data[:len(data) // 2])
    assert jpeg.jpeg_info(data) == {"width": 64, "height": 64, "components": 3,
                                    "sof": "baseline"}


@pytest.mark.parametrize("script", range(5))
def test_arithmetic_files_decode_as_their_huffman_twins(script):
    """Each scan script of the transcoder, arithmetic-coded with libjpeg's
    default and with other DAC conditioning, with and without restarts, on a
    4:2:0, a 4:4:4 and a gray file: the Huffman twin's pixels and Pillow's."""
    tool = _tool()
    img = _image(37, 45, 70 + script)
    for base in (_pil_jpeg(img, quality=85), _pil_jpeg(img, quality=60, subsampling=0),
                 _pil_jpeg(img[..., 2], quality=70)):
        for restart, dac in ((0, True), (2, tool.DAC_WIDE), (5, (0, 0, 63, 15, 15, 1))):
            data = tool.transcode(base, script, restart, arith=dac)
            want = jpeg.decode_jpeg(tool.transcode(base, script, restart))
            for n_threads in (0, 1):     # restart intervals on threads, and in turn
                np.testing.assert_array_equal(jpeg.decode_jpeg(data, n_threads), want)
            np.testing.assert_array_equal(_pil_pixels(data), want)


@pytest.mark.parametrize("pt", [0, 1, 3])
def test_lossless_files_decode_as_pillow(pt):
    """Predictors 1-7 at point transform ``pt``, interleaved or a scan a
    component, with restarts, in RGB, gray and CMYK: Pillow's pixels."""
    tool = _tool()
    rgb = _image(19, 26, 80 + pt)
    cmyk = np.concatenate([rgb, rgb[..., :1] ^ 0x3C], -1)
    for psv in range(1, 8):
        for px, kw in ((rgb, {}), (rgb[..., 0], {"restart_rows": 3}),
                       (rgb, {"interleaved": False, "restart_rows": 2}), (cmyk, {})):
            data = tool.write_lossless(px, psv, pt, **kw)
            want = _pil_pixels(data)
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), want, err_msg=f"{psv} {kw}")
            if px.ndim == 2 or px.shape[2] == 3:    # Pillow gives the samples themselves
                np.testing.assert_array_equal(want, (px >> pt) << pt)
    assert jpeg.jpeg_info(tool.write_lossless(rgb, 1))["sof"] == "lossless"


def test_refused_fixtures_raise_as_pillow_refuses_them():
    """The committed files Pillow refuses (truncated data, SOF11, SOF13,
    lossless YCbCr, 12-bit samples): the port raises naming what it found."""
    refused = _tool().load_refused()
    assert len(refused) == 7
    for name, (data, pattern) in refused.items():
        assert _pil_refuses(data), name
        with pytest.raises(ValueError, match=pattern):
            jpeg.decode_jpeg(data)


def test_progressive_and_cmyk_files_decode_as_pillow(tmp_path):
    """The progressive and CMYK files once refused decode to Pillow's pixels
    (the CMYK one to Pillow's inverted CMYK array)."""
    prog = tmp_path / "prog.jpg"
    Image.fromarray(_image(32, 32, 0)).save(prog, "JPEG", progressive=True)
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog), _pil_pixels(prog.read_bytes()))
    assert jpeg.jpeg_info(prog)["sof"] == "progressive"
    cmyk = tmp_path / "cmyk.jpg"
    Image.fromarray(_image(32, 32, 1)).convert("CMYK").save(cmyk, "JPEG")
    got = jpeg.decode_jpeg(cmyk)
    assert got.shape == (32, 32, 4) and jpeg.read_jpeg(cmyk)[0] == "CMYK"
    np.testing.assert_array_equal(got, _pil_pixels(cmyk.read_bytes()))


def test_failed_build_raises(tmp_path, monkeypatch):
    from gridnext_tpu_torch.ops import _host

    monkeypatch.setattr(_host, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host build of jpeg_codec.cpp failed"):
        _host.build("jpeg_codec")
    assert not list(tmp_path.iterdir())


def test_batches_and_threads(tmp_path):
    patches = np.stack([_image(48, 48, s) for s in range(12)])
    paths = [tmp_path / f"p{i}.jpg" for i in range(len(patches))]
    jpeg.encode_jpeg_batch(patches, paths, quality=75, n_threads=4)
    for img, p in zip(patches, paths):
        assert p.read_bytes() == jpeg.encode_jpeg(img) == _pil_jpeg(img)
    one = jpeg.decode_jpeg_batch(paths, 48, n_threads=1)
    many = jpeg.decode_jpeg_batch(paths, 48, n_threads=8)
    np.testing.assert_array_equal(one, many)
    np.testing.assert_array_equal(one, np.stack([_pil_pixels(p.read_bytes()) for p in paths]))
    with pytest.raises(ValueError, match=r"p3\.jpg: is 48x48x3, not 32x32x3"):
        jpeg.decode_jpeg_batch(paths[3:5], 32)
    assert jpeg.decode_jpeg_batch([], 48).shape == (0, 48, 48, 3)
    # a slide's inverse DCT and colour conversion split over threads
    slide = _image(600, 520, 7)
    data = jpeg.encode_jpeg(slide, quality=95)
    assert data == _pil_jpeg(slide, quality=95)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, n_threads=1),
                                  jpeg.decode_jpeg(data, n_threads=8))


@pytest.mark.parametrize("src,dst,filt", [(160, 128, "bicubic"), (97, 32, "bicubic"),
                                          (48, 32, "bicubic"), (128, 256, "bilinear")])
def test_pil_resample_matches_pillow(src, dst, filt):
    crops = np.stack([_image(src, src, s) for s in range(3)])
    got = pipeline.pil_resample(torch.from_numpy(crops), (dst, dst), filt).numpy()
    resample = Image.BICUBIC if filt == "bicubic" else Image.BILINEAR
    want = np.stack([np.asarray(Image.fromarray(c).resize((dst, dst), resample))
                     for c in crops])
    np.testing.assert_array_equal(got, want)
    # a non-square image, one axis kept
    img = _image(src, src + 9, 5)
    got = pipeline.pil_resample(torch.from_numpy(img), (src, dst), filt).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(Image.fromarray(img).resize((dst, src), resample)))


def test_imagenet_transform_matches_jax():
    x = np.stack([_image(32, 32, s) for s in range(4)]).astype(np.float32) / 255.0
    for resize, crop in ((48, 40), (256, 224)):
        want = np.stack([jax_pipeline.make_imagenet_transform(resize, crop)(p) for p in x])
        got = pipeline.make_imagenet_transform(resize, crop)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (4, crop, crop, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = pipeline.make_imagenet_transform(48, 40)(torch.from_numpy(x[0]))
    assert one.shape == (40, 40, 3)


def test_committed_fixtures_equal_pillow():
    tool = _tool()
    fresh = tool.fixtures()
    committed = tool.load()
    assert sorted(fresh) == sorted(committed)
    for name, f in fresh.items():
        c = committed[name]
        assert c["jpeg"] == f["jpeg"], name
        np.testing.assert_array_equal(c["pixels"], f["pixels"])
        np.testing.assert_array_equal(c["decoded"], f["decoded"])
        assert (c["quality"], c["subsampling"], c["restart_blocks"]) == \
            (f["quality"], f["subsampling"], f["restart_blocks"])
        # and the codec holds to them as the card's check does
        np.testing.assert_array_equal(jpeg.decode_jpeg(c["jpeg"]), c["decoded"])
        if c["subsampling"] == "4:2:0" and not c["restart_blocks"]:
            assert jpeg.encode_jpeg(c["pixels"], quality=c["quality"]) == c["jpeg"], name
