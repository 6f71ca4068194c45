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
  arithmetic-coded and 12-bit files refused with a ``ValueError`` naming
  the file; a failed build raising;
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


def test_unsupported_files_raise_naming_the_file(tmp_path):
    data = _pil_jpeg(_image(32, 32, 0))
    sof = data.index(b"\xff\xc0")
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(data[:sof + 1] + b"\xca" + data[sof + 2:])
    with pytest.raises(ValueError, match=r"arith\.jpg.*arithmetic-coded progressive"):
        jpeg.decode_jpeg(arith)
    with pytest.raises(ValueError, match="arithmetic-coded"):
        jpeg.jpeg_info(arith)
    bits12 = tmp_path / "bits12.jpg"
    bits12.write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    with pytest.raises(ValueError, match=r"bits12\.jpg.*12-bit samples"):
        jpeg.decode_jpeg(bits12)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG not a jpeg")
    data = _pil_jpeg(_image(64, 64, 2))
    with pytest.raises(ValueError, match="premature end|truncated"):
        jpeg.decode_jpeg(data[:len(data) // 2])
    assert jpeg.jpeg_info(data) == {"width": 64, "height": 64, "components": 3,
                                    "sof": "baseline"}


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
