"""The JPEG patch caches in both packages: the port's writer against the
JAX package's, the port's readers on JAX-written caches, the factory's
route, and training over a cache.

On one small simulated cohort (2 arrays, 32-px patches):

- ``python -m gridnext_tpu_torch prepare --images --device cpu`` (Visium,
  ``--window-px``, Visium HD on a ``simulate --hd-grid`` lattice) writes
  cache directories file-for-file byte-equal to ``python -m gridnext_tpu
  prepare --images``; ``save_visium_patches`` drops spots outside a cut
  lattice with the JAX package's warning, to the same files;
- ``PatchGridDataset``, ``PatchSpotDataset`` and the cache forms of
  ``MMSpotDataset`` and ``MMStackDataset``, built by the port's factory on
  JAX-written caches, equal the JAX factory's datasets bit for bit (grids,
  labels, spot items, count vectors), and within 1e-6 with
  ``make_imagenet_transform``;
- the factory takes the cache route exactly when ``save_patches_to`` is
  given or ``fullres_image_files`` is None, raising the JAX package's
  ``ValueError`` when a cache is missing and no image is given;
- one spotwise epoch of both packages' ``train-image`` over the same JPEG
  cache from the same variables agrees as
  ``tests/test_torch_train_image_parity.py`` holds it (``F_RTOL``, correct
  spots within one);
- ``ingest.decode_slide``, ``simulate`` and ``prepare --images`` with PIL
  unimportable.
"""

import filecmp
import functools
import importlib.util
import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import cli as jax_cli
from gridnext_tpu import models as jax_models
from gridnext_tpu import pipeline as jax_pipeline
from gridnext_tpu.data import datasets as jax_datasets
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.train import loops as jl
from gridnext_tpu_torch import cli, ingest, models, pipeline
from gridnext_tpu_torch import data as port_data
from gridnext_tpu_torch import train as port_train
from gridnext_tpu_torch.compat.from_jax import load_variables
from gridnext_tpu_torch.data import datasets
from gridnext_tpu_torch.data import simulate as port_simulate
from gridnext_tpu_torch.train import loops as tl

REPO = Path(__file__).resolve().parents[1]
HD = ("square_016um", (40, 36))


def _parity_module():
    spec = importlib.util.spec_from_file_location(
        "train_image_parity", REPO / "tests" / "test_torch_train_image_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _simulate(root, hd=False):
    kw = dict(n_genes=8, n_classes=3, image=True, spot_spacing_px=20, tissue_fraction=0.2)
    if hd:
        kw.update(hd_grid=HD[1], hd_binning=HD[0], spaceranger_version="hd", spot_spacing_px=24,
                  tissue_fraction=0.5)
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=20 + i, **kw) for i in range(2)]
    return {"root": root, "dirs": [s["spaceranger_dir"] for s in sims],
            "annots": [s["annot_file"] for s in sims],
            "images": [s["image_file"] for s in sims]}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The cohort with JAX-written 32-px caches beside each directory."""
    c = _simulate(tmp_path_factory.mktemp("cohort"))
    jax_cli.main(["prepare", "--spaceranger", *c["dirs"], "--images", *c["images"],
                  "--patch-px", "32"])
    return c


def _moved(c, root):
    """The cohort copied to ``root`` (its paths rewritten)."""
    shutil.copytree(c["root"], root)
    return {k: ([str(root / Path(p).relative_to(c["root"])) for p in v] if k != "root" else root)
            for k, v in c.items()}


def _cache_dirs(c):
    return sorted(str(p.relative_to(c["root"])) for p in Path(c["root"]).glob("*/*_patches*"))


def _assert_same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files), (
        cmp.left_only[:3], cmp.right_only[:3], cmp.diff_files[:3])
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors, (mismatch[:3], errors[:3])


@pytest.mark.parametrize("variant", ["visium", "window", "hd"])
def test_prepare_images_matches_jax(variant, tmp_path):
    flags = ["--patch-px", "32"]
    if variant == "window":
        flags += ["--window-px", "40"]
    hd = variant == "hd"
    if hd:
        flags += ["--hd-binning", HD[0]]
    jc = _simulate(tmp_path / "jax", hd=hd)
    pc = _moved(jc, tmp_path / "port")
    jax_cli.main(["prepare", "--spaceranger", *jc["dirs"], "--images", *jc["images"], *flags])
    cli.main(["prepare", "--spaceranger", *pc["dirs"], "--images", *pc["images"], *flags,
              "--device", "cpu"])
    caches = _cache_dirs(jc)
    assert len(caches) == 2 and caches == _cache_dirs(pc)
    if hd:
        assert all(f"_{HD[0]}_{HD[1][0]}x{HD[1][1]}_patches32px" in d for d in caches)
    for d in caches:
        assert len(os.listdir(jc["root"] / d)) > 100
        _assert_same_tree(jc["root"] / d, pc["root"] / d)


def test_writer_drops_spots_outside_the_lattice_as_jax_does(cohort, tmp_path, capsys):
    srd, img = cohort["dirs"][0], cohort["images"][0]
    jax_pipeline.save_visium_patches(img, srd, tmp_path / "jax", patch_size=32, h_st=40)
    want = capsys.readouterr().out
    n = pipeline.save_visium_patches(img, srd, tmp_path / "port", patch_size=32, h_st=40,
                                     device="cpu")
    got = capsys.readouterr().out
    assert want.startswith("Warning: ") and "outside the 40x64 grid dropped" in want
    assert got == want
    assert n == len(os.listdir(tmp_path / "port")) > 0
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


def _both(cohort, **kw):
    base = dict(annot_files=cohort["annots"], patch_size_px=32, fullres_image_files=None)
    base.update(kw)
    return (jax_datasets.create_visium_dataset(cohort["dirs"], **base),
            datasets.create_visium_dataset(cohort["dirs"], device="cpu", **base))


def test_readers_equal_jax_on_jax_caches(cohort):
    want, got = _both(cohort, use_count=False, spatial=True)
    assert type(got).__name__ == "PatchGridDataset" and len(got) == len(want) == 2
    assert list(got.classes) == list(want.classes)
    assert got.source_ids() == want.source_ids()
    for i in range(2):
        (wx, wy), (gx, gy) = want[i], got[i]
        assert torch.is_tensor(gx) and gx.dtype == torch.float32
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy, wy)
        assert wy.max() > 0
    assert tuple(got.sample_item().shape) == want.sample_item().shape

    want, got = _both(cohort, use_count=False, spatial=False)
    assert type(got).__name__ == "PatchSpotDataset" and len(got) == len(want) > 100
    assert got.source_ids() == want.source_ids()
    wx, wy = want.materialize()
    gx, gy = got.materialize()
    np.testing.assert_array_equal(gx.numpy(), wx)
    np.testing.assert_array_equal(gy, wy)
    x5, y5 = got[5]
    np.testing.assert_array_equal(x5.numpy(), want[5][0])
    assert y5 == want[5][1]


def test_multimodal_cache_forms_equal_jax(cohort):
    want, got = _both(cohort, use_count=True, spatial=False)
    assert type(got).__name__ == "MMSpotDataset" and len(got) == len(want) > 100
    (wi, wc), wy = want.materialize()
    (gi, gc), gy = got.materialize()
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gy, wy)
    assert got.source_ids() == want.source_ids()

    want, got = _both(cohort, use_count=True, spatial=True)
    assert type(got).__name__ == "MMStackDataset" and len(got) == len(want) == 2
    (wi, wc), wy = want[1]
    (gi, gc), gy = got[1]
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gy, wy)


def test_imagenet_transform_through_the_readers(cohort):
    kw = dict(use_count=False, spatial=False)
    want = jax_datasets.create_visium_dataset(
        cohort["dirs"], annot_files=cohort["annots"], patch_size_px=32,
        img_transforms=jax_pipeline.make_imagenet_transform(48, 40), **kw)
    got = datasets.create_visium_dataset(
        cohort["dirs"], annot_files=cohort["annots"], patch_size_px=32, device="cpu",
        img_transforms=pipeline.make_imagenet_transform(48, 40), **kw)
    idx = np.arange(0, len(want), 17)
    gx, gy = got.batch(idx)
    wx = np.stack([want[int(i)][0] for i in idx])
    assert gx.shape == wx.shape == (len(idx), 40, 40, 3)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gy, [want[int(i)][1] for i in idx])


def test_factory_route(cohort, tmp_path):
    kw = dict(annot_files=cohort["annots"], patch_size_px=32, use_count=False)
    before = _cache_dirs(cohort)
    # fullres images and no save_patches_to: the card's crop, no file
    crop = datasets.create_visium_dataset(cohort["dirs"], fullres_image_files=cohort["images"],
                                          device="cpu", **kw)
    assert type(crop).__name__ == "SlideGridDataset"
    spots = datasets.create_visium_dataset(cohort["dirs"], fullres_image_files=cohort["images"],
                                           device="cpu", spatial=False, **kw)
    assert type(spots).__name__ == "SlideSpotDataset"
    with pytest.raises(ValueError, match="img_transforms applies to the patch caches"):
        datasets.create_visium_dataset(cohort["dirs"], fullres_image_files=cohort["images"],
                                       device="cpu", img_transforms=lambda x: x, **kw)
    assert _cache_dirs(cohort) == before
    # save_patches_to: missing caches written there (JAX's bytes), then read
    ds = datasets.create_visium_dataset(cohort["dirs"], fullres_image_files=cohort["images"],
                                        save_patches_to=tmp_path / "saved", device="cpu", **kw)
    assert type(ds).__name__ == "PatchGridDataset"
    assert sorted(os.listdir(tmp_path / "saved")) == ["a0_patches32px", "a1_patches32px"]
    for i, srd in enumerate(cohort["dirs"]):
        name = Path(srd).name
        _assert_same_tree(Path(srd) / f"{name}_patches32px",
                          tmp_path / "saved" / f"{name}_patches32px")
        assert ds.img_dirs[i] == str(tmp_path / "saved" / f"{name}_patches32px")
    assert _cache_dirs(cohort) == before
    # no images: the caches beside the directories, which must exist
    for factory in (jax_datasets.create_visium_dataset, datasets.create_visium_dataset):
        with pytest.raises(ValueError, match="Must provide fullres_image_files to extract "
                                             "image patches"):
            factory(cohort["dirs"], window_size_px=40, **kw)


def test_one_spotwise_epoch_matches_jax_over_a_jpeg_cache(cohort, tmp_path, monkeypatch):
    """Both packages' ``train-image`` (``--epochs 1``) over the JAX-written
    JPEG cache: the JAX command reads it as its factory does; the port's
    factory is sent down its cache route (``fullres_image_files=None``)."""
    par = _parity_module()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rec = {"jax": {"inits": [], "spot_val": []}, "port": {"inits": [], "spot_val": []}}
    argv = ["train-image", "--spaceranger", *cohort["dirs"], "--annots", *cohort["annots"],
            "--images", *cohort["images"], "--f", "tpu", "--patch-px", "32", "--epochs", "1",
            "--batch-size", "64", "--patch-chunk", "2048", "--f-lr", str(par.LR),
            "--g-lr", str(par.LR)]
    try:
        orig = jl.create_train_state

        def create(model, rng, sample, tx, *a, **kw):
            state = orig(model, rng, sample, tx, *a, **kw)
            params = par._numpy_seeded(state.params, 100 + len(rec["jax"]["inits"]))
            state = state.replace(params=jax.tree.map(jax.numpy.asarray, params))
            rec["jax"]["inits"].append(jax.tree.map(np.asarray, state.variables()))
            return state

        orig_steps = jl.make_steps

        def steps(model, tx, loss_kind, augment=None):
            train_step, eval_step = orig_steps(model, tx, loss_kind, augment=augment)

            def evaluate(state, x, y):
                m = eval_step(state, x, y)
                if loss_kind != "grid":
                    rec["jax"]["spot_val"].append(
                        (float(m["loss"]), int(m["n_correct"]), int(m["n"])))
                return m

            return train_step, evaluate

        from gridnext_tpu import train as jax_train
        monkeypatch.setattr(jax_models, "TpuPatchClassifier",
                            functools.partial(jax_models.TpuPatchClassifier, **par.ARCH))
        monkeypatch.setattr(jl, "create_train_state", create)
        monkeypatch.setattr(jax_train, "create_train_state", create)
        monkeypatch.setattr(jl, "make_steps", steps)
        jax_cli.main(argv + ["--out", str(tmp_path / "jax")])
        monkeypatch.undo()

        inits = iter(rec["jax"]["inits"])
        porig = tl.create_train_state

        def pcreate(model, tx, **kw):
            state = porig(model, tx, **kw)
            load_variables(model, next(inits))
            return state

        porig_steps = tl.make_steps

        def psteps(state, loss_kind, augment=None):
            train_step, eval_step = porig_steps(state, loss_kind, augment=augment)

            def evaluate(x, y):
                m = eval_step(x, y)
                if loss_kind != "grid":
                    rec["port"]["spot_val"].append(
                        (float(m["loss"]), int(m["n_correct"]), int(m["n"])))
                return m

            return train_step, evaluate

        factory = port_data.create_visium_dataset
        routes = []

        def cache_route(*a, **kw):
            kw["fullres_image_files"] = None
            ds = factory(*a, **kw)
            routes.append(type(ds).__name__)
            return ds

        monkeypatch.setattr(models, "TpuPatchClassifier",
                            functools.partial(models.TpuPatchClassifier, **par.ARCH))
        monkeypatch.setattr(tl, "create_train_state", pcreate)
        monkeypatch.setattr(port_train, "create_train_state", pcreate)
        monkeypatch.setattr(tl, "make_steps", psteps)
        monkeypatch.setattr(port_data, "create_visium_dataset", cache_route)
        cli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert routes == ["PatchSpotDataset", "PatchGridDataset"]
    got, want = rec["port"]["spot_val"], rec["jax"]["spot_val"]
    print(f"spotwise validation (loss, correct, spots): JAX {want}, port {got}")
    assert len(got) == len(want) > 0
    for (gl, gc, gn), (wl, wc, wn) in zip(got, want):
        assert gn == wn > 0 and abs(gc - wc) <= 1
        np.testing.assert_allclose(gl, wl, rtol=par.F_RTOL)
    assert (tmp_path / "port" / "model.json").exists()


def test_decode_slide_and_simulate_without_pil(cohort, tmp_path, monkeypatch):
    rgb = cohort["images"][0]
    gray = tmp_path / "gray.jpg"
    Image.open(rgb).convert("L").save(gray, "JPEG", quality=90)
    png = tmp_path / "slide.png"
    Image.open(rgb).save(png)
    bmp = tmp_path / "slide.bmp"
    Image.open(rgb).save(bmp)
    want = [np.asarray(Image.open(p).convert("RGB")) for p in (rgb, gray, png)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for p, w in zip((rgb, gray, png), want):
        got = ingest.decode_slide(p)
        assert got.shape == w.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, w)
    with pytest.raises(ImportError, match="slides other than JPEG, TIFF and PNG decode with PIL"):
        ingest.decode_slide(bmp)
    sim = port_simulate.simulate_spaceranger_dir(tmp_path / "nopil" / "a0", n_genes=5, image=True,
                                                 seed=20, spot_spacing_px=20,
                                                 tissue_fraction=0.2, n_classes=3)
    assert Path(sim["image_file"]).read_bytes() == Path(rgb).read_bytes()
    cli.main(["prepare", "--spaceranger", sim["spaceranger_dir"], "--images", sim["image_file"],
              "--patch-px", "32", "--device", "cpu"])
    _assert_same_tree(Path(cohort["dirs"][0]) / "a0_patches32px",
                      tmp_path / "nopil" / "a0" / "a0_patches32px")
