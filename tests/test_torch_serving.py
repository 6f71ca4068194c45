"""The port's slice end to end against the JAX package on simulated slides.

One GridNetHex(TpuPatchClassifier) at small width is initialised in JAX and
carried across by the weight bridge. The JAX SlideRegistrar runs its Pallas
gather and corrector interpreted (as the JAX tests run them on the CPU);
the port's runs on ``device="cpu"``, where its kernels take their plain
versions. Labels must pass ``label_parity_report`` against the JAX logits;
logits agree within 1e-4. Also here: the model-directory route, the Loupe
CSV (byte-identical to the JAX package's) and the position readers.
"""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import evaluate as jax_evaluate
from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.io.spaceranger import read_positions_file as jax_read_positions_file
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.serving import SlideRegistrar as JaxSlideRegistrar
from gridnext_tpu.serving import label_parity_report as jax_parity
from gridnext_tpu_torch import evaluate, modeldir
from gridnext_tpu_torch.compat.from_jax import load_gridnet, load_model_dir
from gridnext_tpu_torch.io import find_position_file, read_positions, read_positions_file
from gridnext_tpu_torch.models import GridNetHex, TpuPatchClassifier
from gridnext_tpu_torch.serving import SlideRegistrar, label_parity_report

N_CLASSES, PATCH = 3, 32
F_KW = dict(stages=((128, 1),), stem_patch=8)


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    # different tissue sizes -> different spot counts -> parked padding
    return [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=8,
                                     n_classes=N_CLASSES, image=True,
                                     tissue_fraction=frac, spot_spacing_px=12)
            for i, frac in enumerate((0.5, 0.3))]


@pytest.fixture(scope="module")
def wsis(sims):
    return np.stack([np.asarray(Image.open(s["image_file"])) for s in sims])


@pytest.fixture(scope="module")
def model():
    jg = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                       n_classes=N_CLASSES)
    variables = jax.tree_util.tree_map(np.asarray, jg.init(
        jax.random.key(0), jnp.zeros((1, 2, 2, PATCH, PATCH, 3), jnp.float32)))
    rng = np.random.default_rng(0)
    for bn in variables["batch_stats"]["corrector"].values():
        bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return jg, variables


def _port_model(variables):
    g = GridNetHex(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                   n_classes=N_CLASSES, f_dim=N_CLASSES)
    return load_gridnet(g, variables)


@pytest.fixture(scope="module", params=["imagenet", None])
def registrars(request, model):
    jg, variables = model
    jax_reg = JaxSlideRegistrar.from_gridnet(
        jg, variables, patch_size=PATCH, normalize=request.param,
        patch_chunk=256, extractor="pallas")
    port_reg = SlideRegistrar.from_gridnet(
        _port_model(variables), patch_size=PATCH, normalize=request.param,
        patch_chunk=256, device="cpu")
    return jax_reg, port_reg


def test_register_logits_and_call_match_jax(registrars, sims, wsis):
    jax_reg, port_reg = registrars
    jpos = jax_read_positions(sims[0]["spaceranger_dir"])
    pos = read_positions(sims[0]["spaceranger_dir"])
    jax_logits, jax_fg = jax_reg.register_logits(jnp.asarray(wsis[0]), jpos)
    logits, fg = port_reg.register_logits(torch.from_numpy(wsis[0]), pos)
    assert logits.dtype == np.float32 and logits.shape == (78, 64, N_CLASSES)
    np.testing.assert_array_equal(fg, jax_fg)
    np.testing.assert_allclose(logits, jax_logits, atol=1e-4, rtol=0)

    want = jax_reg(jnp.asarray(wsis[0]), jpos)
    got = port_reg(wsis[0], pos)          # numpy input moves to the device
    assert got.shape == (78, 64) and got.dtype == np.int32
    jax_parity(want, got, jax_logits)
    np.testing.assert_array_equal(got > 0, sims[0]["label_grid"] > 0)


def test_register_batch_matches_jax(registrars, sims, wsis):
    jax_reg, port_reg = registrars
    jpos = [jax_read_positions(s["spaceranger_dir"]) for s in sims]
    pos = [read_positions(s["spaceranger_dir"]) for s in sims]
    want = jax_reg.register_batch(jnp.asarray(wsis), jpos)
    got = port_reg.register_batch(torch.from_numpy(wsis), pos)
    assert got.shape == (2, 78, 64)
    for i, s in enumerate(sims):
        jax_logits, _ = jax_reg.register_logits(jnp.asarray(wsis[i]), jpos[i])
        label_parity_report(want[i], got[i], jax_logits)
        np.testing.assert_array_equal(got[i] > 0, s["label_grid"] > 0)


def test_registrar_default_device_needs_cuda(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port_model(model[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlideRegistrar.from_gridnet(g, patch_size=PATCH)
    k, b, flags = g.corrector.folded()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlideRegistrar(lambda p: p, k, b, flags, patch_size=PATCH)


def test_registrar_rejects_resize_and_bad_slides(model, wsis, sims):
    """A window other than the patch size is resized now (no longer
    rejected); bad slide inputs still are."""
    g = _port_model(model[1])
    resized = SlideRegistrar.from_gridnet(g, patch_size=PATCH, window_size=2 * PATCH,
                                          device="cpu")
    assert (resized.window_size, resized.patch_size) == (2 * PATCH, PATCH)
    # the resize's weight matrices are built once, with the registrar
    assert [tuple(m.shape) for m in resized._resize] == [(2 * PATCH, PATCH)] * 2
    reg = SlideRegistrar.from_gridnet(g, patch_size=PATCH, device="cpu")
    assert reg.window_size == PATCH and reg._resize is None
    pos = read_positions(sims[0]["spaceranger_dir"])
    with pytest.raises(ValueError, match="uint8"):
        reg(wsis[0].astype(np.float32), pos)
    with pytest.raises(ValueError, match="position sets"):
        reg.register_batch(wsis, [pos])


# -- model directory -----------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, model):
    _, variables = model
    d = tmp_path_factory.mktemp("torch_modeldir")
    meta = {"model": "GridNetHex+TpuPatchClassifier",
            "classes": ["Layer_1", "Layer_2", "Layer_3"],
            "tpu_f": {"stages": [[128, 1]], "stem_patch": 8, "norm": "rms"},
            "patch_px": PATCH, "patch_chunk": 256}
    (d / "model.json").write_text(json.dumps(meta))
    payload = {"params": variables["params"],
               "batch_stats": variables["batch_stats"], "extra_vars": {},
               "step": 3}
    (d / "g_state.msgpack").write_bytes(flax.serialization.msgpack_serialize(payload))
    return d


def test_load_model_dir_matches_jax(model_dir):
    jmeta, jclasses, jvars = jax_modeldir.load_model_dir(model_dir)
    meta, classes, variables = load_model_dir(model_dir)
    assert meta == jmeta and classes == jclasses
    jleaves = jax.tree_util.tree_leaves_with_path(jvars)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in leaves] == [p for p, _ in jleaves]
    for (_, a), (_, b) in zip(leaves, jleaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_image_registrar_from_meta_matches_jax(model_dir, sims, wsis):
    jax_reg = jax_modeldir.image_registrar_from_meta(
        *jax_modeldir.load_model_dir(model_dir))
    port_reg = modeldir.image_registrar_from_meta(*load_model_dir(model_dir),
                                                  device="cpu")
    assert port_reg.normalize is None
    jpos = jax_read_positions(sims[1]["spaceranger_dir"])
    want = jax_reg(jnp.asarray(wsis[1]), jpos)
    got = port_reg(wsis[1], read_positions(sims[1]["spaceranger_dir"]))
    jax_logits, _ = jax_reg.register_logits(jnp.asarray(wsis[1]), jpos)
    label_parity_report(want, got, jax_logits)


@pytest.mark.parametrize("window", [40, 24])
def test_image_registrar_from_meta_resized_window_matches_jax(model_dir, sims, wsis,
                                                               window):
    """``window_px`` != ``patch_px``: crops resized (cubic, antialiased when
    downsampling) as the JAX registrar resizes them."""
    meta, classes, variables = load_model_dir(model_dir)
    meta = dict(meta, window_px=window)
    jax_reg = jax_modeldir.image_registrar_from_meta(meta, classes, variables)
    port_reg = modeldir.image_registrar_from_meta(meta, classes, variables,
                                                  device="cpu")
    assert port_reg.window_size == window
    jpos = jax_read_positions(sims[0]["spaceranger_dir"])
    pos = read_positions(sims[0]["spaceranger_dir"])
    jax_logits, jax_fg = jax_reg.register_logits(jnp.asarray(wsis[0]), jpos)
    logits, fg = port_reg.register_logits(wsis[0], pos)
    np.testing.assert_array_equal(fg, jax_fg)
    # a pixel may round the other way at .5 (within 1 on uint8); f32 otherwise
    np.testing.assert_allclose(logits, jax_logits, atol=1e-3, rtol=0)
    got = port_reg(wsis[0], pos)
    label_parity_report(jax_reg(jnp.asarray(wsis[0]), jpos), got, jax_logits)


def test_image_registrar_from_meta_unported_models(model_dir):
    """A model that is no image model is refused. Square lattices
    (``grid_dims``) are ported (test_torch_square.py): they build the
    Cartesian corrector, which refuses this hex directory's weights.
    (DenseNet-121 directories serve: test_torch_densenet.py.)"""
    meta, classes, variables = load_model_dir(model_dir)
    with pytest.raises(ValueError, match="not an image model"):
        modeldir.image_registrar_from_meta(dict(meta, model="GridNetHex+CountMLP"),
                                           classes, variables, device="cpu")
    with pytest.raises(ValueError, match="corrector/Conv_0"):
        modeldir.image_registrar_from_meta(dict(meta, grid_dims=[10, 10]),
                                           classes, variables, device="cpu")


# -- Loupe export and position readers ------------------------------------------


@pytest.fixture(scope="module", params=[1, 2])
def positions_dir(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"torch_loupe_v{request.param}")
    return simulate_spaceranger_dir(root / "arr", seed=5, n_genes=8, n_classes=3,
                                    spaceranger_version=request.param)


def test_read_positions_matches_jax(positions_dir):
    path = find_position_file(positions_dir["spaceranger_dir"])
    want = jax_read_positions_file(path)
    got = read_positions_file(path)
    assert got.barcodes == list(want.index)
    for col in ("in_tissue", "array_row", "array_col", "pxl_row_in_fullres",
                "pxl_col_in_fullres"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy())


@pytest.mark.parametrize("names", [None, ["Layer_1", "Layer, 2", "Layer_3"]])
def test_loupe_csv_byte_identical(positions_dir, tmp_path, names):
    grid = positions_dir["label_grid"].copy()
    fg = np.argwhere(grid > 0)
    grid[tuple(fg[::7].T)] = 0         # some in-tissue spots left unlabeled
    path = find_position_file(positions_dir["spaceranger_dir"])
    jax_evaluate.to_loupe_annots(grid, path, tmp_path / "jax.csv", annot_names=names)
    evaluate.to_loupe_annots(grid, path, tmp_path / "port.csv", annot_names=names)
    want = (tmp_path / "jax.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == want
    assert want.count(b"\n") == int(np.sum(read_positions_file(path)["in_tissue"])) + 1
