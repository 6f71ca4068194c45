"""The port's multimodal slice against the JAX package.

A ``GridNetHexMM`` with a small scBERT count f (dim 32, depth 2, heads 2,
``dim_head`` 16, m 24, 50 genes) and a small ``TpuPatchClassifier`` image
f, its weights initialised in JAX (BatchNorm statistics and every param
moved by numpy noise) and carried across by the weight bridge; inputs from
a numpy seed. Covered:

- ``GridNetHexMM`` logits against ``model.apply`` with ``count_chunk`` 3
  and ``patch_chunk`` 7, neither dividing the grid (the largest difference
  within 1e-4 of the largest logit);
- ``load_gridnet_hex_mm``: every leaf used, an extra or a missing leaf
  refused, ``jax_variables`` naming exactly what flax names;
- a model directory as ``train-mm`` writes it, served by
  ``mm_model_from_meta`` + ``scbert_transform`` + ``register_mm_grid`` on a
  78 x 64 grid, against the JAX route (``server.py``'s register step):
  labels equal up to near-ties, foreground equal to the tissue;
- the DenseNet-121 image-f branch, and the branches that wait for a later
  slice (``NotImplementedError``) or a card (``RuntimeError``).
"""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.models.scbert import load_gene2vec_names as jax_gene2vec
from gridnext_tpu.models.scbert import preprocess_scbert as jax_preprocess
from gridnext_tpu_torch import modeldir, serving
from gridnext_tpu_torch.compat.from_jax import (jax_variables, load_gridnet_hex_mm,
                                                load_model_dir)
from gridnext_tpu_torch.models import (GridNetHexMM, GridNetMM, TpuPatchClassifier,
                                       densenet121, scBERT)
from gridnext_tpu_torch.ops import favor_cuda

N_CLASSES, GENES, PATCH = 3, 50, 16
SCBERT_KW = dict(n_genes=GENES, dim=32, depth=2, heads=2, dim_head=16, nb_features=24,
                 n_classes=N_CLASSES, generalized_attention=True)
TPU_F = {"stages": [[16, 1]], "stem_patch": 8, "norm": "rms"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mm(patch_chunk=7, count_chunk=3):
    return JaxGridNetHexMM(
        image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),), stem_patch=8),
        count_classifier=JaxScBERT(**SCBERT_KW), n_classes=N_CLASSES,
        patch_chunk=patch_chunk, count_chunk=count_chunk)


def _port_mm(patch_chunk=7, count_chunk=3):
    return GridNetHexMM(TpuPatchClassifier(n_classes=N_CLASSES, stages=((16, 1),),
                                           stem_patch=8),
                        scBERT(**SCBERT_KW), N_CLASSES, patch_chunk=patch_chunk,
                        count_chunk=count_chunk)


def _grids(b, h, w, seed=0, tissue=None):
    """(image grid, raw count grid): /255-scale patches and Poisson counts
    at the tissue cells, zeros elsewhere."""
    rng = np.random.default_rng(seed)
    tissue = np.ones((b, h, w), bool) if tissue is None else tissue
    xi = rng.integers(0, 256, (b, h, w, PATCH, PATCH, 3)).astype(np.float32) / 255.0
    xc = rng.poisson(0.8, (b, h, w, GENES)).astype(np.float32)
    xc[..., 0] += 1                               # every tissue cell has counts
    return xi * tissue[..., None, None, None], xc * tissue[..., None]


@pytest.fixture(scope="module")
def jax_model_vars():
    """A JAX GridNetHexMM and its variables, moved off init by numpy noise
    (BatchNorm variances kept positive)."""
    g = _jax_mm()
    xi, xc = _grids(1, 2, 2)
    variables = _np_tree(g.init(jax.random.key(0), (jnp.asarray(xi), jnp.asarray(np.log2(1 + xc)))))
    rng = np.random.default_rng(1)

    def move(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[0] == "favor":
            return a
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return g, jax.tree_util.tree_map_with_path(move, variables)


def _assert_rel(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"max abs err {err}"


def test_gridnet_hex_mm_matches_jax(jax_model_vars):
    g, variables = jax_model_vars
    xi, xc = _grids(2, 5, 4, seed=2)              # 40 cells: chunks 3 and 7 leave a rest
    xc = np.log2(1 + xc)
    want = g.apply(variables, (jnp.asarray(xi), jnp.asarray(xc)))
    port = load_gridnet_hex_mm(_port_mm(), variables).eval()
    assert port.corrector.convs[0].kernel.shape[1] == 2 * N_CLASSES   # count + image
    with torch.no_grad():
        got = port((torch.from_numpy(xi), torch.from_numpy(xc)))
        ppg = port.patch_predictions((torch.from_numpy(xi), torch.from_numpy(xc)))
        count_f = port.count_classifier(torch.from_numpy(xc.reshape(-1, GENES)))
    assert got.shape == (2, 5, 4, N_CLASSES)
    _assert_rel(got, want)
    # count first, then image (chunks of 3 against one batch of 40)
    np.testing.assert_allclose(ppg[..., :N_CLASSES].reshape(-1, N_CLASSES).numpy(),
                               count_f.numpy(), rtol=0, atol=1e-5)


def test_load_gridnet_hex_mm_uses_every_leaf(jax_model_vars):
    _, variables = jax_model_vars
    names = {jax.tree_util.keystr(p): np.shape(a)
             for p, a in jax.tree_util.tree_leaves_with_path(variables)}
    port_names = {jax.tree_util.keystr(p): np.shape(a)
                  for p, a in jax.tree_util.tree_leaves_with_path(jax_variables(_port_mm()))}
    assert port_names == names
    load_gridnet_hex_mm(_port_mm(), variables)
    extra = {**variables, "favor": {"count_classifier": {
        **variables["favor"]["count_classifier"], "stray": np.zeros(2, np.float32)}}}
    with pytest.raises(ValueError, match="does not have"):
        load_gridnet_hex_mm(_port_mm(), extra)
    missing = {k: v for k, v in variables.items() if k != "favor"}
    with pytest.raises(ValueError, match="no favor/count_classifier"):
        load_gridnet_hex_mm(_port_mm(), missing)


def _ellipse(h=78, w=64):
    yy, xx = np.mgrid[:h, :w]
    return ((yy - h / 2) / (0.4 * h)) ** 2 + ((xx - w / 2) / (0.4 * w)) ** 2 <= 1


def _symbols():
    """Cohort genes: most in the first GENES gene2vec names (one repeated),
    some beyond the vocabulary, some unknown."""
    vocab = jax_gene2vec()
    return vocab[:GENES:2] + [vocab[5], vocab[GENES + 3], "NOT_A_GENE"] + \
        vocab[1:GENES:2][:GENES - 28]


@pytest.fixture(scope="module")
def mm_model_dir(tmp_path_factory, jax_model_vars):
    """A model directory with the meta ``train-mm`` writes (count_chunk 64)."""
    _, variables = jax_model_vars
    d = tmp_path_factory.mktemp("torch_mm_modeldir")
    meta = {"classes": ["A", "B", "C"], "patch_px": PATCH, "window_px": None,
            "patch_chunk": 624, "count_chunk": 64, "n_genes": GENES, "genes": _symbols(),
            "log1p": False, "count_f": "scbert", "scbert_vocab": GENES, "scbert_dim": 32,
            "scbert_depth": 2, "scbert_heads": 2, "scbert_dim_head": 16,
            "scbert_features": 24, "hd_binning": None, "grid_dims": None,
            "image_f": "tpu", "tpu_f": TPU_F, "dense_ingest": False,
            "model": "GridNetHexMM"}
    (d / "model.json").write_text(json.dumps(meta))
    payload = {"params": variables["params"], "batch_stats": variables["batch_stats"],
               "extra_vars": {"favor": variables["favor"]}, "step": 1}
    (d / "g_state.msgpack").write_bytes(flax.serialization.msgpack_serialize(payload))
    return d


def test_mm_model_dir_registers_like_jax(mm_model_dir):
    """The register step of the JAX server (fg from raw counts, the gene2vec
    transform, ``g.apply``, argmax + 1 masked by fg) against the port's."""
    meta, classes, variables = load_model_dir(mm_model_dir)
    symbols = meta["genes"]
    tissue = _ellipse()
    xi, raw = _grids(1, 78, 64, seed=3, tissue=tissue[None])
    xi, raw = xi[0], raw[0]

    jmeta, jclasses, jvars = jax_modeldir.load_model_dir(mm_model_dir)
    g = jax_modeldir.mm_model_from_meta(jmeta, jclasses)
    target = jax_gene2vec()[:jmeta["scbert_vocab"]]
    jxc, _ = jax_preprocess(raw.reshape(-1, raw.shape[-1]), symbols, target_genes=target)
    jxc = jxc.reshape(78, 64, len(target))
    logits = np.asarray(g.apply(jvars, (jnp.asarray(xi[None]), jnp.asarray(jxc[None]))))[0]
    want = np.where(raw.sum(-1) > 0, logits.argmax(-1) + 1, 0)

    transform = modeldir.scbert_transform(symbols, meta["scbert_vocab"])
    np.testing.assert_array_equal(transform(raw), jxc)
    model = modeldir.mm_model_from_meta(meta, classes, variables, device="cpu")
    assert not model.training and model.count_chunk == 64
    before = favor_cuda.launches
    got = serving.register_mm_grid(model, xi, raw, transform, device="cpu")
    assert favor_cuda.launches == before          # the CPU takes the plain ops
    assert got.shape == (78, 64) and got.dtype == np.int32
    np.testing.assert_array_equal(got > 0, tissue)
    serving.label_parity_report(want, got, logits)


def test_mm_model_from_meta_densenet_image_f():
    """``image_f`` other than "tpu" builds DenseNet-121 (``train-mm``'s
    default f), loaded through the same bridge."""
    src = GridNetHexMM(densenet121(num_classes=N_CLASSES), scBERT(**SCBERT_KW), N_CLASSES,
                       patch_chunk=4, count_chunk=2)
    variables = jax_variables(src)
    meta = {"model": "GridNetHexMM", "count_f": "scbert", "image_f": "densenet",
            "scbert_vocab": GENES, "scbert_dim": 32, "scbert_depth": 2, "scbert_heads": 2,
            "scbert_dim_head": 16, "scbert_features": 24, "patch_chunk": 4, "count_chunk": 2}
    model = modeldir.mm_model_from_meta(meta, ["A", "B", "C"], variables, device="cpu")
    rng = np.random.default_rng(4)
    x = (torch.from_numpy(rng.random((1, 2, 3, 32, 32, 3)).astype(np.float32)),
         torch.from_numpy(rng.uniform(0, 6, (1, 2, 3, GENES)).astype(np.float32)))
    with torch.no_grad():
        torch.testing.assert_close(model(x), src.eval()(x), rtol=0, atol=0)


def test_mm_unported_branches_raise(mm_model_dir):
    """The square lattice (``GridNetMM``) is ported: its meta builds the
    Cartesian-corrector model, which refuses this hex directory's corrector
    weights (parity with JAX is in ``test_torch_square.py``); a cohort
    without scBERT genes still raises."""
    meta, classes, variables = load_model_dir(mm_model_dir)
    square = {**meta, "model": "GridNetMM", "grid_dims": [50, 50]}
    with pytest.raises(ValueError, match="corrector/Conv_0"):
        modeldir.mm_model_from_meta(square, classes, variables, device="cpu")
    assert isinstance(GridNetMM(densenet121(num_classes=N_CLASSES), scBERT(**SCBERT_KW),
                                N_CLASSES).corrector.convs[0], torch.nn.Conv2d)
    with pytest.raises(ValueError, match="no cohort gene"):
        modeldir.scbert_transform(["NOT_A_GENE"], GENES)


def test_mm_entry_points_default_to_cuda(monkeypatch, mm_model_dir):
    meta, classes, variables = load_model_dir(mm_model_dir)
    model = modeldir.mm_model_from_meta(meta, classes, variables, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        modeldir.mm_model_from_meta(meta, classes, variables)
    xi, raw = _grids(1, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.register_mm_grid(model, xi[0], raw[0])
