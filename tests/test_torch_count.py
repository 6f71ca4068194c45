"""The port's count route against the JAX package.

Inputs: two simulated Spaceranger arrays (``simulate_spaceranger_dir``) whose
unified count caches the JAX package's ``prepare_count_files`` writes
(multi-member gzip from its native writer), weights initialised in JAX and
moved off init by numpy noise. Covered:

- ``CountMLP`` (with BatchNorm, and the distilled student without it)
  against ``model.apply`` (logits within 1e-4 abs, f32);
- the unified-cache readers and the count grid: ``read_unified_genes``,
  ``validated_unified_cache`` (same errors), ``read_annotated_starray`` and
  ``CountGridDataset`` arrays equal to JAX's, an array without spots an
  empty grid;
- ``grid_model_from_meta`` against JAX's for a count and an image model
  directory, and a square (``grid_dims``) count model (logits within 1e-4);
- a ``count_f: mlp`` multimodal directory through ``register_mm_grid``
  against JAX's ``g.apply`` (labels equal up to near-ties), with BatchNorm
  and as the distilled student (``count_mlp_bn: false``,
  ``count_chunk: null``).
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.data import CountGridDataset as JaxCountGridDataset
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io.annotations import read_annotated_starray as jax_read_starray
from gridnext_tpu.io.unify import read_unified_genes as jax_read_genes
from gridnext_tpu.io.unify import validated_unified_cache as jax_validated
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu_torch import modeldir, serving
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_count_mlp
from gridnext_tpu_torch.data import CountGridDataset
from gridnext_tpu_torch.io.annotations import read_annotated_starray
from gridnext_tpu_torch.io.unify import (read_unified_genes, unified_cache_path,
                                         validated_unified_cache)
from gridnext_tpu_torch.models import CountMLP

N_CLASSES, GENES, PATCH = 3, 24, 16
CLASSES = ["A", "B", "C"]
TPU_F = {"stages": [[16, 1]], "stem_patch": 8, "norm": "rms"}


def _moved(variables, seed=1):
    """Every leaf moved by numpy noise; BatchNorm variances kept positive."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.03 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


def _assert_close(got, want, atol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs err {err}"


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_count")
    dirs = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=GENES,
                                     n_classes=N_CLASSES, tissue_fraction=frac)
            ["spaceranger_dir"] for i, frac in enumerate((0.6, 0.4))]
    caches = prepare_count_files(dirs, minimum_detection_rate=0.02, verbose=False)
    return dirs, caches


@pytest.mark.parametrize("batch_norm", [True, False])
def test_count_mlp_matches_jax(batch_norm):
    f = JaxCountMLP(n_classes=N_CLASSES, batch_norm=batch_norm)
    x = np.random.default_rng(2).poisson(2.0, (37, GENES)).astype(np.float32)
    variables = _moved(f.init(jax.random.key(0), jnp.asarray(x)))
    want = f.apply(variables, jnp.log1p(x))
    port = load_count_mlp(CountMLP(GENES, N_CLASSES, batch_norm=batch_norm), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(np.log1p(x)))
    _assert_close(got, want)
    from gridnext_tpu_torch.models import GridNetHex

    tree = jax_variables(GridNetHex(port, N_CLASSES, N_CLASSES))
    port_f = {c: tree[c]["patch_classifier"] for c in tree if "patch_classifier" in tree[c]}

    def names(t):
        return {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(t)}

    assert names(port_f) == names(variables)


def test_count_grid_matches_jax(cohort, tmp_path):
    dirs, caches = cohort
    with gzip.open(caches[0], "rb") as fh:
        assert fh.read(5) == b"Gene\t"
    for cfile in caches:
        assert read_unified_genes(cfile) == jax_read_genes(cfile)
        got, annots = read_annotated_starray(cfile)
        want, _ = jax_read_starray(cfile)
        assert got.dtype == want.dtype and got.shape == (78, 64, want.shape[-1])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(annots, np.zeros((78, 64), int))
        genes = read_unified_genes(cfile)[::-3]
        np.testing.assert_array_equal(read_annotated_starray(cfile, select_genes=genes)[0],
                                      jax_read_starray(cfile, select_genes=genes)[0])
        for (x, y), (jx, jy) in zip([CountGridDataset([cfile])[0]],
                                    [JaxCountGridDataset([cfile])[0]]):
            assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    # an array without spots: an empty grid; empty cells read as NaN (pandas)
    empty = tmp_path / "empty.unified.tsv.gz"
    with gzip.open(empty, "wt") as fh:
        fh.write("Gene\ng1\ng2\n")
    grid, _ = read_annotated_starray(empty)
    assert grid.shape == (78, 64, 2) and not grid.any()
    holes = tmp_path / "holes.unified.tsv.gz"
    with gzip.open(holes, "wt") as fh:
        fh.write("Gene\t1_1\t2_2\ng1\t\t3\ng2\t1.5\t0\n")
    got, _ = read_annotated_starray(holes)
    want, _ = jax_read_starray(holes)
    np.testing.assert_array_equal(got, want)


def test_validated_cache_errors_match_jax(cohort, tmp_path):
    dirs, caches = cohort
    genes = read_unified_genes(caches[0])
    assert unified_cache_path(dirs[0]) == caches[0]
    assert validated_unified_cache(dirs[0], genes=genes) == jax_validated(dirs[0], genes=genes)
    for srd, kw, exc in ((tmp_path, {}, FileNotFoundError),
                         (dirs[0], {"genes": genes[:-1]}, ValueError)):
        with pytest.raises(exc) as want:
            jax_validated(srd, **kw)
        with pytest.raises(exc) as got:
            validated_unified_cache(srd, **kw)
        # the advice names the port's own prepare command
        assert str(got.value) == str(want.value).replace(
            "python -m gridnext_tpu prepare", "python -m gridnext_tpu_torch prepare")


def _count_dir_vars(genes):
    g = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    return g, _moved(g.init(jax.random.key(0), jnp.zeros((1, 4, 4, genes))))


def _tpu_dir_vars():
    g = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                               stem_patch=8), n_classes=N_CLASSES)
    return g, _moved(g.init(jax.random.key(0), jnp.zeros((1, 2, 2, PATCH, PATCH, 3))))


def test_grid_model_from_meta_matches_jax():
    rng = np.random.default_rng(3)
    _, count_vars = _count_dir_vars(GENES)
    _, tpu_vars = _tpu_dir_vars()
    cases = [({"model": "GridNetHex+CountMLP", "log1p": True, "n_genes": GENES},
              count_vars, np.log1p(rng.poisson(1.5, (1, 6, 5, GENES))).astype(np.float32)),
             ({"model": "GridNetHex+TpuPatchClassifier", "tpu_f": TPU_F, "patch_chunk": 7},
              tpu_vars, rng.random((1, 4, 3, PATCH, PATCH, 3)).astype(np.float32))]
    for meta, variables, x in cases:
        want = jax_modeldir.grid_model_from_meta(meta, CLASSES).apply(variables, jnp.asarray(x))
        model = modeldir.grid_model_from_meta(meta, CLASSES, variables, device="cpu")
        assert not model.training
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        _assert_close(got, want)
    # grid_dims: the square GridNet (Cartesian corrector) over the same f
    x = cases[0][2]
    jg = JaxGridNet(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    square_vars = _moved(jg.init(jax.random.key(2), jnp.zeros((1, 4, 4, GENES))))
    meta = {**cases[0][0], "model": "GridNet+CountMLP", "grid_dims": [6, 5]}
    want = jax_modeldir.grid_model_from_meta(meta, CLASSES).apply(square_vars, jnp.asarray(x))
    model = modeldir.grid_model_from_meta(meta, CLASSES, square_vars, device="cpu")
    with torch.no_grad():
        _assert_close(model(torch.from_numpy(x)), want)
    with pytest.raises(ValueError, match="corrector"):      # a hex checkpoint
        modeldir.grid_model_from_meta(meta, CLASSES, count_vars, device="cpu")


@pytest.mark.parametrize("student", [False, True], ids=["batchnorm", "distilled"])
def test_mm_count_mlp_dir_registers_like_jax(student):
    """A ``count_f: mlp`` multimodal directory (``train-mm``'s meta, or the
    distilled student's) through ``mm_model_from_meta`` and
    ``register_mm_grid`` with ``np.log1p``, against ``g.apply``."""
    meta = {"model": "GridNetHexMM", "count_f": "mlp", "log1p": True, "image_f": "tpu",
            "tpu_f": TPU_F, "patch_px": PATCH, "patch_chunk": 624, "count_chunk": 64,
            "n_genes": GENES, "grid_dims": None, "classes": CLASSES}
    if student:
        meta.update(count_mlp_bn=False, count_chunk=None)
    g = JaxGridNetHexMM(
        image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),), stem_patch=8),
        count_classifier=JaxCountMLP(n_classes=N_CLASSES, batch_norm=not student),
        n_classes=N_CLASSES, patch_chunk=624, count_chunk=meta["count_chunk"])
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:78, :64]
    tissue = ((yy - 39) / 30.0) ** 2 + ((xx - 32) / 25.0) ** 2 <= 1
    xi = rng.random((78, 64, PATCH, PATCH, 3)).astype(np.float32) * tissue[..., None, None, None]
    raw = rng.poisson(1.2, (78, 64, GENES)).astype(np.float32)
    raw[..., 0] += 1
    raw *= tissue[..., None]
    variables = _moved(g.init(jax.random.key(0), (jnp.asarray(xi[None, :2, :2]),
                                                   jnp.asarray(raw[None, :2, :2]))))
    assert ("count_classifier" in variables.get("batch_stats", {})) is not student
    jg = jax_modeldir.mm_model_from_meta(meta, CLASSES)
    logits = np.asarray(jg.apply(variables, (jnp.asarray(xi[None]),
                                             jnp.asarray(np.log1p(raw)[None]))))[0]
    want = np.where(raw.sum(-1) > 0, logits.argmax(-1) + 1, 0)

    model = modeldir.mm_model_from_meta(meta, CLASSES, variables, device="cpu")
    assert model.count_classifier.batch_norm is not student
    assert model.count_chunk == meta["count_chunk"]
    got = serving.register_mm_grid(model, xi, raw, np.log1p if meta["log1p"] else None,
                                   device="cpu")
    np.testing.assert_array_equal(got > 0, tissue)
    serving.label_parity_report(want, got, logits)
    with torch.no_grad():
        port_logits = model((torch.from_numpy(xi[None]),
                             torch.from_numpy(np.log1p(raw)[None])))[0]
    _assert_close(port_logits, logits)
