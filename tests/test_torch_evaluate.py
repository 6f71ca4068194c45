"""The port's ``evaluate`` command and its modules against the JAX package,
on the CPU.

Two simulated hex arrays named by gene2vec symbols (unified caches from the
JAX package's ``prepare_count_files``, fullres slides, Loupe annotations)
and a Visium HD array on a 10 x 12 bin lattice. Model directories are
written as the JAX package's trainers write them, weights moved off init by
numpy noise: ``GridNetHex+CountMLP`` (two seeds, and one under reordered
classes),
square ``GridNet+CountMLP``, ``HexGCN``, ``GridNetHex+TpuPatchClassifier``
(stages (16, 1), 16-px patches), ``GridNetHexMM`` (scBERT depth 1 over
120 gene2vec tokens, and ``CountMLP``) and square ``GridNetMM`` (per bin
and dense ingest). Covered:

- ``all_fgd_predictions`` against JAX's on the same arrays and weights
  (plain, ``f_only``, ``tta``, ``return_grids``; image, count and
  multimodal): ``y_true`` equal, ``y_pred`` equal up to near-ties of JAX's
  logits (``label_parity_report``), softmax within 1e-5;
- the command's JSON against JAX's command's for a hex and a square count
  model, HexGCN and a two-model consensus: keys, classes, confusion and
  accuracy equal, AUPRC and the report within 1e-6, AUROC within 1e-6
  plus two rank swaps of scores tied in float32;
- image and multimodal directories (hex; square per bin and by dense
  ingest) through the port's command against
  JAX's ``all_fgd_predictions`` and ``_fgd_metrics`` fed the port's
  lossless grids (JAX's own command reads JPEG crops by design);
- JAX's refusals, with JAX's messages; ``misclass_density`` and
  ``class_boundary_segments`` equal to JAX's; ``--plots`` / ``--maps``
  render (Agg) the file names JAX's command writes; without matplotlib they
  exit before any forward pass.
"""

import builtins
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gridnext_tpu import plotting as jax_plotting
from gridnext_tpu.cli import _fgd_metrics as jax_fgd_metrics
from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.data.graph_data import feature_axis_signature
from gridnext_tpu.evaluate import all_fgd_predictions as jax_all_fgd_predictions
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io.unify import read_unified_genes, unified_cache_path
from gridnext_tpu.modeldir import grid_model_from_meta as jax_grid_model_from_meta
from gridnext_tpu.modeldir import load_model_dir as jax_load_model_dir
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import GridNetMM as JaxGridNetMM
from gridnext_tpu.models import HexGCN as JaxHexGCN
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.models.scbert import load_gene2vec_names
from gridnext_tpu.train import TrainState, save_checkpoint
from gridnext_tpu_torch import cli, plotting
from gridnext_tpu_torch.cli import main
from gridnext_tpu_torch.compat.from_jax import load_model_dir
from gridnext_tpu_torch.data import DenseWSIGridDataset, MMStackDataset, create_visium_dataset
from gridnext_tpu_torch.evaluate import (all_fgd_predictions, consensus_softmax,
                                         flatten_foreground)
from gridnext_tpu_torch.modeldir import grid_model_from_meta, scbert_count_transform
from gridnext_tpu_torch.serving import label_parity_report

N_CLASSES, PATCH, GENES, VOCAB = 3, 16, 40, 120
CLASSES = [f"Layer{i + 1}" for i in range(N_CLASSES)]
TPU_F = {"stages": [[16, 1]], "stem_patch": 8, "norm": "rms"}
BINNING, HD_GRID, HD_PITCH = "square_016um", (10, 12), 12
# cohort genes: every other gene2vec symbol from the second (half of them
# inside the first VOCAB tokens)
SYMBOLS = load_gene2vec_names()[1:2 * GENES + 1:2]



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    machine's cores, and multi-threaded small CPU ops contend badly there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _moved(variables, seed=1):
    rng = np.random.default_rng(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


_INITS = {}


def _write_model_dir(d, g, sample, meta, seed=1, classes=CLASSES):
    """``save_checkpoint`` of a TrainState (no optimizer state) and
    ``model.json``, as the JAX package writes model directories; the
    initial variables of one module are drawn once, then moved by
    ``seed``."""
    if g not in _INITS:
        _INITS[g] = jax.jit(g.init)(jax.random.key(0), sample)
    variables = _moved(_INITS[g], seed)
    state = TrainState(params=variables["params"], batch_stats=variables.get("batch_stats"),
                       opt_state=None, step=jnp.asarray(0, jnp.int32),
                       extra_vars={k: v for k, v in variables.items()
                                   if k not in ("params", "batch_stats")})
    os.makedirs(d, exist_ok=True)
    save_checkpoint(os.path.join(d, "g_state.msgpack"), state, include_opt_state=False)
    with open(os.path.join(d, "model.json"), "w") as fh:
        json.dump({"classes": classes, **meta}, fh)
    return str(d)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_evaluate")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=GENES,
                                     n_classes=N_CLASSES, image=True, spot_spacing_px=10,
                                     tissue_fraction=frac, gene_names=SYMBOLS)
            for i, frac in enumerate((0.5, 0.35))]
    dirs = [s["spaceranger_dir"] for s in sims]
    prepare_count_files(dirs, verbose=False)
    return root, dirs, [s["image_file"] for s in sims], [s["annot_file"] for s in sims]


@pytest.fixture(scope="module")
def hd(tmp_path_factory):
    sim = simulate_spaceranger_dir(tmp_path_factory.mktemp("torch_evaluate_hd") / "hd0",
                                   seed=4, n_genes=GENES, n_classes=N_CLASSES,
                                   spaceranger_version="hd", hd_grid=HD_GRID,
                                   hd_binning=BINNING, image=True, spot_spacing_px=HD_PITCH)
    prepare_count_files([sim["spaceranger_dir"]], verbose=False, hd_binning=BINNING)
    return sim["spaceranger_dir"], sim["annot_file"], sim["image_file"]


@pytest.fixture(scope="module")
def dirs(cohort, hd):
    """Every model directory of the tests, by name."""
    root, srds, _, _ = cohort
    genes = read_unified_genes(unified_cache_path(srds[0]))
    count_meta = {"n_genes": len(genes), "genes": genes, "log1p": True, "hd_binning": None,
                  "grid_dims": None, "model": "GridNetHex+CountMLP"}
    count_sample = jnp.zeros((1, 4, 4, len(genes)))
    out = {}
    g = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    for name, seed in (("count", 1), ("count2", 7)):
        out[name] = _write_model_dir(root / name, g, count_sample, count_meta, seed)
    # the same weights under a reordered label space
    out["count_reordered"] = str(root / "count_reordered")
    os.makedirs(out["count_reordered"])
    Path(out["count_reordered"], "g_state.msgpack").write_bytes(
        Path(out["count"], "g_state.msgpack").read_bytes())
    Path(out["count_reordered"], "model.json").write_text(json.dumps(
        {"classes": CLASSES[::-1], **count_meta}))

    hd_genes = read_unified_genes(unified_cache_path(hd[0], BINNING))
    g = JaxGridNet(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    out["square"] = _write_model_dir(
        root / "square", g, jnp.zeros((1, 4, 4, len(hd_genes))),
        {"n_genes": len(hd_genes), "genes": hd_genes, "log1p": True, "hd_binning": BINNING,
         "grid_dims": list(HD_GRID), "model": "GridNet+CountMLP"}, 2)

    g = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                               stem_patch=8), n_classes=N_CLASSES)
    out["image"] = _write_model_dir(
        root / "image", g, jnp.zeros((1, 2, 2, PATCH, PATCH, 3)),
        {"patch_px": PATCH, "window_px": None, "model": "GridNetHex+TpuPatchClassifier",
         "tpu_f": TPU_F, "image_f": "tpu", "hd_binning": None, "grid_dims": None,
         "patch_chunk": 256, "dense_ingest": False}, 4)

    for count_f in ("scbert", "mlp"):
        if count_f == "scbert":
            count = JaxScBERT(n_genes=VOCAB, dim=16, depth=1, heads=2, dim_head=8,
                              nb_features=8, n_classes=N_CLASSES, generalized_attention=True)
            width = VOCAB
        else:
            count, width = JaxCountMLP(n_classes=N_CLASSES), len(genes)
        g = JaxGridNetHexMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                                     stem_patch=8),
                            count_classifier=count, n_classes=N_CLASSES, patch_chunk=256,
                            count_chunk=512)
        meta = {"patch_px": PATCH, "window_px": None, "patch_chunk": 256, "count_chunk": 512,
                "n_genes": len(genes), "genes": genes, "log1p": count_f != "scbert",
                "count_f": count_f, "scbert_vocab": VOCAB, "scbert_dim": 16,
                "scbert_depth": 1, "scbert_heads": 2, "scbert_dim_head": 8,
                "scbert_features": 8, "hd_binning": None, "grid_dims": None,
                "image_f": "tpu", "tpu_f": TPU_F, "dense_ingest": False,
                "model": "GridNetHexMM"}
        out[f"mm_{count_f}"] = _write_model_dir(
            root / f"mm_{count_f}", g,
            (jnp.zeros((1, 2, 2, PATCH, PATCH, 3)), jnp.zeros((1, 2, 2, width))), meta, 5)

    g = JaxGridNetMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                              stem_patch=4),
                     count_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES,
                     patch_chunk=64)
    for dense in (False, True):
        out["hd_mm_dense" if dense else "hd_mm"] = _write_model_dir(
            root / f"hd_mm_{dense}", g,
            (jnp.zeros((1, 2, 2, HD_PITCH, HD_PITCH, 3)), jnp.zeros((1, 2, 2, len(hd_genes)))),
            {"patch_px": HD_PITCH, "window_px": None, "patch_chunk": 64, "count_chunk": None,
             "n_genes": len(hd_genes), "genes": hd_genes, "log1p": True, "count_f": "mlp",
             "hd_binning": BINNING, "grid_dims": list(HD_GRID), "image_f": "tpu",
             "tpu_f": {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"},
             "dense_ingest": dense, "model": "GridNetMM"}, 8)

    model = JaxHexGCN(n_classes=N_CLASSES, hidden=16, depth=2)
    params = model.init(jax.random.key(0), jnp.zeros((12, GENES)),
                        jnp.zeros((2, 4), jnp.int32))["params"]
    params = _moved({"params": params}, 6)["params"]
    state = TrainState(params=params, batch_stats=None, opt_state=optax.adam(1e-3).init(params),
                       step=jnp.asarray(1, jnp.int32), extra_vars={})
    d = root / "graph"
    d.mkdir()
    save_checkpoint(str(d / "g_state.msgpack"), state)
    (d / "model.json").write_text(json.dumps({
        "classes": CLASSES, "model": "HexGCN", "hidden": 16, "depth": 2, "log1p": True,
        "n_genes": GENES, "feature_axis": feature_axis_signature(srds[0])}))
    out["graph"] = str(d)
    return out


def _models(model_dir):
    """(JAX model, JAX variables, the port's model on the CPU) of a directory."""
    meta, classes, variables = jax_load_model_dir(model_dir)
    g_jax = jax_grid_model_from_meta(meta, classes)
    meta_p, classes_p, variables_p = load_model_dir(model_dir)
    return g_jax, variables, grid_model_from_meta(meta_p, classes_p, variables_p, device="cpu")


def _inputs(kind, cohort, hd=None):
    """The arrays' grids (the port's lossless crops for images) and labels,
    each model kind's count transform applied: both hex arrays, or the HD
    array (``hd_mm`` per bin, ``hd_mm_dense`` tiled off the slide)."""
    if kind.startswith("hd_mm"):
        srd, annot, image = hd
        counts = create_visium_dataset([srd], use_image=False, annot_files=[annot],
                                       hd_binning=BINNING, grid_dims=HD_GRID)
        if kind == "hd_mm_dense":
            images = DenseWSIGridDataset([image], [srd], [annot], patch_size=HD_PITCH,
                                         hd_binning=BINNING, grid_dims=HD_GRID, device="cpu")
        else:
            images = create_visium_dataset([srd], use_count=False, fullres_image_files=[image],
                                           patch_size_px=HD_PITCH, annot_files=[annot],
                                           hd_binning=BINNING, grid_dims=HD_GRID, device="cpu")
        (xi, xc), y = MMStackDataset(images, counts).materialize()
        return (xi.numpy(), np.log1p(xc)), y
    _, srds, images, annots = cohort
    use_image = kind in ("image", "mm_mlp", "mm_scbert")
    ds = create_visium_dataset(srds, use_image=use_image, use_count=kind != "image",
                               fullres_image_files=images if use_image else None,
                               patch_size_px=PATCH, annot_files=annots, device="cpu")
    x, y = ds.materialize()
    if kind == "mm_scbert":
        transform, _ = scbert_count_transform(srds, None, VOCAB)
        x = (x[0].numpy(), transform(x[1]))
    elif kind == "mm_mlp":
        x = (x[0].numpy(), np.log1p(x[1]))
    elif kind == "image":
        x = x.numpy()
    else:
        x = np.log1p(x)
    return x, y


@pytest.mark.parametrize("kind,mode", [("image", "plain"), ("image", "f_only"),
                                       ("image", "tta"), ("image", "grids"),
                                       ("count", "f_only"), ("mm_mlp", "tta"),
                                       ("mm_scbert", "plain")])
def test_all_fgd_predictions_matches_jax(kind, mode, cohort, dirs):
    g_jax, variables, g = _models(dirs[kind])
    x, y = _inputs(kind, cohort)
    if mode == "tta":               # one array: 8 forwards of each model
        x = tuple(a[:1] for a in x) if isinstance(x, tuple) else x[:1]
        y = y[:1]
    kw = {"f_only": mode == "f_only", "tta": mode == "tta",
          "return_grids": mode == "grids"}
    want = jax_all_fgd_predictions((x, y), g_jax, variables, **kw)
    got = all_fgd_predictions((x, y), g, **kw)
    assert len(got) == len(want) == (4 if mode == "grids" else 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == np.int64 and got[2].dtype == np.float32
    label_parity_report(want[1] + 1, got[1] + 1, np.log(want[2] + 1e-30))
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    if mode == "grids":
        for (ty, ts), (wy, ws) in zip(got[3], want[3]):
            np.testing.assert_array_equal(ty, wy)
            np.testing.assert_allclose(ts, ws, atol=1e-5)
        # the flattened grids are the returned foreground rows
        preds, truth = flatten_foreground(got[3][0][1], got[3][0][0])
        n0 = len(truth)
        np.testing.assert_array_equal(truth, got[0][:n0])
        np.testing.assert_array_equal(preds, got[2][:n0])
        np.testing.assert_array_equal(
            flatten_foreground(np.moveaxis(got[3][0][1], -1, 0), got[3][0][0])[0], preds)


def test_tta_refuses_count_inputs_as_jax(cohort, dirs):
    g_jax, variables, g = _models(dirs["count"])
    x, y = _inputs("count", cohort)
    with pytest.raises(ValueError) as want:
        jax_all_fgd_predictions((x, y), g_jax, variables, tta=True)
    with pytest.raises(ValueError) as got:
        all_fgd_predictions((x, y), g, tta=True)
    assert str(got.value) == str(want.value)


def test_consensus_softmax_matches_jax():
    from gridnext_tpu.evaluate import consensus_softmax as jax_consensus

    rng = np.random.default_rng(0)
    mats = [rng.random((50, 4)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(consensus_softmax(mats), jax_consensus(mats))


def _command(fn, args, out):
    fn(["evaluate", *args, "--out", str(out)] + (["--device", "cpu"] if fn is main else []))
    return json.loads(Path(out).read_text())


def _assert_metrics_close(got, want, tol=1e-6):
    """Keys, classes, counts, confusion and accuracy equal; the AUPRCs and
    the report within ``tol``, the AUROCs within ``tol`` plus two swapped
    (positive, negative) pairs: float32 rounding of the two packages' logits
    can reorder two scores that tie to 1e-7, and one swap moves a class's
    AUROC by 1 / (n_pos n_neg) (2.2e-6 at 1,422 spots)."""
    assert list(got) == list(want)
    for key in ("model", "classes", "f_only", "n_arrays", "n_foreground_spots", "confusion",
                "accuracy"):
        assert got[key] == want[key], key
    n = want["n_foreground_spots"]
    swap = {c: 2.0 / max(want["report"][c]["support"] * (n - want["report"][c]["support"]), 1)
            for c in want["classes"]}
    assert got["macro_auprc"] == pytest.approx(want["macro_auprc"], abs=tol)
    assert got["macro_auroc"] == pytest.approx(want["macro_auroc"],
                                               abs=tol + max(swap.values()))
    for key in ("auroc_per_class", "auprc_per_class"):
        assert list(got[key]) == list(want[key])
        for c, v in want[key].items():
            assert (got[key][c] is None) == (v is None)
            if v is not None:
                slack = swap[c] if key == "auroc_per_class" else 0.0
                assert got[key][c] == pytest.approx(v, abs=tol + slack), (key, c)
    assert list(got["report"]) == list(want["report"])
    for name, row in want["report"].items():
        if isinstance(row, dict):
            assert list(got["report"][name]) == list(row)
            for k, v in row.items():
                assert got["report"][name][k] == pytest.approx(v, abs=tol)
        else:
            assert got["report"][name] == pytest.approx(row, abs=tol)


@pytest.mark.parametrize("kind", ["hex_count", "square_count", "graph", "consensus"])
def test_evaluate_command_matches_jax(kind, cohort, hd, dirs, tmp_path):
    _, srds, _, annots = cohort
    if kind == "square_count":
        args = ["--model", dirs["square"], "--spaceranger", hd[0], "--annots", hd[1]]
    else:
        models = {"hex_count": [dirs["count"]], "graph": [dirs["graph"]],
                  "consensus": [dirs["count"], dirs["count2"]]}[kind]
        args = ["--model", *models, "--spaceranger", *srds, "--annots", *annots]
    want = _command(jax_main, args, tmp_path / "jax.json")
    got = _command(main, args, tmp_path / "port.json")
    assert list(got) == list(want)
    if kind == "consensus":
        assert list(got["models"]) == list(want["models"])
        for m in want["models"]:
            _assert_metrics_close(got["models"][m], want["models"][m])
        _assert_metrics_close(got["consensus"], want["consensus"])
        assert got["consensus"]["model"] == \
            "consensus(GridNetHex+CountMLP+GridNetHex+CountMLP)"
    else:
        _assert_metrics_close(got, want)
        assert got["n_foreground_spots"] > 0 and len(set(got["report"])) == N_CLASSES + 3


@pytest.mark.parametrize("kind", ["image", "image_tta", "mm_scbert", "hd_mm", "hd_mm_dense"])
def test_evaluate_image_and_mm_against_jax_on_lossless_grids(kind, cohort, hd, dirs, tmp_path):
    """The port's command against JAX's predictions on the port's crops
    (JAX's command reads JPEG patch caches, a different input by design):
    hex image and multimodal directories, and a square multimodal one per
    bin and by dense ingest."""
    _, srds, images, annots = cohort
    if kind.startswith("hd_mm"):
        srds, annots, images = [hd[0]], [hd[1]], [hd[2]]
    name = "image" if kind.startswith("image") else kind
    tta = kind == "image_tta"
    if tta:                         # one array: 8 forwards of each model
        srds, annots, images = srds[:1], annots[:1], images[:1]
        cohort = (cohort[0], srds, images, annots)
    got = _command(main, ["--model", dirs[name], "--spaceranger", *srds, "--annots", *annots,
                          "--images", *images] + (["--tta"] if tta else []),
                   tmp_path / "port.json")
    g_jax, variables, _ = _models(dirs[name])
    x, y = _inputs(name, cohort, hd)
    parts = [jax_all_fgd_predictions(((tuple(a[i:i + 1] for a in x) if isinstance(x, tuple)
                                       else x[i:i + 1]), y[i:i + 1]), g_jax, variables, tta=tta)
             for i in range(len(y))]
    y_true, y_pred, smax = (np.concatenate(p) for p in zip(*parts))
    meta, _, _ = jax_load_model_dir(dirs[name])
    want = jax_fgd_metrics(meta["model"], CLASSES, len(y), y_true, y_pred, smax)
    # the port's predictions on the same grids, for the near-tie judgement
    _, _, g = _models(dirs[name])
    got_pred = all_fgd_predictions((x, y), g, tta=tta)[1]
    n_flips = label_parity_report(y_pred + 1, got_pred + 1, np.log(smax + 1e-30))
    assert got["n_foreground_spots"] == want["n_foreground_spots"] == len(y_true)
    assert got["classes"] == want["classes"] and got["model"] == want["model"]
    assert abs(got["accuracy"] - want["accuracy"]) <= n_flips / len(y_true) + 1e-12
    if n_flips == 0:
        _assert_metrics_close(got, want, tol=1e-5)
    else:
        assert got["macro_auroc"] == pytest.approx(want["macro_auroc"], abs=1e-3)


def _exit_code(fn, args):
    with pytest.raises(SystemExit) as e:
        fn(args)
    return e.value.code


def test_evaluate_refusals_match_jax(cohort, dirs, tmp_path):
    _, srds, images, annots = cohort
    base = ["--spaceranger", *srds, "--annots", *annots, "--out", str(tmp_path / "m.json")]
    cases = [
        ["--model", dirs["mm_mlp"], "--images", *images, "--f-only"],      # MM f-only
        ["--model", dirs["count"], dirs["graph"]],                         # graph + grid
        ["--model", dirs["count"], dirs["count_reordered"]],               # classes differ
        ["--model", dirs["graph"], "--f-only"],
        ["--model", dirs["graph"], "--tta"],
        ["--model", dirs["image"]],                                         # no images
    ]
    for extra in cases:
        want = _exit_code(jax_main, ["evaluate", *base, *extra])
        assert isinstance(want, str) and want.startswith("error:")
        assert _exit_code(main, ["evaluate", *base, *extra, "--device", "cpu"]) == want
    # one annotation file for two arrays
    args = ["evaluate", "--model", dirs["count"], "--spaceranger", *srds, "--annots",
            annots[0], "--out", str(tmp_path / "m.json")]
    want = _exit_code(jax_main, args)
    assert _exit_code(main, args + ["--device", "cpu"]) == want
    # annotations naming a class the model never trained on
    two = tmp_path / "two_classes"
    two.mkdir()
    (two / "g_state.msgpack").write_bytes(Path(dirs["count"], "g_state.msgpack").read_bytes())
    meta = json.loads(Path(dirs["count"], "model.json").read_text())
    (two / "model.json").write_text(json.dumps({**meta, "classes": ["Layer1", "Layer2", "X"]}))
    args = ["evaluate", "--model", str(two), *base]
    want = _exit_code(jax_main, args)
    assert "never trained on" in want
    assert _exit_code(main, args + ["--device", "cpu"]) == want
    # the default device needs a card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["evaluate", "--model", dirs["count"], *base])


def test_misclass_density_and_boundaries_match_jax():
    rng = np.random.default_rng(3)
    true = rng.integers(0, 4, (9, 11)).astype(np.uint8)
    smax = rng.dirichlet(np.ones(3), (9, 11)).astype(np.float32)
    np.testing.assert_array_equal(plotting.misclass_density(smax, true),
                                  jax_plotting.misclass_density(smax, true))
    for grid in (true, np.ones((5, 6), np.int64), np.zeros((0, 0), np.int64)):
        np.testing.assert_array_equal(plotting.class_boundary_segments(grid),
                                      jax_plotting.class_boundary_segments(grid))


def test_plots_and_maps_render_like_jax(cohort, dirs, tmp_path):
    """The figures of a single model (file for file the names JAX's command
    writes) and of a consensus (``consensus_`` figures, the same maps); the
    helpers render without error."""
    _, srds, _, annots = cohort
    base = ["--spaceranger", *srds, "--annots", *annots]
    names = {}
    for fn, who, models in ((jax_main, "jax", [dirs["count"]]),
                            (main, "port", [dirs["count"]]),
                            (main, "consensus", [dirs["count"], dirs["count2"]])):
        root = tmp_path / who
        _command(fn, ["--model", *models, *base, "--plots", str(root / "plots"),
                      "--maps", str(root / "maps")], tmp_path / f"{who}.json")
        names[who] = {sub: sorted(os.listdir(root / sub)) for sub in ("plots", "maps")}
        assert all((root / sub / n).stat().st_size > 1000
                   for sub, ns in names[who].items() for n in ns)
    assert names["port"] == names["jax"]
    assert names["jax"]["plots"] == ["confusion.png", "curves.png"]
    assert len(names["jax"]["maps"]) == 3 * len(srds)
    assert names["consensus"] == {"plots": ["consensus_confusion.png", "consensus_curves.png"],
                                  "maps": names["jax"]["maps"]}
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    rng = np.random.default_rng(1)
    grid = rng.integers(0, 3, (6, 5))
    for fig in (plotting.plot_cv_curves(rng.random((3, 4)), rng.random((3, 4)))[0],
                plotting.plot_class_boundaries(rng.random((6, 5)), grid),
                plotting.plot_hextensor(grid).figure,
                plotting.plot_hextensor(grid, layout="odd-q", mask=[0, 3]).figure,
                plotting.plot_squaretensor(grid).figure,
                plotting.performance_curves(np.array([0, 1, 1, 0]), [rng.random((4, 2))] * 2,
                                            condition_names=["a", "b"])[0]):
        plt.close(fig)


def test_plots_without_matplotlib_exit_before_forward(cohort, dirs, tmp_path, monkeypatch):
    _, srds, _, annots = cohort
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    def forward(*_, **__):
        raise AssertionError("a forward pass ran")

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr(cli, "_evaluate_one", forward)
    for flag in ("--plots", "--maps"):
        code = _exit_code(main, ["evaluate", "--model", dirs["count"], "--spaceranger", *srds,
                                 "--annots", *annots, "--out", str(tmp_path / "m.json"),
                                 flag, str(tmp_path / "figs"), "--device", "cpu"])
        assert isinstance(code, str) and "matplotlib" in code and code.startswith("error:")
    assert not (tmp_path / "m.json").exists()
