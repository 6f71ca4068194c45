"""The port's ``register`` command against the JAX package's, on the CPU.

Two simulated arrays whose Spaceranger directories are both named ``outs``
(so the Loupe CSVs take ``NN_`` prefixes), their unified count caches
written by the JAX package's ``prepare_count_files``. Model directories are
written as the JAX package's trainers write them (``save_checkpoint`` of a
TrainState with its optimizer state, and their ``model.json``), weights
moved off init by numpy noise:

- a narrow ``TpuPatchClassifier`` image directory over the two fullres
  slides: the same file names, rows equal up to near-tie flips (judged with
  JAX's logits, ``label_parity_report``), foreground equal;
- a ``GridNetHex+CountMLP`` directory (``train-count``'s meta) through
  ``python -m gridnext_tpu_torch register --device cpu``: CSVs byte-identical;
- a missing cache and a wrong gene axis exit with JAX's messages; the
  other model kinds (``HexGCN``, ``GridNetHexMM``, square ``GridNetMM`` and
  square ``GridNet+CountMLP``, held against JAX in
  ``test_torch_register_mm.py`` and ``test_torch_graph.py``) register and
  write a CSV naming each in-tissue spot; the default device raises
  without CUDA, for a multimodal directory too.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.geometry import pseudo_hex_to_oddr
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.io.unify import read_unified_genes
from gridnext_tpu.data.graph_data import feature_axis_signature
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import GridNetMM as JaxGridNetMM
from gridnext_tpu.models import HexGCN as JaxHexGCN
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.train import (TrainState, create_train_state, make_gridwise_optimizer,
                                save_checkpoint)
from gridnext_tpu_torch.cli import main
from gridnext_tpu_torch.serving import label_parity_report

REPO = Path(__file__).resolve().parents[1]
N_CLASSES, PATCH, GENES = 3, 16, 20
CLASSES = ["A", "B", "C"]
TPU_F = {"stages": [[32, 1]], "stem_patch": 8, "norm": "rms"}
BINNING, HD_GRID, HD_PITCH = "square_016um", (10, 12), 12


def _moved(variables, seed=1):
    rng = np.random.default_rng(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.03 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


def _write_model_dir(d, g, sample, meta):
    """``save_checkpoint`` of a TrainState (Adam state included) and
    ``model.json``, as the JAX package's trainers write them."""
    state = create_train_state(g, jax.random.key(0), sample, make_gridwise_optimizer(1e-3))
    moved = _moved({"params": state.params, "batch_stats": state.batch_stats})
    state = state.replace(**moved)
    os.makedirs(d, exist_ok=True)
    save_checkpoint(os.path.join(d, "g_state.msgpack"), state)
    with open(os.path.join(d, "model.json"), "w") as fh:
        json.dump({"classes": CLASSES, **meta}, fh)
    return str(d)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=GENES,
                                     n_classes=N_CLASSES, image=True, spot_spacing_px=10,
                                     tissue_fraction=frac)
            for i, frac in enumerate((0.5, 0.35))]
    dirs = [str(Path(s["spaceranger_dir"]) / "outs") for s in sims]
    prepare_count_files(dirs, verbose=False)
    return root, dirs, [s["image_file"] for s in sims]


@pytest.fixture(scope="module")
def image_dir(cohort):
    root, _, _ = cohort
    g = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((32, 1),),
                                               stem_patch=8), n_classes=N_CLASSES)
    meta = {"patch_px": PATCH, "window_px": None, "model": "GridNetHex+TpuPatchClassifier",
            "tpu_f": TPU_F, "image_f": "tpu", "hd_binning": None, "grid_dims": None,
            "patch_chunk": 256, "dense_ingest": False}
    return _write_model_dir(root / "model_image", g, jnp.zeros((1, 2, 2, PATCH, PATCH, 3)),
                            meta)


@pytest.fixture(scope="module")
def count_dir(cohort):
    root, dirs, _ = cohort
    genes = read_unified_genes(os.path.join(dirs[0], "outs.unified.tsv.gz"))
    g = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    meta = {"n_genes": len(genes), "genes": genes, "log1p": True, "hd_binning": None,
            "grid_dims": None, "model": "GridNetHex+CountMLP"}
    return _write_model_dir(root / "model_count", g, jnp.zeros((1, 4, 4, len(genes))), meta)


def _csv_grid(path, srd, classes):
    """The label grid a Loupe CSV names (0 where no class)."""
    pos = jax_read_positions(srd)
    grid = np.zeros((78, 64), np.int64)
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["Barcode", "AARs"]
    for barcode, annot in rows[1:]:
        x, y = pseudo_hex_to_oddr(int(pos.loc[barcode, "array_col"]),
                                  int(pos.loc[barcode, "array_row"]))
        grid[y, x] = classes.index(annot) + 1 if annot else 0
    return grid, [r[0] for r in rows]


def test_register_image_dir_matches_jax(cohort, image_dir, tmp_path):
    _, dirs, images = cohort
    args = ["register", "--model", image_dir, "--images", *images, "--spaceranger", *dirs]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    main(args + ["--out", str(tmp_path / "port"), "--device", "cpu", "--slide-batch", "2"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["00_outs_loupe.csv", "01_outs_loupe.csv"]

    meta, classes, variables = jax_modeldir.load_model_dir(image_dir)
    jax_reg = jax_modeldir.image_registrar_from_meta(meta, classes, variables)
    for name, srd, image in zip(names, dirs, images):
        want, want_rows = _csv_grid(tmp_path / "jax" / name, srd, classes)
        got, got_rows = _csv_grid(tmp_path / "port" / name, srd, classes)
        assert got_rows == want_rows
        logits, _ = jax_reg.register_logits(jnp.asarray(np.asarray(Image.open(image))),
                                            jax_read_positions(srd))
        label_parity_report(want, got, logits)
        assert (got > 0).sum() == len(got_rows) - 1


def test_register_count_dir_matches_jax_bytes(cohort, count_dir, tmp_path):
    _, dirs, _ = cohort
    args = ["register", "--model", count_dir, "--spaceranger", *dirs]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "gridnext_tpu_torch", *args,
                          "--out", str(tmp_path / "port"), "--device", "cpu"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "registered 01_outs ->" in res.stdout
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["00_outs_loupe.csv", "01_outs_loupe.csv"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # one array: the CSV is --out itself
    jax_main(["register", "--model", count_dir, "--spaceranger", dirs[1],
              "--out", str(tmp_path / "one_jax.csv")])
    main(["register", "--model", count_dir, "--spaceranger", dirs[1],
          "--out", str(tmp_path / "one_port.csv"), "--device", "cpu"])
    assert (tmp_path / "one_port.csv").read_bytes() == (tmp_path / "one_jax.csv").read_bytes()


def _exit_code(fn, args):
    with pytest.raises(SystemExit) as e:
        fn(args)
    return e.value.code


def test_register_errors_match_jax(cohort, count_dir, image_dir, tmp_path):
    root, dirs, images = cohort
    bare = tmp_path / "bare" / "outs"
    (bare / "spatial").mkdir(parents=True)
    base = ["register", "--model", count_dir, "--out", str(tmp_path / "x.csv")]
    for args in (base + ["--spaceranger", str(bare)],
                 ["register", "--model", image_dir, "--out", str(tmp_path / "y"),
                  "--spaceranger", *dirs, "--images", images[0]]):
        want = _exit_code(jax_main, args)
        assert isinstance(want, str) and want.startswith("error:")
        assert _exit_code(main, args + ["--device", "cpu"]) == want

    # a wrong gene axis, and a model kind neither package knows
    for change in ({"genes": ["NOT_A_GENE"] * GENES}, {"model": "Mystery"}):
        d = tmp_path / f"model_{len(change['genes']) if 'genes' in change else 'x'}"
        d.mkdir()
        (d / "g_state.msgpack").write_bytes(Path(count_dir, "g_state.msgpack").read_bytes())
        meta = json.loads(Path(count_dir, "model.json").read_text())
        (d / "model.json").write_text(json.dumps({**meta, **change}))
        args = ["register", "--model", str(d), "--spaceranger", dirs[0],
                "--out", str(tmp_path / "z.csv")]
        want = _exit_code(jax_main, args)
        assert isinstance(want, str) and want.startswith("error:")
        assert _exit_code(main, args + ["--device", "cpu"]) == want


@pytest.fixture(scope="module")
def hd_dir(tmp_path_factory):
    """A Visium HD array (10 x 12 bins at 12 px) with its slide and binned
    unified cache."""
    sim = simulate_spaceranger_dir(tmp_path_factory.mktemp("torch_cli_hd") / "hd0", seed=4,
                                   n_genes=GENES, n_classes=N_CLASSES,
                                   spaceranger_version="hd", hd_grid=HD_GRID,
                                   hd_binning=BINNING, image=True, spot_spacing_px=HD_PITCH)
    prepare_count_files([sim["spaceranger_dir"]], verbose=False, hd_binning=BINNING)
    return sim["spaceranger_dir"], sim["image_file"]


@pytest.fixture(scope="module")
def mm_dir(cohort):
    """A GridNetHexMM directory (CountMLP count f, TpuPatchClassifier image f)
    with ``train-mm``'s meta."""
    root, dirs, _ = cohort
    genes = read_unified_genes(os.path.join(dirs[0], "outs.unified.tsv.gz"))
    g = JaxGridNetHexMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((32, 1),),
                                                 stem_patch=8),
                        count_classifier=JaxCountMLP(n_classes=N_CLASSES),
                        n_classes=N_CLASSES, patch_chunk=256)
    meta = {"patch_px": PATCH, "window_px": None, "patch_chunk": 256, "count_chunk": None,
            "n_genes": len(genes), "genes": genes, "log1p": True, "count_f": "mlp",
            "hd_binning": None, "grid_dims": None, "image_f": "tpu", "tpu_f": TPU_F,
            "dense_ingest": False, "model": "GridNetHexMM"}
    return _write_model_dir(root / "model_mm", g, (jnp.zeros((1, 2, 2, PATCH, PATCH, 3)),
                                                   jnp.zeros((1, 2, 2, len(genes)))), meta)


def _kind_dir(kind, root, dirs, hd_dir):
    """A model directory of ``kind`` as the JAX package's trainers write it,
    and the ``register`` arguments of its Spaceranger directory."""
    hd_srd, hd_image = hd_dir
    hd_genes = read_unified_genes(os.path.join(hd_srd, f"hd0.{BINNING}.unified.tsv.gz"))
    square = {"hd_binning": BINNING, "grid_dims": list(HD_GRID), "genes": hd_genes,
              "n_genes": len(hd_genes), "log1p": True}
    if kind == "HexGCN":
        g = JaxHexGCN(n_classes=N_CLASSES, hidden=16, depth=2)
        params = g.init(jax.random.key(0), jnp.zeros((12, GENES)),
                        jnp.zeros((2, 4), jnp.int32))["params"]
        params = _moved({"params": params})["params"]
        state = TrainState(params=params, batch_stats=None,
                           opt_state=optax.adam(1e-3).init(params),
                           step=jnp.asarray(1, jnp.int32), extra_vars={})
        d = root / "kind_HexGCN"
        d.mkdir()
        save_checkpoint(str(d / "g_state.msgpack"), state)
        (d / "model.json").write_text(json.dumps({
            "classes": CLASSES, "model": "HexGCN", "hidden": 16, "depth": 2, "log1p": True,
            "n_genes": GENES, "feature_axis": feature_axis_signature(dirs[0])}))
        return str(d), ["--spaceranger", dirs[0]]
    if kind == "GridNetMM":
        g = JaxGridNetMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                                  stem_patch=4),
                         count_classifier=JaxCountMLP(n_classes=N_CLASSES),
                         n_classes=N_CLASSES, patch_chunk=64)
        meta = {**square, "model": "GridNetMM", "patch_px": HD_PITCH, "window_px": None,
                "patch_chunk": 64, "count_f": "mlp", "image_f": "tpu",
                "tpu_f": {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"},
                "dense_ingest": False}
        sample = (jnp.zeros((1, 2, 2, HD_PITCH, HD_PITCH, 3)),
                  jnp.zeros((1, 2, 2, len(hd_genes))))
        return (_write_model_dir(root / "kind_GridNetMM", g, sample, meta),
                ["--spaceranger", hd_srd, "--images", hd_image])
    g = JaxGridNet(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    meta = {**square, "model": "GridNet+CountMLP"}
    return (_write_model_dir(root / "kind_count", g, jnp.zeros((1, 4, 4, len(hd_genes))), meta),
            ["--spaceranger", hd_srd])


@pytest.mark.parametrize("kind", ["HexGCN", "GridNetHexMM", "GridNetMM", "GridNet+CountMLP"])
def test_register_formerly_unported_kinds(kind, cohort, mm_dir, hd_dir, tmp_path):
    """Each model kind that ``register`` refused before registers and writes a
    CSV naming every in-tissue spot with a class."""
    root, dirs, images = cohort
    if kind == "GridNetHexMM":
        model, args = mm_dir, ["--spaceranger", dirs[0], "--images", images[0]]
    else:
        model, args = _kind_dir(kind, tmp_path, dirs, hd_dir)
    out = tmp_path / "u.csv"
    main(["register", "--model", model, *args, "--out", str(out), "--device", "cpu"])
    hd = args[1] == hd_dir[0]
    pos = jax_read_positions(args[1], hd_binning=BINNING if hd else None)
    with open(out, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["Barcode", "AARs"]
    assert sorted(r[0] for r in rows[1:]) == sorted(pos.index[pos["in_tissue"] == 1])
    assert {r[1] for r in rows[1:]} <= set(CLASSES)


def test_register_default_device_needs_cuda(monkeypatch, cohort, count_dir, image_dir,
                                            mm_dir, tmp_path):
    _, dirs, images = cohort
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in (["register", "--model", count_dir, "--spaceranger", dirs[0]],
                 ["register", "--model", image_dir, "--spaceranger", dirs[0],
                  "--images", images[0]],
                 ["register", "--model", mm_dir, "--spaceranger", dirs[0],
                  "--images", images[0]]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args + ["--out", str(tmp_path / "d.csv")])
    assert not (tmp_path / "d.csv").exists()
