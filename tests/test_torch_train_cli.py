"""The port's ``train-*`` commands on the CPU (``--device cpu``) against the
JAX package's ``register``.

Cohorts come from the JAX package's ``simulate_spaceranger_dir`` (small
tissue ellipses, 3 classes) with unified count caches from its
``prepare_count_files``. Each command trains from the port's own
initialisation; the model directory it writes must be read by the JAX
package's ``register`` and give exactly the CSV the port's ``register``
writes (the same labels, byte for byte):

- ``train-count`` (hex), with ``--resume`` after one epoch, and after
  SIGTERM's guard stops the f stage mid-epoch (exit 75), equal to an
  uninterrupted two-epoch run (``g_state.msgpack`` bit for bit);
- ``train-image --f tpu --augment`` on 32-px patches;
- ``train-mm --count-f mlp --f tpu``, and ``--count-f scbert`` (a tiny
  scBERT) on a cohort named with gene2vec symbols;
- ``train-image --dense-ingest`` on a square Visium HD lattice;
- ``--mesh`` and ``--scbert-ckpt`` exit naming the Queue 1 item that
  ports them.
"""

import json

import numpy as np
import pytest

from gridnext_tpu import cli as jax_cli
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu_torch import cli
from gridnext_tpu_torch.compat.from_jax import load_checkpoint


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=20, n_classes=3,
                                     image=True, spot_spacing_px=20, tissue_fraction=0.25)
            for i in range(3)]
    dirs = [s["spaceranger_dir"] for s in sims]
    prepare_count_files(dirs, ".unified.tsv.gz", 0.0)
    return {"dirs": dirs, "annots": [s["annot_file"] for s in sims],
            "images": [s["image_file"] for s in sims], "root": root}


def _registers_alike(model, srd, tmp_path, images=None):
    """The JAX package's register and the port's give the same CSV."""
    extra = ["--images", images] if images else []
    jax_cli.main(["register", "--spaceranger", srd, "--model", str(model),
                  "--out", str(tmp_path / "jax.csv")] + extra)
    cli.main(["register", "--spaceranger", srd, "--model", str(model), "--out",
              str(tmp_path / "port.csv"), "--device", "cpu"] + extra)
    want = (tmp_path / "jax.csv").read_text()
    assert (tmp_path / "port.csv").read_text() == want
    assert len(want.splitlines()) > 20


def _train(cmd, cohort, out, *extra, images=True):
    argv = [cmd, "--spaceranger", *cohort["dirs"], "--annots", *cohort["annots"],
            "--out", str(out), "--device", "cpu", *extra]
    if images:
        argv += ["--images", *cohort["images"]]
    cli.main(argv)


def test_train_count_cli_and_resume(cohort, tmp_path):
    _train("train-count", cohort, tmp_path / "m", "--epochs", "2", images=False)
    meta = json.loads((tmp_path / "m" / "model.json").read_text())
    assert meta["model"] == "GridNetHex+CountMLP" and meta["n_genes"] == 20
    assert (tmp_path / "m" / "f_state.msgpack").exists()
    payload = load_checkpoint(tmp_path / "m" / "g_state.msgpack")
    assert set(payload["opt_state"]["inner_states"]) == {"f", "frozen", "g"}
    _registers_alike(tmp_path / "m", cohort["dirs"][0], tmp_path)

    # one epoch, then --resume to two: the uninterrupted run's bits
    _train("train-count", cohort, tmp_path / "r", "--epochs", "1", images=False)
    _train("train-count", cohort, tmp_path / "r", "--epochs", "2", "--resume", images=False)
    a = load_checkpoint(tmp_path / "m" / "g_state.msgpack")
    b = load_checkpoint(tmp_path / "r" / "g_state.msgpack")
    for coll in ("params", "batch_stats"):
        for layer, leaves in a[coll]["corrector"].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(b[coll]["corrector"][layer][leaf], v)


def test_train_count_preempted_exits_75_and_resumes(cohort, tmp_path, monkeypatch):
    """SIGTERM's guard, tripped at the f stage's third batch: exit 75 after
    the mid-epoch checkpoint; ``--resume`` then ends where an uninterrupted
    run ends (``g_state.msgpack`` bit for bit)."""
    from gridnext_tpu_torch.train import loops, preempt

    plain = loops._iter_batches
    seen = {"n": 0}

    def tripping(*args, **kwargs):
        for batch in plain(*args, **kwargs):
            seen["n"] += 1
            if seen["n"] == 3:
                preempt.active().trigger()
            yield batch

    monkeypatch.setattr(loops, "_iter_batches", tripping)
    with pytest.raises(SystemExit) as exit_info:
        _train("train-count", cohort, tmp_path / "p", "--epochs", "2", images=False)
    assert exit_info.value.code == 75
    meta = load_checkpoint(tmp_path / "p" / "f_state.msgpack.latest")
    # the third batch is drawn while batches are staged ahead of the steps:
    # the guard is seen at a step boundary before it
    assert meta["epochs_done"] == 0 and 0 < meta["batches_done"] < 3
    monkeypatch.setattr(loops, "_iter_batches", plain)
    _train("train-count", cohort, tmp_path / "p", "--epochs", "2", "--resume", images=False)
    _train("train-count", cohort, tmp_path / "u", "--epochs", "2", images=False)
    a = load_checkpoint(tmp_path / "u" / "g_state.msgpack")
    b = load_checkpoint(tmp_path / "p" / "g_state.msgpack")
    for coll in ("params", "batch_stats"):
        for layer, leaves in a[coll]["corrector"].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(b[coll]["corrector"][layer][leaf], v)


def test_train_image_cli(cohort, tmp_path):
    _train("train-image", cohort, tmp_path / "m", "--epochs", "1", "--f", "tpu",
           "--patch-px", "32", "--batch-size", "64", "--patch-chunk", "2048",
           "--augment")
    meta = json.loads((tmp_path / "m" / "model.json").read_text())
    assert meta["model"] == "GridNetHex+TpuPatchClassifier" and meta["image_f"] == "tpu"
    _registers_alike(tmp_path / "m", cohort["dirs"][1], tmp_path, cohort["images"][1])


def test_train_mm_cli(cohort, tmp_path):
    _train("train-mm", cohort, tmp_path / "m", "--epochs", "1", "--f", "tpu",
           "--patch-px", "32", "--batch-size", "64", "--patch-chunk", "2048")
    meta = json.loads((tmp_path / "m" / "model.json").read_text())
    assert meta["model"] == "GridNetHexMM" and meta["count_f"] == "mlp"
    for name in ("f_count_state", "f_image_state", "g_state"):
        assert (tmp_path / "m" / f"{name}.msgpack").exists()
    _registers_alike(tmp_path / "m", cohort["dirs"][2], tmp_path, cohort["images"][2])


def test_train_mm_scbert_cli(tmp_path):
    """``--count-f scbert`` (a tiny scBERT over the first 60 gene2vec
    tokens) on a cohort named with gene2vec symbols."""
    from gridnext_tpu.models.scbert import load_gene2vec_names

    names = list(load_gene2vec_names()[:20])
    sims = [simulate_spaceranger_dir(tmp_path / f"s{i}", seed=i, n_genes=20, n_classes=3,
                                     image=True, spot_spacing_px=20, tissue_fraction=0.25,
                                     gene_names=names) for i in range(2)]
    cohort = {"dirs": [s["spaceranger_dir"] for s in sims],
              "annots": [s["annot_file"] for s in sims],
              "images": [s["image_file"] for s in sims]}
    prepare_count_files(cohort["dirs"], ".unified.tsv.gz", 0.0)
    _train("train-mm", cohort, tmp_path / "m", "--epochs", "1", "--f", "tpu",
           "--patch-px", "32", "--batch-size", "64", "--patch-chunk", "2048",
           "--count-f", "scbert", "--scbert-vocab", "60", "--scbert-dim", "16",
           "--scbert-depth", "1", "--scbert-heads", "2", "--scbert-dim-head", "8",
           "--scbert-features", "8", "--count-chunk", "64")
    meta = json.loads((tmp_path / "m" / "model.json").read_text())
    assert meta["count_f"] == "scbert" and meta["scbert_vocab"] == 60
    assert "favor" in load_checkpoint(tmp_path / "m" / "g_state.msgpack")["extra_vars"]
    _registers_alike(tmp_path / "m", cohort["dirs"][0], tmp_path, cohort["images"][0])


def test_train_image_dense_ingest_square(tmp_path):
    binning, pitch = "square_016um", 32
    sims = [simulate_spaceranger_dir(tmp_path / f"h{i}", seed=7 + i, n_genes=8,
                                     n_classes=3, spaceranger_version="hd",
                                     hd_grid=(12, 10), hd_binning=binning, image=True,
                                     spot_spacing_px=pitch) for i in range(2)]
    cohort = {"dirs": [s["spaceranger_dir"] for s in sims],
              "annots": [s["annot_file"] for s in sims],
              "images": [s["image_file"] for s in sims]}
    _train("train-image", cohort, tmp_path / "m", "--epochs", "1", "--f", "tpu",
           "--hd-binning", binning, "--grid-dims", "auto", "--dense-ingest",
           "--patch-px", str(pitch))
    meta = json.loads((tmp_path / "m" / "model.json").read_text())
    assert meta["dense_ingest"] is True and meta["grid_dims"] == [12, 10]
    assert meta["model"] == "GridNet+TpuPatchClassifier"
    assert not (tmp_path / "m" / "f_state.msgpack").exists()   # no spotwise stage
    _registers_alike(tmp_path / "m", cohort["dirs"][0], tmp_path, cohort["images"][0])


@pytest.mark.parametrize("flag,item", [(["--mesh", "data=2"], "item 9"),
                                       (["--scbert-ckpt", "x.pth"], "item 6")])
def test_unported_training_flags_exit(cohort, tmp_path, flag, item):
    with pytest.raises(SystemExit, match=item):
        _train("train-mm", cohort, tmp_path / "m", "--count-f", "scbert", *flag)
