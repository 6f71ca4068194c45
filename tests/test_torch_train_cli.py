"""The port's ``train-*`` commands on the CPU (``--device cpu``) against the
JAX package's ``register``.

Cohorts come from the JAX package's ``simulate_spaceranger_dir`` (small
tissue ellipses, 3 classes) with unified count caches from its
``prepare_count_files``. Each command trains from the port's own
initialisation; the model directory it writes must be read by the JAX
package's ``register`` and give exactly the CSV the port's ``register``
writes (the same labels, byte for byte), except the scBERT multimodal
directory, which JAX's command reads through JPEG patches (``ROADMAP.md``
Queue 3 item 4): its CSV is held against JAX's model on JAX's lossless
grid, up to near-ties of JAX's logits:

- ``train-count`` (hex), with ``--resume`` after SIGTERM's guard stops the
  g stage mid-epoch and after it stops the f stage mid-epoch (exit 75),
  equal to an uninterrupted two-epoch run (``g_state.msgpack`` bit for
  bit);
- ``train-image --f tpu --augment`` on 32-px patches;
- ``train-mm --count-f mlp --f tpu``, and ``--count-f scbert`` (a tiny
  scBERT) on a cohort named with gene2vec symbols;
- ``train-image --dense-ingest`` on a square Visium HD lattice;
- ``train-mm`` and ``pretrain-scbert`` on 2 gloo ranks of a ``data=1,
  seq=2`` mesh against one process (``pretrain-scbert`` sequence-parallel;
  the other axes: ``test_torch_parallel.py``).
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


def _registers_like_jax_lossless(model, srd, image, tmp_path):
    """The port's register CSV names the labels of JAX's model on JAX's
    lossless grid (the uint8 crops / 255 and JAX's count grid through its
    scBERT transform) up to near-ties of JAX's logits."""
    import jax.numpy as jnp
    from gridnext_tpu import modeldir as jax_modeldir
    from gridnext_tpu.data import CountGridDataset as JaxCountGridDataset
    from gridnext_tpu.geometry import pseudo_hex_to_oddr
    from gridnext_tpu.io import read_positions as jax_read_positions
    from gridnext_tpu.io.unify import unified_cache_path
    from gridnext_tpu.pipeline import grid_from_wsi_visium
    from gridnext_tpu_torch.serving import label_parity_report

    meta, classes, variables = jax_modeldir.load_model_dir(str(model))
    g = jax_modeldir.mm_model_from_meta(meta, classes)
    xi = grid_from_wsi_visium(image, srd, patch_size=meta["patch_px"], dtype=np.uint8)
    xc, _ = JaxCountGridDataset([unified_cache_path(srd)])[0]
    transform, _ = jax_modeldir.scbert_count_transform([srd], None, meta["scbert_vocab"])
    logits = np.asarray(g.apply(variables, (jnp.asarray(xi[None].astype(np.float32) / 255.0),
                                            jnp.asarray(transform(xc)[None])), train=False))[0]
    want = np.where(xc.sum(-1) > 0, logits.argmax(-1) + 1, 0)
    cli.main(["register", "--spaceranger", srd, "--model", str(model), "--out",
              str(tmp_path / "port.csv"), "--device", "cpu", "--images", image])
    pos = jax_read_positions(srd)
    got = np.zeros(want.shape, np.int64)
    with open(tmp_path / "port.csv") as fh:
        rows = [line.rstrip("\n").split(",") for line in fh][1:]
    for barcode, annot in rows:
        x, y = pseudo_hex_to_oddr(int(pos.loc[barcode, "array_col"]),
                                  int(pos.loc[barcode, "array_row"]))
        got[y, x] = list(classes).index(annot) + 1
    label_parity_report(want, got, logits)
    assert len(rows) == int((want > 0).sum()) > 20


def _train(cmd, cohort, out, *extra, images=True):
    argv = [cmd, "--spaceranger", *cohort["dirs"], "--annots", *cohort["annots"],
            "--out", str(out), "--device", "cpu", *extra]
    if images:
        argv += ["--images", *cohort["images"]]
    cli.main(argv)


def test_train_count_cli_and_resume(cohort, tmp_path, monkeypatch):
    from gridnext_tpu_torch.train import loops, preempt

    _train("train-count", cohort, tmp_path / "m", "--epochs", "2", images=False)
    meta = json.loads((tmp_path / "m" / "model.json").read_text())
    assert meta["model"] == "GridNetHex+CountMLP" and meta["n_genes"] == 20
    assert (tmp_path / "m" / "f_state.msgpack").exists()
    payload = load_checkpoint(tmp_path / "m" / "g_state.msgpack")
    assert set(payload["opt_state"]["inner_states"]) == {"f", "frozen", "g"}
    _registers_alike(tmp_path / "m", cohort["dirs"][0], tmp_path)

    # stopped in g's second epoch, then --resume: the uninterrupted run's bits
    # (a resume continues the run that wrote the .latest files; g's carries
    # the f it was trained with)
    plain, grid_batches = loops._iter_batches, [0]

    def tripping(*args, **kwargs):
        for batch in plain(*args, **kwargs):
            if kwargs.get("pad_kind") == "grid":
                grid_batches[0] += 1
                if grid_batches[0] == 4:         # epoch 2's second train batch
                    preempt.active().trigger()
            yield batch

    monkeypatch.setattr(loops, "_iter_batches", tripping)
    with pytest.raises(SystemExit) as exit_info:
        _train("train-count", cohort, tmp_path / "r", "--epochs", "2", images=False)
    assert exit_info.value.code == 75
    assert load_checkpoint(tmp_path / "r" / "g_state.msgpack.latest")["epochs_done"] == 1
    monkeypatch.setattr(loops, "_iter_batches", plain)
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
    _registers_like_jax_lossless(tmp_path / "m", cohort["dirs"][0], cohort["images"][0],
                                 tmp_path)


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


def _two_ranks(argv, cwd, one: bool, timeout=240):
    """``python -m gridnext_tpu_torch --coordinator ... <argv>`` as 2 gloo
    ranks (one torch thread each) and, with ``one``, the same command in one
    process, all at once: their stdouts."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]),
               OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "gridnext_tpu_torch"]
    procs = [subprocess.Popen(cmd, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in ([*run, "--coordinator", f"{coord},2,0", *argv, "--out", "two",
                          "--mesh", "data=1,seq=2"],
                         [*run, "--coordinator", f"{coord},2,1", *argv, "--out", "two_r1",
                          "--mesh", "data=1,seq=2"],
                         [*run, *argv, "--out", "one"])[:3 if one else 2]]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _loss_lines(log):
    return [(line.split()[0], float(line.split()[2])) for line in log.splitlines()
            if line.startswith(("train Loss", "val Loss"))]


@pytest.fixture(scope="module")
def small_cohort(tmp_path_factory):
    """Two arrays of few spots named with gene2vec symbols."""
    from gridnext_tpu.models.scbert import load_gene2vec_names

    root = tmp_path_factory.mktemp("small")
    names = list(load_gene2vec_names()[:20])
    sims = [simulate_spaceranger_dir(root / f"s{i}", seed=i, n_genes=20, n_classes=3,
                                     image=True, spot_spacing_px=20, tissue_fraction=0.1,
                                     gene_names=names) for i in range(2)]
    dirs = [s["spaceranger_dir"] for s in sims]
    prepare_count_files(dirs, ".unified.tsv.gz", 0.0)
    return {"dirs": dirs, "annots": [s["annot_file"] for s in sims],
            "images": [s["image_file"] for s in sims], "root": root}


@pytest.mark.parametrize("cmd,item", [("train-mm", "item 9"), ("pretrain-scbert", "item 9")])
def test_unported_training_flags_exit(small_cohort, tmp_path, cmd, item):
    """A ``seq`` mesh axis (Queue 1 ``item``, sequence-parallel MLM) runs:
    the command on 2 gloo ranks ``--mesh data=1,seq=2`` against one
    process. ``pretrain-scbert`` shards its 60 tokens over ``seq`` (FAVOR
    sums over the group): its losses within 1e-3 and the LM's weights within
    Adam's sign-step bound (2 lr a step, ROADMAP Queue 3 item 5) of one
    process's. ``train-mm`` shards its spot batches over every axis and its
    grid batches over ``data`` (the ``seq`` ranks hold copies), as JAX's
    does: its model directory registers as JAX's ``register`` does. Only
    rank 0 writes (``--scbert-ckpt`` and the ``data`` and ``spot`` axes:
    ``test_torch_pretrain.py``, ``test_torch_parallel.py``)."""
    c = small_cohort
    if cmd == "train-mm":
        argv = [cmd, "--spaceranger", *c["dirs"], "--annots", *c["annots"], "--images",
                *c["images"], "--device", "cpu", "--epochs", "1", "--f", "tpu",
                "--patch-px", "32", "--batch-size", "32", "--patch-chunk", "2048"]
    else:
        argv = [cmd, "--spaceranger", *c["dirs"], "--device", "cpu", "--epochs", "1",
                "--batch-size", "8", "--scbert-vocab", "59", "--scbert-dim", "16",
                "--scbert-depth", "1", "--scbert-heads", "2", "--scbert-dim-head", "8",
                "--scbert-features", "8", "--redraw-every", "0"]
    two, rank1, *one = _two_ranks(argv, tmp_path, one=cmd != "train-mm")
    assert "[mesh {'data': 1, 'seq': 2}]" in two and "Loss" not in rank1
    assert not (tmp_path / "two_r1").exists() or not any((tmp_path / "two_r1").iterdir())
    if cmd == "train-mm":
        for name in ("f_count_state", "f_image_state", "g_state"):
            assert (tmp_path / "two" / f"{name}.msgpack").exists()
        _registers_alike(tmp_path / "two", c["dirs"][0], tmp_path, c["images"][0])
        return
    one = one[0]
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == \
        sorted(p.name for p in (tmp_path / "one").iterdir())
    got, want = _loss_lines(two), _loss_lines(one)
    assert [p for p, _ in got] == [p for p, _ in want] == ["train", "val"]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=0, atol=1e-3)
    steps = -(-int(two.split("MLM corpus: ")[1].split()[0]) // 8)
    a = load_checkpoint(tmp_path / "two" / "scbert_lm.msgpack")
    b = load_checkpoint(tmp_path / "one" / "scbert_lm.msgpack")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", np.asarray(v)

    la, lb = dict(leaves(a["params"])), dict(leaves(b["params"]))
    assert sorted(la) == sorted(lb)
    for k, v in lb.items():
        np.testing.assert_allclose(la[k], v, rtol=0, atol=2 * 1e-4 * steps, err_msg=k)
