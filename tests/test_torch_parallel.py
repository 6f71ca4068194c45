"""The port's parallel tier against the JAX package's, on the CPU.

Training runs one process a card over ``torch.distributed`` (gloo here);
the multi-rank tests start their ranks as subprocesses, each with a
timeout of its own, and hold them against one process at the same global
batch:

- ``train_mlm`` of a small PerformerLM through FAVOR (3 steps, a
  projection redraw after each): the losses within 1e-6 relative, every
  step's gradients within 1e-6 abs + 1e-5 rel, the ranks' weights and
  projections equal, and the projections those of one process;
- one train step of a grid model (global-batch BatchNorm in g) on a
  ``{'data': 2}`` and a ``{'data': 1, 'spot': 2}`` mesh, and of a spot model
  over a padded batch: the loss within 1e-6 relative, every gradient within
  1e-6 abs + 1e-5 rel, the BatchNorm statistics within 1e-6, and the two
  ranks' parameters after the step equal;
- the ``train-count`` command on 2 ranks (``--coordinator``, ``--mesh
  data=2``) against one process: the spot stage's train losses within 1e-5
  relative, f's weights and BatchNorm statistics within 1e-5 abs + 1e-4
  rel except the biases of zero true gradient and the running means they
  shift (``SIGN_LIMIT``, ROADMAP Queue 3 item 5: Adam moves them by about
  lr a step, held to 2 lr a step), and the val losses, which read those
  running means, held to the same bound; g is held to the bound too (its
  input is eval-mode f); only rank 0 writes files;
- a ``.latest`` written by 2 ranks resumes in 1 process, and one written by
  1 process on 2 ranks, to the uninterrupted trajectory.

Also: the mesh factorization, the balanced shard split, the divisibility
errors and the odd-H warning word for word, the contiguous-ranks check,
the ``seq`` axis's token length and its serving refusal, the commands'
mesh and multihost refusals, and
``SlideRegistrar(mesh=...)`` over 2 CPU shards against the unsharded
registrar and JAX's registrar on its 8-device CPU mesh.
"""

import argparse
import faulthandler
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu import cli as jax_cli
from gridnext_tpu.parallel import make_mesh as jax_make_mesh
from gridnext_tpu.parallel import mesh as jax_mesh
from gridnext_tpu.parallel import multihost as jax_multihost
from gridnext_tpu.train import loops as jax_loops
from gridnext_tpu_torch import cli
from gridnext_tpu_torch.parallel import collectives, make_mesh, mesh, multihost
from gridnext_tpu_torch.parallel.mesh import Mesh
from gridnext_tpu_torch.train import loops as tl

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 120            # seconds a rank subprocess may take
GROUP_TIMEOUT = 60       # seconds a worker's collective waits for the other rank
MODULE_TIMEOUT = 300     # seconds the whole module may take
SIGN_LIMIT = ("Dense_0/bias", "Dense_1/bias", "Dense_2/bias", "Dense_3/bias",
              "HexConv_1/bias", "HexConv_3/bias", "/mean")


@pytest.fixture(scope="module", autouse=True)
def module_timeout():
    """End this test process, every thread's traceback dumped, if the
    module outlives MODULE_TIMEOUT: a hang then costs the suite this
    module, not its whole time limit."""
    faulthandler.dump_traceback_later(MODULE_TIMEOUT, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(argvs, cwd):
    """Start the ``argvs`` processes at once (one torch thread each)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(a, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for a in argvs]


def _wait(procs, timeout=TIMEOUT):
    """The stdouts of ``procs``, or the failure of any (all killed)."""
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


# -- one process: shapes, splits, messages ------------------------------------------


def test_default_mesh_shape_and_shard_split_match_jax():
    for n in range(1, 10):
        assert mesh.default_mesh_shape(n) == jax_mesh.default_mesh_shape(n)
    for n_items in (0, 1, 7, 32, 33):
        for count in (1, 2, 3, 5):
            for index in range(count):
                assert multihost.local_shard_indices(n_items, index, count) == \
                    jax_multihost.local_shard_indices(n_items, index, count)
    with pytest.raises(ValueError, match="outside"):
        multihost.local_shard_indices(4, 2, 2)
    assert multihost.local_shard_indices(5) == range(5)     # one process: everything
    assert multihost.is_primary() and multihost.process_count() == 1


def _messages(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_divisibility_errors_and_odd_h_warning_match_jax():
    shape = {"data": 4, "spot": 2}
    jm = jax_make_mesh(shape, jax.devices()[:8])
    pm = Mesh(shape, devices=["cpu"] * 8)
    assert _messages(lambda: mesh.grid_batch_rows(3, pm)) == \
        _messages(lambda: jax_mesh.shard_grid_batch(jnp.zeros((3, 78, 8)), jm))
    assert _messages(lambda: mesh.spot_batch_rows(12, pm)) == \
        _messages(lambda: jax_mesh.shard_spot_batch(jnp.zeros((12, 5)), jm))
    for kind, batch in (("grid", 6), ("spot", 12), ("mlm", 4)):
        assert _messages(lambda: tl._mesh_placement(pm, kind, batch)) == \
            _messages(lambda: jax_loops._mesh_placement(jm, kind, batch))
    with pytest.warns(UserWarning) as ours:
        assert mesh.spot_rows(77, pm) is None
    with pytest.warns(UserWarning) as theirs:
        jax_mesh.shard_grid_batch(jnp.zeros((4, 77, 8)), jm)
    assert str(ours[0].message) == str(theirs[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        share = mesh.spot_rows(78, pm)
    assert (share.index, share.count) == (0, 2)
    # this rank's rows: rank 0 of {'data': 4, 'spot': 2} holds grid 0 and spot row half 0
    assert list(tl._mesh_placement(pm, "grid", 8)(np.arange(8))) == [0, 1]
    assert list(tl._mesh_placement(pm, "spot", 16)(np.arange(16))) == [0, 1]
    x = np.arange(16 * 3).reshape(16, 3)
    np.testing.assert_array_equal(mesh.shard_spot_batch({"x": x}, pm)["x"], x[:2])
    with pytest.warns(UserWarning, match="not divisible by mesh axis 'spot'"):
        np.testing.assert_array_equal(mesh.shard_grid_batch(np.zeros((8, 77, 2)), pm),
                                      np.zeros((2, 77, 2)))


def test_contiguous_ranks_check():
    ok = Mesh({"data": 2, "spot": 2}, devices=["cpu"] * 4)
    for fn in (multihost.global_grid_batch, multihost.global_spot_batch):
        out = fn({"x": np.ones((2, 3))}, ok)
        assert torch.is_tensor(out["x"]) and out["x"].device.type == "cpu"
    bad = Mesh({"spot": 2, "data": 2}, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match=r"put the process-spanning \('data'\) axis FIRST"):
        multihost.global_grid_batch(np.ones((2, 3)), bad)
    multihost.global_spot_batch(np.ones((2, 3)), bad)      # every axis: any order


def test_seq_axis_and_process_count_refusals():
    # a 'seq' axis trains (one process a rank; tests/test_torch_seq.py runs
    # it): the token length pads as JAX's, a mesh needs its ranks, and only
    # a serving mesh refuses the axis
    for shape in ({"data": 1, "seq": 2}, {"seq": 3}):
        assert tl.mlm_token_len(10, mesh_shape=shape) == \
            jax_loops.mlm_token_len(10, mesh_shape=shape)
    assert tl.mlm_token_len(10, {"seq": 2}) == 10 and tl.mlm_token_len(11, {"seq": 2}) == 12
    for fn in (lambda: make_mesh({"data": 1, "seq": 2}),
               lambda: tl._resolve_mesh(None, {"seq": 2})):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m gridnext_tpu_torch"):
            fn()
    with pytest.raises(ValueError, match="a serving mesh has no 'seq' axis"):
        make_mesh({"data": 1, "seq": 2}, devices=["cpu"] * 2)
    assert tl.mlm_token_len(10, mesh_shape={"data": 2}) == 10
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m gridnext_tpu_torch"):
        tl._resolve_mesh(None, {"data": 2})
    with pytest.raises(ValueError, match="OR mesh_shape"):
        tl._resolve_mesh("auto", "auto")
    with pytest.raises(ValueError, match="must be a dict or 'auto'"):
        tl._resolve_mesh(None, "bogus")
    one = tl._resolve_mesh({"data": 1}, None)          # a 1-rank mesh, no process group
    assert one.shape == {"data": 1} and not one.distributed
    with pytest.raises(ValueError, match="needs 2 devices but only 1 visible"):
        make_mesh({"spot": 2}, devices=["cpu"])


def test_draw_rows_takes_the_global_batchs_rows():
    gen = lambda: torch.Generator().manual_seed(3)       # noqa: E731
    full = torch.rand((6, 4), generator=gen())
    with collectives.sharded(rows=collectives.RowShard(2, 4, 6)):
        part = collectives.draw_rows(lambda s: torch.rand(s, generator=gen()), (2, 4))
        other = collectives.draw_rows(lambda s: torch.rand(s, generator=gen()), (3, 4))
    assert torch.equal(part, full[2:4]) and other.shape == (3, 4)
    assert collectives.batch_norm_group() is None and collectives.spot_shard() is None


def test_cli_mesh_and_multihost_refusals(tmp_path, capsys, monkeypatch):
    def exit_message(main, argv):
        with pytest.raises(SystemExit) as e:
            main(argv)
        return str(e.value.code)

    argv = ["--multihost", "register", "--model", "m", "--spaceranger", "s", "--out", "o"]
    assert exit_message(cli.main, argv) == exit_message(jax_cli.main, argv)
    argv = ["serve", "--artifact", str(tmp_path / "a.pt2"), "--mesh", "data=2"]
    assert exit_message(cli.main, argv) == exit_message(jax_cli.main, argv)
    for spec in ("data=0", "data", "x=1,"):
        assert exit_message(cli._parse_mesh, argparse.Namespace(mesh=spec)) == \
            exit_message(jax_cli._parse_mesh, argparse.Namespace(mesh=spec))
    assert cli._parse_mesh(argparse.Namespace(mesh="Data=4,spot=2")) == \
        jax_cli._parse_mesh(argparse.Namespace(mesh="Data=4,spot=2"))
    assert cli._parse_mesh(argparse.Namespace(mesh="data=1,seq=2")) == \
        jax_cli._parse_mesh(argparse.Namespace(mesh="data=1,seq=2")) == {"data": 1, "seq": 2}
    base = ["train-count", "--spaceranger", "s", "--annots", "a", "--out",
            str(tmp_path / "o"), "--device", "cpu"]
    assert "needs 2 processes" in exit_message(
        cli._checked_mesh, argparse.Namespace(mesh="data=2"))
    assert "'host:port,num_processes,process_id'" in exit_message(
        cli.main, ["--coordinator", "127.0.0.1:1"] + base)
    # fail fast on batch divisibility, before any stage trains
    monkeypatch.setattr(tl, "_resolve_mesh",
                        lambda m, s: Mesh(s, devices=["cpu"] * 8))
    args = argparse.Namespace(mesh="data=4,spot=2")
    assert "(adjust --batch-size / --grid-batch-size before training starts)" in \
        exit_message(lambda a: cli._checked_mesh(a, spot_batch=8, grid_batch=1), args)
    assert cli._checked_mesh(args, spot_batch=8, grid_batch=4).shape == \
        {"data": 4, "spot": 2}
    assert args.train_mesh.shape == {"data": 4, "spot": 2}


# -- serving over a device mesh ------------------------------------------------------


def _port_gridnet():
    from gridnext_tpu_torch.models import GridNetHex, TpuPatchClassifier

    return GridNetHex(TpuPatchClassifier(n_classes=3, stages=((64, 1),), stem_patch=8),
                      n_classes=3, f_dim=3)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two simulated slides and one set of numpy-seeded weights (flax's
    initialisers drawn by the port, in the JAX layout) for both packages."""
    from PIL import Image

    from gridnext_tpu.data import simulate_spaceranger_dir
    from gridnext_tpu.models import GridNetHex as JaxGridNetHex
    from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
    from gridnext_tpu_torch.compat.from_jax import jax_variables
    from gridnext_tpu_torch.train.init import flax_init_

    root = tmp_path_factory.mktemp("mesh_serving")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=8, n_classes=3,
                                     image=True, tissue_fraction=frac, spot_spacing_px=12)
            for i, frac in enumerate((0.5, 0.3))]
    wsis = np.stack([np.asarray(Image.open(s["image_file"])) for s in sims])
    jg = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=3, stages=((64, 1),),
                                                 stem_patch=8), n_classes=3)
    g = _port_gridnet()
    flax_init_(g, torch.Generator().manual_seed(0))
    return sims, wsis, jg, jax_variables(g)


def test_registrar_mesh_matches_unsharded_and_jax(served):
    from gridnext_tpu.io import read_positions as jax_read_positions
    from gridnext_tpu.serving import SlideRegistrar as JaxSlideRegistrar
    from gridnext_tpu_torch.compat.from_jax import load_gridnet
    from gridnext_tpu_torch.io import read_positions
    from gridnext_tpu_torch.ops import patch_gather_cuda
    from gridnext_tpu_torch.serving import SlideRegistrar, label_parity_report

    sims, wsis, jg, variables = served

    def port(mesh=None):
        return SlideRegistrar.from_gridnet(load_gridnet(_port_gridnet(), variables),
                                           patch_size=32,
                                           normalize=None, patch_chunk=100, device="cpu",
                                           mesh=mesh)

    single, sharded = port(), port(make_mesh({"spot": 2}, devices=["cpu", "cpu"]))
    jax_sharded = JaxSlideRegistrar.from_gridnet(
        jg, variables, patch_size=32, normalize=None, patch_chunk=100, extractor="pallas",
        mesh=jax_make_mesh({"data": 4, "spot": 2}, jax.devices()[:8]))
    pos = [read_positions(s["spaceranger_dir"]) for s in sims]
    jpos = [jax_read_positions(s["spaceranger_dir"]) for s in sims]
    n = patch_gather_cuda.launches
    got = sharded.register_batch(torch.from_numpy(wsis), pos)
    assert patch_gather_cuda.launches == n       # CPU tensors take the plain version
    np.testing.assert_array_equal(got, single.register_batch(torch.from_numpy(wsis), pos))
    want = np.asarray(jax_sharded.register_batch(jnp.asarray(wsis), jpos))
    for i in range(len(sims)):
        logits, _ = single.register_logits(wsis[i], pos[i])
        label_parity_report(want[i], got[i], logits)
        np.testing.assert_array_equal(sharded(wsis[i], pos[i]), got[i])
        np.testing.assert_array_equal(got[i] > 0, sims[i]["label_grid"] > 0)
    # slides pad their spots to a bucket of 128, so the shards' own padding
    # runs on an odd spot count taken alone
    w = torch.from_numpy(wsis)
    yx = torch.tensor([40, 52, 64, 76, 88])
    slide = torch.tensor([0, 1, 0, 1, 1])
    torch.testing.assert_close(sharded._feats_flat(w, yx, yx + 8, slide),
                               single._feats_flat(w, yx, yx + 8, slide), rtol=1e-5,
                               atol=1e-6)
    # a shard on another device runs a copy of f there ('cpu:0' is not 'cpu')
    other = port(make_mesh({"spot": 2}, devices=["cpu", "cpu:0"]))
    np.testing.assert_array_equal(other.register_batch(torch.from_numpy(wsis), pos), got)
    assert list(other._shards) == [torch.device("cpu", 0)]
    for ours, theirs in ((lambda: sharded.export((64, 64, 3), 128),
                          lambda: jax_sharded.export((64, 64, 3), 128)),):
        assert _messages(ours) == _messages(theirs)
    with pytest.raises(ValueError, match="training meshes span processes"):
        port(Mesh({"data": 1}))


def test_serving_mesh_refusals(monkeypatch, tmp_path):
    from gridnext_tpu.server import RegistrationService as JaxService
    from gridnext_tpu_torch import server
    from gridnext_tpu_torch.compat import from_jax

    meta = ({"model": "GridNetHex+CountMLP"}, ["a"], {})
    monkeypatch.setattr(from_jax, "load_model_dir", lambda d: meta)
    monkeypatch.setattr("gridnext_tpu.modeldir.load_model_dir", lambda d: meta)
    pm = Mesh({"data": 2}, devices=["cpu", "cpu"])
    ours = _messages(lambda: server.RegistrationService.from_model_dir(
        tmp_path, device="cpu", mesh=pm))
    assert ours == _messages(lambda: JaxService.from_model_dir(tmp_path, mesh=object()))
    with pytest.raises(ValueError, match="needs 2 devices but only 1 visible"):
        cli._serving_mesh(argparse.Namespace(mesh="data=2", device="cuda:0")) \
            if torch.cuda.is_available() else make_mesh({"data": 2}, devices=["cpu"])
    got = cli._serving_mesh(argparse.Namespace(mesh="spot=2", device="cpu"))
    assert got.devices == [torch.device("cpu")] * 2


# -- several processes ---------------------------------------------------------------

STEP_WORKER = r'''
import json, sys
import numpy as np, torch
from gridnext_tpu_torch.parallel import initialize_multihost
from gridnext_tpu_torch.parallel.mesh import spot_rows
from gridnext_tpu_torch.models import CountMLP, GridNetHex, PerformerLM
from gridnext_tpu_torch.train import loops as tl
coord, world, rank, timeout = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
if world:
    initialize_multihost(coord, world, rank, device="cpu", timeout=float(timeout))
out = {}
for name, kind, shape in (("data2", "grid", {"data": 2}),
                          ("spot2", "grid", {"data": 1, "spot": 2}),
                          ("spot", "spot", {"data": 2})):
    rng = np.random.default_rng(0)
    if kind == "grid":
        x = rng.normal(size=(2, 78, 64, 12)).astype(np.float32)
        y = rng.integers(0, 4, size=(2, 78, 64))
        model = GridNetHex(CountMLP(12, 3, hidden=(20, 10, 10, 6)), 3, 3)
        tx, batch = tl.make_gridwise_optimizer(1e-3), 2
    else:
        x = rng.normal(size=(7, 12)).astype(np.float32)
        y = rng.integers(0, 3, size=(7,))
        model, tx, batch = CountMLP(12, 3, hidden=(20, 10, 10, 6)), tl.make_adam(1e-3), 8
    st = tl.create_train_state(model, tx, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    ms = shard = None
    if world:
        m = tl._resolve_mesh(None, shape)
        shard = tl._mesh_placement(m, kind, batch)
        ms = tl._MeshStep(shard(np.arange(batch)), batch,
                          copies=m.size // m.axis_size("data") if kind == "grid" else 1)
        if kind == "grid":
            ms.spot = spot_rows(78, m)
    step, _ = tl.make_steps(st, kind, mesh_step=ms)
    (xb, yb, _), = tl._iter_batches((x, y), batch, None, pad_kind=kind, shard=shard)
    grads = {}
    apply = st.optimizer.step
    def capture():
        for n, p in model.named_parameters():
            if p.grad is not None:
                grads[n] = p.grad.detach().numpy().ravel().tolist()
        apply()
    st.optimizer.step = capture
    metrics = step(torch.as_tensor(xb), torch.as_tensor(yb))
    out[name] = {"loss": float(metrics["loss"]), "n": int(metrics["n"]), "grads": grads,
                 "after": {k: v.detach().numpy().ravel().tolist()
                           for k, v in model.state_dict().items()}}
# masked-LM pretraining through FAVOR: 10 rows in batches of 4 (the last one
# padded), dropout, and a projection redraw after every step
rng = np.random.default_rng(1)
tokens = rng.integers(0, 6, size=(14, 16))
lm = PerformerLM(num_tokens=7, max_seq_len=16, dim=16, depth=2, heads=2, dim_head=8,
                 nb_features=12, generalized_attention=True, emb_dropout=0.1,
                 ff_dropout=0.1)
st = tl.create_train_state(lm, tl.make_adam(1e-3), generator=torch.Generator().manual_seed(0),
                           device="cpu")
steps = []
apply = st.optimizer.step
def capture_each():
    steps.append({n: p.grad.detach().numpy().ravel().tolist()
                  for n, p in lm.named_parameters() if p.grad is not None})
    apply()
st.optimizer.step = capture_each
_, val, train = tl.train_mlm(lm, {"train": tokens[:10], "val": tokens[10:]}, mask_id=6,
                             num_epochs=1, batch_size=4, state=st, redraw_every=1,
                             verbose=False, device="cpu",
                             mesh_shape={"data": 2} if world else None)
out["mlm"] = {"train": train, "val": val, "grads": steps,
              "after": {k: v.detach().numpy().ravel().tolist()
                        for k, v in lm.state_dict().items()}}
print(json.dumps(out))
'''


@pytest.mark.parametrize("name", ["data2", "spot2"])
def test_two_rank_step_matches_one_process(name, ranks):
    one, r0, r1 = ranks.result("step")
    for kind in (name, "spot"):
        want, got = one[kind], r0[kind]
        assert got["n"] == want["n"] and r1[kind]["loss"] == got["loss"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-5, atol=1e-6, err_msg=k)
        for k, v in want["after"].items():
            assert r1[kind]["after"][k] == got["after"][k], k       # replicas equal
            if "running" in k:
                np.testing.assert_allclose(got["after"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_two_rank_mlm_matches_one_process(ranks):
    """``train_mlm`` on 2 ranks: each rank's rows of the MLM mask and the
    dropout masks (``draw_rows``), the padded last batch, and the FAVOR
    projections redrawn after every step alike on every rank."""
    one, r0, r1 = (r["mlm"] for r in ranks.result("step"))
    assert r1["train"] == r0["train"] and r1["val"] == r0["val"]
    np.testing.assert_allclose(r0["train"], one["train"], rtol=1e-6)
    np.testing.assert_allclose(r0["val"], one["val"], rtol=1e-6)
    assert len(r0["grads"]) == len(one["grads"]) == 3
    for i, (got, want) in enumerate(zip(r0["grads"], one["grads"])):
        assert sorted(got) == sorted(want)
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g, rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    projections = [k for k in one["after"] if k.endswith("fast_attention.projection")]
    assert len(projections) == 2
    for k, v in one["after"].items():
        assert r1["after"][k] == r0["after"][k], k           # replicas equal
    for k in projections:
        assert r0["after"][k] == one["after"][k], k           # the same 3 redraws


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _close_checkpoints(got_path, want_path, bound):
    """Every float leaf within 1e-5 abs + 1e-4 rel; the SIGN_LIMIT leaves
    (and, with ``all_bound``, every leaf) within ``bound``."""
    from gridnext_tpu_torch.compat.from_jax import load_checkpoint

    got = dict(_leaves(load_checkpoint(got_path)))
    want = dict(_leaves(load_checkpoint(want_path)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype.kind != "f" or "opt_state" in k:
            continue
        if bound is not None and (any(s in k for s in SIGN_LIMIT + ("best_val_loss",))
                                  or bound == "all"):
            if bound != "all":
                np.testing.assert_allclose(got[k], w, rtol=0, atol=bound, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    return got, want


def _losses(log):
    """[(phase, loss)] of a training command's log."""
    out = []
    for line in log.splitlines():
        if line.startswith(("train Loss", "val Loss")):
            out.append((line.split()[0], float(line.split()[2])))
    return out


def test_train_count_two_ranks_match_one_process(ranks):
    root = ranks.root
    one, r0, r1 = ranks.result("cli")
    assert "[mesh {'data': 2}]" in r0 and "saved model to two" in r0
    assert "saved model to" not in r1 and "Loss" not in r1         # rank 1 reports nothing
    assert sorted(os.listdir(root / "two")) == sorted(os.listdir(root / "one"))
    assert os.listdir(root / "two_rank1") == []                     # only rank 0 writes
    want, got = _losses(one), _losses(r0)
    assert [p for p, _ in got] == [p for p, _ in want] == ["train", "val"] * 4
    f_lr, g_lr, spot_steps = 1e-4, 1e-3, 2 * -(-4158 * 4 // 5 // 256)
    bound_f = 2 * f_lr * spot_steps
    for (p, a), (_, b) in zip(got[:4], want[:4]):                     # the spot stage
        if p == "train":
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=bound_f + 1e-4)
    _close_checkpoints(root / "two" / "f_state.msgpack", root / "one" / "f_state.msgpack",
                       bound_f)
    # g trains on eval-mode f, whose output moves with f's sign-limited biases
    got_g, want_g = _close_checkpoints(root / "two" / "g_state.msgpack",
                                       root / "one" / "g_state.msgpack", "all")
    bound_g = 2 * g_lr * 2 + 0.01
    for k, w in want_g.items():
        if w.dtype.kind == "f" and "opt_state" not in k and "patch_classifier" not in k:
            np.testing.assert_allclose(got_g[k], w, rtol=0, atol=bound_g, err_msg=k)
    for (_, a), (_, b) in zip(got[4:], want[4:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=bound_g)


RESUME_WORKER = r'''
import json, sys
import numpy as np, torch
from gridnext_tpu_torch.parallel import initialize_multihost
from gridnext_tpu_torch.models import CountMLP
from gridnext_tpu_torch.train import train_spotwise
coord, world, rank, epochs, out, resume, timeout = sys.argv[1:8]
world, rank, epochs = int(world), int(rank), int(epochs)
if world:
    initialize_multihost(coord, world, rank, device="cpu", timeout=float(timeout))
rng = np.random.default_rng(5)
x = rng.normal(1.0, 2.0, size=(75, 10)).astype(np.float32)
y = ((x[:, 0] > 1).astype(np.int64) + (x[:, 1] > 2)).astype(np.int64)
st, vh, th = train_spotwise(CountMLP(10, 3, hidden=(16, 12, 12, 8)),
                            {"train": (x[:60], y[:60]), "val": (x[60:], y[60:])},
                            num_epochs=epochs, batch_size=16, learning_rate=1e-3,
                            outfile=out, resume=None if resume == "-" else resume,
                            device="cpu", verbose=False,
                            generator=torch.Generator().manual_seed(2),
                            mesh_shape={"data": world} if world else None)
print(json.dumps({"train": th, "val": vh}))
'''


def _resume_worker(tmp_path, world, rank, epochs, out, resume="-", coord="-"):
    return [sys.executable, "-c", RESUME_WORKER, coord, str(world), str(rank),
            str(epochs), str(tmp_path / out), resume, str(GROUP_TIMEOUT)]


class _Ranks:
    """The multi-process runs, started together once for the module."""

    def __init__(self, root):
        self.root, self.procs, self.outs = root, {}, {}

    def result(self, name):
        if name not in self.outs:
            outs = _wait(self.procs.pop(name))
            self.outs[name] = ([json.loads(o) for o in outs] if name != "cli" else outs)
        return self.outs[name]


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test, so that the ranks run while
    the single-process tests do."""
    root = tmp_path_factory.mktemp("ranks")
    runs = _Ranks(root)
    coord = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    runs.procs["step"] = _start([[sys.executable, "-c", STEP_WORKER, coord[0], str(w), str(r),
                                  str(GROUP_TIMEOUT)] for w, r in ((0, 0), (2, 0), (2, 1))],
                                root)
    w = lambda *a, **k: _resume_worker(root, *a, **k)      # noqa: E731
    runs.procs["resume"] = _start([w(0, 0, 3, "ref.msgpack"),
                                   w(2, 0, 1, "a.msgpack", coord=coord[1]),
                                   w(2, 1, 1, "a_rank1.msgpack", coord=coord[1]),
                                   w(0, 0, 1, "b.msgpack")], root)
    cli.main(["simulate", "--out", str(root / "sim"), "--arrays", "3", "--genes", "30",
              "--seed", "7"])
    dirs = [str(root / "sim" / f"a{i}") for i in range(3)]
    cli.main(["prepare", "--spaceranger", *dirs])
    annots = [os.path.join(d, f"a{i}_annotations.csv") for i, d in enumerate(dirs)]
    command = ["train-count", "--spaceranger", *dirs, "--annots", *annots, "--epochs", "2",
               "--batch-size", "256", "--grid-batch-size", "2", "--device", "cpu"]
    run = [sys.executable, "-m", "gridnext_tpu_torch"]
    runs.procs["cli"] = _start([run + command + ["--out", "one"],
                                run + ["--coordinator", f"{coord[2]},2,0"] + command
                                + ["--out", "two", "--mesh", "data=2"],
                                run + ["--coordinator", f"{coord[2]},2,1"] + command
                                + ["--out", "two_rank1", "--mesh", "data=2"]], root)
    yield runs
    for procs in runs.procs.values():
        for p in procs:
            p.kill()
            p.communicate()


def test_latest_resumes_across_rank_counts(ranks):
    """2 ranks for epoch 1, then 1 process from their ``.latest`` for epochs
    2-3, and the reverse, against one process for all 3 epochs."""
    root = ranks.root
    ref = ranks.result("resume")[0]
    assert not (root / "a_rank1.msgpack.latest").exists()
    latest_a, latest_b = (str(root / f"{n}.msgpack.latest") for n in "ab")
    coord = f"127.0.0.1:{_free_port()}"
    a, b, _ = (json.loads(o) for o in _wait(_start(
        [_resume_worker(root, 0, 0, 3, "a.msgpack", latest_a),
         _resume_worker(root, 2, 0, 3, "b.msgpack", latest_b, coord),
         _resume_worker(root, 2, 1, 3, "b_rank1.msgpack", latest_b, coord)], root)))
    bound = 2 * 1e-3 * 12            # Adam's sign steps: 2 lr a step, 12 steps
    for got, path in ((a, "a"), (b, "b")):
        assert len(got["train"]) == 2                        # epochs 2-3 after the resume
        np.testing.assert_allclose(got["train"], ref["train"][1:], rtol=1e-5)
        np.testing.assert_allclose(got["val"], ref["val"][1:], rtol=0, atol=bound)
        _close_checkpoints(root / f"{path}.msgpack.latest", root / "ref.msgpack.latest",
                           bound)
