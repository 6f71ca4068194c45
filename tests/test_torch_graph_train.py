"""The port's graph trainer (``train-graph``) against the JAX package, on
the CPU.

Two simulated hex arrays (20 genes, 3 classes) with Loupe annotations, a
quarter of array 0's labels blanked. Covered:

- ``visium_to_graphdata`` with annotations, with and without
  ``keep_unannotated`` (y = -1 for the unannotated), padded by
  ``pad_graph`` (JAX's by ``pad_to``), and ``pad_graph``'s refusals: every
  array equal to JAX's;
- ``graph_node_loss`` (padding and unlabeled nodes masked) within 1e-6;
- 25 full-batch Adam steps of ``cli.fit_graph`` from JAX's initial params
  (the bridge) against JAX's step on the same padded graph: every step's
  loss within 1e-5 abs / 1e-4 rel, the final weights within 1e-4;
- ``train-graph`` through both packages' commands from the same initial
  params: the logged losses equal to the printed digits, and the port's
  directory registered by both packages' ``register`` to the same CSV.
"""

import csv
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import graph_data as jgd
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.models import HexGCN as JaxHexGCN
from gridnext_tpu.models import graph_node_loss as jax_loss
from gridnext_tpu_torch import cli
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_checkpoint, load_hexgcn
from gridnext_tpu_torch.data import graph_data as tgd
from gridnext_tpu_torch.models import HexGCN, graph_node_loss
from gridnext_tpu_torch.train import create_train_state, loops, make_adam

HIDDEN, DEPTH, LR = 16, 2, 5e-3


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph_train")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=20 + i, n_genes=20, n_classes=3,
                                     tissue_fraction=0.3) for i in range(2)]
    annots = [str(s["annot_file"]) for s in sims]
    with open(annots[0], newline="") as fh:
        rows = list(csv.reader(fh))
    for i, row in enumerate(rows[1:]):
        if i % 4 == 1:
            row[1] = ""                       # unannotated spots
    annots[0] = str(root / "partial.csv")
    with open(annots[0], "w", newline="") as fh:
        csv.writer(fh).writerows(rows)
    return [str(s["spaceranger_dir"]) for s in sims], annots


def _padded_graph(dirs, annots):
    """The graph as the train-graph command builds it (JAX's)."""
    gd = jgd.visium_to_graphdata(dirs, annot_files=annots, keep_unannotated=True)
    n = gd["nodes"].shape[0]
    return jgd.pad_graph(gd, ((n + 127) // 128) * 128 + 128)


@pytest.mark.parametrize("keep", [False, True])
def test_graphdata_with_annotations_matches_jax(cohort, keep):
    dirs, annots = cohort
    n = sum(jgd.read_visium_graph(d)[0].shape[0] for d in dirs)
    want = jgd.visium_to_graphdata(dirs, annot_files=annots, keep_unannotated=keep,
                                   pad_to=n + 5)
    got = tgd.pad_graph(tgd.visium_to_graphdata(dirs, annot_files=annots,
                                                keep_unannotated=keep), n + 5)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (int((got["y"] == -1).sum()) > 5) == keep or not keep


def test_pad_graph_refusals_match_jax(cohort):
    dirs, annots = cohort
    gd = tgd.visium_to_graphdata(dirs[1], annot_files=annots[1])
    jd = jgd.visium_to_graphdata(dirs[1], annot_files=annots[1])
    n, e = gd["nodes"].shape[0], gd["edges"].shape[1]
    for args in ((n - 1,), (n + 1, e - 1), (n, e + 1)):
        with pytest.raises(ValueError) as port_err:
            tgd.pad_graph(gd, *args)
        with pytest.raises(ValueError) as jax_err:
            jgd.pad_graph(jd, *args)
        assert str(port_err.value) == str(jax_err.value)
    for key, a in jgd.pad_graph(jd, n + 3, e + 7).items():
        np.testing.assert_array_equal(tgd.pad_graph(gd, n + 3, e + 7)[key], a, err_msg=key)


def test_graph_node_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((50, 3)).astype(np.float32)
    y = rng.integers(-1, 3, 50)
    mask = rng.random(50) > 0.2
    want = jax_loss(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))
    got = graph_node_loss(torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    none = graph_node_loss(torch.from_numpy(logits), torch.full((50,), -1))
    assert float(none[0]) == 0.0 and int(none[2]) == 0


def test_fit_graph_trajectory_matches_jax(cohort):
    dirs, annots = cohort
    gd = _padded_graph(dirs, annots)
    nodes, edges = np.log1p(gd["nodes"]), gd["edges"]
    y, mask = gd["y"], gd["node_mask"]
    model = JaxHexGCN(n_classes=len(gd["classes"]), hidden=HIDDEN, depth=DEPTH)
    params = model.init(jax.random.key(0), jnp.asarray(nodes), jnp.asarray(edges))["params"]
    tx = optax.adam(LR)

    @jax.jit
    def step(params, opt):
        def lf(p):
            return jax_loss(model.apply({"params": p}, nodes, edges), y, mask)[0]

        loss, grads = jax.value_and_grad(lf)(params)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    opt, want = tx.init(params), []
    port = load_hexgcn(HexGCN(nodes.shape[1], len(gd["classes"]), HIDDEN, DEPTH),
                       {"params": jax.tree_util.tree_map(np.asarray, params)})
    state = create_train_state(port, make_adam(LR), device="cpu", init=False)
    for _ in range(25):
        params, opt, loss = step(params, opt)
        want.append(float(loss))
    got = cli.fit_graph(state, torch.from_numpy(nodes), torch.from_numpy(edges),
                        torch.from_numpy(y), torch.from_numpy(mask), 25, log=lambda s: None)
    np.testing.assert_allclose([float(v) for v in got], want, atol=1e-5, rtol=1e-4)
    assert want[-1] < want[0]
    back = jax_variables(port)["params"]
    for layer, leaves in jax.tree_util.tree_map(np.asarray, params).items():
        for leaf, a in leaves.items():
            np.testing.assert_allclose(back[layer][leaf], a, atol=1e-4, rtol=1e-3)


def _losses(text):
    return [(int(s), float(v)) for s, v in re.findall(r"step (\d+): loss ([0-9.]+)", text)]


def test_train_graph_commands_match_and_register(cohort, tmp_path, capsys, monkeypatch):
    dirs, annots = cohort
    args = ["train-graph", "--spaceranger", *dirs, "--annots", *annots, "--steps", "51",
            "--hidden", str(HIDDEN), "--depth", str(DEPTH)]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    want = _losses(capsys.readouterr().out)
    gd = _padded_graph(dirs, annots)
    init = JaxHexGCN(n_classes=len(gd["classes"]), hidden=HIDDEN, depth=DEPTH).init(
        jax.random.key(0), jnp.asarray(np.log1p(gd["nodes"])), jnp.asarray(gd["edges"]))
    init = {"params": jax.tree_util.tree_map(np.asarray, init["params"])}
    monkeypatch.setattr(loops, "flax_init_", lambda model, generator: load_hexgcn(model, init))
    cli.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    got = _losses(capsys.readouterr().out)
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 50]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], atol=1.5e-4)
    meta = (tmp_path / "port" / "model.json").read_text()
    assert meta == (tmp_path / "jax" / "model.json").read_text()
    payload = load_checkpoint(tmp_path / "port" / "g_state.msgpack")
    assert payload["step"] == 51 and payload["opt_state"]["0"]["count"] == 51
    for srd in dirs:
        jax_main(["register", "--model", str(tmp_path / "port"), "--spaceranger", srd,
                  "--out", str(tmp_path / "j.csv")])
        cli.main(["register", "--model", str(tmp_path / "port"), "--spaceranger", srd,
                  "--out", str(tmp_path / "p.csv"), "--device", "cpu"])
        text = (tmp_path / "j.csv").read_text()
        assert (tmp_path / "p.csv").read_text() == text and len(text.splitlines()) > 50
