"""The port's graph tier (``HexGCN`` registration) against the JAX package,
on the CPU.

Two simulated hex arrays (20 genes) read as graphs, and ``HexGCN`` models
initialised in JAX, moved off init by numpy noise and carried across by
the weight bridge. Covered:

- ``hex_adjacency`` on a random subset of the lattice, and
  ``visium_to_graphdata`` over both arrays (nodes in the positions file's
  in-tissue order, node-offset edges, positions, per-array counts): equal
  to JAX's; ``feature_axis_signature`` equal, and JAX's refusal of arrays
  whose feature axes differ;
- the weight bridge: the port names exactly the leaves flax's creation
  order gives (``Dense_0``, ``Dense_1``, ``LayerNorm_0``, ..., the head
  last), uses every one, and its logits lie within 1e-5 of
  ``model.apply``'s, at the JAX defaults (hidden 128, depth 3) and at
  hidden 16, depth 1;
- ``python -m gridnext_tpu_torch register --device cpu`` on a directory
  written as ``train-graph`` writes it: the CSVs byte-identical to the JAX
  command's; a feature axis that differs from the model's exits with
  JAX's message.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.data import graph_data as jax_graph_data
from gridnext_tpu.models import HexGCN as JaxHexGCN
from gridnext_tpu.train import TrainState, save_checkpoint
from gridnext_tpu_torch import modeldir
from gridnext_tpu_torch.cli import main
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_hexgcn, load_model_dir
from gridnext_tpu_torch.data import graph_data
from gridnext_tpu_torch.models import HexGCN

REPO = Path(__file__).resolve().parents[1]
N_CLASSES, GENES = 4, 20


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_graph")
    dirs = [str(Path(simulate_spaceranger_dir(root / f"g{i}", seed=10 + i, n_genes=GENES,
                                              n_classes=N_CLASSES,
                                              tissue_fraction=frac)["spaceranger_dir"])
                 / "outs")
            for i, frac in enumerate((0.6, 0.45))]
    return root, dirs


def _moved(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def test_hex_adjacency_matches_jax():
    rng = np.random.default_rng(0)
    row = rng.integers(0, 78, 600)
    col = 2 * rng.integers(0, 64, 600) + row % 2
    coords = np.unique(np.stack([col, row], 1), axis=0)[rng.permutation(500)[:400]]
    got = graph_data.hex_adjacency(coords)
    np.testing.assert_array_equal(got, jax_graph_data.hex_adjacency(coords))
    assert got.dtype == np.int64 and got.shape[1] > 0


def test_visium_to_graphdata_matches_jax(cohort):
    _, dirs = cohort
    want = jax_graph_data.visium_to_graphdata(dirs)
    got = graph_data.visium_to_graphdata(dirs)
    for key in ("nodes", "edges", "pos", "n_node", "n_edge"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    assert got["n_node"].tolist() == [(graph_data.read_visium_graph(d)[0].shape[0])
                                      for d in dirs]
    for srd in dirs:
        assert graph_data.feature_axis_signature(srd) == \
            jax_graph_data.feature_axis_signature(srd)


def test_visium_to_graphdata_refuses_mixed_feature_axes(cohort, tmp_path):
    root, dirs = cohort
    other = str(Path(simulate_spaceranger_dir(tmp_path / "h", seed=3, n_genes=GENES + 1,
                                              n_classes=N_CLASSES)["spaceranger_dir"])
                / "outs")
    msgs = []
    for fn in (jax_graph_data.visium_to_graphdata, graph_data.visium_to_graphdata):
        with pytest.raises(ValueError, match="feature axes differ") as e:
            fn([dirs[0], other])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("hidden,depth", [(128, 3), (16, 1)])
def test_hexgcn_bridge_and_forward_match_jax(cohort, hidden, depth):
    _, dirs = cohort
    gd = jax_graph_data.visium_to_graphdata(dirs)
    x = np.log1p(gd["nodes"])
    model = JaxHexGCN(n_classes=N_CLASSES, hidden=hidden, depth=depth)
    params = _moved(model.init(jax.random.key(0), jnp.asarray(x),
                               jnp.asarray(gd["edges"]))["params"])
    port = HexGCN(GENES, N_CLASSES, hidden=hidden, depth=depth)
    names = {jax.tree_util.keystr(p): np.shape(a)
             for p, a in jax.tree_util.tree_leaves_with_path({"params": params})}
    port_names = {jax.tree_util.keystr(p): np.shape(a)
                  for p, a in jax.tree_util.tree_leaves_with_path(jax_variables(port))}
    assert port_names == names
    assert "['params']['Dense_1']['bias']" not in names        # the neighbour Dense
    load_hexgcn(port, {"params": params}).eval()
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                  jnp.asarray(gd["edges"])))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(gd["edges"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    extra = {"params": {**params, "Dense_99": {"bias": np.zeros(2, np.float32)}}}
    with pytest.raises(ValueError, match="does not have"):
        load_hexgcn(HexGCN(GENES, N_CLASSES, hidden=hidden, depth=depth), extra)


@pytest.fixture(scope="module")
def graph_dir(cohort):
    """A model directory as ``train-graph`` writes it (Adam state included)."""
    root, dirs = cohort
    gd = jax_graph_data.visium_to_graphdata(dirs)
    model = JaxHexGCN(n_classes=N_CLASSES, hidden=32, depth=2)
    params = _moved(model.init(jax.random.key(1), jnp.asarray(np.log1p(gd["nodes"])),
                               jnp.asarray(gd["edges"]))["params"], seed=2)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(params=params, batch_stats=None, opt_state=optax.adam(1e-3).init(params),
                       step=jnp.asarray(5, jnp.int32), extra_vars={})
    d = root / "model_graph"
    d.mkdir()
    save_checkpoint(str(d / "g_state.msgpack"), state)
    (d / "model.json").write_text(json.dumps({
        "classes": [f"Layer{i + 1}" for i in range(N_CLASSES)], "model": "HexGCN",
        "hidden": 32, "depth": 2, "log1p": True, "n_genes": GENES,
        "feature_axis": jax_graph_data.feature_axis_signature(dirs[0])}))
    return str(d)


def test_graph_model_from_meta(graph_dir):
    meta, classes, variables = load_model_dir(graph_dir)
    model = modeldir.graph_model_from_meta(meta, classes, variables, device="cpu")
    assert not model.training and len(model.norms) == 2
    assert model.self_dense[0].in_features == GENES and model.out.out_features == N_CLASSES


def test_register_graph_dir_matches_jax_bytes(cohort, graph_dir, tmp_path):
    _, dirs = cohort
    args = ["register", "--model", graph_dir, "--spaceranger", *dirs]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "gridnext_tpu_torch", *args,
                          "--out", str(tmp_path / "port"), "--device", "cpu"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["00_outs_loupe.csv", "01_outs_loupe.csv"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _exit_code(fn, args):
    with pytest.raises(SystemExit) as e:
        fn(args)
    return e.value.code


def test_register_graph_feature_axis_exit_matches_jax(cohort, graph_dir, tmp_path):
    _, dirs = cohort
    d = tmp_path / "model"
    shutil.copytree(graph_dir, d)
    meta = json.loads((d / "model.json").read_text())
    meta["feature_axis"] = {"n_genes": GENES + 1, "sha256": "0" * 16}
    (d / "model.json").write_text(json.dumps(meta))
    args = ["register", "--model", str(d), "--spaceranger", dirs[0], "--out",
            str(tmp_path / "x.csv")]
    want = _exit_code(jax_main, args)
    assert isinstance(want, str) and "does not match the model's training axis" in want
    assert _exit_code(main, args + ["--device", "cpu"]) == want
    assert not (tmp_path / "x.csv").exists()
    with pytest.raises(ValueError, match="training axis"):
        modeldir.validate_graph_feature_axis(meta, dirs[0])
