"""The port's flax msgpack reader and writer against flax.

- A ``g_state.msgpack`` written by the JAX package's ``save_checkpoint``
  (optimizer state, a bfloat16 leaf, and arrays chunked by a lowered
  chunk size) reads equal to ``flax.serialization.msgpack_restore``
  (bfloat16 compared after widening to float32);
- the port's writer gives the bytes of ``flax.serialization.msgpack_serialize``
  for the payload ``save_checkpoint`` writes, and those bytes restore in
  flax to the same tree;
- every msgpack type the format allows decodes as ``msgpack`` decodes it;
- ``load_model_dir`` reads a JAX-written model directory with ``msgpack``
  unimportable.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.train import create_train_state, make_gridwise_optimizer
from gridnext_tpu.train import load_checkpoint as jax_load_checkpoint
from gridnext_tpu.train import save_checkpoint as jax_save_checkpoint
from gridnext_tpu_torch.compat import flax_msgpack
from gridnext_tpu_torch.compat.from_jax import (load_checkpoint, load_model_dir,
                                                save_checkpoint, save_model_dir)

REPO = Path(__file__).resolve().parents[1]
GENES, N_CLASSES = 12, 3


def _assert_tree_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def jax_state():
    """A GridNetHex(CountMLP) TrainState (Adam state included), its params
    moved off init, a bfloat16 collection beside them."""
    g = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    state = create_train_state(g, jax.random.key(0), jnp.zeros((1, 4, 4, GENES)),
                               make_gridwise_optimizer(1e-3))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32), state.params)
    extra = {"favor": {"proj": jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16)}}
    return state.replace(params=params, extra_vars=extra, step=jnp.asarray(17, jnp.int32))


def test_jax_checkpoint_reads_like_flax(tmp_path, jax_state, monkeypatch):
    # lower the chunk size so arrays over 256 bytes are stored chunked
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = tmp_path / "g_state.msgpack"
    jax_save_checkpoint(path, jax_state)
    assert b"__msgpack_chunked_array__" in path.read_bytes()
    want = flax.serialization.msgpack_restore(path.read_bytes())
    got = load_checkpoint(path)
    assert set(got) == {"params", "batch_stats", "extra_vars", "step", "opt_state"}
    assert got["extra_vars"]["favor"]["proj"].dtype == np.float32
    _assert_tree_equal(got, want)
    _assert_tree_equal(got, jax_load_checkpoint(path))


@pytest.mark.parametrize("chunk", [None, 256])
def test_port_writer_is_flax_bytes(tmp_path, jax_state, monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jax_state.params, "batch_stats": jax_state.batch_stats,
        "favor": {"proj": jax_state.extra_vars["favor"]["proj"].astype(jnp.float32)}})
    path = tmp_path / "g_state.msgpack"
    save_checkpoint(path, variables, step=3)
    payload = {"params": variables["params"], "batch_stats": variables["batch_stats"],
               "extra_vars": {"favor": variables["favor"]}, "step": 3}
    assert path.read_bytes() == flax.serialization.msgpack_serialize(payload)
    restored = jax_load_checkpoint(path)
    _assert_tree_equal(restored, jax.tree_util.tree_map(lambda x: x, payload))
    _assert_tree_equal(load_checkpoint(path), restored)


def test_every_msgpack_type_decodes_as_msgpack():
    values = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
              -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63, 1.5,
              "", "a" * 31, "b" * 32, "c" * 256, "d" * 65536, "é", b"", b"x" * 300,
              b"y" * 70000, list(range(15)), list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {str(i): i for i in range(17)},
              {"nested": {"deep": [1, {"x": None}]}}]
    data = msgpack.packb(values, use_bin_type=True)
    assert flax_msgpack.unpackb(data) == msgpack.unpackb(data, raw=False)
    single = msgpack.packb([1.25], use_single_float=True)
    assert flax_msgpack.unpackb(single) == [1.25]
    maps = msgpack.packb({i: i for i in range(70000)})         # map 32
    assert flax_msgpack.unpackb(maps) == msgpack.unpackb(maps, strict_map_key=False)
    for n in (1, 2, 3, 4, 8, 16, 17, 300, 70000):                  # fixext and ext 8/16/32
        ext = msgpack.packb(msgpack.ExtType(42, b"z" * n))
        assert flax_msgpack.unpackb(ext) == (42, b"z" * n)
    tree = {"c": complex(1.5, -2), "s": np.float32(2.5), "i": np.int64(-7),
            "b": np.bool_(True), "a": np.arange(6, dtype=np.int16).reshape(2, 3)}
    data = flax.serialization.msgpack_serialize(tree)
    _assert_tree_equal(flax_msgpack.unpackb(data), flax.serialization.msgpack_restore(data))
    assert flax_msgpack.packb(tree) == data
    with pytest.raises(ValueError, match="ends inside"):
        flax_msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError, match="extra data"):
        flax_msgpack.unpackb(data + b"\xc0")


def test_model_dir_loads_without_msgpack(tmp_path, jax_state):
    d = tmp_path / "model"
    d.mkdir()
    jax_save_checkpoint(d / "g_state.msgpack", jax_state)
    meta = {"classes": ["A", "B", "C"], "model": "GridNetHex+CountMLP", "log1p": True}
    (d / "model.json").write_text(json.dumps(meta))
    code = ("import sys\n"
            "sys.modules['msgpack'] = None\n"
            "from gridnext_tpu_torch.compat.from_jax import load_model_dir\n"
            f"meta, classes, v = load_model_dir({str(d)!r})\n"
            "k = v['params']['patch_classifier']['Dense_0']['kernel']\n"
            "print(classes, k.shape, float(k.sum()), sorted(v))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    kernel = np.asarray(jax_state.params["patch_classifier"]["Dense_0"]["kernel"])
    assert res.stdout.split()[:3] == ["['A',", "'B',", "'C']"]
    assert f"({GENES}, 500)" in res.stdout
    assert f"{float(kernel.sum())}" in res.stdout
    assert "['batch_stats', 'favor', 'params']" in res.stdout

    # save_model_dir writes what load_model_dir (and the JAX package) reads back
    _, _, variables = load_model_dir(d)
    out = tmp_path / "copy"
    save_model_dir(out, meta, variables)
    meta2, classes2, variables2 = load_model_dir(out)
    assert meta2 == meta and classes2 == meta["classes"]
    _assert_tree_equal(variables2, variables)
    from gridnext_tpu import modeldir as jax_modeldir

    jmeta, _, jvars = jax_modeldir.load_model_dir(out)
    assert jmeta == meta
    _assert_tree_equal(variables, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else a, jvars))
