"""The port's orbax checkpoints (``train/orbax_io.py``, ``io/ocdbt.py``)
against the JAX package's, which run orbax and tensorstore here.

- JAX's ``save_checkpoint_orbax`` writes, the port's
  ``restore_checkpoint_orbax`` reads: every leaf bitwise equal to the port's
  msgpack route of the same JAX state, and so is one further port step.
  States: CountMLP + GridNetHex gridwise (``f_lr`` None and set,
  ``accum_iters`` 2), a spotwise Adam, a depth-1 scBERT with ``favor``
  extra vars and the masked fine-tune Adam, and ``batch_stats=None``.
  The Adam moments and counts are drawn from a numpy seed.
- The port writes, JAX's ``restore_checkpoint_orbax`` reads: leaves
  bitwise equal.
- A tree of 3,000 arrays with one above OCDBT's inline limit, each way:
  tensorstore's and the port's B+trees with interior nodes and values out
  of line; a leaf sharded over the 8-device CPU mesh (a chunk a shard).
- ``block=False``: the files hold the state at the call; the old
  checkpoint restores until ``wait_until_finished()``.
- Each refusal raises a ``ValueError`` naming its file.
- With ``orbax`` and ``tensorstore`` blocked the port's round trip works,
  and it reads orbax's ``use_ocdbt=False`` layout.
- The committed JAX checkpoint ``tests/data/orbax/``
  (``tools/make_orbax_fixture.py``) restores, and the port's CPU registrar
  gives the labels JAX recorded for its slide.
"""

import json
import os
import struct
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import from_state_dict, to_state_dict

from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.models.scbert import finetune_param_labels as jax_labels
from gridnext_tpu.train import loops as jl
from gridnext_tpu.train import orbax_io as jo
from gridnext_tpu_torch.io import ocdbt
from gridnext_tpu_torch.models import CountMLP, GridNetHex, scBERT
from gridnext_tpu_torch.models.scbert import finetune_param_labels
from gridnext_tpu_torch.train import loops as tl
from gridnext_tpu_torch.train import orbax_io as to

C, G, LR = 3, 10, 1e-3
SC = dict(n_genes=15, dim=16, depth=1, heads=2, dim_head=8, nb_features=8, n_classes=C,
          generalized_attention=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _drawn_opt_state(opt_state, seed):
    """optax's state with every moment drawn from a seed and every count 3,
    so a restore that drops or swaps a leaf shows."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind == "i":
            return np.full(a.shape, 3, a.dtype)
        return np.abs(rng.normal(size=a.shape)).astype(a.dtype)
    return from_state_dict(opt_state, jax.tree.map(draw, to_state_dict(opt_state)))


def _case(name):
    """(JAX state, fresh port state factory, one batch (x, y), loss kind)."""
    rng = np.random.default_rng(4)
    if name.startswith("grid"):
        f_lr = None if name == "grid_g_only" else 5e-4
        accum = 2 if name == "grid_accum2" else 1
        jm = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=C, hidden=(12, 8, 8, 6)),
                           n_classes=C)
        x = rng.normal(1.0, 2.0, size=(2, 6, 5, G)).astype(np.float32)
        y = rng.integers(0, C + 1, size=(2, 6, 5)).astype(np.int64)
        jtx = jl.make_gridwise_optimizer(LR, f_lr=f_lr, accum_iters=accum)

        def port():
            return GridNetHex(CountMLP(G, C, hidden=(12, 8, 8, 6)), n_classes=C, f_dim=C), \
                tl.make_gridwise_optimizer(LR, f_lr=f_lr, accum_iters=accum)
        kind = "grid"
    elif name in ("spot_adam", "no_batch_stats"):
        bn = name == "spot_adam"
        jm = JaxCountMLP(n_classes=C, hidden=(12, 8, 8, 6), batch_norm=bn)
        x = rng.normal(size=(6, G)).astype(np.float32)
        y = rng.integers(0, C, size=6).astype(np.int64)
        jtx = optax.adam(LR)

        def port():
            return CountMLP(G, C, hidden=(12, 8, 8, 6), batch_norm=bn), tl.make_adam(LR)
        kind = "spot"
    else:
        jm = JaxScBERT(**SC)
        x = rng.integers(0, 6, size=(4, 15)).astype(np.float32)
        y = rng.integers(0, C, size=4).astype(np.int64)
        jtx = optax.multi_transform({"train": optax.adam(LR), "frozen": optax.set_to_zero()},
                                    lambda p: jax_labels(p, SC["depth"]))

        def port():
            return scBERT(**SC), tl.make_masked_adam(
                LR, lambda p: finetune_param_labels(p, SC["depth"]))
        kind = "spot"
    jstate = jl.create_train_state(jm, jax.random.key(3), jnp.asarray(x[:1]), jtx)
    jstate = jstate.replace(opt_state=_drawn_opt_state(jstate.opt_state, 5),
                            step=jnp.asarray(7, jnp.int32))

    def fresh():
        model, tx = port()
        return tl.create_train_state(model, tx, device="cpu")
    return jstate, fresh, (torch.from_numpy(x), torch.from_numpy(y)), kind


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_bitwise(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def _payload(state):
    return tl._host_tree(tl._payload_tree(state))


@pytest.mark.parametrize("name", ["grid_g_only", "grid_f_lr", "grid_accum2", "spot_adam",
                                  "scbert_masked", "no_batch_stats"])
def test_checkpoints_cross_packages_bitwise(name, tmp_path):
    jstate, fresh, (x, y), kind = _case(name)
    jo.save_checkpoint_orbax(tmp_path / "jax_ckpt", jstate)
    jl.save_checkpoint(tmp_path / "jax.msgpack", jstate)

    via_orbax = to.restore_checkpoint_orbax(tmp_path / "jax_ckpt", fresh())
    via_msgpack = tl.restore_train_state(tmp_path / "jax.msgpack", fresh())
    assert via_orbax.step == via_msgpack.step == 7
    if name == "no_batch_stats":
        assert to.read_checkpoint_orbax(tmp_path / "jax_ckpt")["batch_stats"] is None
    _assert_bitwise(_payload(via_orbax), _payload(via_msgpack))

    for state in (via_orbax, via_msgpack):            # one further port step
        train_step, _ = tl.make_steps(state, kind)
        train_step(x, y)
    _assert_bitwise(_payload(via_orbax), _payload(via_msgpack))

    # the port writes, JAX's restore reads
    to.save_checkpoint_orbax(tmp_path / "port_ckpt", via_orbax)
    back = jo.restore_checkpoint_orbax(tmp_path / "port_ckpt", jstate)
    want = _payload(via_orbax)
    assert int(back.step) == want["step"] == 8
    got = {"params": _np(back.params), "batch_stats": _np(back.batch_stats),
           "extra_vars": _np(back.extra_vars), "step": want["step"],
           "opt_state": _np(to_state_dict(back.opt_state))}
    _assert_bitwise(got, want)


def _many_arrays(n, seed):
    rng = np.random.default_rng(seed)
    params = {f"layer_{i:04d}": {"w": rng.normal(size=(i % 5 + 1,)).astype(np.float32)}
              for i in range(n)}
    params["big"] = {"w": rng.normal(size=(40, 50)).astype(np.float32)}   # 8,000 bytes
    return params


def test_large_tree_interior_nodes_and_out_of_line_values(tmp_path):
    """3,000 arrays each way: JAX's checkpoint (one leaf of 6,004 keys, the
    big chunk over the 1,024-byte inline limit stored out of line) read by
    the port; the port's checkpoint (a B+tree with interior nodes) read by
    orbax; and the same keys in a B+tree of tensorstore's own with interior
    nodes three deep (4 KB nodes), read by the port."""
    import orbax.checkpoint as ocp
    import tensorstore as ts

    params = _many_arrays(3000, 0)
    jstate = types.SimpleNamespace(params=params, batch_stats=None, extra_vars={},
                                   opt_state={}, step=np.asarray(2, np.int32))
    jo.save_checkpoint_orbax(tmp_path / "jax_ckpt", jstate)
    assert ocdbt.read_manifest(tmp_path / "jax_ckpt")["num_keys"] == 2 * 3001 + 2
    got = to.read_checkpoint_orbax(tmp_path / "jax_ckpt")
    _assert_bitwise(got["params"], params)
    assert got["step"] == 2 and got["batch_stats"] is None

    payload = {"params": params, "batch_stats": None, "extra_vars": {}, "opt_state": {},
               "step": np.asarray(2, np.int32)}
    to._write_dir(str(tmp_path / "port_ckpt"), payload, 0)
    assert ocdbt.read_manifest(tmp_path / "port_ckpt")["height"] >= 1
    with ocp.StandardCheckpointer() as ckptr:
        back = ckptr.restore(str(tmp_path / "port_ckpt"))
    _assert_bitwise(_np(back["params"]), params)
    assert int(back["step"]) == 2

    items = {}
    for layer, leaf in params.items():
        items.update(ocdbt.zarr_items(f"params.{layer}.w", leaf["w"]))
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path / 'ts'}/",
                             "config": {"max_decoded_node_bytes": 4096,
                                        "max_inline_value_bytes": 1024}}).result()
    txn = ts.Transaction()
    for key, value in items.items():
        store.with_transaction(txn).write(key, value).result()
    txn.commit_async().result()
    assert ocdbt.read_manifest(tmp_path / "ts")["height"] >= 2
    read = ocdbt.read_store(tmp_path / "ts")
    assert set(read) == set(items) and all(bytes(read[k]) == v for k, v in items.items())
    np.testing.assert_array_equal(ocdbt.read_zarr(read.get, "params.big.w", "ts"),
                                  params["big"]["w"])



def test_sharded_jax_array_reads_every_chunk(tmp_path):
    """A leaf sharded over the 8-device CPU mesh is written one zarr chunk a
    shard: the port reads the chunk grid back into one array."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from gridnext_tpu.parallel import make_mesh

    mesh = make_mesh({"data": len(jax.devices())})
    w = np.random.default_rng(3).normal(size=(8 * 3, 5)).astype(np.float32)
    params = {"w": jax.device_put(w, NamedSharding(mesh, P("data", None)))}
    jstate = types.SimpleNamespace(params=params, batch_stats=None, extra_vars={},
                                   opt_state={}, step=np.asarray(4, np.int32))
    jo.save_checkpoint_orbax(tmp_path / "ckpt", jstate)
    store = ocdbt.read_store(tmp_path / "ckpt")
    assert json.loads(bytes(store["params.w/.zarray"]))["chunks"] == [3, 5]
    assert sum(k.startswith("params.w/") for k in store) == 1 + len(jax.devices())
    got = to.read_checkpoint_orbax(tmp_path / "ckpt")
    np.testing.assert_array_equal(got["params"]["w"], w)
    assert got["step"] == 4

def test_async_save_holds_the_state_at_the_call(tmp_path):
    jstate, fresh, (x, y), kind = _case("grid_f_lr")
    jl.save_checkpoint(tmp_path / "jax.msgpack", jstate)
    state = tl.restore_train_state(tmp_path / "jax.msgpack", fresh())
    path = tmp_path / "ckpt"
    to.save_checkpoint_orbax(path, state)                   # the old checkpoint
    old = _payload(state)
    train_step, _ = tl.make_steps(state, kind)
    train_step(x, y)
    at_call = _payload(state)
    handle = to.save_checkpoint_orbax(path, state, block=False)
    train_step(x, y)                                        # the state moves on
    later = _payload(state)
    _assert_bitwise(to.read_checkpoint_orbax(path), old)    # not swapped yet
    handle.wait_until_finished()
    handle.close()
    assert not any(p.name.startswith("ckpt.") for p in tmp_path.iterdir())
    _assert_bitwise(to.read_checkpoint_orbax(path), at_call)
    restored = to.restore_checkpoint_orbax(path, fresh())
    _assert_bitwise(_payload(restored), at_call)
    assert later["step"] == at_call["step"] + 1


def _rewrite_manifest(path, edit):
    """Decode a manifest written uncompressed, ``edit`` its body, re-seal it."""
    with open(path, "rb") as fh:
        data = fh.read()
    body = edit(bytearray(data[12:-4]))
    head = data[:4] + struct.pack("<Q", 12 + len(body) + 4)
    sealed = head + bytes(body)
    with open(path, "wb") as fh:
        fh.write(sealed + struct.pack("<I", ocdbt.crc32c(sealed)))


def _edit_zarray(tmp, field, value):
    store = {k: bytes(v) for k, v in ocdbt.read_store(tmp).items()}
    for key in store:
        if key.endswith("/.zarray"):
            meta = json.loads(store[key])
            meta[field] = value
            store[key] = json.dumps(meta).encode()
    for p in ("manifest.ocdbt",):
        os.remove(os.path.join(tmp, p))
    ocdbt.write_store(tmp, store)


def _refuse_metadata(tmp, edit):
    path = os.path.join(tmp, "_METADATA")
    with open(path) as fh:
        meta = json.load(fh)
    edit(meta)
    with open(path, "w") as fh:
        json.dump(meta, fh)


def _first_value_type(meta):
    entry = next(iter(meta["tree_metadata"].values()))
    entry["value_metadata"]["value_type"] = "string"


REFUSALS = {
    "zarr3": (lambda t: _refuse_metadata(t, lambda m: m.update(use_zarr3=True)),
              "_METADATA", "use_zarr3"),
    "value_type": (lambda t: _refuse_metadata(t, _first_value_type), "_METADATA",
                   "value_type 'string'"),
    "compressor": (lambda t: _edit_zarray(t, "compressor", {"id": "blosc"}), ".zarray",
                   "compressor 'blosc'"),
    "filters": (lambda t: _edit_zarray(t, "filters", [{"id": "delta"}]), ".zarray",
                "filters"),
    "order": (lambda t: _edit_zarray(t, "order", "F"), ".zarray", "order 'F'"),
    "checksum": (lambda t: _flip_last_node_byte(t), "d/", "bad checksum"),
    "version": (lambda t: _rewrite_manifest(os.path.join(t, "manifest.ocdbt"),
                                            lambda b: bytearray([1]) + b[1:]),
                "manifest.ocdbt", "format version 1"),
    "numbered": (lambda t: _rewrite_manifest(os.path.join(t, "manifest.ocdbt"),
                                             lambda b: b[:18] + bytearray([1]) + b[19:]),
                 "manifest.ocdbt", "numbered manifests"),
    "missing": (lambda t: os.remove(os.path.join(t, "_METADATA")), "_METADATA", "missing"),
}


def _flip_last_node_byte(tmp):
    d = os.path.join(tmp, "d")
    path = os.path.join(d, os.listdir(d)[0])
    with open(path, "r+b") as fh:
        fh.seek(-6, os.SEEK_END)
        b = fh.read(1)
        fh.seek(-6, os.SEEK_END)
        fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_name_their_file(name, tmp_path):
    _, fresh, _, _ = _case("spot_adam")
    state = fresh()
    path = tmp_path / "ckpt"
    to.save_checkpoint_orbax(path, state)
    edit, where, what = REFUSALS[name]
    edit(str(path))
    with pytest.raises(ValueError) as err:
        to.restore_checkpoint_orbax(path, fresh())
    msg = str(err.value)
    assert str(path) in msg and where in msg and what in msg, msg


def test_round_trip_without_orbax_or_tensorstore(tmp_path, monkeypatch):
    for mod in ("orbax", "orbax.checkpoint", "tensorstore"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError):
        import tensorstore  # noqa: F401
    _, fresh, (x, y), kind = _case("grid_accum2")
    state = fresh()
    train_step, _ = tl.make_steps(state, kind)
    train_step(x, y)
    to.save_checkpoint_orbax(tmp_path / "ckpt", state)
    restored = to.restore_checkpoint_orbax(tmp_path / "ckpt", fresh())
    _assert_bitwise(_payload(restored), _payload(state))


def test_reads_orbax_without_ocdbt(tmp_path):
    """orbax's per-array zarr directories (``use_ocdbt=False``)."""
    import orbax.checkpoint as ocp

    jstate, fresh, _, _ = _case("spot_adam")
    payload = {"params": jstate.params, "batch_stats": jstate.batch_stats,
               "extra_vars": jstate.extra_vars, "opt_state": jstate.opt_state,
               "step": np.asarray(jstate.step)}
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    ckptr.save(str(tmp_path / "ckpt"), payload)
    assert not os.path.exists(tmp_path / "ckpt" / "manifest.ocdbt")
    jl.save_checkpoint(tmp_path / "jax.msgpack", jstate)
    via_dirs = to.restore_checkpoint_orbax(tmp_path / "ckpt", fresh())
    via_msgpack = tl.restore_train_state(tmp_path / "jax.msgpack", fresh())
    _assert_bitwise(_payload(via_dirs), _payload(via_msgpack))


def test_ocdbt_codec_pieces():
    """CRC-32C's check value, a raw-block ZSTD frame over several blocks,
    and the empty store."""
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(0).bytes(300_000)
    frame = ocdbt.zstd_raw_frame(data)
    assert ocdbt.zstd_decompress(frame, "mem", size=len(data)) == data
    assert ocdbt.zstd_decompress(frame, "mem") == data
    assert ocdbt.zstd_decompress(ocdbt.zstd_raw_frame(b""), "mem") == b""


def _fixture_tool():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "make_orbax_fixture.py")
    spec = importlib.util.spec_from_file_location("make_orbax_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_jax_fixture_restores_and_registers(tmp_path):
    from gridnext_tpu_torch.io import read_positions
    from gridnext_tpu_torch.models import TpuPatchClassifier, tpu_f_arch_kwargs
    from gridnext_tpu_torch.serving import SlideRegistrar

    fx = _fixture_tool()
    fixture = fx.load()
    n, arch = len(fixture["classes"]), tpu_f_arch_kwargs(fixture["tpu_f"])
    model = GridNetHex(TpuPatchClassifier(n_classes=n, **arch), n_classes=n, f_dim=n)
    state = tl.create_train_state(model, tl.make_gridwise_optimizer(
        fixture["lr"], f_lr=fixture["f_lr"]), device="cpu", init=False)
    state = to.restore_checkpoint_orbax(fixture["checkpoint"], state)
    assert state.step == fixture["step"]

    reg = SlideRegistrar.from_gridnet(state.model, patch_size=fixture["patch_px"],
                                      normalize=None, device="cpu")
    labels = reg(torch.from_numpy(fx.slide()),
                 read_positions(fx.write_spaceranger_dir(tmp_path)))
    np.testing.assert_array_equal(labels, fixture["labels"])
