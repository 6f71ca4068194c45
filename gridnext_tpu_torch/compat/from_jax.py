"""Weight bridge from the JAX package's model directories to the port.

* :func:`load_checkpoint` reads a ``g_state.msgpack`` that flax's
  ``msgpack_serialize`` wrote, without flax: msgpack ext type 1 is an
  ndarray packed as ``(shape, dtype name, C-order bytes)``, type 3 a numpy
  scalar the same way, type 2 a complex; arrays over 1 GiB come as
  ``__msgpack_chunked_array__`` dicts. ``msgpack`` is imported inside the
  function: the serving path never needs it.
* :func:`load_model_dir` returns ``(meta, classes, variables)`` like the JAX
  package's ``modeldir.load_model_dir``.
* :func:`load_gridnet_hex` copies a variables tree (nested dicts of numpy
  arrays) into a :class:`~gridnext_tpu_torch.models.GridNetHex`:

  - flax ``Conv`` kernels are HWIO, torch's OIHW;
  - ``Dense`` kernels ``(in, out)`` become ``Linear.weight`` ``(out, in)``;
  - ``RMSNorm``/``LayerNorm`` ``scale`` (and ``bias``) map directly;
  - ``HexConv`` kernels stay ``(7, C_in, C_out)`` in ``HEX_TAPS_R1`` order;
  - BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` go
    into the ``BatchNorm1d`` weight, bias and running buffers.

  flax names the unnamed convs and norms of ``TpuPatchClassifier`` by
  creation order (``Conv_0``, ``RMSNorm_0``, ...; the downsample convs take
  ``Conv_i`` slots too), so the bridge walks f in that same order
  (:meth:`TpuPatchClassifier.jax_order`).
* :func:`load_densenet` does the same for a flax ``DenseNet`` (``params``
  and ``batch_stats``): ``conv0``; the stem's ``BatchNorm_0``;
  ``_DenseLayer_{k}`` numbered across all blocks, each with ``BatchNorm_0``,
  ``Conv_0`` (1x1), ``BatchNorm_1``, ``Conv_1`` (3x3); ``_Transition_{k}``
  with ``BatchNorm_0``, ``Conv_0``; the final norm ``BatchNorm_1``
  (``BatchNorm_0`` with ``small_inputs``, which has no stem norm); and
  ``classifier`` unless ``classify=False``. The convs have no bias. These
  are the names ``compat/torch_convert.densenet_from_torch`` of the JAX
  package gives the reference's torch checkpoints.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gridnext_tpu_torch.models.densenet import DenseNet
from gridnext_tpu_torch.models.tpu_f import ChannelNorm, TpuPatchClassifier

_NORM_NAMES = {"rms": "RMSNorm", "layer": "LayerNorm"}


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # bfloat16 is the high half of a float32: widen without ml_dtypes
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1).reshape(shape, order="C")


def _ext_hook(code, data):
    import msgpack

    if code == 1:   # ndarray
        return _ndarray_from_bytes(data)
    if code == 2:   # native complex
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == 3:   # numpy scalar
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def load_checkpoint(path):
    """Read a checkpoint payload dict (params/batch_stats/extra_vars/step,
    optionally opt_state) from a flax msgpack file."""
    import msgpack

    with open(path, "rb") as fh:
        payload = msgpack.unpackb(fh.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(payload)


def load_model_dir(model_dir):
    """(meta, classes, variables) from a trained model directory
    (``model.json`` + ``g_state.msgpack``)."""
    with open(os.path.join(model_dir, "model.json")) as fh:
        meta = json.load(fh)
    payload = load_checkpoint(os.path.join(model_dir, "g_state.msgpack"))
    variables = {"params": payload["params"]}
    if payload.get("batch_stats") is not None:
        variables["batch_stats"] = payload["batch_stats"]
    variables.update(payload.get("extra_vars") or {})
    return meta, meta["classes"], variables


# -- module <-> tree mapping ---------------------------------------------------
# Each entry: (path in the JAX tree, torch tensor, layout) with layout one of
# 'conv' (HWIO <-> OIHW), 'dense' ((in, out) <-> (out, in)) or 'same'.


def _tpu_f_entries(f: TpuPatchClassifier, prefix=("params",)):
    counts = {"Conv": 0, "RMSNorm": 0, "LayerNorm": 0}
    for mod in f.jax_order():
        if isinstance(mod, ChannelNorm):
            if mod.kind == "none":
                continue
            kind = _NORM_NAMES[mod.kind]
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            yield prefix + (name, "scale"), mod.scale, "same"
            if mod.kind == "layer":
                yield prefix + (name, "bias"), mod.bias, "same"
            continue
        if mod is f.stem:
            name = "stem"
        else:
            name = f"Conv_{counts['Conv']}"
            counts["Conv"] += 1
        yield prefix + (name, "kernel"), mod.weight, "conv"
        yield prefix + (name, "bias"), mod.bias, "same"
    yield prefix + ("head", "kernel"), f.head.weight, "dense"
    yield prefix + ("head", "bias"), f.head.bias, "same"


def _batchnorm_entries(bn, params, stats, name):
    yield params + (name, "scale"), bn.weight, "same"
    yield params + (name, "bias"), bn.bias, "same"
    yield stats + (name, "mean"), bn.running_mean, "same"
    yield stats + (name, "var"), bn.running_var, "same"


def _densenet_entries(f: DenseNet, params=("params",), stats=("batch_stats",)):
    yield params + ("conv0", "kernel"), f.conv0.weight, "conv"
    if f.norm0 is not None:
        yield from _batchnorm_entries(f.norm0, params, stats, "BatchNorm_0")
    k = 0
    for block in f.blocks:
        for layer in block:
            p, s = params + (f"_DenseLayer_{k}",), stats + (f"_DenseLayer_{k}",)
            yield from _batchnorm_entries(layer.norm1, p, s, "BatchNorm_0")
            yield p + ("Conv_0", "kernel"), layer.conv1.weight, "conv"
            yield from _batchnorm_entries(layer.norm2, p, s, "BatchNorm_1")
            yield p + ("Conv_1", "kernel"), layer.conv2.weight, "conv"
            k += 1
    for k, trans in enumerate(f.transitions):
        p, s = params + (f"_Transition_{k}",), stats + (f"_Transition_{k}",)
        yield from _batchnorm_entries(trans.norm, p, s, "BatchNorm_0")
        yield p + ("Conv_0", "kernel"), trans.conv.weight, "conv"
    final = "BatchNorm_0" if f.norm0 is None else "BatchNorm_1"
    yield from _batchnorm_entries(f.norm_final, params, stats, final)
    if f.classifier is not None:
        yield params + ("classifier", "kernel"), f.classifier.weight, "dense"
        yield params + ("classifier", "bias"), f.classifier.bias, "same"


def _f_entries(f, params, stats):
    if isinstance(f, TpuPatchClassifier):
        return _tpu_f_entries(f, params)
    if isinstance(f, DenseNet):
        return _densenet_entries(f, params, stats)
    raise NotImplementedError(f"the weight bridge maps TpuPatchClassifier and "
                              f"DenseNet, not {type(f).__name__}")


def _gridnet_hex_entries(model):
    yield from _f_entries(model.patch_classifier, ("params", "patch_classifier"),
                          ("batch_stats", "patch_classifier"))
    for collection, layer, leaf, tensor in model.corrector.jax_entries():
        yield (collection, "corrector", layer, leaf), tensor, "same"


def _to_jax_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if layout == "conv":
        return a.transpose(2, 3, 1, 0)   # OIHW -> HWIO
    if layout == "dense":
        return a.T
    return a


def _from_jax_layout(a: np.ndarray, layout: str) -> np.ndarray:
    a = np.asarray(a)
    if layout == "conv":
        return a.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if layout == "dense":
        return a.T
    return a


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def _load(entries, variables, roots):
    """Copy every entry's array out of ``variables``; every leaf under the
    ``roots`` subtrees must be consumed."""
    used = set()
    with torch.no_grad():
        for path, tensor, layout in entries:
            node = variables
            for key in path:
                if not isinstance(node, dict) or key not in node:
                    raise ValueError(f"variables tree has no {'/'.join(path)}")
                node = node[key]
            value = _from_jax_layout(node, layout)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(path)}: shape {value.shape} does not "
                                 f"fit {tuple(tensor.shape)} after layout "
                                 f"{layout!r}")
            tensor.copy_(torch.tensor(value, dtype=tensor.dtype))
            used.add(path)
    for root in roots:
        node = variables
        for key in root:
            node = node.get(key, {}) if isinstance(node, dict) else {}
        extra = [p for p in _leaf_paths(node, root) if p not in used]
        if extra:
            raise ValueError(f"variables the model does not have: "
                             f"{['/'.join(p) for p in extra[:5]]}")


def load_tpu_f(f: TpuPatchClassifier, params: dict) -> TpuPatchClassifier:
    """Copy a flax ``TpuPatchClassifier`` params tree into ``f`` (in place)."""
    _load(_tpu_f_entries(f), {"params": params}, [("params",)])
    return f


def load_densenet(f: DenseNet, variables: dict) -> DenseNet:
    """Copy a flax ``DenseNet`` variables tree (``params`` and
    ``batch_stats``) into ``f`` (in place)."""
    _load(_densenet_entries(f), variables, [("params",), ("batch_stats",)])
    return f


def load_gridnet_hex(model, variables: dict):
    """Copy a JAX ``GridNetHex`` variables tree, with a
    ``TpuPatchClassifier`` or ``DenseNet`` f (``params`` and, with
    BatchNorm, ``batch_stats``), into ``model`` (in place) and return it."""
    roots = [("params", "patch_classifier"), ("params", "corrector"),
             ("batch_stats", "patch_classifier"), ("batch_stats", "corrector")]
    _load(_gridnet_hex_entries(model), variables, roots)
    return model


def jax_variables(model) -> dict:
    """The variables tree in the JAX package's layout that
    :func:`load_gridnet_hex` reads back into ``model`` (nested dicts of
    numpy arrays). Its shapes are those a JAX checkpoint must have."""
    tree: dict = {}
    for path, tensor, layout in _gridnet_hex_entries(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_jax_layout(tensor, layout)
    return tree
