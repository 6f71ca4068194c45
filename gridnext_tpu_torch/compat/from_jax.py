"""Weight bridge from the JAX package's model directories to the port.

* :func:`load_checkpoint` reads a ``g_state.msgpack`` that flax's
  ``msgpack_serialize`` wrote, and :func:`save_checkpoint` writes one as
  the JAX package's ``save_checkpoint`` does (``params``, ``batch_stats``,
  ``extra_vars``, ``step``), both without flax or ``msgpack``
  (:mod:`~gridnext_tpu_torch.compat.flax_msgpack`).
* :func:`load_model_dir` returns ``(meta, classes, variables)`` like the JAX
  package's ``modeldir.load_model_dir``; :func:`save_model_dir` writes
  ``model.json`` and ``g_state.msgpack``.
* :func:`load_gridnet` copies a variables tree (nested dicts of numpy
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
* :func:`load_performer` does the same for scBERT and its parts
  (``FastAttention``, ``SelfAttention``, ``Performer``, ``PerformerLM``,
  ``AttentionClassifier``): ``params`` hold ``performer_lm/token_emb``
  (``embedding``), ``performer_lm/performer/layers_{i}_attn`` (``to_q``,
  ``to_k``, ``to_v``, ``to_out`` Dense layers), ``layers_{i}_ff`` (``w1``,
  ``w2``), the pre-norms ``wrap_{i}_attn_norm`` / ``wrap_{i}_ff_norm``,
  ``performer_lm/norm``, and the classifier at scBERT's root ``to_out``
  (``conv1``, ``fc1``-``fc3``); the ``favor`` collection holds each
  layer's ``fast_attention/projection``, which fills the module's
  ``projection`` buffer (a layer of local heads only has none). ScaleNorm
  pre-norms hold ``wrap_{i}_{attn,ff}_norm/g``, ReZero gains sit under
  ``performer`` as ``wrap_{i}_{attn,ff}_rezero_g``, a learned absolute
  positional table is ``pos_emb/embedding``, and a raw ``PerformerLM``
  holds its ``to_out`` head unless it ties the token embedding.
* :func:`load_gridnet_hex_mm` copies a ``GridNetHexMM`` tree: the count f
  under ``params``/``favor`` ``count_classifier``, the image f under
  ``params``/``batch_stats`` ``image_classifier``, the corrector as in
  ``GridNetHex``.
* The square-lattice models (``GridNet``, ``GridNetMM``) hold the
  Cartesian corrector under ``corrector``: ``Conv_0``..``Conv_3`` (flax
  HWIO kernels, torch OIHW) and, with BatchNorm, ``BatchNorm_0``..``_2``;
  ``ConcatGridNet`` holds the four convs at the root of ``params``.
  :func:`load_gridnet` loads any grid model.
* A ``CountMLP`` f (as ``GridNetHex``'s f or ``GridNetHexMM``'s count f)
  holds ``Dense_0``..``Dense_4`` and, with BatchNorm, ``BatchNorm_0`` and
  ``BatchNorm_1``.
* :func:`load_hexgcn` copies a ``HexGCN`` (``params`` only), named by
  creation order: layer k's self ``Dense_{2k}`` (kernel, bias), its
  neighbour ``Dense_{2k+1}`` (kernel, no bias) and ``LayerNorm_k``, then
  the head ``Dense_{2 depth}``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gridnext_tpu_torch.compat import flax_msgpack
from gridnext_tpu_torch.models.densenet import DenseNet
from gridnext_tpu_torch.models.graph import HexGCN
from gridnext_tpu_torch.models.gridnet import ConcatGridNet, GridNetHexMM
from gridnext_tpu_torch.models.mlp import CountMLP
from gridnext_tpu_torch.models.performer import (FastAttention, Performer, PerformerLM,
                                                 ScaleNorm, SelfAttention)
from gridnext_tpu_torch.models.scbert import AttentionClassifier, scBERT
from gridnext_tpu_torch.models.tpu_f import ChannelNorm, TpuPatchClassifier

_NORM_NAMES = {"rms": "RMSNorm", "layer": "LayerNorm"}


def load_checkpoint(path):
    """Read a checkpoint payload dict (params/batch_stats/extra_vars/step,
    optionally opt_state) from a flax msgpack file."""
    with open(path, "rb") as fh:
        return flax_msgpack.unpackb(fh.read())


def save_checkpoint(path, variables: dict, step: int = 0):
    """Write ``variables`` (a tree in the JAX layout, as :func:`jax_variables`
    gives it) as the JAX package's ``save_checkpoint`` writes a model
    directory's payload: ``params``, ``batch_stats`` (None without),
    ``extra_vars`` (every other collection, e.g. ``favor``) and ``step``.
    The file is written beside and renamed into place."""
    payload = {"params": variables["params"],
               "batch_stats": variables.get("batch_stats"),
               "extra_vars": {k: v for k, v in variables.items()
                              if k not in ("params", "batch_stats")},
               "step": int(step)}
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(flax_msgpack.packb(payload))
    os.replace(tmp, path)


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


def save_model_dir(model_dir, meta: dict, variables: dict):
    """Write a model directory :func:`load_model_dir` (and the JAX package)
    reads: ``model.json`` from ``meta`` (with its ``classes``) and
    ``g_state.msgpack`` from ``variables``."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "model.json"), "w") as fh:
        json.dump(meta, fh)
    save_checkpoint(os.path.join(model_dir, "g_state.msgpack"), variables)


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
    if f.head is not None:
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


def _count_mlp_entries(f: CountMLP, params=("params",), stats=("batch_stats",)):
    for i, linear in enumerate(f.dense):
        yield params + (f"Dense_{i}", "kernel"), linear.weight, "dense"
        yield params + (f"Dense_{i}", "bias"), linear.bias, "same"
    if f.batch_norm:
        for j, bn in enumerate(f.norms):
            yield from _batchnorm_entries(bn, params, stats, f"BatchNorm_{j}")


def _f_entries(f, params, stats):
    if isinstance(f, TpuPatchClassifier):
        return _tpu_f_entries(f, params)
    if isinstance(f, DenseNet):
        return _densenet_entries(f, params, stats)
    if isinstance(f, CountMLP):
        return _count_mlp_entries(f, params, stats)
    raise NotImplementedError(f"the weight bridge maps TpuPatchClassifier, "
                              f"DenseNet and CountMLP, not {type(f).__name__}")


def _dense_entries(linear, path):
    yield path + ("kernel",), linear.weight, "dense"
    if linear.bias is not None:
        yield path + ("bias",), linear.bias, "same"


def _layer_norm_entries(norm, path):
    yield path + ("scale",), norm.weight, "same"
    yield path + ("bias",), norm.bias, "same"


def _fast_attention_entries(fa: FastAttention, favor):
    if not fa.no_projection:
        yield favor + ("projection",), fa.projection, "same"


def _self_attention_entries(attn: SelfAttention, params, favor):
    for name in ("to_q", "to_k", "to_v", "to_out"):
        yield from _dense_entries(getattr(attn, name), params + (name,))
    if attn.fast_attention is not None:
        yield from _fast_attention_entries(attn.fast_attention, favor + ("fast_attention",))


def _pre_norm_entries(norm, path):
    if isinstance(norm, ScaleNorm):
        yield path + ("g",), norm.g, "same"
    elif isinstance(norm, torch.nn.LayerNorm):
        yield from _layer_norm_entries(norm, path)


def _performer_entries(perf: Performer, params, favor):
    for i, (attn_norm, attn, ff_norm, ff) in enumerate(zip(
            perf.attn_norms, perf.attns, perf.ff_norms, perf.ffs)):
        yield from _pre_norm_entries(attn_norm, params + (f"wrap_{i}_attn_norm",))
        yield from _self_attention_entries(attn, params + (f"layers_{i}_attn",),
                                           favor + (f"layers_{i}_attn",))
        yield from _pre_norm_entries(ff_norm, params + (f"wrap_{i}_ff_norm",))
        yield from _dense_entries(ff.w1, params + (f"layers_{i}_ff", "w1"))
        yield from _dense_entries(ff.w2, params + (f"layers_{i}_ff", "w2"))
        if perf.use_rezero:
            for part in ("attn", "ff"):
                yield (params + (f"wrap_{i}_{part}_rezero_g",),
                       perf.rezero_gain(i, part), "same")


def _attention_classifier_entries(head: AttentionClassifier, params):
    for name in ("conv1", "fc1", "fc2", "fc3"):
        yield from _dense_entries(getattr(head, name), params + (name,))


def _performer_lm_entries(lm: PerformerLM, params, favor):
    """A PerformerLM's own weights; a ``head_module``'s live elsewhere (at
    scBERT's root)."""
    yield params + ("token_emb", "embedding"), lm.token_emb.weight, "same"
    if lm.pos_emb is not None:
        yield params + ("pos_emb", "embedding"), lm.pos_emb.embedding, "same"
    yield from _performer_entries(lm.performer, params + ("performer",),
                                  favor + ("performer",))
    yield from _layer_norm_entries(lm.norm, params + ("norm",))
    if lm.to_out is not None:
        yield from _dense_entries(lm.to_out, params + ("to_out",))


def _scbert_entries(f: scBERT, params, favor):
    lm = f.performer_lm
    yield from _performer_lm_entries(lm, params + ("performer_lm",),
                                     favor + ("performer_lm",))
    if lm.head_module is not None:
        yield from _attention_classifier_entries(lm.head_module, params + ("to_out",))


_PERFORMER_FAMILY = (
    (scBERT, _scbert_entries),
    (PerformerLM, _performer_lm_entries),
    (Performer, _performer_entries),
    (SelfAttention, _self_attention_entries),
    (FastAttention, lambda m, params, favor: _fast_attention_entries(m, favor)),
    (AttentionClassifier, lambda m, params, favor: _attention_classifier_entries(m, params)),
)


_PERFORMER_CLASSES = tuple(cls for cls, _ in _PERFORMER_FAMILY)


def _performer_family_entries(module, params=("params",), favor=("favor",)):
    for cls, entries in _PERFORMER_FAMILY:
        if isinstance(module, cls):
            return entries(module, params, favor)
    raise NotImplementedError(f"the weight bridge maps scBERT and its parts, not "
                              f"{type(module).__name__}")


def _corrector_entries(corrector, scope=("corrector",)):
    for collection, layer, leaf, tensor, layout in corrector.jax_entries():
        yield (collection, *scope, layer, leaf), tensor, layout


def _gridnet_entries(model):
    yield from _f_entries(model.patch_classifier, ("params", "patch_classifier"),
                          ("batch_stats", "patch_classifier"))
    yield from _corrector_entries(model.corrector)


def _gridnet_mm_entries(model: GridNetHexMM):
    if isinstance(model.count_classifier, CountMLP):
        yield from _count_mlp_entries(model.count_classifier,
                                      ("params", "count_classifier"),
                                      ("batch_stats", "count_classifier"))
    else:
        yield from _performer_family_entries(model.count_classifier,
                                             ("params", "count_classifier"),
                                             ("favor", "count_classifier"))
    yield from _f_entries(model.image_classifier, ("params", "image_classifier"),
                          ("batch_stats", "image_classifier"))
    yield from _corrector_entries(model.corrector)


def _hexgcn_entries(model: HexGCN, params=("params",)):
    for k, (self_dense, nbr_dense, norm) in enumerate(zip(
            model.self_dense, model.nbr_dense, model.norms)):
        yield from _dense_entries(self_dense, params + (f"Dense_{2 * k}",))
        yield from _dense_entries(nbr_dense, params + (f"Dense_{2 * k + 1}",))
        yield from _layer_norm_entries(norm, params + (f"LayerNorm_{k}",))
    yield from _dense_entries(model.out, params + (f"Dense_{2 * len(model.norms)}",))


def _model_entries(model):
    """(path, tensor, layout) of every weight of ``model``: a grid model,
    a ``HexGCN``, or a model that trains alone (an f: ``TpuPatchClassifier``,
    ``DenseNet``, ``CountMLP``, scBERT and its parts) with its collections
    at the root of the tree."""
    if isinstance(model, (TpuPatchClassifier, DenseNet, CountMLP)):
        return _f_entries(model, ("params",), ("batch_stats",))
    if isinstance(model, _PERFORMER_CLASSES):
        return _performer_family_entries(model)
    if isinstance(model, HexGCN):
        return _hexgcn_entries(model)
    if isinstance(model, GridNetHexMM):          # and GridNetMM
        return _gridnet_mm_entries(model)
    if isinstance(model, ConcatGridNet):         # flax names its convs at the root
        return _corrector_entries(model.corrector, ())
    return _gridnet_entries(model)


def to_jax_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    """A torch weight (or a tensor shaped like it: a gradient, an Adam
    moment) as the JAX tree holds it: a copy, never a view of a CPU
    tensor's memory (which a later in-place update would change)."""
    a = t.detach().cpu().numpy()
    if layout == "conv":
        a = a.transpose(2, 3, 1, 0)      # OIHW -> HWIO
    elif layout == "dense":
        a = a.T
    return np.array(a)


def from_jax_layout(a: np.ndarray, layout: str) -> np.ndarray:
    """A JAX tree's array in the layout of the torch weight it maps to."""
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
            value = from_jax_layout(node, layout)
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
    ``batch_stats``) into ``f`` (in place) and return it in eval mode, as a
    checkpoint serves (``f.train()`` trains it)."""
    _load(_densenet_entries(f), variables, [("params",), ("batch_stats",)])
    return f.eval()


def load_count_mlp(f: CountMLP, variables: dict) -> CountMLP:
    """Copy a flax ``CountMLP`` variables tree (``params`` and, with
    BatchNorm, ``batch_stats``) into ``f`` (in place)."""
    _load(_count_mlp_entries(f), variables, [("params",), ("batch_stats",)])
    return f


def load_gridnet(model, variables: dict):
    """Copy a JAX grid model's variables tree into ``model`` (in place) and
    return it: a ``GridNetHex`` or ``GridNet`` (a ``TpuPatchClassifier``,
    ``DenseNet`` or ``CountMLP`` f; ``params`` and, with BatchNorm,
    ``batch_stats``), a ``GridNetHexMM`` or ``GridNetMM``
    (:func:`load_gridnet_hex_mm`) or a ``ConcatGridNet`` (its four convs at
    the root of ``params``). The Cartesian corrector's ``Conv_i`` kernels
    go from flax's (kh, kw, in, out) to torch's (out, in, kh, kw). Every
    leaf under the model's roots must be used."""
    if isinstance(model, GridNetHexMM):
        return load_gridnet_hex_mm(model, variables)
    if isinstance(model, ConcatGridNet):
        roots = [("params",)]
    else:
        roots = [("params", "patch_classifier"), ("params", "corrector"),
                 ("batch_stats", "patch_classifier"), ("batch_stats", "corrector")]
    _load(_model_entries(model), variables, roots)
    return model


def load_hexgcn(model: HexGCN, variables: dict) -> HexGCN:
    """Copy a flax ``HexGCN`` variables tree (``params``) into ``model`` (in
    place) and return it. Every leaf under ``params`` must be used."""
    _load(_hexgcn_entries(model), variables, [("params",)])
    return model


def load_performer(module, variables: dict):
    """Copy a flax scBERT (or ``PerformerLM``, ``Performer``,
    ``SelfAttention``, ``FastAttention``, ``AttentionClassifier``)
    variables tree (``params`` and, with projections, ``favor``) into
    ``module`` (in place) and return it."""
    _load(_performer_family_entries(module), variables, [("params",), ("favor",)])
    return module


def load_gridnet_hex_mm(model: GridNetHexMM, variables: dict) -> GridNetHexMM:
    """Copy a JAX ``GridNetHexMM`` or ``GridNetMM`` variables tree (an scBERT
    or ``CountMLP`` count f, a ``TpuPatchClassifier`` or ``DenseNet`` image
    f, the hex or Cartesian corrector) into ``model`` (in place) and return
    it. Every leaf under the model's roots must be used."""
    roots = [("params", "count_classifier"), ("params", "image_classifier"),
             ("params", "corrector"), ("batch_stats", "count_classifier"),
             ("batch_stats", "image_classifier"), ("batch_stats", "corrector"),
             ("favor", "count_classifier")]
    _load(_gridnet_mm_entries(model), variables, roots)
    return model


def load_variables(model, variables: dict):
    """Copy a JAX variables tree into any model :func:`jax_variables` maps
    (in place) and return it: a grid model (:func:`load_gridnet`), a
    ``HexGCN``, or an f alone (its collections at the root). Every leaf
    under the model's roots must be used."""
    if isinstance(model, HexGCN):
        return load_hexgcn(model, variables)
    if isinstance(model, (TpuPatchClassifier, DenseNet, CountMLP) + _PERFORMER_CLASSES):
        entries = list(_model_entries(model))
        _load(entries, variables, sorted({path[:1] for path, _, _ in entries}))
        return model
    return load_gridnet(model, variables)


def model_entries(model):
    """``(path, tensor, layout)`` of every weight of ``model``, as a list:
    ``path`` the key path in the JAX variables tree (collection first),
    ``layout`` 'conv', 'dense' or 'same' (:func:`to_jax_layout`)."""
    return list(_model_entries(model))


def jax_variables(model) -> dict:
    """The variables tree in the JAX package's layout that
    :func:`load_variables` reads back into ``model`` (nested dicts of numpy
    arrays): a grid model, a ``HexGCN`` or any f that trains alone. Its
    shapes are those a JAX checkpoint must have."""
    tree: dict = {}
    for path, tensor, layout in _model_entries(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_jax_layout(tensor, layout)
    return tree
