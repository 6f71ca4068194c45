"""The reference scBERT's torch checkpoints, read into the port's modules.

The reference's ``PerformerLM`` / scBERT ``state_dict`` names map onto the
port's weight tree (the JAX package's layout, which
:func:`~gridnext_tpu_torch.compat.from_jax.load_variables` copies into a
:class:`~gridnext_tpu_torch.models.PerformerLM` or
:class:`~gridnext_tpu_torch.models.scBERT`)::

  token_emb.weight                              -> token_emb/embedding
  performer.net.layers.{i}.0.norm.{weight,bias} -> performer/wrap_{i}_attn_norm
  performer.net.layers.{i}.0.fn.to_{q,k,v,out}  -> performer/layers_{i}_attn/*
  performer.net.layers.{i}.0.fn.fast_attention.projection_matrix
                                                -> the 'favor' collection
  performer.net.layers.{i}.0.g / .1.g           -> ScaleNorm gains
                                                   (use_scalenorm) or ReZero
                                                   gains wrap_{i}_*_rezero_g
  performer.net.layers.{i}.1.norm.{weight,bias} -> performer/wrap_{i}_ff_norm
  performer.net.layers.{i}.1.fn[.fn].w{1,2}     -> performer/layers_{i}_ff/*
  norm.{weight,bias}                            -> norm
  to_out.{weight,bias}                          -> to_out (a Linear head)
  to_out.{conv1,fc1,fc2,fc3}.*                  -> the AttentionClassifier,
                                                   at scBERT's root
  pos_emb.emb.weight                            -> returned apart: the gene2vec
                                                   table without its last row

A Linear's ``weight (out, in)`` becomes a ``kernel (in, out)``; the
classifier's ``conv1`` (a ``Conv2d(1, 1, (1, dim))``) becomes a Dense
``(dim, 1)`` kernel. The state dict cannot tell a ScaleNorm gain from a
ReZero gain (both are ``.0.g``): ``use_scalenorm`` says which.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layer_norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _layer(sd: Mapping, i: int, use_scalenorm: bool, perf: dict, favor: dict) -> None:
    base = f"performer.net.layers.{i}"
    perf[f"layers_{i}_attn"] = {name: _linear(sd, f"{base}.0.fn.{name}")
                                for name in ("to_q", "to_k", "to_v", "to_out")}
    proj = f"{base}.0.fn.fast_attention.projection_matrix"
    if proj in sd:
        favor[f"layers_{i}_attn"] = {"fast_attention": {"projection": _np(sd[proj])}}
    for j, part in enumerate(("attn", "ff")):
        if f"{base}.{j}.norm.weight" in sd:
            perf[f"wrap_{i}_{part}_norm"] = _layer_norm(sd, f"{base}.{j}.norm")
        elif f"{base}.{j}.g" in sd:
            gain = _np(sd[f"{base}.{j}.g"]).reshape(1)
            if use_scalenorm:
                perf[f"wrap_{i}_{part}_norm"] = {"g": gain}
            else:
                perf[f"wrap_{i}_{part}_rezero_g"] = gain
    ff = f"{base}.1.fn.fn" if f"{base}.1.fn.fn.w1.weight" in sd else f"{base}.1.fn"
    perf[f"layers_{i}_ff"] = {"w1": _linear(sd, f"{ff}.w1"), "w2": _linear(sd, f"{ff}.w2")}


def performer_lm_from_torch(sd: Mapping, depth: int, use_scalenorm: bool = False
                            ) -> Tuple[dict, Optional[np.ndarray]]:
    """A reference ``PerformerLM`` state dict as ``(variables, g2v)``:
    ``variables`` holds ``params`` (and ``favor`` when the state dict has
    projections) for a ``PerformerLM`` of ``depth`` layers; ``g2v`` is the
    gene2vec table (pass it as ``g2v_weights``) or None. An
    ``AttentionClassifier`` head stays under ``params/to_out``."""
    perf, favor = {}, {}
    for i in range(depth):
        _layer(sd, i, use_scalenorm, perf, favor)
    params = {"token_emb": {"embedding": _np(sd["token_emb.weight"])},
              "performer": perf, "norm": _layer_norm(sd, "norm")}
    if "to_out.weight" in sd:
        params["to_out"] = _linear(sd, "to_out")
    elif "to_out.fc1.weight" in sd:
        conv = _np(sd["to_out.conv1.weight"])              # (1, 1, 1, dim)
        params["to_out"] = {"conv1": {"kernel": conv.reshape(conv.shape[-1], 1),
                                      "bias": _np(sd["to_out.conv1.bias"])},
                            **{name: _linear(sd, f"to_out.{name}")
                               for name in ("fc1", "fc2", "fc3")}}
    variables = {"params": params}
    if favor:
        variables["favor"] = {"performer": favor}
    g2v = None
    if "pos_emb.emb.weight" in sd:
        g2v = _np(sd["pos_emb.emb.weight"])[:-1]   # the model appends the zero row itself
    return variables, g2v


def scbert_from_torch(sd: Mapping, depth: int = 6, use_scalenorm: bool = False
                      ) -> Tuple[dict, Optional[np.ndarray]]:
    """A reference scBERT state dict as ``(variables, g2v)`` for the port's
    :class:`~gridnext_tpu_torch.models.scBERT`: the LM under
    ``performer_lm``, an ``AttentionClassifier`` head at the root
    ``to_out``."""
    inner, g2v = performer_lm_from_torch(sd, depth, use_scalenorm)
    lm = dict(inner["params"])
    params = {"performer_lm": lm}
    if "conv1" in lm.get("to_out", {}):
        params["to_out"] = lm.pop("to_out")
    variables = {"params": params}
    if "favor" in inner:
        variables["favor"] = {"performer_lm": inner["favor"]}
    return variables, g2v


def read_torch_checkpoint(path) -> Mapping:
    """A ``.pth`` / ``.pt`` state dict, read without running pickled code
    (``weights_only``); a ``{"model_state_dict": ...}`` wrapper is
    unwrapped."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return sd
