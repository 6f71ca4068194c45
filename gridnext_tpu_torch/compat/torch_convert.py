"""The reference's PyTorch checkpoints, read into the port's modules.

The port's copy of the JAX package's ``compat/torch_convert.py``. Each
converter maps a reference ``state_dict`` (the trained checkpoints of the
reference, e.g. its ``densenet_ba44_p128.pth``) onto the port's weight tree
(the JAX package's layout), which
:func:`~gridnext_tpu_torch.compat.from_jax.load_variables` copies into the
port's module; :func:`load_torch_checkpoint` does both::

    sd = read_torch_checkpoint("densenet_ba44_p128.pth")    # no pickled code runs
    f = load_variables(densenet121(num_classes=4), densenet_from_torch(sd))

Input is a plain ``{name: tensor-like}`` mapping. Layouts converted:
  torch Conv2d weight (out, in, kh, kw)  -> (kh, kw, in, out)
  torch Linear weight (out, in)          -> (in, out)
  torch BatchNorm {weight,bias,running_mean,running_var}
      -> {scale,bias} params + {mean,var} batch_stats
and hexagdly's odd-down hex kernels -> the odd-right 7-tap (or 19-tap)
layout of the port's hex convolutions.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from gridnext_tpu_torch.compat.scbert_convert import read_torch_checkpoint
from gridnext_tpu_torch.geometry import hex_taps


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _conv_w(t):
    return _np(t).transpose(2, 3, 1, 0)


def _linear_w(t):
    return _np(t).transpose(1, 0)


def _bn(sd: Mapping, prefix: str):
    params = {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}
    stats = {"mean": _np(sd[prefix + ".running_mean"]), "var": _np(sd[prefix + ".running_var"])}
    return params, stats


def densenet_from_torch(sd: Mapping, block_config=(6, 12, 24, 16),
                        small_inputs: bool = False, classify: bool = True):
    """Convert a reference DenseNet state_dict to flax variables.

    Reference module names (densenet.py:100-138): ``features.conv0``,
    ``features.norm0``, ``features.denseblock{i}.denselayer{j}.{norm1,conv1,
    norm2,conv2}``, ``features.transition{i}.{norm,conv}``,
    ``features.norm_final``, ``classifier``.

    Our flax DenseNet creates modules in call order, so names are positional:
    ``conv0``, then ``BatchNorm_0`` (stem, if not small_inputs), then per
    dense layer a ``_DenseLayer_{k}`` containing BatchNorm_0/Conv_0/
    BatchNorm_1/Conv_1, per transition a ``_Transition_{k}``, the final
    ``BatchNorm_{n}``, and ``classifier``.
    """
    params: dict = {}
    stats: dict = {}

    params["conv0"] = {"kernel": _conv_w(sd["features.conv0.weight"])}

    n_stem_bn = 0
    if not small_inputs:
        p, s = _bn(sd, "features.norm0")
        params["BatchNorm_0"] = p
        stats["BatchNorm_0"] = s
        n_stem_bn = 1

    layer_idx = 0
    trans_idx = 0
    for bi, n_layers in enumerate(block_config, start=1):
        for li in range(1, n_layers + 1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            name = f"_DenseLayer_{layer_idx}"
            p0, s0 = _bn(sd, pre + ".norm1")
            p1, s1 = _bn(sd, pre + ".norm2")
            params[name] = {
                "BatchNorm_0": p0,
                "Conv_0": {"kernel": _conv_w(sd[pre + ".conv1.weight"])},
                "BatchNorm_1": p1,
                "Conv_1": {"kernel": _conv_w(sd[pre + ".conv2.weight"])},
            }
            stats[name] = {"BatchNorm_0": s0, "BatchNorm_1": s1}
            layer_idx += 1
        if bi != len(block_config):
            pre = f"features.transition{bi}"
            name = f"_Transition_{trans_idx}"
            p, s = _bn(sd, pre + ".norm")
            params[name] = {
                "BatchNorm_0": p,
                "Conv_0": {"kernel": _conv_w(sd[pre + ".conv.weight"])},
            }
            stats[name] = {"BatchNorm_0": s}
            trans_idx += 1

    p, s = _bn(sd, "features.norm_final")
    params[f"BatchNorm_{n_stem_bn}"] = p
    stats[f"BatchNorm_{n_stem_bn}"] = s

    if classify and "classifier.weight" in sd:
        params["classifier"] = {
            "kernel": _linear_w(sd["classifier.weight"]),
            "bias": _np(sd["classifier.bias"]),
        }

    return {"params": params, "batch_stats": stats}


def count_mlp_from_torch(sd: Mapping):
    """Convert the tutorial count-MLP ``nn.Sequential`` state_dict.

    Sequential indices (Tutorial_visium_count.ipynb cell 12): Linear 0, 1,
    BatchNorm1d 2, Linear 4, 5, BatchNorm1d 6, Linear 8.
    """
    def dense(i):
        return {"kernel": _linear_w(sd[f"{i}.weight"]), "bias": _np(sd[f"{i}.bias"])}

    p2, s2 = _bn(sd, "2")
    p6, s6 = _bn(sd, "6")
    params = {
        "Dense_0": dense(0), "Dense_1": dense(1), "BatchNorm_0": p2,
        "Dense_2": dense(4), "Dense_3": dense(5), "BatchNorm_1": p6,
        "Dense_4": dense(8),
    }
    stats = {"BatchNorm_0": s2, "BatchNorm_1": s6}
    return {"params": params, "batch_stats": stats}


def gridnet_from_torch(sd: Mapping, f_variables: Mapping, use_bn: bool = True):
    """Convert a trained reference *Cartesian* GridNet state_dict to ours.

    The reference square-lattice corrector is an ``nn.Sequential`` of plain
    Conv2d 3/5/5/3 + BN + ReLU (gridnet_models.py:51-66): with BN the module
    indices are Conv 0,3,6,9 / BN 1,4,7; without BN, Conv 0,2,4,6. Our
    ``models.gridnet.GridNet`` holds the same topology as
    ``corrector.Conv_0..3`` / ``BatchNorm_0..2``.

    ``f_variables``: the patch classifier's flax variables, converted
    separately (densenet_from_torch / count_mlp_from_torch / ...).
    """
    conv_idx = (0, 3, 6, 9) if use_bn else (0, 2, 4, 6)
    corr_p: dict = {}
    corr_s: dict = {}
    for i, mi in enumerate(conv_idx):
        corr_p[f"Conv_{i}"] = {
            "kernel": _conv_w(sd[f"corrector.{mi}.weight"]),
            "bias": _np(sd[f"corrector.{mi}.bias"]),
        }
    if use_bn:
        for j, mi in enumerate((1, 4, 7)):
            p, s = _bn(sd, f"corrector.{mi}")
            corr_p[f"BatchNorm_{j}"] = p
            corr_s[f"BatchNorm_{j}"] = s
    variables = {"params": {"patch_classifier": dict(f_variables["params"]),
                            "corrector": corr_p}}
    bs: dict = {}
    if "batch_stats" in f_variables:
        bs["patch_classifier"] = dict(f_variables["batch_stats"])
    if corr_s:
        bs["corrector"] = corr_s
    if bs:
        variables["batch_stats"] = bs
    return variables


def hex_kernel_from_hexagdly(kernel0, kernel1):
    """hexagdly sub-kernels -> (7, C_in, C_out) tap weights (HEX_TAPS_R1 order).

    ``kernel0`` (C_out, C_in, 3, 1) is hexagdly's central-column sub-kernel,
    ``kernel1`` (C_out, C_in, 2, 2) the adjacent-columns one (semantics pinned
    in the JAX package's compat.hexagdly_ref). The reference enters hexagdly's odd-down
    addressing through a rot90+flip pair (gridnet_models.py:178-186) that
    composes to a spatial transpose, under which odd-q compass directions map
    onto odd-r taps as below; the JAX package's hexagdly oracle certifies the
    map numerically through the literal torch rot90/flip ops.
    """
    k0, k1 = _np(kernel0), _np(kernel1)
    taps = [  # HEX_TAPS_R1 order
        k0[:, :, 1, 0],  # C   <- center
        k0[:, :, 0, 0],  # W   <- N
        k0[:, :, 2, 0],  # E   <- S
        k1[:, :, 0, 0],  # NW  <- upper-west
        k1[:, :, 1, 0],  # NE  <- lower-west
        k1[:, :, 0, 1],  # SW  <- upper-east
        k1[:, :, 1, 1],  # SE  <- lower-east
    ]
    return np.stack([t.transpose(1, 0) for t in taps], axis=0)


def hex_kernel_from_hexagdly_k2(kernel0, kernel1, kernel2):
    """hexagdly kernel_size=2 sub-kernels -> (19, C_in, C_out) tap weights.

    Layout follows ``geometry.hex_taps(2)`` order. Under the reference's
    rot90+flip transpose, an odd-q sub-kernel cell at column offset dx and
    row offset dy maps onto the odd-r tap (dr=dx, dc_even=dy@even-col,
    dc_odd=dy@odd-col) -- the same correspondence
    :func:`hex_kernel_from_hexagdly` encodes cell by cell for size 1, built
    here as a lookup over the sub-kernel geometry pinned in
    the JAX package's
    ``compat.hexagdly_ref.hexagdly_conv2d_k2``. The reference never trains
    size-2 correctors, so this exists to certify ``hex_taps(radius=2)``
    against the independent oracle (and to convert any future checkpoint).
    """
    k0, k1, k2 = _np(kernel0), _np(kernel1), _np(kernel2)
    lut = {}
    for i in range(5):                      # central column: dy = i-2
        lut[(0, i - 2, i - 2)] = k0[:, :, i, 0]
    for i in range(4):                      # columns +-1: top dy -2/-1
        for j, dx in ((0, -1), (1, 1)):
            lut[(dx, i - 2, i - 1)] = k1[:, :, i, j]
    for i in range(3):                      # columns +-2: dy = i-1
        for j, dx in ((0, -2), (1, 2)):
            lut[(dx, i - 1, i - 1)] = k2[:, :, i, j]
    taps = [lut[t] for t in hex_taps(2)]
    return np.stack([t.transpose(1, 0) for t in taps], axis=0)


def gridnethex_from_torch(sd: Mapping, f_variables: Mapping, use_bn: bool = True):
    """Convert a trained reference GridNetHex(Oddr) state_dict to our GridNetHex.

    The reference corrector is an ``nn.Sequential`` of hexagdly convs + BN
    (gridnet_models.py:128-148): module indices 0,1 hex, 2 BN, 4,5 hex, 6 BN,
    8 hex (without BN: 0,1,3,4,6 hex). Our odd-right-native _HexCorrector has
    the same topology as HexConv_0..4 / BatchNorm_0..1; the rot90/flip
    round-trip is absorbed into the kernel tap mapping.

    ``f_variables``: the patch classifier's flax variables, converted
    separately (densenet_from_torch / count_mlp_from_torch / scbert
    converters) -- f architectures vary per experiment.
    """
    hex_idx = (0, 1, 4, 5, 8) if use_bn else (0, 1, 3, 4, 6)
    corr_p: dict = {}
    corr_s: dict = {}
    for i, mi in enumerate(hex_idx):
        pre = f"corrector.{mi}"
        entry = {"kernel": hex_kernel_from_hexagdly(
            sd[pre + ".kernel0"], sd[pre + ".kernel1"])}
        if pre + ".bias" in sd:
            entry["bias"] = _np(sd[pre + ".bias"])
        corr_p[f"HexConv_{i}"] = entry
    if use_bn:
        for j, mi in enumerate((2, 6)):
            p, s = _bn(sd, f"corrector.{mi}")
            corr_p[f"BatchNorm_{j}"] = p
            corr_s[f"BatchNorm_{j}"] = s
    variables = {"params": {"patch_classifier": dict(f_variables["params"]),
                            "corrector": corr_p}}
    bs: dict = {}
    if "batch_stats" in f_variables:
        bs["patch_classifier"] = dict(f_variables["batch_stats"])
    if corr_s:
        bs["corrector"] = corr_s
    if bs:
        variables["batch_stats"] = bs
    return variables


def gridnethexmm_from_torch(sd: Mapping, image_f_variables: Mapping,
                            count_f_variables: Mapping, use_bn: bool = True):
    """Convert a trained reference GridNetHexMM state_dict to our GridNetHexMM.

    The reference MM model (gridnet_models.py:193-235) shares the
    GridNetHexOddr corrector (its input width = count_f_dim + image_f_dim;
    concat order count-first, :235) and carries two f networks. Pass each
    f's flax variables converted separately (densenet_from_torch /
    count_mlp_from_torch / scbert converters); the corrector tap map is the
    same hexagdly round-trip as :func:`gridnethex_from_torch`.
    """
    base = gridnethex_from_torch(sd, f_variables={"params": {}},
                                 use_bn=use_bn)
    variables = {"params": {
        "image_classifier": dict(image_f_variables["params"]),
        "count_classifier": dict(count_f_variables["params"]),
        "corrector": base["params"]["corrector"],
    }}
    bs: dict = {}
    if "batch_stats" in image_f_variables:
        bs["image_classifier"] = dict(image_f_variables["batch_stats"])
    if "batch_stats" in count_f_variables:
        bs["count_classifier"] = dict(count_f_variables["batch_stats"])
    if base.get("batch_stats", {}).get("corrector"):
        bs["corrector"] = base["batch_stats"]["corrector"]
    if bs:
        variables["batch_stats"] = bs
    return variables


def load_torch_checkpoint(model, path, convert, *args, **kwargs):
    """Read the reference checkpoint ``path``
    (:func:`~gridnext_tpu_torch.compat.scbert_convert.read_torch_checkpoint`,
    which runs no pickled code), convert it with ``convert`` (one of this
    module's ``*_from_torch``; ``args`` and ``kwargs`` go to it) and copy it
    into the port's ``model``, which is returned."""
    from gridnext_tpu_torch.compat.from_jax import load_variables

    return load_variables(model, convert(read_torch_checkpoint(path), *args, **kwargs))


__all__ = ["count_mlp_from_torch", "densenet_from_torch", "gridnet_from_torch",
           "gridnethex_from_torch", "gridnethexmm_from_torch", "hex_kernel_from_hexagdly",
           "hex_kernel_from_hexagdly_k2", "load_torch_checkpoint", "read_torch_checkpoint"]
