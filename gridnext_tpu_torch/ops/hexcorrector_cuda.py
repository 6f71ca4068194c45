"""Hex corrector g for serving: five folded radius-1 hex convolutions.

:func:`fused_hex_corrector` (logits) and :func:`fused_hex_corrector_labels`
(argmax+1, 0 on background) replace the TPU kernels of
``gridnext_tpu/ops/hexcorrector_pallas.py`` of the same names. On a CUDA
tensor they launch the CUDA kernels of ``csrc/hexcorrector.cu``, one launch
per layer; on a CPU tensor they run the plain versions
(:func:`hex_corrector_plain`, :func:`hex_corrector_labels_plain`), which loop
:func:`gridnext_tpu_torch.ops.hexconv.hex_conv` over the folded layers.
There is no fallback from one to the other.

What bounds the kernels on the card: f32 operations (~246 MFLOP per 78x64
grid against ~150 KB of input). The TPU kernel ran all five layers in VMEM;
here each layer is one launch with one thread per (cell, 8 output
channels) and the layer's weights (28 KB at 32x32) in shared memory; the
(B, 78, 64, 32) intermediates go through device memory and stay in the
50 MB L2. The labels launch keeps all of a cell's logits in registers and
writes ``argmax + 1`` (first index on ties, a strict ``>``), or 0 where
``fg == 0``, so the last layer's logits never reach device memory.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gridnext_tpu_torch.ops import _cuda
from gridnext_tpu_torch.ops.hexconv import hex_conv

# ReLU placement of the 5-layer hex corrector (after layers 1 and 3)
CORRECTOR_RELU_FLAGS = (False, True, False, True, False)

# Kernel launches (one per layer) made by each wrapper; plain integers that a
# run resets and reads to show the kernels were used.
launches = {"fused_hex_corrector": 0, "fused_hex_corrector_labels": 0}

_MAX_CLASSES = 32  # csrc/hexcorrector.cu kMaxClasses


def fold_corrector_params(params: dict, batch_stats=None, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the hex-conv weights of a corrector.

    ``params``/``batch_stats`` use the JAX package's layout
    (``HexConv_i`` kernel/bias, ``BatchNorm_j`` scale/bias and mean/var).
    Returns (kernels, biases, relu_flags): five folded (7, C_in, C_out) f32
    kernels and (C_out,) biases. ``use_bn=False`` correctors (no BatchNorm
    entries) skip the fold.
    """
    kernels, biases = [], []
    for i in range(5):
        hc = params[f"HexConv_{i}"]
        kernels.append(np.asarray(hc["kernel"], np.float32))
        biases.append(np.asarray(hc["bias"], np.float32))

    for bn_idx, layer in ((0, 1), (1, 3)):
        if f"BatchNorm_{bn_idx}" not in params:
            continue  # use_bn=False corrector
        bn_p = params[f"BatchNorm_{bn_idx}"]
        if not batch_stats or f"BatchNorm_{bn_idx}" not in batch_stats:
            raise ValueError(
                "corrector has BatchNorm params but no batch_stats were "
                "provided; pass variables['batch_stats']['corrector']")
        bn_s = batch_stats[f"BatchNorm_{bn_idx}"]
        s = np.asarray(bn_p["scale"]) / np.sqrt(np.asarray(bn_s["var"]) + eps)
        kernels[layer] = kernels[layer] * s  # scale out-channels
        biases[layer] = (biases[layer] - np.asarray(bn_s["mean"])) * s \
            + np.asarray(bn_p["bias"])

    return kernels, biases, CORRECTOR_RELU_FLAGS


def as_f32_tensors(ts, device) -> list:
    """Weights (tensors or numpy arrays) as contiguous float32 tensors on ``device``."""
    return [(t if isinstance(t, torch.Tensor)
             else torch.from_numpy(np.array(t, np.float32)))
            .to(device, torch.float32).contiguous() for t in ts]


def hex_corrector_plain(x: torch.Tensor, kernels: Sequence, biases: Sequence,
                        relu_flags: Sequence[bool] = CORRECTOR_RELU_FLAGS) -> torch.Tensor:
    """Plain PyTorch corrector: (B, H, W, C_in) -> (B, H, W, n_classes) f32."""
    cur = x.float()
    dev = x.device
    for k, b, relu in zip(as_f32_tensors(kernels, dev), as_f32_tensors(biases, dev),
                          relu_flags):
        cur = hex_conv(cur, k, b)
        if relu:
            cur = torch.relu(cur)
    return cur


def hex_corrector_labels_plain(x: torch.Tensor, fg: torch.Tensor, kernels: Sequence,
                               biases: Sequence,
                               relu_flags: Sequence[bool] = CORRECTOR_RELU_FLAGS
                               ) -> torch.Tensor:
    """Plain corrector + argmax+1, 0 where ``fg == 0``: (B, H, W) int32."""
    logits = hex_corrector_plain(x, kernels, biases, relu_flags)
    labels = torch.argmax(logits, dim=-1).to(torch.int32) + 1
    return torch.where(fg > 0, labels, torch.zeros_like(labels))


def _check_inputs(x, kernels, biases, relu_flags):
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C) grids, got {tuple(x.shape)}")
    if not (len(kernels) == len(biases) == len(relu_flags)) or not kernels:
        raise ValueError("need one kernel, bias and relu flag per layer")
    c = x.shape[-1]
    for k, b in zip(kernels, biases):
        if tuple(k.shape[:2]) != (7, c) or tuple(b.shape) != (k.shape[2],):
            raise ValueError(f"layer weights {tuple(k.shape)} / bias "
                             f"{tuple(b.shape)} do not take {c} input channels")
        c = k.shape[2]


def _run_layers(x, kernels, biases, relu_flags, fg):
    """Launch the layer kernels; the last one emits labels when ``fg`` is given."""
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the CUDA corrector takes contiguous float32 grids")
    kernels = as_f32_tensors(kernels, dev)
    biases = as_f32_tensors(biases, dev)
    lib = _cuda.library("hexcorrector")
    nb, h, w, _ = x.shape
    name = "fused_hex_corrector" if fg is None else "fused_hex_corrector_labels"
    cur = x
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, (k, b, relu) in enumerate(zip(kernels, biases, relu_flags)):
            c_in, c_out = k.shape[1], k.shape[2]
            if fg is not None and i == len(kernels) - 1:
                out = torch.empty((nb, h, w), dtype=torch.int32, device=dev)
                err = lib.hex_layer_labels_f32(
                    cur.data_ptr(), k.data_ptr(), b.data_ptr(), fg.data_ptr(),
                    nb, h, w, c_in, c_out, int(bool(relu)), out.data_ptr(), stream)
            else:
                out = torch.empty((nb, h, w, c_out), dtype=torch.float32, device=dev)
                err = lib.hex_layer_f32(
                    cur.data_ptr(), k.data_ptr(), b.data_ptr(), nb, h, w, c_in,
                    c_out, int(bool(relu)), out.data_ptr(), stream)
            _cuda.check(lib, err, f"{name} layer {i}")
            launches[name] += 1
            cur = out
    return cur


def fused_hex_corrector(x: torch.Tensor, kernels: Sequence, biases: Sequence,
                        relu_flags: Sequence[bool] = CORRECTOR_RELU_FLAGS) -> torch.Tensor:
    """Apply the folded corrector to (B, H, W, C_in) f-output grids.

    Returns (B, H, W, n_classes) float32 logits. Inputs come from
    :func:`fold_corrector_params`. CUDA tensors launch the kernel (one
    launch per layer), CPU tensors run :func:`hex_corrector_plain`.
    Replaces the TPU kernel ``gridnext_tpu/ops/hexcorrector_pallas.py::
    fused_hex_corrector``; bound by f32 operations, with the layer's
    weights in shared memory (module docstring).
    """
    _check_inputs(x, kernels, biases, relu_flags)
    if x.device.type == "cpu":
        return hex_corrector_plain(x, kernels, biases, relu_flags)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _run_layers(x, kernels, biases, relu_flags, None)


def fused_hex_corrector_labels(x: torch.Tensor, fg: torch.Tensor, kernels: Sequence,
                               biases: Sequence,
                               relu_flags: Sequence[bool] = CORRECTOR_RELU_FLAGS
                               ) -> torch.Tensor:
    """Corrector + argmax + background mask: (B, H, W) int32 label grids.

    ``fg``: (B, H, W) foreground mask (nonzero = in-tissue spot). Labels
    are 0 on background and 1..n_classes on foreground; ties take the
    first class, as ``jnp.argmax`` does. CUDA tensors launch the kernel,
    CPU tensors run :func:`hex_corrector_labels_plain`. Replaces the TPU
    kernel ``gridnext_tpu/ops/hexcorrector_pallas.py::
    fused_hex_corrector_labels``; the last layer keeps a cell's logits in
    registers and writes only the label (module docstring).
    """
    _check_inputs(x, kernels, biases, relu_flags)
    if tuple(fg.shape) != tuple(x.shape[:3]):
        raise ValueError(f"fg {tuple(fg.shape)} does not match grids "
                         f"{tuple(x.shape[:3])}")
    if x.device.type == "cpu":
        return hex_corrector_labels_plain(x, fg, kernels, biases, relu_flags)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_classes = kernels[-1].shape[2]
    if n_classes > _MAX_CLASSES:
        raise ValueError(f"the labels kernel takes at most {_MAX_CLASSES} "
                         f"classes, got {n_classes}")
    fg = fg.to(x.device, torch.int32).contiguous()
    return _run_layers(x, kernels, biases, relu_flags, fg)
