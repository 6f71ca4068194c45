"""Hex corrector g for serving: five folded radius-1 hex convolutions.

:func:`fused_hex_corrector` (logits) and :func:`fused_hex_corrector_labels`
(argmax+1, 0 on background) replace the TPU kernels of
``gridnext_tpu/ops/hexcorrector_pallas.py`` of the same names. On a CUDA
tensor they launch the CUDA kernel of ``csrc/hexcorrector.cu``, once per
call for all layers; on a CPU tensor they run the plain versions
(:func:`hex_corrector_plain`, :func:`hex_corrector_labels_plain`), which loop
:func:`gridnext_tpu_torch.ops.hexconv.hex_conv` over the folded layers.
There is no fallback from one to the other.

What bounds the kernel on the card: f32 operations (~246 MFLOP per 78x64
grid against ~140 KB of input). The TPU kernel ran all five layers in VMEM;
here one thread-block cluster per grid runs them all in one launch: each
CTA keeps a band of whole rows at the layer width in shared memory, reads
the rows above and below its band from its neighbours' shared memory, and
syncs the cluster once per layer (:func:`plan_corrector` sizes the bands
and the channel slices). Input channels and the weights stream through
shared memory in slices, so neither ``c_in`` nor the class count is limited;
where two bands do not fit in shared memory (wide hidden layers, very wide
grids) they live in a device scratch and are staged a tile at a time, and
the layers come in a device array, so no layer count, hidden width, batch
or grid shape is refused.
The labels variant keeps a running ``(max, argmax)`` per cell and writes
``argmax + 1`` (first class on ties, as ``jnp.argmax``), or 0 where
``fg == 0``, so the last layer's logits never reach device memory.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch.ops import _cuda
from gridnext_tpu_torch.ops.hexconv import hex_conv

# ReLU placement of the 5-layer hex corrector (after layers 1 and 3)
CORRECTOR_RELU_FLAGS = (False, True, False, True, False)

# Kernel launches (one per call) made by each wrapper; plain integers that a
# run resets and reads to show the kernels were used.
launches = {"fused_hex_corrector": 0, "fused_hex_corrector_labels": 0}

CLUSTER_SIZES = (16, 8, 4, 2, 1)  # CTAs per grid, largest first (16 is non-portable)
# dynamic shared memory a block may use on sm_90: 232,448 bytes less the
# kernel's static 16 layer descriptors of 32 bytes (kSharedLayers)
SMEM_LIMIT = 232_448 - 16 * 32
_THREADS, _CELLS, _TILE_OUT = 256, 5, 32   # csrc/hexcorrector.cu kThreads, kCells, kTileOut
_MIN_KC = 8                     # fewest input channels a slice takes beside bands in smem


@dataclass(frozen=True)
class CorrectorPlan:
    """How the kernel splits a grid: ``cluster`` CTAs of ``band_rows`` rows
    each, worked in tiles of ``tile_rows`` x ``tile_cols`` cells, input
    slices of ``kc`` channels, band buffers of ``buf_c`` channels in shared
    memory (``smem_bands``, where the tile is the band) or in a device
    scratch."""
    cluster: int
    band_rows: int
    tile_rows: int
    tile_cols: int
    kc: int
    buf_c: int
    smem_bands: bool
    smem_bytes: int


def smem_bytes(tile_rows: int, tile_cols: int, kc: int, buf_c: int, smem_bands: bool) -> int:
    """A CTA's dynamic shared memory (``csrc/hexcorrector.cu``'s
    smem_floats, in bytes): two zero-padded band buffers with their halo
    rows when the bands are in shared memory, else a zero-padded staging
    tile of ``kc`` channels; two weight slices (the next one is copied while
    this one is used) and the labels' join buffers, in floats of 4 bytes."""
    def up4(n):                                  # regions start on 16-byte boundaries
        return -(-n // 4) * 4

    plane = (tile_rows + 2) * (tile_cols + 2)
    held = 2 * up4(buf_c * plane) if smem_bands else up4(kc * plane)
    return 4 * (held + 2 * 7 * kc * _TILE_OUT + 2 * _THREADS * _CELLS)


def _scratch_tile(band_rows: int, w: int, kc: int) -> tuple:
    """The largest staging tile of a band, whole rows first, whose ``kc``
    channels fit :data:`SMEM_LIMIT` beside the weight slices."""
    free = SMEM_LIMIT // 4 - 2 * 7 * kc * _TILE_OUT - 2 * _THREADS * _CELLS
    plane = free // 4 * 4 // kc                   # floats of one channel of the tile
    rows = min(band_rows, plane // (w + 2) - 2)
    return (rows, w) if rows >= 1 else (1, min(w, plane // 3 - 2))


def plan_corrector(h: int, w: int, widths: Sequence[int],
                   cluster_ok: Optional[Callable[[int, int, bool], bool]] = None
                   ) -> CorrectorPlan:
    """The kernel's plan for ``h x w`` grids through layers of ``widths``
    (input width, then each layer's output width).

    Rule: the largest cluster of :data:`CLUSTER_SIZES`, no larger than
    ``h``, that ``cluster_ok(cluster, smem_bytes, smem_bands)`` accepts (on
    the card: whether a cluster of that size with that shared memory can
    run), bands of ``ceil(h / cluster)`` rows; the hidden bands in shared
    memory when they fit beside input slices of at least 8 channels, else
    in device scratch with the widest slice (32, 16, ... 1 channels) that
    stages a whole band within :data:`SMEM_LIMIT`; where not even one
    channel of a band fits, slices of 8 channels (fewer if the layers are
    narrower) and the band in smaller tiles (:func:`_scratch_tile`).
    """
    buf_c = max(widths[1:-1], default=0)
    c_max = max(widths[:-1])
    for cluster in CLUSTER_SIZES:
        if cluster > h and cluster > 1:
            continue                                  # a CTA per row at most
        rb = -(-h // cluster)
        tiled = min(_MIN_KC, c_max)
        options = [(True, kc, (rb, w)) for kc in (32, 16, 8) if buf_c]
        options += [(False, kc, (rb, w)) for kc in (32, 16, 8, 4, 2, 1)]
        options.append((False, tiled, _scratch_tile(rb, w, tiled)))
        last_mode = None
        for bands, kc, (tr, tc) in options:
            # shared bands also hold layer 0's staged slices: kc <= buf_c
            kc = min(kc, min(c_max, buf_c) if bands else c_max)
            if bands and kc < min(_MIN_KC, c_max, buf_c):
                continue
            nbytes = smem_bytes(tr, tc, kc, buf_c, bands)
            if nbytes > SMEM_LIMIT or bands == last_mode:
                continue
            if cluster_ok is not None and not cluster_ok(cluster, nbytes, bands):
                last_mode = bands                     # smaller slices would not help
                continue
            return CorrectorPlan(cluster, rb, tr, tc, kc, buf_c, bands, nbytes)
    raise ValueError("no cluster size of the corrector kernel can run on this card")


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


@functools.lru_cache(maxsize=None)
def _prepare(device_index: int):
    """The kernel library, with the kernel allowed all opt-in shared memory
    and 16-CTA clusters on the card (once per card)."""
    lib = _cuda.library("hexcorrector")
    with torch.cuda.device(device_index):
        _cuda.check(lib, lib.hex_corrector_prepare(), "hex corrector set-up")
    return lib


def _cluster_ok(device_index: int, cluster: int, nbytes: int, smem_bands: bool) -> bool:
    """Whether the card can run one cluster of ``cluster`` CTAs with
    ``nbytes`` of shared memory each (the CUDA occupancy query)."""
    lib = _prepare(device_index)
    with torch.cuda.device(device_index):
        return lib.hex_corrector_max_clusters(cluster, nbytes, int(smem_bands)) >= 1


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, h: int, w: int, widths: tuple) -> CorrectorPlan:
    return plan_corrector(h, w, widths, functools.partial(_cluster_ok, device_index))


@functools.lru_cache(maxsize=64)
def _layer_table(device_index: int, weights: tuple, biases: tuple, widths: tuple,
                 relu: tuple) -> torch.Tensor:
    """The kernel's array of ``Layer`` (``csrc/hexcorrector.cu``) on the
    card, as four int64 words a layer: the weight and bias pointers, c_in
    and c_out (low and high half of a little-endian word), the ReLU flag.
    Its contents follow from the key alone, so a cached table stays right."""
    rows = [[wp, bp, widths[i] | widths[i + 1] << 32, int(r)]
            for i, (wp, bp, r) in enumerate(zip(weights, biases, relu))]
    # a blocking copy: the table is on the card before any stream reads it
    return torch.tensor(rows, dtype=torch.int64).to(torch.device("cuda", device_index))


def _launch(x, kernels, biases, relu_flags, fg):
    """One launch of the kernel over all layers; labels when ``fg`` is given.
    Its plan and layer table are computed here, behind the op boundary."""
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the CUDA corrector takes contiguous float32 grids")
    kernels = as_f32_tensors(kernels, dev)
    biases = as_f32_tensors(biases, dev)
    nb, h, w, c_in = x.shape
    widths = (c_in,) + tuple(int(k.shape[2]) for k in kernels)
    name = "fused_hex_corrector" if fg is None else "fused_hex_corrector_labels"
    out = (torch.empty((nb, h, w, widths[-1]), dtype=torch.float32, device=dev)
           if fg is None else torch.empty((nb, h, w), dtype=torch.int32, device=dev))
    if out.numel() == 0:
        return out
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _prepare(idx)
    plan = _plan(idx, h, w, widths)
    table = _layer_table(idx, tuple(k.data_ptr() for k in kernels),
                         tuple(b.data_ptr() for b in biases), widths,
                         tuple(bool(r) for r in relu_flags))
    scratch = None
    if not plan.smem_bands and len(kernels) > 1:
        scratch = torch.empty(nb * 2 * plan.buf_c * h * w, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hex_corrector_f32(
            x.data_ptr(), None if fg is None else fg.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), table.data_ptr(), len(kernels),
            nb, h, w, plan.cluster, plan.band_rows, plan.tile_rows, plan.tile_cols, plan.kc,
            plan.buf_c, int(plan.smem_bands), stream)
    _cuda.check(lib, err, name)
    launches[name] += 1
    return out


# The two wrappers as the custom ops ``gridnext::fused_hex_corrector`` and
# ``gridnext::fused_hex_corrector_labels`` (weights as ``Tensor[]``, ReLU
# flags as ``bool[]``): torch.export records each call as one node. CPU
# tensors take the plain versions, CUDA tensors the kernel.
_LAYERS = "Tensor[] kernels, Tensor[] biases, bool[] relu_flags"
hex_corrector_op = _cuda.custom_op(
    "fused_hex_corrector", f"(Tensor x, {_LAYERS}) -> Tensor",
    cpu=hex_corrector_plain,
    cuda=lambda x, kernels, biases, relu_flags: _launch(x, kernels, biases, relu_flags,
                                                         None),
    fake=lambda x, kernels, biases, relu_flags: x.new_empty(
        (*x.shape[:3], kernels[-1].shape[2]), dtype=torch.float32))
hex_corrector_labels_op = _cuda.custom_op(
    "fused_hex_corrector_labels", f"(Tensor x, Tensor fg, {_LAYERS}) -> Tensor",
    cpu=hex_corrector_labels_plain,
    cuda=lambda x, fg, kernels, biases, relu_flags: _launch(
        x, kernels, biases, relu_flags, fg.to(torch.int32).contiguous()),
    fake=lambda x, fg, kernels, biases, relu_flags: x.new_empty(
        tuple(x.shape[:3]), dtype=torch.int32))


def _layers(x, kernels, biases, relu_flags):
    """The checked layers as the ops take them: float32 tensors on x's
    device and a list of bools."""
    _check_inputs(x, kernels, biases, relu_flags)
    return (as_f32_tensors(kernels, x.device), as_f32_tensors(biases, x.device),
            [bool(r) for r in relu_flags])


def fused_hex_corrector(x: torch.Tensor, kernels: Sequence, biases: Sequence,
                        relu_flags: Sequence[bool] = CORRECTOR_RELU_FLAGS) -> torch.Tensor:
    """Apply the folded corrector to (B, H, W, C_in) f-output grids.

    Returns (B, H, W, n_classes) float32 logits. Inputs come from
    :func:`fold_corrector_params`. CUDA tensors launch the kernel (one
    launch per call for all layers), CPU tensors run
    :func:`hex_corrector_plain`, both through the custom op
    ``gridnext::fused_hex_corrector``. Replaces the TPU kernel
    ``gridnext_tpu/ops/hexcorrector_pallas.py::fused_hex_corrector``; bound
    by f32 operations, with each grid's layers in one thread-block cluster
    (module docstring).
    """
    return hex_corrector_op(x, *_layers(x, kernels, biases, relu_flags))


def fused_hex_corrector_labels(x: torch.Tensor, fg: torch.Tensor, kernels: Sequence,
                               biases: Sequence,
                               relu_flags: Sequence[bool] = CORRECTOR_RELU_FLAGS
                               ) -> torch.Tensor:
    """Corrector + argmax + background mask: (B, H, W) int32 label grids.

    ``fg``: (B, H, W) foreground mask (nonzero = in-tissue spot). Labels
    are 0 on background and 1..n_classes on foreground; ties take the
    first class, as ``jnp.argmax`` does. CUDA tensors launch the kernel,
    CPU tensors run :func:`hex_corrector_labels_plain`, both through the
    custom op ``gridnext::fused_hex_corrector_labels``. Replaces the TPU
    kernel ``gridnext_tpu/ops/hexcorrector_pallas.py::
    fused_hex_corrector_labels``; the last layer keeps a running argmax per
    cell and writes only the label, at any class count (module docstring).
    """
    layers = _layers(x, kernels, biases, relu_flags)
    if tuple(fg.shape) != tuple(x.shape[:3]):
        raise ValueError(f"fg {tuple(fg.shape)} does not match grids "
                         f"{tuple(x.shape[:3])}")
    return hex_corrector_labels_op(x, fg.to(x.device), *layers)
