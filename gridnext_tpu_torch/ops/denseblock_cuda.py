"""Fused DenseNet-BC inference: each dense block through the CUDA kernel.

:func:`fused_dense_block` replaces the TPU kernel
``gridnext_tpu/ops/denseblock_pallas.py::fused_dense_block``. On a CUDA
tensor it launches ``csrc/denseblock.cu``'s ``dense_layer_kernel``, one
launch per layer; on a CPU tensor it runs :func:`fused_dense_block_plain`.
There is no fallback from one to the other. :func:`build_densenet_fused_infer`
runs a whole DenseNet on it (stem, transitions and head in plain PyTorch).

Per layer, with eval-mode BatchNorm folded to per-channel affines
(:func:`fold_dense_block_params`), both versions compute, at the JAX
function's rounding points::

    t = relu(buf * a1 + b1)           # f32, from the bf16 buffer
    u = relu((t @ W1) * a2 + b2)      # 1x1 to Cb, f32 accumulation; rounded to bf16
    w = sum_{9 taps} shift(u) @ W2    # 3x3 zero-padded conv, f32 accumulation
    buf[..., c:c + growth] = bf16(w)  # appended in place

The plain version keeps ``t`` in f32, as the JAX function does when it runs
interpreted on the CPU. The kernel's tensor cores take bf16 operands, so it
rounds ``t`` to bf16 before the 1x1 product, as the TPU's default-precision
f32 dot does; at DenseNet-121's widths the two differ by about one bf16
rounding of ``u`` (``chip_smoke.py`` holds them within 3e-2).

What bounds the kernel on the card: operations and, layer by layer, device
memory. A 624-patch chunk of DenseNet-121 at 128 px does 424 / 291 / 224 /
43 GFLOP in blocks 1-4 (written channels only), 0.43 / 0.29 / 0.23 / 0.043
ms at 989 TFLOP/s bf16, and each layer must read its ``c_in`` written
channels and write ``growth`` (1.24 ms a chunk at 3.35 TB/s). The TPU kernel
kept a batch tile's whole concat buffer in VMEM; on Hopper one patch's
buffer (512 KB in block 1) exceeds a block's 227 KB of shared memory, so the
buffer stays in device memory. What the design keeps on chip is the
bottleneck's output ``u``: one launch per layer computes the 1x1 product
into shared memory and the 3x3 from there, both with ``wgmma`` (A from
registers, B from shared memory, a ``cp.async`` ring). :func:`plan_dense_block`
chooses which pixels a CTA owns: whole patches where a patch's ``u`` fits
four 64-pixel tiles (no halo), else bands of whole rows of one patch with
``u`` recomputed for the row above and below (design notes in
``csrc/denseblock.cu``).

Shapes: the ``wgmma`` kernel takes c_in0, growth and Cb in multiples of 8
with growth <= 32 and Cb <= 128 (DenseNet-BC's widths). Other widths up to
those limits are zero-padded to multiples of 8 (:func:`pad_dense_block`:
zero affines and weight rows and columns make t and u exactly 0 there), run
through it and sliced back. Blocks wider than the limits take the general
route of the same source, two plain f32-FMA launches a layer. The wrapper
chooses by shape (:func:`route`) and counts every launch in
:data:`launches`, the general route's also in :data:`general_launches`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gridnext_tpu_torch.ops import _cuda

# Kernel launches made by fused_dense_block (one a layer on the wgmma route,
# two on the general route), and those of the general route alone; plain
# integers that a run resets and reads to show the kernels were used.
launches = 0
general_launches = 0

_ALIGN = 8  # c_in0, growth and Cb must be multiples of this (16-byte vectors)
CB_MAX, GROWTH_MAX = 128, 32  # the products' N: wgmma n128 (1x1) and n32 (3x3)
TILE = 64                # wgmma M: pixels per warpgroup tile
MAX_WARPGROUPS = 4       # tiles a CTA multiplies at once
SMEM_LIMIT = 232_448     # dynamic shared memory a block may use on sm_90
NUM_SMS = 132            # H100 SXM; steers the patches per CTA only
_BAND_U_TILES = 8        # a band's u holds at most 8 tiles (two rounds of 4)
_BK = 32                 # 1x1 channels per ring stage (csrc/denseblock.cu kBK)


@dataclass(frozen=True)
class DensePlan:
    """How one block's layers tile the pixels over CTAs.

    ``band_rows > 0``: each CTA appends to ``band_rows`` whole rows of one
    patch (the last band of a patch may be shorter) and holds ``u`` for those
    rows plus the row above and below. ``band_rows == 0``: each CTA holds
    ``patches`` whole patches, no halo. ``u_pix`` is the most ``u`` pixels a
    CTA holds; ``smem_bytes`` its dynamic shared memory.
    """
    band_rows: int
    patches: int
    warpgroups: int
    stages: int
    ctas: int
    u_pix: int
    smem_bytes: int


def smem_bytes(u_pix: int, cb: int, warpgroups: int, stages: int) -> int:
    """A CTA's dynamic shared memory (``csrc/denseblock.cu``'s
    dense_block_smem_bytes): the ring (per stage a 64-row tile of 32 channels
    per warpgroup, rows padded to 80 bytes, W1's 32 x 128 bf16 slice and the
    32 channels' f32 a1, b1), which later holds W2's nine taps; u in whole
    64-row tiles with rows of Cb (rounded up to 16) + 8 bf16; a zero row."""
    cbp = -(-cb // 16) * 16
    slot = warpgroups * TILE * (_BK + 8) * 2 + _BK * CB_MAX * 2 + 2 * _BK * 4
    u_rows = -(-u_pix // TILE) * TILE
    return max(stages * slot, 9 * cbp * GROWTH_MAX * 2) + (u_rows + 1) * (cbp + 8) * 2


def _fit(u_pix: int, cb: int, warpgroups: int) -> Optional[int]:
    """The deepest ring (4, 3 or 2 stages) that fits, or None."""
    for stages in (4, 3, 2):
        if smem_bytes(u_pix, cb, warpgroups, stages) <= SMEM_LIMIT:
            return stages
    return None


def plan_dense_block(b: int, h: int, w: int, cb: int, *, band_rows: Optional[int] = None,
                     patches: Optional[int] = None) -> DensePlan:
    """The tile plan of a block on ``b`` patches of ``h x w`` with bottleneck
    width ``cb``.

    Rule: where a patch's u fits four 64-pixel tiles (``h * w <= 256``) a
    CTA takes whole patches, the largest power of two of them that fits four
    tiles while the grid keeps at least half of ``NUM_SMS`` CTAs (one patch
    when no count reaches it),
    with one warpgroup per tile (on an H100, block 4 ran fastest at 78
    CTAs of two warpgroups: ``PERF.md`` §6). Otherwise a CTA takes a band of rows of one patch,
    the most rows whose u (band plus the row above and below) fits eight
    tiles, with four warpgroups; a row whose u alone exceeds eight tiles
    still makes a band of one row. ``band_rows`` or ``patches`` override the
    rule (for timing other plans). The ring is the deepest of 4, 3, 2
    stages that fits :data:`SMEM_LIMIT`; raises ``ValueError`` when none does.
    """
    hw = h * w
    if band_rows is None and (patches is not None or hw <= MAX_WARPGROUPS * TILE):
        if patches is None:
            fits = [1 << i for i in range(8, -1, -1) if (1 << i) * hw <= MAX_WARPGROUPS * TILE]
            patches = next((k for k in fits if -(-b // k) >= NUM_SMS // 2), 1)
        u_pix = patches * hw
        warpgroups = min(MAX_WARPGROUPS, -(-u_pix // TILE))
        stages = _fit(u_pix, cb, warpgroups)
        if stages is not None:
            return DensePlan(0, patches, warpgroups, stages, -(-b // patches), u_pix,
                             smem_bytes(u_pix, cb, warpgroups, stages))
    if band_rows is None:
        band_rows = max(1, min(h, _BAND_U_TILES * TILE // w - 2))
        while band_rows > 1 and _fit((band_rows + 2) * w, cb, MAX_WARPGROUPS) is None:
            band_rows -= 1
    band_rows = min(band_rows, h)
    u_pix = (band_rows + 2) * w
    stages = _fit(u_pix, cb, MAX_WARPGROUPS)
    if stages is None:
        raise ValueError(f"the dense-block kernel cannot hold u for one row of {w} "
                         f"pixels at Cb = {cb} in {SMEM_LIMIT} bytes of shared memory")
    return DensePlan(band_rows, 1, MAX_WARPGROUPS, stages, b * -(-h // band_rows), u_pix,
                     smem_bytes(u_pix, cb, MAX_WARPGROUPS, stages))


def plan_ctas(plan: DensePlan, b: int, h: int, w: int) -> Iterator[tuple]:
    """``(u_first, u_count, out_first, out_count)`` flat pixel ranges of each
    CTA, in grid order, as ``dense_layer_kernel`` derives them from its block
    index (u_first may be negative or reach past the batch: those pixels are
    zero and never read)."""
    hw, m = h * w, b * h * w
    if plan.band_rows:
        bands = -(-h // plan.band_rows)
        for cta in range(plan.ctas):
            patch, y0 = divmod(cta, bands)
            y0 *= plan.band_rows
            rows = min(plan.band_rows, h - y0)
            base = (patch * h + y0 - 1) * w
            yield base, (rows + 2) * w, base + w, rows * w
    else:
        for cta in range(plan.ctas):
            base = cta * plan.patches * hw
            yield base, plan.patches * hw, base, min(plan.patches * hw, m - base)


def _bn_affine(bn_params, bn_stats, eps: float = 1e-5):
    """Eval-mode BatchNorm as ``x * a + b``: (a, b) float numpy arrays."""
    a = np.asarray(bn_params["scale"]) / np.sqrt(np.asarray(bn_stats["var"]) + eps)
    b = np.asarray(bn_params["bias"]) - np.asarray(bn_stats["mean"]) * a
    return a, b


def fold_dense_block_params(block_layers: Sequence[dict], block_stats: Sequence[dict],
                            c_in0: int, growth: int = 32) -> dict:
    """Stack and zero-pad one block's ``_DenseLayer`` params for the kernel.

    ``block_layers``/``block_stats``: the per-layer params / batch_stats
    dicts (``BatchNorm_0``, ``Conv_0`` (1x1), ``BatchNorm_1``, ``Conv_1``
    (3x3)) in layer order, in the JAX package's layout. Returns float32
    numpy arrays ``A1``, ``B1`` (L, Cmax), ``W1`` (L, Cmax, Cb), ``A2``,
    ``B2`` (L, Cb), ``W2`` (L, 9, Cb, growth) with Cmax = c_in0 + L*growth,
    zero beyond each layer's input channels, plus ``c_in0`` and ``growth``:
    the JAX function's outputs and layout.
    """
    n_layers = len(block_layers)
    c_max = c_in0 + n_layers * growth
    cb = np.asarray(block_layers[0]["Conv_0"]["kernel"]).shape[-1]
    out = {"A1": np.zeros((n_layers, c_max), np.float32),
           "B1": np.zeros((n_layers, c_max), np.float32),
           "W1": np.zeros((n_layers, c_max, cb), np.float32),
           "A2": np.zeros((n_layers, cb), np.float32),
           "B2": np.zeros((n_layers, cb), np.float32),
           "W2": np.zeros((n_layers, 9, cb, growth), np.float32)}
    for l, (p, s) in enumerate(zip(block_layers, block_stats)):
        c_in = c_in0 + l * growth
        out["A1"][l, :c_in], out["B1"][l, :c_in] = _bn_affine(p["BatchNorm_0"],
                                                              s["BatchNorm_0"])
        out["W1"][l, :c_in] = np.asarray(p["Conv_0"]["kernel"])[0, 0]
        out["A2"][l], out["B2"][l] = _bn_affine(p["BatchNorm_1"], s["BatchNorm_1"])
        out["W2"][l] = np.asarray(p["Conv_1"]["kernel"]).reshape(9, cb, growth)
    return {**out, "c_in0": c_in0, "growth": growth}


def _as(t, device, dtype) -> torch.Tensor:
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
    return t.to(device, dtype).contiguous()


def _check(x, A1, W1, A2, W2, c_in0: int, growth: int):
    """(n_layers, c_max, cb) after checking the shapes against each other."""
    if x.dim() != 4 or x.shape[-1] != c_in0:
        raise ValueError(f"expected (B, H, W, {c_in0}) input, got {tuple(x.shape)}")
    n_layers, c_max = A1.shape
    cb = A2.shape[1]
    if c_max != c_in0 + n_layers * growth:
        raise ValueError(f"A1 {tuple(A1.shape)} does not match c_in0={c_in0} + "
                         f"{n_layers} layers x growth {growth}")
    if (tuple(W1.shape) != (n_layers, c_max, cb)
            or tuple(W2.shape) != (n_layers, 9, cb, growth)):
        raise ValueError(f"W1 {tuple(W1.shape)} / W2 {tuple(W2.shape)} do not fit "
                         f"L={n_layers}, Cmax={c_max}, Cb={cb}, growth={growth}")
    return n_layers, c_max, cb


def fused_dense_block_plain(x: torch.Tensor, A1, B1, W1, A2, B2, W2, *,
                            c_in0: int, growth: int = 32) -> torch.Tensor:
    """Plain PyTorch dense block at the JAX function's rounding points.

    bf16 values are multiplied as float32 values, so the sums are float32
    sums; ``t`` stays in f32 (module docstring). Each layer reads its
    written channels only (the folded tails are zero).
    """
    n_layers, c_max, cb = _check(x, A1, W1, A2, W2, c_in0, growth)
    dev = x.device
    A1, B1, A2, B2 = (_as(a, dev, torch.float32) for a in (A1, B1, A2, B2))
    W1, W2 = (_as(a, dev, torch.bfloat16).float() for a in (W1, W2))
    b, h, w, _ = x.shape
    buf = torch.empty((b, h, w, c_max), dtype=torch.bfloat16, device=dev)
    buf[..., :c_in0] = x.to(torch.bfloat16)
    for l in range(n_layers):
        c_in = c_in0 + l * growth
        t = torch.relu(buf[..., :c_in].float() * A1[l, :c_in] + B1[l, :c_in])
        u = torch.relu(torch.matmul(t, W1[l, :c_in]) * A2[l] + B2[l])
        up = F.pad(u.to(torch.bfloat16).float(), (0, 0, 1, 1, 1, 1))
        acc = torch.zeros((b, h, w, growth), dtype=torch.float32, device=dev)
        for tap in range(9):
            dr, dc = divmod(tap, 3)
            acc += torch.matmul(up[:, dr:dr + h, dc:dc + w], W2[l, tap])
        buf[..., c_in:c_in + growth] = acc.to(torch.bfloat16)
    return buf


def _up8(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def route(c_in0: int, growth: int, cb: int) -> str:
    """``"wgmma"`` when the block's widths, padded to multiples of 8, fit the
    ``wgmma`` kernel (growth <= 32, Cb <= 128), else ``"general"``."""
    return "wgmma" if _up8(growth) <= GROWTH_MAX and _up8(cb) <= CB_MAX else "general"


def pad_dense_block(A1, B1, W1, A2, B2, W2, *, c_in0: int, growth: int):
    """The block's folded arrays with c_in0, growth and Cb zero-padded to
    multiples of 8, for the ``wgmma`` kernel.

    Returns ``(arrays, c_in0_p, growth_p, keep)``: the six padded tensors
    (same dtypes and device), the padded widths, and ``keep``, the padded
    buffer's channel of each original channel (``buf_p[..., keep]`` is the
    unpadded buffer). Padded channels get zero ``a1``/``b1`` rows of ``W1``,
    padded Cb columns zero ``W1`` columns, ``a2``/``b2`` and ``W2`` rows,
    padded growth columns zero ``W2`` columns, so t and u are exactly 0
    there and every padded channel the block writes is 0.
    """
    n_layers, c_max = A1.shape
    cb = A2.shape[1]
    c0p, gp, cbp = _up8(c_in0), _up8(growth), _up8(cb)
    keep = torch.tensor([c if c < c_in0 else c0p + (c - c_in0) // growth * gp + (c - c_in0) % growth
                         for c in range(c_max)], device=A1.device)
    c_max_p = c0p + n_layers * gp

    def padded(t, shape):
        return t.new_zeros(shape)

    a1, b1 = padded(A1, (n_layers, c_max_p)), padded(B1, (n_layers, c_max_p))
    a1[:, keep], b1[:, keep] = A1, B1
    w1 = padded(W1, (n_layers, c_max_p, cbp))
    w1[:, keep, :cb] = W1
    a2, b2 = padded(A2, (n_layers, cbp)), padded(B2, (n_layers, cbp))
    a2[:, :cb], b2[:, :cb] = A2, B2
    w2 = padded(W2, (n_layers, 9, cbp, gp))
    w2[:, :, :cb, :growth] = W2
    return (a1, b1, w1, a2, b2, w2), c0p, gp, keep


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is not 16-byte aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_dense_block(x: torch.Tensor, A1, B1, W1, A2, B2, W2, *, c_in0: int,
                      growth: int = 32) -> torch.Tensor:
    """Run one dense block: (B, H, W, c_in0) -> bf16 (B, H, W, c_in0 + L*growth).

    The arrays come from :func:`fold_dense_block_params` (numpy arrays or
    tensors; pass them already on the device, ``A*``/``B*`` in float32 and
    ``W*`` in bf16, to skip the conversion on every call). ``x`` is cast to
    bf16. On a CUDA tensor this launches ``csrc/denseblock.cu``'s
    ``dense_layer_kernel`` once per layer, tiled by :func:`plan_dense_block`
    (widths that are not multiples of 8 zero-padded by
    :func:`pad_dense_block`), or, where growth exceeds 32 or Cb 128, the
    general route's two kernels a layer (:func:`route`); on a CPU tensor it
    runs :func:`fused_dense_block_plain`. Every shape runs. The JAX
    function's ``batch_tile`` and ``interpret`` exist only for the TPU and
    are not taken. Replaces the TPU kernel
    ``gridnext_tpu/ops/denseblock_pallas.py::fused_dense_block``; bound by
    operations (module docstring).
    """
    if x.device.type == "cpu":
        return fused_dense_block_plain(x, A1, B1, W1, A2, B2, W2, c_in0=c_in0,
                                       growth=growth)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n_layers, c_max, cb = _check(x, A1, W1, A2, W2, c_in0, growth)
    b, h, w, _ = x.shape
    if route(c_in0, growth, cb) == "general":
        buf = torch.empty((b, h, w, c_max), dtype=torch.bfloat16, device=x.device)
        buf[..., :c_in0] = x
        return _launch_general(buf, A1, B1, W1, A2, B2, W2, c_in0=c_in0, growth=growth)
    if (_up8(c_in0), _up8(growth), _up8(cb)) == (c_in0, growth, cb):
        buf = torch.empty((b, h, w, c_max), dtype=torch.bfloat16, device=x.device)
        buf[..., :c_in0] = x
        return _launch(buf, A1, B1, W1, A2, B2, W2, c_in0=c_in0, growth=growth)
    dev = x.device
    arrays = [_as(a, dev, torch.float32) for a in (A1, B1)] + [_as(W1, dev, torch.bfloat16)] \
        + [_as(a, dev, torch.float32) for a in (A2, B2)] + [_as(W2, dev, torch.bfloat16)]
    padded, c0p, gp, keep = pad_dense_block(*arrays, c_in0=c_in0, growth=growth)
    buf = torch.zeros((b, h, w, c0p + n_layers * gp), dtype=torch.bfloat16, device=dev)
    buf[..., :c_in0] = x
    _launch(buf, *padded, c_in0=c0p, growth=gp)
    return buf[..., keep]


def _launch_general(buf: torch.Tensor, A1, B1, W1, A2, B2, W2, *, c_in0: int,
                    growth: int) -> torch.Tensor:
    """The general route on a contiguous bf16 CUDA ``buf`` (B, H, W, Cmax)
    whose first ``c_in0`` channels hold the input: two launches a layer."""
    global launches, general_launches
    n_layers, c_max, cb = _check(buf[..., :c_in0], A1, W1, A2, W2, c_in0, growth)
    if buf.dtype != torch.bfloat16 or not buf.is_contiguous() or buf.shape[-1] != c_max:
        raise ValueError("buf must be a contiguous bf16 (B, H, W, Cmax) tensor")
    dev = buf.device
    a1, b1, a2, b2 = (_as(a, dev, torch.float32) for a in (A1, B1, A2, B2))
    w1, w2 = (_as(a, dev, torch.bfloat16) for a in (W1, W2))
    b, h, w, _ = buf.shape
    if buf.numel() == 0 or n_layers == 0:
        return buf
    u = torch.empty((b * h * w, cb), dtype=torch.bfloat16, device=dev)
    lib = _cuda.library("denseblock")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_block_general_bf16(
            buf.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1.data_ptr(),
            a2.data_ptr(), b2.data_ptr(), w2.data_ptr(), b, h, w, c_in0, growth,
            n_layers, cb, u.data_ptr(), stream)
    _cuda.check(lib, err, "fused_dense_block (general route)")
    launches += 2 * n_layers
    general_launches += 2 * n_layers
    return buf


def _launch(buf: torch.Tensor, A1, B1, W1, A2, B2, W2, *, c_in0: int, growth: int,
            plan: Optional[DensePlan] = None) -> torch.Tensor:
    """Run the block's layers in place on a contiguous bf16 CUDA ``buf``
    (B, H, W, Cmax) whose first ``c_in0`` channels hold the input; the other
    channels may hold anything. ``plan`` defaults to
    :func:`plan_dense_block`'s."""
    global launches
    n_layers, c_max, cb = _check(buf[..., :c_in0], A1, W1, A2, W2, c_in0, growth)
    if c_in0 % _ALIGN or growth % _ALIGN or cb % _ALIGN:
        raise ValueError(f"the dense-block kernel takes c_in0, growth and Cb in "
                         f"multiples of {_ALIGN}, got {c_in0}, {growth}, {cb}")
    if growth > GROWTH_MAX or cb > CB_MAX:
        raise ValueError(f"the dense-block kernel takes growth <= {GROWTH_MAX} and "
                         f"Cb <= {CB_MAX}, got {growth}, {cb}")
    if (buf.dtype != torch.bfloat16 or not buf.is_contiguous() or buf.shape[-1] != c_max
            or buf.data_ptr() % 16):
        raise ValueError("buf must be a contiguous, 16-byte aligned bf16 (B, H, W, Cmax) tensor")
    dev = buf.device
    a1, b1, a2, b2 = (_aligned(_as(a, dev, torch.float32)) for a in (A1, B1, A2, B2))
    w1, w2 = (_aligned(_as(a, dev, torch.bfloat16)) for a in (W1, W2))
    b, h, w, _ = buf.shape
    if buf.numel() == 0 or n_layers == 0:
        return buf
    plan = plan or plan_dense_block(b, h, w, cb)
    lib = _cuda.library("denseblock")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_block_bf16(
            buf.data_ptr(), a1.data_ptr(), b1.data_ptr(), w1.data_ptr(),
            a2.data_ptr(), b2.data_ptr(), w2.data_ptr(), b, h, w, c_in0, growth,
            n_layers, cb, plan.band_rows, plan.patches, plan.warpgroups, plan.stages,
            stream)
    _cuda.check(lib, err, "fused_dense_block")
    launches += n_layers
    return buf


# ---------------------------------------------------------------------------
# Whole-net fused inference: stem, transitions and head in plain PyTorch
# ---------------------------------------------------------------------------


def build_densenet_fused_infer(variables: dict, block_config=(6, 12, 24, 16),
                               num_init_features: int = 64, growth: int = 32,
                               compression: float = 0.5, device="cuda"):
    """``infer(x (N, P, P, 3) float) -> (N, classes) f32 logits`` with every
    dense block through :func:`fused_dense_block`.

    ``variables``: a flax ``DenseNet`` tree (``params``, ``batch_stats``)
    of a model with the 7x7 stem (``small_inputs=False``) and a
    classifier. The weights are folded, converted (bf16 convs, f32
    affines) and moved to ``device`` once, here. Inference semantics only,
    at the JAX function's rounding points: the stem conv in bf16, its
    BatchNorm, ReLU and max-pool in f32, each block in bf16, each
    transition's ReLU(BN) rounded to bf16 and its 1x1 product and 2x2 mean
    in f32, the head in f32. The transition pools before its 1x1 product
    (both linear, so equal up to the order of the f32 sums), which makes
    the f32 product 4x smaller. Replaces ``gridnext_tpu/ops/
    denseblock_pallas.py::build_densenet_fused_infer``; its ``batch_tiles``
    and ``interpret`` exist only for the TPU.
    """
    from gridnext_tpu_torch.serving import resolve_device

    dev = resolve_device(device)
    params, stats = variables["params"], variables["batch_stats"]

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    def affine(name, sub=None):
        p, s = params[name], stats[name]
        if sub is not None:
            p, s = p[sub], s[sub]
        return tuple(f32(v) for v in _bn_affine(p, s))

    # stem: HWIO -> OIHW bf16
    conv0 = f32(np.asarray(params["conv0"]["kernel"]).transpose(3, 2, 0, 1)) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    stem = affine("BatchNorm_0")
    blocks, transitions = [], []
    layer_idx, num_features = 0, num_init_features
    for bi, n_layers in enumerate(block_config):
        names = [f"_DenseLayer_{layer_idx + j}" for j in range(n_layers)]
        layer_idx += n_layers
        folded = fold_dense_block_params([params[n] for n in names],
                                         [stats[n] for n in names], num_features,
                                         growth)
        blocks.append({**{k: f32(folded[k]) for k in ("A1", "B1", "A2", "B2")},
                       **{k: f32(folded[k]).to(torch.bfloat16) for k in ("W1", "W2")},
                       "c_in0": num_features, "growth": growth})
        num_features += n_layers * growth
        if bi != len(block_config) - 1:
            name = f"_Transition_{bi}"
            kernel = np.asarray(params[name]["Conv_0"]["kernel"])[0, 0]
            # bf16-valued weights, multiplied in f32
            transitions.append((*affine(name, "BatchNorm_0"),
                                f32(kernel).to(torch.bfloat16).float()))
            num_features = int(num_features * compression)
    final = affine("BatchNorm_1")
    cls_k = f32(params["classifier"]["kernel"])
    cls_b = f32(params["classifier"]["bias"])

    def infer(x: torch.Tensor) -> torch.Tensor:
        x = x.to(dev, torch.bfloat16).permute(0, 3, 1, 2)        # NCHW view, NHWC memory
        x = F.conv2d(x, conv0, stride=2, padding=3)              # bf16 out, as XLA's
        x = torch.relu(x.float() * stem[0][:, None, None] + stem[1][:, None, None])
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = x.permute(0, 2, 3, 1).to(torch.bfloat16)             # NHWC
        for bi, blk in enumerate(blocks):
            x = fused_dense_block(x, blk["A1"], blk["B1"], blk["W1"], blk["A2"],
                                  blk["B2"], blk["W2"], c_in0=blk["c_in0"],
                                  growth=blk["growth"])
            if bi < len(transitions):
                ta, tb, tw = transitions[bi]
                t = torch.relu(x.float() * ta + tb).to(torch.bfloat16).float()
                n, hh, ww, c = t.shape
                t = t[:, :hh - hh % 2, :ww - ww % 2]             # VALID pool floors
                t = t.reshape(n, hh // 2, 2, ww // 2, 2, c).mean((2, 4))
                x = torch.matmul(t, tw).to(torch.bfloat16)
        x = torch.relu(x.float() * final[0] + final[1]).mean(dim=(1, 2))
        return x @ cls_k + cls_b

    return infer
