"""ReLU-FAVOR linear attention with the feature maps kept on chip.

:func:`fused_generalized_linear_attention` replaces the TPU kernel
``gridnext_tpu/ops/favor_pallas.py::fused_generalized_linear_attention``.
For ``q, k, v`` of shape ``(B, H, N, d)`` and a projection ``proj (m, d)``
it computes, per (b, h)::

    phi(x) = relu((d^-1/4 x) @ proj^T) + 1e-3
    out_n  = (phi(q_n) @ sum_n phi(k_n) v_n^T) / (phi(q_n) . sum_n phi(k_n))

which is :func:`favor_attention_plain` (``generalized_kernel_features``
twice, then ``linear_attention``). On a CUDA tensor it launches the kernels
of ``csrc/favor.cu`` (accumulate, reduce, apply: one call of the C entry
point, counted once in :data:`launches`); on a CPU tensor it runs
:func:`favor_attention_plain`. There is no fallback from one to the other:
a CUDA call the kernel does not take raises.

What bounds the kernel on the card: operations. At scBERT's shape (B 8,
H 10, N 16,907, d 64, m 266) one call is 1.85e11 FLOP. The kernel runs its
four products on the tensor cores in split TF32 (three TF32 products per
f32 product, which keeps the f32 tolerance that one TF32 pass misses):
1.12 ms at the 495 TFLOP/s TF32 peak, against 2.76 ms as f32 FMA on the
CUDA cores and 0.41 ms to move the 1.39 GB of q, k, v and output at
3.35 TB/s. The (B, H, N, m) feature maps, 1.44 GB each at that shape, never
reach device memory (design notes in ``csrc/favor.cu``).
The sequence is split across blocks and the partial sums are reduced in a
fixed order, so a call gives the same bits every time.

Head widths: the tensor-core kernels are compiled for d in
:data:`HEAD_DIMS`; a narrower d is zero-padded to the next of them (the
padded columns add 0 to ``x @ proj^T`` and give zero output columns, which
are sliced away; the scale stays ``d^-1/4`` of the true d). A d above 64
runs the general f32 kernels of the same source, which stage the
contraction in chunks of 32 columns and own 64 output columns a block, so
every d >= 1 runs. Inputs of another dtype are cast to float32, and an
operand whose layout the kernel cannot read is copied to a contiguous
float32 tensor, as the JAX wrapper casts; the output is float32.

Only the forward is a kernel. The call is the custom op
``gridnext::favor_attention``, whose registered backward differentiates
the plain version, as the JAX op's custom VJP differentiates its einsum
path.
"""

from __future__ import annotations

import torch

from gridnext_tpu_torch.ops import _cuda
from gridnext_tpu_torch.ops.favor import generalized_kernel_features, linear_attention

# Calls of the C entry point made by fused_generalized_linear_attention (one
# per call, three kernels each); a plain integer that a run resets and reads
# to show the kernel was used.
launches = 0

HEAD_DIMS = (16, 32, 48, 64)   # head widths the tensor-core kernels are compiled for
_ROWS = 32                 # csrc/favor.cu kRows: sequence rows per accumulate tile
_FEAT_TILE = 16            # csrc/favor.cu kFeatTile: features per warp
_ACC_WARPS_MAX = 6         # csrc/favor.cu kAccWarpsMax: feature tiles per block
_BLOCKS_PER_SM = 16        # accumulate-pass blocks to aim for, per SM
_SPLIT_TILES = 32          # accumulate tiles one split sums in sequence, at most


def favor_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          proj: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ReLU-FAVOR attention (the JAX module's
    ``_einsum_reference``): ``(B, H, N, d)`` float32."""
    q, k, v, proj = (t.float() for t in (q, k, v, proj))
    qf = generalized_kernel_features(q, proj, torch.relu)
    kf = generalized_kernel_features(k, proj, torch.relu)
    return linear_attention(qf, kf, v)


def _check_shapes(q, k, v, proj):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if proj.dim() != 2 or proj.shape[1] != q.shape[-1]:
        raise ValueError(f"proj {tuple(proj.shape)} is not (m, {q.shape[-1]})")


def kernel_width(d: int) -> int:
    """The width the kernel runs a head width ``d`` at: the smallest of
    :data:`HEAD_DIMS` that holds it, or ``d`` itself above them (the
    general kernels)."""
    return next((w for w in HEAD_DIMS if w >= d), d)


def _kernel_operand(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (``(..., d)``) as the kernel reads it: float32 with ``width``
    columns, the last dim contiguous and, for the tensor-core kernels,
    16-byte aligned with element strides that are multiples of 4. ``t``
    itself where it already is, else a contiguous copy (zero-padded to
    ``width``)."""
    d = t.shape[-1]
    if width != d:
        return torch.nn.functional.pad(t.float(), (0, width - d)).contiguous()
    if t.dtype != torch.float32:
        return t.float().contiguous()
    aligned = (t.data_ptr() % 16 == 0 and not any(s % 4 for s in t.stride()[:-1])
               if width in HEAD_DIMS else True)
    return t if t.stride(-1) == 1 and aligned else t.contiguous()


def _splits(bh: int, n: int, m: int, d: int, device) -> int:
    """Sequence ranges per (b, h) of the accumulate pass: enough blocks to
    fill the card, at most one per 32-row tile, and at least one per
    :data:`_SPLIT_TILES` tiles. A split sums its rows' ctx and ksum in one
    f32 chain, whose rounding grows with its length: filling the card alone
    gave 2 splits of 265 tiles at B 64, H 10, N 16,907, and scBERT's
    attention there missed FAVOR's tolerance of its float64 value (rtol
    2e-4, atol 2e-5); 32 tiles a split keep it well inside at every batch
    (``tools/favor_split_precision.py``)."""
    tiles = -(-n // _ROWS)
    m_tiles = -(-m // _FEAT_TILE)
    if d in HEAD_DIMS:
        groups = -(-m_tiles // _ACC_WARPS_MAX)     # blocks per (b, h) and split
    else:                                          # general: 32 features x 64 columns a block
        groups = -(-m_tiles * _FEAT_TILE // 32) * -(-d // 64)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-_BLOCKS_PER_SM * sms // (groups * bh))
    return max(-(-tiles // _SPLIT_TILES), min(tiles, want))


def _launch(q, k, v, proj):
    global launches
    b, h, n, d = q.shape
    m = proj.shape[0]
    if n == 0 or m == 0 or b * h == 0 or d == 0:
        raise ValueError(f"empty FAVOR call: q {tuple(q.shape)}, proj {tuple(proj.shape)}")
    dev = q.device
    if any(t.device != dev for t in (k, v, proj)):
        raise ValueError("q, k, v and proj must be on one device")
    width = kernel_width(d)
    q, k, v = (_kernel_operand(t, width) for t in (q, k, v))
    proj = _kernel_operand(proj.contiguous(), width).contiguous()
    lib = _cuda.library("favor")
    splits = _splits(b * h, n, m, width, dev)
    work = torch.empty(int(lib.favor_workspace_floats(b * h, splits, m, width)),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, h, n, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.favor_attention_f32(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], b, h, n, width, proj.data_ptr(), m, splits,
            float(d) ** -0.25, work.data_ptr(), out.data_ptr(), stream)
    _cuda.check(lib, err, "fused_generalized_linear_attention")
    launches += 1
    return out if width == d else out[..., :d].contiguous()


# The wrapper as the custom op ``gridnext::favor_attention``: torch.export
# records each call as one node. CPU tensors take the plain version, CUDA
# tensors the kernels.
favor_attention_op = _cuda.custom_op(
    "favor_attention", "(Tensor q, Tensor k, Tensor v, Tensor proj) -> Tensor",
    cpu=favor_attention_plain, cuda=_launch,
    fake=lambda q, k, v, proj: q.new_empty(tuple(q.shape), dtype=torch.float32))


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _plain_vjp(ctx, grad):
    """The backward: the plain version's VJP at the saved inputs, as the
    JAX op's custom VJP differentiates its einsum path."""
    needs = ctx.needs_input_grad
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, needs)]
        out = favor_attention_plain(*ins)
        grads = iter(torch.autograd.grad(
            out, [t for t, need in zip(ins, needs) if need], grad.float()))
    return tuple(next(grads) if need else None for need in needs)


favor_attention_op.register_autograd(_plain_vjp, setup_context=_save_inputs)


def fused_generalized_linear_attention(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, proj: torch.Tensor
                                       ) -> torch.Tensor:
    """ReLU-FAVOR linear attention: ``(B, H, N, d)`` float32.

    Args:
      q, k, v: ``(B, H, N, d)``, any head width d >= 1 and any floating
        dtype (cast to float32); on CUDA they may be strided views, read in
        place where the kernel takes their layout and copied otherwise.
      proj: ``(m, d)`` projection (a FastAttention's ``projection``).

    CUDA tensors launch the kernels of ``csrc/favor.cu`` (and raise on an
    empty call or mismatched shapes); CPU tensors run
    :func:`favor_attention_plain`; both through the custom op
    ``gridnext::favor_attention``, whose backward differentiates the plain
    version.
    Replaces the TPU kernel ``gridnext_tpu/ops/favor_pallas.py::
    fused_generalized_linear_attention``; bound by operations (split-TF32
    tensor-core products), with the feature maps made and consumed in
    registers (module docstring).
    """
    _check_shapes(q, k, v, proj)
    return favor_attention_op(q, k, v, proj)
