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

A sequence sharded over ranks (the ``seq`` mesh axis of sequence-parallel
MLM) needs ctx and ksum summed over the ranks between the two halves, as
the TPU kernel's two ``pallas_call``s (accumulate ``:142``, apply ``:161``)
are apart: with ``seq_group``, :func:`fused_generalized_linear_attention`
runs the custom op ``gridnext::favor_accumulate`` (the accumulate and
reduce launches, C entry ``favor_accumulate_f32``), sums (ctx, ksum) over
the group (:func:`seq_sum`, whose backward sums the gradients too), then
``gridnext::favor_apply`` (the apply launch, ``favor_apply_f32``). Each
half is counted in its own counter (:data:`accumulate_launches`,
:data:`apply_launches`) and has the plain version's VJP as its backward.
The accumulate pass sizes its splits (:func:`_splits`) from the rank's own
rows, so a sharded sequence sums its float32 partials in another order
than one process does (``ROADMAP.md`` Queue 3 item 19). Without a group
the one-process path calls ``favor_attention_f32`` alone, as before.
"""

from __future__ import annotations

import torch

from gridnext_tpu_torch.ops import _cuda
from gridnext_tpu_torch.ops.favor import (generalized_kernel_features, linear_apply,
                                          linear_context)

# Calls of the C entry point made by fused_generalized_linear_attention (one
# per call, three kernels each); a plain integer that a run resets and reads
# to show the kernel was used.
launches = 0
# Calls of favor_accumulate_f32 (two kernels) and favor_apply_f32 (one
# kernel): the halves a seq group runs apart.
accumulate_launches = 0
apply_launches = 0

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
    return favor_apply_plain(q, proj, *favor_accumulate_plain(k, v, proj))


def favor_accumulate_plain(k: torch.Tensor, v: torch.Tensor, proj: torch.Tensor):
    """The accumulate half of :func:`favor_attention_plain`: ``(ctx (B, H,
    m, d), ksum (B, H, m))`` float32, sums over the sequence."""
    kf = generalized_kernel_features(k.float(), proj.float(), torch.relu)
    return linear_context(kf, v)


def favor_apply_plain(q: torch.Tensor, proj: torch.Tensor, ctx: torch.Tensor,
                      ksum: torch.Tensor) -> torch.Tensor:
    """The apply half: ``(B, H, N, d)`` float32 from q and the (summed)
    ``ctx`` and ``ksum``."""
    qf = generalized_kernel_features(q.float(), proj.float(), torch.relu)
    return linear_apply(qf, ctx.float(), ksum.float())


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


def _prologue(x, proj, *others):
    """(b, h, n, d, m, width, proj as the kernels read it) of a launch
    over ``x`` ``(B, H, N, d)``; raises on an empty call or operands on
    several devices."""
    b, h, n, d = x.shape
    m = proj.shape[0]
    if n == 0 or m == 0 or b * h == 0 or d == 0:
        raise ValueError(f"empty FAVOR call: q {tuple(x.shape)}, proj {tuple(proj.shape)}")
    if any(t.device != x.device for t in (proj, *others)):
        raise ValueError("q, k, v, proj (and ctx, ksum) must be on one device")
    width = kernel_width(d)
    return b, h, n, d, m, width, _kernel_operand(proj.contiguous(), width).contiguous()


def _launch(q, k, v, proj):
    global launches
    b, h, n, d, m, width, proj = _prologue(q, proj, k, v)
    dev = q.device
    q, k, v = (_kernel_operand(t, width) for t in (q, k, v))
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


def _accumulate_launch(k, v, proj):
    global accumulate_launches
    b, h, n, d, m, width, proj = _prologue(k, proj, v)
    dev = k.device
    k, v = (_kernel_operand(t, width) for t in (k, v))
    lib = _cuda.library("favor")
    splits = _splits(b * h, n, m, width, dev)
    work = torch.empty(int(lib.favor_workspace_floats(b * h, splits, m, width)),
                       dtype=torch.float32, device=dev)
    ctx = torch.empty((b, h, m, width), dtype=torch.float32, device=dev)
    ksum = torch.empty((b, h, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.favor_accumulate_f32(
            k.data_ptr(), *k.stride()[:3], v.data_ptr(), *v.stride()[:3], b, h, n, width,
            proj.data_ptr(), m, splits, float(d) ** -0.25, work.data_ptr(), ctx.data_ptr(),
            ksum.data_ptr(), stream)
    _cuda.check(lib, err, "favor_accumulate")
    accumulate_launches += 1
    return (ctx if width == d else ctx[..., :d].contiguous()), ksum


def _apply_launch(q, proj, ctx, ksum):
    global apply_launches
    b, h, n, d, m, width, proj = _prologue(q, proj, ctx, ksum)
    if tuple(ctx.shape) != (b, h, m, d) or tuple(ksum.shape) != (b, h, m):
        raise ValueError(f"ctx {tuple(ctx.shape)} / ksum {tuple(ksum.shape)} are not "
                         f"{(b, h, m, d)} / {(b, h, m)}")
    dev = q.device
    q = _kernel_operand(q, width)
    ctx = _kernel_operand(ctx, width).contiguous()
    ksum = ksum.float().contiguous()
    lib = _cuda.library("favor")
    work = torch.empty(int(lib.favor_apply_workspace_floats(b * h, m, width)),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, h, n, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.favor_apply_f32(
            q.data_ptr(), *q.stride()[:3], b, h, n, width, proj.data_ptr(), m, ctx.data_ptr(),
            ksum.data_ptr(), float(d) ** -0.25, work.data_ptr(), out.data_ptr(), stream)
    _cuda.check(lib, err, "favor_apply")
    apply_launches += 1
    return out if width == d else out[..., :d].contiguous()


# The two halves as the custom ops ``gridnext::favor_accumulate`` and
# ``gridnext::favor_apply``.
favor_accumulate_op = _cuda.custom_op(
    "favor_accumulate", "(Tensor k, Tensor v, Tensor proj) -> (Tensor, Tensor)",
    cpu=favor_accumulate_plain, cuda=_accumulate_launch,
    fake=lambda k, v, proj: (k.new_empty(tuple(k.shape[:2]) + (proj.shape[0], k.shape[3]),
                                         dtype=torch.float32),
                             k.new_empty(tuple(k.shape[:2]) + (proj.shape[0],),
                                         dtype=torch.float32)))
favor_apply_op = _cuda.custom_op(
    "favor_apply", "(Tensor q, Tensor proj, Tensor ctx, Tensor ksum) -> Tensor",
    cpu=favor_apply_plain, cuda=_apply_launch,
    fake=lambda q, proj, ctx, ksum: q.new_empty(tuple(q.shape), dtype=torch.float32))


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _plain_vjp_of(plain):
    """The backward of an op whose plain version is ``plain``: its VJP at
    the saved inputs, as the JAX op's custom VJP differentiates its einsum
    path."""
    def vjp(ctx, *grads):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().float().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            outs = plain(*ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g.float()) for o, g in zip(outs, grads) if g is not None]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], [t for t, need in zip(ins, needs) if need],
                [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if need else None for need in needs)

    return vjp


favor_attention_op.register_autograd(_plain_vjp_of(favor_attention_plain),
                                     setup_context=_save_inputs)
favor_accumulate_op.register_autograd(_plain_vjp_of(favor_accumulate_plain),
                                      setup_context=_save_inputs)
favor_apply_op.register_autograd(_plain_vjp_of(favor_apply_plain), setup_context=_save_inputs)


def seq_sum(ctx: torch.Tensor, ksum: torch.Tensor, group):
    """(ctx, ksum) summed over the ranks of ``group`` (a ``seq`` axis), one
    all-reduce of both, counted in ``collectives.COUNTS["favor_seq"]``.
    Differentiable: each rank's ctx and ksum reach every rank's queries,
    so the backward sums the gradients over the group too
    (``collectives.all_reduce``)."""
    from gridnext_tpu_torch.parallel import collectives

    collectives.COUNTS["favor_seq"] += 1
    flat = collectives.all_reduce(torch.cat([ctx.reshape(-1), ksum.reshape(-1)]).float(), group)
    return flat[:ctx.numel()].view(ctx.shape), flat[ctx.numel():].view(ksum.shape)


def fused_generalized_linear_attention(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, proj: torch.Tensor,
                                       seq_group=None) -> torch.Tensor:
    """ReLU-FAVOR linear attention: ``(B, H, N, d)`` float32.

    Args:
      q, k, v: ``(B, H, N, d)``, any head width d >= 1 and any floating
        dtype (cast to float32); on CUDA they may be strided views, read in
        place where the kernel takes their layout and copied otherwise.
      proj: ``(m, d)`` projection (a FastAttention's ``projection``).
      seq_group: the process group of the ranks that hold the other rows
        of each sequence (a ``seq`` mesh axis), or None: one process holds
        every row and the fused entry runs alone.

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
    if seq_group is None:
        return favor_attention_op(q, k, v, proj)
    ctx, ksum = seq_sum(*favor_accumulate_op(k, v, proj), seq_group)
    return favor_apply_op(q, proj, ctx, ksum)
