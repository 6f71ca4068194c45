"""Performer (FAVOR+ linear-attention transformer) in PyTorch.

Port of ``gridnext_tpu/models/performer.py``: ``FastAttention`` (softmax
and generalized random features, ``no_projection``, causal attention as a
chunked prefix scan, ``sow_attention``), the rotary helpers (the
half-rotation convention of the local heads, the interleaved one of the
global heads), ``local_block_attention``, ``SelfAttention`` with a
global/local head split, ``FeedForward`` (exact GELU, GLU, chunks),
``Performer`` with pre-LayerNorm, ScaleNorm or ReZero residuals and
optional activation checkpointing (``remat``), ``PerformerLM`` (token
embedding, gene2vec / absolute / no positional embedding, a tied or
separate head, the final LayerNorm) and :func:`redraw_projections`. The
dropouts of the JAX modules act in train mode, through
:class:`~gridnext_tpu_torch.models.layers.Dropout`.

Each ``FastAttention`` holds its projection in a ``projection`` buffer (the
JAX package's ``favor`` collection; the weight bridge fills it). With
generalized ReLU features on CUDA tensors, non-causal and projected, it
calls :func:`~gridnext_tpu_torch.ops.favor_cuda.fused_generalized_linear_attention`
(the CUDA kernel); otherwise the plain ops of
:mod:`gridnext_tpu_torch.ops.favor`. The causal scan, the local heads and
the rotary embeddings are plain torch (XLA in the JAX package).

flax's ``LayerNorm`` epsilon is 1e-6 (torch's default is 1e-5) and its
GELU here is the exact (erf) one; both are set explicitly.

Sequence parallelism (the ``seq`` mesh axis): :func:`shard_sequence` gives
the modules a :class:`~gridnext_tpu_torch.parallel.collectives.TokenShard`
(this rank's columns of the token axis and the group of ranks holding the
rest), and every token-mixing operation computes what one process computes
on the whole sequence, through all-reduce SUMs over the group
(:mod:`~gridnext_tpu_torch.parallel.collectives`):

* FAVOR sums its ctx and ksum over the group between its accumulate and
  apply halves, on the kernel and the plain route alike (one all-reduce);
* softmax features first gather each rank's ``(B, H)`` key maximum and
  take the largest (the gradient reaches the rank that holds it);
* the causal scan gathers every rank's (ctx, ksum) totals and starts from
  the sum of the lower ranks';
* ``no_projection`` takes its softmax over tokens across the group (the
  maximum gathered, the sum all-reduced); its causal key side subtracts
  the maximum of the whole global tensor, over the group that spans the
  global batch's rows too (``collectives.batch_norm_group``) where a
  trainer sets one;
* the local heads gather their keys, values and key mask over the group
  and compute only the query blocks of the rank's tokens, with global
  rotary positions and one process's attention-dropout mask;
* ``sow_attention`` gathers the key features: :attr:`FastAttention.
  attention` holds the rank's query rows over every key;

and the positional embeddings and rotary angles take the rank's positions.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gridnext_tpu_torch.models.layers import Dropout
from gridnext_tpu_torch.parallel import collectives
from gridnext_tpu_torch.ops.favor import (causal_linear_attention,
                                          generalized_kernel_features,
                                          implicit_attention_weights, linear_apply,
                                          linear_attention, linear_context,
                                          orthogonal_gaussian_matrix,
                                          softmax_kernel_features)
from gridnext_tpu_torch.ops.favor_cuda import fused_generalized_linear_attention, seq_sum

LAYER_NORM_EPS = 1e-6   # flax nn.LayerNorm's default
REZERO_INIT = 1e-3      # the ReZero gain's initial value


def default_nb_features(dim_head: int) -> int:
    """FAVOR+ random-feature count m = d ln d (266 at d = 64)."""
    return int(dim_head * math.log(dim_head))


def _is_relu(fn: Callable) -> bool:
    return fn is torch.relu or fn is F.relu


def shard_sequence(model: nn.Module, shard) -> None:
    """Give every module of ``model`` that reads it the token shard
    ``shard`` (a :class:`~gridnext_tpu_torch.parallel.collectives.TokenShard`,
    or None for a whole sequence): every token-mixing operation then
    reduces over ``shard.group`` (the module docstring says how). The
    trainers set it around a sequence-parallel run."""
    for m in model.modules():
        if hasattr(type(m), "seq_shard"):
            m.seq_shard = shard


class FastAttention(nn.Module):
    """FAVOR+ attention core over ``(B, H, N, dh)`` q/k/v.

    ``sow_attention`` (non-causal only): each forward stores the head-mean
    absolute implicit attention weights, ``(B, N, N)``, in
    :attr:`attention` (the JAX module sows them into ``intermediates``);
    O(N^2) memory. ``ortho_scaling`` is the projection's row scaling (see
    :func:`~gridnext_tpu_torch.ops.favor.orthogonal_gaussian_matrix`).
    ``dtype`` is a storage hint only, as in the JAX module: the feature
    maps stay float32. ``seq_shard`` (set by :func:`shard_sequence`): the
    rows of each sequence are split over its group's ranks, and each
    reduction over them spans the group: (ctx, ksum) are summed (one
    all-reduce; ``favor_seq``); softmax features gather each rank's
    ``(B, H)`` key maximum; the causal scan gathers each rank's (ctx,
    ksum) totals and starts from the lower ranks' sum; ``no_projection``
    gathers the keys' maximum over tokens and sums their exponentials
    (causal: the maximum of the whole tensor, over the trainers' batch
    group where one is set); ``sow_attention`` gathers the key features,
    and :attr:`attention` holds ``(B, n_local, N)``, this rank's query
    rows over every key (each ``token_mix``).
    """

    seq_shard = None

    def __init__(self, dim_head: int, nb_features: Optional[int] = None,
                 causal: bool = False, generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, no_projection: bool = False,
                 sow_attention: bool = False, ortho_scaling: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.causal = causal
        self.generalized_attention = generalized_attention
        self.kernel_fn = kernel_fn
        self.no_projection = no_projection
        self.sow_attention = sow_attention
        self.ortho_scaling = ortho_scaling
        self.dtype = dtype
        self.attention: Optional[torch.Tensor] = None
        if not no_projection:
            nb = nb_features or default_nb_features(dim_head)
            self.register_buffer("projection",
                                 orthogonal_gaussian_matrix(nb, dim_head, ortho_scaling))

    def _features(self, q, k, group):
        """(query, key) feature maps; ``group``: the ranks holding the
        sequence's other rows, or None."""
        if self.no_projection:
            qf = torch.softmax(q, dim=-1)
            if self.causal:
                # jnp.max(k) in the JAX module: every row and token of the global tensor
                wide = collectives.batch_norm_group()
                wide = group if wide is None else wide
                top = k.max() if wide is None else collectives.rank_max(k.max(), wide)
                return qf, torch.exp(k - top)
            if group is None:
                return qf, torch.softmax(k, dim=-2)
            # the softmax over tokens across the group; its maximum only stabilises
            top = collectives.rank_max(k.detach().amax(dim=-2, keepdim=True), group)
            e = torch.exp(k - top)
            return qf, e / collectives.token_sum(e.sum(dim=-2, keepdim=True), group)
        proj = self.projection
        if self.generalized_attention:
            return (generalized_kernel_features(q, proj, self.kernel_fn),
                    generalized_kernel_features(k, proj, self.kernel_fn))
        key_max = None if group is None else (lambda m: collectives.rank_max(m, group))
        return (softmax_kernel_features(q, proj, is_query=True),
                softmax_kernel_features(k, proj, is_query=False, key_max=key_max))

    def _kernel(self, q, k, v, group):
        # a whole sequence keeps the wrapper's four-argument call, which
        # callers may swap for the plain version
        if group is None:
            return fused_generalized_linear_attention(q, k, v, self.projection)
        return fused_generalized_linear_attention(q, k, v, self.projection, seq_group=group)

    def forward(self, q, k, v):
        shard = self.seq_shard
        group = None if shard is None else shard.group
        kernel = (not self.causal and not self.no_projection and self.generalized_attention
                  and _is_relu(self.kernel_fn) and q.device.type == "cuda")
        if kernel and not self.sow_attention:
            return self._kernel(q, k, v, group)
        qf, kf = self._features(q, k, group)
        if self.sow_attention and not self.causal:
            keys = kf if shard is None else collectives.gather_tokens(kf.detach(), -2, shard)
            self.attention = implicit_attention_weights(qf, keys).abs().mean(dim=-3)
        if kernel:
            return self._kernel(q, k, v, group)
        if shard is None:
            return (causal_linear_attention if self.causal else linear_attention)(qf, kf, v)
        ctx, ksum = linear_context(kf, v)
        if not self.causal:
            return linear_apply(qf, *seq_sum(ctx, ksum, group))
        # the scan starts from the totals of the tokens on the lower ranks
        flat = collectives.lower_ranks_sum(torch.cat([ctx.reshape(-1), ksum.reshape(-1)]),
                                           group)
        init = flat[:ctx.numel()].view(ctx.shape), flat[ctx.numel():].view(ksum.shape)
        return causal_linear_attention(qf, kf, v, init=init)


# -- rotary embeddings -----------------------------------------------------------


def sinusoidal_rotary_freqs(n: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Rotary angles of the half-rotation (GPT-NeoX) convention, ``(n, dim)``:
    theta_i = 10000^(-2i/dim), each frequency twice (once a half-dim)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=dtype, device=device) / dim))
    freqs = torch.arange(n, dtype=dtype, device=device)[:, None] * inv[None, :]
    return torch.cat([freqs, freqs], dim=-1)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotary_half(t, freqs):
    return t * freqs.cos() + _rotate_half(t) * freqs.sin()


def apply_rotary_pos_emb(q, k, freqs):
    """Half-rotation rotary on q and k ``(..., N, d)`` with angles ``freqs``
    ``(N, d)`` (the local heads' convention)."""
    return _rotary_half(q, freqs), _rotary_half(k, freqs)


def interleaved_rotary_angles(n: int, dim: int, dtype=torch.float32, device=None,
                              offset: int = 0) -> torch.Tensor:
    """Rotary angles of the interleaved (GPT-J) convention, ``(n, dim // 2)``:
    one angle per adjacent (2i, 2i+1) pair, at positions ``offset`` ..
    ``offset + n - 1``."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=dtype, device=device) / dim))
    return torch.arange(offset, offset + n, dtype=dtype, device=device)[:, None] * inv[None, :]


def _rotate_every_two(x):
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def apply_rotary_interleaved(q, k, angles):
    """Interleaved-pair rotary on q and k ``(..., N, d)``: each pair (2i,
    2i+1) rotated by ``angles[pos, i]`` (the global heads' convention)."""
    sin = angles.sin().repeat_interleave(2, dim=-1)
    cos = angles.cos().repeat_interleave(2, dim=-1)
    return q * cos + _rotate_every_two(q) * sin, k * cos + _rotate_every_two(k) * sin


# -- local attention -------------------------------------------------------------


def local_block_attention(q, k, v, window: int, causal: bool = False, mask=None,
                          rel_pos: bool = False, attn_dropout: Optional[Dropout] = None,
                          q_start: int = 0) -> torch.Tensor:
    """Blockwise local softmax attention over ``(B, H, N, d)`` k/v.

    The sequence is padded to whole blocks of ``window``; each block attends
    to itself and the block before it (and after it, unless ``causal``).
    ``rel_pos`` applies half-rotation rotary embeddings after the padding.
    ``mask`` (B, N) bool marks the keys to keep; padded positions, blocks
    beyond either end and (causal) later positions are masked too, and a
    query whose keys are all masked gets zeros. ``attn_dropout`` acts on
    the softmax weights.

    ``q`` ``(B, H, n, d)`` holds the queries at positions ``q_start`` ..
    ``q_start + n - 1`` (by default all N): only the blocks that hold them
    are computed, and ``attn_dropout`` takes these blocks of one process's
    mask (a rank's tokens on a ``seq`` axis, k and v gathered).
    """
    b, h, nq, d = q.shape
    n = k.shape[2]
    pad = (-n) % window
    nb = (n + pad) // window
    if mask is not None:
        mask = mask.to(torch.bool)
        if pad:
            mask = F.pad(mask, (0, pad))
    if pad:
        k, v = (F.pad(t, (0, 0, 0, pad)) for t in (k, v))
    g0, g1 = q_start // window, -(-(q_start + nq) // window)   # the query blocks
    lead = q_start - g0 * window
    q = F.pad(q, (0, 0, lead, g1 * window - q_start - nq))
    if rel_pos:
        freqs = sinusoidal_rotary_freqs(nb * window, d, q.dtype, q.device)
        q, k = _rotary_half(q, freqs[g0 * window:g1 * window]), _rotary_half(k, freqs)
    dev = q.device
    blk = torch.arange(g0, g1, device=dev)
    qb = q.reshape(b, h, g1 - g0, window, d)
    kb, vb = (t.reshape(b, h, nb, window, d) for t in (k, v))
    offs = [-1, 0] + ([] if causal else [1])
    near = [(blk + o).clamp(0, nb - 1) for o in offs]      # blocks beyond either end: masked
    kcat = torch.cat([kb[:, :, i] for i in near], dim=3)
    vcat = torch.cat([vb[:, :, i] for i in near], dim=3)
    scores = torch.einsum("bhgnd,bhgmd->bhgnm", qb, kcat) / math.sqrt(d)

    within = torch.arange(window, device=dev)
    seq_pos = blk[:, None] * window + within[None, :]                     # (G, w)
    valid = torch.cat([((blk + o >= 0) & (blk + o < nb))[:, None].expand(len(blk), window)
                       for o in offs], dim=1)                              # (G, k w)
    col_pos = torch.cat([(blk + o)[:, None] * window + within[None, :] for o in offs], dim=1)
    m = valid[None, None, :, None, :] & (col_pos < n)[None, None, :, None, :]
    if causal:
        m = m & (col_pos[None, None, :, None, :] <= seq_pos[None, None, :, :, None])
    if mask is not None:
        key_mask = mask[:, col_pos.clamp(0, mask.shape[1] - 1)]            # (B, G, k w)
        m = m & key_mask[:, None, :, None, :]
    m = m.expand(scores.shape)
    scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(m.any(dim=-1, keepdim=True), attn, torch.zeros_like(attn))
    if attn_dropout is not None:
        attn = attn_dropout(attn, span=(2, nb, g0))
    out = torch.einsum("bhgnm,bhgmd->bhgnd", attn, vcat).reshape(b, h, -1, d)
    return out[:, :, lead:lead + nq]


class SelfAttention(nn.Module):
    """Multi-head attention: ``heads - local_heads`` global FAVOR+ heads
    and ``local_heads`` windowed softmax heads.

    The global heads take interleaved rotary embeddings with ``rotary``,
    the local heads half-rotation ones with ``local_rel_pos``. ``mask``
    (B, N), True to keep, zeroes the global heads' values at masked
    positions and masks the local heads' keys.
    """

    seq_shard = None

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 local_heads: int = 0, local_window_size: int = 256,
                 local_rel_pos: bool = True, rotary: bool = False, causal: bool = False,
                 nb_features: Optional[int] = None, generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, no_projection: bool = False,
                 qkv_bias: bool = False, dropout: float = 0.0, sow_attention: bool = False):
        super().__init__()
        if not 0 <= local_heads <= heads:
            raise ValueError(f"local_heads={local_heads} must be in [0, heads={heads}]")
        self.heads, self.dim_head = heads, dim_head
        self.local_heads, self.local_window_size = local_heads, local_window_size
        self.local_rel_pos, self.rotary, self.causal = local_rel_pos, rotary, causal
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(dim, inner, bias=qkv_bias)
        self.fast_attention = FastAttention(
            dim_head, nb_features, causal=causal, generalized_attention=generalized_attention,
            kernel_fn=kernel_fn, no_projection=no_projection,
            sow_attention=sow_attention) if heads > local_heads else None
        self.local_attn_drop = Dropout(dropout) if local_heads and dropout > 0 else None
        self.to_out = nn.Linear(inner, dim)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        b, n, _ = x.shape
        gh = self.heads - self.local_heads
        shard = self.seq_shard

        def heads(t):   # (B, N, H dh) -> (B, H, N, dh), a view
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x))
        outs = []
        if gh > 0:
            qg, kg, vg = q[:, :gh], k[:, :gh], v[:, :gh]
            if mask is not None:
                vg = vg * mask[:, None, :, None].to(vg.dtype)
            if self.rotary:
                qg, kg = apply_rotary_interleaved(
                    qg, kg, interleaved_rotary_angles(n, self.dim_head, device=x.device,
                                                      offset=0 if shard is None else
                                                      shard.start))
            outs.append(self.fast_attention(qg, kg, vg))
        if self.local_heads > 0:
            kl, vl, key_mask, start = k[:, gh:], v[:, gh:], mask, 0
            if shard is not None:
                # every rank's keys, values and key mask; this rank's queries
                kv = collectives.gather_tokens(torch.cat([kl, vl], dim=1), 2, shard)
                kl, vl = kv.split(self.local_heads, dim=1)
                if mask is not None:
                    key_mask = collectives.gather_tokens(mask.float(), 1, shard) > 0
                start = shard.start
            outs.append(local_block_attention(
                q[:, gh:], kl, vl, self.local_window_size, causal=self.causal,
                mask=key_mask, rel_pos=self.local_rel_pos, attn_dropout=self.local_attn_drop,
                q_start=start))
        out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.dropout(self.to_out(out.to(x.dtype)))


class FeedForward(nn.Module):
    """Dense -> exact GELU (optionally gated) -> Dense, over ``chunks``
    pieces of the sequence, with ``dropout`` after the GELU."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False, chunks: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.glu, self.chunks = glu, chunks
        self.w1 = nn.Linear(dim, dim * mult * (2 if glu else 1))
        self.w2 = nn.Linear(dim * mult, dim)
        self.dropout = Dropout(dropout)

    def _ff(self, x):
        h = self.w1(x)
        if self.glu:
            a, gate = h.chunk(2, dim=-1)   # act(first half) * second half
            h = F.gelu(a, approximate="none") * gate
        else:
            h = F.gelu(h, approximate="none")
        return self.w2(self.dropout(h))

    def forward(self, x):
        if self.chunks <= 1:
            return self._ff(x)
        return torch.cat([self._ff(p) for p in torch.tensor_split(x, self.chunks, dim=1)],
                         dim=1)


class ScaleNorm(nn.Module):
    """``x / max(||x||, eps) * g`` over the last axis, one learned gain."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=self.eps) * self.g


def _norm(dim: int, use_scalenorm: bool, use_rezero: bool) -> nn.Module:
    if use_scalenorm:
        return ScaleNorm()
    if use_rezero:
        return nn.Identity()
    return nn.LayerNorm(dim, eps=LAYER_NORM_EPS)


def _dropouts(module: nn.Module):
    return [m for m in module.modules() if isinstance(m, Dropout)]


def _checkpointed(fn, modules, *args):
    """``fn(*args)`` under activation checkpointing. The backward runs the
    forward again; there each :class:`Dropout` generator of ``modules`` is
    rewound to its state before the first run, so the recomputation draws
    the same masks, and set back afterwards."""
    gens = list({id(d.generator): d.generator for m in modules for d in _dropouts(m)
                 if d.generator is not None}.values())
    before = [g.get_state() for g in gens]
    runs = [0]

    def run(*a):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*a)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            return fn(*a)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False)


class Performer(nn.Module):
    """``depth`` x (SelfAttention, FeedForward) residual blocks.

    Each sub-block is pre-normed by a LayerNorm (default), a ScaleNorm
    (``use_scalenorm``) or nothing with its output scaled by a learned gain
    ``wrap_{i}_{attn,ff}_rezero_g`` initialised to 1e-3 (``use_rezero``).
    With both, the ScaleNorm pre-norms and the gains scale. ``local_attn_heads``:
    an int, or one count per layer. ``remat`` runs each block under
    activation checkpointing when gradients are on (the forward runs again
    in the backward, FAVOR's kernel included).
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64,
                 local_attn_heads: Union[int, Sequence[int]] = 0,
                 local_window_size: int = 256, rotary: bool = False, causal: bool = False,
                 ff_mult: int = 4, nb_features: Optional[int] = None, remat: bool = False,
                 ff_chunks: int = 1, generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, use_scalenorm: bool = False,
                 use_rezero: bool = False, ff_glu: bool = False, ff_dropout: float = 0.0,
                 attn_dropout: float = 0.0, no_projection: bool = False,
                 qkv_bias: bool = True, sow_attention: bool = False):
        super().__init__()
        if isinstance(local_attn_heads, int):
            local_attn_heads = (local_attn_heads,) * depth
        if len(local_attn_heads) != depth:
            raise ValueError(f"{len(local_attn_heads)} local head counts for depth {depth}")
        self.remat, self.use_rezero = remat, use_rezero
        self.attn_norms = nn.ModuleList(_norm(dim, use_scalenorm, use_rezero)
                                        for _ in range(depth))
        self.attns = nn.ModuleList(SelfAttention(
            dim, heads, dim_head, local_heads=lh, local_window_size=local_window_size,
            rotary=rotary, causal=causal, nb_features=nb_features,
            generalized_attention=generalized_attention, kernel_fn=kernel_fn,
            no_projection=no_projection, qkv_bias=qkv_bias, dropout=attn_dropout,
            sow_attention=sow_attention) for lh in local_attn_heads)
        self.ff_norms = nn.ModuleList(_norm(dim, use_scalenorm, use_rezero)
                                      for _ in range(depth))
        self.ffs = nn.ModuleList(FeedForward(dim, mult=ff_mult, glu=ff_glu, chunks=ff_chunks,
                                             dropout=ff_dropout) for _ in range(depth))
        if self.use_rezero:
            for i in range(depth):
                for part in ("attn", "ff"):
                    self.register_parameter(f"wrap_{i}_{part}_rezero_g",
                                            nn.Parameter(torch.full((1,), REZERO_INIT)))

    def rezero_gain(self, i: int, part: str) -> Optional[torch.Tensor]:
        """Layer ``i``'s ReZero gain of ``part`` ('attn' or 'ff'), or None."""
        return getattr(self, f"wrap_{i}_{part}_rezero_g") if self.use_rezero else None

    def _block(self, i, x, mask):
        a = self.attns[i](self.attn_norms[i](x), mask=mask)
        if self.use_rezero:
            a = a * self.rezero_gain(i, "attn")
        x = x + a
        f = self.ffs[i](self.ff_norms[i](x))
        if self.use_rezero:
            f = f * self.rezero_gain(i, "ff")
        return x + f

    def forward(self, x, mask=None):
        remat = self.remat and torch.is_grad_enabled()
        for i in range(len(self.attns)):
            if remat:
                x = _checkpointed(lambda h, i=i: self._block(i, h, mask),
                                  (self.attns[i], self.ffs[i]), x)
            else:
                x = self._block(i, x, mask)
        return x


class AbsolutePositionalEmbedding(nn.Module):
    """A learned ``(max_seq_len, dim)`` table; returns its rows from
    ``offset`` on, one a token of ``x``."""

    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(max_seq_len, dim) * 0.02)

    def forward(self, x, offset: int = 0):
        return self.embedding[offset:offset + x.shape[1]]


class PerformerLM(nn.Module):
    """Token model over gene sequences: token embedding plus a positional
    embedding, dropout, Performer, LayerNorm, then ``head_module``
    (scBERT's classifier), the token embedding's transpose (``tie_embed``)
    or a ``to_out`` Linear to per-token logits.

    ``pos_emb_kind``: 'gene2vec' (``g2v_weights`` ``(n, dim)``, a zero row
    appended, added as a fixed table), 'absolute' (a learned table) or
    'none'. ``forward(x, return_encodings=False, mask=None)``: with
    ``return_encodings`` the normed encodings ``(B, N, dim)``. Under a
    ``seq_shard`` (:func:`shard_sequence`), ``x`` holds the shard's
    columns of the token axis.
    """

    seq_shard = None

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int, depth: int,
                 heads: int, dim_head: int = 64,
                 local_attn_heads: Union[int, Sequence[int]] = 0,
                 local_window_size: int = 256, rotary: bool = False, causal: bool = False,
                 ff_mult: int = 4, nb_features: Optional[int] = None, remat: bool = False,
                 ff_chunks: int = 1, ff_glu: bool = False, emb_dropout: float = 0.0,
                 ff_dropout: float = 0.0, attn_dropout: float = 0.0,
                 generalized_attention: bool = False, kernel_fn: Callable = torch.relu,
                 use_scalenorm: bool = False, use_rezero: bool = False,
                 no_projection: bool = False, tie_embed: bool = False,
                 pos_emb_kind: str = "none", g2v_weights=None, qkv_bias: bool = False,
                 sow_attention: bool = False, head_module: Optional[nn.Module] = None):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.pos_emb_kind = pos_emb_kind
        self.pos_emb = None
        if pos_emb_kind == "gene2vec":
            if g2v_weights is None:
                raise ValueError("gene2vec positional embedding requires g2v_weights "
                                 "(the reference asset gene2vec_16906.npy)")
            w = torch.as_tensor(g2v_weights, dtype=torch.float32)
            self.register_buffer("g2v", torch.cat([w, w.new_zeros((1, w.shape[1]))]),
                                 persistent=False)
        elif pos_emb_kind == "absolute":
            self.pos_emb = AbsolutePositionalEmbedding(dim, max_seq_len)
        elif pos_emb_kind != "none":
            raise ValueError(pos_emb_kind)
        self.emb_dropout = Dropout(emb_dropout)
        self.performer = Performer(
            dim, depth, heads, dim_head, local_attn_heads=local_attn_heads,
            local_window_size=local_window_size, rotary=rotary, causal=causal,
            ff_mult=ff_mult, nb_features=nb_features, remat=remat, ff_chunks=ff_chunks,
            generalized_attention=generalized_attention, kernel_fn=kernel_fn,
            use_scalenorm=use_scalenorm, use_rezero=use_rezero, ff_glu=ff_glu,
            ff_dropout=ff_dropout, attn_dropout=attn_dropout, no_projection=no_projection,
            qkv_bias=qkv_bias, sow_attention=sow_attention)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.tie_embed = tie_embed
        self.head_module = head_module
        self.to_out = (nn.Linear(dim, num_tokens)
                       if head_module is None and not tie_embed else None)

    def forward(self, x, return_encodings: bool = False, mask=None):
        shard = self.seq_shard
        n_total, offset = (x.shape[1], 0) if shard is None else (shard.total, shard.start)
        if shard is not None and x.shape[1] != shard.stop - shard.start:
            raise ValueError(f"{x.shape[1]} tokens, but the token shard holds columns "
                             f"[{shard.start}, {shard.stop})")
        if n_total > self.max_seq_len:
            raise ValueError(f"{n_total} tokens exceed max_seq_len "
                             f"{self.max_seq_len}")
        h = self.token_emb(x)
        if self.pos_emb_kind == "gene2vec":
            h = h + self.g2v[offset:offset + x.shape[1]]
        elif self.pos_emb is not None:
            h = h + self.pos_emb(x, offset)
        h = self.norm(self.performer(self.emb_dropout(h), mask=mask))
        if return_encodings:
            return h
        if self.tie_embed:
            return h @ self.token_emb.weight.T
        return self.head_module(h) if self.head_module is not None else self.to_out(h)


def fast_attentions(model: nn.Module):
    """Every :class:`FastAttention` of ``model`` with a projection, in
    module order."""
    return [m for m in model.modules() if isinstance(m, FastAttention) and not m.no_projection]


def redraw_projections(model: nn.Module, generator: torch.Generator) -> int:
    """Replace every FastAttention projection of ``model`` (in place) by a
    fresh orthogonal Gaussian matrix at the layer's own ``ortho_scaling``,
    one draw of the CPU ``generator`` after another in module order;
    returns how many were drawn."""
    layers = fast_attentions(model)
    with torch.no_grad():
        for fa in layers:
            fa.projection.copy_(orthogonal_gaussian_matrix(
                *fa.projection.shape, fa.ortho_scaling, generator=generator))
    return len(layers)
