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
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gridnext_tpu_torch.models.layers import Dropout
from gridnext_tpu_torch.ops.favor import (causal_linear_attention,
                                          generalized_kernel_features,
                                          implicit_attention_weights, linear_attention,
                                          orthogonal_gaussian_matrix,
                                          softmax_kernel_features)
from gridnext_tpu_torch.ops.favor_cuda import fused_generalized_linear_attention

LAYER_NORM_EPS = 1e-6   # flax nn.LayerNorm's default
REZERO_INIT = 1e-3      # the ReZero gain's initial value


def default_nb_features(dim_head: int) -> int:
    """FAVOR+ random-feature count m = d ln d (266 at d = 64)."""
    return int(dim_head * math.log(dim_head))


def _is_relu(fn: Callable) -> bool:
    return fn is torch.relu or fn is F.relu


class FastAttention(nn.Module):
    """FAVOR+ attention core over ``(B, H, N, dh)`` q/k/v.

    ``sow_attention`` (non-causal only): each forward stores the head-mean
    absolute implicit attention weights, ``(B, N, N)``, in
    :attr:`attention` (the JAX module sows them into ``intermediates``);
    O(N^2) memory. ``ortho_scaling`` is the projection's row scaling (see
    :func:`~gridnext_tpu_torch.ops.favor.orthogonal_gaussian_matrix`).
    ``dtype`` is a storage hint only, as in the JAX module: the feature
    maps stay float32.
    """

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

    def _features(self, q, k):
        if self.no_projection:
            kf = torch.exp(k - k.max()) if self.causal else torch.softmax(k, dim=-2)
            return torch.softmax(q, dim=-1), kf
        proj = self.projection
        if self.generalized_attention:
            return (generalized_kernel_features(q, proj, self.kernel_fn),
                    generalized_kernel_features(k, proj, self.kernel_fn))
        return (softmax_kernel_features(q, proj, is_query=True),
                softmax_kernel_features(k, proj, is_query=False))

    def forward(self, q, k, v):
        kernel = (not self.causal and not self.no_projection and self.generalized_attention
                  and _is_relu(self.kernel_fn) and q.device.type == "cuda")
        if kernel and not self.sow_attention:
            return fused_generalized_linear_attention(q, k, v, self.projection)
        qf, kf = self._features(q, k)
        if self.sow_attention and not self.causal:
            self.attention = implicit_attention_weights(qf, kf).abs().mean(dim=-3)
        if kernel:
            return fused_generalized_linear_attention(q, k, v, self.projection)
        if self.causal:
            return causal_linear_attention(qf, kf, v)
        return linear_attention(qf, kf, v)


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


def apply_rotary_pos_emb(q, k, freqs):
    """Half-rotation rotary on q and k ``(..., N, d)`` with angles ``freqs``
    ``(N, d)`` (the local heads' convention)."""
    cos, sin = freqs.cos(), freqs.sin()
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def interleaved_rotary_angles(n: int, dim: int, dtype=torch.float32, device=None
                              ) -> torch.Tensor:
    """Rotary angles of the interleaved (GPT-J) convention, ``(n, dim // 2)``:
    one angle per adjacent (2i, 2i+1) pair."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=dtype, device=device) / dim))
    return torch.arange(n, dtype=dtype, device=device)[:, None] * inv[None, :]


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
                          rel_pos: bool = False,
                          attn_dropout: Optional[Callable] = None) -> torch.Tensor:
    """Blockwise local softmax attention over ``(B, H, N, d)`` q/k/v.

    The sequence is padded to whole blocks of ``window``; each block attends
    to itself and the block before it (and after it, unless ``causal``).
    ``rel_pos`` applies half-rotation rotary embeddings after the padding.
    ``mask`` (B, N) bool marks the keys to keep; padded positions, blocks
    beyond either end and (causal) later positions are masked too, and a
    query whose keys are all masked gets zeros. ``attn_dropout`` acts on
    the softmax weights.
    """
    b, h, n, d = q.shape
    pad = (-n) % window
    if mask is not None:
        mask = mask.to(torch.bool)
        if pad:
            mask = F.pad(mask, (0, pad))
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    if rel_pos:
        q, k = apply_rotary_pos_emb(q, k, sinusoidal_rotary_freqs(q.shape[2], d, q.dtype,
                                                                  q.device))
    nb = q.shape[2] // window
    qb, kb, vb = (t.reshape(b, h, nb, window, d) for t in (q, k, v))
    offs = [-1, 0] + ([] if causal else [1])
    kcat = torch.cat([torch.roll(kb, -o, dims=2) for o in offs], dim=3)
    vcat = torch.cat([torch.roll(vb, -o, dims=2) for o in offs], dim=3)
    scores = torch.einsum("bhgnd,bhgmd->bhgnm", qb, kcat) / math.sqrt(d)

    dev = q.device
    blk = torch.arange(nb, device=dev)
    within = torch.arange(window, device=dev)
    seq_pos = blk[:, None] * window + within[None, :]                     # (nb, w)
    valid = torch.cat([((blk + o >= 0) & (blk + o < nb))[:, None].expand(nb, window)
                       for o in offs], dim=1)                              # (nb, k w)
    col_pos = torch.cat([(blk + o)[:, None] * window + within[None, :] for o in offs], dim=1)
    m = valid[None, None, :, None, :] & (col_pos < n)[None, None, :, None, :]
    if causal:
        m = m & (col_pos[None, None, :, None, :] <= seq_pos[None, None, :, :, None])
    if mask is not None:
        key_mask = mask[:, col_pos.clamp(0, mask.shape[1] - 1)]            # (B, nb, k w)
        m = m & key_mask[:, None, :, None, :]
    m = m.expand(scores.shape)
    scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.where(m.any(dim=-1, keepdim=True), attn, torch.zeros_like(attn))
    if attn_dropout is not None:
        attn = attn_dropout(attn)
    out = torch.einsum("bhgnm,bhgmd->bhgnd", attn, vcat).reshape(b, h, nb * window, d)
    return out[:, :, :n]


class SelfAttention(nn.Module):
    """Multi-head attention: ``heads - local_heads`` global FAVOR+ heads
    and ``local_heads`` windowed softmax heads.

    The global heads take interleaved rotary embeddings with ``rotary``,
    the local heads half-rotation ones with ``local_rel_pos``. ``mask``
    (B, N), True to keep, zeroes the global heads' values at masked
    positions and masks the local heads' keys.
    """

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
                    qg, kg, interleaved_rotary_angles(n, self.dim_head, device=x.device))
            outs.append(self.fast_attention(qg, kg, vg))
        if self.local_heads > 0:
            outs.append(local_block_attention(
                q[:, gh:], k[:, gh:], v[:, gh:], self.local_window_size, causal=self.causal,
                mask=mask, rel_pos=self.local_rel_pos, attn_dropout=self.local_attn_drop))
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
    """A learned ``(max_seq_len, dim)`` table; returns its first N rows."""

    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(max_seq_len, dim) * 0.02)

    def forward(self, x):
        return self.embedding[: x.shape[1]]


class PerformerLM(nn.Module):
    """Token model over gene sequences: token embedding plus a positional
    embedding, dropout, Performer, LayerNorm, then ``head_module``
    (scBERT's classifier), the token embedding's transpose (``tie_embed``)
    or a ``to_out`` Linear to per-token logits.

    ``pos_emb_kind``: 'gene2vec' (``g2v_weights`` ``(n, dim)``, a zero row
    appended, added as a fixed table), 'absolute' (a learned table) or
    'none'. ``forward(x, return_encodings=False, mask=None)``: with
    ``return_encodings`` the normed encodings ``(B, N, dim)``.
    """

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
        if x.shape[1] > self.max_seq_len:
            raise ValueError(f"{x.shape[1]} tokens exceed max_seq_len "
                             f"{self.max_seq_len}")
        h = self.token_emb(x)
        if self.pos_emb_kind == "gene2vec":
            h = h + self.g2v[: x.shape[1]]
        elif self.pos_emb is not None:
            h = h + self.pos_emb(x)
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
