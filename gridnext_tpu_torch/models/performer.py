"""Performer (FAVOR+ linear-attention transformer), inference in PyTorch.

Port of ``gridnext_tpu/models/performer.py`` as far as scBERT in a
multimodal model directory needs it: ``FastAttention`` (generalized and
softmax random features, ``no_projection``), ``SelfAttention`` with global
heads only, ``FeedForward`` (exact GELU, GLU, chunks), ``Performer`` with
pre-LayerNorm residuals and ``PerformerLM`` (token embedding, no positional
embedding, an optional head module, the final LayerNorm). Modules run in
eval mode: dropout is zero in every model directory the port serves.

Causal attention, local heads, rotary embeddings and ``sow_attention``
wait for a later slice (``ROADMAP.md`` Queue 1 item 6) and raise
``NotImplementedError``; ScaleNorm/ReZero residuals and positional
embeddings are absent.

Each ``FastAttention`` holds its projection in a ``projection`` buffer (the
JAX package's ``favor`` collection; the weight bridge fills it). With
generalized ReLU features on CUDA tensors, non-causal and projected, it
calls :func:`~gridnext_tpu_torch.ops.favor_cuda.fused_generalized_linear_attention`
(the CUDA kernel); otherwise the plain ops of
:mod:`gridnext_tpu_torch.ops.favor`.

flax's ``LayerNorm`` epsilon is 1e-6 (torch's default is 1e-5) and its
GELU here is the exact (erf) one; both are set explicitly.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gridnext_tpu_torch.ops.favor import (generalized_kernel_features,
                                          linear_attention,
                                          orthogonal_gaussian_matrix,
                                          softmax_kernel_features)
from gridnext_tpu_torch.ops.favor_cuda import fused_generalized_linear_attention

LAYER_NORM_EPS = 1e-6   # flax nn.LayerNorm's default
_LATER = "a later slice of the port (ROADMAP.md Queue 1 item 6)"


def default_nb_features(dim_head: int) -> int:
    """FAVOR+ random-feature count m = d ln d (266 at d = 64)."""
    return int(dim_head * math.log(dim_head))


def _is_relu(fn: Callable) -> bool:
    return fn is torch.relu or fn is F.relu


class FastAttention(nn.Module):
    """FAVOR+ attention core over ``(B, H, N, dh)`` q/k/v."""

    def __init__(self, dim_head: int, nb_features: Optional[int] = None,
                 causal: bool = False, generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, no_projection: bool = False,
                 sow_attention: bool = False):
        super().__init__()
        if causal:
            raise NotImplementedError(f"causal linear attention is {_LATER}")
        if sow_attention:
            raise NotImplementedError(f"sow_attention is {_LATER}")
        self.generalized_attention = generalized_attention
        self.kernel_fn = kernel_fn
        self.no_projection = no_projection
        if not no_projection:
            nb = nb_features or default_nb_features(dim_head)
            self.register_buffer("projection", orthogonal_gaussian_matrix(nb, dim_head))

    def forward(self, q, k, v):
        if self.no_projection:
            return linear_attention(torch.softmax(q, dim=-1),
                                    torch.softmax(k, dim=-2), v)
        proj = self.projection
        if self.generalized_attention:
            if _is_relu(self.kernel_fn) and q.device.type == "cuda":
                return fused_generalized_linear_attention(q, k, v, proj)
            qf = generalized_kernel_features(q, proj, self.kernel_fn)
            kf = generalized_kernel_features(k, proj, self.kernel_fn)
        else:
            qf = softmax_kernel_features(q, proj, is_query=True)
            kf = softmax_kernel_features(k, proj, is_query=False)
        return linear_attention(qf, kf, v)


class SelfAttention(nn.Module):
    """Multi-head FAVOR+ attention with global heads only."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 local_heads: int = 0, rotary: bool = False,
                 nb_features: Optional[int] = None,
                 generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, no_projection: bool = False,
                 qkv_bias: bool = False):
        super().__init__()
        if local_heads:
            raise NotImplementedError(f"local attention heads are {_LATER}")
        if rotary:
            raise NotImplementedError(f"rotary embeddings are {_LATER}")
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(dim, inner, bias=qkv_bias)
        self.fast_attention = FastAttention(
            dim_head, nb_features, generalized_attention=generalized_attention,
            kernel_fn=kernel_fn, no_projection=no_projection)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x):
        b, n, _ = x.shape

        def heads(t):   # (B, N, H dh) -> (B, H, N, dh), a view
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        out = self.fast_attention(heads(self.to_q(x)), heads(self.to_k(x)),
                                  heads(self.to_v(x)))
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


class FeedForward(nn.Module):
    """Dense -> exact GELU (optionally gated) -> Dense, over ``chunks``
    pieces of the sequence."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False, chunks: int = 1):
        super().__init__()
        self.glu, self.chunks = glu, chunks
        self.w1 = nn.Linear(dim, dim * mult * (2 if glu else 1))
        self.w2 = nn.Linear(dim * mult, dim)

    def _ff(self, x):
        h = self.w1(x)
        if self.glu:
            a, gate = h.chunk(2, dim=-1)   # act(first half) * second half
            h = F.gelu(a, approximate="none") * gate
        else:
            h = F.gelu(h, approximate="none")
        return self.w2(h)

    def forward(self, x):
        if self.chunks <= 1:
            return self._ff(x)
        return torch.cat([self._ff(p) for p in torch.tensor_split(x, self.chunks, dim=1)],
                         dim=1)


class Performer(nn.Module):
    """``depth`` x (SelfAttention, FeedForward), each with a pre-LayerNorm
    residual."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int = 64,
                 nb_features: Optional[int] = None, ff_chunks: int = 1,
                 generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, ff_glu: bool = False,
                 no_projection: bool = False, qkv_bias: bool = True):
        super().__init__()
        self.attn_norms = nn.ModuleList(nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
                                        for _ in range(depth))
        self.attns = nn.ModuleList(SelfAttention(
            dim, heads, dim_head, nb_features=nb_features,
            generalized_attention=generalized_attention, kernel_fn=kernel_fn,
            no_projection=no_projection, qkv_bias=qkv_bias)
            for _ in range(depth))
        self.ff_norms = nn.ModuleList(nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
                                      for _ in range(depth))
        self.ffs = nn.ModuleList(FeedForward(dim, glu=ff_glu, chunks=ff_chunks)
                                 for _ in range(depth))

    def forward(self, x):
        for attn_norm, attn, ff_norm, ff in zip(self.attn_norms, self.attns,
                                                self.ff_norms, self.ffs):
            x = x + attn(attn_norm(x))
            x = x + ff(ff_norm(x))
        return x


class PerformerLM(nn.Module):
    """Token model over gene sequences: embedding, Performer, LayerNorm,
    then ``head_module`` (scBERT's classifier) or a ``to_out`` Linear to
    per-token logits. No positional embedding (``pos_emb_kind="none"``,
    what scBERT uses without gene2vec weights)."""

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int, depth: int,
                 heads: int, dim_head: int = 64, nb_features: Optional[int] = None,
                 ff_chunks: int = 1, ff_glu: bool = False,
                 generalized_attention: bool = False,
                 kernel_fn: Callable = torch.relu, no_projection: bool = False,
                 qkv_bias: bool = False, head_module: Optional[nn.Module] = None):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.performer = Performer(
            dim, depth, heads, dim_head, nb_features=nb_features, ff_chunks=ff_chunks,
            generalized_attention=generalized_attention, kernel_fn=kernel_fn,
            ff_glu=ff_glu, no_projection=no_projection, qkv_bias=qkv_bias)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.head_module = head_module
        self.to_out = nn.Linear(dim, num_tokens) if head_module is None else None

    def forward(self, x):
        if x.shape[1] > self.max_seq_len:
            raise ValueError(f"{x.shape[1]} tokens exceed max_seq_len "
                             f"{self.max_seq_len}")
        h = self.norm(self.performer(self.token_emb(x)))
        return self.head_module(h) if self.head_module is not None else self.to_out(h)
