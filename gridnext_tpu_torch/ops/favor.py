"""FAVOR+ linear attention primitives (Performer), plain PyTorch.

Port of ``gridnext_tpu/ops/favor.py``: softmax and generalized random
features, Gaussian orthogonal projections, non-causal linear attention,
causal linear attention as a chunked prefix scan and the implicit
attention weights, all accumulated in float32. Shapes are ``(..., heads,
seq, dim)`` throughout. The ReLU-feature composition that the CUDA kernel
fuses is :func:`gridnext_tpu_torch.ops.favor_cuda.favor_attention_plain`;
the causal scan has no kernel (XLA in the JAX package, plain torch here).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def orthogonal_gaussian_matrix(nb_rows: int, nb_columns: int, scaling: int = 0,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Stacked orthogonal blocks of Gaussian directions (QR per block).

    ``scaling=0``: rows rescaled to the chi-distributed norms of true
    Gaussian rows; ``scaling=1``: every row scaled to ``sqrt(nb_columns)``.
    Draws from ``generator`` (default: torch's global generator) on the CPU;
    the JAX package's random stream cannot be reproduced, only its
    distribution. Returns ``(nb_rows, nb_columns)`` float32.
    """
    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float64)

    n_full, rem = divmod(nb_rows, nb_columns)
    blocks = [torch.linalg.qr(normal(nb_columns, nb_columns))[0].T
              for _ in range(n_full)]
    if rem > 0:
        blocks.append(torch.linalg.qr(normal(nb_columns, nb_columns))[0].T[:rem])
    final = torch.cat(blocks, dim=0)
    if scaling == 0:
        multiplier = torch.linalg.norm(normal(nb_rows, nb_columns), dim=1)
    elif scaling == 1:
        multiplier = torch.full((nb_rows,), math.sqrt(float(nb_columns)),
                                dtype=torch.float64)
    else:
        raise ValueError(f"Invalid scaling {scaling}")
    return (multiplier[:, None] * final).float()


def softmax_kernel_features(data: torch.Tensor, projection: torch.Tensor,
                            is_query: bool, normalize_data: bool = True,
                            eps: float = 1e-4) -> torch.Tensor:
    """Positive random features phi(x) approximating the softmax kernel.

    Queries subtract a per-row max, keys a max over each (batch, head)
    slice, for numerical stability (as the JAX package does).
    """
    data_normalizer = data.shape[-1] ** -0.25 if normalize_data else 1.0
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.einsum("...id,jd->...ij", data_normalizer * data, projection)
    diag_data = (data ** 2).sum(-1, keepdim=True) / 2.0 * data_normalizer ** 2
    if is_query:
        stab = data_dash.amax(dim=-1, keepdim=True)
    else:
        stab = data_dash.amax(dim=(-2, -1), keepdim=True)
    return ratio * (torch.exp(data_dash - diag_data - stab) + eps)


def generalized_kernel_features(data: torch.Tensor, projection=None,
                                kernel_fn: Callable = torch.relu,
                                kernel_epsilon: float = 1e-3,
                                normalize_data: bool = True) -> torch.Tensor:
    """Generalized (e.g. ReLU) random features ``kernel_fn(x' @ proj^T) + eps``."""
    data_normalizer = data.shape[-1] ** -0.25 if normalize_data else 1.0
    if projection is None:
        return kernel_fn(data_normalizer * data) + kernel_epsilon
    data_dash = torch.einsum("...id,jd->...ij", data_normalizer * data, projection)
    return kernel_fn(data_dash) + kernel_epsilon


def linear_context(k: torch.Tensor, v: torch.Tensor):
    """The key side of non-causal linear attention: ``(context (..., r, d),
    k_sum (..., r))``, sums over the sequence of ``k``'s ``(..., n, r)``
    feature maps and ``v`` ``(..., n, d)``, float32. Both are sums over
    rows, so a sequence split over ranks adds its parts' results."""
    k, v = k.float(), v.float()
    return torch.einsum("...nd,...ne->...de", k, v), k.sum(dim=-2)


def linear_apply(q: torch.Tensor, context: torch.Tensor, k_sum: torch.Tensor) -> torch.Tensor:
    """The query side: ``(q @ context) / (q . k_sum)`` for ``q``'s
    ``(..., n, r)`` feature maps, float32."""
    q = q.float()
    d_inv = 1.0 / torch.einsum("...nd,...d->...n", q, k_sum)
    return torch.einsum("...de,...nd,...n->...ne", context, q, d_inv)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal linear attention over feature maps, float32 throughout:
    :func:`linear_apply` of :func:`linear_context`.

    q, k: ``(..., n, r)`` feature maps; v: ``(..., n, d)``.
    """
    return linear_apply(q, *linear_context(k, v))


def implicit_attention_weights(qf: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """The implicit attention matrix ``D^-1 q' k'^T``: ``(..., n, n)``
    row-normalised weights from ``(..., n, r)`` feature maps (a row whose
    scores sum to 0 is divided by 1). O(n^2) memory: for interpretation on
    token subsets."""
    scores = torch.einsum("...nr,...mr->...nm", qf, kf)
    denom = scores.sum(dim=-1, keepdim=True)
    return scores / torch.where(denom == 0, torch.ones_like(denom), denom)


def causal_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            chunk_size: int = 128, eps: float = 1e-6) -> torch.Tensor:
    """Causal linear attention as a chunked prefix scan.

    The sequence is zero-padded to whole chunks of ``chunk_size``; within a
    chunk the causal part is a lower-triangular-masked product, and the
    running context ``sum k v^T`` and key sum of the chunks before it are
    carried in float32. ``out_n = (q_n . sum_{m<=n} k_m v_m^T) / (q_n .
    sum_{m<=n} k_m + eps)``. q, k: ``(..., n, r)`` feature maps; v:
    ``(..., n, d)``. O(n) memory.
    """
    q, k, v = q.float(), k.float(), v.float()
    n = q.shape[-2]
    pad = (-n) % chunk_size
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    n_chunks = q.shape[-2] // chunk_size

    def chunked(x):
        return x.reshape(x.shape[:-2] + (n_chunks, chunk_size, x.shape[-1]))

    qc, kc, vc = chunked(q), chunked(k), chunked(v)
    tri = torch.tril(torch.ones((chunk_size, chunk_size), dtype=torch.bool, device=q.device))
    ctx = q.new_zeros(q.shape[:-2] + (q.shape[-1], v.shape[-1]))
    ksum = q.new_zeros(q.shape[:-2] + (q.shape[-1],))
    outs = []
    for c in range(n_chunks):
        qi, ki, vi = qc[..., c, :, :], kc[..., c, :, :], vc[..., c, :, :]
        scores = torch.einsum("...nr,...mr->...nm", qi, ki).masked_fill(~tri, 0.0)
        num = torch.einsum("...nm,...md->...nd", scores, vi) + qi @ ctx
        den = scores.sum(-1) + torch.einsum("...nr,...r->...n", qi, ksum)
        outs.append(num / (den + eps)[..., None])
        ctx = ctx + torch.einsum("...mr,...md->...rd", ki, vi)
        ksum = ksum + ki.sum(-2)
    out = torch.stack(outs, dim=-3).reshape(q.shape[:-2] + (n_chunks * chunk_size, v.shape[-1]))
    return out[..., :n, :]
