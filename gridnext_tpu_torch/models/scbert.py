"""scBERT: a PerformerLM over the gene2vec vocabulary, as a count-spot f.

Port of ``gridnext_tpu/models/scbert.py``: expression binned
into ``bin_num`` tokens with an appended zero token, the
``AttentionClassifier`` head, the count preprocessing recipe
(:func:`preprocess_scbert`, numpy and scipy only) and the 16,906-symbol
gene2vec vocabulary, kept in the port's own copy
(``gridnext_tpu_torch/assets/gene2vec_names.csv``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gridnext_tpu_torch.models.layers import Dropout
from gridnext_tpu_torch.models.performer import PerformerLM

SCBERT_N_GENES = 16906  # gene2vec vocabulary size
GENE2VEC_NAMES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "assets", "gene2vec_names.csv")


class AttentionClassifier(nn.Module):
    """Token-embedding pooling head: Dense(dim -> 1) over each token, then
    an MLP over the ``seq_len`` token scores (fc1 -> 512 -> ``h_dim`` ->
    ``out_dim``, ReLUs between, ``dropout`` after the first two)."""

    def __init__(self, dim: int, seq_len: int = SCBERT_N_GENES + 1, h_dim: int = 128,
                 out_dim: int = 10, dropout: float = 0.0):
        super().__init__()
        self.seq_len = seq_len
        self.dropout = Dropout(dropout)
        self.conv1 = nn.Linear(dim, 1)
        self.fc1 = nn.Linear(seq_len, 512)
        self.fc2 = nn.Linear(512, h_dim)
        self.fc3 = nn.Linear(h_dim, out_dim)

    def forward(self, x):
        if x.shape[1] != self.seq_len:
            raise ValueError(f"AttentionClassifier built for seq_len={self.seq_len} "
                             f"but got {x.shape[1]} tokens")
        h = torch.relu(self.conv1(x)[..., 0])        # (B, seq_len)
        h = self.dropout(torch.relu(self.fc1(h)))
        h = self.dropout(torch.relu(self.fc2(h)))
        return self.fc3(h)


class scBERT(nn.Module):  # noqa: N801 (the JAX package's name)
    """Performer LM over binned log-expression with an optional classifier.

    ``forward(x)`` with ``x`` ``(B, n_genes)`` float log-expression: values
    are clipped to ``bin_num`` and truncated to integer tokens, a zero token
    is appended, and the LM runs over ``n_genes + 1`` tokens. With
    ``n_classes``: ``(B, n_classes)`` logits (the count-f of
    ``GridNetHexMM``); without: per-token logits. ``ff_dropout`` and
    ``attn_dropout`` act in train mode, as the JAX module's.
    """

    def __init__(self, n_genes: int = SCBERT_N_GENES, bin_num: int = 5, dim: int = 200,
                 depth: int = 6, heads: int = 10, dim_head: int = 64,
                 nb_features: Optional[int] = None, n_classes: Optional[int] = None,
                 generalized_attention: bool = False, ff_dropout: float = 0.0,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.bin_num = bin_num
        head = (None if n_classes is None else
                AttentionClassifier(dim, seq_len=n_genes + 1, h_dim=128, out_dim=n_classes))
        self.performer_lm = PerformerLM(
            num_tokens=bin_num + 2, max_seq_len=n_genes + 1, dim=dim, depth=depth,
            heads=heads, dim_head=dim_head, nb_features=nb_features,
            generalized_attention=generalized_attention, head_module=head,
            ff_dropout=ff_dropout, attn_dropout=attn_dropout)

    def forward(self, x):
        tokens = torch.clamp(x, max=self.bin_num).to(torch.int64)   # truncation
        cls = torch.zeros((tokens.shape[0], 1), dtype=torch.int64, device=x.device)
        return self.performer_lm(torch.cat([tokens, cls], dim=-1))


def preprocess_scbert(X, var_names: Sequence[str], *, target_genes: Sequence[str],
                      target_depth: float = 1e4, min_genes: Optional[int] = None,
                      min_depth: Optional[float] = None):
    """Reindex counts to a reference gene list, depth-normalize, log2(1+x).

    Args:
      X: (n_spots, n_genes) raw counts (dense or scipy sparse).
      var_names: gene names aligned with X's columns (the first of a
        repeated name is kept).
      target_genes: ordered reference gene list (e.g. the gene2vec names);
        genes absent from ``var_names`` become zero columns.

    Returns:
      (X_new, keep_mask): the (n_kept, len(target_genes)) float32 matrix and
      the row filter applied.
    """
    import scipy.sparse as sp

    if sp.issparse(X):
        X = np.asarray(X.todense())
    X = np.asarray(X, dtype=np.float32)

    target_index = {g: i for i, g in enumerate(target_genes)}
    out = np.zeros((X.shape[0], len(target_genes)), np.float32)
    src_cols, dst_cols, seen = [], [], set()
    for j, g in enumerate(var_names):
        if g in target_index and g not in seen:
            src_cols.append(j)
            dst_cols.append(target_index[g])
            seen.add(g)
    out[:, dst_cols] = X[:, src_cols]

    keep = np.ones(out.shape[0], bool)
    if min_genes is not None:
        keep &= (out > 0).sum(1) >= min_genes
    if min_depth is not None:
        keep &= out.sum(1) >= min_depth
    out = out[keep]

    depths = out.sum(1, keepdims=True)
    depths[depths == 0] = 1.0
    out = out / depths * target_depth
    return np.log2(1.0 + out), keep


def load_gene2vec_names() -> list:
    """The ordered 16,906-symbol gene2vec vocabulary that defines scBERT's
    input order (the port's copy of the JAX package's asset)."""
    with open(GENE2VEC_NAMES) as fh:
        names = [line.strip() for line in fh if line.strip()]
    if len(names) != SCBERT_N_GENES:
        raise RuntimeError(f"gene2vec vocabulary has {len(names)} entries, "
                           f"expected {SCBERT_N_GENES}")
    return names
