"""scBERT: a PerformerLM over the gene2vec vocabulary, as a count-spot f.

Port of ``gridnext_tpu/models/scbert.py``: expression binned
into ``bin_num`` tokens with an appended zero token, the
``AttentionClassifier`` head, the fine-tuning freeze policy
(:func:`finetune_param_labels`), the count preprocessing recipe
(:func:`preprocess_scbert`, numpy and scipy only) and the 16,906-symbol
gene2vec vocabulary, kept in the port's own copy
(``gridnext_tpu_torch/assets/gene2vec_names.csv``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from gridnext_tpu_torch.models.layers import Dropout
from gridnext_tpu_torch.models.performer import PerformerLM, shard_sequence

SCBERT_N_GENES = 16906  # gene2vec vocabulary size
GENE2VEC_NAMES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "assets", "gene2vec_names.csv")


class AttentionClassifier(nn.Module):
    """Token-embedding pooling head: Dense(dim -> 1) over each token, then
    an MLP over the ``seq_len`` token scores (fc1 -> 512 -> ``h_dim`` ->
    ``out_dim``, ReLUs between, ``dropout`` after the first two). Under a
    ``seq_shard`` the tokens are the shard's columns: fc1's partial product
    over them is summed over the shard's group, as JAX's partitioner sums
    a Dense over a sharded axis, and every rank gets the whole logits."""

    seq_shard = None

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
        shard = self.seq_shard
        n = x.shape[1] if shard is None else shard.total
        if n != self.seq_len:
            raise ValueError(f"AttentionClassifier built for seq_len={self.seq_len} "
                             f"but got {n} tokens")
        h = torch.relu(self.conv1(x)[..., 0])        # (B, seq_len)
        if shard is None:
            h = self.fc1(h)
        else:
            from gridnext_tpu_torch.parallel.collectives import all_reduce

            w = self.fc1.weight[:, shard.start:shard.stop]
            h = all_reduce(h @ w.T, shard.group) + self.fc1.bias
        h = self.dropout(torch.relu(h))
        h = self.dropout(torch.relu(self.fc2(h)))
        return self.fc3(h)


class scBERT(nn.Module):  # noqa: N801 (the JAX package's name)
    """Performer LM over binned log-expression with an optional classifier.

    ``forward(x)`` with ``x`` ``(B, n_genes)`` float log-expression: values
    are clipped to ``bin_num`` and truncated to integer tokens, a zero token
    is appended, and the LM runs over ``n_genes + 1`` tokens. With
    ``n_classes``: ``(B, n_classes)`` logits (the count-f of
    ``GridNetHexMM``); without: per-token logits. ``g2v_weights`` selects
    the gene2vec positional embedding (else none); ``local_attn_heads``,
    ``remat`` and ``sow_attention`` as in
    :class:`~gridnext_tpu_torch.models.performer.PerformerLM`.
    ``ff_dropout`` and ``attn_dropout`` act in train mode, as the JAX
    module's. Under a ``seq_shard`` (``performer.shard_sequence``) ``x``
    holds the shard's columns of the gene axis; the rank that holds the
    last genes appends the zero token.
    """

    seq_shard = None

    def __init__(self, n_genes: int = SCBERT_N_GENES, bin_num: int = 5, dim: int = 200,
                 depth: int = 6, heads: int = 10, dim_head: int = 64,
                 nb_features: Optional[int] = None, local_attn_heads: int = 0,
                 n_classes: Optional[int] = None, g2v_weights=None, remat: bool = False,
                 generalized_attention: bool = False, ff_dropout: float = 0.0,
                 attn_dropout: float = 0.0, sow_attention: bool = False):
        super().__init__()
        self.bin_num = bin_num
        head = (None if n_classes is None else
                AttentionClassifier(dim, seq_len=n_genes + 1, h_dim=128, out_dim=n_classes))
        self.performer_lm = PerformerLM(
            num_tokens=bin_num + 2, max_seq_len=n_genes + 1, dim=dim, depth=depth,
            heads=heads, dim_head=dim_head, nb_features=nb_features,
            local_attn_heads=local_attn_heads,
            pos_emb_kind="gene2vec" if g2v_weights is not None else "none",
            g2v_weights=g2v_weights, remat=remat,
            generalized_attention=generalized_attention, head_module=head,
            ff_dropout=ff_dropout, attn_dropout=attn_dropout, sow_attention=sow_attention)

    def forward(self, x):
        tokens = torch.clamp(x, max=self.bin_num).to(torch.int64)   # truncation
        cls = torch.zeros((tokens.shape[0], 1), dtype=torch.int64, device=x.device)
        genes = self.seq_shard
        if genes is not None:
            # the LM's token axis is the gene axis and the zero token, on the last rank
            last = genes.stop == genes.total
            shard_sequence(self.performer_lm, dataclasses.replace(
                genes, stop=genes.stop + last, total=genes.total + 1))
            if not last:
                return self.performer_lm(tokens)
        return self.performer_lm(torch.cat([tokens, cls], dim=-1))


def finetune_param_labels(params: dict, depth: int) -> dict:
    """The fine-tuning freeze policy as a label tree congruent with an
    scBERT ``params`` tree (the JAX layout, nested dicts): 'train' for the
    root ``to_out`` classifier head, the final ``performer_lm/norm`` and
    performer layer ``depth - 2`` (its attention, feed-forward and their
    ``wrap_`` norms or gains); 'frozen' for every other leaf."""
    def label(tree, keys):
        if isinstance(tree, dict):
            return {k: label(v, keys + (str(k),)) for k, v in tree.items()}
        joined = "/".join(keys)
        trainable = (keys[0] == "to_out" or "performer_lm/norm" in joined
                     or f"layers_{depth - 2}_" in joined or f"wrap_{depth - 2}_" in joined)
        return "train" if trainable else "frozen"

    return label(params, ())


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
