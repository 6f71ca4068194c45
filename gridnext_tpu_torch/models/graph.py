"""Graph node classifier over Visium hex graphs.

Port of ``gridnext_tpu/models/graph.py``: ``HexGCN`` over the ``nodes``
(N, F) and ``edges`` (2, E) arrays of
:func:`~gridnext_tpu_torch.data.graph_data.visium_to_graphdata`, and the
masked node loss :func:`graph_node_loss` that ``train-graph`` minimises.
Message passing is ``index_add_`` over the edge list (atomic adds on the
card, so the sum order is not fixed).
"""

from __future__ import annotations

import torch
from torch import nn


class HexGCN(nn.Module):
    """Stacked mean-aggregation graph convolutions and a linear head.

    Each layer computes ``h' = relu(LayerNorm(W_self h + W_nbr mean_{j->i}
    h_j))``, the mean over the edges into each node (in-degree, at least
    1); a final ``Linear`` maps to class logits.

    Args:
      n_genes: node feature width (flax infers it; torch needs it up front).
      n_classes: output width.
      hidden: width of every layer.
      depth: number of graph convolutions.
    """

    def __init__(self, n_genes: int, n_classes: int, hidden: int = 128, depth: int = 3):
        super().__init__()
        widths = [n_genes] + [hidden] * depth
        self.self_dense = nn.ModuleList(nn.Linear(i, hidden) for i in widths[:-1])
        self.nbr_dense = nn.ModuleList(nn.Linear(i, hidden, bias=False) for i in widths[:-1])
        self.norms = nn.ModuleList(nn.LayerNorm(hidden, eps=1e-6) for _ in range(depth))
        self.out = nn.Linear(hidden, n_classes)

    def forward(self, nodes: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
        send, recv = edges[0], edges[1]
        deg = nodes.new_zeros(nodes.shape[0]).index_add_(
            0, recv, nodes.new_ones(recv.shape[0]))
        inv_deg = 1.0 / deg.clamp(min=1.0)
        h = nodes
        for self_dense, nbr_dense, norm in zip(self.self_dense, self.nbr_dense, self.norms):
            agg = h.new_zeros(h.shape).index_add_(0, recv, h[send]) * inv_deg[:, None]
            h = torch.relu(norm(self_dense(h) + nbr_dense(agg)))
        return self.out(h)


def graph_node_loss(logits: torch.Tensor, y: torch.Tensor, node_mask=None):
    """Masked node-classification CE: ``(mean loss, n_correct, n)``.

    ``y`` in ``[0, C)``, -1 for unlabeled and padding nodes; ``node_mask``
    (optional, bool) leaves out padding nodes. The mean is over labeled
    nodes (at least 1); ``n`` is their raw count (0 when none is labeled).
    """
    valid = y >= 0
    if node_mask is not None:
        valid = valid & node_mask
    safe = torch.where(valid, y, torch.zeros_like(y))
    ll = torch.log_softmax(logits, dim=-1).gather(-1, safe[:, None])[:, 0]
    loss = -torch.where(valid, ll, torch.zeros_like(ll)).sum() / valid.sum().clamp_min(1)
    correct = (logits.argmax(-1) == safe) & valid
    return loss, correct.sum(), valid.sum()
