"""Models of the port: the spot classifiers f, the GridNet compositions and
the graph node classifier."""

from gridnext_tpu_torch.models.densenet import DenseNet, densenet121
from gridnext_tpu_torch.models.gridnet import (ConcatGridNet, GridNet, GridNetHex,
                                               GridNetHexMM, GridNetMM, apply_f_chunked)
from gridnext_tpu_torch.models.graph import HexGCN, graph_node_loss
from gridnext_tpu_torch.models.layers import HexConv
from gridnext_tpu_torch.models.mlp import CountMLP
from gridnext_tpu_torch.models.performer import (FastAttention, FeedForward, Performer,
                                                 PerformerLM, SelfAttention,
                                                 redraw_projections)
from gridnext_tpu_torch.models.scbert import AttentionClassifier, scBERT
from gridnext_tpu_torch.models.tpu_f import (TpuPatchClassifier, tpu_f_arch_kwargs,
                                             tpu_f_arch_meta)

__all__ = ["AttentionClassifier", "ConcatGridNet", "CountMLP", "DenseNet", "FastAttention",
           "FeedForward", "GridNet", "GridNetHex", "GridNetHexMM", "GridNetMM", "HexConv",
           "HexGCN", "Performer", "PerformerLM", "SelfAttention", "TpuPatchClassifier",
           "apply_f_chunked", "densenet121", "graph_node_loss", "redraw_projections",
           "scBERT", "tpu_f_arch_kwargs", "tpu_f_arch_meta"]
