"""Models of the port: the spot classifier f and the GridNet composition."""

from gridnext_tpu_torch.models.densenet import DenseNet, densenet121
from gridnext_tpu_torch.models.gridnet import GridNetHex, apply_f_chunked
from gridnext_tpu_torch.models.layers import HexConv
from gridnext_tpu_torch.models.tpu_f import TpuPatchClassifier, tpu_f_arch_kwargs

__all__ = ["DenseNet", "GridNetHex", "HexConv", "TpuPatchClassifier", "apply_f_chunked",
           "densenet121", "tpu_f_arch_kwargs"]
