"""Models of the port: the spot classifier f and the GridNet composition."""

from gridnext_tpu_torch.models.gridnet import GridNetHex, apply_f_chunked
from gridnext_tpu_torch.models.layers import HexConv
from gridnext_tpu_torch.models.tpu_f import TpuPatchClassifier, tpu_f_arch_kwargs

__all__ = ["GridNetHex", "HexConv", "TpuPatchClassifier", "apply_f_chunked",
           "tpu_f_arch_kwargs"]
