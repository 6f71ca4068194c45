"""Kernels of the port (CUDA C++ in ``csrc/``) and their plain versions.

Importing the package registers the serving kernels as ``gridnext::``
custom ops (the gather, both hex-corrector variants and FAVOR's forward),
which a loaded ``torch.export`` artifact calls.
"""

from gridnext_tpu_torch.ops import favor_cuda, hexcorrector_cuda, patch_gather_cuda  # noqa: F401
