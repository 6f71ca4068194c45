"""gridnext_tpu_torch: the PyTorch/CUDA port of gridnext_tpu for NVIDIA Hopper.

Ported so far: registering a Visium slide with a ``TpuPatchClassifier``
image model -- positions and model directories in, label grid and Loupe CSV
out -- with the patch gather and the hex corrector as CUDA C++ kernels
(``csrc/``). Entry points run on CUDA unless asked for the CPU.
"""

__version__ = "0.1.0"
