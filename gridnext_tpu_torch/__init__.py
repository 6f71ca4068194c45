"""gridnext_tpu_torch: the PyTorch/CUDA port of gridnext_tpu for NVIDIA Hopper.

Ported so far: registering a Visium slide with a ``TpuPatchClassifier`` or
DenseNet-121 image model -- positions and model directories in, label grid
and Loupe CSV out -- and with a multimodal scBERT + image model directory
(image and count grids in, label grid out). The patch gather, the hex
corrector, the dense block and the FAVOR linear attention are CUDA C++
kernels (``csrc/``). Entry points run on CUDA unless asked for the CPU.
"""

__version__ = "0.1.0"
