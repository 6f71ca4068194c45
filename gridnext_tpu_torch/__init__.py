"""gridnext_tpu_torch: the PyTorch/CUDA port of gridnext_tpu for NVIDIA Hopper.

Ported so far: registering Visium slides with a ``TpuPatchClassifier`` or
DenseNet-121 image model -- positions, slide files and model directories
in, label grids and Loupe CSVs out, decode and staging overlapped
(``python -m gridnext_tpu_torch register``) -- on the hex lattice and on
Visium HD's square bin lattices (``GridNet``, positions parquets, dense
lattices of a fractional pitch resampled), with a ``CountMLP`` count
model over unified count caches, and with a multimodal scBERT or CountMLP
+ image model directory (image and count grids in, label grid out); and
training those models (``train-count``, ``train-image``, ``train-mm``:
spotwise f, then gridwise g, writing model directories both packages
read). The patch gather, the hex corrector, the dense block and the FAVOR
linear attention are CUDA C++ kernels (``csrc/``). Entry points run on
CUDA unless asked for the CPU.
"""

__version__ = "0.1.0"
