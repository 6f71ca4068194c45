"""Bridges from the JAX package's checkpoints and model directories, and
from the reference's PyTorch checkpoints (``torch_convert``,
``scbert_convert``): the converters give the port's weight tree, which
``from_jax.load_variables`` copies into the port's modules."""

from gridnext_tpu_torch.compat.scbert_convert import (  # noqa: F401
    performer_lm_from_torch,
    read_torch_checkpoint,
    scbert_from_torch,
)
from gridnext_tpu_torch.compat.torch_convert import (  # noqa: F401
    count_mlp_from_torch,
    densenet_from_torch,
    gridnet_from_torch,
    gridnethex_from_torch,
    gridnethexmm_from_torch,
    hex_kernel_from_hexagdly,
    hex_kernel_from_hexagdly_k2,
    load_torch_checkpoint,
)
