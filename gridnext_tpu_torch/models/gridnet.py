"""GridNetHex: spot classifier f composed with the hex grid corrector g.

Port of ``gridnext_tpu/models/gridnet.py`` (hex branch). Tensors are
channels-last: image grids ``(B, H, W, P, P, 3)`` in, ``(B, H, W,
n_classes)`` logits out.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gridnext_tpu_torch.models.layers import HexConv
from gridnext_tpu_torch.ops.hexcorrector_cuda import fold_corrector_params


class _HexCorrector(nn.Module):
    """Five radius-1 hex convs: f_dim->32->32 [BN,ReLU] ->32->32 [BN,ReLU] ->n_classes.

    BatchNorm runs over every cell of the (B, H, W, C) grid (flax
    ``BatchNorm`` over all axes but the last): momentum 0.1 in torch's
    convention is flax's 0.9, epsilon 1e-5 in both.
    """

    def __init__(self, in_features: int, n_classes: int, use_bn: bool = True,
                 width: int = 32):
        super().__init__()
        self.use_bn = use_bn
        dims = (in_features, width, width, width, width, n_classes)
        self.convs = nn.ModuleList(HexConv(dims[i], dims[i + 1]) for i in range(5))
        if use_bn:
            self.bns = nn.ModuleList(nn.BatchNorm1d(width, eps=1e-5, momentum=0.1)
                                     for _ in range(2))

    def _bn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if not self.use_bn:
            return x
        return self.bns[i](x.reshape(-1, x.shape[-1])).reshape(x.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs[1](self.convs[0](x))
        x = torch.relu(self._bn(0, x))
        x = self.convs[3](self.convs[2](x))
        x = torch.relu(self._bn(1, x))
        return self.convs[4](x)

    def jax_entries(self):
        """(collection, layer, leaf, tensor) of every weight, named as in the
        JAX package's corrector (``HexConv_i`` kernel/bias, ``BatchNorm_j``
        scale/bias and batch_stats mean/var); the weight bridge and
        :meth:`folded` both read it."""
        for i, conv in enumerate(self.convs):
            yield "params", f"HexConv_{i}", "kernel", conv.kernel
            yield "params", f"HexConv_{i}", "bias", conv.bias
        if self.use_bn:
            for j, bn in enumerate(self.bns):
                yield "params", f"BatchNorm_{j}", "scale", bn.weight
                yield "params", f"BatchNorm_{j}", "bias", bn.bias
                yield "batch_stats", f"BatchNorm_{j}", "mean", bn.running_mean
                yield "batch_stats", f"BatchNorm_{j}", "var", bn.running_var

    def folded(self):
        """(kernels, biases, relu_flags) with eval-mode BatchNorm folded in,
        for the serving corrector kernels."""
        tree = {"params": {}, "batch_stats": {}}
        for collection, layer, leaf, tensor in self.jax_entries():
            tree[collection].setdefault(layer, {})[leaf] = tensor.detach().cpu().numpy()
        return fold_corrector_params(tree["params"], tree["batch_stats"] or None)


def apply_f_chunked(f: nn.Module, flat: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """Apply spot classifier ``f`` over a flattened spot batch.

    ``chunk=None``: one batched call. Otherwise chunks of ``chunk`` spots;
    when gradients are on, each chunk runs under activation checkpointing
    (the reference's ``atonce_patch_limit``), and under ``torch.no_grad()``
    (serving) it is a plain loop.
    """
    if chunk is None or flat.shape[0] <= chunk:
        return f(flat)
    if torch.is_grad_enabled():
        return torch.cat([checkpoint(f, part, use_reentrant=False)
                          for part in torch.split(flat, chunk)])
    return torch.cat([f(part) for part in torch.split(flat, chunk)])


class _GridNetBase(nn.Module):
    """Shared f-application machinery; subclasses define the corrector.

    f always runs in eval mode, as in the JAX package (``train=False``
    inside GridNet): ``train()`` leaves it in eval mode, so its norms use
    running statistics and dropout stays off. Gradients still reach it.
    """

    def __init__(self, patch_classifier: nn.Module, n_classes: int,
                 f_dim: Optional[int] = None, patch_chunk: Optional[int] = None):
        super().__init__()
        self.patch_classifier = patch_classifier.eval()
        self.n_classes = n_classes
        self.f_dim = f_dim
        self.patch_chunk = patch_chunk

    def train(self, mode: bool = True):
        super().train(mode)
        self.patch_classifier.eval()
        return self

    def patch_predictions(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, *spot_shape) -> (B, H, W, f_dim) grid of f outputs."""
        b, h, w = x.shape[:3]
        out = apply_f_chunked(self.patch_classifier,
                              x.reshape((b * h * w,) + tuple(x.shape[3:])),
                              self.patch_chunk)
        if self.f_dim is not None and out.shape[-1] != self.f_dim:
            raise ValueError(f"patch classifier produced {out.shape[-1]} "
                             f"features, but f_dim={self.f_dim} was declared")
        return out.reshape(b, h, w, out.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.corrector(self.patch_predictions(x))


class GridNetHex(_GridNetBase):
    """Visium GridNet with the hexagonal corrector, odd-right native.

    ``f_dim`` is the width of f's output (its ``n_classes`` for a
    classifying f); the corrector is built for it.
    """

    def __init__(self, patch_classifier: nn.Module, n_classes: int, f_dim: int,
                 use_bn: bool = True, patch_chunk: Optional[int] = None):
        super().__init__(patch_classifier, n_classes, f_dim, patch_chunk)
        self.corrector = _HexCorrector(f_dim, n_classes, use_bn)
