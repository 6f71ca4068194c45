"""The GridNet family: spot classifiers f composed with a grid corrector g.

Port of ``gridnext_tpu/models/gridnet.py``. Tensors are channels-last:
image grids ``(B, H, W, P, P, 3)`` and count grids ``(B, H, W, G)`` in,
``(B, H, W, n_classes)`` logits out. Visium's pseudo-hex lattice takes the
hex corrector (:class:`GridNetHex`, :class:`GridNetHexMM`); square
lattices (Visium HD bins) take the Cartesian conv corrector
(:class:`GridNet`, :class:`GridNetMM`); :class:`ConcatGridNet` is the
Cartesian corrector alone over concatenated feature grids.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gridnext_tpu_torch.models.layers import BatchNorm, HexConv
from gridnext_tpu_torch.ops.hexcorrector_cuda import fold_corrector_params


class _CartesianCorrector(nn.Module):
    """The square-lattice corrector: 3x3, 5x5, 5x5, 3x3 convs at
    ``n_classes`` channels (zero padding 1, 2, 2, 1), each of the first
    three followed by BatchNorm (with ``use_bn``) and ReLU.

    Channels-last ``(B, H, W, C)`` in and out, like the JAX package's
    ``nn.Conv`` stack (a cross-correlation, as ``conv2d``); flax's BatchNorm
    runs over (B, H, W).
    ``width`` is the hidden channel count (default ``n_classes``; the
    concat fusion corrector holds its input width).
    """

    def __init__(self, in_features: int, n_classes: int, use_bn: bool = True,
                 width: Optional[int] = None):
        super().__init__()
        width = n_classes if width is None else width
        dims = (in_features, width, width, width, n_classes)
        self.use_bn = use_bn
        self.convs = nn.ModuleList(nn.Conv2d(dims[i], dims[i + 1], k, padding=k // 2)
                                   for i, k in enumerate((3, 5, 5, 3)))
        if use_bn:
            self.bns = nn.ModuleList(BatchNorm(width, axis=1) for _ in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = self.convs[i](x)
            if self.use_bn:
                x = self.bns[i](x)
            x = torch.relu(x)
        return self.convs[3](x).permute(0, 2, 3, 1)

    def jax_entries(self):
        """(collection, layer, leaf, tensor, layout) of every weight, named
        as in the JAX package (``Conv_i`` kernel/bias, ``BatchNorm_j``
        scale/bias and batch_stats mean/var); ``layout`` is 'conv' for the
        kernels (flax HWIO, torch OIHW)."""
        for i, conv in enumerate(self.convs):
            yield "params", f"Conv_{i}", "kernel", conv.weight, "conv"
            yield "params", f"Conv_{i}", "bias", conv.bias, "same"
        if self.use_bn:
            for j, bn in enumerate(self.bns):
                yield "params", f"BatchNorm_{j}", "scale", bn.weight, "same"
                yield "params", f"BatchNorm_{j}", "bias", bn.bias, "same"
                yield "batch_stats", f"BatchNorm_{j}", "mean", bn.running_mean, "same"
                yield "batch_stats", f"BatchNorm_{j}", "var", bn.running_var, "same"


class _HexCorrector(nn.Module):
    """Five radius-1 hex convs: f_dim->32->32 [BN,ReLU] ->32->32 [BN,ReLU] ->n_classes.

    flax's BatchNorm runs over every cell of the (B, H, W, C) grid (all axes
    but the last).
    """

    def __init__(self, in_features: int, n_classes: int, use_bn: bool = True,
                 width: int = 32):
        super().__init__()
        self.use_bn = use_bn
        dims = (in_features, width, width, width, width, n_classes)
        self.convs = nn.ModuleList(HexConv(dims[i], dims[i + 1]) for i in range(5))
        if use_bn:
            self.bns = nn.ModuleList(BatchNorm(width) for _ in range(2))

    def _bn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.bns[i](x) if self.use_bn else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs[1](self.convs[0](x))
        x = torch.relu(self._bn(0, x))
        x = self.convs[3](self.convs[2](x))
        x = torch.relu(self._bn(1, x))
        return self.convs[4](x)

    def jax_entries(self):
        """(collection, layer, leaf, tensor, layout) of every weight, named
        as in the JAX package's corrector (``HexConv_i`` kernel/bias,
        ``BatchNorm_j`` scale/bias and batch_stats mean/var); the weight
        bridge and :meth:`folded` both read it."""
        for i, conv in enumerate(self.convs):
            yield "params", f"HexConv_{i}", "kernel", conv.kernel, "same"
            yield "params", f"HexConv_{i}", "bias", conv.bias, "same"
        if self.use_bn:
            for j, bn in enumerate(self.bns):
                yield "params", f"BatchNorm_{j}", "scale", bn.weight, "same"
                yield "params", f"BatchNorm_{j}", "bias", bn.bias, "same"
                yield "batch_stats", f"BatchNorm_{j}", "mean", bn.running_mean, "same"
                yield "batch_stats", f"BatchNorm_{j}", "var", bn.running_var, "same"

    def folded(self):
        """(kernels, biases, relu_flags) with eval-mode BatchNorm folded in,
        for the serving corrector kernels."""
        tree = {"params": {}, "batch_stats": {}}
        for collection, layer, leaf, tensor, _ in self.jax_entries():
            tree[collection].setdefault(layer, {})[leaf] = tensor.detach().cpu().numpy()
        return fold_corrector_params(tree["params"], tree["batch_stats"] or None)


def apply_f_chunked(f: nn.Module, flat: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """Apply spot classifier ``f`` over a flattened spot batch.

    ``chunk=None``: one batched call. Otherwise chunks of ``chunk`` spots;
    when f trains (gradients on and some f parameter requires one), each
    chunk runs under activation checkpointing (the reference's
    ``atonce_patch_limit``). An f with no trainable parameter (frozen: no
    optimizer of its own) runs under ``torch.no_grad()`` as a plain loop,
    as serving does: JAX computes and discards its gradients, which XLA
    drops as dead work, so here none are built.
    """
    trains = torch.is_grad_enabled() and any(p.requires_grad for p in f.parameters())
    with torch.set_grad_enabled(trains):
        if chunk is None or flat.shape[0] <= chunk:
            return f(flat)
        if trains:
            return torch.cat([checkpoint(f, part, use_reentrant=False)
                              for part in torch.split(flat, chunk)])
        return torch.cat([f(part) for part in torch.split(flat, chunk)])


def apply_f_grid(f: nn.Module, x: torch.Tensor, chunk: Optional[int],
                 f_dim: Optional[int] = None, what: str = "patch classifier"
                 ) -> torch.Tensor:
    """(B, H, W, *spot_shape) -> (B, H, W, f_dim): flatten, run f chunked
    over every cell, re-grid; shared by the unimodal and MM models."""
    b, h, w = x.shape[:3]
    out = apply_f_chunked(f, x.reshape((b * h * w,) + tuple(x.shape[3:])), chunk)
    if f_dim is not None and out.shape[-1] != f_dim:
        raise ValueError(f"{what} produced {out.shape[-1]} features, but "
                         f"f_dim={f_dim} was declared")
    return out.reshape(b, h, w, out.shape[-1])


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
        return apply_f_grid(self.patch_classifier, x, self.patch_chunk, self.f_dim)

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


class GridNet(_GridNetBase):
    """Square-lattice GridNet (Visium HD bins): the Cartesian conv
    corrector over f's ``(B, H, W, f_dim)`` output grid."""

    def __init__(self, patch_classifier: nn.Module, n_classes: int, f_dim: int,
                 use_bn: bool = True, patch_chunk: Optional[int] = None):
        super().__init__(patch_classifier, n_classes, f_dim, patch_chunk)
        self.corrector = _CartesianCorrector(f_dim, n_classes, use_bn)


class ConcatGridNet(nn.Module):
    """Feature-concat fusion g: the corrector alone, over pre-computed
    ``(B, H, W, in_features)`` feature or logit grids (e.g. a count model's
    logits concatenated with an image model's). A Cartesian 3/5/5/3 conv
    stack held at the input width, ReLUs and no BatchNorm;
    ``patch_predictions`` is the identity. ``in_features`` is the concat
    width (flax reads it from the input; torch needs it up front)."""

    def __init__(self, in_features: int, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.corrector = _CartesianCorrector(in_features, n_classes, use_bn=False,
                                             width=in_features)

    def patch_predictions(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.corrector(x)


class GridNetHexMM(nn.Module):
    """Multimodal GridNet: an f per modality, channel-concat fusion, the
    hex corrector.

    ``forward((x_image, x_count))`` with ``x_image`` ``(B, H, W, P, P, 3)``
    and ``x_count`` ``(B, H, W, G)``. Each f runs over every cell of the
    grid (the count f in chunks of ``count_chunk``, default
    ``patch_chunk``); the outputs concatenate count first, then image, and
    the corrector takes ``count_f_dim + image_f_dim`` channels (each
    defaults to ``n_classes``). Both f stay in eval mode, as in
    :class:`GridNetHex`.
    """

    _corrector = _HexCorrector

    def __init__(self, image_classifier: nn.Module, count_classifier: nn.Module,
                 n_classes: int, image_f_dim: Optional[int] = None,
                 count_f_dim: Optional[int] = None, use_bn: bool = True,
                 patch_chunk: Optional[int] = None, count_chunk: Optional[int] = None):
        super().__init__()
        self.image_classifier = image_classifier.eval()
        self.count_classifier = count_classifier.eval()
        self.n_classes = n_classes
        self.image_f_dim = n_classes if image_f_dim is None else image_f_dim
        self.count_f_dim = n_classes if count_f_dim is None else count_f_dim
        self.patch_chunk = patch_chunk
        self.count_chunk = count_chunk
        self.corrector = self._corrector(self.count_f_dim + self.image_f_dim, n_classes,
                                         use_bn)

    def train(self, mode: bool = True):
        super().train(mode)
        self.image_classifier.eval()
        self.count_classifier.eval()
        return self

    def patch_predictions(self, x) -> torch.Tensor:
        """(x_image, x_count) -> (B, H, W, count_f_dim + image_f_dim)."""
        x_image, x_count = x
        cc = self.patch_chunk if self.count_chunk is None else self.count_chunk
        count = apply_f_grid(self.count_classifier, x_count, cc, self.count_f_dim,
                             "count classifier")
        image = apply_f_grid(self.image_classifier, x_image, self.patch_chunk,
                             self.image_f_dim, "image classifier")
        return torch.cat([count, image], dim=-1)

    def forward(self, x) -> torch.Tensor:
        return self.corrector(self.patch_predictions(x))


class GridNetMM(GridNetHexMM):
    """Square-lattice multimodal GridNet (Visium HD bins): the same concat
    fusion as :class:`GridNetHexMM` before the Cartesian conv corrector."""

    _corrector = _CartesianCorrector
