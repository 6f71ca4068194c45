"""DenseNet-BC spot classifier f over image patches, in f32 and eval mode.

Port of ``gridnext_tpu/models/densenet.py``: the same blocks, bottleneck
widths, compression, stem variants (``small_inputs``) and ``classify=False``
mode (the pooled features instead of logits). DenseNet-121
(:func:`densenet121`) is the checkpoint-parity f: the reference's trained
``densenet_ba44_p128.pth`` converts to the JAX package's tree with
``compat/torch_convert.densenet_from_torch``, and that tree loads here with
:func:`gridnext_tpu_torch.compat.from_jax.load_densenet`.

Layouts follow the JAX package at the module boundary: patches are
``(N, P, P, 3)`` channels-last floats; the module converts to NCHW inside.
Numerics follow flax: BatchNorm epsilon 1e-5 (not the 1e-6 of the norms in
``tpu_f``); the stem's ``max_pool`` pads with -inf, which is
``MaxPool2d(3, 2, padding=1)``; the transitions' 2x2 VALID ``avg_pool``
floors odd sizes (9x9 pools to 4x4), as ``AvgPool2d(2, 2)`` does.

Serving only: the module runs in eval mode (BatchNorm on running
statistics). The JAX module's ``dtype``, ``efficient`` (rematerialisation)
and ``drop_rate`` options serve training and are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax BatchNorm epsilon in the JAX DenseNet


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)


class _DenseLayer(nn.Module):
    """BN-ReLU-1x1 conv to ``bn_size * growth``, BN-ReLU-3x3 conv to ``growth``."""

    def __init__(self, c_in: int, growth_rate: int, bn_size: int):
        super().__init__()
        width = bn_size * growth_rate
        self.norm1 = _bn(c_in)
        self.conv1 = nn.Conv2d(c_in, width, 1, bias=False)
        self.norm2 = _bn(width)
        self.conv2 = nn.Conv2d(width, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(torch.relu(self.norm1(x)))
        return self.conv2(torch.relu(self.norm2(h)))


class _Transition(nn.Module):
    """BN-ReLU-1x1 conv, then a 2x2 stride-2 average pool (floors odd sizes)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.norm = _bn(c_in)
        self.conv = nn.Conv2d(c_in, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] < 2 or x.shape[-1] < 2:
            raise ValueError(
                f"input patches too small: spatial dims are "
                f"{tuple(x.shape[-2:])} at a transition's 2x2 pool (would "
                "collapse to zero); densenet121 needs >= 32px patches")
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """DenseNet-BC over ``(N, P, P, 3)`` channels-last patches.

    ``forward(x)`` returns ``(N, num_classes)`` logits, or
    ``(N, num_features)`` pooled features with ``classify=False``. Arguments
    as the flax module's (``drop_rate``, ``efficient`` and ``dtype`` are
    not ported).
    """

    def __init__(self, growth_rate: int = 12, block_config: Sequence[int] = (16, 16, 16),
                 compression: float = 0.5, num_init_features: int = 24,
                 bn_size: int = 4, num_classes: int = 10, small_inputs: bool = True,
                 classify: bool = True):
        super().__init__()
        if not 0 < compression <= 1:
            raise ValueError(f"compression must be in (0, 1], got {compression}")
        if small_inputs:
            self.conv0 = nn.Conv2d(3, num_init_features, 3, padding=1, bias=False)
            self.norm0 = None
        else:
            self.conv0 = nn.Conv2d(3, num_init_features, 7, stride=2, padding=3,
                                   bias=False)
            self.norm0 = _bn(num_init_features)
        self.blocks = nn.ModuleList()
        self.transitions = nn.ModuleList()
        c = num_init_features
        for i, n_layers in enumerate(block_config):
            self.blocks.append(nn.ModuleList(
                _DenseLayer(c + j * growth_rate, growth_rate, bn_size)
                for j in range(n_layers)))
            c += n_layers * growth_rate
            if i != len(block_config) - 1:
                features = int(c * compression)
                self.transitions.append(_Transition(c, features))
                c = features
        self.num_features = c   # width of the pooled features (classify=False)
        self.norm_final = _bn(c)
        self.classifier = nn.Linear(c, num_classes) if classify else None
        self.eval()   # serving only: BatchNorm on running statistics

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv0(x.float().permute(0, 3, 1, 2))   # NHWC -> NCHW
        if self.norm0 is not None:
            x = F.max_pool2d(torch.relu(self.norm0(x)), 3, 2, padding=1)
        for i, block in enumerate(self.blocks):
            for layer in block:
                x = torch.cat([x, layer(x)], dim=1)
            if i < len(self.transitions):
                x = self.transitions[i](x)
        x = torch.relu(self.norm_final(x)).mean(dim=(2, 3))
        return self.classifier(x) if self.classifier is not None else x


def densenet121(num_classes: int, **kw) -> DenseNet:
    """The tutorial / ``densenet_ba44`` configuration (224- or 128-px stem)."""
    return DenseNet(growth_rate=32, block_config=(6, 12, 24, 16),
                    num_init_features=64, bn_size=4, num_classes=num_classes,
                    small_inputs=False, **kw)
