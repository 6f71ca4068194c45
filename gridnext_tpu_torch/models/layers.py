"""Shared layers: the hex convolution, flax's BatchNorm (over the global
batch on a mesh) and a dropout that draws from an explicit generator."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gridnext_tpu_torch.ops.hexconv import hex_conv, num_taps
from gridnext_tpu_torch.parallel import collectives


class HexConv(nn.Module):
    """Hexagonal convolution layer over odd-right ``(..., H, W, C)`` grids.

    Weights are per-tap full matrices ``kernel (T, C_in, C_out)`` in
    ``geometry.hex_taps(radius)`` order, the JAX package's layout, so a
    flax ``HexConv`` kernel loads unchanged. Init: xavier-uniform over the
    full ``(T*C_in, C_out)`` tap fan, zero bias, as the flax layer does.
    """

    def __init__(self, in_features: int, features: int, radius: int = 1):
        super().__init__()
        self.radius = radius
        t = num_taps(radius)
        bound = math.sqrt(6.0 / (t * in_features + features))
        self.kernel = nn.Parameter(
            torch.empty(t, in_features, features).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hex_conv(x, self.kernel, self.bias, radius=self.radius)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis of the input but ``axis``.

    Train mode normalises with the batch's mean and its **biased** variance
    and moves the running statistics as flax does: ``running = momentum *
    running + (1 - momentum) * batch`` (flax's momentum, 0.9; torch's
    ``BatchNorm`` would take 0.1 and move the variance by the unbiased
    estimate, ``n / (n - 1)`` larger). The statistics are reduced in
    float32 or wider. Eval mode normalises with the running statistics. The
    weights keep ``nn.BatchNorm``'s names (``weight``, ``bias``,
    ``running_mean``, ``running_var``), which the weight bridge maps to
    flax's ``scale``, ``bias``, ``mean`` and ``var``.

    On a mesh (inside :func:`~gridnext_tpu_torch.parallel.collectives.sharded`
    with a group of more than one rank) train mode takes the statistics of
    the global batch: each rank's count and sum, then its sum of squared
    deviations from the global mean (float32 or wider), are all-reduced,
    differentiably, so every rank normalises with the global batch's mean
    and biased variance and moves its running statistics alike
    (``nn.SyncBatchNorm`` would move the running variance by the unbiased
    estimate with momentum 0.1).
    """

    def __init__(self, num_features: int, axis: int = -1, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.axis, self.momentum, self.eps = axis, momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _channels_second(self, x: torch.Tensor) -> torch.Tensor:
        """x with its channel axis at 1 (a view), as ``F.batch_norm`` wants."""
        axis = self.axis % x.dim()
        if axis == 1:
            return x
        if axis == x.dim() - 1:
            return x.reshape(-1, x.shape[axis])
        return x.movedim(axis, 1)

    def _moved(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = momentum * running + (1 - momentum) * batch``."""
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), 1.0 - self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), 1.0 - self.momentum)

    def update_stats(self, x: torch.Tensor) -> None:
        """Move the running statistics by the batch's (no gradient); for a
        caller that normalises under activation checkpointing, where the
        forward would run twice."""
        with torch.no_grad():
            xc = self._channels_second(x)
            xc = xc.to(torch.promote_types(xc.dtype, torch.float32))
            group = collectives.batch_norm_group()
            if group is not None:
                mean, var = _global_moments(xc, group)
            else:
                var, mean = torch.var_mean(xc, [d for d in range(xc.dim()) if d != 1],
                                           correction=0)
        self._moved(mean, var)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """Normalised ``x``: with the batch's statistics in train mode (moving
        the running ones unless ``update_stats`` is False), the running ones
        in eval mode."""
        xc = self._channels_second(x)
        group = collectives.batch_norm_group() if self.training else None
        if group is not None:
            xf = xc.to(torch.promote_types(xc.dtype, torch.float32))
            mean, var = _global_moments(xf, group)
            shape = (1, -1) + (1,) * (xf.dim() - 2)
            scale = torch.rsqrt(var + self.eps) * self.weight
            y = ((xf - mean.view(shape)) * scale.view(shape)
                 + self.bias.view(shape)).to(xc.dtype)
            if update_stats:
                self._moved(mean.detach(), var.detach())
        elif self.training:
            # one reduction gives the output and the batch's mean and
            # 1 / sqrt(biased variance + eps)
            y, mean, invstd = torch.native_batch_norm(xc, self.weight, self.bias, None, None,
                                                      True, 0.0, self.eps)
            if update_stats:
                self._moved(mean, invstd.double().pow(-2) - self.eps)
        else:
            y = F.batch_norm(xc, self.running_mean, self.running_var, self.weight,
                             self.bias, training=False, eps=self.eps)
        axis = self.axis % x.dim()
        if axis == 1:
            return y
        return y.reshape(x.shape) if axis == x.dim() - 1 else y.movedim(1, axis)


def _global_moments(xf: torch.Tensor, group):
    """(mean, biased variance) over every axis of ``xf`` but 1 and every
    rank of ``group``, in two passes as one process's reduction makes them
    (E[x^2] - E[x]^2 in float32 cancels where the mean dwarfs the spread):
    a differentiable all-reduce of the local sums and count, then one of
    the local sums of squared deviations from the global mean."""
    c = xf.shape[1]
    dims = [d for d in range(xf.dim()) if d != 1]
    stats = collectives.all_reduce(
        torch.cat([xf.sum(dims), xf.new_full((1,), xf.numel() // c)]), group)
    n = stats[c]
    mean = stats[:c] / n
    dev = xf - mean.view((1, -1) + (1,) * (xf.dim() - 2))
    return mean, collectives.all_reduce((dev * dev).sum(dims), group) / n


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - rate`` and scale the kept by ``1 / (1 - rate)``; eval mode and
    ``rate == 0`` are the identity.

    The mask is drawn from :attr:`generator` (a ``torch.Generator`` on the
    input's device, or None for torch's default one); the trainers set it
    to a generator seeded by the step (:func:`set_dropout_generator`), so a
    resumed run draws the masks of an uninterrupted one; on a mesh a rank
    takes its rows of the global batch's mask, and on a ``seq`` axis the
    columns of its tokens
    (:func:`~gridnext_tpu_torch.parallel.collectives.draw_rows`).
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        # (B, N, ...) activations: on a seq axis the rank's tokens of the mask
        mask = collectives.draw_rows(
            lambda shape: torch.empty(shape, device=x.device).bernoulli_(
                keep, generator=self.generator), x.shape,
            token_dim=1 if x.dim() >= 3 else None)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
