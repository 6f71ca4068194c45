"""flax's initialisers for the port's models, drawn from a torch.Generator.

A model that trains from scratch starts from the distributions the JAX
package's ``model.init`` draws from (the bits cannot match: torch draws
from another generator):

* ``Dense`` and ``Conv`` kernels: lecun-normal (a normal truncated at two
  standard deviations, variance ``1 / fan_in`` after the truncation);
  biases zero;
* DenseNet's convolutions: ``_conv_init``, a normal of variance
  ``2 / (out * kh * kw)``;
* the Cartesian corrector's convolutions (``GridNet``, ``ConcatGridNet``)
  and ``HexConv``: xavier-uniform over the full fan, biases zero;
* token embeddings: a normal of variance ``1 / dim`` (``nn.Embed``);
* BatchNorm, LayerNorm and RMSNorm: scale one, bias zero, running mean
  zero and variance one;
* FAVOR projections: a fresh orthogonal Gaussian draw.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gridnext_tpu_torch.models.densenet import DenseNet
from gridnext_tpu_torch.models.gridnet import ConcatGridNet, _CartesianCorrector
from gridnext_tpu_torch.models.layers import BatchNorm, HexConv
from gridnext_tpu_torch.models.performer import FastAttention
from gridnext_tpu_torch.models.tpu_f import ChannelNorm
from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

# stddev of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def _xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, g: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-bound, bound, generator=g)


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every weight of ``model`` (in place) from flax's initialisers;
    returns it. ``generator`` is a CPU generator; the model may live on any
    device (each draw is made on the CPU and copied)."""
    densenet_convs, xavier_convs = set(), set()
    for m in model.modules():
        if isinstance(m, DenseNet):
            densenet_convs |= {id(c) for c in m.modules() if isinstance(c, nn.Conv2d)}
        if isinstance(m, (_CartesianCorrector, ConcatGridNet)):
            xavier_convs |= {id(c) for c in m.modules() if isinstance(c, nn.Conv2d)}

    def put(t: torch.Tensor, draw) -> None:
        cpu = torch.empty(t.shape, dtype=torch.float32)
        draw(cpu)
        t.copy_(cpu)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                out_c, in_c, kh, kw = m.weight.shape
                if id(m) in densenet_convs:
                    std = math.sqrt(2.0 / (out_c * kh * kw))
                    put(m.weight, lambda w: w.normal_(0.0, std, generator=generator))
                elif id(m) in xavier_convs:
                    put(m.weight, lambda w: _xavier_uniform_(w, in_c * kh * kw,
                                                             out_c * kh * kw, generator))
                else:
                    put(m.weight, lambda w: _lecun_normal_(w, in_c * kh * kw, generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                put(m.weight, lambda w: _lecun_normal_(w, m.in_features, generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, HexConv):
                t, c_in, c_out = m.kernel.shape
                put(m.kernel, lambda w: _xavier_uniform_(w, t * c_in, c_out, generator))
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                std = math.sqrt(1.0 / m.embedding_dim)
                put(m.weight, lambda w: w.normal_(0.0, std, generator=generator))
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, (nn.LayerNorm, ChannelNorm)):
                for name in ("weight", "scale"):
                    if getattr(m, name, None) is not None:
                        getattr(m, name).fill_(1.0)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, FastAttention) and not m.no_projection:
                m.projection.copy_(orthogonal_gaussian_matrix(
                    *m.projection.shape, generator=generator))
    return model
