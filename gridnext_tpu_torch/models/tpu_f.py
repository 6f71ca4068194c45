"""TpuPatchClassifier: the residual ConvNet spot classifier f.

Port of ``gridnext_tpu/models/tpu_f.py``: a patchify stem, then per stage an
optional 2x2/2 downsample conv and ``depth`` pre-norm residual blocks of two
3x3 convs, global average pooling and a linear head. Every conv has
128-multiple output channels.

Layouts follow the JAX package at the module boundary: patches are
``(N, P, P, 3)`` channels-last floats; f converts to NCHW inside. Numerics
follow flax: LayerNorm/RMSNorm over channels with epsilon 1e-6 (flax's
default; the stats use the one-pass ``E[x^2] - E[x]^2`` variance, as flax's
``use_fast_variance``), ``"SAME"`` 3x3 convs (pad 1), and ``"SAME"`` 2x2/2
downsamples (no pad on even sizes; one pad row/column at the end on odd).
``dtype`` (e.g. ``torch.bfloat16``) computes the convolutions and the head
in that type under autocast with float32 parameters, as flax's ``dtype``
(the norms reduce in float32); ``dropout`` drops the pooled features before
the head in train mode.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gridnext_tpu_torch.models.layers import Dropout

NORM_EPS = 1e-6  # flax LayerNorm / RMSNorm default epsilon


class ChannelNorm(nn.Module):
    """flax ``LayerNorm`` ('layer') or ``RMSNorm`` ('rms') over the channel
    axis of an NCHW tensor; 'none' is the identity."""

    def __init__(self, kind: str, channels: int, eps: float = NORM_EPS):
        super().__init__()
        if kind not in ("layer", "rms", "none"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.eps = eps
        if kind != "none":
            self.scale = nn.Parameter(torch.ones(channels))
        if kind == "layer":
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return x
        dtype, x = x.dtype, x.float()
        mean2 = (x * x).mean(dim=1, keepdim=True)
        if self.kind == "rms":
            y = x * torch.rsqrt(mean2 + self.eps)
            return (y * self.scale.view(1, -1, 1, 1)).to(dtype)
        mean = x.mean(dim=1, keepdim=True)
        var = (mean2 - mean * mean).clamp_min(0.0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)).to(dtype)


class _Block(nn.Module):
    """Pre-norm residual block: two 3x3 convs."""

    def __init__(self, width: int, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(width, width, 3, padding=1)
        self.norm1 = ChannelNorm(norm, width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1)
        self.norm2 = ChannelNorm(norm, width)

    def forward(self, x):
        h = torch.relu(self.norm1(self.conv1(x)))
        h = self.conv2(h)
        return torch.relu(self.norm2(x + h))


class _Downsample(nn.Module):
    """2x2 stride-2 conv with flax ``"SAME"`` padding (pad at the end only)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 2, stride=2)

    def forward(self, x):
        ph, pw = x.shape[-2] % 2, x.shape[-1] % 2
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        return self.conv(x)


class TpuPatchClassifier(nn.Module):
    """Residual ConvNet with 128-multiple channels everywhere.

    ``forward(x)`` maps ``(N, P, P, 3)`` floats to ``(N, n_classes)``
    float32 logits, or ``(N, width)`` pooled features with
    ``classify=False``.
    """

    def __init__(self, n_classes: int = 7,
                 stages: Sequence[Tuple[int, int]] = ((256, 2), (512, 2)),
                 stem_patch: int = 16, norm: str = "rms", classify: bool = True,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stages_spec = tuple((int(w), int(d)) for w, d in stages)
        self.stem_patch = int(stem_patch)
        w0 = self.stages_spec[0][0]
        self.stem = nn.Conv2d(3, w0, self.stem_patch, stride=self.stem_patch)
        self.stem_norm = ChannelNorm(norm, w0)
        self.downs = nn.ModuleList()
        self.blocks = nn.ModuleList()
        c = w0
        for width, depth in self.stages_spec:
            self.downs.append(_Downsample(c, width) if c != width else nn.Identity())
            self.blocks.append(nn.ModuleList(_Block(width, norm) for _ in range(depth)))
            c = width
        self.dropout = Dropout(dropout)
        self.head = nn.Linear(c, n_classes) if classify else None

    def jax_order(self):
        """Convs and norms in the order flax creates them in
        ``TpuPatchClassifier.__call__``: the stem conv (named ``stem``), its
        norm, then per stage the downsample conv (if any) and per block
        conv, norm, conv, norm. flax numbers unnamed ``Conv`` and norm
        modules in this order (``Conv_0``, ``RMSNorm_0``, ...)."""
        yield self.stem
        yield self.stem_norm
        for down, blocks in zip(self.downs, self.blocks):
            if isinstance(down, _Downsample):
                yield down.conv
            for blk in blocks:
                yield from (blk.conv1, blk.norm1, blk.conv2, blk.norm2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        min_px = self.stem_patch * 2 ** (len(self.stages_spec) - 1)
        if x.shape[-3] < min_px or x.shape[-2] < min_px:
            raise ValueError(
                f"input patches {tuple(x.shape[-3:-1])} too small for "
                f"stem_patch={self.stem_patch} with {len(self.stages_spec)} "
                f"stages: use patches of at least {min_px}px")
        with torch.autocast(x.device.type, dtype=self.dtype or torch.bfloat16,
                            enabled=self.dtype is not None):
            x = x.float().permute(0, 3, 1, 2)  # NHWC -> NCHW
            x = self.stem_norm(self.stem(x))
            for down, blocks in zip(self.downs, self.blocks):
                x = down(x)
                for blk in blocks:
                    x = blk(x)
            x = x.mean(dim=(2, 3))              # global average pool
            if self.head is None:
                return x.float()
            return self.head(self.dropout(x)).float()


def tpu_f_arch_meta(f: TpuPatchClassifier) -> dict:
    """Architecture fields for model.json: what reconstructs this exact f at
    register time whatever the class defaults become."""
    return {"stages": [list(s) for s in f.stages_spec],
            "stem_patch": int(f.stem_patch), "norm": f.stem_norm.kind}


def tpu_f_arch_kwargs(meta: Optional[dict]) -> dict:
    """model.json ``tpu_f`` dict -> TpuPatchClassifier constructor kwargs.

    ``None``/missing means a checkpoint from before the field existed,
    trained on the original default shape: stages ((128,2),(256,2),(512,2)),
    stem 8, LayerNorm.
    """
    if not meta:
        return {"stages": ((128, 2), (256, 2), (512, 2)),
                "stem_patch": 8, "norm": "layer"}
    return {"stages": tuple((int(w), int(d)) for w, d in meta["stages"]),
            "stem_patch": int(meta["stem_patch"]),
            "norm": str(meta["norm"])}
