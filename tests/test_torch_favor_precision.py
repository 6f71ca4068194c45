"""Why the FAVOR kernel multiplies in split TF32 and not in one TF32 pass.

``csrc/favor.cu`` runs its four products (phi(k), ctx, phi(q), out) on the
tensor cores with TF32 operands. One TF32 pass keeps 10 mantissa bits of
each operand; the kernel splits every operand into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` (both toward zero: hi by clearing the low 13 mantissa
bits, lo by the tensor core reading an f32 as TF32) and sums
``lo hi + hi lo + hi hi`` in f32. This file emulates that operand rounding
in plain PyTorch on the CPU (products summed in float64, as the card's f32
sums would only add a little) and holds it against
:func:`favor_attention_plain` with the kernel's card tolerance, rtol 2e-4 /
atol 2e-5: the split stays inside it at the card tests' shapes (B H cut to
1-2), one pass does not, whether it rounds to nearest or toward zero.
"""

import numpy as np
import pytest
import torch

from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix
from gridnext_tpu_torch.ops.favor_cuda import favor_attention_plain

RTOL, ATOL = 2e-4, 2e-5     # tests/test_favor_pallas.py and the card tests


def _tf32(x: torch.Tensor, nearest: bool = False) -> torch.Tensor:
    """float32 ``x`` as TF32: the low 13 mantissa bits dropped, toward zero
    (as the kernel splits and the tensor core reads an f32) or to nearest,
    ties away from zero (as ``cvt.rna.tf32.f32`` rounds)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if nearest else 0)) & -0x2000).view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, split: bool,
            nearest: bool = False) -> torch.Tensor:
    """``a @ b`` with TF32 operands: split as the kernel splits (three
    products), or one pass rounded toward zero or to nearest."""
    a_hi, b_hi = _tf32(a, nearest), _tf32(b, nearest)
    if not split:
        return (a_hi.double() @ b_hi.double()).float()
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    a_hi, b_hi, a_lo, b_lo = (t.double() for t in (a_hi, b_hi, a_lo, b_lo))
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).float()


def _kernel_arithmetic(q, k, v, proj, split: bool, nearest: bool = False) -> torch.Tensor:
    """The kernel's four products with TF32 operands; ksum and the
    denominator in full precision, as the kernel sums them on the CUDA
    cores."""
    scale = q.shape[-1] ** -0.25

    def features(x):
        return torch.relu(_matmul(scale * x, proj.T, split, nearest)) + 1e-3

    qf, kf = features(q), features(k)
    ksum = kf.double().sum(-2)
    ctx = _matmul(kf.transpose(-1, -2), v, split, nearest)
    num = _matmul(qf, ctx, split, nearest)
    den = (qf.double() @ ksum[..., None]).float()
    return num / den


def _case(b, h, n, d, m, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(np.float32))
               for _ in range(3))
    proj = orthogonal_gaussian_matrix(m, d, generator=torch.Generator().manual_seed(seed))
    return q, k, v, proj


def _worst(b, h, n, d, m, split: bool, nearest: bool = False) -> float:
    """Largest |emulated - plain| / (atol + rtol |plain|): 1 is the limit."""
    q, k, v, proj = _case(b, h, n, d, m, seed=n)
    want = favor_attention_plain(q, k, v, proj)
    got = _kernel_arithmetic(q, k, v, proj, split, nearest)
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 30)
    for nearest, ulps in ((True, 2.0 ** -11), (False, 2.0 ** -10)):
        r = _tf32(x, nearest)
        assert not (r.view(torch.int32) & 0x1FFF).any()
        assert ((r - x).abs() <= x.abs() * ulps).all()
    assert ((_tf32(x) - x) * x <= 0).all()               # toward zero
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert _tf32(tie, nearest=True).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    hi = _tf32(x)                                         # the kernel's split
    assert ((x - hi - _tf32(x - hi)).abs() <= x.abs() * 2.0 ** -20).all()


@pytest.mark.parametrize("b,h,n,d,m", [
    (1, 1, 16907, 64, 266),      # scBERT's N and m
    (1, 2, 700, 16, 37),
    (1, 2, 1030, 64, 37),
    (1, 2, 45, 64, 266),
    (1, 1, 512, 32, 64),
    (1, 2, 3001, 16, 266)],
    ids=["scbert", "d16-m37", "bh160", "short", "d32", "d16-m266"])
def test_split_tf32_keeps_the_f32_tolerance(b, h, n, d, m):
    assert _worst(b, h, n, d, m, split=True) <= 0.25


@pytest.mark.parametrize("nearest", [True, False], ids=["nearest", "toward-zero"])
def test_one_tf32_pass_misses_the_f32_tolerance(nearest):
    assert _worst(3, 2, 45, 64, 266, split=False, nearest=nearest) > 1.0
