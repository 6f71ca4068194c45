"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only the port's
dependencies (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gridnext_tpu_torch.ops import hexcorrector_cuda as corr
from gridnext_tpu_torch.ops import patch_gather_cuda as gather
from gridnext_tpu_torch.serving import label_parity_report

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _gather_case(dev, b, h, w, n, win, seed):
    rng = np.random.default_rng(seed)
    imgs = torch.as_tensor(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
                           device=dev)
    y0 = rng.integers(-win, h + win, n).astype(np.int32)
    x0 = rng.integers(-win, w + win, n).astype(np.int32)
    slide = rng.integers(-1, b + 1, n).astype(np.int32)   # includes out-of-range ids
    return imgs, *(torch.as_tensor(a, device=dev) for a in (y0, x0, slide))


@pytest.mark.parametrize("b,h,w,n,win", [(2, 150, 300, 64, 24), (1, 97, 131, 33, 97),
                                         (3, 400, 260, 500, 128)])
def test_gather_kernel_bit_exact(dev, b, h, w, n, win):
    imgs, y0, x0, slide = _gather_case(dev, b, h, w, n, win, seed=n)
    before = gather.launches
    got = gather.gather_patches(imgs, y0, x0, win, slide)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_patches_plain(imgs, y0, x0, win, slide))


def test_gather_kernel_single_slide_and_empty(dev):
    imgs, y0, x0, _ = _gather_case(dev, 1, 120, 90, 20, 32, seed=1)
    got = gather.gather_patches(imgs[0], y0, x0, 32)
    assert torch.equal(got, gather.gather_patches_plain(imgs[0], y0, x0, 32))
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    assert gather.gather_patches(imgs, empty, empty, 32).shape == (0, 32, 32, 3)
    with pytest.raises(ValueError, match="smaller than"):
        gather.gather_patches(imgs, y0, x0, 121)


def _corrector_case(dev, c_in, n_classes, b=2, seed=0):
    rng = np.random.default_rng(seed)
    dims = (c_in, 32, 32, 32, 32, n_classes)
    kernels = [rng.normal(size=(7, dims[i], dims[i + 1])).astype(np.float32)
               / np.sqrt(7 * dims[i]) for i in range(5)]
    biases = [rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1 for i in range(5)]
    x = torch.as_tensor(rng.normal(size=(b, 78, 64, c_in)).astype(np.float32), device=dev)
    fg = torch.as_tensor((rng.random((b, 78, 64)) < 0.6).astype(np.int32), device=dev)
    return x, fg, corr.as_f32_tensors(kernels, dev), corr.as_f32_tensors(biases, dev)


@pytest.mark.parametrize("c_in,n_classes", [(7, 7), (3, 5), (64, 32)])
def test_corrector_kernels_match_plain(dev, c_in, n_classes):
    x, fg, kernels, biases = _corrector_case(dev, c_in, n_classes)
    before = dict(corr.launches)
    logits = corr.fused_hex_corrector(x, kernels, biases)
    labels = corr.fused_hex_corrector_labels(x, fg, kernels, biases)
    plain = corr.hex_corrector_plain(x, kernels, biases)
    plain_labels = corr.hex_corrector_labels_plain(x, fg, kernels, biases)
    torch.cuda.synchronize()
    assert corr.launches["fused_hex_corrector"] == before["fused_hex_corrector"] + 5
    assert (corr.launches["fused_hex_corrector_labels"]
            == before["fused_hex_corrector_labels"] + 5)
    assert (logits - plain).abs().max().item() <= 1e-4
    for i in range(x.shape[0]):
        label_parity_report(plain_labels[i].cpu().numpy(), labels[i].cpu().numpy(),
                            plain[i].cpu().numpy())


def test_corrector_labels_kernel_ties_and_class_limit(dev):
    x = torch.zeros((1, 4, 4, 3), device=dev)
    kernels = [torch.zeros((7, 3, 3), device=dev)]
    biases = [torch.tensor([1.0, 1.0, 0.5], device=dev)]
    fg = torch.ones((1, 4, 4), dtype=torch.int32, device=dev)
    fg[0, 0, 0] = 0
    got = corr.fused_hex_corrector_labels(x, fg, kernels, biases, (False,))
    want = torch.ones((1, 4, 4), dtype=torch.int32)
    want[0, 0, 0] = 0
    assert torch.equal(got.cpu(), want)   # ties take the first class
    with pytest.raises(ValueError, match="at most 32"):
        corr.fused_hex_corrector_labels(
            x, fg, [torch.zeros((7, 3, 33), device=dev)],
            [torch.zeros(33, device=dev)], (False,))
