"""The port's CUDA kernels against their plain PyTorch versions, on a card
(and the card's PCA fit against float64, the mesh registrar's launches).

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only the port's
dependencies (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gridnext_tpu_torch.ops import denseblock_cuda as dense
from gridnext_tpu_torch.ops import favor_cuda as favor
from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix
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
                                         (3, 400, 260, 500, 128),
                                         (2, 500, 420, 200, 160)])
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


@pytest.mark.parametrize("win", [24, 97, 128, 160])
def test_gather_kernel_every_source_residue(dev, win):
    """Source rows starting at every byte offset mod 16, from an aligned
    stack and from a slide view that starts 12 bytes past a 16-byte
    boundary, clamped corners and slide ids included: bit-exact, and the
    bulk-copy path exactly where a row is a multiple of 16 bytes."""
    b, h, w = 3, 2 * win + 7, 2 * win + 41
    rng = np.random.default_rng(win)
    stack = torch.as_tensor(rng.integers(0, 256, (b + 1, h, w, 3), dtype=np.uint8),
                            device=dev)
    # 16 consecutive corners of one row: 3 x0 runs through every residue mod 16
    x0 = np.concatenate([np.arange(16) + 5, [-3, w, w - win - 1]]).astype(np.int32)
    y0 = np.concatenate([np.full(16, 3), [h, -9, 2]]).astype(np.int32)
    slide = np.concatenate([np.full(16, 1), [b + 4, -2, 1]]).astype(np.int32)
    y0, x0, slide = (torch.as_tensor(a, device=dev) for a in (y0, x0, slide))
    offsets = set()
    for imgs in (stack[:b], stack[1:]):
        for yy, xx, ss in zip(y0[:16].tolist(), x0[:16].tolist(), slide[:16].tolist()):
            offsets.add((imgs.data_ptr() + 3 * ((ss * h + yy) * w + xx)) % 16)
        before, before_bytes = gather.launches, gather.byte_launches
        got = gather.gather_patches(imgs, y0, x0, win, slide)
        torch.cuda.synchronize()
        assert gather.launches == before + 1
        assert gather.byte_launches == before_bytes + (not gather.bulk(win))
        assert torch.equal(got, gather.gather_patches_plain(imgs, y0, x0, win, slide))
    assert offsets == set(range(16))


def _corrector_case(dev, c_in, n_classes, b=2, seed=0, width=32):
    rng = np.random.default_rng(seed)
    dims = (c_in, width, width, width, width, n_classes)
    kernels = [rng.normal(size=(7, dims[i], dims[i + 1])).astype(np.float32)
               / np.sqrt(7 * dims[i]) for i in range(5)]
    biases = [rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1 for i in range(5)]
    x = torch.as_tensor(rng.normal(size=(b, 78, 64, c_in)).astype(np.float32), device=dev)
    fg = torch.as_tensor((rng.random((b, 78, 64)) < 0.6).astype(np.int32), device=dev)
    return x, fg, corr.as_f32_tensors(kernels, dev), corr.as_f32_tensors(biases, dev)


@pytest.mark.parametrize("c_in,n_classes,width", [
    (7, 7, 32), (3, 5, 32), (64, 32, 32),
    (7, 33, 32), (14, 64, 32), (1024, 64, 32),   # above 32 classes; c_in beyond shared memory
    (300, 33, 32), (7, 7, 128), (5, 9, 12)],     # hidden bands in device scratch; narrow
    ids=["7-7", "3-5", "64-32", "7-33", "14-64", "1024-64", "300-33", "hidden128", "hidden12"])
def test_corrector_kernels_match_plain(dev, c_in, n_classes, width):
    x, fg, kernels, biases = _corrector_case(dev, c_in, n_classes, width=width)
    before = dict(corr.launches)
    logits = corr.fused_hex_corrector(x, kernels, biases)
    labels = corr.fused_hex_corrector_labels(x, fg, kernels, biases)
    plain = corr.hex_corrector_plain(x, kernels, biases)
    plain_labels = corr.hex_corrector_labels_plain(x, fg, kernels, biases)
    torch.cuda.synchronize()
    # one launch a call, all layers
    assert corr.launches["fused_hex_corrector"] == before["fused_hex_corrector"] + 1
    assert (corr.launches["fused_hex_corrector_labels"]
            == before["fused_hex_corrector_labels"] + 1)
    assert (logits - plain).abs().max().item() <= 1e-4
    for i in range(x.shape[0]):
        label_parity_report(plain_labels[i].cpu().numpy(), labels[i].cpu().numpy(),
                            plain[i].cpu().numpy())


def test_corrector_labels_kernel_ties_and_class_limit(dev):
    """Ties take the first class, within one output group, across groups and
    across 32-class tiles; 33 and 70 classes compute (the 32-class limit is
    gone) with the tie at the tile boundary."""
    x = torch.zeros((1, 4, 4, 3), device=dev)
    kernels = [torch.zeros((7, 3, 3), device=dev)]
    biases = [torch.tensor([1.0, 1.0, 0.5], device=dev)]
    fg = torch.ones((1, 4, 4), dtype=torch.int32, device=dev)
    fg[0, 0, 0] = 0
    got = corr.fused_hex_corrector_labels(x, fg, kernels, biases, (False,))
    want = torch.ones((1, 4, 4), dtype=torch.int32)
    want[0, 0, 0] = 0
    assert torch.equal(got.cpu(), want)   # ties take the first class
    for n, top in ((33, (9, 32)), (70, (40, 63, 64)), (20, (12, 19))):
        bias = torch.zeros(n, device=dev)
        bias[list(top)] = 2.0             # a tie between groups or tiles
        before = corr.launches["fused_hex_corrector_labels"]
        got = corr.fused_hex_corrector_labels(x, fg, [torch.zeros((7, 3, n), device=dev)],
                                              [bias], (False,))
        torch.cuda.synchronize()
        assert corr.launches["fused_hex_corrector_labels"] == before + 1
        want = torch.full((1, 4, 4), top[0] + 1, dtype=torch.int32)
        want[0, 0, 0] = 0
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,h,w,dims", [
    (2, 78, 64, (7,) + (32,) * 9 + (7,)),            # 10 layers (once at most 8)
    (70_000, 2, 2, (3, 4, 4, 5)),                     # more grids than gridDim.y's 65,535
    (1, 1920, 500, (7, 32, 32, 32, 32, 7)),           # bands in tiles of whole rows
    (1, 32, 20_000, (7, 32, 32, 32, 32, 7))],         # bands in tiles of part rows
    ids=["layers10", "grids70000", "tall", "wide"])
def test_corrector_kernel_any_depth_batch_and_grid(dev, b, h, w, dims):
    """Layer counts, batches and grid shapes the kernel once refused, one
    launch a call, against the plain version."""
    rng = np.random.default_rng(len(dims) + h)
    n = len(dims) - 1
    kernels = corr.as_f32_tensors([rng.normal(size=(7, dims[i], dims[i + 1])).astype(
        np.float32) / np.sqrt(7 * dims[i]) for i in range(n)], dev)
    biases = corr.as_f32_tensors([rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1
                                  for i in range(n)], dev)
    flags = tuple(i % 2 == 1 for i in range(n))
    x = torch.as_tensor(rng.normal(size=(b, h, w, dims[0])).astype(np.float32), device=dev)
    fg = torch.as_tensor((rng.random((b, h, w)) < 0.6).astype(np.int32), device=dev)
    before = dict(corr.launches)
    logits = corr.fused_hex_corrector(x, kernels, biases, flags)
    labels = corr.fused_hex_corrector_labels(x, fg, kernels, biases, flags)
    plain = corr.hex_corrector_plain(x, kernels, biases, flags)
    plain_labels = corr.hex_corrector_labels_plain(x, fg, kernels, biases, flags)
    torch.cuda.synchronize()
    assert corr.launches["fused_hex_corrector"] == before["fused_hex_corrector"] + 1
    assert (corr.launches["fused_hex_corrector_labels"]
            == before["fused_hex_corrector_labels"] + 1)
    assert (logits - plain).abs().max().item() <= 1e-4
    flips = (labels != plain_labels).nonzero()
    for i in flips[:, 0].unique().tolist():
        label_parity_report(plain_labels[i].cpu().numpy(), labels[i].cpu().numpy(),
                            plain[i].cpu().numpy())


def _dense_case(dev, b, h, w, c0, n_layers, growth=32, cb=128, seed=0):
    """Folded params of one dense block from a numpy seed (BatchNorm affines
    near 1 / 0, convs scaled by fan-in) and a (b, h, w, c0) input."""
    rng = np.random.default_rng(seed)
    layers, stats = [], []
    for l in range(n_layers):
        c_in = c0 + l * growth
        layers.append({
            "BatchNorm_0": {"scale": rng.uniform(0.8, 1.2, c_in), "bias": rng.normal(size=c_in) * 0.1},
            "Conv_0": {"kernel": rng.normal(size=(1, 1, c_in, cb)) / np.sqrt(c_in)},
            "BatchNorm_1": {"scale": rng.uniform(0.8, 1.2, cb), "bias": rng.normal(size=cb) * 0.1},
            "Conv_1": {"kernel": rng.normal(size=(3, 3, cb, growth)) / np.sqrt(9 * cb)}})
        stats.append({
            "BatchNorm_0": {"mean": rng.normal(size=c_in) * 0.1, "var": rng.uniform(0.5, 1.5, c_in)},
            "BatchNorm_1": {"mean": rng.normal(size=cb) * 0.1, "var": rng.uniform(0.5, 1.5, cb)}})
    folded = dense.fold_dense_block_params(layers, stats, c0, growth)
    arrays = [torch.as_tensor(folded[k], device=dev) for k in ("A1", "B1", "A2", "B2")]
    a1, b1, a2, b2 = arrays
    w1, w2 = (torch.as_tensor(folded[k], device=dev).to(torch.bfloat16) for k in ("W1", "W2"))
    x = torch.as_tensor(rng.normal(size=(b, h, w, c0)).astype(np.float32), device=dev)
    return x, (a1, b1, w1, a2, b2, w2)


@pytest.mark.parametrize("b,hw,c0,n_layers,growth,cb", [
    (3, 32, 64, 6, 32, 128), (5, 16, 128, 12, 32, 128), (7, 8, 256, 24, 32, 128),
    (9, 4, 512, 16, 32, 128),                        # DenseNet-121's four blocks
    (2, 12, 16, 3, 8, 32),                           # a small width
    (13, 8, 64, 2, 32, 128),                         # a ragged batch (13 * 64 px)
    (3, 9, 24, 3, 16, 48), (4, 7, 40, 2, 8, 24),     # odd sizes: 9x9, 7x7
    (1, 150, 16, 2, 8, 16),                          # rows wider than a tile
    (1, 32, 64, 6, 32, 128), (2, 32, 64, 6, 32, 128),  # block 1's bands in 1, 2 patches
    (5, 4, 512, 16, 32, 128),                        # block 4 at B = 5
    (3, 16, 8, 4, 32, 128)],                         # c_in0 8: a partial first K stage
    ids=["block1", "block2", "block3", "block4", "small", "ragged", "9x9", "7x7",
         "wide", "block1-b1", "block1-b2", "block4-b5", "c8"])
def test_dense_block_kernel_matches_plain(dev, b, hw, c0, n_layers, growth, cb):
    x, arrays = _dense_case(dev, b, hw, hw, c0, n_layers, growth, cb, seed=hw)
    before = dense.launches
    got = dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth)
    want = dense.fused_dense_block_plain(x, *arrays, c_in0=c0, growth=growth)
    torch.cuda.synchronize()
    assert dense.launches == before + n_layers
    assert got.dtype == torch.bfloat16 and got.shape == (b, hw, hw, c0 + n_layers * growth)
    _assert_dense_close(got, want, c0)


def _assert_dense_close(got, want, c0):
    got, want = got.float(), want.float()
    assert torch.equal(got[..., :c0], want[..., :c0])     # the input, unchanged
    # bf16 buffer, t rounded to bf16 in the kernel only: 3e-2 and correlation
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    corr_ = np.corrcoef(got.cpu().numpy().ravel(), want.cpu().numpy().ravel())[0, 1]
    assert corr_ > 0.999


@pytest.mark.parametrize("b,hw,c0,n_layers,override", [
    (2, 32, 64, 3, {"band_rows": 6}), (2, 32, 64, 3, {"band_rows": 8}),
    (2, 32, 64, 3, {"band_rows": 16}),               # 4, 4 and 2 ring stages
    (5, 4, 512, 4, {"patches": 4}), (7, 8, 256, 4, {"patches": 4})],  # ragged last CTA
    ids=["band6", "band8", "band16", "block4-b5-p4", "block3-b7-p4"])
def test_dense_block_kernel_other_plans(dev, b, hw, c0, n_layers, override):
    x, arrays = _dense_case(dev, b, hw, hw, c0, n_layers, seed=hw + 1)
    plan = dense.plan_dense_block(b, hw, hw, 128, **override)
    buf = torch.empty((b, hw, hw, c0 + 32 * n_layers), dtype=torch.bfloat16, device=dev)
    buf[..., :c0] = x
    got = dense._launch(buf, *arrays, c_in0=c0, growth=32, plan=plan)
    want = dense.fused_dense_block_plain(x, *arrays, c_in0=c0, growth=32)
    torch.cuda.synchronize()
    _assert_dense_close(got, want, c0)


@pytest.mark.parametrize("b,hw,c0,n_layers", [(2, 32, 64, 6), (9, 4, 512, 16), (3, 9, 24, 3)],
                         ids=["block1", "block4", "9x9"])
def test_dense_block_kernel_ignores_unwritten_channels(dev, b, hw, c0, n_layers):
    """Channels not yet written hold NaN before the call (as torch.empty may
    leave them); the kernel gives the same bits as on a clean buffer, and the
    same bits on every call."""
    growth = 16 if c0 == 24 else 32
    cb = 48 if c0 == 24 else 128
    x, arrays = _dense_case(dev, b, hw, hw, c0, n_layers, growth, cb, seed=7)
    buf = torch.full((b, hw, hw, c0 + growth * n_layers), float("nan"),
                     dtype=torch.bfloat16, device=dev)
    buf[..., :c0] = x
    got = dense._launch(buf, *arrays, c_in0=c0, growth=growth)
    again = dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth)
    third = dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again) and torch.equal(again, third)
    _assert_dense_close(got, dense.fused_dense_block_plain(x, *arrays, c_in0=c0,
                                                           growth=growth), c0)


@pytest.mark.parametrize("b,hw,c0,n_layers,growth,cb,route", [
    (1, 4, 12, 2, 8, 16, "wgmma"),            # c_in0 not a multiple of 8
    (3, 9, 24, 3, 12, 48, "wgmma"),           # growth 12, as the JAX DenseNet's default
    (2, 8, 20, 2, 6, 20, "wgmma"),            # every width unaligned
    (1, 4, 16, 1, 48, 192, "general"),        # growth above 32, Cb above 128
    (2, 7, 30, 3, 48, 192, "general"),
    (3, 5, 9, 2, 40, 136, "general")],        # unaligned and wide
    ids=["c12", "g12", "unaligned", "g48-b1", "g48", "wide-unaligned"])
def test_dense_block_kernel_refuses_unaligned_widths(dev, b, hw, c0, n_layers, growth, cb,
                                                     route):
    """Widths the wgmma kernel does not take compute: zero-padded to
    multiples of 8 up to growth 32 / Cb 128, the general route above; one
    launch a layer on the first, two on the second."""
    x, arrays = _dense_case(dev, b, hw, hw, c0, n_layers, growth, cb, seed=c0)
    assert dense.route(c0, growth, cb) == route
    before, before_general = dense.launches, dense.general_launches
    got = dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth)
    want = dense.fused_dense_block_plain(x, *arrays, c_in0=c0, growth=growth)
    again = dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth)
    torch.cuda.synchronize()
    per_layer = 1 if route == "wgmma" else 2
    assert dense.launches == before + 2 * per_layer * n_layers
    assert dense.general_launches == before_general + (2 * per_layer * n_layers
                                                       if route == "general" else 0)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hw, hw, c0 + n_layers * growth)
    assert torch.equal(got, again)
    _assert_dense_close(got, want, c0)
    # mismatched shapes still refuse, before any launch
    with pytest.raises(ValueError):
        dense.fused_dense_block(x, *arrays, c_in0=c0, growth=growth + 1)
    assert dense.launches == before + 2 * per_layer * n_layers


def _favor_case(dev, b, h, n, d, m, seed=0, scale=1.0):
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version in full f32
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(scale * rng.standard_normal((b, h, n, d)).astype(np.float32),
                               device=dev) for _ in range(3))
    proj = orthogonal_gaussian_matrix(m, d, generator=torch.Generator().manual_seed(seed))
    return q, k, v, proj.to(dev)


@pytest.mark.parametrize("b,h,n,d,m,scale", [
    (8, 10, 16907, 64, 266, 1),  # scBERT's shape: B H = 80 < 132 SMs, ragged N
    (2, 3, 700, 16, 37, 1),      # d 16, m not a multiple of 16
    (4, 40, 1030, 64, 37, 1),    # B H = 160 > 132
    (3, 2, 45, 64, 266, 1),      # N smaller than one apply tile
    (1, 1, 512, 32, 64, 1),      # d 32, whole tiles
    (2, 5, 3001, 16, 266, 1),
    (2, 3, 100, 64, 1, 1),       # m = 1: one feature
    (1, 2, 257, 64, 8, 1),       # m at one MMA n tile
    (1, 2, 257, 32, 9, 1),       # m one past it
    (2, 2, 999, 64, 264, 1),     # m a multiple of 8, not of 16
    (2, 2, 999, 64, 272, 1),     # m a multiple of 16
    (2, 3, 1, 64, 266, 1),       # N = 1
    (1, 4, 33, 64, 266, 1),      # N one past an accumulate tile (32 rows)
    (2, 2, 65, 32, 100, 1),      # N one past an apply tile (64 rows)
    (2, 3, 700, 64, 266, 30),    # inputs scaled by 30: the hi/lo split's range
    (2, 3, 2000, 32, 266, 1)],   # d 32 at scBERT's m
    ids=["scbert", "d16-m37", "bh160", "short", "d32", "d16-m266", "m1", "m8", "m9",
         "m264", "m272", "n1", "n33", "n65", "x30", "d32-m266"])
def test_favor_kernel_matches_plain(dev, b, h, n, d, m, scale):
    q, k, v, proj = _favor_case(dev, b, h, n, d, m, seed=n, scale=scale)
    before = favor.launches
    got = favor.fused_generalized_linear_attention(q, k, v, proj)
    want = favor.favor_attention_plain(q, k, v, proj)
    again = favor.fused_generalized_linear_attention(q, k, v, proj)
    torch.cuda.synchronize()
    assert favor.launches == before + 2
    assert got.shape == (b, h, n, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    assert torch.equal(got, again)          # fixed reduction order: same bits


def test_favor_kernel_takes_head_split_views(dev):
    """q, k, v as SelfAttention makes them: (B, N, H d) viewed as (B, H, N, d)."""
    b, n, h, d, m = 2, 333, 3, 64, 100
    rng = np.random.default_rng(5)
    qkv = [torch.as_tensor(rng.standard_normal((b, n, h * d)).astype(np.float32),
                           device=dev).reshape(b, n, h, d).transpose(1, 2)
           for _ in range(3)]
    proj = orthogonal_gaussian_matrix(m, d, generator=torch.Generator().manual_seed(5))
    proj = proj.to(dev)
    assert not qkv[0].is_contiguous()
    got = favor.fused_generalized_linear_attention(*qkv, proj)
    want = favor.favor_attention_plain(*(t.contiguous() for t in qkv), proj)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_favor_kernel_gradients_match_plain(dev):
    q, k, v, proj = _favor_case(dev, 2, 3, 260, 16, 20, seed=3)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    qp = [t.clone().requires_grad_() for t in (q, k, v)]
    (favor.fused_generalized_linear_attention(*qk, proj) ** 2).sum().backward()
    (favor.favor_attention_plain(*qp, proj) ** 2).sum().backward()
    for a, b in zip(qk, qp):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [8, 48, 100, 128, 200])
def test_favor_kernel_refuses_what_it_does_not_take(dev, d):
    """Head widths outside the compiled ones (padded, or the general kernels
    above 64), bf16 inputs and strided views that the tensor-core kernels
    cannot read all compute within the f32 tolerance; an empty call and
    mismatched shapes still refuse, before any launch."""
    q, k, v, proj = _favor_case(dev, 2, 3, 333, d, 70, seed=d)
    before = favor.launches
    got = favor.fused_generalized_linear_attention(q, k, v, proj)
    again = favor.fused_generalized_linear_attention(q, k, v, proj)
    want = favor.favor_attention_plain(q, k, v, proj)
    torch.cuda.synchronize()
    assert favor.launches == before + 2
    assert got.shape == (2, 3, 333, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    assert torch.equal(got, again)
    # bf16 inputs: cast to f32, as the JAX wrapper casts
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = favor.fused_generalized_linear_attention(qb, kb, vb, proj)
    want = favor.favor_attention_plain(qb.float(), kb.float(), vb.float(), proj)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    # strided views: rows of d + 1 floats (misaligned for the tensor cores)
    wide = torch.as_tensor(np.random.default_rng(d).standard_normal((3, 2, 3, 333, d + 1))
                           .astype(np.float32), device=dev)
    got = favor.fused_generalized_linear_attention(*wide[..., 1:], proj)
    want = favor.favor_attention_plain(*(t.contiguous() for t in wide[..., 1:]), proj)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    assert favor.launches == before + 4
    with pytest.raises(ValueError, match="empty"):
        favor.fused_generalized_linear_attention(q[:, :, :0], k[:, :, :0], v[:, :, :0], proj)
    with pytest.raises(ValueError):
        favor.fused_generalized_linear_attention(q, k[:, :, 1:], v, proj)
    with pytest.raises(ValueError):
        favor.fused_generalized_linear_attention(q, k, v, proj[:, 1:])
    assert favor.launches == before + 4



@pytest.mark.parametrize("b,h,n,d,m", [(4, 10, 8454, 64, 266), (2, 3, 700, 16, 37),
                                       (2, 3, 333, 8, 70), (2, 3, 333, 48, 70),
                                       (2, 3, 333, 128, 70), (2, 3, 1, 64, 266)],
                         ids=["seq-rank", "d16-m37", "d8", "d48", "d128", "n1"])
def test_favor_halves_match_fused_and_plain(dev, b, h, n, d, m):
    """``favor_accumulate_f32`` then ``favor_apply_f32`` without a sum: the
    fused entry's bits at the same split plan; each half within FAVOR's
    tolerance of its plain version (ctx and ksum against their largest
    value: sums over N, whose elements may cancel)."""
    q, k, v, proj = _favor_case(dev, b, h, n, d, m, seed=n + d)
    counts = favor.launches, favor.accumulate_launches, favor.apply_launches
    fused = favor.fused_generalized_linear_attention(q, k, v, proj)
    ctx, ksum = favor.favor_accumulate_op(k, v, proj)
    seam = favor.favor_apply_op(q, proj, ctx, ksum)
    torch.cuda.synchronize()
    assert (favor.launches, favor.accumulate_launches, favor.apply_launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2] + 1)
    assert ctx.shape == (b, h, m, d) and ksum.shape == (b, h, m)
    assert torch.equal(seam, fused)
    p_ctx, p_ksum = favor.favor_accumulate_plain(k, v, proj)
    for got, want in ((ctx, p_ctx), (ksum, p_ksum)):
        assert float((got - want).abs().max()) <= 2e-5 + 2e-4 * float(want.abs().max())
    torch.testing.assert_close(seam, favor.favor_apply_plain(q, proj, ctx, ksum),
                               rtol=2e-4, atol=2e-5)


def test_favor_halves_gradients_and_a_one_rank_seq_group(dev):
    """The halves' backward is the plain version's VJP; over a 1-rank gloo
    group (CUDA tensors through gloo) the seq route gives the fused bits."""
    import socket

    import torch.distributed as dist

    q, k, v, proj = _favor_case(dev, 2, 3, 260, 16, 20, seed=4)
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    qp = [t.clone().requires_grad_() for t in (q, k, v)]
    ctx, ksum = favor.favor_accumulate_op(qk[1], qk[2], proj)
    (favor.favor_apply_op(qk[0], proj, ctx, ksum) ** 2).sum().backward()
    (favor.favor_attention_plain(*qp, proj) ** 2).sum().backward()
    for a, b in zip(qk, qp):
        torch.testing.assert_close(a.grad, b.grad, rtol=2e-4, atol=2e-5)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        got = favor.fused_generalized_linear_attention(q, k, v, proj,
                                                       seq_group=dist.group.WORLD)
        assert torch.equal(got, favor.fused_generalized_linear_attention(q, k, v, proj))
    finally:
        dist.destroy_process_group()

# -- exported artifacts: the kernels inside torch.export programs --------------------


def test_exported_registration_launches_the_kernels(dev):
    """An ``export`` artifact of a registrar on the card runs the gather and
    the labels corrector as its ``gridnext::`` ops: one launch each a call,
    and the live registrar's labels (up to near-ties)."""
    from gridnext_tpu_torch.models import GridNetHex, TpuPatchClassifier
    from gridnext_tpu_torch.serving import SlideRegistrar, load_exported_registration

    torch.manual_seed(0)
    g = GridNetHex(TpuPatchClassifier(n_classes=5, stages=((32, 1),), stem_patch=8),
                   n_classes=5, f_dim=5)
    reg = SlideRegistrar.from_gridnet(g, patch_size=32, normalize=None, patch_chunk=200,
                                      device=dev)
    rng = np.random.default_rng(0)
    wsi = torch.as_tensor(rng.integers(0, 256, (900, 800, 3), dtype=np.uint8), device=dev)
    n, k = 512, 300
    oy = np.full(n, 78, np.int32)
    ox = np.zeros(n, np.int32)
    y_px = np.full(n, 16, np.int32)
    x_px = np.full(n, 16, np.int32)
    cells = rng.choice(78 * 64, k, replace=False)
    oy[:k], ox[:k] = divmod(cells, 64)
    y_px[:k] = rng.integers(16, 900 - 16, k)
    x_px[:k] = rng.integers(16, 800 - 16, k)
    ins = [torch.as_tensor(a, device=dev) for a in (oy, ox, y_px, x_px)]
    with torch.inference_mode():
        live = reg._register(wsi, *(t.long() for t in ins)).cpu().numpy()
        logits, _ = reg._register_logits(wsi, *(t.long() for t in ins))
    fn = load_exported_registration(reg.export(tuple(wsi.shape), n_spots=n))
    before = (gather.launches, corr.launches["fused_hex_corrector_labels"])
    got = fn(wsi, *ins).cpu().numpy()
    torch.cuda.synchronize()
    assert (gather.launches, corr.launches["fused_hex_corrector_labels"]) == (
        before[0] + 1, before[1] + 1)
    label_parity_report(live, got, logits.cpu().numpy())
    assert int((got > 0).sum()) == k
    with pytest.raises(ValueError, match="cannot export for platforms"):
        reg.export(tuple(wsi.shape), n_spots=n, platforms=["cpu"])


def test_exported_scbert_grid_forward_launches_favor(dev):
    """A multimodal grid artifact with a 2-layer scBERT count f: the count
    chunks are one ``map`` in the graph, FAVOR's op runs once a layer for
    each chunk, and the labels are the live model's (up to near-ties)."""
    from gridnext_tpu_torch.models import GridNetHexMM, TpuPatchClassifier, scBERT
    from gridnext_tpu_torch.serving import export_grid_forward, load_exported_registration

    torch.manual_seed(1)
    h, w, vocab, depth, chunk = 6, 5, 40, 2, 1
    g = GridNetHexMM(TpuPatchClassifier(n_classes=3, stages=((16, 1),), stem_patch=4),
                     scBERT(n_genes=vocab, dim=16, depth=depth, heads=2, dim_head=16,
                            nb_features=12, n_classes=3, generalized_attention=True),
                     n_classes=3, patch_chunk=16, count_chunk=chunk).to(dev).eval()
    rng = np.random.default_rng(2)
    imgs = torch.as_tensor(rng.uniform(size=(1, h, w, 8, 8, 3)).astype(np.float32), device=dev)
    counts = torch.as_tensor(np.log2(1 + rng.poisson(2.0, (1, h, w, vocab)))
                             .astype(np.float32), device=dev)
    fg = torch.ones((1, h, w), dtype=torch.int32, device=dev)
    blob = export_grid_forward(g, ((h, w, 8, 8, 3), (h, w, vocab)), explicit_fg=True)
    import io

    ep = torch.export.load(io.BytesIO(blob))
    assert any(str(n.target) == "map_impl" for n in ep.graph.nodes)    # chunks: one map
    fn = load_exported_registration(blob)
    before = favor.launches
    got = fn(imgs, counts, fg).cpu().numpy()
    torch.cuda.synchronize()
    assert favor.launches - before == depth * -(-h * w // chunk)
    with torch.no_grad():
        logits = g((imgs, counts)).cpu().numpy()
    label_parity_report(logits.argmax(-1)[0] + 1, got[0], logits[0])


def test_fit_pca_on_the_card_matches_float64(dev):
    """cuSOLVER's default (Jacobi) driver left components 4e-4 off unit
    norm at this shape; the fit must reach float32's precision."""
    from gridnext_tpu_torch.workflows import fit_pca, pca_transform

    rng = np.random.default_rng(0)
    n, g = 1500, 600
    X = (rng.normal(size=(n, g)) * (10 * 0.9 ** np.arange(g) + 0.5)) @ \
        np.linalg.qr(rng.normal(size=(g, g)))[0].T
    _, s64, vt64 = np.linalg.svd(X - X.mean(0), full_matrices=False)
    pca = fit_pca(torch.as_tensor(X, dtype=torch.float32, device=dev))
    assert pca.components_.device.type == "cuda"
    comp = pca.components_.double().cpu().numpy()[:5]
    np.testing.assert_allclose(np.abs(np.sum(comp * vt64[:5], 1)), 1, atol=1e-4)
    np.testing.assert_allclose(pca.explained_variance_ratio_.double().cpu().numpy(),
                               s64 ** 2 / (s64 ** 2).sum(), rtol=0, atol=1e-5)
    # an array projects on the card by default, as fit_pca fits there
    proj = pca_transform(X[:7].astype(np.float32), pca.components_, pca.mean_, 5)
    assert proj.device.type == "cuda" and proj.shape == (7, 5)
    np.testing.assert_allclose(proj.cpu().numpy(), (X[:7] - X.mean(0)) @ comp.T,
                               rtol=1e-4, atol=1e-3)


def test_mesh_registrar_launches_a_gather_a_shard(dev):
    """Two spot shards on the card: one gather launch a shard, the features
    those of the unsharded registrar (odd spot count: the shards pad)."""
    from gridnext_tpu_torch.models import GridNetHex, TpuPatchClassifier
    from gridnext_tpu_torch.parallel import make_mesh
    from gridnext_tpu_torch.serving import SlideRegistrar
    from gridnext_tpu_torch.train.init import flax_init_

    g = GridNetHex(TpuPatchClassifier(n_classes=3, stages=((64, 1),), stem_patch=8), 3, 3)
    flax_init_(g, torch.Generator().manual_seed(0))
    kw = dict(patch_size=32, normalize=None, patch_chunk=256, device=dev)
    single = SlideRegistrar.from_gridnet(g, **kw)
    sharded = SlideRegistrar.from_gridnet(g, mesh=make_mesh({"spot": 2}, devices=[dev, dev]),
                                          **kw)
    rng = np.random.default_rng(1)
    wsis = torch.as_tensor(rng.integers(0, 256, (2, 900, 800, 3), dtype=np.uint8), device=dev)
    y = np.repeat(np.arange(60, 840, 12), 60)[:1999]
    x = np.tile(np.arange(60, 780, 12), 40)[:1999]
    yx = torch.as_tensor(np.stack([y, x]), device=dev)
    slide = torch.as_tensor(rng.integers(0, 2, 1999), device=dev)
    n = gather.launches
    with torch.inference_mode():
        got = sharded._feats_flat(wsis, yx[0], yx[1], slide)
        want = single._feats_flat(wsis, yx[0], yx[1], slide)
    torch.cuda.synchronize()
    assert gather.launches - n == 3                     # 2 shards + the single pass
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
