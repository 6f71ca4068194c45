"""The port's kernel modules against the JAX package, on the same inputs.

Gather: the port's plain gather equals the JAX Pallas ``gather_patches``
(run interpreted, as the JAX tests run it) bit for bit. Corrector: the
port's fold equals JAX's, the plain logits match ``fused_hex_corrector``
within 1e-5 (f32, another summation order), and the plain labels equal
``fused_hex_corrector_labels`` up to near-tie flips. The CUDA kernels are
held against the plain versions in ``test_torch_cuda.py`` (on a card) and
by ``chip_smoke.py`` at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu.models.gridnet import _HexCorrector as JaxHexCorrector
from gridnext_tpu.ops import hexconv as jax_hexconv
from gridnext_tpu.ops import hexcorrector_pallas as jax_corr
from gridnext_tpu.ops.patch_gather_pallas import gather_patches as jax_gather
from gridnext_tpu.ops.patch_gather_pallas import pack_wsi
from gridnext_tpu.serving import label_parity_report as jax_parity
from gridnext_tpu_torch.ops import hexcorrector_cuda as corr
from gridnext_tpu_torch.ops import patch_gather_cuda as gather
from gridnext_tpu_torch.ops.hexconv import hex_conv
from gridnext_tpu_torch.serving import label_parity_report

H, W = 150, 300


@pytest.fixture(scope="module")
def slides():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)


def _jax_gather(imgs, y0, x0, win, slide):
    packed = jnp.stack([pack_wsi(jnp.asarray(im)) for im in imgs])
    return np.asarray(jax_gather(packed, jnp.asarray(y0), jnp.asarray(x0), win,
                                 None if slide is None else jnp.asarray(slide),
                                 orig_hw=(H, W), depth=4, interpret=True))


def _corners(rng, n, win):
    y0 = rng.integers(0, H - win + 1, n).astype(np.int32)
    x0 = rng.integers(0, W - win + 1, n).astype(np.int32)
    # edge-clamped corners on every side
    y0[:6] = [-10, H + 50, H - win + 1, 0, -1, 7]
    x0[:6] = [W + 9, -3, W - win + 2, W - win, 5, -100]
    return y0, x0


@pytest.mark.parametrize("win", [16, 24, 33])
def test_plain_gather_matches_jax_kernel(slides, win):
    rng = np.random.default_rng(win)
    y0, x0 = _corners(rng, 24, win)
    slide = (np.arange(24) % 2).astype(np.int32)
    slide[:3] = [-1, 5, 2]   # out-of-range slide indices clamp into [0, B-1]
    want = _jax_gather(slides, y0, x0, win, slide)
    got = gather.gather_patches_plain(torch.from_numpy(slides), torch.from_numpy(y0),
                                      torch.from_numpy(x0), win, torch.from_numpy(slide))
    assert got.dtype == torch.uint8 and got.shape == (24, win, win, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_gather_single_slide_default_index(slides):
    rng = np.random.default_rng(3)
    y0, x0 = _corners(rng, 10, 16)
    want = _jax_gather(slides[:1], y0, x0, 16, None)
    got = gather.gather_patches_plain(torch.from_numpy(slides[0]),
                                      torch.from_numpy(y0), torch.from_numpy(x0), 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_empty_and_errors(slides):
    empty = torch.zeros((0,), dtype=torch.int32)
    jax_empty = _jax_gather(slides, np.zeros((0,), np.int32),
                            np.zeros((0,), np.int32), 16, None)
    got = gather.gather_patches(torch.from_numpy(slides), empty, empty, 16)
    assert got.shape == jax_empty.shape == (0, 16, 16, 3)
    assert got.dtype == torch.uint8
    with pytest.raises(ValueError, match="smaller than"):
        gather.gather_patches(torch.from_numpy(slides), empty, empty, H + 1)
    with pytest.raises(ValueError, match="uint8"):
        gather.gather_patches(torch.from_numpy(slides).float(), empty, empty, 16)


def test_gather_wrapper_takes_plain_version_on_cpu(slides):
    rng = np.random.default_rng(4)
    y0, x0 = _corners(rng, 8, 16)
    before = gather.launches
    got = gather.gather_patches(torch.from_numpy(slides), torch.from_numpy(y0),
                                torch.from_numpy(x0), 16)
    want = gather.gather_patches_plain(torch.from_numpy(slides), torch.from_numpy(y0),
                                       torch.from_numpy(x0), 16)
    assert torch.equal(got, want)
    assert gather.launches == before   # no kernel launch for a CPU tensor


# -- hex convolution ------------------------------------------------------------


@pytest.mark.parametrize("radius", [1, 2])
def test_hex_conv_matches_jax(radius):
    rng = np.random.default_rng(radius)
    t = jax_hexconv.num_taps(radius)
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    k = rng.normal(size=(t, 5, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    got = hex_conv(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                   radius=radius).numpy()
    want = np.asarray(jax_hexconv.hex_conv(jnp.asarray(x), jnp.asarray(k),
                                           jnp.asarray(b), radius=radius))
    ref = jax_hexconv.hex_conv_reference(x, k, b, radius=radius)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_hex_conv_rejects_wrong_tap_count():
    with pytest.raises(ValueError, match="taps"):
        hex_conv(torch.zeros(1, 4, 4, 2), torch.zeros(19, 2, 3), radius=1)


# -- hex corrector --------------------------------------------------------------

C_IN, N_CLASSES = 7, 5


def _jax_corrector_variables(use_bn, seed=0):
    mod = JaxHexCorrector(n_classes=N_CLASSES, use_bn=use_bn)
    variables = mod.init(jax.random.key(seed), jnp.zeros((1, 78, 64, C_IN)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = None
    if use_bn:
        rng = np.random.default_rng(seed)
        stats = {k: {"mean": rng.normal(size=v["mean"].shape).astype(np.float32) * 0.1,
                     "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
                 for k, v in variables["batch_stats"].items()}
        for k in stats:
            params[k] = {"scale": rng.uniform(0.5, 1.5, params[k]["scale"].shape)
                         .astype(np.float32),
                         "bias": rng.normal(size=params[k]["bias"].shape)
                         .astype(np.float32) * 0.1}
    return params, stats


@pytest.mark.parametrize("use_bn", [True, False])
def test_fold_matches_jax(use_bn):
    params, stats = _jax_corrector_variables(use_bn)
    jk, jb, jflags = jax_corr.fold_corrector_params(params, stats)
    tk, tb, tflags = corr.fold_corrector_params(params, stats)
    assert tuple(tflags) == tuple(jflags) == corr.CORRECTOR_RELU_FLAGS
    for a, b in zip(tk + tb, jk + jb):
        np.testing.assert_array_equal(a, b)


def test_fold_requires_batch_stats():
    params, _ = _jax_corrector_variables(True)
    with pytest.raises(ValueError, match="batch_stats"):
        corr.fold_corrector_params(params, None)


@pytest.fixture(scope="module")
def corrector_case():
    params, stats = _jax_corrector_variables(True, seed=1)
    kernels, biases, flags = corr.fold_corrector_params(params, stats)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 78, 64, C_IN)).astype(np.float32)
    fg = (rng.random((2, 78, 64)) < 0.7).astype(np.int32)
    jk = [jnp.asarray(k) for k in kernels]
    jb = [jnp.asarray(b) for b in biases]
    jax_logits = np.asarray(jax_corr.fused_hex_corrector(
        jnp.asarray(x), jk, jb, flags, interpret=True))
    jax_labels = np.asarray(jax_corr.fused_hex_corrector_labels(
        jnp.asarray(x), jnp.asarray(fg), jk, jb, flags, interpret=True))
    return x, fg, kernels, biases, flags, jax_logits, jax_labels


def test_plain_corrector_logits_match_jax_kernel(corrector_case):
    x, _, kernels, biases, flags, jax_logits, _ = corrector_case
    got = corr.fused_hex_corrector(torch.from_numpy(x), kernels, biases, flags)
    assert got.dtype == torch.float32 and got.shape == (2, 78, 64, N_CLASSES)
    np.testing.assert_allclose(got.numpy(), jax_logits, atol=1e-5, rtol=0)


def test_plain_corrector_labels_match_jax_kernel(corrector_case):
    x, fg, kernels, biases, flags, jax_logits, jax_labels = corrector_case
    before = dict(corr.launches)
    got = corr.fused_hex_corrector_labels(torch.from_numpy(x), torch.from_numpy(fg),
                                          kernels, biases, flags)
    assert corr.launches == before   # CPU tensors take the plain version
    assert got.dtype == torch.int32
    for i in range(2):
        jax_parity(jax_labels[i], got[i].numpy(), jax_logits[i])
        label_parity_report(jax_labels[i], got[i].numpy(), jax_logits[i])
    assert ((got.numpy() > 0) == (fg > 0)).all()


def test_labels_take_first_index_on_ties():
    """Equal logits resolve to the first class, as jnp.argmax does."""
    x = torch.zeros((1, 4, 4, 3))
    kernels = [np.zeros((7, 3, 3), np.float32)]
    biases = [np.array([1.0, 1.0, 0.5], np.float32)]
    fg = torch.ones((1, 4, 4), dtype=torch.int32)
    fg[0, 0, 0] = 0
    got = corr.fused_hex_corrector_labels(x, fg, kernels, biases, (False,))
    want = np.ones((1, 4, 4), np.int32)
    want[0, 0, 0] = 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_corrector_rejects_mismatched_weights(corrector_case):
    x, _, kernels, biases, flags, _, _ = corrector_case
    with pytest.raises(ValueError, match="input channels"):
        corr.fused_hex_corrector(torch.from_numpy(x[..., :3]), kernels, biases, flags)
