"""Shapes the port's kernels once refused, against the JAX package on the CPU.

The CUDA wrappers used to raise where the JAX functions compute: the labels
corrector above 32 classes (and any corrector whose first layer's weights
outgrew shared memory), FAVOR at head widths other than 16, 32 and 64, and
the dense block at widths that are not multiples of 8 or above growth 32 /
Cb 128. On the CPU each wrapper runs its plain version, which is what these
tests hold against the JAX functions (the Pallas kernels interpreted) on the
same numpy-seeded inputs; the pure-Python parts of the card routes (the
corrector's cluster plan, the dense block's padding, FAVOR's operand
widths) are checked here too. ``tests/test_torch_cuda.py`` holds the
kernels to these plain versions on a card.
"""

import json
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.models import DenseNet as JaxDenseNet
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.models.scbert import load_gene2vec_names as jax_gene2vec
from gridnext_tpu.models.scbert import preprocess_scbert as jax_preprocess
from gridnext_tpu.ops import denseblock_pallas as jax_dense
from gridnext_tpu.ops import hexcorrector_pallas as jax_corr
from gridnext_tpu_torch import modeldir, serving
from gridnext_tpu_torch.compat.from_jax import load_model_dir
from gridnext_tpu_torch.ops import denseblock_cuda as dense
from gridnext_tpu_torch.ops import favor_cuda
from gridnext_tpu_torch.ops import hexcorrector_cuda as corr
from gridnext_tpu_torch.ops import patch_gather_cuda as gather
from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

REPO = Path(__file__).resolve().parents[1]

# -- the hex corrector: any class count, any c_in ---------------------------------


def _corrector_case(c_in, n_classes, seed, b=2, h=10, w=12, width=32):
    rng = np.random.default_rng(seed)
    dims = (c_in, width, width, width, width, n_classes)
    kernels = [(rng.normal(size=(7, dims[i], dims[i + 1])) / np.sqrt(7 * dims[i]))
               .astype(np.float32) for i in range(5)]
    biases = [(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32) for i in range(5)]
    x = rng.normal(size=(b, h, w, c_in)).astype(np.float32)
    fg = (rng.random((b, h, w)) < 0.6).astype(np.int32)
    return x, fg, kernels, biases


@pytest.mark.parametrize("c_in,n_classes", [(7, 33), (14, 64), (300, 7), (300, 33)],
                         ids=["33-classes", "64-classes", "c_in-300", "c_in-300-33"])
def test_corrector_beyond_old_limits_matches_jax(c_in, n_classes):
    """Both variants above 32 classes and at c_in 300 (7 * 300 * 32 * 4 B =
    269 KB of first-layer weights, more than a block's shared memory)."""
    x, fg, kernels, biases = _corrector_case(c_in, n_classes, seed=c_in + n_classes)
    flags = corr.CORRECTOR_RELU_FLAGS
    want = np.asarray(jax_corr.fused_hex_corrector(
        jnp.asarray(x), [jnp.asarray(k) for k in kernels], [jnp.asarray(b) for b in biases],
        flags, interpret=True))
    want_labels = np.asarray(jax_corr.fused_hex_corrector_labels(
        jnp.asarray(x), jnp.asarray(fg), [jnp.asarray(k) for k in kernels],
        [jnp.asarray(b) for b in biases], flags, interpret=True))
    before = dict(corr.launches)
    got = corr.fused_hex_corrector(torch.from_numpy(x), kernels, biases, flags)
    got_labels = corr.fused_hex_corrector_labels(torch.from_numpy(x), torch.from_numpy(fg),
                                                 kernels, biases, flags)
    assert corr.launches == before                 # the CPU takes the plain version
    assert got.shape == want.shape and got_labels.dtype == torch.int32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for i in range(x.shape[0]):
        serving.label_parity_report(want_labels[i], got_labels[i].numpy(), want[i])


@pytest.mark.parametrize("h,w,widths,cluster_max,want", [
    (78, 64, (7, 32, 32, 32, 32, 7), 16, (16, 5, 32, True)),        # the main path
    (78, 64, (1024, 32, 32, 32, 32, 64), 16, (16, 5, 32, True)),    # c_in 1024, 64 classes
    (78, 64, (7, 32, 32, 32, 32, 7), 8, (8, 10, 8, True)),          # no 16-CTA clusters
    (78, 64, (7, 128, 128, 128, 128, 7), 16, (16, 5, 32, False)),   # hidden bands in scratch
    (78, 64, (5, 12, 12, 12, 12, 9), 16, (16, 5, 12, True)),        # narrow: slices <= bands
    (4, 4, (3, 3), 16, (4, 1, 3, False)),                           # one layer, tiny grid
    (300, 260, (7, 32, 32, 32, 32, 7), 16, (16, 19, 8, False)),    # a large grid
    (1920, 500, (7, 32, 32, 32, 32, 7), 16, (16, 120, 8, False)),   # tiles of whole rows
    (32, 20000, (7, 32, 32, 32, 32, 7), 16, (16, 2, 8, False)),     # tiles of part rows
    (2, 2, (3,) + (4,) * 10 + (5,), 16, (2, 1, 4, True))],           # 11 layers
    ids=["main", "c1024", "cluster8", "hidden128", "narrow", "tiny", "large", "tall", "wide",
         "deep"])
def test_corrector_plan(h, w, widths, cluster_max, want):
    """The plan fits shared memory, covers the grid, keeps layer 0's staged
    slices inside the bands and takes the largest cluster the card allows;
    its tiles are the band with shared bands, else pieces of it, whole rows
    first."""
    plan = corr.plan_corrector(h, w, widths,
                               lambda cluster, nbytes, bands: cluster <= cluster_max)
    assert (plan.cluster, plan.band_rows, plan.kc, plan.smem_bands) == want
    assert plan.cluster * plan.band_rows >= h and plan.cluster <= max(1, h)
    assert plan.smem_bytes == corr.smem_bytes(plan.tile_rows, plan.tile_cols, plan.kc,
                                              plan.buf_c, plan.smem_bands) <= corr.SMEM_LIMIT
    assert plan.buf_c == max(widths[1:-1], default=0)
    assert 1 <= plan.tile_rows <= plan.band_rows and 1 <= plan.tile_cols <= w
    if plan.tile_cols < w:
        assert plan.tile_rows == 1
    if plan.smem_bands:
        assert plan.kc <= plan.buf_c
        assert (plan.tile_rows, plan.tile_cols) == (plan.band_rows, w)


def test_corrector_plan_refuses_what_cannot_fit():
    """What the plan once refused, a band too wide for one channel in shared
    memory, now runs in tiles of part of a row; only a card that runs no
    cluster size at all is refused."""
    plan = corr.plan_corrector(78, 40000, (7, 32, 7))
    assert (plan.cluster, plan.band_rows, plan.tile_rows, plan.kc) == (16, 5, 1, 8)
    assert plan.tile_cols < 40000 and plan.smem_bytes <= corr.SMEM_LIMIT
    assert corr.smem_bytes(1, plan.tile_cols + 1, 8, 32, False) > corr.SMEM_LIMIT
    with pytest.raises(ValueError, match="no cluster size"):
        corr.plan_corrector(78, 64, (7, 32, 7), lambda cluster, nbytes, bands: False)


@pytest.mark.parametrize("n_layers", [1, 2, 10])
def test_corrector_any_layer_count_matches_jax(n_layers):
    """Stacks of 1, 2 and 10 layers (the kernel once took at most 8), both
    variants, against the interpreted JAX kernels."""
    rng = np.random.default_rng(100 + n_layers)
    dims = (5,) + (12,) * (n_layers - 1) + (9,)
    kernels = [(rng.normal(size=(7, dims[i], dims[i + 1])) / np.sqrt(7 * dims[i]))
               .astype(np.float32) for i in range(n_layers)]
    biases = [(rng.normal(size=(dims[i + 1],)) * 0.1).astype(np.float32)
              for i in range(n_layers)]
    flags = tuple(i % 2 == 1 for i in range(n_layers))
    x = rng.normal(size=(2, 9, 7, dims[0])).astype(np.float32)
    fg = (rng.random((2, 9, 7)) < 0.6).astype(np.int32)
    want = np.asarray(jax_corr.fused_hex_corrector(
        jnp.asarray(x), [jnp.asarray(k) for k in kernels], [jnp.asarray(b) for b in biases],
        flags, interpret=True))
    want_labels = np.asarray(jax_corr.fused_hex_corrector_labels(
        jnp.asarray(x), jnp.asarray(fg), [jnp.asarray(k) for k in kernels],
        [jnp.asarray(b) for b in biases], flags, interpret=True))
    got = corr.fused_hex_corrector(torch.from_numpy(x), kernels, biases, flags)
    got_labels = corr.fused_hex_corrector_labels(torch.from_numpy(x), torch.from_numpy(fg),
                                                 kernels, biases, flags)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for i in range(x.shape[0]):
        serving.label_parity_report(want_labels[i], got_labels[i].numpy(), want[i])


# -- FAVOR: any head width ---------------------------------------------------------

SCBERT_48 = dict(n_genes=40, dim=32, depth=1, heads=2, dim_head=48, nb_features=20,
                 n_classes=3, generalized_attention=True)
TPU_F = {"stages": [[16, 1]], "stem_patch": 8, "norm": "rms"}


def _mm_grids(h, w, seed, tissue, genes=40, patch=16):
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, 256, (h, w, patch, patch, 3)).astype(np.float32) / 255.0
    xc = rng.poisson(0.8, (h, w, genes)).astype(np.float32)
    xc[..., 0] += 1
    return xi * tissue[..., None, None, None], xc * tissue[..., None]


def test_mm_model_dir_with_dim_head_48_registers_like_jax(tmp_path):
    """An scBERT + TpuPatchClassifier model directory whose ``scbert_dim_head``
    is 48 (``train-mm --scbert-dim-head 48``), served by
    ``mm_model_from_meta`` + ``register_mm_grid``, against the JAX route."""
    g = JaxGridNetHexMM(image_classifier=JaxTpuF(n_classes=3, stages=((16, 1),), stem_patch=8),
                        count_classifier=JaxScBERT(**SCBERT_48), n_classes=3,
                        patch_chunk=624, count_chunk=64)
    tissue = np.zeros((78, 64), bool)
    tissue[20:50, 10:40] = True
    xi0, xc0 = _mm_grids(1, 1, 0, np.ones((1, 1), bool))
    variables = jax.tree_util.tree_map(np.asarray, g.init(
        jax.random.key(0), (jnp.asarray(xi0[None]), jnp.asarray(xc0[None]))))
    rng = np.random.default_rng(2)

    def move(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[0] == "favor":
            return a
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(move, variables)
    genes = jax_gene2vec()[:40]
    meta = {"classes": ["A", "B", "C"], "patch_px": 16, "window_px": None,
            "patch_chunk": 624, "count_chunk": 64, "n_genes": 40, "genes": genes,
            "log1p": False, "count_f": "scbert", "scbert_vocab": 40, "scbert_dim": 32,
            "scbert_depth": 1, "scbert_heads": 2, "scbert_dim_head": 48,
            "scbert_features": 20, "hd_binning": None, "grid_dims": None,
            "image_f": "tpu", "tpu_f": TPU_F, "dense_ingest": False, "model": "GridNetHexMM"}
    (tmp_path / "model.json").write_text(json.dumps(meta))
    payload = {"params": variables["params"], "batch_stats": variables["batch_stats"],
               "extra_vars": {"favor": variables["favor"]}, "step": 1}
    (tmp_path / "g_state.msgpack").write_bytes(flax.serialization.msgpack_serialize(payload))

    xi, raw = _mm_grids(78, 64, 3, tissue)
    jmeta, jclasses, jvars = jax_modeldir.load_model_dir(tmp_path)
    jg = jax_modeldir.mm_model_from_meta(jmeta, jclasses)
    jxc, _ = jax_preprocess(raw.reshape(-1, 40), genes, target_genes=genes)
    logits = np.asarray(jg.apply(jvars, (jnp.asarray(xi[None]),
                                         jnp.asarray(jxc.reshape(1, 78, 64, 40)))))[0]
    want = np.where(raw.sum(-1) > 0, logits.argmax(-1) + 1, 0)

    meta, classes, loaded = load_model_dir(tmp_path)
    model = modeldir.mm_model_from_meta(meta, classes, loaded, device="cpu")
    attn = model.count_classifier.performer_lm.performer.attns[0].fast_attention
    assert attn.projection.shape == (20, 48)
    before = favor_cuda.launches
    got = serving.register_mm_grid(model, xi, raw, modeldir.scbert_transform(genes, 40),
                                   device="cpu")
    assert favor_cuda.launches == before
    np.testing.assert_array_equal(got > 0, tissue)
    serving.label_parity_report(want, got, logits)


@pytest.mark.parametrize("d,want", [(1, 16), (8, 16), (16, 16), (20, 32), (48, 48),
                                    (50, 64), (64, 64), (65, 65), (100, 100), (200, 200)])
def test_favor_kernel_width(d, want):
    """Widths up to 64 run at the next compiled instance, wider ones as they
    are (the general kernels)."""
    assert favor_cuda.kernel_width(d) == want


@pytest.mark.parametrize("d", [8, 20, 48])
def test_favor_padding_is_exact(d):
    """The kernel's operands at a padded width: zero columns of q, k, v and
    proj with the true d's scale give the same attention, and the padded
    output columns are 0 (what the wrapper slices away)."""
    from gridnext_tpu_torch.ops.favor import linear_attention

    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 37, d)).astype(np.float32))
               for _ in range(3))
    proj = orthogonal_gaussian_matrix(19, d, generator=torch.Generator().manual_seed(d))
    width = favor_cuda.kernel_width(d)
    qp, kp, vp = (favor_cuda._kernel_operand(t, width) for t in (q, k, v))
    pp = favor_cuda._kernel_operand(proj, width)
    assert qp.shape[-1] == width and qp.is_contiguous() and qp.dtype == torch.float32

    def feats(x):
        return torch.relu(torch.einsum("...id,jd->...ij", d ** -0.25 * x, pp)) + 1e-3

    out = linear_attention(feats(qp), feats(kp), vp)
    want = favor_cuda.favor_attention_plain(q, k, v, proj)
    torch.testing.assert_close(out[..., :d], want, rtol=1e-5, atol=1e-6)
    assert (out[..., d:] == 0).all()


def test_favor_operand_layouts():
    """What the tensor-core kernels read in place (f32, unit last stride,
    strides multiples of 4) is passed as it is; another dtype or a stride
    they cannot read is copied to a contiguous f32 tensor."""
    x = torch.zeros((2, 3, 10, 64))
    assert favor_cuda._kernel_operand(x, 64) is x
    heads = torch.zeros((2, 10, 3 * 64)).reshape(2, 10, 3, 64).transpose(1, 2)
    assert favor_cuda._kernel_operand(heads, 64) is heads
    for t in (x.bfloat16(), torch.zeros((2, 3, 10, 65))[..., 1:], x.transpose(-1, -2)):
        got = favor_cuda._kernel_operand(t, t.shape[-1])
        assert got.is_contiguous() and got.dtype == torch.float32
        torch.testing.assert_close(got, t.float())


def test_favor_plain_casts_to_f32():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
               for _ in range(3))
    proj = orthogonal_gaussian_matrix(8, 16, generator=torch.Generator().manual_seed(3))
    got = favor_cuda.fused_generalized_linear_attention(q.bfloat16(), k.bfloat16(),
                                                        v.bfloat16(), proj)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, favor_cuda.favor_attention_plain(
        q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(), proj))


# -- the dense block: every shape ---------------------------------------------------


def _jax_block(growth, cb, c0, n_layers, seed):
    """One folded block of a JAX DenseNet with ``growth`` and bottleneck
    ``cb`` (bn_size = cb / growth), weights and statistics moved off init."""
    jm = JaxDenseNet(growth_rate=growth, block_config=(n_layers,), num_init_features=c0,
                     bn_size=cb // growth, num_classes=3, small_inputs=False)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(seed), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(seed)

    def move(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(move, variables)
    names = [f"_DenseLayer_{i}" for i in range(n_layers)]
    return dense.fold_dense_block_params([variables["params"][n] for n in names],
                                         [variables["batch_stats"][n] for n in names],
                                         c0, growth)


@pytest.mark.parametrize("growth,cb,c0,n_layers", [(12, 48, 24, 3), (48, 192, 16, 2)],
                         ids=["growth12", "growth48-cb192"])
def test_plain_dense_block_beyond_old_limits_matches_jax(growth, cb, c0, n_layers):
    """The JAX DenseNet's default growth 12 (widths not multiples of 8) and
    growth 48 / Cb 192 (above the wgmma kernel's 32 / 128)."""
    folded = _jax_block(growth, cb, c0, n_layers, seed=growth)
    arrays = [folded[k] for k in ("A1", "B1", "W1", "A2", "B2", "W2")]
    x = np.random.default_rng(growth).normal(size=(2, 6, 5, c0)).astype(np.float32)
    want = np.asarray(jax_dense.fused_dense_block(
        jnp.asarray(x), *arrays, c_in0=c0, growth=growth, batch_tile=2,
        interpret=True).astype(jnp.float32))
    got = dense.fused_dense_block(torch.from_numpy(x), *arrays, c_in0=c0, growth=growth)
    assert tuple(got.shape) == (2, 6, 5, c0 + n_layers * growth)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("growth,cb,c0,route", [
    (12, 48, 24, "wgmma"), (6, 20, 20, "wgmma"), (32, 128, 64, "wgmma"),
    (33, 128, 64, "general"), (48, 192, 16, "general"), (32, 130, 64, "general")])
def test_dense_block_route_and_padding(growth, cb, c0, route):
    """The wrapper's choice by shape, and the padded block for the wgmma
    kernel: through the plain version it gives the unpadded block's values
    at ``keep`` and exact zeros in every padded channel."""
    assert dense.route(c0, growth, cb) == route
    if route == "general":
        return
    rng = np.random.default_rng(growth + cb)
    n_layers = 2
    c_max = c0 + n_layers * growth
    arrays = [torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32)) for s in
              ((n_layers, c_max), (n_layers, c_max))] + \
        [torch.from_numpy((rng.normal(size=(n_layers, c_max, cb)) / np.sqrt(c_max))
                          .astype(np.float32)).bfloat16()] + \
        [torch.from_numpy(rng.uniform(0.5, 1.5, (n_layers, cb)).astype(np.float32))
         for _ in range(2)] + \
        [torch.from_numpy((rng.normal(size=(n_layers, 9, cb, growth)) / np.sqrt(9 * cb))
                          .astype(np.float32)).bfloat16()]
    x = torch.from_numpy(rng.normal(size=(2, 5, 4, c0)).astype(np.float32))
    want = dense.fused_dense_block_plain(x, *arrays, c_in0=c0, growth=growth)
    padded, c0p, gp, keep = dense.pad_dense_block(*arrays, c_in0=c0, growth=growth)
    assert c0p % 8 == 0 and gp % 8 == 0 and padded[3].shape[1] % 8 == 0
    xp = torch.zeros((2, 5, 4, c0p))
    xp[..., :c0] = x
    got = dense.fused_dense_block_plain(xp, *padded, c_in0=c0p, growth=gp)
    torch.testing.assert_close(got[..., keep].float(), want.float(), rtol=0, atol=1e-2)
    spare = torch.ones(got.shape[-1], dtype=torch.bool)
    spare[keep] = False
    assert (got[..., spare] == 0).all()


# -- the gather: the single-call library form ------------------------------------


def test_gather_library_form_equals_plain():
    """``chip_smoke.py``'s library yardstick (one ``aten::index`` on an
    unfold view, corners clamped outside the call) crops what the plain
    version crops, clamped corners and slide ids included."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    rng = np.random.default_rng(11)
    slides = torch.from_numpy(rng.integers(0, 256, (3, 90, 70, 3), dtype=np.uint8))
    y0 = torch.from_numpy(rng.integers(-20, 100, 40).astype(np.int32))
    x0 = torch.from_numpy(rng.integers(-20, 80, 40).astype(np.int32))
    s = torch.from_numpy(rng.integers(-1, 4, 40).astype(np.int32))
    for window in (16, 24, 33):
        yy, xx, ss = chip_smoke.clamped(y0, x0, s, 3, 90, 70, window)
        got = chip_smoke.library_gather(chip_smoke.window_view(slides, window), ss, yy, xx)
        assert torch.equal(got, gather.gather_patches_plain(slides, y0, x0, window, s))


@pytest.mark.parametrize("window,want", [(16, True), (128, True), (160, True), (24, False),
                                         (97, False), (1056, True), (1072, False)])
def test_gather_path_by_window(window, want):
    """The bulk-copy path takes rows of a multiple of 16 bytes whose two
    32-row stages fit its shared memory; other windows take the byte path."""
    assert gather.bulk(window) is want
