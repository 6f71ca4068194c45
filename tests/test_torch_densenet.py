"""The port's DenseNet slice against the JAX package, on the same inputs.

Weights are initialised in JAX (with BatchNorm statistics drawn from a
numpy seed, so eval-mode BatchNorm is not the identity) and carried across
by the weight bridge; inputs come from a numpy seed. Covered:

- the f32 ``DenseNet`` module against flax ``DenseNet`` (1e-4), and
  ``densenet121`` at 32 px;
- the weight bridge (round trip, and the names ``densenet_from_torch``
  gives the reference's torch checkpoints);
- the block fold (equal to JAX's), the plain dense block against the JAX
  Pallas block run interpreted (1e-2: one bf16 ulp is 3.9e-3 and the two
  summation orders may move a rounding by one ulp), and the fused
  whole-net inference against JAX's (5e-2, equal argmax);
- the model-directory registrar and a registrar on the fused f, each
  against its JAX counterpart through ``label_parity_report``;
- the cubic window resize against ``jax.image.resize`` (within 1 on uint8:
  a rounding at .5 may flip).

The dense-block CUDA kernel is held against the plain version in
``test_torch_cuda.py`` (on a card) and by ``chip_smoke.py`` at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.compat.torch_convert import densenet_from_torch
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.models import DenseNet as JaxDenseNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import densenet121 as jax_densenet121
from gridnext_tpu.ops import denseblock_pallas as jax_dense
from gridnext_tpu.ops.hexcorrector_pallas import fold_corrector_params
from gridnext_tpu.pipeline import resize_patches_device
from gridnext_tpu.serving import SlideRegistrar as JaxSlideRegistrar
from gridnext_tpu_torch import modeldir
from gridnext_tpu_torch.compat.from_jax import (jax_variables, load_densenet,
                                                load_gridnet)
from gridnext_tpu_torch.io import read_positions
from gridnext_tpu_torch.models import DenseNet, GridNetHex, densenet121
from gridnext_tpu_torch.ops import denseblock_cuda as dense
from gridnext_tpu_torch.pipeline import resize_matrices, resize_patches
from gridnext_tpu_torch.serving import SlideRegistrar, label_parity_report

SMALL = dict(growth_rate=8, block_config=(2, 3), num_init_features=16,
             num_classes=5)


def _random_stats(tree, rng):
    """BatchNorm statistics from a numpy seed (flax inits them to 0 / 1)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _random_stats(val, rng)
        elif key == "mean":
            out[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
        else:
            out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    return out


def _flax_variables(module, patch, seed=0):
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(module.init)(
        jax.random.key(seed), jnp.zeros((1, patch, patch, 3))))
    variables["batch_stats"] = _random_stats(variables["batch_stats"],
                                             np.random.default_rng(seed))
    return variables


def _patches(n, p, seed):
    return np.random.default_rng(seed).normal(size=(n, p, p, 3)).astype(np.float32)


@pytest.mark.parametrize("small_inputs,classify,patch", [
    (False, True, 32), (True, True, 16), (False, False, 32), (False, True, 36)],
    ids=["stem7x7", "small_inputs", "features", "odd36px"])
def test_densenet_matches_flax(small_inputs, classify, patch):
    jm = JaxDenseNet(**SMALL, small_inputs=small_inputs, classify=classify)
    variables = _flax_variables(jm, patch)
    x = _patches(3, patch, seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    f = load_densenet(DenseNet(**SMALL, small_inputs=small_inputs, classify=classify),
                      variables)
    with torch.no_grad():
        got = f(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 5 if classify else f.num_features)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


N_CLASSES, PATCH = 3, 32


@pytest.fixture(scope="module")
def hex_dn121():
    """A JAX GridNetHex(DenseNet-121) variables tree (32-px patches) with
    random BatchNorm statistics, initialised once."""
    jg = JaxGridNetHex(patch_classifier=jax_densenet121(num_classes=N_CLASSES),
                       n_classes=N_CLASSES)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jg.init)(
        jax.random.key(0), jnp.zeros((1, 2, 2, PATCH, PATCH, 3), jnp.float32)))
    variables["batch_stats"] = _random_stats(variables["batch_stats"],
                                             np.random.default_rng(0))
    return variables


def _f_variables(variables):
    return {c: variables[c]["patch_classifier"] for c in ("params", "batch_stats")}


def test_densenet121_matches_flax(hex_dn121):
    f_vars = _f_variables(hex_dn121)
    x = _patches(2, PATCH, seed=4)
    want = np.asarray(jax.jit(jax_densenet121(num_classes=N_CLASSES).apply)(
        f_vars, jnp.asarray(x)))
    f = load_densenet(densenet121(num_classes=N_CLASSES), f_vars)
    with torch.no_grad():
        got = f(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="too small"):
        with torch.no_grad():
            f(torch.zeros((1, 16, 16, 3)))


def test_densenet_bridge_round_trip_and_torch_names():
    """jax_variables of a GridNetHex(DenseNet) loads back unchanged, and its
    f subtree has the tree ``densenet_from_torch`` builds from the
    reference's torch state_dict names."""
    f = DenseNet(**SMALL, small_inputs=False)
    g = GridNetHex(f, n_classes=5, f_dim=5)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for t in list(g.parameters()) + list(g.buffers()):
            if t.dtype.is_floating_point:
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                         .astype(np.float32)))
    tree = jax_variables(g)
    g2 = load_gridnet(GridNetHex(DenseNet(**SMALL, small_inputs=False),
                                     n_classes=5, f_dim=5), tree)
    for (name, a), (_, b) in zip(g.state_dict().items(), g2.state_dict().items()):
        assert torch.equal(a, b), name

    # the reference's torch names (densenet.py of the reference) for this f
    sd = {}
    sd["features.conv0.weight"] = f.conv0.weight

    def bn(prefix, mod):
        sd.update({f"{prefix}.weight": mod.weight, f"{prefix}.bias": mod.bias,
                   f"{prefix}.running_mean": mod.running_mean,
                   f"{prefix}.running_var": mod.running_var})

    bn("features.norm0", f.norm0)
    for bi, block in enumerate(f.blocks, start=1):
        for li, layer in enumerate(block, start=1):
            pre = f"features.denseblock{bi}.denselayer{li}"
            bn(f"{pre}.norm1", layer.norm1)
            bn(f"{pre}.norm2", layer.norm2)
            sd[f"{pre}.conv1.weight"] = layer.conv1.weight
            sd[f"{pre}.conv2.weight"] = layer.conv2.weight
        if bi <= len(f.transitions):
            bn(f"features.transition{bi}.norm", f.transitions[bi - 1].norm)
            sd[f"features.transition{bi}.conv.weight"] = f.transitions[bi - 1].conv.weight
    bn("features.norm_final", f.norm_final)
    sd["classifier.weight"], sd["classifier.bias"] = f.classifier.weight, f.classifier.bias
    want = densenet_from_torch(sd, block_config=SMALL["block_config"])
    got = {c: tree[c]["patch_classifier"] for c in ("params", "batch_stats")}
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_w.keys() == flat_g.keys()
    for path, val in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], val)


def _block_inputs(growth=8, n_layers=3, c0=16, seed=0):
    jm = JaxDenseNet(growth_rate=growth, block_config=(n_layers,),
                     num_init_features=c0, num_classes=5, small_inputs=False)
    variables = _flax_variables(jm, 32, seed)
    names = [f"_DenseLayer_{i}" for i in range(n_layers)]
    return ([variables["params"][n] for n in names],
            [variables["batch_stats"][n] for n in names])


def test_fold_dense_block_params_matches_jax():
    lp, ls = _block_inputs()
    want = jax_dense.fold_dense_block_params(lp, ls, 16, 8)
    got = dense.fold_dense_block_params(lp, ls, 16, 8)
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val)


@pytest.mark.parametrize("shape", [(4, 8, 8), (3, 9, 7)], ids=["8x8", "9x7_ragged"])
def test_plain_dense_block_matches_jax_kernel(shape):
    lp, ls = _block_inputs()
    folded = dense.fold_dense_block_params(lp, ls, 16, 8)
    arrays = [folded[k] for k in ("A1", "B1", "W1", "A2", "B2", "W2")]
    x = np.random.default_rng(6).normal(size=shape + (16,)).astype(np.float32)
    want = np.asarray(jax_dense.fused_dense_block(
        jnp.asarray(x), *arrays, c_in0=16, growth=8, batch_tile=2,
        interpret=True).astype(jnp.float32))
    got = dense.fused_dense_block(torch.from_numpy(x), *arrays, c_in0=16, growth=8)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape + (40,)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_dense_block_rejects_mismatched_weights():
    lp, ls = _block_inputs()
    folded = dense.fold_dense_block_params(lp, ls, 16, 8)
    arrays = [folded[k] for k in ("A1", "B1", "W1", "A2", "B2", "W2")]
    with pytest.raises(ValueError, match="input"):
        dense.fused_dense_block(torch.zeros((1, 4, 4, 8)), *arrays, c_in0=16, growth=8)
    with pytest.raises(ValueError, match="growth"):
        dense.fused_dense_block(torch.zeros((1, 4, 4, 16)), *arrays, c_in0=16, growth=16)


@pytest.mark.parametrize("patch", [32, 36], ids=["32px", "odd36px"])
def test_fused_infer_matches_jax(patch):
    jm = JaxDenseNet(**SMALL, small_inputs=False)
    variables = _flax_variables(jm, patch, seed=7)
    kw = dict(block_config=(2, 3), num_init_features=16, growth=8)
    want_fn = jax_dense.build_densenet_fused_infer(variables, batch_tiles=(2, 2),
                                                   interpret=True, **kw)
    infer = dense.build_densenet_fused_infer(variables, device="cpu", **kw)
    x = _patches(4, patch, seed=8)
    want = np.asarray(want_fn(jnp.asarray(x)))
    got = infer(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # and the f32 module on the same weights agrees as the JAX test's budget says
    f = load_densenet(DenseNet(**SMALL, small_inputs=False), variables)
    with torch.no_grad():
        np.testing.assert_allclose(got, f(torch.from_numpy(x)).numpy(),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("size,out", [(160, 128), (256, 224), (97, 64)])
def test_resize_matches_jax(size, out):
    crops = np.random.default_rng(size).integers(0, 256, (3, size, size, 3),
                                                 dtype=np.uint8)
    want = np.asarray(resize_patches_device(jnp.asarray(crops), out))
    got = resize_patches(torch.from_numpy(crops), out)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, out, out, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    # the matrices a registrar builds once give the same result
    mats = resize_matrices(size, size, out, "cpu")
    assert torch.equal(resize_patches(torch.from_numpy(crops), out, mats), got)
    same = torch.from_numpy(crops)
    assert resize_patches(same, size) is same      # window == patch: no resize


# -- registrars on simulated slides ----------------------------------------------


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    from PIL import Image

    s = simulate_spaceranger_dir(tmp_path_factory.mktemp("torch_densenet") / "a0",
                                 seed=0, n_genes=8, n_classes=N_CLASSES, image=True,
                                 tissue_fraction=0.15, spot_spacing_px=12)
    return s, np.asarray(Image.open(s["image_file"]))


def _parity(jax_reg, port_reg, sim, rel_tol):
    s, img = sim
    jpos = jax_read_positions(s["spaceranger_dir"])
    want = jax_reg(jnp.asarray(img), jpos)
    got = port_reg(img, read_positions(s["spaceranger_dir"]))
    jax_logits, _ = jax_reg.register_logits(jnp.asarray(img), jpos)
    np.testing.assert_array_equal(got > 0, s["label_grid"] > 0)
    label_parity_report(want, got, jax_logits, rel_tol=rel_tol)


def test_densenet_model_dir_registrar_matches_jax(hex_dn121, sim):
    meta = {"model": "GridNetHex+DenseNet121", "patch_px": PATCH, "patch_chunk": 256}
    classes = [f"Layer_{i}" for i in range(N_CLASSES)]
    jax_reg = jax_modeldir.image_registrar_from_meta(meta, classes, hex_dn121)
    port_reg = modeldir.image_registrar_from_meta(meta, classes, hex_dn121,
                                                  device="cpu")
    assert isinstance(port_reg.f_apply, DenseNet) and port_reg.normalize is None
    _parity(jax_reg, port_reg, sim, rel_tol=1e-2)   # f32 on both sides


def test_fused_f_registrar_matches_jax(sim):
    """A registrar on the fused f, at the small DenseNet configuration, against
    the JAX registrar on JAX's fused f (Pallas blocks interpreted). Both run
    bf16 blocks with other summation orders: near-ties within 5e-2."""
    jg = JaxGridNetHex(patch_classifier=JaxDenseNet(**dict(SMALL, num_classes=N_CLASSES),
                                                    small_inputs=False),
                       n_classes=N_CLASSES)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jg.init)(
        jax.random.key(9), jnp.zeros((1, 2, 2, PATCH, PATCH, 3), jnp.float32)))
    variables["batch_stats"] = _random_stats(variables["batch_stats"],
                                             np.random.default_rng(9))
    f_vars = _f_variables(variables)
    corr = fold_corrector_params(variables["params"]["corrector"],
                                 variables["batch_stats"]["corrector"])
    kw = dict(block_config=SMALL["block_config"], growth=SMALL["growth_rate"],
              num_init_features=SMALL["num_init_features"])
    jax_reg = JaxSlideRegistrar(
        jax_dense.build_densenet_fused_infer(f_vars, batch_tiles=(8, 8),
                                             interpret=True, **kw),
        *corr, patch_size=PATCH, normalize=None, patch_chunk=256)
    port_reg = SlideRegistrar(dense.build_densenet_fused_infer(f_vars, device="cpu", **kw),
                              *corr, patch_size=PATCH, normalize=None, patch_chunk=256,
                              device="cpu")
    _parity(jax_reg, port_reg, sim, rel_tol=5e-2)
