"""The port's f, hex layer and GridNetHex against the flax modules.

Weights are initialised in JAX and carried across by the weight bridge
(``gridnext_tpu_torch.compat.from_jax``); inputs come from a numpy seed.
f logits must agree within 1e-4 (f32, other convolution algorithms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models.layers import HexConv as JaxHexConv
from gridnext_tpu.models.tpu_f import tpu_f_arch_kwargs as jax_arch_kwargs
from gridnext_tpu.ops.hexcorrector_pallas import fold_corrector_params as jax_fold
from gridnext_tpu_torch.compat.from_jax import (jax_variables, load_gridnet_hex,
                                                load_tpu_f)
from gridnext_tpu_torch.models import (GridNetHex, HexConv, TpuPatchClassifier,
                                       tpu_f_arch_kwargs)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _patches(n, p, seed=0):
    return np.random.default_rng(seed).random((n, p, p, 3)).astype(np.float32)


def _f_parity(kw, p, n=3, seed=0):
    jf = JaxTpuF(n_classes=4, **kw)
    x = _patches(n, p, seed)
    variables = jf.init(jax.random.key(seed), jnp.asarray(x))
    want = np.asarray(jf.apply(variables, jnp.asarray(x)))
    tf = load_tpu_f(TpuPatchClassifier(n_classes=4, **kw),
                    _np_tree(variables["params"]))
    with torch.no_grad():
        got = tf(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("norm", ["rms", "layer", "none"])
def test_tpu_f_matches_flax(norm):
    _f_parity(dict(stages=((128, 1),), stem_patch=8, norm=norm), p=32)


def test_tpu_f_legacy_shape_matches_flax():
    """The model.json-less legacy shape (three stages, two downsample convs
    in the Conv_i numbering, LayerNorm), narrowed to one block per stage."""
    kw = tpu_f_arch_kwargs(None)
    assert kw == jax_arch_kwargs(None)
    kw["stages"] = tuple((w, 1) for w, _ in kw["stages"])
    _f_parity(kw, p=32, n=2)


def test_tpu_f_odd_size_downsample():
    """Odd spatial sizes pad the 2x2/2 downsample at the end like flax
    'SAME'."""
    _f_parity(dict(stages=((128, 1), (256, 1)), stem_patch=8, norm="rms"), p=24)


def test_tpu_f_arch_kwargs_from_meta():
    meta = {"stages": [[128, 2], [256, 1]], "stem_patch": 4, "norm": "rms"}
    assert tpu_f_arch_kwargs(meta) == jax_arch_kwargs(meta)


def test_tpu_f_rejects_small_patches():
    f = TpuPatchClassifier(stages=((128, 1), (256, 1)), stem_patch=8)
    with pytest.raises(ValueError, match="too small"):
        f(torch.zeros(1, 8, 8, 3))


def test_bridge_rejects_foreign_params():
    jf = JaxTpuF(n_classes=4, stages=((128, 1),), stem_patch=8)
    params = _np_tree(jf.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))["params"])
    with pytest.raises(ValueError, match="shape"):
        load_tpu_f(TpuPatchClassifier(n_classes=5, stages=((128, 1),), stem_patch=8),
                   params)
    params["extra"] = {"kernel": np.zeros(3)}
    with pytest.raises(ValueError, match="does not have"):
        load_tpu_f(TpuPatchClassifier(n_classes=4, stages=((128, 1),), stem_patch=8),
                   params)


def test_hexconv_layer_matches_flax():
    x = np.random.default_rng(1).normal(size=(2, 6, 5, 3)).astype(np.float32)
    jl = JaxHexConv(4)
    variables = jl.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jl.apply(variables, jnp.asarray(x)))
    tl = HexConv(3, 4)
    with torch.no_grad():
        tl.kernel.copy_(torch.tensor(np.asarray(variables["params"]["kernel"])))
        tl.bias.copy_(torch.tensor(np.asarray(variables["params"]["bias"])))
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _gridnet_pair(use_bn, seed=0, n_classes=3, p=16):
    f_kw = dict(stages=((128, 1),), stem_patch=8)
    jg = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=n_classes, **f_kw),
                       n_classes=n_classes, use_bn=use_bn)
    variables = _np_tree(jg.init(jax.random.key(seed),
                                 jnp.zeros((1, 4, 4, p, p, 3), jnp.float32)))
    if use_bn:   # non-trivial running stats, so the fold has work to do
        rng = np.random.default_rng(seed)
        for bn in variables["batch_stats"]["corrector"].values():
            bn["mean"] = rng.normal(size=bn["mean"].shape).astype(np.float32) * 0.1
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    tg = GridNetHex(TpuPatchClassifier(n_classes=n_classes, **f_kw),
                    n_classes=n_classes, f_dim=n_classes, use_bn=use_bn,
                    patch_chunk=7)
    load_gridnet_hex(tg, variables)
    return jg, variables, tg


@pytest.mark.parametrize("use_bn", [True, False])
def test_gridnet_hex_forward_matches_flax(use_bn):
    jg, variables, tg = _gridnet_pair(use_bn)
    x = np.random.default_rng(2).random((2, 5, 4, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jg.apply(variables, jnp.asarray(x), train=False))
    tg.eval()
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the torch corrector folds to the same serving weights as JAX's
    k, b, _ = tg.corrector.folded()
    jk, jb, _ = jax_fold(variables["params"]["corrector"],
                         variables.get("batch_stats", {}).get("corrector"))
    for a, c in zip(k + b, jk + jb):
        np.testing.assert_array_equal(a, c)


def test_gridnet_chunked_f_keeps_gradients():
    """Chunked f under autograd runs checkpointed and still trains f, which
    stays in eval mode when the model trains."""
    _, _, tg = _gridnet_pair(True)
    tg.train()
    assert tg.training and tg.corrector.training
    assert not tg.patch_classifier.training
    x = np.random.default_rng(4).random((1, 3, 4, 16, 16, 3)).astype(np.float32)
    tg(torch.from_numpy(x)).sum().backward()
    assert tg.patch_classifier.stem.weight.grad is not None


def test_jax_variables_round_trip():
    jg, variables, tg = _gridnet_pair(True, seed=3)
    tree = jax_variables(tg)
    for path in (("params", "patch_classifier", "stem", "kernel"),
                 ("params", "patch_classifier", "head", "kernel"),
                 ("params", "corrector", "HexConv_4", "kernel"),
                 ("batch_stats", "corrector", "BatchNorm_1", "var")):
        a, b = tree, variables
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_array_equal(a, b)
