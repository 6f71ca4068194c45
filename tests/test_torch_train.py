"""The port's training tier against the JAX package's trainers.

Inputs are made with numpy from seeds; the port starts from JAX's initial
variables (through the weight bridge), since torch cannot draw JAX's
initialisation bits. Dropout is 0 (every JAX f's default). Covered:

- the three losses (background, -1 and NaN pads) against JAX's, within
  1e-6 relative (float32 reductions in another order);
- ``_pad_batch`` / ``_iter_batches``: batches, pads, order and ``skip``
  equal to JAX's, for the array-pair and the dataset forms;
- the optimiser forms (Adam, gridwise g only, ``f_lr``, ``accum_iters`` 2,
  frozen labels) over 5 steps of the same numpy gradients against optax:
  parameters and moments within 1e-6 abs + 1e-5 rel (torch's Adam divides
  by the bias corrections in another order), and the state-dict layout
  equal to ``flax.serialization.to_state_dict`` of optax's state;
- the flax-exact BatchNorm's running statistics after one train step,
  within 1e-6, in every port module with BatchNorm;
- ``train_spotwise`` (CountMLP with a non-divisible last batch; a narrow
  DenseNet with ``efficient`` off and on; a tiny scBERT through the plain
  FAVOR) and ``train_gridwise`` (GridNetHex + CountMLP with f frozen and
  with ``f_lr``; a square GridNet), two epochs with val: train and val
  histories, best-val restore and final variables. Tolerances: losses
  within 1e-4 relative and weights within 1e-4 abs + 1e-3 rel, except the
  biases that feed a BatchNorm through linear maps only (``SIGN_LIMIT``):
  their true gradient is zero, so Adam moves each by about lr times the
  sign of a rounding residue, and the two packages may disagree by up to
  2 lr per step (ROADMAP.md Queue 3); they, the running means they shift
  and the val losses (eval mode reads those running means) are held to
  that bound instead;
- the 8 augmentation transforms;
- resume after an epoch and after a mid-epoch ``PreemptionGuard.trigger()``
  equal to an uninterrupted port run (bit for bit on the CPU);
- JAX's ``restore_train_state`` reads a port ``.latest``, and the port
  resumes a JAX ``.latest``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import to_state_dict

from gridnext_tpu import pipeline as jax_pipeline
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import DenseNet as JaxDenseNet
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.train import loops as jl
from gridnext_tpu.train.preempt import (TrainingPreempted, active,
                                        install_preemption_handler,
                                        uninstall_preemption_handler)
from gridnext_tpu_torch import pipeline
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_variables
from gridnext_tpu_torch.models import (CountMLP, DenseNet, GridNet, GridNetHex,
                                       scBERT)
from gridnext_tpu_torch.models.layers import BatchNorm
from gridnext_tpu_torch.train import loops as tl
from gridnext_tpu_torch.train import preempt as tpreempt

C, G = 3, 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(model, variables, tx):
    state = tl.create_train_state(model, tx, device="cpu", init=False)
    load_variables(model, _np(variables))
    return state


def _close_trees(got, want, rtol, atol, skip=()):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        name = jax.tree_util.keystr(path)
        if any(s in name for s in skip):
            continue
        np.testing.assert_allclose(np.asarray(flat_g[path]), np.asarray(w),
                                   rtol=rtol, atol=atol, err_msg=name)


# -- losses, batches ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["grid", "spot", "spot_mse"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "grid":
        logits = rng.normal(size=(2, 6, 5, C)).astype(np.float32)
        labels = rng.integers(0, C + 1, size=(2, 6, 5))
        labels[1] = 0                                        # an all-background grid
        jfn, tfn = jl.masked_cross_entropy, tl.masked_cross_entropy
    elif kind == "spot":
        logits = rng.normal(size=(9, C)).astype(np.float32)
        labels = rng.integers(0, C, size=9)
        labels[-3:] = -1                                     # pad rows
        jfn, tfn = jl._spot_loss, tl._spot_loss
    else:
        logits = rng.normal(size=(9, 4)).astype(np.float32)
        labels = rng.normal(size=(9, 4)).astype(np.float32)
        labels[-2:] = np.nan
        jfn, tfn = jl._spot_mse, tl._spot_mse
    want = [np.asarray(v) for v in jfn(jnp.asarray(logits), jnp.asarray(labels))]
    got = [v.numpy() for v in tfn(torch.from_numpy(logits), torch.from_numpy(labels))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


class _Items:
    """A map-style dataset of (x, y) items."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


@pytest.mark.parametrize("form", ["arrays", "dataset", "multimodal"])
@pytest.mark.parametrize("kind", ["grid", "spot", "spot_mse"])
def test_iter_batches_match_jax(form, kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(11, 4)).astype(np.float32)
    y = (rng.integers(0, 3, size=11).astype(np.uint8) if kind != "spot_mse"
         else rng.integers(0, 3, size=11))
    data = {"arrays": (x, y), "dataset": _Items(x, y),
            "multimodal": ((x, x * 2), y)}[form]
    for skip in (0, 1):
        want = list(jl._iter_batches(data, 4, np.random.default_rng(5), kind, skip))
        got = list(tl._iter_batches(data, 4, np.random.default_rng(5), kind, skip))
        assert len(got) == len(want) == 3 - skip
        for (gx, gy, gn), (wx, wy, wn) in zip(got, want):
            assert gn == wn
            assert gy.dtype == wy.dtype
            np.testing.assert_array_equal(gy, wy)
            for a, b in zip(gx if isinstance(gx, tuple) else (gx,),
                            wx if isinstance(wx, tuple) else (wx,)):
                np.testing.assert_array_equal(a, b)


# -- the optimiser -----------------------------------------------------------------


def _grid_pair(f_batch_norm=True, square=False):
    jcls, tcls = (JaxGridNet, GridNet) if square else (JaxGridNetHex, GridNetHex)
    jg = jcls(patch_classifier=JaxCountMLP(n_classes=C, hidden=(12, 8, 8, 6),
                                           batch_norm=f_batch_norm), n_classes=C)
    variables = _np(jg.init(jax.random.key(3), jnp.zeros((1, 6, 5, G), jnp.float32)))
    tg = tcls(CountMLP(G, C, hidden=(12, 8, 8, 6), batch_norm=f_batch_norm),
              n_classes=C, f_dim=C)
    return jg, variables, tg


def _frozen_dense0(tree):
    return {k: jax.tree.map(lambda _: "frozen" if k == "Dense_0" else "train", v)
            for k, v in tree.items()}


OPTIMIZERS = {
    "adam": (lambda: optax.adam(2e-3), lambda: tl.make_adam(2e-3)),
    "g_only": (lambda: jl.make_gridwise_optimizer(2e-3),
               lambda: tl.make_gridwise_optimizer(2e-3)),
    "f_lr": (lambda: jl.make_gridwise_optimizer(2e-3, f_lr=5e-4),
             lambda: tl.make_gridwise_optimizer(2e-3, f_lr=5e-4)),
    "accum2": (lambda: jl.make_gridwise_optimizer(2e-3, f_lr=5e-4, accum_iters=2),
               lambda: tl.make_gridwise_optimizer(2e-3, f_lr=5e-4, accum_iters=2)),
    "frozen_labels": (
        lambda: jl.make_gridwise_optimizer(
            2e-3, f_lr=5e-4, frozen_f_labels={"patch_classifier": _frozen_dense0}),
        lambda: tl.make_gridwise_optimizer(
            2e-3, f_lr=5e-4, frozen_f_labels={"patch_classifier": _frozen_dense0})),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_forms_match_optax(name):
    """5 steps of the same numpy gradients: parameters, moments and the
    state-dict layout against optax."""
    _, variables, tg = _grid_pair()
    jtx, ttx = (make() for make in OPTIMIZERS[name])
    params = variables["params"]
    opt_state = jtx.init(params)
    state = _port_state(tg, variables, ttx)
    rng = np.random.default_rng(7)
    for _ in range(5):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, opt_state = jtx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for path, t, layout in state.optimizer.entries:
            if t.requires_grad:
                g = grads
                for k in path:
                    g = g[k]
                t.grad = torch.from_numpy(np.ascontiguousarray(
                    g.T if layout == "dense" else g))
        state.optimizer.step()
    _close_trees(jax_variables(tg)["params"], _np(params), rtol=1e-5, atol=1e-6)
    want = _np(to_state_dict(opt_state))
    got = tl._host_tree(state.optimizer.state_tree())
    assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
    _close_trees(got, want, rtol=1e-5, atol=1e-6)


# -- BatchNorm ---------------------------------------------------------------------


def _stats_after_one_step(jm, tm, variables, x):
    _, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    load_variables(tm, variables)
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    return _np(mut["batch_stats"]), jax_variables(tm)["batch_stats"]


@pytest.mark.parametrize("module", ["count_mlp", "densenet", "hex_corrector", "square"])
def test_batchnorm_running_stats_match_flax(module):
    rng = np.random.default_rng(2)
    if module == "count_mlp":
        jm, tm = JaxCountMLP(n_classes=C), CountMLP(G, C)
        x = rng.normal(3.0, 2.0, size=(128, G)).astype(np.float32)
    elif module == "densenet":
        kw = dict(growth_rate=4, block_config=(2, 2), num_init_features=8, bn_size=2,
                  num_classes=C, small_inputs=False)
        jm, tm = JaxDenseNet(**kw), DenseNet(**kw)
        x = rng.random((4, 32, 32, 3)).astype(np.float32)
    else:
        jm, _, tm = _grid_pair(square=module == "square")
        x = rng.normal(1.0, 2.0, size=(2, 6, 5, G)).astype(np.float32)
    variables = _np(jm.init(jax.random.key(4), jnp.asarray(x[:1])))
    want, got = _stats_after_one_step(jm, tm, variables, x)
    _close_trees(got, want, rtol=1e-6, atol=1e-6)
    # torch's own BatchNorm moves the variance by the unbiased estimate
    bn = torch.nn.BatchNorm1d(4, momentum=0.1)
    ours = BatchNorm(4)
    v = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    bn.train()(v)
    ours.train()(v)
    assert not torch.allclose(bn.running_var, ours.running_var, rtol=1e-3)


@pytest.mark.parametrize("efficient", [False, True])
def test_batchnorm_float64_moves_by_the_biased_variance(efficient):
    """A float64 module keeps float64 statistics: after one train step they
    equal ``0.9 * running + 0.1 * batch`` with the biased variance, to 1e-12
    (float64 rounding), through the layer's forward and through
    ``update_stats`` (the checkpointed DenseNet's route)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(2.0, 3.0, size=(6, 4, 5, 5)))
    ours = BatchNorm(4, axis=1).double().train()
    with torch.no_grad():
        ours.running_mean.copy_(torch.from_numpy(rng.normal(size=4)))
        ours.running_var.copy_(torch.from_numpy(rng.random(4) + 0.5))
    mean0, var0 = ours.running_mean.clone(), ours.running_var.clone()
    if efficient:
        ours.update_stats(x)
    else:
        ours(x)
    xc = x.transpose(0, 1).reshape(4, -1)
    assert ours.running_mean.dtype == ours.running_var.dtype == torch.float64
    torch.testing.assert_close(ours.running_mean, 0.9 * mean0 + 0.1 * xc.mean(1),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(ours.running_var, 0.9 * var0 + 0.1 * xc.var(1, correction=0),
                               rtol=0, atol=1e-12)


# -- the trainers ------------------------------------------------------------------

LR = 1e-3
# biases whose true gradient is zero (they reach a BatchNorm through linear
# maps only): Adam moves them by ~lr * sign(rounding residue)
SIGN_LIMIT = ("'Dense_0']['bias'", "'Dense_1']['bias'", "'Dense_2']['bias'",
              "'Dense_3']['bias'", "'HexConv_1']['bias'", "'HexConv_3']['bias'",
              "'corrector']['Conv_0']['bias'", "'corrector']['Conv_1']['bias'",
              "'corrector']['Conv_2']['bias'")


def _compare_runs(jres, tres, steps, lr=LR, sign_limited=False):
    """Histories and final variables of a JAX and a port run."""
    (js, jv, jt), (ts, tv, tt) = jres, tres
    np.testing.assert_allclose(tt, jt, rtol=1e-4)
    bound = 2 * lr * steps
    if sign_limited:
        # eval mode reads running means the sign-limited biases shift
        np.testing.assert_allclose(tv, jv, rtol=0, atol=bound)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-4)
    got, want = jax_variables(ts.model), _np(js.variables())
    _close_trees(got, want, rtol=1e-3, atol=1e-4,
                 skip=SIGN_LIMIT + ("'mean'",) if sign_limited else ())
    if sign_limited:
        _close_trees(got, want, rtol=0, atol=bound)
        _close_trees(got.get("batch_stats", {}), want.get("batch_stats", {}),
                     rtol=0, atol=bound)


def _spot_data(n=53, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(n, G)).astype(np.float32)
    y = (x[:, 0] > 1).astype(np.int64) + (x[:, 1] > 2).astype(np.int64)
    return {"train": (x[:41], y[:41]), "val": (x[41:], y[41:])}


def test_train_spotwise_count_mlp_matches_jax():
    """41 train items in batches of 16: the last batch pads 7 repeats."""
    dls = _spot_data()
    jm = JaxCountMLP(n_classes=C)
    jstate = jl.create_train_state(jm, jax.random.key(0), jnp.asarray(dls["train"][0][:1]),
                                   optax.adam(LR))
    tm = CountMLP(G, C)
    tstate = _port_state(tm, jstate.variables(), tl.make_adam(LR))
    kw = dict(num_epochs=2, batch_size=16, verbose=False)
    jres = jl.train_spotwise(jm, dls, state=jstate, tx=optax.adam(LR), **kw)
    tres = tl.train_spotwise(tm, dls, state=tstate, device="cpu", **kw)
    _compare_runs(jres, tres, steps=6, sign_limited=True)


@pytest.mark.parametrize("efficient", [False, True], ids=["plain", "efficient"])
def test_train_spotwise_densenet_matches_jax(efficient):
    rng = np.random.default_rng(6)
    x = rng.random((20, 32, 32, 3)).astype(np.float32)
    y = (x[..., 0].mean((1, 2)) > 0.5).astype(np.int64)
    dls = {"train": (x[:14], y[:14]), "val": (x[14:], y[14:])}
    kw = dict(growth_rate=4, block_config=(2, 2), num_init_features=8, bn_size=2,
              num_classes=C, small_inputs=False, efficient=efficient)
    jm = JaxDenseNet(**kw)
    jstate = jl.create_train_state(jm, jax.random.key(0), jnp.asarray(x[:1]),
                                   optax.adam(LR))
    tm = DenseNet(**kw)
    tstate = _port_state(tm, jstate.variables(), tl.make_adam(LR))
    run = dict(num_epochs=2, batch_size=8, verbose=False)
    jres = jl.train_spotwise(jm, dls, state=jstate, tx=optax.adam(LR), **run)
    tres = tl.train_spotwise(tm, dls, state=tstate, device="cpu", **run)
    _compare_runs(jres, tres, steps=4)


def test_train_spotwise_scbert_matches_jax():
    """A tiny scBERT with ReLU FAVOR: the port's plain FAVOR on the CPU
    against JAX's einsum path."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 6, size=(12, 15)).astype(np.float32)
    y = (x[:, 0] > 2).astype(np.int64)
    dls = {"train": (x[:9], y[:9]), "val": (x[9:], y[9:])}
    kw = dict(n_genes=15, dim=16, depth=1, heads=2, dim_head=8, nb_features=8,
              n_classes=C, generalized_attention=True)
    jm = JaxScBERT(**kw)
    jstate = jl.create_train_state(jm, jax.random.key(0), jnp.asarray(x[:1]),
                                   optax.adam(LR))
    tm = scBERT(**kw)
    tstate = _port_state(tm, jstate.variables(), tl.make_adam(LR))
    run = dict(num_epochs=2, batch_size=4, verbose=False)
    jres = jl.train_spotwise(jm, dls, state=jstate, tx=optax.adam(LR), **run)
    tres = tl.train_spotwise(tm, dls, state=tstate, device="cpu", **run)
    _compare_runs(jres, tres, steps=6)


def _grid_data(n=7, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(n, 6, 5, G)).astype(np.float32)
    y = 1 + (x[..., 0] > 1).astype(np.int64) + (x[..., 1] > 2).astype(np.int64)
    y[:, :, 0] = 0                                   # a background column
    return {"train": (x[:5], y[:5]), "val": (x[5:], y[5:])}


@pytest.mark.parametrize("case", ["hex_frozen_f", "hex_f_lr", "square"])
def test_train_gridwise_matches_jax(case):
    """Two epochs with val from JAX's initial variables: histories, the
    best-val restore and the final variables."""
    dls = _grid_data()
    jg, variables, tg = _grid_pair(square=case == "square")
    f_lr = 5e-4 if case == "hex_f_lr" else None
    jtx = jl.make_gridwise_optimizer(LR, f_lr=f_lr)
    jstate = jl.create_train_state(jg, jax.random.key(3), jnp.asarray(dls["train"][0][:1]),
                                   jtx)
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    tstate = _port_state(tg, variables, tl.make_gridwise_optimizer(LR, f_lr=f_lr))
    if f_lr is None:
        assert not any(p.requires_grad for p in tg.patch_classifier.parameters())
    run = dict(num_epochs=2, batch_size=2, verbose=False)
    jres = jl.train_gridwise(jg, dls, state=jstate, tx=jtx, **run)
    tres = tl.train_gridwise(tg, dls, state=tstate, device="cpu", **run)
    _compare_runs(jres, tres, steps=6, sign_limited=True)


# -- augmentation ------------------------------------------------------------------


def test_augment_transforms_match_jax():
    x = np.random.default_rng(10).random((2, 3, 5, 5, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    for k in range(8):
        np.testing.assert_array_equal(pipeline.dihedral_transform(xt, k).numpy(),
                                      np.asarray(jax_pipeline.dihedral_transform(x, k)))
    out = pipeline.augment_patches(torch.Generator().manual_seed(0), xt)
    drawn = {next(k for k in range(8)
                  if torch.equal(out[i, j], pipeline.dihedral_transform(xt[i, j], k)))
             for i in range(2) for j in range(3)}
    assert drawn <= set(range(8))
    aug = pipeline.make_train_augment()
    img, counts = aug(torch.Generator().manual_seed(1), (xt, torch.ones(2, 4)))
    assert img.shape == xt.shape and torch.equal(counts, torch.ones(2, 4))


# -- resume ------------------------------------------------------------------------


class _Trigger(_Items):
    """Trips the port's guard at the Nth item access (0: never)."""

    def __init__(self, x, y, trigger_at=0):
        super().__init__(x, y)
        self.trigger_at, self.accesses = trigger_at, 0

    def __getitem__(self, i):
        self.accesses += 1
        if self.trigger_at and self.accesses == self.trigger_at:
            tpreempt.active().trigger()
        return super().__getitem__(i)


def _port_grid_run(variables, dls, outfile, epochs, resume=None):
    _, _, tg = _grid_pair()
    state = _port_state(tg, variables, tl.make_gridwise_optimizer(LR))
    return tl.train_gridwise(tg, dls, state=state, num_epochs=epochs, batch_size=2,
                             outfile=str(outfile), resume=resume, verbose=False,
                             device="cpu")


def test_resume_after_epoch_and_preemption_match_uninterrupted(tmp_path):
    data = _grid_data()
    _, variables, _ = _grid_pair()
    full, vh, th = _port_grid_run(variables, data, tmp_path / "a.msgpack", 3)
    want = jax_variables(full.model)

    # an epoch-end resume
    _port_grid_run(variables, data, tmp_path / "b.msgpack", 1)
    res, vh_b, th_b = _port_grid_run(variables, data, tmp_path / "b.msgpack", 3,
                                     resume=str(tmp_path / "b.msgpack.latest"))
    assert th_b == th[1:] and vh_b == vh[1:]
    _close_trees(jax_variables(res.model), want, rtol=0, atol=0)

    # a mid-epoch preemption in epoch 1
    guard = tpreempt.install_preemption_handler()
    try:
        guard.reset()
        out = tmp_path / "c.msgpack"
        trig = {"train": _Trigger(*data["train"], trigger_at=5 + 3), "val": _Items(*data["val"])}
        with pytest.raises(tpreempt.TrainingPreempted) as ei:
            _port_grid_run(variables, trig, out, 3)
        meta = tl.load_checkpoint(ei.value.checkpoint)
        assert meta["epochs_done"] == 1 and 0 < meta["batches_done"] < 3
        res, vh_c, th_c = _port_grid_run(variables, data, out, 3,
                                         resume=ei.value.checkpoint)
    finally:
        tpreempt.uninstall_preemption_handler()
    assert vh_c == vh[1:] and th_c[1:] == th[2:]
    _close_trees(jax_variables(res.model), want, rtol=0, atol=0)


def test_latest_checkpoints_resume_across_packages(tmp_path):
    """JAX writes epoch 1's .latest and the port trains epoch 2 from it;
    the port writes one and JAX's restore_train_state reads it back."""
    data = _grid_data()
    jg, variables, _ = _grid_pair()
    jtx = jl.make_gridwise_optimizer(LR, f_lr=5e-4, accum_iters=2)

    def jax_state():
        s = jl.create_train_state(jg, jax.random.key(3), jnp.asarray(data["train"][0][:1]),
                                  jtx)
        return s.replace(params=variables["params"], batch_stats=variables["batch_stats"])

    run = dict(batch_size=2, verbose=False)
    jfull, jvh, jth = jl.train_gridwise(jg, data, state=jax_state(), tx=jtx, num_epochs=2,
                                        **run)
    jout = tmp_path / "j.msgpack"
    jl.train_gridwise(jg, data, state=jax_state(), tx=jtx, num_epochs=1,
                      outfile=str(jout), **run)
    _, _, tg = _grid_pair()
    tstate = _port_state(tg, variables, tl.make_gridwise_optimizer(LR, f_lr=5e-4,
                                                                   accum_iters=2))
    tres, tvh, tth = tl.train_gridwise(tg, data, state=tstate, num_epochs=2,
                                       resume=str(jout) + ".latest", device="cpu", **run)
    np.testing.assert_allclose(tth, jth[1:], rtol=1e-4)
    _close_trees(jax_variables(tg), _np(jfull.variables()), rtol=1e-3, atol=1e-4,
                 skip=SIGN_LIMIT + ("'mean'",))

    # the port's .latest, read by JAX's restore_train_state
    tout = tmp_path / "t.msgpack"
    _, _, tg2 = _grid_pair()
    tstate2 = _port_state(tg2, variables, tl.make_gridwise_optimizer(LR, f_lr=5e-4,
                                                                     accum_iters=2))
    tl.train_gridwise(tg2, data, state=tstate2, num_epochs=1, outfile=str(tout),
                      device="cpu", **run)
    restored = jl.restore_train_state(str(tout) + ".latest", jax_state())
    assert int(restored.step) == tstate2.step == 3
    _close_trees(_np(restored.variables()), jax_variables(tg2), rtol=0, atol=0)
    want = tl._host_tree(tstate2.optimizer.state_tree())
    _close_trees(_np(to_state_dict(restored.opt_state)), want, rtol=0, atol=0)
    jl.train_gridwise(jg, data, state=restored, tx=jtx, num_epochs=2, **run)


def test_jax_preemption_guard_is_not_the_ports():
    """The port keeps its own process-global guard (no JAX import)."""
    g = install_preemption_handler()
    try:
        assert active() is g and tpreempt.active() is None
    finally:
        uninstall_preemption_handler()
    assert TrainingPreempted is not tpreempt.TrainingPreempted
