"""ROADMAP Queue 3 item 11: the port's ``train-image`` command against the
JAX package's, from the same initial weights on the same pixels.

On one small simulated cohort (3 arrays, 32-px patches, ``--f tpu``) both
commands run the spotwise and the grid stage on the CPU. Both start every
state they create from the same numpy-seeded variables (the JAX package's
``create_train_state`` draws them; the port's loads the same tree through
the weight bridge), and the JAX patch cache is written and read losslessly
(PNG bytes in place of its JPEGs), so the two see the same pixels.

The spotwise stages must agree at each epoch: the validation loss within
``F_RTOL`` and the correct spots within one (their weights agree only up to
Adam's sign steps on float-noise gradients, ROADMAP Queue 3 item 5). The
port's grid stage then loads the JAX run's f, so that it is held alone: how
the command builds g, freezes f and feeds the grids. Its correct spots must
equal JAX's at each epoch, its validation loss and g's variables after its
first step agree within the trainer tests' tolerances
(``tests/test_torch_train.py``: 2 lr a step for what the sign-limited biases
move).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import cli as jax_cli
from gridnext_tpu import models as jax_models
from gridnext_tpu import train as jax_train
from gridnext_tpu.data import datasets as jax_datasets
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.train import loops as jl
from gridnext_tpu_torch import cli, models
from gridnext_tpu_torch import train as port_train
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_variables
from gridnext_tpu_torch.train import loops as tl

EPOCHS = 2
LR = 1e-3
# the spotwise stages' validation loss, each package's own f (8 Adam steps
# an epoch): 6e-4 apart on this cohort
F_RTOL = 2e-3
# a narrow TpuPatchClassifier in both packages (the default's 256/512-wide
# stages take minutes on the CPU); model.json records it
ARCH = {"stages": ((32, 1),), "stem_patch": 8}


def _numpy_seeded(params, seed):
    """A params tree of the same shapes, drawn from a numpy seed: kernels
    He-scaled normals, scales near 1, biases small normals."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "kernel":
                fan_in = int(np.prod(val.shape[:-1]))
                out[key] = (rng.normal(size=val.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif key == "scale":
                out[key] = rng.uniform(0.8, 1.2, val.shape).astype(np.float32)
            else:
                out[key] = (rng.normal(size=val.shape) * 0.05).astype(np.float32)
        return out

    return fill(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=20 + i, n_genes=8, n_classes=3,
                                     image=True, spot_spacing_px=20, tissue_fraction=0.2)
            for i in range(3)]
    return {"dirs": [s["spaceranger_dir"] for s in sims],
            "annots": [s["annot_file"] for s in sims],
            "images": [s["image_file"] for s in sims]}


def _run(pkg, cohort, out, monkeypatch, inits=None, f=None):
    """One ``train-image`` command; returns the initial variables of each
    state it created, the grid stage's (loss, accuracy) per validation pass
    and g's variables after its first step, and the f its grid stage
    loaded. The port's states load ``inits``, the JAX run's, in order, and
    its grid stage loads ``f``, the JAX run's f."""
    rec = {"inits": [], "val": [], "spot_val": [], "first_g": None, "f": None}
    if pkg == "jax":
        orig = jl.create_train_state

        def create(model, rng, sample, tx, *a, **kw):
            state = orig(model, rng, sample, tx, *a, **kw)
            params = _numpy_seeded(state.params, 100 + len(rec["inits"]))
            state = state.replace(params=jax.tree.map(jax.numpy.asarray, params))
            rec["inits"].append(jax.tree.map(np.asarray, state.variables()))
            return state

        orig_steps = jl.make_steps

        def steps(model, tx, loss_kind, augment=None):
            train_step, eval_step = orig_steps(model, tx, loss_kind, augment=augment)
            val = rec["val" if loss_kind == "grid" else "spot_val"]

            def train(state, x, y):
                state, m = train_step(state, x, y)
                if loss_kind == "grid" and rec["first_g"] is None:
                    rec["first_g"] = jax.tree.map(np.asarray, state.variables())
                return state, m

            def evaluate(state, x, y):
                m = eval_step(state, x, y)
                val.append((float(m["loss"]), int(m["n_correct"]), int(m["n"])))
                return m

            return train, evaluate

        load_f = jax_train.load_f_params

        def load_f_params(state, f_variables, *a, **kw):
            rec["f"] = jax.tree.map(np.asarray, f_variables)
            return load_f(state, f_variables, *a, **kw)

        monkeypatch.setattr(jax_models, "TpuPatchClassifier",
                            functools.partial(jax_models.TpuPatchClassifier, **ARCH))
        monkeypatch.setattr(jl, "create_train_state", create)
        monkeypatch.setattr(jax_train, "create_train_state", create)
        monkeypatch.setattr(jax_train, "load_f_params", load_f_params)
        monkeypatch.setattr(jl, "make_steps", steps)
        # the JAX patch cache, lossless: PNG bytes under its .jpg names,
        # read back by PIL (the native batch decoder reads JPEG only)
        save = Image.Image.save
        monkeypatch.setattr(Image.Image, "save", lambda im, fp, format=None, **kw: save(
            im, fp, "PNG" if format == "JPEG" else format, **kw))
        monkeypatch.setattr(jax_datasets, "_decode_patch_batch", lambda paths: None)
        main = jax_cli.main
    else:
        inits, jax_f = iter(inits), f
        orig = tl.create_train_state

        def create(model, tx, **kw):
            state = orig(model, tx, **kw)
            load_variables(model, next(inits))
            return state

        orig_steps = tl.make_steps

        def steps(state, loss_kind, augment=None):
            train_step, eval_step = orig_steps(state, loss_kind, augment=augment)
            val = rec["val" if loss_kind == "grid" else "spot_val"]

            def train(x, y):
                m = train_step(x, y)
                if loss_kind == "grid" and rec["first_g"] is None:
                    rec["first_g"] = jax_variables(state.model)
                return m

            def evaluate(x, y):
                m = eval_step(x, y)
                val.append((float(m["loss"]), int(m["n_correct"]), int(m["n"])))
                return m

            return train, evaluate

        load_f = port_train.load_f_params

        def load_f_params(state, f_variables, key="patch_classifier"):
            rec["f"] = f_variables
            return load_f(state, jax_f, key=key)

        monkeypatch.setattr(models, "TpuPatchClassifier",
                            functools.partial(models.TpuPatchClassifier, **ARCH))
        monkeypatch.setattr(tl, "create_train_state", create)
        monkeypatch.setattr(port_train, "create_train_state", create)
        monkeypatch.setattr(port_train, "load_f_params", load_f_params)
        monkeypatch.setattr(tl, "make_steps", steps)
        main = cli.main
    argv = ["train-image", "--spaceranger", *cohort["dirs"], "--annots", *cohort["annots"],
            "--images", *cohort["images"], "--out", str(out), "--f", "tpu",
            "--patch-px", "32", "--epochs", str(EPOCHS), "--batch-size", "64",
            "--patch-chunk", "2048", "--f-lr", str(LR), "--g-lr", str(LR)]
    main(argv + (["--device", "cpu"] if pkg == "port" else []))
    return rec


def _first_step_gaps(got, want):
    """(elements beyond rtol 1e-3 / atol 1e-4, all elements, the largest
    gap) over every leaf of two variables trees."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    off = total = 0
    worst = 0.0
    for path, w in flat_w:
        g, w = np.asarray(flat_g[path], np.float64), np.asarray(w, np.float64)
        gap = np.abs(g - w)
        off += int((gap > 1e-4 + 1e-3 * np.abs(w)).sum())
        total += w.size
        worst = max(worst, float(gap.max(initial=0.0)))
    return off, total, worst


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_image_grid_stage_matches_jax(cohort, tmp_path, monkeypatch, one_thread):
    want = _run("jax", cohort, tmp_path / "jax", monkeypatch)
    monkeypatch.undo()
    got = _run("port", cohort, tmp_path / "port", monkeypatch, want["inits"], want["f"])
    assert len(want["inits"]) == 2                       # f's state, then g's
    # the spotwise stage, each package's own, batch by batch
    assert len(got["spot_val"]) == len(want["spot_val"]) > 0
    for (gl, gc, gn), (wl, wc, wn) in zip(got["spot_val"], want["spot_val"]):
        assert gn == wn > 0 and abs(gc - wc) <= 1
        np.testing.assert_allclose(gl, wl, rtol=F_RTOL)
    # the grid stage from JAX's f: one validation grid an epoch, two train
    # grids a step each
    assert len(got["val"]) == len(want["val"]) == EPOCHS
    for epoch, ((gl, gc, gn), (wl, wc, wn)) in enumerate(zip(got["val"], want["val"])):
        assert (gc, gn) == (wc, wn) and wn > 0
        np.testing.assert_allclose(gl, wl, rtol=0, atol=2 * LR * 2 * (epoch + 1))
    # g after its first step (f frozen): Adam's first step moves every
    # element by lr * sign(gradient), so an element whose gradient is float
    # noise (BatchNorm-cancelled, ROADMAP Queue 3 item 5) may step the other
    # way: 2 lr apart; at most 0.1 % of the elements may
    off, total, worst = _first_step_gaps(got["first_g"], want["first_g"])
    print(f"grid stage validation (loss, correct, spots) by epoch: JAX {want['val']}, "
          f"port {got['val']}; g after one step: {off} of {total} elements beyond "
          f"rtol 1e-3 / atol 1e-4, the largest gap {worst:.3g}")
    assert off <= total // 1000 and worst <= 2 * LR * (1 + 1e-3), (off, total, worst)
