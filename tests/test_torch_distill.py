"""The port's distillation (``train/distill.py`` and the ``distill``
command) against the JAX package, on the CPU.

- ``make_distill_step`` against JAX's jitted ``run``: the indices JAX draws
  (``jax.random.split`` / ``randint``) are fed to the port's step; from
  JAX's initial student, after 3 steps of an f32 ``TpuPatchClassifier``
  student the parameters agree within 1e-5 abs + 1e-4 rel and the losses
  within 1e-5 rel; a bf16 student's losses within 2e-2 rel; a stateless
  ``CountMLP`` student of a cross-representation teacher too;
- ``distill_patch_classifier``: one ``randint`` a step from its generator,
  the history one mean a ``scan_chunk``, the row-alignment error;
- ``patch_agreement`` and ``label_agreement`` equal to JAX's, errors too;
- both writers: ``model.json`` byte-equal to JAX's writer's on the same
  info, the weights read back by JAX's ``load_model_dir`` equal to JAX's
  writer's;
- ``python -m gridnext_tpu_torch distill --device cpu`` end to end for an
  image teacher (``GridNetHex+TpuPatchClassifier``: JAX's ``register``
  over the student directory equals the port's up to near-ties, and the
  recorded label agreement is the registrars') and for an scBERT
  multimodal teacher (``count_f: mlp``, the image f and the corrector
  bit-equal to the teacher's; the port's ``register`` equals JAX's model
  on the port's lossless grid up to near-ties), and the command's refusals.
"""

import csv
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.geometry import pseudo_hex_to_oddr
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.io.unify import read_unified_genes, unified_cache_path
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.models.scbert import load_gene2vec_names
from gridnext_tpu.train import TrainState, save_checkpoint
from gridnext_tpu.train import distill as jax_distill
from gridnext_tpu_torch.cli import main
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_model_dir, load_variables
from gridnext_tpu_torch.data import create_visium_dataset
from gridnext_tpu_torch.modeldir import image_registrar_from_meta
from gridnext_tpu_torch.models import CountMLP, TpuPatchClassifier
from gridnext_tpu_torch.serving import label_parity_report
from gridnext_tpu_torch.train import distill
from gridnext_tpu_torch.train.loops import Optimizer, make_adam

N_CLASSES, PATCH, GENES, VOCAB = 3, 16, 40, 120
CLASSES = [f"Layer{i + 1}" for i in range(N_CLASSES)]
TPU_F = {"stages": [[16, 1]], "stem_patch": 8, "norm": "rms"}
SYMBOLS = load_gene2vec_names()[1:2 * GENES + 1:2]
B, N_POOL, LR = 16, 48, 3e-4     # LR: the command's default



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    machine's cores, and multi-threaded small CPU ops contend badly there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _tree_close(got, want, atol, rtol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_close(got[k], want[k], atol, rtol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _tree_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax_steps(teacher_apply, student, params, pool, t_pool, keys):
    """JAX's ``run``, one update a call: (params after each, losses)."""
    tx = optax.adam(LR)
    run = jax_distill.make_distill_step(teacher_apply, student, tx)
    opt = tx.init(params)
    losses = []
    for k in keys:
        params, opt, loss = run(params, opt, jnp.asarray(pool), jnp.asarray(t_pool), k,
                                batch_size=B, n_steps=1)
        losses.append(float(loss))
    return params, losses


def _jax_indices(keys, n):
    """The rows ``run`` draws for ``n_steps=1`` under each key."""
    return [np.asarray(jax.random.randint(jax.random.split(k, 1)[0], (B,), 0, n))
            for k in keys]


def _port_steps(teacher, student, pool, t_pool, indices):
    step = distill.make_distill_step(teacher, student, Optimizer(make_adam(LR), student))
    return [float(step(pool, t_pool, torch.tensor(idx, dtype=torch.int64)))
            for idx in indices]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_distill_step_matches_jax(dtype):
    rng = np.random.default_rng(0)
    pool = rng.random((N_POOL, PATCH, PATCH, 3)).astype(np.float32)
    jt = JaxTpuF(n_classes=N_CLASSES, stages=((32, 1),), stem_patch=8)
    tvars = jt.init(jax.random.key(1), jnp.asarray(pool[:1]))
    tvars = jax.tree_util.tree_map(lambda a: a * 3.0 if a.ndim > 1 else a, tvars)
    js = JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),), stem_patch=8,
                 dtype=jnp.bfloat16 if dtype == "bf16" else None)
    sparams = js.init(jax.random.key(2), jnp.asarray(pool[:1]))["params"]
    keys = list(jax.random.split(jax.random.key(3), 3))
    want_params, want_losses = _jax_steps(lambda x: jt.apply(tvars, x, train=False), js,
                                          sparams, pool, pool, keys)

    teacher = load_variables(TpuPatchClassifier(N_CLASSES, stages=((32, 1),), stem_patch=8),
                             jax.device_get(tvars))
    student = load_variables(TpuPatchClassifier(
        N_CLASSES, stages=((16, 1),), stem_patch=8,
        dtype=torch.bfloat16 if dtype == "bf16" else None),
        {"params": jax.device_get(sparams)})
    pool_t = torch.as_tensor(pool)
    got_losses = _port_steps(teacher, student, pool_t, pool_t, _jax_indices(keys, N_POOL))
    if dtype == "f32":
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
        _tree_close(jax_variables(student)["params"], jax.device_get(want_params),
                    atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got_losses, want_losses, rtol=2e-2)
    assert not teacher.training and all(p.grad is None for p in teacher.parameters())


def test_cross_representation_step_matches_jax():
    """A CountMLP(batch_norm=False) student on log1p counts, the teacher on
    another representation of the same rows."""
    rng = np.random.default_rng(1)
    raw = rng.poisson(2.0, (N_POOL, GENES)).astype(np.float32)
    s_pool, t_pool = np.log1p(raw), np.sqrt(raw)
    jt = JaxCountMLP(n_classes=N_CLASSES, batch_norm=False)
    tvars = jt.init(jax.random.key(4), jnp.asarray(t_pool[:1]))
    js = JaxCountMLP(n_classes=N_CLASSES, batch_norm=False)
    sparams = js.init(jax.random.key(5), jnp.asarray(s_pool[:1]))["params"]
    keys = list(jax.random.split(jax.random.key(6), 3))
    want_params, want_losses = _jax_steps(lambda x: jt.apply(tvars, x, train=False), js,
                                          sparams, s_pool, t_pool, keys)
    teacher = load_variables(CountMLP(GENES, N_CLASSES, batch_norm=False),
                             jax.device_get(tvars))
    student = load_variables(CountMLP(GENES, N_CLASSES, batch_norm=False),
                             {"params": jax.device_get(sparams)})
    got = _port_steps(teacher, student, torch.as_tensor(s_pool), torch.as_tensor(t_pool),
                      _jax_indices(keys, N_POOL))
    np.testing.assert_allclose(got, want_losses, rtol=1e-5)
    _tree_close(jax_variables(student)["params"], jax.device_get(want_params),
                atol=1e-5, rtol=1e-4)


def test_distill_patch_classifier_draws_and_history(monkeypatch):
    rng = np.random.default_rng(2)
    raw = rng.poisson(2.0, (N_POOL, GENES)).astype(np.float32)
    teacher = CountMLP(GENES, N_CLASSES, batch_norm=False)
    student = CountMLP(GENES, N_CLASSES, batch_norm=False)
    draws = []
    randint = torch.randint

    def counted(*args, **kwargs):
        draws.append(kwargs.get("generator"))
        return randint(*args, **kwargs)

    monkeypatch.setattr(torch, "randint", counted)
    gen = torch.Generator().manual_seed(5)
    variables, losses = distill.distill_patch_classifier(
        teacher, student, torch.as_tensor(np.log1p(raw)), steps=25, batch_size=8,
        scan_chunk=10, generator=gen, verbose=False)
    assert len(draws) == 25 and all(g is gen for g in draws)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert sorted(variables) == ["params"] and not student.training
    _tree_equal(variables["params"], jax_variables(student)["params"])
    with pytest.raises(ValueError, match="row-aligned"):
        distill.distill_patch_classifier(teacher, student, torch.as_tensor(np.log1p(raw)),
                                         teacher_inputs=torch.as_tensor(raw[:-1]), steps=1)


def test_agreement_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((70, GENES)).astype(np.float32)
    w_t, w_s = rng.standard_normal((2, GENES, N_CLASSES)).astype(np.float32)
    w_s = w_t + 0.5 * w_s
    want = jax_distill.patch_agreement(lambda a: a @ w_t, lambda a: a @ w_s, x, batch_size=16)
    got = distill.patch_agreement(lambda a: a @ torch.as_tensor(w_t),
                                  lambda a: a @ torch.as_tensor(w_s), torch.as_tensor(x),
                                  batch_size=16)
    assert got == want and 0 < got < 1
    a, b = rng.integers(0, 4, (2, 9, 7))
    assert distill.label_agreement(a, b) == jax_distill.label_agreement(a, b)
    for fn, args in ((distill.patch_agreement, (None, None, x[:0])),
                     (distill.label_agreement, (np.zeros((3, 3)), np.zeros((3, 3))))):
        with pytest.raises(ValueError):
            fn(*args)


def _jax_mm_variables(seed=7):
    count = JaxScBERT(n_genes=VOCAB, dim=16, depth=1, heads=2, dim_head=8, nb_features=8,
                      n_classes=N_CLASSES, generalized_attention=True)
    g = JaxGridNetHexMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                                 stem_patch=8),
                        count_classifier=count, n_classes=N_CLASSES, count_chunk=512)
    return _moved(jax.jit(g.init)(jax.random.key(seed), (
        jnp.zeros((1, 2, 2, PATCH, PATCH, 3)), jnp.zeros((1, 2, 2, VOCAB)))), seed)


def test_writers_match_jax(tmp_path):
    g = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((32, 1),),
                                               stem_patch=8), n_classes=N_CLASSES)
    tvars = jax.device_get(jax.jit(g.init)(jax.random.key(0),
                                           jnp.zeros((1, 2, 2, PATCH, PATCH, 3))))
    js = JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),), stem_patch=8)
    svars = jax.device_get(js.init(jax.random.key(1), jnp.zeros((1, PATCH, PATCH, 3))))
    meta = {"model": "GridNetHex+DenseNet121", "patch_px": PATCH, "window_px": 24,
            "grid_dims": None, "hd_binning": None, "patch_chunk": 64, "dense_ingest": False,
            "classes": CLASSES, "extra_field": 1}
    info = {"patch_agreement": 0.91234567, "steps": 20, "final_loss": 0.1234567,
            "label_agreement": 0.75}
    jax_distill.write_distilled_model_dir(str(tmp_path / "jax"), meta, CLASSES, tvars, svars,
                                          js, info)
    student = TpuPatchClassifier(N_CLASSES, stages=((16, 1),), stem_patch=8)
    got_meta = distill.write_distilled_model_dir(str(tmp_path / "port"), meta, CLASSES, tvars,
                                                 svars, student, info)
    assert (tmp_path / "port" / "model.json").read_bytes() == \
        (tmp_path / "jax" / "model.json").read_bytes()
    assert got_meta["distill"]["steps"] == 20.0 and got_meta["tpu_f"] == {
        "stages": [[16, 1]], "stem_patch": 8, "norm": "rms"}
    _, _, want_vars = jax_modeldir.load_model_dir(str(tmp_path / "jax"))
    _, _, got_vars = jax_modeldir.load_model_dir(str(tmp_path / "port"))
    _tree_equal(got_vars, want_vars)

    mm_vars = jax.device_get(_jax_mm_variables())
    mlp = JaxCountMLP(n_classes=N_CLASSES, batch_norm=False)
    mlp_vars = jax.device_get(mlp.init(jax.random.key(2), jnp.zeros((1, GENES))))
    mm_meta = {"model": "GridNetHexMM", "count_f": "scbert", "scbert_vocab": VOCAB,
               "count_chunk": 8, "classes": CLASSES, "patch_px": PATCH, "log1p": False}
    jax_distill.write_count_distilled_mm_dir(str(tmp_path / "mm_jax"), mm_meta, CLASSES,
                                             mm_vars, mlp_vars, {"count_f_agreement": 0.5})
    distill.write_count_distilled_mm_dir(str(tmp_path / "mm_port"), mm_meta, CLASSES,
                                         mm_vars, mlp_vars, {"count_f_agreement": 0.5})
    assert (tmp_path / "mm_port" / "model.json").read_bytes() == \
        (tmp_path / "mm_jax" / "model.json").read_bytes()
    _, _, want_vars = jax_modeldir.load_model_dir(str(tmp_path / "mm_jax"))
    _, _, got_vars = jax_modeldir.load_model_dir(str(tmp_path / "mm_port"))
    _tree_equal(got_vars, want_vars)
    assert "favor" not in got_vars            # the scBERT projections go with it


# -- the command ------------------------------------------------------------------


def _moved(variables, seed=1):
    rng = np.random.default_rng(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


def _save_dir(d, variables, meta):
    state = TrainState(params=variables["params"], batch_stats=variables.get("batch_stats"),
                       opt_state=None, step=jnp.asarray(0, jnp.int32),
                       extra_vars={k: v for k, v in variables.items()
                                   if k not in ("params", "batch_stats")})
    os.makedirs(d, exist_ok=True)
    save_checkpoint(os.path.join(d, "g_state.msgpack"), state, include_opt_state=False)
    with open(os.path.join(d, "model.json"), "w") as fh:
        json.dump({"classes": CLASSES, **meta}, fh)
    return str(d)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_distill")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=GENES,
                                     n_classes=N_CLASSES, image=True, spot_spacing_px=10,
                                     tissue_fraction=frac, gene_names=SYMBOLS)
            for i, frac in enumerate((0.4, 0.3))]
    dirs = [s["spaceranger_dir"] for s in sims]
    prepare_count_files(dirs, verbose=False)
    return root, dirs, [s["image_file"] for s in sims]


def _csv_grid(path, srd):
    pos = jax_read_positions(srd)
    grid = np.zeros((78, 64), np.int64)
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    for barcode, annot in rows[1:]:
        x, y = pseudo_hex_to_oddr(int(pos.loc[barcode, "array_col"]),
                                  int(pos.loc[barcode, "array_row"]))
        grid[y, x] = CLASSES.index(annot) + 1 if annot else 0
    return grid


def test_distill_image_teacher_end_to_end(cohort, tmp_path):
    root, srds, images = cohort
    g = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((32, 1),),
                                               stem_patch=8), n_classes=N_CLASSES)
    tdir = _save_dir(tmp_path / "teacher", _moved(jax.jit(g.init)(
        jax.random.key(0), jnp.zeros((1, 2, 2, PATCH, PATCH, 3))), 3),
        {"patch_px": PATCH, "window_px": None, "model": "GridNetHex+TpuPatchClassifier",
         "tpu_f": {"stages": [[32, 1]], "stem_patch": 8, "norm": "rms"}, "image_f": "tpu",
         "hd_binning": None, "grid_dims": None, "patch_chunk": 256, "dense_ingest": False})
    out = str(tmp_path / "student")
    info = main(["distill", "--model", tdir, "--spaceranger", *srds, "--images", *images,
                 "--out", out, "--steps", "30", "--batch-size", "32", "--max-patches", "300",
                 "--student-stages", "16:1", "--student-stem", "8", "--f32",
                 "--device", "cpu"])
    meta, classes, variables = load_model_dir(out)
    assert meta["model"] == "GridNetHex+TpuPatchClassifier" and meta["tpu_f"] == TPU_F
    assert meta["distilled_from"] == "GridNetHex+TpuPatchClassifier" and classes == CLASSES
    assert sorted(meta["distill"]) == ["final_loss", "label_agreement", "patch_agreement",
                                       "steps"]
    assert meta["distill"]["label_agreement"] == round(info["label_agreement"], 6)
    _, _, tvars = load_model_dir(tdir)
    _tree_equal(variables["params"]["corrector"], tvars["params"]["corrector"])
    _tree_equal(variables["batch_stats"], {"corrector": tvars["batch_stats"]["corrector"]})

    # the recorded agreement is the two registrars' on the slides
    tmeta, tclasses, _ = load_model_dir(tdir)
    reg_t = image_registrar_from_meta(tmeta, tclasses, tvars, device="cpu")
    reg_s = image_registrar_from_meta(meta, classes, variables, device="cpu")
    agrs = [distill.label_agreement(reg_t(np.asarray(Image.open(im)), jax_read_positions(s)),
                                    reg_s(np.asarray(Image.open(im)), jax_read_positions(s)))
            for s, im in zip(srds, images)]
    assert info["label_agreement"] == pytest.approx(float(np.mean(agrs)), abs=1e-12)

    # JAX's register over the port's student directory names the port's labels
    args = ["register", "--model", out, "--images", *images, "--spaceranger", *srds]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jmeta, jclasses, jvars = jax_modeldir.load_model_dir(out)
    jax_reg = jax_modeldir.image_registrar_from_meta(jmeta, jclasses, jvars)
    for name, srd, image in zip(sorted(os.listdir(tmp_path / "jax")), srds, images):
        want = _csv_grid(tmp_path / "jax" / name, srd)
        got = _csv_grid(tmp_path / "port" / name, srd)
        logits, _ = jax_reg.register_logits(jnp.asarray(np.asarray(Image.open(image))),
                                            jax_read_positions(srd))
        label_parity_report(want, got, logits)


def test_distill_scbert_mm_teacher_end_to_end(cohort, tmp_path):
    root, srds, images = cohort
    genes = read_unified_genes(unified_cache_path(srds[0]))
    tvars = _jax_mm_variables(seed=8)
    tmeta = {"patch_px": PATCH, "window_px": None, "patch_chunk": 256, "count_chunk": 512,
             "n_genes": len(genes), "genes": genes, "log1p": False, "count_f": "scbert",
             "scbert_vocab": VOCAB, "scbert_dim": 16, "scbert_depth": 1, "scbert_heads": 2,
             "scbert_dim_head": 8, "scbert_features": 8, "hd_binning": None,
             "grid_dims": None, "image_f": "tpu", "tpu_f": TPU_F, "dense_ingest": False,
             "model": "GridNetHexMM"}
    tdir = _save_dir(tmp_path / "mm_teacher", tvars, tmeta)
    out = str(tmp_path / "mm_student")
    info = main(["distill", "--model", tdir, "--spaceranger", *srds, "--images", *images,
                 "--out", out, "--steps", "30", "--batch-size", "32", "--device", "cpu"])
    meta, classes, variables = load_model_dir(out)
    assert meta["count_f"] == "mlp" and meta["log1p"] is True
    assert meta["count_mlp_bn"] is False and meta["count_chunk"] is None
    assert meta["count_distilled_from"] == "scbert"
    assert sorted(meta["distill"]) == ["count_f_agreement", "final_loss", "label_agreement",
                                       "steps"]
    assert 0.0 <= info["label_agreement"] <= 1.0
    _, _, tvars_back = load_model_dir(tdir)
    for col in ("params", "batch_stats"):
        kept = {k: v for k, v in tvars_back[col].items() if k != "count_classifier"}
        assert "corrector" in kept
        for key, sub in kept.items():
            _tree_equal(variables[col][key], sub)
    assert "favor" not in variables

    # the port's register against JAX's model of the student directory on the
    # port's lossless grids
    main(["register", "--model", out, "--images", *images, "--spaceranger", *srds,
          "--out", str(tmp_path / "port"), "--device", "cpu"])
    jmeta, jclasses, jvars = jax_modeldir.load_model_dir(out)
    jmodel = jax_modeldir.mm_model_from_meta(jmeta, jclasses)
    grids = create_visium_dataset(srds, fullres_image_files=images, patch_size_px=PATCH,
                                  device="cpu")
    for i, (name, srd) in enumerate(zip(sorted(os.listdir(tmp_path / "port")), srds)):
        (xi, xc), _ = grids[i]
        logits = np.asarray(jmodel.apply(jvars, (jnp.asarray(xi.numpy()[None]),
                                                 jnp.asarray(np.log1p(xc)[None])),
                                         train=False))[0]
        want = np.where(xc.sum(-1) > 0, logits.argmax(-1) + 1, 0)
        label_parity_report(want, _csv_grid(tmp_path / "port" / name, srd), logits)


def _exit_code(fn, args):
    with pytest.raises(SystemExit) as e:
        fn(args)
    return e.value.code


def test_distill_refusals_match_jax(cohort, tmp_path):
    _, srds, images = cohort
    genes = read_unified_genes(unified_cache_path(srds[0]))
    count_dir = tmp_path / "count"
    g = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    _save_dir(count_dir, jax.jit(g.init)(jax.random.key(0), jnp.zeros((1, 2, 2, len(genes)))),
              {"model": "GridNetHex+CountMLP", "genes": genes, "log1p": True})
    mlp_mm = tmp_path / "mlp_mm"
    os.makedirs(mlp_mm)
    (mlp_mm / "g_state.msgpack").write_bytes((count_dir / "g_state.msgpack").read_bytes())
    (mlp_mm / "model.json").write_text(json.dumps({"classes": CLASSES, "model": "GridNetHexMM",
                                                   "count_f": "mlp"}))
    base = ["distill", "--spaceranger", *srds, "--images", *images, "--out",
            str(tmp_path / "out")]
    for model in (count_dir, mlp_mm):
        want = _exit_code(jax_main, base + ["--model", str(model)])
        assert isinstance(want, str) and want.startswith("error:")
        assert _exit_code(main, base + ["--model", str(model), "--device", "cpu"]) == want
    assert not (tmp_path / "out").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(base + ["--model", str(count_dir)])
