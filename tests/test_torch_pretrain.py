"""The port's masked-LM pretraining, scBERT checkpoints and fine-tuning
against the JAX package.

Weights are initialised in JAX, moved off their init values by numpy noise
and carried across by the weight bridge; inputs and masks come from a
numpy seed. Random draws (the MLM mask, redraws, initialisation) cannot
match JAX's bits, so the MLM mask is injected into both steps. Covered:

- one ``make_mlm_steps`` train step and an eval step on an injected mask,
  pad rows in the batch: loss, counts and the Adam-updated parameters
  (1e-5 abs / 1e-4 rel);
- ``train_mlm`` resumed after an epoch, with a FAVOR redraw in each epoch,
  bit-equal to an uninterrupted run (``redraws_done`` recorded);
- ``compat/scbert_convert.py`` on a reference-named state dict (LayerNorm
  with the ``AttentionClassifier`` head and a gene2vec table, ScaleNorm,
  ReZero): forwards equal to JAX's ``scbert_from_torch`` models', and a
  ``.pth`` with a ``model_state_dict`` wrapper read by ``_load_scbert_ckpt``;
- ``pretrain-scbert`` (``--device cpu``, tiny widths) whose
  ``scbert_lm.msgpack`` JAX's ``_load_scbert_ckpt`` reads, and a JAX
  checkpoint the port's reads, every LM leaf bit-equal after the merge and
  only the head re-initialised; ``finetune_param_labels`` leaf for leaf
  against JAX's; ``train-mm --scbert-ckpt
  --scbert-finetune`` leaving every frozen leaf bit-unchanged in both
  stages, its ``.latest`` restored by JAX's ``restore_train_state``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gridnext_tpu import cli as jax_cli
from gridnext_tpu.compat import scbert_convert as jconv
from gridnext_tpu.models import performer as jp
from gridnext_tpu.models import scbert as js
from gridnext_tpu.train import loops as jloops
from gridnext_tpu_torch import cli
from gridnext_tpu_torch.compat import scbert_convert as tconv
from gridnext_tpu_torch.compat import from_jax as tfj
from gridnext_tpu_torch.compat.from_jax import jax_variables, load_checkpoint, load_performer
from gridnext_tpu_torch.models import performer as tp
from gridnext_tpu_torch.models import scbert as ts
from gridnext_tpu_torch.train import loops
from gridnext_tpu_torch.train.init import flax_init_

DIM, DEPTH, HEADS, DH, M, N = 16, 2, 2, 8, 8, 33
LM_KW = dict(num_tokens=7, max_seq_len=N, dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH,
             nb_features=M, generalized_attention=True)
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    machine's cores, and multi-threaded small CPU ops contend badly there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(6, size=(n, N), p=[0.7, 0.15, 0.08, 0.04, 0.02, 0.01]).astype(np.int16)


@pytest.fixture(scope="module")
def jax_lm():
    """A JAX PerformerLM with noise-moved params (one init for the file)."""
    model = jp.PerformerLM(**LM_KW)
    variables = _np_tree(model.init(jax.random.key(0), jnp.zeros((1, N), jnp.int32)))
    rng = np.random.default_rng(1)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        variables["params"])
    return model, variables


def test_mlm_step_matches_jax(jax_lm, monkeypatch):
    model, variables = jax_lm
    y = _corpus(6).astype(np.int32)
    y[4:] = -1                                           # two pad rows
    mask = np.random.default_rng(2).random(y.shape) < 0.3
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    monkeypatch.setattr(loops, "_mlm_mask", lambda g, shape, p, device: torch.from_numpy(mask))
    tx = optax.adam(LR)
    train_j, eval_j = jloops.make_mlm_steps(model, tx, mask_id=6)
    state_j = jloops.TrainState(params=variables["params"], batch_stats=None,
                                opt_state=tx.init(variables["params"]),
                                step=jnp.zeros((), jnp.int32),
                                extra_vars={"favor": variables["favor"]})
    dummy = jnp.zeros((6, 1), jnp.int8)
    ev_j = eval_j(state_j, dummy, jnp.asarray(y))
    new_j, m_j = train_j(state_j, dummy, jnp.asarray(y))

    lm = load_performer(tp.PerformerLM(**LM_KW), variables)
    state = loops.create_train_state(lm, loops.make_adam(LR), device="cpu", init=False)
    train_t, eval_t = loops.make_mlm_steps(state, mask_id=6)
    yt = torch.from_numpy(y)
    ev_t = eval_t(None, yt)
    m_t = train_t(None, yt)
    for got, want in ((ev_t, ev_j), (m_t, m_j)):
        assert int(got["n"]) == int(want["n"]) == int((mask & (y >= 0)).sum())
        assert int(got["n_correct"]) == int(want["n_correct"])
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    got = jax_variables(lm)["params"]
    for path, a in _leaves(_np_tree(new_j.params)):
        np.testing.assert_allclose(_get(got, path), a, atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))
    assert state.step == 1


def test_train_mlm_resume_with_redraw_matches_uninterrupted(tmp_path):
    tokens = {"train": _corpus(16, seed=3), "val": _corpus(4, seed=4)}

    def run(out, epochs, resume=None):
        lm = tp.PerformerLM(**LM_KW)
        loops.train_mlm(lm, tokens, mask_id=6, learning_rate=5e-3, num_epochs=epochs,
                        batch_size=4, outfile=str(out), redraw_every=3, verbose=False,
                        resume=resume, device="cpu")
        return lm

    run(tmp_path / "a.msgpack", 2)
    run(tmp_path / "b.msgpack", 1)
    run(tmp_path / "b.msgpack", 2, resume=str(tmp_path / "b.msgpack.latest"))
    a, b = (load_checkpoint(tmp_path / f"{k}.msgpack.latest") for k in "ab")
    assert a["redraws_done"] == b["redraws_done"] == 2 and a["step"] == b["step"] == 8
    for coll in ("params", "extra_vars"):
        for path, leaf in _leaves(a[coll]):
            np.testing.assert_array_equal(_get(b[coll], path), leaf, err_msg="/".join(path))
    # the projections the run started from (train_mlm's default init) were redrawn
    start = flax_init_(tp.PerformerLM(**LM_KW), torch.Generator().manual_seed(0))
    for i, fa in enumerate(tp.fast_attentions(start)):
        drawn = _get(a["extra_vars"], ("favor", "performer", f"layers_{i}_attn",
                                       "fast_attention", "projection"))
        assert not np.array_equal(drawn, fa.projection.numpy())


def _reference_state_dict(kind, seed=5, n_genes=20, n_classes=3):
    """A state dict named as the reference's PerformerLM / scBERT."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32))

    inner = HEADS * DH
    sd = {"token_emb.weight": t(7, DIM), "norm.weight": 1 + t(DIM), "norm.bias": t(DIM)}
    for i in range(DEPTH):
        base = f"performer.net.layers.{i}"
        for j in (0, 1):
            if kind in ("layernorm", "head"):
                sd[f"{base}.{j}.norm.weight"] = 1 + t(DIM)
                sd[f"{base}.{j}.norm.bias"] = t(DIM)
            else:
                sd[f"{base}.{j}.g"] = 1 + t(1) if kind == "scalenorm" else 0.5 + t(1)
        for name in ("to_q", "to_k", "to_v"):
            sd[f"{base}.0.fn.{name}.weight"] = t(inner, DIM)
        sd[f"{base}.0.fn.to_out.weight"] = t(DIM, inner)
        sd[f"{base}.0.fn.to_out.bias"] = t(DIM)
        q, _ = np.linalg.qr(rng.standard_normal((DH, DH)))
        sd[f"{base}.0.fn.fast_attention.projection_matrix"] = torch.from_numpy(
            (2.8 * q.T[:M]).astype(np.float32))
        sd[f"{base}.1.fn.fn.w1.weight"] = t(4 * DIM, DIM)
        sd[f"{base}.1.fn.fn.w1.bias"] = t(4 * DIM)
        sd[f"{base}.1.fn.fn.w2.weight"] = t(DIM, 4 * DIM)
        sd[f"{base}.1.fn.fn.w2.bias"] = t(DIM)
    if kind == "head":
        sd.update({"to_out.conv1.weight": t(1, 1, 1, DIM), "to_out.conv1.bias": t(1),
                   "to_out.fc1.weight": t(512, n_genes + 1), "to_out.fc1.bias": t(512),
                   "to_out.fc2.weight": t(128, 512), "to_out.fc2.bias": t(128),
                   "to_out.fc3.weight": t(n_classes, 128), "to_out.fc3.bias": t(n_classes),
                   "pos_emb.emb.weight": t(n_genes + 1, DIM)})
    else:
        sd.update({"to_out.weight": t(7, DIM), "to_out.bias": t(7)})
    return sd


@pytest.mark.parametrize("kind", ["head", "scalenorm", "rezero"])
def test_scbert_convert_matches_jax(kind, tmp_path):
    sd = _reference_state_dict(kind)
    scalenorm = kind == "scalenorm"
    if kind == "head":
        x = np.random.default_rng(6).uniform(0, 7, (2, 20)).astype(np.float32)
        jv, jg2v = jconv.scbert_from_torch(sd, depth=DEPTH)
        kw = dict(n_genes=20, dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, nb_features=M,
                  n_classes=3, generalized_attention=True)
        want = js.scBERT(g2v_weights=jg2v, **kw).apply(jv, jnp.asarray(x))
        torch.save({"model_state_dict": sd}, tmp_path / "ref.pth")
        loaded = cli._load_scbert_ckpt(str(tmp_path / "ref.pth"), DEPTH)
        tv, tg2v = tconv.scbert_from_torch(sd, depth=DEPTH)
        for path, leaf in _leaves(tv):
            np.testing.assert_array_equal(_get(loaded, path), leaf)
        np.testing.assert_array_equal(tg2v, jg2v)
        tm = tfj.load_variables(ts.scBERT(g2v_weights=tg2v, **kw), tv)
        inp = torch.from_numpy(x)
    else:
        tokens = np.random.default_rng(7).integers(0, 7, (2, 30))
        kw = dict(LM_KW, use_scalenorm=scalenorm, use_rezero=not scalenorm)
        jv, _ = jconv.performer_lm_from_torch(sd, DEPTH, use_scalenorm=scalenorm)
        want = jp.PerformerLM(**kw).apply(jv, jnp.asarray(tokens))
        tv, _ = tconv.performer_lm_from_torch(sd, DEPTH, use_scalenorm=scalenorm)
        tm = tfj.load_variables(tp.PerformerLM(**kw), tv)
        inp = torch.from_numpy(tokens)
    with torch.no_grad():
        got = tm(inp).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-4)


SC_ARGS = ["--scbert-vocab", "60", "--scbert-dim", str(DIM), "--scbert-depth", str(DEPTH),
           "--scbert-heads", str(HEADS), "--scbert-dim-head", str(DH), "--scbert-features",
           str(M)]


def test_checkpoints_across_packages_and_finetune(jax_lm, tmp_path):
    from gridnext_tpu.data import simulate_spaceranger_dir
    from gridnext_tpu.io import prepare_count_files

    names = list(js.load_gene2vec_names()[:20])
    sims = [simulate_spaceranger_dir(tmp_path / f"s{i}", seed=i, n_genes=20, n_classes=3,
                                     image=True, spot_spacing_px=20, tissue_fraction=0.25,
                                     gene_names=names) for i in range(2)]
    dirs = [s["spaceranger_dir"] for s in sims]
    prepare_count_files(dirs, ".unified.tsv.gz", 0.0)
    cli.main(["pretrain-scbert", "--spaceranger", *dirs, "--out", str(tmp_path / "lm"),
              "--epochs", "1", "--redraw-every", "3", "--device", "cpu", *SC_ARGS])
    port_file = str(tmp_path / "lm" / "scbert_lm.msgpack")
    port_lm = load_checkpoint(port_file)
    assert "opt_state" not in port_lm

    # the port's checkpoint through JAX's loader and merge
    sc_kw = dict(n_genes=60, dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, nb_features=M,
                 n_classes=3, generalized_attention=True)
    fresh = _np_tree(js.scBERT(**sc_kw).init(jax.random.key(0), jnp.zeros((1, 60))))
    # the freeze policy, leaf for leaf
    want = js.finetune_param_labels(fresh["params"], DEPTH)
    got = ts.finetune_param_labels(jax_variables(ts.scBERT(**sc_kw))["params"], DEPTH)
    assert sorted((p, str(v)) for p, v in _leaves(got)) == sorted(
        (p, str(v)) for p, v in _leaves(jax.tree_util.tree_map(str, want)))
    assert {str(v) for _, v in _leaves(got)} == {"train", "frozen"}
    loaded = jax_cli._load_scbert_ckpt(port_file, DEPTH)
    skipped = []
    merged = jax_cli._merge_matching_params(fresh["params"], loaded["params"], skipped)
    assert skipped == ["/to_out (missing)"]
    for coll, tree in (("params", merged), ("extra_vars", None)):
        src = port_lm[coll]
        if coll == "extra_vars":
            tree = jax_cli._merge_matching_params(fresh["favor"], loaded["favor"], [])
            src = src["favor"]
        for path, leaf in _leaves(tree):
            if path[0] == "performer_lm":
                np.testing.assert_array_equal(leaf, _get(src, path[1:]))

    # a JAX checkpoint through the port's loader and merge (its weights do
    # not depend on the token count)
    _, jvars = jax_lm
    jstate = jloops.TrainState(params=jvars["params"], batch_stats=None, opt_state=None,
                               step=jnp.zeros((), jnp.int32),
                               extra_vars={"favor": jvars["favor"]})
    jloops.save_checkpoint(tmp_path / "jax_lm.msgpack", jstate, include_opt_state=False)
    loaded = cli._load_scbert_ckpt(str(tmp_path / "jax_lm.msgpack"), DEPTH)
    port = ts.scBERT(**sc_kw)
    fresh_t, skipped = jax_variables(port), []
    merged = {c: cli._merge_matching_params(v, loaded[c], skipped) for c, v in fresh_t.items()}
    assert skipped == ["/to_out (missing)"]
    from gridnext_tpu_torch.compat.from_jax import load_variables

    back = jax_variables(load_variables(port, merged))
    jtree = {"params": _np_tree(jstate.params), "favor": _np_tree(jstate.extra_vars["favor"])}
    for coll in ("params", "favor"):
        for path, leaf in _leaves(jtree[coll]):
            if path[0] != "to_out":
                np.testing.assert_array_equal(_get(back[coll], ("performer_lm",) + path), leaf)

    # fine-tuning from the port's checkpoint: frozen leaves bit-unchanged
    out = tmp_path / "mm"
    cli.main(["train-mm", "--spaceranger", *dirs, "--annots", *[s["annot_file"] for s in sims],
              "--images", *[s["image_file"] for s in sims], "--out", str(out), "--epochs", "1",
              "--f", "tpu", "--patch-px", "32", "--batch-size", "64", "--patch-chunk", "2048",
              "--count-f", "scbert", "--count-chunk", "64", "--scbert-ckpt", port_file,
              "--scbert-finetune", "--device", "cpu", *SC_ARGS])
    f_state = load_checkpoint(out / "f_count_state.msgpack.latest")
    g_state = load_checkpoint(out / "g_state.msgpack")
    labels = ts.finetune_param_labels(f_state["params"], DEPTH)
    moved = 0
    for path, label in _leaves(labels):
        if path[0] != "performer_lm":
            continue
        start = _get(port_lm["params"], path[1:])
        f_leaf = _get(f_state["params"], path)
        g_leaf = _get(g_state["params"]["count_classifier"], path)
        if str(label) == "frozen":
            np.testing.assert_array_equal(f_leaf, start, err_msg="/".join(path))
            np.testing.assert_array_equal(g_leaf, start, err_msg="/".join(path))
        else:
            moved += not np.array_equal(f_leaf, start)
    assert moved > 10
    assert set(f_state["opt_state"]["inner_states"]) == {"train", "frozen"}

    # JAX resumes the port's fine-tuning state
    labels_fn = lambda p: js.finetune_param_labels(p, DEPTH)  # noqa: E731
    tx = optax.multi_transform({"train": optax.adam(LR), "frozen": optax.set_to_zero()},
                               labels_fn)
    template = jloops.TrainState(params=fresh["params"], batch_stats=None,
                                 opt_state=tx.init(fresh["params"]),
                                 step=jnp.zeros((), jnp.int32),
                                 extra_vars={"favor": fresh["favor"]})
    restored = jloops.restore_train_state(out / "f_count_state.msgpack.latest", template)
    assert int(restored.step) == f_state["step"]
    for path, leaf in _leaves(_np_tree(restored.params)):
        np.testing.assert_array_equal(leaf, _get(f_state["params"], path))
    count = restored.opt_state.inner_states["train"].inner_state[0].count
    assert int(count) == f_state["step"]
