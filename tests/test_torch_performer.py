"""The port's FAVOR ops, Performer and scBERT against the JAX package.

Inputs come from a numpy seed; weights are initialised in JAX, moved off
their init values by numpy noise (so LayerNorm scales and biases are not
1 and 0) and carried across by the weight bridge. Covered:

- the favor features and ``linear_attention`` against ``ops/favor.py``
  (1e-5 relative);
- the port's plain FAVOR (and its wrapper on the CPU) against the JAX
  Pallas kernel run interpreted and against its einsum path, within rtol
  2e-4 / atol 2e-5 (the JAX kernel's own test tolerance);
- ``FastAttention`` (generalized, softmax, ``no_projection``),
  ``SelfAttention``, ``Performer`` (plain, GLU, chunked), ``PerformerLM``,
  ``AttentionClassifier`` and ``scBERT`` at dim 32, depth 2, heads 2,
  ``dim_head`` 16, m 24, 50 genes, against ``model.apply``: the largest
  difference within 1e-4 of the largest output (f32, other summation
  orders);
- the causal scan (N 33 and 300: one ragged chunk, three chunks and a
  ragged tail) and ``implicit_attention_weights`` (a zero row) against
  ``ops/favor.py`` within 1e-5 abs / 1e-4 rel; both rotary conventions;
  ``local_block_attention`` (causal or not, masked, rows with every key
  masked) against JAX's and against the float64 oracle
  ``compat/local_attention_ref.py``; ``SelfAttention`` with local and
  rotary global heads and a mask; a causal, a ScaleNorm and a ReZero
  ``Performer`` and causal ``no_projection``; ``PerformerLM`` with
  absolute and gene2vec positional embeddings and ``tie_embed``;
  ``sow_attention``'s per-layer maps against JAX's ``intermediates``;
  ``remat`` giving the gradients (dropout on) of the plain forward;
  ``redraw_projections``' distribution (rows orthogonal, norms as
  ``orthogonal_gaussian_matrix``'s, each layer distinct);
- ``preprocess_scbert`` and the gene2vec vocabulary (the port's copy
  byte-equal to the JAX asset); ``orthogonal_gaussian_matrix``'s
  properties (JAX's random stream cannot be reproduced).

The FAVOR CUDA kernel is held against the plain version in
``test_torch_cuda.py`` (on a card) and by ``chip_smoke.py`` at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gridnext_tpu.models import performer as jp
from gridnext_tpu.models import scbert as js
from gridnext_tpu.ops import favor as jfavor
from gridnext_tpu.ops.favor_pallas import (_einsum_reference,
                                           fused_generalized_linear_attention as jax_fused)
from gridnext_tpu_torch.compat.from_jax import load_performer
from gridnext_tpu_torch.models import performer as tp
from gridnext_tpu_torch.models import scbert as ts
from gridnext_tpu_torch.ops import favor, favor_cuda

DIM, DEPTH, HEADS, DH, M, GENES = 32, 2, 2, 16, 24, 50


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(variables, seed=0):
    """JAX variables with every ``params`` leaf moved by numpy noise; the
    ``favor`` projections stay as drawn."""
    rng = np.random.default_rng(seed)
    out = _np_tree(variables)
    out["params"] = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        out["params"])
    return out


def _assert_rel(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"max abs err {err} vs scale {np.abs(want).max()}"


def _qkv(b=2, h=3, n=70, d=DH, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3)]


def _proj(m=M, d=DH, seed=1):
    return np.asarray(jfavor.orthogonal_gaussian_matrix(jax.random.key(seed), m, d))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# -- ops -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["relu-proj", "relu-noproj", "softmax-q", "softmax-k"])
def test_favor_features_match_jax(case):
    q, _, _ = _qkv()
    proj = _proj()
    if case == "relu-proj":
        want = jfavor.generalized_kernel_features(jnp.asarray(q), jnp.asarray(proj))
        got = favor.generalized_kernel_features(*_t(q, proj))
    elif case == "relu-noproj":
        want = jfavor.generalized_kernel_features(jnp.asarray(q), None)
        got = favor.generalized_kernel_features(torch.from_numpy(q), None)
    else:
        is_query = case == "softmax-q"
        want = jfavor.softmax_kernel_features(jnp.asarray(q), jnp.asarray(proj), is_query)
        got = favor.softmax_kernel_features(*_t(q, proj), is_query)
    _assert_rel(got, want, 1e-5)


def test_linear_attention_matches_jax():
    q, k, v = _qkv(seed=2)
    proj = _proj()
    qf, kf = (np.asarray(jfavor.generalized_kernel_features(jnp.asarray(x), jnp.asarray(proj)))
              for x in (q, k))
    want = jfavor.linear_attention(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(v))
    _assert_rel(favor.linear_attention(*_t(qf, kf, v)), want, 1e-5)


@pytest.mark.parametrize("n,m", [(512, 64), (700, 37), (1030, 266)])
def test_plain_favor_matches_jax_kernel_and_einsum(n, m):
    """The JAX function's own cases (``tests/test_favor_pallas.py``): the
    Pallas kernel runs interpreted on the CPU."""
    q, k, v = _qkv(b=2, h=3, n=n, d=16, seed=n)
    proj = _proj(m, 16)
    args = [jnp.asarray(a) for a in (q, k, v, proj)]
    got = favor_cuda.favor_attention_plain(*_t(q, k, v, proj)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fused(*args)), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_einsum_reference(*args)),
                               rtol=2e-4, atol=2e-5)
    before = favor_cuda.launches
    wrapped = favor_cuda.fused_generalized_linear_attention(*_t(q, k, v, proj))
    assert favor_cuda.launches == before          # the CPU runs the plain version
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_plain_favor_gradients_match_jax():
    q, k, v = _qkv(b=2, h=3, n=260, d=8, seed=4)
    proj = _proj(20, 8)
    gj = jax.grad(lambda q, k, v: jnp.sum(_einsum_reference(q, k, v, jnp.asarray(proj)) ** 2),
                  argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts_ = [t.requires_grad_() for t in _t(q, k, v)]
    (favor_cuda.fused_generalized_linear_attention(*ts_, torch.from_numpy(proj)) ** 2
     ).sum().backward()
    for a, b in zip(ts_, gj):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("scaling", [0, 1])
def test_orthogonal_gaussian_matrix_properties(scaling):
    m, d = 70, 16
    gen = torch.Generator().manual_seed(3)
    w = favor.orthogonal_gaussian_matrix(m, d, scaling, generator=gen)
    assert w.shape == (m, d) and w.dtype == torch.float32
    again = favor.orthogonal_gaussian_matrix(m, d, scaling,
                                             generator=torch.Generator().manual_seed(3))
    assert torch.equal(w, again)
    norms = w.double().norm(dim=1)
    unit = w.double() / norms[:, None]
    for start in range(0, m, d):                  # each block's rows are orthonormal
        blk = unit[start:start + d]
        torch.testing.assert_close(blk @ blk.T, torch.eye(len(blk), dtype=torch.float64),
                                   atol=1e-5, rtol=0)
    if scaling == 1:
        torch.testing.assert_close(norms, torch.full((m,), d ** 0.5, dtype=torch.float64))
    else:                                         # chi_d norms: mean ~ sqrt(d - 1/2)
        assert norms.std() > 0.1 and abs(norms.mean().item() - (d - 0.5) ** 0.5) < 0.5
    jw = np.asarray(jfavor.orthogonal_gaussian_matrix(jax.random.key(0), m, d, scaling))
    assert jw.shape == tuple(w.shape)
    with pytest.raises(ValueError, match="scaling"):
        favor.orthogonal_gaussian_matrix(m, d, 2)


# -- modules -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["generalized", "softmax", "no_projection"])
def test_fast_attention_matches_jax(kind):
    kw = dict(generalized_attention=kind == "generalized",
              no_projection=kind == "no_projection")
    q, k, v = _qkv(seed=5)
    jm = jp.FastAttention(dim_head=DH, nb_features=M, **kw)
    args = [jnp.asarray(a) for a in (q, k, v)]
    variables = _np_tree(jm.init(jax.random.key(0), *args))
    want = jm.apply(variables, *args)
    tm = tp.FastAttention(DH, M, **kw)
    if kind != "no_projection":
        load_performer(tm, {"favor": variables["favor"]})
    _assert_rel(tm(*_t(q, k, v)), want)


def _self_attention_input(n=40, seed=6):
    return np.random.default_rng(seed).standard_normal((2, n, DIM)).astype(np.float32)


@pytest.mark.parametrize("generalized", [True, False])
def test_self_attention_matches_jax(generalized):
    x = _self_attention_input()
    jm = jp.SelfAttention(dim=DIM, heads=HEADS, dim_head=DH, nb_features=M,
                          generalized_attention=generalized, qkv_bias=True)
    variables = _perturbed(jm.init(jax.random.key(1), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_performer(tp.SelfAttention(DIM, HEADS, DH, nb_features=M,
                                         generalized_attention=generalized,
                                         qkv_bias=True), variables)
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("glu,chunks", [(False, 1), (True, 1), (False, 3)])
def test_performer_matches_jax(glu, chunks):
    """The chunked feed-forward is held against JAX's unchunked one (the
    same row-wise function): the JAX FeedForward cannot build with
    ``chunks > 1``, as flax refuses its second ``w1`` (NameInUseError)."""
    x = _self_attention_input(seed=7)
    kw = dict(nb_features=M, generalized_attention=True, ff_glu=glu)
    jm = jp.Performer(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH, **kw)
    variables = _perturbed(jm.init(jax.random.key(2), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_performer(tp.Performer(DIM, DEPTH, HEADS, DH, ff_chunks=chunks, **kw),
                        variables)
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(x)), want)


def test_performer_lm_matches_jax():
    tokens = np.random.default_rng(8).integers(0, 7, (2, 30))
    kw = dict(num_tokens=7, max_seq_len=GENES, dim=DIM, depth=DEPTH, heads=HEADS,
              dim_head=DH, nb_features=M, generalized_attention=True)
    jm = jp.PerformerLM(**kw)
    variables = _perturbed(jm.init(jax.random.key(3), jnp.asarray(tokens)))
    want = jm.apply(variables, jnp.asarray(tokens))
    tm = load_performer(tp.PerformerLM(**kw), variables)
    assert tm.performer.attns[0].to_q.bias is None    # PerformerLM: qkv_bias=False
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(tokens)), want)
        with pytest.raises(ValueError, match="max_seq_len"):
            tm(torch.zeros((1, GENES + 1), dtype=torch.int64))


def test_attention_classifier_matches_jax():
    x = np.random.default_rng(9).standard_normal((3, GENES + 1, DIM)).astype(np.float32)
    jm = js.AttentionClassifier(seq_len=GENES + 1, out_dim=5)
    variables = _perturbed(jm.init(jax.random.key(4), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_performer(ts.AttentionClassifier(DIM, seq_len=GENES + 1, out_dim=5),
                        variables)
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(x)), want)
        with pytest.raises(ValueError, match="seq_len"):
            tm(torch.zeros((1, GENES, DIM)))


def _expression(b=3, seed=10):
    """log2(1 + x)-scale expression with exact bin edges and values above
    bin_num (clipped), as scBERT inputs look after preprocessing."""
    x = np.random.default_rng(seed).uniform(0, 7.5, (b, GENES)).astype(np.float32)
    x[:, :4] = [0.0, 1.0, 4.999, 5.0]
    return x


@pytest.mark.parametrize("generalized", [True, False])
def test_scbert_matches_jax(generalized):
    x = _expression()
    kw = dict(n_genes=GENES, dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DH,
              nb_features=M, n_classes=5, generalized_attention=generalized)
    jm = js.scBERT(**kw)
    variables = _perturbed(jm.init(jax.random.key(5), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_performer(ts.scBERT(**kw), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, 5)
    _assert_rel(got, want)


def test_scbert_without_classes_gives_token_logits():
    x = _expression(b=2)
    kw = dict(n_genes=GENES, dim=DIM, depth=1, heads=HEADS, dim_head=DH, nb_features=M,
              generalized_attention=True)
    jm = js.scBERT(**kw)
    variables = _perturbed(jm.init(jax.random.key(6), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_performer(ts.scBERT(**kw), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, GENES + 1, 7)
    _assert_rel(got, want)


def test_bridge_refuses_extra_and_missing_leaves():
    x = _expression(b=1)
    kw = dict(n_genes=GENES, dim=DIM, depth=1, heads=HEADS, dim_head=DH, nb_features=M,
              n_classes=5, generalized_attention=True)
    variables = _np_tree(js.scBERT(**kw).init(jax.random.key(7), jnp.asarray(x)))
    extra = dict(variables, favor={**variables["favor"], "stray": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="does not have"):
        load_performer(ts.scBERT(**kw), extra)
    missing = dict(variables, favor={})
    with pytest.raises(ValueError, match="no favor/performer_lm"):
        load_performer(ts.scBERT(**kw), missing)


def test_performer_option_checks():
    """Local heads beyond the head count raise as in JAX; m = d ln d."""
    with pytest.raises(ValueError, match="local_heads"):
        tp.SelfAttention(DIM, HEADS, DH, local_heads=HEADS + 1)
    with pytest.raises(ValueError, match="local_heads"):
        jp.SelfAttention(dim=DIM, heads=HEADS, dim_head=DH, local_heads=HEADS + 1).init(
            jax.random.key(0), jnp.zeros((1, 4, DIM)))
    assert tp.default_nb_features(64) == jp.default_nb_features(64) == 266


def _close(got, want, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("n", [33, 300])
def test_causal_linear_attention_matches_jax(n):
    q, k, v = _qkv(b=2, h=2, n=n, d=8, seed=n)
    proj = _proj(12, 8)
    qf, kf = (np.asarray(jfavor.generalized_kernel_features(jnp.asarray(x), jnp.asarray(proj)))
              for x in (q, k))
    want = jfavor.causal_linear_attention(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(v))
    _close(favor.causal_linear_attention(*_t(qf, kf, v)), want)


def test_implicit_attention_weights_matches_jax():
    rng = np.random.default_rng(12)
    qf, kf = (rng.uniform(0, 1, (2, 3, 20, 6)).astype(np.float32) for _ in range(2))
    qf[0, 1, 4] = 0.0                               # a row of zero scores: denom 1
    want = jfavor.implicit_attention_weights(jnp.asarray(qf), jnp.asarray(kf))
    got = favor.implicit_attention_weights(*_t(qf, kf))
    _close(got, want)
    assert float(got[0, 1, 4].abs().sum()) == 0.0


@pytest.mark.parametrize("kind", ["half", "interleaved"])
def test_rotary_conventions_match_jax(kind):
    q, k, _ = _qkv(b=1, h=2, n=23, d=8, seed=13)
    if kind == "half":
        jf, tf = (jp.sinusoidal_rotary_freqs(23, 8), tp.sinusoidal_rotary_freqs(23, 8))
        want = jp.apply_rotary_pos_emb(jnp.asarray(q), jnp.asarray(k), jf)
        got = tp.apply_rotary_pos_emb(*_t(q, k), tf)
    else:
        jf, tf = (jp.interleaved_rotary_angles(23, 8), tp.interleaved_rotary_angles(23, 8))
        want = jp.apply_rotary_interleaved(jnp.asarray(q), jnp.asarray(k), jf)
        got = tp.apply_rotary_interleaved(*_t(q, k), tf)
    _close(tf, jf, atol=1e-6)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("causal,masked,rel_pos", [(False, False, True), (True, False, True),
                                                   (False, True, False), (True, True, True)])
def test_local_block_attention_matches_jax_and_oracle(causal, masked, rel_pos):
    from gridnext_tpu.compat.local_attention_ref import local_attention_ref

    q, k, v = _qkv(b=2, h=2, n=37, d=8, seed=14)
    mask = None
    if masked:
        mask = np.random.default_rng(15).random((2, 37)) > 0.3
        mask[0, :9] = False              # with causal: rows whose keys are all masked
        mask[1, 20:30] = False
    args = dict(window=8, causal=causal, rel_pos=rel_pos)
    want = jp.local_block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    mask=None if mask is None else jnp.asarray(mask), **args)
    got = tp.local_block_attention(*_t(q, k, v), mask=None if mask is None
                                   else torch.from_numpy(mask), **args)
    _close(got, want)
    _close(got, local_attention_ref(q, k, v, mask=mask, **args))
    if masked and causal:
        assert float(got[0, :, :9].abs().max()) == 0.0     # all-masked rows give zeros


def test_self_attention_local_and_rotary_heads_match_jax():
    x = _self_attention_input(n=37, seed=16)
    mask = np.ones((2, 37), bool)
    mask[1, 30:] = False
    kw = dict(local_window_size=8, nb_features=M, generalized_attention=True, qkv_bias=True)
    jm = jp.SelfAttention(dim=DIM, heads=4, dim_head=8, local_heads=2, rotary=True, **kw)
    variables = _perturbed(jm.init(jax.random.key(8), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask))
    tm = load_performer(tp.SelfAttention(DIM, 4, 8, local_heads=2, rotary=True, **kw),
                        variables)
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(x), mask=torch.from_numpy(mask)), want)
    local_only = tp.SelfAttention(DIM, 2, 8, local_heads=2)
    assert local_only.fast_attention is None


@pytest.mark.parametrize("kind", ["causal", "scalenorm", "rezero", "causal_noproj"])
def test_performer_variants_match_jax(kind):
    x = _self_attention_input(n=40, seed=17)
    kw = dict(nb_features=M, generalized_attention=kind != "causal_noproj",
              causal=kind.startswith("causal"), no_projection=kind == "causal_noproj",
              use_scalenorm=kind == "scalenorm", use_rezero=kind == "rezero")
    jm = jp.Performer(dim=DIM, depth=1, heads=HEADS, dim_head=DH, **kw)
    variables = _perturbed(jm.init(jax.random.key(9), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = load_performer(tp.Performer(DIM, 1, HEADS, DH, **kw), variables)
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("kind", ["absolute", "gene2vec", "tied"])
def test_performer_lm_embeddings_match_jax(kind):
    tokens = np.random.default_rng(18).integers(0, 7, (2, 30))
    g2v = np.random.default_rng(19).standard_normal((GENES - 1, DIM)).astype(np.float32)
    kw = dict(num_tokens=7, max_seq_len=GENES, dim=DIM, depth=1, heads=HEADS, dim_head=DH,
              nb_features=M, generalized_attention=True, tie_embed=kind == "tied",
              pos_emb_kind={"tied": "none"}.get(kind, kind),
              g2v_weights=g2v if kind == "gene2vec" else None)
    jm = jp.PerformerLM(**kw)
    variables = _perturbed(jm.init(jax.random.key(10), jnp.asarray(tokens)))
    want = jm.apply(variables, jnp.asarray(tokens))
    tm = load_performer(tp.PerformerLM(**kw), variables)
    assert (tm.to_out is None) == (kind == "tied")
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(tokens)), want)
        if kind == "absolute":
            enc = jm.apply(variables, jnp.asarray(tokens), return_encodings=True)
            _assert_rel(tm(torch.from_numpy(tokens), return_encodings=True), enc)


def test_sow_attention_matches_jax():
    x = _expression(b=2)
    kw = dict(n_genes=GENES, dim=DIM, depth=1, heads=HEADS, dim_head=DH, nb_features=M,
              n_classes=3, generalized_attention=True, sow_attention=True)
    jm = js.scBERT(**kw)
    variables = _perturbed({k: v for k, v in jm.init(jax.random.key(11), jnp.asarray(x)).items()
                            if k != "intermediates"})
    want, inter = jm.apply(variables, jnp.asarray(x), mutable=["intermediates"])
    tm = load_performer(ts.scBERT(**kw), variables)
    with torch.no_grad():
        _assert_rel(tm(torch.from_numpy(x)), want)
    perf = inter["intermediates"]["performer_lm"]["performer"]
    for i, attn in enumerate(tm.performer_lm.performer.attns):
        jmap = perf[f"layers_{i}_attn"]["fast_attention"]["attention"][0]
        assert attn.fast_attention.attention.shape == (2, GENES + 1, GENES + 1)
        _close(attn.fast_attention.attention, jmap)


def test_remat_gives_the_plain_gradients():
    """Under ``remat`` the backward reruns each block; the dropout masks
    are drawn again from the rewound generator, so the gradients equal the
    plain forward's."""
    from gridnext_tpu_torch.models.layers import set_dropout_generator

    tokens = torch.from_numpy(np.random.default_rng(20).integers(0, 7, (2, 30)))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        lm = tp.PerformerLM(num_tokens=7, max_seq_len=GENES, dim=DIM, depth=DEPTH,
                            heads=HEADS, dim_head=DH, nb_features=M, remat=remat,
                            generalized_attention=True, ff_dropout=0.2, attn_dropout=0.2)
        set_dropout_generator(lm, torch.Generator().manual_seed(5))
        lm.train()(tokens).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in lm.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7)


def test_redraw_projections_distribution():
    lm = tp.Performer(DIM, 3, HEADS, DH, nb_features=40, generalized_attention=True)
    before = [fa.projection.clone() for fa in tp.fast_attentions(lm)]
    assert tp.redraw_projections(lm, torch.Generator().manual_seed(4)) == 3
    after = [fa.projection for fa in tp.fast_attentions(lm)]
    for a, b in zip(before, after):
        assert b.shape == (40, DH) and not torch.equal(a, b)
    for i in range(3):
        for j in range(i):
            assert not torch.allclose(after[i], after[j])          # each layer its own
    for w in after:
        w = w.double()
        norms = w.norm(dim=1)
        unit = w / norms[:, None]
        for start in range(0, 40, DH):
            blk = unit[start:start + DH]
            torch.testing.assert_close(blk @ blk.T, torch.eye(len(blk), dtype=torch.float64),
                                       atol=1e-5, rtol=0)
        assert norms.std() > 0.1 and abs(norms.mean().item() - (DH - 0.5) ** 0.5) < 0.8
    for fa in tp.fast_attentions(lm):
        fa.ortho_scaling = 1                    # as built with ortho_scaling=1
    tp.redraw_projections(lm, torch.Generator().manual_seed(4))
    for fa in tp.fast_attentions(lm):
        torch.testing.assert_close(fa.projection.double().norm(dim=1),
                                   torch.full((40,), DH ** 0.5, dtype=torch.float64))


# -- count preprocessing -----------------------------------------------------------


@pytest.mark.parametrize("sparse,filters", [(False, {}), (True, {}),
                                            (False, {"min_genes": 3, "min_depth": 5.0})])
def test_preprocess_scbert_matches_jax(sparse, filters):
    rng = np.random.default_rng(11)
    counts = rng.poisson(0.7, (12, 30)).astype(np.float32)
    counts[3] = 0                                   # an empty spot: depth 0 kept at 0
    names = [f"G{i}" for i in range(25)] + ["G3", "X1", "X2", "G7", "Y"]
    target = [f"G{i}" for i in range(0, 40, 2)] + ["X2"]
    x = sp.csr_matrix(counts) if sparse else counts
    got, keep = ts.preprocess_scbert(x, names, target_genes=target, **filters)
    want, jkeep = js.preprocess_scbert(x, names, target_genes=target, **filters)
    np.testing.assert_array_equal(keep, jkeep)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_gene2vec_vocabulary_is_the_jax_assets():
    from importlib import resources

    jax_csv = resources.files("gridnext_tpu.assets") / "gene2vec_names.csv"
    with open(ts.GENE2VEC_NAMES, "rb") as fh:
        assert fh.read() == jax_csv.read_bytes()
    names = ts.load_gene2vec_names()
    assert names == js.load_gene2vec_names() and len(names) == ts.SCBERT_N_GENES == 16906
