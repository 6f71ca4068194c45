"""Sequence-parallel MLM (the ``seq`` mesh axis) against one process and the
JAX package, on the CPU.

The ranks run as gloo subprocesses, each with a timeout of its own, started
by an autouse module fixture so that they run while the single-process
tests do:

- the split plain FAVOR (``favor_accumulate_plain`` then
  ``favor_apply_plain``, and the custom ops ``gridnext::favor_accumulate``
  / ``gridnext::favor_apply``) against ``favor_attention_plain`` within
  1e-6, forward and VJP;
- ``train_mlm`` of a small PerformerLM through FAVOR (dropout, a redraw
  after each step, a padded last batch, a 15-token corpus padded to 16) on
  2 ranks ``{'data': 1, 'seq': 2}`` against one process on the padded
  corpus: the sharded forward within FAVOR's tolerance (rtol 2e-4, atol
  2e-5), the losses within 1e-5 relative, the step-1 gradients within 1e-3
  of each tensor's largest, the ranks' weights equal and the projections
  one process's;
- ``mlm_token_len``, the -1 padding and ``shard_token_batch``'s warning
  against JAX's, for 16,907 and 1,025 tokens over ``seq`` 2, 3 and 4;
- a small scBERT's forward (1,024 genes, the zero token on the last
  rank, the ``AttentionClassifier`` head's fc1 summed over the group)
  under ``seq`` 2 against JAX's ``model.apply``, with ReLU features and
  with JAX's default softmax features;
- each token-mixing operation (``VARIANTS``: softmax features, with
  remat, the causal scan with rotary, a local head whose block straddles
  the ranks with attention dropout, ``no_projection``, causal
  ``no_projection``, ``sow_attention``) on 2 ranks against one process:
  the eval forward, one train step's gradients, the sow rows, the
  collectives a layer;
- causal ``no_projection`` on 2 ranks of ``data`` against one process
  (its key maximum spans the global batch);
- the ``ValueError`` of a token batch that is not the shard's columns.
"""

import faulthandler
import json
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gridnext_tpu.parallel import make_mesh as jax_make_mesh
from gridnext_tpu.parallel import mesh as jax_mesh
from gridnext_tpu.train import loops as jax_loops
from gridnext_tpu_torch.ops import favor_cuda
from gridnext_tpu_torch.parallel import collectives, mesh
from gridnext_tpu_torch.parallel.mesh import Mesh
from gridnext_tpu_torch.train import loops as tl

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 150            # seconds a rank subprocess may take
GROUP_TIMEOUT = 60       # seconds a worker's collective waits for the other rank
MODULE_TIMEOUT = 300     # seconds the whole module may take
FAVOR_RTOL, FAVOR_ATOL = 2e-4, 2e-5
N_GENES = 1024           # the scBERT forward's genes (1,025 tokens with the zero token)
# the token-mixing operations of a PerformerLM (dim 16, depth 2, 2 heads of 8, m 12) over
# 16 tokens split at 8: with the local window 5, block [5, 10) straddles the ranks
VARIANTS = {
    "softmax": {},
    "softmax_remat": {"remat": True},
    "causal_rotary": {"causal": True, "rotary": True, "generalized_attention": True},
    "local_dropout": {"local_attn_heads": 1, "local_window_size": 5, "attn_dropout": 0.1,
                      "generalized_attention": True},
    "no_projection": {"no_projection": True},
    "causal_no_projection": {"causal": True, "no_projection": True},
    "sow": {"sow_attention": True, "generalized_attention": True},
}
# (favor_seq, token_mix) collectives of one eval forward on a rank: a layer each of
# FAVOR's (ctx, ksum) sum and the key maximum / lower totals / local keys and values /
# softmax maximum and sum / key features
VARIANT_COUNTS = {"softmax": (2, 2), "softmax_remat": (2, 2), "causal_rotary": (0, 2),
                  "local_dropout": (2, 2), "no_projection": (2, 4),
                  "causal_no_projection": (0, 4), "sow": (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def module_timeout():
    """End this test process, every thread's traceback dumped, if the
    module outlives MODULE_TIMEOUT."""
    faulthandler.dump_traceback_later(MODULE_TIMEOUT, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = r'''
import json, sys
import numpy as np, torch
from gridnext_tpu_torch.compat.from_jax import load_checkpoint, load_variables
import torch.distributed as dist
from gridnext_tpu_torch.models import PerformerLM, scBERT
from gridnext_tpu_torch.models.layers import set_dropout_generator
from gridnext_tpu_torch.models.performer import FastAttention, shard_sequence
from gridnext_tpu_torch.parallel import collectives, initialize_multihost, shard_token_batch
from gridnext_tpu_torch.parallel.mesh import token_columns
from gridnext_tpu_torch.train import loops as tl
coord, world, rank, timeout, ckpt, n_genes, ckpt_softmax = sys.argv[1:8]
world, rank, n_genes = int(world), int(rank), int(n_genes)
torch.manual_seed(0)
if world:
    initialize_multihost(coord, world, rank, device="cpu", timeout=float(timeout))
    mesh = tl._resolve_mesh(None, {"data": 1, "seq": world})
out = {}
rng = np.random.default_rng(1)
tokens = rng.integers(0, 6, size=(14, 15)).astype(np.uint8)     # unsigned: widened to pad
padded = np.concatenate([tokens.astype(np.int32), np.full((14, 1), -1, np.int32)], axis=1)

def lm_model():
    return PerformerLM(num_tokens=7, max_seq_len=16, dim=16, depth=2, heads=2, dim_head=8,
                       nb_features=12, generalized_attention=True, emb_dropout=0.1,
                       ff_dropout=0.1)

# the forward of a fresh LM on the padded corpus (eval mode)
lm = lm_model()
lm.load_state_dict(torch.load(ckpt + ".lm.pt"))
lm.eval()
x = torch.as_tensor(padded[:4].clip(0), dtype=torch.int64)
with torch.no_grad():
    if world:
        cols = token_columns(16, mesh)
        shard_sequence(lm, collectives.TokenShard(mesh.group("seq"), cols.start, cols.stop, 16))
        logits = lm(x[:, cols])
        shard_sequence(lm, None)
    else:
        logits = lm(x)
out["forward"] = logits.numpy().tolist()
# three train_mlm steps, each followed by a projection redraw
st = tl.create_train_state(lm, tl.make_adam(1e-3), device="cpu")
steps = []
apply = st.optimizer.step
def capture():
    steps.append({n: p.grad.detach().numpy().ravel().tolist()
                  for n, p in lm.named_parameters() if p.grad is not None})
    apply()
st.optimizer.step = capture
collectives.reset_counts()
_, val, train = tl.train_mlm(lm, {"train": tokens[:10] if world else padded[:10],
                                  "val": tokens[10:] if world else padded[10:]},
                             mask_id=6, num_epochs=1, batch_size=4, state=st, redraw_every=1,
                             verbose=False, device="cpu",
                             mesh_shape={"data": 1, "seq": world} if world else None)
out["mlm"] = {"train": train, "val": val, "grads": steps, "seq_sums": collectives.COUNTS["favor_seq"],
              "shard_after": lm.performer.attns[0].fast_attention.seq_shard is None,
              "after": {k: v.detach().numpy().ravel().tolist()
                        for k, v in lm.state_dict().items()}}
# a small scBERT forward (JAX's weights) over its gene axis: ReLU and softmax features
for key, path, relu in (("scbert", ckpt, True), ("scbert_softmax", ckpt_softmax, False)):
    sc = scBERT(n_genes=n_genes, dim=32, depth=2, heads=4, n_classes=4,
                generalized_attention=relu)
    payload = load_checkpoint(path)
    load_variables(sc, {"params": payload["params"], **payload["extra_vars"]})
    sc.eval()
    xs = np.random.default_rng(0).integers(0, 6, size=(2, n_genes)).astype(np.float32)
    with torch.no_grad():
        if world:
            cols = token_columns(n_genes, mesh)
            shard_sequence(sc, collectives.TokenShard(mesh.group("seq"), cols.start,
                                                      cols.stop, n_genes))
            local = shard_token_batch(xs, mesh)
            out[key] = sc(torch.as_tensor(local)).numpy().tolist()
        else:
            out[key] = sc(torch.as_tensor(xs)).numpy().tolist()
# every token-mixing operation: an eval forward and one train step's gradients
x16 = torch.as_tensor(np.random.default_rng(5).integers(0, 6, size=(4, 16)))
w16 = torch.as_tensor(np.random.default_rng(4).standard_normal((4, 16, 7)), dtype=torch.float32)
vshard, cols = None, slice(0, 16)
if world:
    cols = token_columns(16, mesh)
    vshard = collectives.TokenShard(mesh.group("seq"), cols.start, cols.stop, 16)
out["variants"] = {}
for name, kw in json.loads(sys.argv[8]).items():
    torch.manual_seed(10)
    lm = PerformerLM(num_tokens=7, max_seq_len=16, dim=16, depth=2, heads=2, dim_head=8,
                     nb_features=12, **kw)
    res = {}
    shard_sequence(lm, vshard)
    collectives.reset_counts()
    lm.eval()
    with torch.no_grad():
        res["forward"] = lm(x16[:, cols]).numpy().tolist()
    res["counts"] = {k: collectives.COUNTS[k] for k in ("favor_seq", "token_mix")}
    if kw.get("sow_attention"):
        res["sow"] = [a.fast_attention.attention.numpy().tolist() for a in lm.performer.attns]
    lm.train()
    set_dropout_generator(lm, torch.Generator().manual_seed(7))
    with collectives.sharded(tokens=vshard):
        (lm(x16[:, cols]) * w16[:, cols]).sum().backward()
    if world:
        collectives.all_reduce_grads(list(lm.parameters()), mesh.group("seq"))
    res["grads"] = {n: p.grad.numpy().ravel().tolist() for n, p in lm.named_parameters()}
    shard_sequence(lm, None)
    out["variants"][name] = res
# causal no_projection's key maximum over the global batch on a 'data' axis (one
# rank's rows shifted by +30)
rng = np.random.default_rng(6)
q, k, v, g = (torch.as_tensor(rng.standard_normal((4, 2, 16, 8)), dtype=torch.float32)
              for _ in range(4))
k[2:] += 30
rows = slice(2 * rank, 2 * rank + 2) if world else slice(0, 4)
q, k, v = (t[rows].clone().requires_grad_() for t in (q, k, v))
fa = FastAttention(8, causal=True, no_projection=True)
with collectives.sharded(dist.group.WORLD if world else None,
                         rows=collectives.RowShard(rows.start, rows.stop, 4)):
    o = fa(q, k, v)
    (o * g[rows]).sum().backward()
out["data_causal_np"] = {"out": o.detach().numpy().tolist(),
                         "grads": [t.grad.numpy().tolist() for t in (q, k, v)]}
print(json.dumps(out))
'''


class _Ranks:
    def __init__(self, procs):
        self.procs, self.outs = procs, None

    def result(self):
        if self.outs is None:
            outs = []
            try:
                for p in self.procs:
                    out, err = p.communicate(timeout=TIMEOUT)
                    assert p.returncode == 0, err[-3000:]
                    outs.append(json.loads(out))
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
            self.outs = outs
        return self.outs


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """JAX's scBERT variables written for the workers, then one process and
    2 ranks started together."""
    from flax.core import unfreeze

    from gridnext_tpu.models import scBERT as JaxScBERT
    from gridnext_tpu_torch.compat.from_jax import save_checkpoint
    from gridnext_tpu_torch.models import PerformerLM

    root = tmp_path_factory.mktemp("seq")
    x = np.random.default_rng(0).integers(0, 6, size=(2, N_GENES)).astype(np.float32)
    ckpts, applied = {}, {}
    for relu in (True, False):          # ReLU features, then JAX's default (softmax)
        model = JaxScBERT(n_genes=N_GENES, dim=32, depth=2, heads=4, n_classes=4,
                          generalized_attention=relu)
        variables = model.init({"params": jax.random.key(0), "favor": jax.random.key(1)},
                               jnp.asarray(x[:1]))
        ckpts[relu] = str(root / f"scbert_{'relu' if relu else 'softmax'}.msgpack")
        save_checkpoint(ckpts[relu], jax.tree_util.tree_map(np.asarray, unfreeze(variables)))
        applied[relu] = (model, variables)
    ckpt = ckpts[True]
    torch.manual_seed(3)
    lm = PerformerLM(num_tokens=7, max_seq_len=16, dim=16, depth=2, heads=2, dim_head=8,
                     nb_features=12, generalized_attention=True, emb_dropout=0.1,
                     ff_dropout=0.1)
    torch.save(lm.state_dict(), ckpt + ".lm.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, coord, str(w), str(r),
                               str(GROUP_TIMEOUT), ckpt, str(N_GENES), ckpts[False],
                               json.dumps(VARIANTS)], cwd=str(root), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for w, r in ((0, 0), (2, 0), (2, 1))]
    runs = _Ranks(procs)
    runs.jax_scbert, runs.jax_scbert_softmax = (
        np.asarray(m.apply(v, jnp.asarray(x), train=False))
        for m, v in (applied[True], applied[False]))
    yield runs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


# -- one process -------------------------------------------------------------------


def test_split_plain_favor_matches_fused_plain():
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((2, 3, 37, 8)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    proj = torch.tensor(rng.standard_normal((12, 8)), dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 3, 37, 8)), dtype=torch.float32)
    want = favor_cuda.favor_attention_plain(q, k, v, proj)
    want_grads = torch.autograd.grad(want, (q, k, v, proj), g)
    for split in (lambda: favor_cuda.favor_apply_plain(
                      q, proj, *favor_cuda.favor_accumulate_plain(k, v, proj)),
                  lambda: favor_cuda.favor_apply_op(
                      q, proj, *favor_cuda.favor_accumulate_op(k, v, proj))):
        n = favor_cuda.accumulate_launches, favor_cuda.apply_launches, favor_cuda.launches
        got = split()
        assert (favor_cuda.accumulate_launches, favor_cuda.apply_launches,
                favor_cuda.launches) == n           # CPU tensors take the plain version
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        for a, b in zip(torch.autograd.grad(got, (q, k, v, proj), g), want_grads):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    ctx, ksum = favor_cuda.favor_accumulate_op(k, v, proj)
    assert ctx.shape == (2, 3, 12, 8) and ksum.shape == (2, 3, 12)


@pytest.mark.parametrize("n_tokens", [16907, 1025])
@pytest.mark.parametrize("seq", [2, 3, 4])
def test_token_len_padding_and_warning_match_jax(n_tokens, seq):
    assert tl.mlm_token_len(n_tokens, mesh_shape={"data": 1, "seq": seq}) == \
        jax_loops.mlm_token_len(n_tokens, mesh_shape={"data": 1, "seq": seq})
    assert tl.mlm_token_len(n_tokens, {"data": 2}) == n_tokens
    # the padded corpus: JAX's as_pair pads what train_mlm trains
    corpus = np.random.default_rng(seq).integers(0, 6, size=(3, n_tokens)).astype(np.uint16)
    seen = {}

    def jax_run(model, state, tx, pairs, *a, **k):
        seen["jax"] = pairs["train"][1]

    def port_run(state, pairs, *a, **k):
        seen["port"] = pairs["train"][1]

    jm = jax_make_mesh({"data": 1, "seq": seq}, jax.devices()[:seq])
    pm = Mesh({"data": 1, "seq": seq}, devices=["cpu"] * seq)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loops, "_run_training", jax_run)
        mp.setattr(tl, "_run_training", port_run)
        jax_loops.train_mlm(None, {"train": corpus}, mask_id=6, mesh=jm, state=object(),
                            tx=object())
        tl.train_mlm(None, {"train": corpus}, mask_id=6, device="cpu", mesh=pm,
                     state=SimpleNamespace(model=torch.nn.Linear(1, 1)))
    assert seen["port"].dtype == seen["jax"].dtype
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert seen["port"].shape[1] == tl.mlm_token_len(n_tokens, {"seq": seq})
    # shard_token_batch: the warning of an indivisible token axis, word for word
    x = np.zeros((2, n_tokens), np.int16)
    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        local = mesh.shard_token_batch(x, pm)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        jax_mesh.shard_token_batch(jnp.asarray(x), jm)
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    assert local.shape == ((2, n_tokens) if n_tokens % seq else (2, n_tokens // seq))


def test_shard_token_batch_columns_and_rows():
    pm = Mesh({"data": 2, "seq": 2}, devices=["cpu"] * 4, rank=3)
    x = np.arange(4 * 6).reshape(4, 6)
    np.testing.assert_array_equal(mesh.shard_token_batch({"y": x}, pm)["y"], x[2:, 3:])
    assert mesh.token_columns(6, pm) == slice(3, 6)
    assert mesh.token_columns(6, Mesh({"data": 2}, devices=["cpu"] * 2)) is None
    # the MLM batch shards its rows over 'data' only, the tokens apart
    assert list(tl._mesh_placement(pm, "mlm", 4)(np.arange(4))) == [2, 3]
    with pytest.raises(ValueError, match="sharding factor 2"):
        tl._mesh_placement(pm, "mlm", 3)
    assert list(tl._mesh_placement(pm, "spot", 4)(np.arange(4))) == [3]


def test_draw_rows_takes_the_token_columns():
    gen = lambda: torch.Generator().manual_seed(3)       # noqa: E731
    full = torch.rand((6, 8, 5), generator=gen())
    with collectives.sharded(rows=collectives.RowShard(2, 4, 6),
                             tokens=collectives.TokenShard(None, 4, 8, 8)):
        part = collectives.draw_rows(lambda s: torch.rand(s, generator=gen()), (2, 4, 5),
                                     token_dim=1)
        rows_only = collectives.draw_rows(lambda s: torch.rand(s, generator=gen()),
                                          (2, 4, 5))
    assert torch.equal(part, full[2:4, 4:8])
    assert torch.equal(rows_only, torch.rand((6, 4, 5), generator=gen())[2:4])


def test_unsharded_operations_raise():
    """Every token-mixing operation runs under a shard (the two-rank tests
    below); what still raises is a token batch that is not the shard's."""
    from gridnext_tpu_torch.models.performer import PerformerLM, shard_sequence

    shard = collectives.TokenShard(None, 0, 4, 8)
    lm = PerformerLM(num_tokens=7, max_seq_len=8, dim=16, depth=1, heads=2, dim_head=8,
                     generalized_attention=True)
    shard_sequence(lm, shard)
    with pytest.raises(ValueError, match=r"holds columns \[0, 4\)"):
        lm(torch.zeros((1, 3), dtype=torch.int64))


# -- two ranks -----------------------------------------------------------------------


def test_seq_forward_matches_one_process(ranks):
    one, r0, r1 = ranks.result()
    want = np.asarray(one["forward"])
    got = np.concatenate([np.asarray(r0["forward"]), np.asarray(r1["forward"])], axis=1)
    np.testing.assert_allclose(got, want, rtol=FAVOR_RTOL, atol=FAVOR_ATOL)


def test_seq_train_mlm_matches_one_process(ranks):
    """``train_mlm`` on ``{'data': 1, 'seq': 2}``: each rank its token
    columns of every row, the MLM and dropout masks its columns of the
    global batch's, FAVOR's sums over the group, the gradients over the
    world."""
    one, r0, r1 = (r["mlm"] for r in ranks.result())
    assert r1["train"] == r0["train"] and r1["val"] == r0["val"]
    np.testing.assert_allclose(r0["train"], one["train"], rtol=1e-5)
    np.testing.assert_allclose(r0["val"], one["val"], rtol=1e-5)
    assert len(r0["grads"]) == len(one["grads"]) == 3
    for k, g in one["grads"][0].items():
        g = np.asarray(g)
        np.testing.assert_allclose(r0["grads"][0][k], g, rtol=0,
                                   atol=1e-3 * np.abs(g).max(), err_msg=k)
    for k in one["after"]:
        assert r1["after"][k] == r0["after"][k], k            # replicas equal
        if k.endswith("fast_attention.projection"):
            assert r0["after"][k] == one["after"][k], k       # the same 3 redraws
    # one (ctx, ksum) sum a layer a forward, over 3 train and 1 val batches
    assert r0["seq_sums"] == 2 * (3 + 1) and one["seq_sums"] == 0
    assert r0["shard_after"] and one["shard_after"]


def test_seq_scbert_forward_matches_jax(ranks):
    one, r0, r1 = ranks.result()
    want = ranks.jax_scbert
    assert r0["scbert"] == r1["scbert"]
    np.testing.assert_allclose(np.asarray(r0["scbert"]), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(one["scbert"]), want, rtol=1e-4, atol=1e-5)


def test_seq_scbert_softmax_features_match_jax(ranks):
    """JAX's scBERT default (softmax features: the key maximum gathered over
    the group) under ``seq`` 2, as JAX's own
    ``test_scbert_sequence_parallel_matches_single_device`` runs it."""
    one, r0, r1 = ranks.result()
    want = ranks.jax_scbert_softmax
    assert r0["scbert_softmax"] == r1["scbert_softmax"]
    np.testing.assert_allclose(np.asarray(r0["scbert_softmax"]), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(one["scbert_softmax"]), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_seq_token_mixing_matches_one_process(ranks, variant):
    """Each token-mixing operation on 2 ranks of ``seq`` against one process:
    the eval forward within FAVOR's tolerance, one train step's gradients
    (dropout drawn as one process draws it) within 1e-3 of each tensor's
    largest, the sow maps' rows joined, and the collectives a layer."""
    one, r0, r1 = (r["variants"][variant] for r in ranks.result())
    got = np.concatenate([np.asarray(r0["forward"]), np.asarray(r1["forward"])], axis=1)
    np.testing.assert_allclose(got, np.asarray(one["forward"]), rtol=FAVOR_RTOL,
                               atol=FAVOR_ATOL)
    for k, g in one["grads"].items():
        g = np.asarray(g)
        assert r0["grads"][k] == r1["grads"][k], k
        np.testing.assert_allclose(r0["grads"][k], g, rtol=0, atol=1e-3 * np.abs(g).max(),
                                   err_msg=k)
    if "sow" in one:
        for a, b, want in zip(r0["sow"], r1["sow"], one["sow"]):
            np.testing.assert_allclose(np.concatenate([a, b], axis=1), want,
                                       rtol=FAVOR_RTOL, atol=FAVOR_ATOL)
    for r in (r0, r1):
        assert (r["counts"]["favor_seq"], r["counts"]["token_mix"]) == VARIANT_COUNTS[variant]
    assert one["counts"] == {"favor_seq": 0, "token_mix": 0}


def test_data_axis_causal_no_projection_matches_one_process(ranks):
    """Causal ``no_projection`` subtracts ``jnp.max(k)`` of the global
    tensor: on 2 ranks of ``data`` (one rank's keys 30 higher) the maximum
    spans both ranks' rows, so each rank's rows equal one process's."""
    one, r0, r1 = (r["data_causal_np"] for r in ranks.result())
    got = np.concatenate([np.asarray(r0["out"]), np.asarray(r1["out"])], axis=0)
    np.testing.assert_allclose(got, np.asarray(one["out"]), rtol=FAVOR_RTOL, atol=FAVOR_ATOL)
    for a, b, want in zip(r0["grads"], r1["grads"], one["grads"]):
        want = np.asarray(want)
        np.testing.assert_allclose(np.concatenate([a, b], axis=0), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())
