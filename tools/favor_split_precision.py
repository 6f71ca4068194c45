#!/usr/bin/env python3
"""How the FAVOR kernel's error depends on the length of its sums.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/favor_split_precision.py

The kernel's accumulate pass splits each (b, h) sequence into ranges and
sums a range's ctx and ksum in one float32 chain. This script takes the
attention inputs where that matters: the first layer's q, k, v of
``chip_smoke.py`` phase 17 (c)'s scBERT teacher (phase 9's seeded weights
cut to depth 2, 16,907 tokens) on 64 spots of Poisson counts, the batch of
that phase's ``distill``. On the 8 sequences where the former split rule
(fill the card, nothing more) departs most from the float32 plain version,
it holds the kernel's output at several split counts against the float64
attention, as multiples of FAVOR's tolerance (rtol 2e-4, atol 2e-5), and
times each at B 64 and B 8 with CUDA events; beside them the float32
plain version and the kernel's operand rounding alone (its split-TF32
operands with float64 sums). Prints one line a split count and one JSON
line, beside the card's name and power limit.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def event_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def operands_only(torch, q, k, v, proj):
    """The kernel's four products with its split-TF32 operands (hi = x with
    the low 13 mantissa bits cleared, lo = x - hi read as TF32 the same way,
    lo hi + hi lo + hi hi) summed in float64: its operand rounding without
    its float32 sums."""
    def tf32(x):
        return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)

    def product(a, b):
        a, b = a.float(), b.float()
        a_hi, b_hi = tf32(a), tf32(b)
        a_lo, b_lo = (tf32(x - x_hi).double() for x, x_hi in ((a, a_hi), (b, b_hi)))
        a_hi, b_hi = a_hi.double(), b_hi.double()
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    def features(x):
        return torch.relu(product(x.shape[-1] ** -0.25 * x, proj.T)).float() + 1e-3

    qf, kf = features(q), features(k)
    ctx = product(kf.transpose(-1, -2), v).float()
    return product(qf, ctx) / (qf.double() @ kf.double().sum(-2)[..., None])


def teacher_qkv(torch, cs, dev):
    """The teacher's first FAVOR call on 64 spots: (q, k, v, proj)."""
    from gridnext_tpu_torch import modeldir, models
    from gridnext_tpu_torch.compat import from_jax
    from gridnext_tpu_torch.models import performer
    from gridnext_tpu_torch.models.scbert import load_gene2vec_names

    template = models.GridNetHexMM(
        models.densenet121(num_classes=cs.N_CLASSES),
        models.scBERT(n_genes=cs.MM_VOCAB, dim=cs.MM_DIM, depth=cs.MM_DEPTH,
                      heads=cs.MM_HEADS, dim_head=cs.MM_DIM_HEAD, n_classes=cs.N_CLASSES,
                      generalized_attention=True), cs.N_CLASSES)
    variables = cs.random_variables(models, from_jax, seed=cs.SEED + 6, model=template)
    classes = [f"Class_{i + 1}" for i in range(cs.N_CLASSES)]
    meta = {"model": "GridNetHexMM", "classes": classes, "patch_px": cs.PATCH,
            "window_px": None, "patch_chunk": cs.CHUNK, "count_chunk": cs.COUNT_CHUNK,
            "log1p": False, "count_f": "scbert", "scbert_vocab": cs.MM_VOCAB,
            "scbert_dim": cs.MM_DIM, "scbert_depth": cs.MM_STEP_DEPTH,
            "scbert_heads": cs.MM_HEADS, "scbert_dim_head": cs.MM_DIM_HEAD,
            "scbert_features": None, "hd_binning": None, "grid_dims": None,
            "image_f": "densenet", "dense_ingest": False}
    model = modeldir.mm_model_from_meta(
        meta, classes, cs.scbert_depth_cut(variables, cs.MM_STEP_DEPTH), device=dev)
    genes = load_gene2vec_names()[:cs.MM_VOCAB]
    raw = np.random.default_rng(cs.SEED + 7).poisson(
        cs.COUNT_RATE, (cs.MM_DISTILL_BATCH, len(genes))).astype(np.float32)
    x = torch.as_tensor(modeldir.scbert_transform(genes, cs.MM_VOCAB)(raw), device=dev)
    kernel, first = performer.fused_generalized_linear_attention, []

    def first_call(q, k, v, proj):
        if not first:
            first.append((q, k, v, proj))
        return kernel(q, k, v, proj)

    performer.fused_generalized_linear_attention = first_call
    try:
        with torch.no_grad():
            model.count_classifier.eval()(x)
    finally:
        performer.fused_generalized_linear_attention = kernel
    return first[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("favor_split_precision: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gridnext_tpu_torch.ops import _cuda, favor_cuda

    _cuda.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    q, k, v, proj = teacher_qkv(torch, cs, dev)
    b, h, n, d = q.shape
    m = proj.shape[0]
    tiles = -(-n // favor_cuda._ROWS)
    rule = favor_cuda._splits

    def fill_only(bh, n, m, d, device):
        """The former rule: enough blocks to fill the card, at most one a
        tile, with no cap on a split's length (d in HEAD_DIMS)."""
        groups = -(-(-(-m // favor_cuda._FEAT_TILE)) // favor_cuda._ACC_WARPS_MAX)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return max(1, min(-(-n // favor_cuda._ROWS),
                          -(-favor_cuda._BLOCKS_PER_SM * sms // (groups * bh))))

    def run(splits):
        favor_cuda._splits = splits
        try:
            return favor_cuda.fused_generalized_linear_attention(q, k, v, proj)
        finally:
            favor_cuda._splits = rule

    with torch.no_grad():
        plain = favor_cuda.favor_attention_plain(q, k, v, proj)
        gap = (run(fill_only) - plain).abs() / (cs.FAVOR_ATOL + cs.FAVOR_RTOL * plain.abs())
        seqs = gap.flatten(1).amax(1).topk(8).indices
        exact = cs.favor_float64(q[seqs], k[seqs], v[seqs], proj)
        tol = cs.FAVOR_ATOL + cs.FAVOR_RTOL * exact.abs()
        plain_x = float(((plain[seqs].double() - exact).abs() / tol).max().item())
        operand_x = float(((operands_only(torch, q[seqs], k[seqs], v[seqs], proj) - exact)
                           .abs() / tol).max().item())
        del plain, gap
        rows = []
        q8, k8, v8 = q[:8], k[:8], v[:8]
        cases = [("former rule", fill_only), ("current rule", rule)]
        cases += [(str(s), lambda *a, s=s: s) for s in (4, 9, 17, 33, 67)]
        for name, splits in cases:
            got = run(splits)
            err = float(((got[seqs].double() - exact).abs() / tol).max().item())
            del got
            favor_cuda._splits = splits
            try:
                ms64 = event_ms(torch, lambda: favor_cuda.fused_generalized_linear_attention(
                    q, k, v, proj), 10)
                ms8 = event_ms(torch, lambda: favor_cuda.fused_generalized_linear_attention(
                    q8, k8, v8, proj), 20)
                s64 = favor_cuda._splits(b * h, n, m, d, dev)
                s8 = favor_cuda._splits(8 * h, n, m, d, dev)
            finally:
                favor_cuda._splits = rule
            rows.append({"splits": name, "splits_b64": s64, "splits_b8": s8,
                         "x_tolerance": err, "ms_b64": ms64, "ms_b8": ms8})
            print(f"{name}: {s64} splits at B {b} ({-(-tiles // s64)} tiles a split), error "
                  f"{err:.4f} x FAVOR's tolerance of the float64 value, {ms64:.3f} ms; B 8 "
                  f"({s8} splits) {ms8:.4f} ms [{card}]", flush=True)
    print(f"float32 plain version: {plain_x:.4f} x the tolerance; the kernel's operand "
          f"rounding alone (float64 sums): {operand_x:.4f} x; |attention| up to "
          f"{float(exact.abs().max().item()):.3g}; shape {(b, h, n, d)}, m {m} [{card}]")
    print(json.dumps({"card": card, "shape": [b, h, n, d, m], "plain_x_tolerance": plain_x,
                      "operands_only_x_tolerance": operand_x, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
