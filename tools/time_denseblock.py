#!/usr/bin/env python3
"""Time the port's dense-block kernel at DenseNet-121's four blocks, for one
copy of the port.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/time_denseblock.py [--root DIR] [--profile] [--plans]

``--root`` names the directory that holds the ``gridnext_tpu_torch``
package to time (default: this checkout), so that two versions of the
kernel can be timed in turns on one card, each in its own process. Each
block runs on B = 624 patches of 128-px DenseNet-121 (32x32x64 with 6
layers, 16x16x128 with 12, 8x8x256 with 24, 4x4x512 with 16; growth 32, Cb
128), folded from BatchNorm and conv parameters drawn from a numpy seed
(affines near 1 / 0, convs scaled by fan-in) with a standard normal input.
Prints one JSON line: the card, and per block the CUDA-event ms per call
over back-to-back calls, the worst |kernel - plain| / (atol + rtol |plain|)
at rtol = atol = 3e-2, the kernel launches per call and, with
``--profile``, each CUDA kernel's device ms per call from a torch.profiler
trace; then the four blocks' sum. ``--plans`` also times other tile plans
of the package's planner (``plan_dense_block``) for each block.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

CHUNK = 624
BLOCKS = ((32, 64, 6), (16, 128, 12), (8, 256, 24), (4, 512, 16))   # side, c_in0, layers
GROWTH, CB = 32, 128
ITERS = 20
# other plans timed with --plans, per block
PLANS = ({"band_rows": 6}, {"band_rows": 8}, {"band_rows": 14}, {"band_rows": 16}), \
    ({"patches": 1}, {"band_rows": 8}), \
    ({"patches": 1}, {"patches": 2}, {"patches": 4}), \
    ({"patches": 4}, {"patches": 8}, {"patches": 16})


def block_arrays(dense, torch, side, c0, n_layers, seed):
    """(x, (a1, b1, w1, a2, b2, w2)) of one block on the card."""
    rng = np.random.default_rng(seed)
    layers, stats = [], []
    for l in range(n_layers):
        c_in = c0 + l * GROWTH
        layers.append({
            "BatchNorm_0": {"scale": rng.uniform(0.8, 1.2, c_in),
                            "bias": rng.normal(size=c_in) * 0.1},
            "Conv_0": {"kernel": rng.normal(size=(1, 1, c_in, CB)) / np.sqrt(c_in)},
            "BatchNorm_1": {"scale": rng.uniform(0.8, 1.2, CB), "bias": rng.normal(size=CB) * 0.1},
            "Conv_1": {"kernel": rng.normal(size=(3, 3, CB, GROWTH)) / np.sqrt(9 * CB)}})
        stats.append({
            "BatchNorm_0": {"mean": rng.normal(size=c_in) * 0.1,
                            "var": rng.uniform(0.5, 1.5, c_in)},
            "BatchNorm_1": {"mean": rng.normal(size=CB) * 0.1, "var": rng.uniform(0.5, 1.5, CB)}})
    fold = dense.fold_dense_block_params(layers, stats, c0, GROWTH)
    dev = torch.device("cuda")
    a1, b1, a2, b2 = (torch.as_tensor(fold[k], device=dev) for k in ("A1", "B1", "A2", "B2"))
    w1, w2 = (torch.as_tensor(fold[k], device=dev).to(torch.bfloat16) for k in ("W1", "W2"))
    x = torch.as_tensor(rng.standard_normal((CHUNK, side, side, c0), dtype=np.float32),
                        device=dev).to(torch.bfloat16)
    return x, (a1, b1, w1, a2, b2, w2)


def event_ms(torch, fn, iters=ITERS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_ms(torch, fn, calls=5):
    """{CUDA kernel name: device ms per call} of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        name = re.search(r"dense_\w+_kernel", evt.key)
        if name:
            us = getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
            res[name.group()] = res.get(name.group(), 0.0) + us / calls / 1e3
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--profile", action="store_true",
                        help="also trace 5 calls and give each CUDA kernel's device ms per call")
    parser.add_argument("--plans", action="store_true",
                        help="also time other tile plans of each block (this package only)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_denseblock: no CUDA device", file=sys.stderr)
        return 1
    from gridnext_tpu_torch.ops import denseblock_cuda as dense

    if not dense.__file__.startswith(root):
        raise RuntimeError(f"imported {dense.__file__}, not the package under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    res = {"root": root, "card": card, "batch": CHUNK, "blocks": []}
    for bi, (side, c0, n_layers) in enumerate(BLOCKS):
        x, arrays = block_arrays(dense, torch, side, c0, n_layers, seed=bi)

        def kernel():
            return dense.fused_dense_block(x, *arrays, c_in0=c0, growth=GROWTH)

        got = kernel().float()
        want = dense.fused_dense_block_plain(x, *arrays, c_in0=c0, growth=GROWTH).float()
        worst = float(((got - want).abs() / (3e-2 + 3e-2 * want.abs())).max().item())
        finite = bool(torch.isfinite(got).all().item())
        before = dense.launches
        kernel()
        row = {"shape": [CHUNK, side, side, c0], "layers": n_layers, "worst": worst,
               "finite": finite, "launches": dense.launches - before,
               "ms": event_ms(torch, kernel)}
        if args.profile:
            row["device_ms"] = profile_ms(torch, kernel)
        if args.plans:
            row["plans"] = []
            for override in PLANS[bi]:
                plan = dense.plan_dense_block(CHUNK, side, side, CB, **override)
                buf = torch.empty((CHUNK, side, side, c0 + GROWTH * n_layers),
                                  dtype=torch.bfloat16, device="cuda")
                buf[..., :c0] = x

                def planned():
                    return dense._launch(buf, *arrays, c_in0=c0, growth=GROWTH, plan=plan)

                out = planned().float()
                err = float(((out - want).abs() / (3e-2 + 3e-2 * want.abs())).max().item())
                row["plans"].append({**override, "stages": plan.stages,
                                     "warpgroups": plan.warpgroups, "ctas": plan.ctas,
                                     "worst": err, "ms": event_ms(torch, planned)})
        del got, want
        res["blocks"].append(row)
    res["total_ms"] = sum(r["ms"] for r in res["blocks"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
