#!/usr/bin/env python3
"""Time the port's FAVOR kernel at scBERT's shape, for one copy of the port.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/time_favor.py [--root DIR] [--profile] [--peak]

``--root`` names the directory that holds the ``gridnext_tpu_torch``
package to time (default: this checkout), so that two versions of the
kernel can be timed in turns on one card, each in its own process. Inputs
are standard normal from a numpy seed with an orthogonal Gaussian
projection, at B 8, H 10, N 16,907, d 64, m 266 (one scBERT layer over one
count chunk). Prints one JSON line: the card, the kernel's CUDA-event ms per
call over back-to-back calls, its worst |kernel - plain| /
(atol + rtol |plain|) at rtol 2e-4 / atol 2e-5 and, with ``--profile``,
each of its CUDA kernels' device ms per call from a torch.profiler trace.
``--peak`` instead builds ``tools/mma_tf32_peak.cu`` and prints the rate of
the kernel's tensor-core instruction (``mma.sync.m16n8k8`` TF32) alone,
beside the kernel's operand split, and beside the split and its
shared-memory loads, at 8, 16 and 32 resident warps per SM, in TFLOP/s,
with the SM clock.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

SHAPE = (8, 10, 16907, 64, 266)     # B, H, N (16,906 genes + 1), d, m
ITERS = 20                          # back-to-back calls between the events


def mma_peak(torch) -> dict:
    """TFLOP/s of mma.sync.m16n8k8 TF32 at 8, 16 and 32 warps per SM, for
    each mode of ``tools/mma_tf32_peak.cu`` (alone; with the operand split;
    with the split and shared-memory loads)."""
    import ctypes
    import tempfile

    from gridnext_tpu_torch.ops import _cuda

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mma_tf32_peak.cu")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libmma_tf32_peak.so")
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.mma_tf32_peak.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        iters, threads = 20000, 256
        for mode, label in enumerate(("alone", "split", "split_lds")):
            for blocks_per_sm in (1, 2, 4):
                blocks = blocks_per_sm * sms
                out = torch.empty(blocks * threads, device="cuda")
                ms = ctypes.c_float()
                err = lib.mma_tf32_peak(mode, blocks, threads, iters, out.data_ptr(),
                                        ctypes.byref(ms))
                if err:
                    raise RuntimeError(f"mma_tf32_peak: CUDA error {err}")
                flop = blocks * threads // 32 * iters * 12 * 2 * 16 * 8 * 8
                res[f"{label}_warps_per_sm_{8 * blocks_per_sm}"] = flop / ms.value / 1e9
    res["clocks_sm"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--profile", action="store_true",
                        help="also trace 5 calls and give each CUDA kernel's device ms per call")
    parser.add_argument("--peak", action="store_true",
                        help="time mma.sync TF32 alone (TFLOP/s) instead of the kernel")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_favor: no CUDA device", file=sys.stderr)
        return 1
    from gridnext_tpu_torch.ops import favor_cuda
    from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

    if not favor_cuda.__file__.startswith(root):
        raise RuntimeError(f"imported {favor_cuda.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.peak:
        print(json.dumps({"card": card, "mma_tf32_tflops": mma_peak(torch)}))
        return 0
    b, h, n, d, m = SHAPE
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    q, k, v = (torch.as_tensor(rng.standard_normal((b, h, n, d), dtype=np.float32),
                               device=dev) for _ in range(3))
    proj = orthogonal_gaussian_matrix(m, d, generator=torch.Generator().manual_seed(m)).to(dev)
    got = favor_cuda.fused_generalized_linear_attention(q, k, v, proj)
    want = favor_cuda.favor_attention_plain(q, k, v, proj)
    worst = float(((got - want).abs() / (2e-5 + 2e-4 * want.abs())).max().item())
    del got, want
    for _ in range(3):
        favor_cuda.fused_generalized_linear_attention(q, k, v, proj)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        favor_cuda.fused_generalized_linear_attention(q, k, v, proj)
    end.record()
    end.synchronize()
    res = {"root": root, "card": card, "shape": SHAPE,
           "ms": start.elapsed_time(end) / ITERS, "worst": worst}
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                favor_cuda.fused_generalized_linear_attention(q, k, v, proj)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            name = re.search(r"favor_\w+_kernel", evt.key)
            if name:
                us = getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
                res[name.group()] = res.get(name.group(), 0.0) + us / 5 / 1e3
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
