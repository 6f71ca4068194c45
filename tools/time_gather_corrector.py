#!/usr/bin/env python3
"""Time the port's patch-gather and hex-corrector kernels, for one copy of the port.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/time_gather_corrector.py [--root DIR] [--profile] [--probe]

``--root`` names the directory that holds the ``gridnext_tpu_torch``
package to time (default: this checkout), so that two versions of the
kernels can be timed in turns on one card, each in its own process. The
gather runs at ``chip_smoke.py`` phase 2's shape (4 random 9,325 x 8,892 x
3 uint8 slides, 4 x 4,992 lattice spots, 128-px windows); the corrector on
4 random 78 x 64 x 7 grids through the five-layer corrector (7 -> 32 x 4
-> 7), both from numpy seeds. Prints one JSON line: the card, each
kernel's CUDA-event ms per call over back-to-back calls (checked against
its plain version first), the host's ms to issue a corrector call, the
crop as one PyTorch indexing call (the library time) and, with
``--profile``, each kernel's device ms per call from a torch.profiler
trace. ``--probe`` also builds ``csrc/hexcorrector.cu`` with
``-DHEX_PROBE`` and gives, per layer of one corrector call, the clocks of
the first CTA's thread 0 in staging, products, epilogue and cluster sync.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
ITERS = 20


def probe_corrector(torch, corr, x, kernels, biases) -> list:
    """Per layer, [staging, products, epilogue, sync] clocks of one call
    through a ``-DHEX_PROBE`` build of the corrector (the second of two)."""
    from gridnext_tpu_torch.ops import _cuda

    path = os.path.join(tempfile.mkdtemp(), "libhexcorrector_probe.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DHEX_PROBE", "-o", path,
                    os.path.join(_cuda.CSRC_DIR, "hexcorrector.cu")], check=True)
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in _cuda.SIGNATURES["hexcorrector"].items():
        getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
    lib.hex_corrector_probe.argtypes = [ctypes.c_void_p]
    lib.hex_corrector_probe.restype = ctypes.c_int
    clocks = (ctypes.c_longlong * (16 * 4))()
    library = _cuda.library
    _cuda.library = lambda name: lib if name == "hexcorrector" else library(name)
    corr._prepare.cache_clear()
    try:
        for _ in range(2):
            _cuda.check(lib, lib.hex_corrector_probe(clocks), "probe reset")
            corr.fused_hex_corrector(x, kernels, biases)
            torch.cuda.synchronize()
        _cuda.check(lib, lib.hex_corrector_probe(clocks), "probe read")
    finally:
        _cuda.library = library
        corr._prepare.cache_clear()
    return [list(clocks[4 * l:4 * l + 4]) for l in range(min(len(kernels), 16))]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(TOOLS))
    parser.add_argument("--profile", action="store_true",
                        help="also trace 10 calls of each and give its device ms per call")
    parser.add_argument("--probe", action="store_true",
                        help="also give the corrector's clocks per layer from a -DHEX_PROBE build")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.dirname(TOOLS))        # this checkout's chip_smoke helpers
    import torch

    if not torch.cuda.is_available():
        print("time_gather_corrector: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gridnext_tpu_torch import geometry
    from gridnext_tpu_torch.ops import hexcorrector_cuda as corr
    from gridnext_tpu_torch.ops import patch_gather_cuda as gather

    if not gather.__file__.startswith(root):
        raise RuntimeError(f"imported {gather.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    res = {"root": root, "card": cs.card_line()}

    # the gather at phase 2's shape
    _, _, y_px, x_px = cs.lattice(geometry)
    h, w = int(y_px.max() + cs.MARGIN), int(x_px.max() + cs.MARGIN)
    slides = cs.make_slides(torch, cs.N_SLIDES, h, w, dev)
    b = cs.N_SLIDES
    y0 = torch.as_tensor(np.tile(y_px - cs.PATCH // 2, b).astype(np.int32), device=dev)
    x0 = torch.as_tensor(np.tile(x_px - cs.PATCH // 2, b).astype(np.int32), device=dev)
    slide = torch.as_tensor(np.repeat(np.arange(b), len(y_px)).astype(np.int32), device=dev)
    want = gather.gather_patches_plain(slides, y0, x0, cs.PATCH, slide)
    if not torch.equal(gather.gather_patches(slides, y0, x0, cs.PATCH, slide), want):
        raise AssertionError("gather kernel differs from plain")
    yy, xx, ss = cs.clamped(y0, x0, slide, b, h, w, cs.PATCH)
    view = cs.window_view(slides, cs.PATCH)
    n = y0.shape[0]
    res["gather_n"] = n
    res["gather_bound_ms"] = (2 * n * cs.PATCH ** 2 * 3 + 3 * n * 4) / cs.HBM_BYTES_PER_S * 1e3
    res["gather_ms"] = cs.cuda_ms(torch, lambda: gather.gather_patches(
        slides, y0, x0, cs.PATCH, slide), ITERS)[0]
    res["gather_library_ms"] = cs.cuda_ms(torch, lambda: cs.library_gather(view, ss, yy, xx),
                                          ITERS)[0]
    if args.profile:
        symbols = (cs.KERNEL_SYMBOLS["gather_patches"] if hasattr(gather, "bulk")
                   else ("gather_patches_kernel",))       # one byte per load and store
        res["gather_device_ms"] = cs.kernel_line(cs.device_ms(
            torch, lambda: gather.gather_patches(slides, y0, x0, cs.PATCH, slide), 10,
            symbols))[0]
    del want, slides, view

    # the corrector at B = 4
    rng = np.random.default_rng(cs.SEED + 1)
    dims = (cs.N_CLASSES, 32, 32, 32, 32, cs.N_CLASSES)
    kernels = corr.as_f32_tensors([rng.normal(size=(7, dims[i], dims[i + 1])).astype(
        np.float32) / np.sqrt(7 * dims[i]) for i in range(5)], dev)
    biases = corr.as_f32_tensors([rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1
                                  for i in range(5)], dev)
    x = torch.as_tensor(rng.normal(size=(b, 78, 64, cs.N_CLASSES)).astype(np.float32),
                        device=dev)
    fg = torch.as_tensor((rng.random((b, 78, 64)) < 0.7).astype(np.int32), device=dev)
    err = float((corr.fused_hex_corrector(x, kernels, biases)
                 - corr.hex_corrector_plain(x, kernels, biases)).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"corrector differs from plain by {err}")
    for name, fn in (("corrector", lambda: corr.fused_hex_corrector(x, kernels, biases)),
                     ("corrector_labels",
                      lambda: corr.fused_hex_corrector_labels(x, fg, kernels, biases))):
        res[f"{name}_ms"], res[f"{name}_host_ms"] = cs.cuda_ms(torch, fn, 50)
        if args.profile:
            symbols = cs.KERNEL_SYMBOLS["fused_hex_corrector" if name == "corrector"
                                        else "fused_hex_corrector_labels"]
            if not hasattr(corr, "plan_corrector"):     # one launch a layer
                symbols = ("hex_layer_kernel",) + (() if name == "corrector"
                                                   else ("hex_labels_kernel",))
            res[f"{name}_device_ms"] = cs.kernel_line(cs.device_ms(torch, fn, 50, symbols))[0]
    if args.probe:
        res["corrector_probe_clocks"] = probe_corrector(torch, corr, x, kernels, biases)
    res["corrector_bound_ms"] = cs.corrector_work(b, cs.N_CLASSES, cs.N_CLASSES)[0] \
        / cs.FP32_FLOPS_PER_S * 1e3
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
