#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py     # ~1 minute, builds the kernels itself

Phases, each of which fails the run (non-zero exit, no result line):

1. setup: the card's name and power limit, versions, and an ``nvcc`` build
   of every kernel in ``gridnext_tpu_torch/csrc/`` (all started together);
2. the patch-gather kernel on 4 random 9,325 x 8,892 x 3 uint8 slides with
   4 x 4,992 lattice spots (+ edge-clamped, parked and out-of-range-slide
   spots), bit-exact against its plain version, timed against its bound;
3. the hex-corrector kernels on 4 random 78 x 64 x 7 grids, logits within
   1e-4 and labels equal (up to near-tie flips) against the plain version;
   each kernel is timed three ways: CUDA events around back-to-back wrapper
   calls, the host's time to issue one call, and the device time of its
   kernels alone from a torch.profiler trace;
4. the main path at full width, as a model directory serves: positions
   files read by ``io.read_positions``, ``modeldir.image_registrar_from_meta``
   for the default ``TpuPatchClassifier`` (stages (256,2),(512,2), stem 16,
   RMSNorm, f32) and the BatchNorm hex corrector, with random weights from a
   numpy seed in the JAX checkpoint layout (through the weight bridge);
   ``__call__``, ``register_logits`` and ``register_batch`` over the 4
   slides, and ``evaluate.to_loupe_annots``. Both kernels must have
   launched, the foreground must equal each tissue mask, the Loupe CSV must
   name each spot's class, the labels must equal the plain-version
   registrar's up to near-ties, and ``register_logits`` must match a direct
   GridNetHex forward on the same patch grid; then the time of
   ``register_batch`` (kernels and plain in turns) and a torch.profiler
   table of one call, with the ported kernels' device time in it;
5. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Parity phases run with TF32 off for cuDNN and matmuls. Imports only the
port, torch and numpy.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12      # f32 on the CUDA cores (no tensor cores)

N_SLIDES = 4
PATCH = 128
PITCH = int(PATCH * 1.07)     # 136 px lattice pitch, 128 px margin
MARGIN = PATCH
N_CLASSES = 7
SEED = 0
TISSUE_FRACTIONS = (0.95, 0.8, 0.65, 0.5)   # elliptical masks, one per slide


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> tuple:
    """(ms per call on the stream between CUDA events, ms per call the host
    took to issue it) of ``fn``, over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3 / iters


# CUDA kernel of each ported function, as the profiler names it
KERNEL_SYMBOLS = {"gather_patches": ("gather_patches_kernel",),
                  "fused_hex_corrector": ("hex_layer_kernel",),
                  "fused_hex_corrector_labels": ("hex_layer_kernel",
                                                 "hex_labels_kernel")}


def traced_kernels(prof, symbols, calls: int) -> dict:
    """{symbol: (launches per call, device ms per call)} of the CUDA kernels
    named ``symbols`` in a torch.profiler trace of ``calls`` calls."""
    found = {}
    for evt in prof.key_averages():
        for sym in symbols:
            if f"{sym}(" in evt.key:
                us = getattr(evt, "self_device_time_total", None)
                if us is None:
                    us = evt.self_cuda_time_total
                n, t = found.get(sym, (0, 0.0))
                found[sym] = (n + evt.count, t + us)
    missing = [s for s in symbols if s not in found or found[s][1] <= 0]
    if missing:
        names = [e.key[:60] for e in prof.key_averages()][:30]
        raise AssertionError(f"no device time for {missing} in the trace; "
                             f"events: {names}")
    return {s: (n / calls, us / 1e3 / calls) for s, (n, us) in found.items()}


def device_ms(torch, fn, iters: int, symbols) -> dict:
    """:func:`traced_kernels` of ``iters`` back-to-back calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return traced_kernels(prof, symbols, iters)


def kernel_line(per_symbol: dict) -> tuple:
    """(device ms per call, text) of :func:`traced_kernels`' result."""
    total = sum(ms for _, ms in per_symbol.values())
    parts = ", ".join(f"{s} {n:g} x {ms / n * 1e3:.2f} us" for s, (n, ms)
                      in per_symbol.items())
    return total, parts


def lattice(geometry):
    """(row, col_oddr, y_px, x_px) of the 78 x 64 spots at the bench pitch."""
    rows = np.repeat(np.arange(geometry.VISIUM_H_ST), geometry.VISIUM_W_ST)
    cols = np.tile(np.arange(geometry.VISIUM_W_ST), geometry.VISIUM_H_ST)
    x, y = geometry.oddr_to_cartesian(cols, rows)
    return (rows, cols, np.rint(y * PITCH).astype(np.int64) + MARGIN,
            np.rint(x * PITCH).astype(np.int64) + MARGIN)


def make_slides(torch, n, h, w, device):
    """Random slides with structure: 64-px colour blocks plus noise."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    bh, bw = -(-h // 64), -(-w // 64)
    blocks = torch.randint(0, 256, (n, bh, bw, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    slides = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        big = blocks[i].repeat_interleave(64, 0).repeat_interleave(64, 1)[:h, :w]
        noise = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8, device=device,
                              generator=gen)
        slides[i] = big // 2 + noise // 2
    return slides


def phase_gather(torch, slides, geometry, gather):
    log("== phase 2: patch-gather kernel")
    b, h, w, _ = slides.shape
    _, _, y_px, x_px = lattice(geometry)
    y0 = np.tile(y_px - PATCH // 2, b)
    x0 = np.tile(x_px - PATCH // 2, b)
    slide = np.repeat(np.arange(b), len(y_px))
    # edge corners (clamped), parked-spot corners, out-of-range slide ids
    y0 = np.concatenate([y0, [-50, h, h - 100, 5, 0, 0, 17, 9000]])
    x0 = np.concatenate([x0, [-50, w, 5, w - 10, 0, 0, 8800, -7]])
    slide = np.concatenate([slide, [0, 3, 1, 2, 0, 1, -1, 9]])
    dev = slides.device
    args = [torch.as_tensor(a.astype(np.int32), device=dev) for a in (y0, x0, slide)]
    n = len(y0)
    out = gather.gather_patches(slides, args[0], args[1], PATCH, args[2])
    plain = gather.gather_patches_plain(slides, args[0], args[1], PATCH, args[2])
    torch.cuda.synchronize()
    err = int((out.int() - plain.int()).abs().max().item())
    if not torch.equal(out, plain):
        raise AssertionError(f"gather kernel differs from plain (max abs {err})")
    del plain
    def kernel():
        return gather.gather_patches(slides, args[0], args[1], PATCH, args[2])

    ms, host_ms = cuda_ms(torch, kernel, iters=20)
    dev_ms, parts = kernel_line(device_ms(torch, kernel, 10,
                                          KERNEL_SYMBOLS["gather_patches"]))
    plain_ms, _ = cuda_ms(torch, lambda: gather.gather_patches_plain(
        slides, args[0], args[1], PATCH, args[2]), iters=3, warmup=1)
    nbytes = 2 * n * PATCH * PATCH * 3 + 3 * n * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"gather: N={n} window={PATCH}: bit-exact; kernel {ms:.4f} ms per call "
        f"(events; host issues a call in {host_ms:.4f} ms), device {dev_ms:.4f} "
        f"ms ({parts}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes {nbytes})")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


def corrector_work(b, c_in, n_classes, width=32, h=78, w=64):
    """(flops, bytes) of the 5-layer corrector on b grids."""
    dims = (c_in, width, width, width, width, n_classes)
    macs = sum(7 * dims[i] * dims[i + 1] for i in range(5))
    weights = sum(7 * dims[i] * dims[i + 1] + dims[i + 1] for i in range(5))
    return 2 * b * h * w * macs, b * h * w * c_in * 4 + weights * 4


def phase_corrector(torch, corr, serving, dev):
    log("== phase 3: hex-corrector kernels")
    rng = np.random.default_rng(SEED + 1)
    dims = (N_CLASSES, 32, 32, 32, 32, N_CLASSES)
    kernels = [rng.normal(size=(7, dims[i], dims[i + 1])).astype(np.float32)
               / np.sqrt(7 * dims[i]) for i in range(5)]
    biases = [rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1
              for i in range(5)]
    kernels = corr.as_f32_tensors(kernels, dev)
    biases = corr.as_f32_tensors(biases, dev)
    flags = corr.CORRECTOR_RELU_FLAGS
    x = torch.as_tensor(rng.normal(size=(N_SLIDES, 78, 64, N_CLASSES))
                        .astype(np.float32), device=dev)
    fg = torch.as_tensor((rng.random((N_SLIDES, 78, 64)) < 0.7).astype(np.int32),
                         device=dev)
    logits = corr.fused_hex_corrector(x, kernels, biases, flags)
    plain = corr.hex_corrector_plain(x, kernels, biases, flags)
    labels = corr.fused_hex_corrector_labels(x, fg, kernels, biases, flags)
    plain_labels = corr.hex_corrector_labels_plain(x, fg, kernels, biases, flags)
    torch.cuda.synchronize()
    err = float((logits - plain).abs().max().item())
    if not err <= 1e-4:
        raise AssertionError(f"corrector logits differ from plain by {err}")
    flips = sum(serving.label_parity_report(plain_labels[i].cpu().numpy(),
                                            labels[i].cpu().numpy(),
                                            plain[i].cpu().numpy())
                for i in range(N_SLIDES))
    label_err = int((labels - plain_labels).abs().max().item())
    flops, nbytes = corrector_work(N_SLIDES, N_CLASSES, N_CLASSES)
    res = {}
    for name, fn, plain_fn, out_bytes in (
            ("fused_hex_corrector",
             lambda: corr.fused_hex_corrector(x, kernels, biases, flags),
             lambda: corr.hex_corrector_plain(x, kernels, biases, flags),
             N_SLIDES * 78 * 64 * N_CLASSES * 4),
            ("fused_hex_corrector_labels",
             lambda: corr.fused_hex_corrector_labels(x, fg, kernels, biases, flags),
             lambda: corr.hex_corrector_labels_plain(x, fg, kernels, biases, flags),
             N_SLIDES * 78 * 64 * 4 * 2)):   # fg in + labels out
        ms, host_ms = cuda_ms(torch, fn, iters=50)
        dev_ms, parts = kernel_line(device_ms(torch, fn, 50, KERNEL_SYMBOLS[name]))
        plain_ms, _ = cuda_ms(torch, plain_fn, iters=10)
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        t_bytes = (nbytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": ms, "device_ms": dev_ms, "host_ms": host_ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        log(f"{name}: B={N_SLIDES}: kernel {ms:.4f} ms per call (events; host "
            f"issues a call in {host_ms:.4f} ms), device {dev_ms:.4f} ms "
            f"({parts}), plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.5f} "
            f"ms ({flops / 1e6:.1f} MFLOP, {nbytes + out_bytes} bytes)")
    res["fused_hex_corrector"]["max_abs_err"] = err
    res["fused_hex_corrector_labels"]["max_abs_err"] = label_err
    log(f"corrector: logits max abs err {err:.3g} (<= 1e-4), labels equal up to "
        f"{flips} near-tie flips")
    return res


def write_spaceranger_dir(root, geometry, frac: float, idx: int):
    """Write a Spaceranger v2 positions file for one slide: an elliptical
    tissue mask of relative size ``frac`` over the bench lattice. Returns
    (the Spaceranger directory, the (78, 64) tissue mask); spot ``i`` of the
    file is odd-right cell ``divmod(i, 64)``."""
    rows, cols, y_px, x_px = lattice(geometry)
    cx, cy = geometry.oddr_to_cartesian(cols, rows)
    rx = (cx.max() - cx.min()) / 2 * frac
    ry = (cy.max() - cy.min()) / 2 * frac
    r2 = ((cx - cx.mean()) / rx) ** 2 + ((cy - cy.mean()) / ry) ** 2
    in_tissue = (r2 <= 1.0).astype(np.int64)
    array_col, array_row = geometry.oddr_to_pseudo_hex(cols, rows)
    sr_dir = os.path.join(root, f"slide{idx}")
    os.makedirs(os.path.join(sr_dir, "outs", "spatial"))
    with open(os.path.join(sr_dir, "outs", "spatial", "tissue_positions.csv"), "w",
              newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["barcode", "in_tissue", "array_row", "array_col",
                      "pxl_row_in_fullres", "pxl_col_in_fullres"])
        out.writerows([f"S{idx}BC{i:05d}-1", *vals] for i, vals in enumerate(
            zip(in_tissue, array_row, array_col, y_px, x_px)))
    return sr_dir, in_tissue.reshape(geometry.VISIUM_H_ST, geometry.VISIUM_W_ST)


def random_variables(models, from_jax):
    """A variables tree in the JAX package's layout for the default-width
    GridNetHex(TpuPatchClassifier) with the BatchNorm corrector, filled from
    a numpy seed (what a JAX model directory's checkpoint holds)."""
    model = models.GridNetHex(models.TpuPatchClassifier(n_classes=N_CLASSES),
                              n_classes=N_CLASSES, f_dim=N_CLASSES, use_bn=True)
    rng = np.random.default_rng(SEED + 2)

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
            elif key == "var":
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            else:   # bias, mean
                out[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
        return out

    return fill(from_jax.jax_variables(model))


def check_loupe_csv(path, labels, classes, n_spots):
    """The Loupe CSV names each in-tissue spot's class from ``labels``."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if rows[0] != ["Barcode", "AARs"] or len(rows) != n_spots + 1:
        raise AssertionError(f"Loupe CSV: header {rows[0]}, {len(rows) - 1} rows "
                             f"for {n_spots} in-tissue spots")
    for barcode, annot in rows[1:]:
        spot = int(barcode.split("BC")[1].split("-")[0])
        y, x = divmod(spot, labels.shape[1])
        if annot != classes[labels[y, x] - 1]:
            raise AssertionError(f"Loupe CSV: {barcode} is {annot!r}, label "
                                 f"{labels[y, x]}")


def phase_main_path(torch, slides, port, card, tmp):
    geometry, io, models, from_jax, modeldir, evaluate, serving, gather, corr = port
    log("== phase 4: main path at full width (TF32 off for cuDNN and matmuls)")
    dev = slides.device
    meta = {"model": "GridNetHex+TpuPatchClassifier",
            "classes": [f"Class_{i + 1}" for i in range(N_CLASSES)],
            "tpu_f": {"stages": [[256, 2], [512, 2]], "stem_patch": 16, "norm": "rms"},
            "patch_px": PATCH, "patch_chunk": 624}
    classes = meta["classes"]
    variables = random_variables(models, from_jax)
    dirs_masks = [write_spaceranger_dir(tmp, geometry, f, i)
                  for i, f in enumerate(TISSUE_FRACTIONS)]
    masks = [m for _, m in dirs_masks]
    n_spots = [int(m.sum()) for m in masks]
    log(f"in-tissue spots per slide: {n_spots}")
    # the model-directory route (normalize=None: /255 only)
    reg = modeldir.image_registrar_from_meta(meta, classes, variables, device=dev)
    positions = [io.read_positions(d) for d, _ in dirs_masks]

    gather.launches = 0
    for k in corr.launches:
        corr.launches[k] = 0
    labels0 = reg(slides[0], positions[0])
    logits1, fg1 = reg.register_logits(slides[1], positions[1])
    labels_b = reg.register_batch(slides, positions)
    torch.cuda.synchronize()
    launches = {"gather_patches": gather.launches, **corr.launches}
    log(f"main-path kernel launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # what comes out: shapes, finite logits, foreground == tissue masks
    if labels0.shape != (78, 64) or labels_b.shape != (N_SLIDES, 78, 64):
        raise AssertionError(f"label shapes {labels0.shape} {labels_b.shape}")
    if not np.isfinite(logits1).all() or logits1.shape != (78, 64, N_CLASSES):
        raise AssertionError("register_logits gave non-finite or misshapen logits")
    for got, mask in [(labels0 > 0, masks[0]), (fg1 > 0, masks[1])] + [
            (labels_b[i] > 0, masks[i]) for i in range(N_SLIDES)]:
        if not np.array_equal(got, mask > 0):
            raise AssertionError("foreground differs from the tissue mask")
    if labels_b.max() > N_CLASSES:
        raise AssertionError(f"label {labels_b.max()} out of range")
    loupe = os.path.join(tmp, "slide0_labels.csv")
    evaluate.to_loupe_annots(labels0, io.find_position_file(dirs_masks[0][0]), loupe,
                             annot_names=classes)
    check_loupe_csv(loupe, labels0, classes, n_spots[0])
    log(f"Loupe CSV of slide 0: {n_spots[0]} spots, classes match the label grid")

    # the same model through the same weight bridge, with the plain versions
    class PlainRegistrar(serving.SlideRegistrar):
        """The registrar with each kernel's plain version in its place."""

        def _extract_flat(self, wsis, y_c, x_c, slide):
            w = self.window_size
            return gather.gather_patches_plain(wsis, y_c - w // 2, x_c - w // 2, w,
                                               slide)

        def _labels_from_grid(self, grid, fg):
            return corr.hex_corrector_labels_plain(grid, fg, self.kernels,
                                                   self.biases, self.relu_flags)

        def _register_logits(self, wsi, oy, ox, y_px, x_px):
            grid, fg = self._grid_fg(wsi[None], oy[None], ox[None], y_px[None],
                                     x_px[None])
            logits = corr.hex_corrector_plain(grid, self.kernels, self.biases,
                                              self.relu_flags)
            return logits[0].float(), fg[0]

    f = models.TpuPatchClassifier(n_classes=N_CLASSES,
                                  **models.tpu_f_arch_kwargs(meta["tpu_f"]))
    model = from_jax.load_gridnet_hex(
        models.GridNetHex(f, n_classes=N_CLASSES, f_dim=N_CLASSES), variables)
    model = model.to(dev).eval()
    plain = PlainRegistrar.from_gridnet(model, patch_size=PATCH, patch_chunk=624,
                                        normalize=None, device=dev)
    plain_logits = [plain.register_logits(slides[i], positions[i])[0]
                    for i in range(N_SLIDES)]
    flips = serving.label_parity_report(plain(slides[0], positions[0]), labels0,
                                        plain_logits[0])
    plain_b = plain.register_batch(slides, positions)
    for i in range(N_SLIDES):
        flips += serving.label_parity_report(plain_b[i], labels_b[i], plain_logits[i])
    logit_err = float(np.abs(logits1 - plain_logits[1]).max())
    if not logit_err <= 1e-4:
        raise AssertionError(f"register_logits differs from plain by {logit_err}")
    log(f"kernels vs plain registrar: labels equal up to {flips} near-tie flips, "
        f"logits max abs err {logit_err:.3g}")

    # an independent reference: GridNetHex forward on the patch grid of slide 1
    # (background cells are zero patches, as in training grids)
    oy, ox, y_px, x_px = serving.spot_pixel_arrays(positions[1])
    crops = gather.gather_patches_plain(
        slides[1], torch.as_tensor(y_px - PATCH // 2, device=dev),
        torch.as_tensor(x_px - PATCH // 2, device=dev), PATCH)
    grid = torch.zeros((78, 64, PATCH, PATCH, 3), device=dev)
    grid[torch.as_tensor(oy, device=dev), torch.as_tensor(ox, device=dev)] = \
        crops.float() / 255.0
    model.patch_chunk = 624
    with torch.inference_mode():
        ref = model(grid[None])[0].cpu().numpy()
    ref_err = float(np.abs(ref - logits1).max())
    if not ref_err <= 1e-3:
        raise AssertionError(f"register_logits differs from the GridNetHex "
                             f"forward by {ref_err}")
    log(f"register_logits vs GridNetHex forward: max abs err {ref_err:.3g}")
    del grid, crops

    # end-to-end time of register_batch (host clock, results on the host), the
    # kernels' registrar and the plain one in turns: k p p k k p p k
    times = {"kernels": [], "plain": []}
    for r in (reg, plain):
        r.register_batch(slides, positions)
    for name in ("kernels", "plain", "plain", "kernels") * 2:
        r = reg if name == "kernels" else plain
        t0 = time.perf_counter()
        r.register_batch(slides, positions)
        times[name].append(time.perf_counter() - t0)
    t, t_plain = (float(np.median(times[k])) for k in ("kernels", "plain"))
    log(f"register_batch of {N_SLIDES} slides ({sum(n_spots)} spots), f32 without "
        f"TF32, median of 4: {t * 1e3 / N_SLIDES:.2f} ms/slide, "
        f"{sum(n_spots) / t:.0f} spots/s with the kernels (runs "
        f"{[round(x * 1e3, 2) for x in times['kernels']]} ms); "
        f"{t_plain * 1e3 / N_SLIDES:.2f} ms/slide with "
        f"the plain versions [{card}]")
    return launches, reg, positions


def profile_batch(torch, reg, slides, positions):
    from torch.profiler import ProfilerActivity, profile

    reg.register_batch(slides, positions)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reg.register_batch(slides, positions)
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    for name in ("gather_patches", "fused_hex_corrector_labels"):
        dev_ms, parts = kernel_line(traced_kernels(prof, KERNEL_SYMBOLS[name], 1))
        log(f"register_batch trace: {name} device {dev_ms:.4f} ms ({parts})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from gridnext_tpu_torch import evaluate, geometry, io, modeldir, models, serving
    from gridnext_tpu_torch.compat import from_jax
    from gridnext_tpu_torch.ops import _cuda
    from gridnext_tpu_torch.ops import hexcorrector_cuda as corr
    from gridnext_tpu_torch.ops import patch_gather_cuda as gather

    log("== phase 1: setup")
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _cuda.build()
    for name, info in built.items():
        log(f"built {name}.cu in {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {line.strip()}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    _, _, y_px, x_px = lattice(geometry)
    h, w = int(y_px.max() + MARGIN), int(x_px.max() + MARGIN)
    slides = make_slides(torch, N_SLIDES, h, w, dev)
    log(f"{N_SLIDES} slides of {h} x {w} x 3 uint8 ({slides.numel() / 1e9:.2f} GB)")

    res = {"gather_patches": phase_gather(torch, slides, geometry, gather)}
    res.update(phase_corrector(torch, corr, serving, dev))
    with tempfile.TemporaryDirectory() as tmp:   # positions files, Loupe CSV
        launches, reg, positions = phase_main_path(
            torch, slides, (geometry, io, models, from_jax, modeldir, evaluate,
                            serving, gather, corr), card, tmp)
    profile_batch(torch, reg, slides, positions)

    meta = {
        "gather_patches": ("gridnext_tpu_torch/csrc/patch_gather.cu",
                           "gridnext_tpu/ops/patch_gather_pallas.py:143"),
        "fused_hex_corrector": ("gridnext_tpu_torch/csrc/hexcorrector.cu",
                                "gridnext_tpu/ops/hexcorrector_pallas.py:182"),
        "fused_hex_corrector_labels": ("gridnext_tpu_torch/csrc/hexcorrector.cu",
                                       "gridnext_tpu/ops/hexcorrector_pallas.py:197"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": res[name]["max_abs_err"],
                "ms": res[name]["ms"], "device_ms": res[name]["device_ms"],
                "host_ms": res[name]["host_ms"], "plain_ms": res[name]["plain_ms"],
                "bound_ms": res[name]["bound_ms"], "bound_by": res[name]["bound_by"],
                # no single PyTorch call computes either function
                "library_ms": None}
               for name, (src, rep) in meta.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
