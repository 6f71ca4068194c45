#!/usr/bin/env python3
"""Time the ``register`` command's serving loop (``serving.register_slides``)
in parts, for one copy of the port.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/time_register_slides.py [--root DIR]

``--root`` names the directory that holds the ``gridnext_tpu_torch``
package to time (default: this checkout). The cohort is ``chip_smoke.py``
phase 10's: the default ``TpuPatchClassifier`` model with random weights
from a numpy seed, 4 random 9,325 x 8,892 x 3 uint8 slides saved as
``.npy`` in the order A A B A A B (B: slides 0 and 1 cut to 9,000 rows),
decoded with ``np.load``, ``slide_batch`` 4, prefetch 5. Prints, per
variant, the loop's wall ms/slide and its stage ms/slide, then one JSON
line with all of them and the card:

- ``fresh source`` (twice): a new ``SlideSource`` per pass, as the CLI makes;
- ``same source`` (twice): one ``SlideSource`` iterated twice;
- ``positions pre-read`` (twice): no positions parse on the decode thread;
- ``source alone``: the decode thread's rate with nothing registering;
- ``registration alone``: the loop over slides already staged;
- ``torch threads 1``: one intra-op thread for the copies into pinned memory;
- ``traced``: a pass under torch.profiler, with the pinned copies' device
  ms and their share under kernels from its Chrome trace.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(TOOLS),
                    help="directory holding the gridnext_tpu_torch package to time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, os.path.dirname(TOOLS))          # chip_smoke's helpers
    import torch

    if not torch.cuda.is_available():
        print("time_register_slides: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gridnext_tpu_torch import geometry, ingest, io, modeldir, models, serving
    from gridnext_tpu_torch.compat import from_jax
    from gridnext_tpu_torch.ops import _cuda

    card = cs.card_line()
    cs.log(card)
    _cuda.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, _, y_px, x_px = cs.lattice(geometry)
    h, w = int(y_px.max() + cs.MARGIN), int(x_px.max() + cs.MARGIN)
    slides = cs.make_slides(torch, cs.N_SLIDES, h, w, dev)
    meta = {"model": "GridNetHex+TpuPatchClassifier",
            "classes": [f"Class_{i + 1}" for i in range(cs.N_CLASSES)],
            "tpu_f": {"stages": [[256, 2], [512, 2]], "stem_patch": 16, "norm": "rms"},
            "patch_px": cs.PATCH, "patch_chunk": cs.CHUNK}
    reg = modeldir.image_registrar_from_meta(meta, meta["classes"],
                                             cs.random_variables(models, from_jax), device=dev)
    tmp = tempfile.mkdtemp()
    dirs_masks = [cs.write_spaceranger_dir(tmp, geometry, f, i)
                  for i, f in enumerate(cs.TISSUE_FRACTIONS)]
    files, dirs = [], []
    for k, (kind, i) in enumerate([("A", 0), ("A", 1), ("B", 0), ("A", 2), ("A", 3),
                                   ("B", 1)]):
        wsi = slides[i] if kind == "A" else slides[i][:cs.B_ROWS]
        files.append(os.path.join(tmp, f"slide{k}.npy"))
        np.save(files[-1], wsi.cpu().numpy())
        dirs.append(dirs_masks[i][0])
    reg.register_batch(slides, [io.read_positions(d) for d, _ in dirs_masks])  # warm-up
    del slides
    n = len(files)
    out = {"card": card}

    def source(cls=ingest.SlideSource):
        return cls(files, dirs, prefetch=5, decode=np.load, device=dev)

    def run(name, src):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in serving.register_slides(reg, files, dirs, slide_batch=4, source=src):
            pass
        wall = time.perf_counter() - t0
        per = {k: v * 1e3 / n for k, v in src.timer.summary().items()}
        out[name] = {"wall_ms_per_slide": wall * 1e3 / n, "stage_ms_per_slide": per}
        cs.log(f"{name}: wall {wall * 1e3 / n:.2f} ms/slide, stages {json.dumps(per)}")

    for p in range(2):
        run(f"fresh source {p}", source())
    same = source()
    for p in range(2):
        same.timer = ingest.StageTimer()
        run(f"same source {p}", same)
    positions = {d: io.read_positions(d) for d in set(dirs)}

    class PreRead(ingest.SlideSource):
        def _positions(self, i):
            return positions[self.spaceranger_dirs[i]]

    for p in range(2):
        run(f"positions pre-read {p}", source(PreRead))
    alone = source()
    t0 = time.perf_counter()
    for _ in alone:
        pass
    torch.cuda.synchronize()
    out["source alone"] = {"wall_ms_per_slide": (time.perf_counter() - t0) * 1e3 / n,
                           "stage_ms_per_slide": {k: v * 1e3 / n for k, v in
                                                  alone.timer.summary().items()}}
    cs.log(f"source alone: {json.dumps(out['source alone'])}")
    staged = [(i, wsi.clone(), pos) for i, wsi, pos in source()]

    class Staged:
        timer = ingest.StageTimer()

        def __iter__(self):
            return iter(staged)

    run("registration alone", Staged())
    del staged
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    run("torch threads 1", source())
    torch.set_num_threads(threads)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run("traced", source())
        torch.cuda.synchronize()
    out["traced"]["overlap"] = cs.staging_overlap(prof, os.path.join(tmp, "trace.json"))
    cs.log(f"traced: {json.dumps(out['traced']['overlap'])}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
