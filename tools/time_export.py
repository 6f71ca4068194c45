#!/usr/bin/env python3
"""Time ``torch.export`` of a full-width multimodal grid model on the card.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/time_export.py

Exports, through ``serving.export_grid_forward`` (the ``export`` command's
path), a ``GridNetHexMM`` of scBERT (16,906 genes, dim 200, depth 2, 10
heads, dim_head 64, m 266, count chunk 8) and DenseNet-121 (f32, patch
chunk 624) over the 78 x 64 grid of 128-px patches, with random weights
from a torch seed: once with every chunk loop a ``map``
(``models.gridnet.MAP_MIN_CHUNKS`` = 1) and once with the package's rule
(the 8 image chunks unrolled, the 624 count chunks mapped), after one
small export that pays the exporter's first-use set-up. Prints one JSON
line: the card, and each way's export seconds and artifact megabytes.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_export: no CUDA device", file=sys.stderr)
        return 1
    from gridnext_tpu_torch import models, serving
    from gridnext_tpu_torch.models import gridnet

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    serving.export_grid_forward(models.GridNetHex(models.CountMLP(5, 3), n_classes=3,
                                                  f_dim=3).to(dev).eval(), (4, 4, 5))
    shapes = ((78, 64, 128, 128, 3), (78, 64, 16906))
    out = {"card": card}
    rule = gridnet.MAP_MIN_CHUNKS
    for name, min_chunks in (("every loop mapped", 1), ("package rule", rule)):
        gridnet.MAP_MIN_CHUNKS = min_chunks
        torch.manual_seed(0)
        g = models.GridNetHexMM(
            models.densenet121(num_classes=7),
            models.scBERT(n_genes=16906, dim=200, depth=2, heads=10, dim_head=64,
                          nb_features=266, n_classes=7, generalized_attention=True),
            n_classes=7, patch_chunk=624, count_chunk=8).to(dev).eval()
        t0 = time.perf_counter()
        blob = serving.export_grid_forward(g, shapes, explicit_fg=True)
        out[name] = {"export_s": time.perf_counter() - t0, "mb": len(blob) / 1e6}
        del g, blob
        torch.cuda.empty_cache()
    gridnet.MAP_MIN_CHUNKS = rule
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
