#!/usr/bin/env python3
"""Hold the port's Lab -> RGB conversion to Pillow on all 2^24 8-bit Lab
triplets.

    python tools/check_lab_conversion.py

Pillow converts a ``LAB`` image through LittleCMS
(``ImageCms.buildTransform(createProfile("LAB"), createProfile("sRGB"),
"LAB", "RGB")``); the port converts with ``io/pillow_modes.lab_to_rgb``
(the table of ``lab_table`` interpolated in ``csrc/raster_codec.cpp``).
This script feeds both every (L, a*, b*) byte triplet, a* and b* as the
two's-complement bytes ``np.asarray`` shows, 2^16 at a time, and prints
how many of the 2^24 outputs differ and by how much. Exits 1 if any
differs. Needs Pillow; takes about a minute on one core.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from PIL import Image

    from gridnext_tpu_torch.io import pillow_modes

    t0 = time.perf_counter()
    ab = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    ab = ab.reshape(256, 256, 2).astype(np.uint8)
    differ, worst = 0, 0
    for L in range(256):
        lab = np.concatenate([np.full((256, 256, 1), L, np.uint8), ab], -1)
        want = np.asarray(Image.fromarray(lab, "LAB").convert("RGB")).astype(np.int16)
        got = pillow_modes.lab_to_rgb(lab).astype(np.int16)
        d = np.abs(got - want).max(-1)
        differ += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    print(f"{2 ** 24} Lab triplets: {2 ** 24 - differ} equal to Pillow, {differ} differ "
          f"(largest difference {worst}), {time.perf_counter() - t0:.1f} s")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
