#!/usr/bin/env python3
"""Write the JPEG codec's fixtures: small JPEGs encoded by Pillow, the
pixels they encode and the pixels Pillow decodes from them.

    python tools/make_jpeg_fixtures.py        # writes tests/data/jpeg/

The port's codec (``gridnext_tpu_torch/io/jpeg.py``) is held to Pillow
where Pillow is absent (a GPU machine) through these files:
``chip_smoke.py`` phase 21 (a) and ``tests/test_torch_cuda.py`` decode
each ``<name>.jpg`` to its ``decoded_<name>`` and encode the
``pixels_<name>`` of the 4:2:0 and gray cases without restart markers
(what the encoder writes: Pillow's defaults) to the file's bytes.
``tests/test_torch_jpeg.py`` runs
:func:`fixtures` again and checks the committed files still equal
Pillow's output. The images are seeded numpy patterns: smooth gradients
under noise, so every DCT band and Huffman code length occurs.
"""

from __future__ import annotations

import io
import json
import os
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
                   "data", "jpeg")

# name, shape, quality, subsampling (the codec's name; Pillow's number),
# restart_marker_blocks (0: none)
CASES = (
    ("rgb33_q75", (33, 33, 3), 75, "4:2:0", 0),
    ("rgb128_q75", (128, 128, 3), 75, "4:2:0", 0),
    ("rgb100x64_q95_444", (100, 64, 3), 95, "4:4:4", 0),
    ("rgb17x40_q75_422", (17, 40, 3), 75, "4:2:2", 0),
    ("gray45x31_q75", (45, 31), 75, "4:2:0", 0),
    ("rgb48_q90_rst3", (48, 48, 3), 90, "4:2:0", 3),
)
_PIL_SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def image(shape, seed: int) -> np.ndarray:
    """A seeded uint8 test image: gradients plus uniform noise."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * x // 5 + y) % 256, (y * 11) % 256], -1)
    img = ((base + rng.integers(0, 64, (h, w, 3))) % 256).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


def fixtures() -> dict:
    """``{name: {"jpeg": bytes, "pixels": ..., "decoded": ..., "quality",
    "subsampling", "restart_blocks"}}``, Pillow's encoding and decoding of
    each case."""
    from PIL import Image

    out = {}
    for i, (name, shape, quality, sub, rst) in enumerate(CASES):
        pixels = image(shape, seed=i)
        kw = {"quality": quality}
        if pixels.ndim == 3:       # Pillow's gray files keep 1x1 unless asked
            kw["subsampling"] = _PIL_SUBSAMPLING[sub]
        if rst:
            kw["restart_marker_blocks"] = rst
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        decoded = np.asarray(Image.open(io.BytesIO(data)))
        out[name] = {"jpeg": data, "pixels": pixels, "decoded": decoded, "quality": quality,
                     "subsampling": sub, "restart_blocks": rst}
    return out


def load(directory: str = OUT) -> dict:
    """The committed fixtures, in :func:`fixtures`' form (no PIL needed)."""
    with open(os.path.join(directory, "cases.json")) as fh:
        cases = json.load(fh)
    arrays = np.load(os.path.join(directory, "pixels.npz"))
    out = {}
    for name, meta in cases.items():
        with open(os.path.join(directory, f"{name}.jpg"), "rb") as fh:
            data = fh.read()
        out[name] = {"jpeg": data, "pixels": arrays[f"pixels_{name}"],
                     "decoded": arrays[f"decoded_{name}"], **meta}
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    fx = fixtures()
    arrays = {}
    for name, f in fx.items():
        with open(os.path.join(OUT, f"{name}.jpg"), "wb") as fh:
            fh.write(f["jpeg"])
        arrays[f"pixels_{name}"] = f["pixels"]
        arrays[f"decoded_{name}"] = f["decoded"]
    np.savez_compressed(os.path.join(OUT, "pixels.npz"), **arrays)
    with open(os.path.join(OUT, "cases.json"), "w") as fh:
        json.dump({name: {k: f[k] for k in ("quality", "subsampling", "restart_blocks")}
                   for name, f in fx.items()}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {len(fx)} fixtures to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
