#!/usr/bin/env python3
"""Write the orbax fixture: a JAX TrainState checkpoint written by the JAX
package's ``save_checkpoint_orbax``, and JAX's labels of a slide.

    python tools/make_orbax_fixture.py        # writes tests/data/orbax/

Runs on the CPU with JAX, flax, optax and orbax. The state is a small
GridNetHex (a ``TpuPatchClassifier`` f of one 16-wide stage, stem 4, RMS
norm, 16-px patches; the BatchNorm hex corrector) with
``make_gridwise_optimizer(1e-3, f_lr=1e-4)``: initialised from
``jax.random.key(SEED)``, every Adam moment drawn from a numpy seed and
each count 5, step 11. The slide is :func:`slide` (numpy seed) over the
78 x 64 lattice of :func:`positions_rows` at a 17-px pitch, an elliptical
tissue mask; JAX's ``SlideRegistrar`` (no normalisation) registers it and
``labels.json`` holds the (78, 64) labels, the classes and the smallest
top-2 logit gap over the tissue.

``chip_smoke.py`` phase 26 (b) restores the checkpoint into the port on
the card (no orbax, no tensorstore there), registers the same slide and
requires JAX's labels; it builds the slide and the positions file with
this module's numpy-only helpers.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "orbax")
N_CLASSES = 4
PATCH = 16
PITCH = 17
MARGIN = 16
F_ARCH = {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"}
LR, F_LR = 1e-3, 1e-4
SEED = 26
TISSUE = 0.7


def positions_rows():
    """(barcode, in_tissue, array_row, array_col, pxl_row, pxl_col) rows of
    the 78 x 64 lattice, spot ``i`` at odd-right cell ``divmod(i, 64)``."""
    sys.path.insert(0, REPO)
    from gridnext_tpu_torch import geometry

    h, w = geometry.VISIUM_H_ST, geometry.VISIUM_W_ST
    rows = np.repeat(np.arange(h), w)
    cols = np.tile(np.arange(w), h)
    x, y = geometry.oddr_to_cartesian(cols, rows)
    y_px = np.rint(y * PITCH).astype(np.int64) + MARGIN
    x_px = np.rint(x * PITCH).astype(np.int64) + MARGIN
    r2 = (((x - x.mean()) / ((x.max() - x.min()) / 2 * TISSUE)) ** 2
          + ((y - y.mean()) / ((y.max() - y.min()) / 2 * TISSUE)) ** 2)
    array_col, array_row = geometry.oddr_to_pseudo_hex(cols, rows)
    return [(f"ORBX{i:05d}-1", int(r2[i] <= 1.0), int(array_row[i]), int(array_col[i]),
             int(y_px[i]), int(x_px[i])) for i in range(h * w)]


def write_spaceranger_dir(root) -> str:
    """A Spaceranger v2 directory holding only the positions file."""
    sr_dir = os.path.join(str(root), "orbax_slide")
    os.makedirs(os.path.join(sr_dir, "outs", "spatial"), exist_ok=True)
    with open(os.path.join(sr_dir, "outs", "spatial", "tissue_positions.csv"), "w",
              newline="") as fh:
        out = csv.writer(fh)
        out.writerow(["barcode", "in_tissue", "array_row", "array_col",
                      "pxl_row_in_fullres", "pxl_col_in_fullres"])
        out.writerows(positions_rows())
    return sr_dir


def slide() -> np.ndarray:
    """The (H, W, 3) uint8 slide: 8-px colour blocks under pixel noise."""
    rows = positions_rows()
    h = max(r[4] for r in rows) + MARGIN
    w = max(r[5] for r in rows) + MARGIN
    rng = np.random.default_rng(SEED)
    blocks = rng.integers(0, 256, (-(-h // 8), -(-w // 8), 3), dtype=np.uint8)
    big = blocks.repeat(8, 0).repeat(8, 1)[:h, :w]
    return (big // 2 + rng.integers(0, 128, (h, w, 3), dtype=np.uint8)).astype(np.uint8)


def load() -> dict:
    """The committed labels and the checkpoint's path."""
    with open(os.path.join(OUT, "labels.json")) as fh:
        out = json.load(fh)
    out["labels"] = np.asarray(out["labels"], np.int64)
    out["checkpoint"] = os.path.join(OUT, "ckpt")
    return out


def write(out_dir: str = OUT) -> dict:
    """Write ``ckpt/`` and ``labels.json`` under ``out_dir``."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from flax.serialization import from_state_dict, to_state_dict

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from gridnext_tpu.io import read_positions
    from gridnext_tpu.models import GridNetHex, TpuPatchClassifier
    from gridnext_tpu.serving import SlideRegistrar
    from gridnext_tpu.train.loops import create_train_state, make_gridwise_optimizer
    from gridnext_tpu.train.orbax_io import save_checkpoint_orbax

    arch = dict(stages=tuple(tuple(s) for s in F_ARCH["stages"]),
                stem_patch=F_ARCH["stem_patch"], norm=F_ARCH["norm"])
    model = GridNetHex(patch_classifier=TpuPatchClassifier(n_classes=N_CLASSES, **arch),
                       n_classes=N_CLASSES)
    tx = make_gridwise_optimizer(LR, f_lr=F_LR)
    state = create_train_state(model, jax.random.key(SEED),
                               jnp.zeros((1, 2, 2, PATCH, PATCH, 3), jnp.float32), tx)
    rng = np.random.default_rng(SEED)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind == "i":
            return np.full(a.shape, 5, a.dtype)
        return (np.abs(rng.normal(size=a.shape)) * 1e-3).astype(a.dtype)

    stats = {k: {n: {"mean": (rng.normal(size=v["mean"].shape) * 0.1).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32)}
                 for n, v in bn.items()} for k, bn in state.batch_stats.items()}
    state = state.replace(
        opt_state=from_state_dict(state.opt_state,
                                  jax.tree.map(draw, to_state_dict(state.opt_state))),
        batch_stats=stats, step=jnp.asarray(11, jnp.int32))
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, "ckpt")
    if os.path.isdir(ckpt):
        shutil.rmtree(ckpt)
    save_checkpoint_orbax(ckpt, state)

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    reg = SlideRegistrar.from_gridnet(model, variables, patch_size=PATCH, normalize=None,
                                      patch_chunk=1024, extractor="xla")
    with tempfile.TemporaryDirectory() as tmp:
        positions = read_positions(write_spaceranger_dir(tmp))
    logits, fg = reg.register_logits(jnp.asarray(slide()), positions)
    logits, fg = np.asarray(logits), np.asarray(fg)
    labels = np.where(fg > 0, logits.argmax(-1) + 1, 0)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0])[fg > 0].min())
    meta = {"model": "GridNetHex+TpuPatchClassifier", "tpu_f": F_ARCH, "patch_px": PATCH,
            "classes": [f"Class_{i + 1}" for i in range(N_CLASSES)], "lr": LR, "f_lr": F_LR,
            "step": 11, "smallest_top2_gap": gap, "labels": labels.tolist()}
    with open(os.path.join(out_dir, "labels.json"), "w") as fh:
        json.dump(meta, fh)
    return {"spots": int((fg > 0).sum()), "smallest_top2_gap": gap,
            "bytes": sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(out_dir) for f in fs)}


if __name__ == "__main__":
    print(json.dumps(write()))
