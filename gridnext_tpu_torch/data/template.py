"""The real Visium v1 slide template: the barcode <-> lattice whitelist.

Visium v1 slides carry a fixed 78 x 64 pseudo-hex lattice of 4,992 spots,
each with a fixed 16-mer barcode assigned at manufacture; the port ships
its own copy of the asset (``assets/visium_v1_template/``) and reads it
with the standard library. The port of the JAX package's
``data/template.py``: columns ``barcode, in_tissue, array_row, array_col,
pxl_row_in_fullres, pxl_col_in_fullres`` (the Spaceranger v2 contract);
``in_tissue`` is the template's capture-area pattern (4,525 of 4,992).
"""

from __future__ import annotations

import csv
import gzip
import io
import json
from pathlib import Path

import numpy as np

from gridnext_tpu_torch import geometry

TEMPLATE_DIR = Path(__file__).resolve().parents[1] / "assets" / "visium_v1_template"


def visium_v1_template() -> dict:
    """The template's positions: ``{"barcode": str array, <field>: int64
    array}`` in file order, 4,992 rows."""
    raw = gzip.decompress((TEMPLATE_DIR / "tissue_positions.csv.gz").read_bytes())
    rows = list(csv.reader(io.StringIO(raw.decode())))
    header, body = rows[0], [r for r in rows[1:] if r]
    out = {"barcode": np.array([r[0] for r in body])}
    for i, name in enumerate(header[1:], start=1):
        out[name] = np.array([int(r[i]) for r in body], np.int64)
    return out


def visium_v1_scalefactors() -> dict:
    """The template's ``scalefactors_json.json`` as a dict."""
    return json.loads((TEMPLATE_DIR / "scalefactors_json.json").read_text())


def visium_v1_barcode_grid() -> np.ndarray:
    """(78, 64) object array: ``grid[oddr_y, oddr_x]`` is the real slide
    barcode of that lattice cell."""
    pos = visium_v1_template()
    ox, oy = geometry.pseudo_hex_to_oddr(pos["array_col"], pos["array_row"])
    grid = np.empty((geometry.VISIUM_H_ST, geometry.VISIUM_W_ST), dtype=object)
    grid[oy, ox] = pos["barcode"]
    return grid
