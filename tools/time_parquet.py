#!/usr/bin/env python3
"""Time the port's Parquet reader on a Visium HD positions table.

Run from the root of a checkout (no card needed; it times the host)::

    python3 tools/time_parquet.py [--runs N]

Writes a 384 x 384 ``square_016um`` positions table (147,456 rows: the
barcode, ``in_tissue``, ``array_row``/``array_col`` and float pixel
centers, as ``chip_smoke.py`` phase 12 writes them) with the port's writer
into a temporary directory, then reads it with
``gridnext_tpu_torch.io.parquet.read_parquet`` ``--runs`` times as it is and
``--runs`` times with the fixed-length barcode path turned off (every
BYTE_ARRAY value read one at a time), alternating. Prints the median and
every run in ms, then one JSON line with them.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gridnext_tpu_torch.io import parquet  # noqa: E402

BINS = 384


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=7)
    args = ap.parse_args()
    row = np.repeat(np.arange(BINS, dtype=np.int64), BINS)
    col = np.tile(np.arange(BINS, dtype=np.int64), BINS)
    fixed = parquet._fixed_byte_arrays
    times = {"fixed-length path": [], "one value at a time": []}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tissue_positions.parquet")
        parquet.write_parquet(path, {
            "barcode": [f"s_016um_{r:05d}_{c:05d}-1" for r, c in zip(row, col)],
            "in_tissue": np.ones(BINS * BINS, np.int64), "array_row": row, "array_col": col,
            "pxl_row_in_fullres": 32.0 + (row + 0.5) * 58.46,
            "pxl_col_in_fullres": 32.0 + (col + 0.5) * 58.46})
        want = parquet.read_parquet(path)
        for _ in range(args.runs):
            for name, swap in (("fixed-length path", fixed),
                               ("one value at a time", lambda buf, count: None)):
                parquet._fixed_byte_arrays = swap
                try:
                    t0 = time.perf_counter()
                    got = parquet.read_parquet(path)
                    times[name].append(round((time.perf_counter() - t0) * 1e3, 2))
                finally:
                    parquet._fixed_byte_arrays = fixed
                if got["barcode"] != want["barcode"]:
                    raise AssertionError(f"{name}: the barcodes differ")
    out = {name: {"median_ms": float(np.median(t)), "runs_ms": t} for name, t in times.items()}
    for name, v in out.items():
        print(f"read_parquet, {BINS * BINS} rows, {name}: {v['median_ms']:.2f} ms "
              f"(runs {v['runs_ms']})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
