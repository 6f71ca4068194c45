#!/usr/bin/env python3
"""Write the Parquet reader's fixtures: small tables written by pyarrow in
every codec, page version and encoding the port reads, hand-made codec-5
(LZ4) files, slide E's full-width positions table in three codecs, and the
values pandas reads from each small file.

    python tools/make_parquet_fixtures.py        # writes tests/data/parquet/

The port's reader (``gridnext_tpu_torch/io/parquet.py`` over
``csrc/parquet_codec.cpp``) is held to pandas where pandas is absent (a GPU
machine) through these files: ``chip_smoke.py`` phase 23 (a) reads each
small file and compares it with ``<name>.npz``, which holds
``pd.read_parquet(<name>.parquet)`` column by column (string columns as
unicode arrays; ``bytes`` columns as ``<column>__bytes``, the values laid
end to end, and ``<column>__lengths``). ``cases.json`` lists the files
with what each exercises. Phase 23 (b) reads ``hd384_<codec>.parquet``,
which is ``chip_smoke.write_hd_dir``'s slide E table (384 x 384 bins)
rewritten by pyarrow with ZSTD, BROTLI and LZ4_RAW pages, and compares it
with the table phase 12 writes. ``tests/test_torch_parquet.py`` reads
every fixture against pandas and its ``.npz`` on the CPU.

pyarrow writes no codec-5 (deprecated LZ4) file, so :func:`write_pages`
assembles one: PLAIN pages compressed by ``compress`` under any codec id,
in the layout of ``io.parquet.write_parquet``. :func:`hadoop_lz4` frames
raw LZ4 blocks as Hadoop's codec does; both framings are read back by
pyarrow before they are kept.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "parquet")
# pandas' compression names of the codecs pyarrow writes (its "lz4" is LZ4_RAW)
CODECS = {"none": None, "snappy": "snappy", "gzip": "gzip", "brotli": "brotli",
          "zstd": "zstd", "lz4_raw": "lz4"}
HD_CODECS = {"zstd": "zstd", "brotli": "brotli", "lz4_raw": "lz4"}


def positions_frame(h: int, w: int, seed: int = 0, pitch: float = 58.46):
    """An HD-shaped positions table: a bin a row, real-HD barcode names."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(h), w)
    col = np.tile(np.arange(w), h)
    return pd.DataFrame({
        "barcode": [f"s_016um_{r:05d}_{c:05d}-1" for r, c in zip(row, col)],
        "in_tissue": (rng.random(h * w) < 0.6).astype(np.int64),
        "array_row": row, "array_col": col,
        "pxl_row_in_fullres": 31.7 + (row + 0.5) * pitch + rng.normal(0, 0.01, h * w),
        "pxl_col_in_fullres": 24.2 + (col + 0.5) * pitch})


def typed_table(n: int = 300, seed: int = 0):
    """Every physical type the reader takes: INT32, INT64, FLOAT, DOUBLE,
    BOOLEAN, strings (shared prefixes, non-ASCII) and bytes."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    return pa.table({
        "i32": pa.array(rng.integers(-2 ** 31, 2 ** 31, n), pa.int32()),
        "i64": pa.array(np.cumsum(rng.integers(-1000, 5000, n)) - 2 ** 40, pa.int64()),
        "f32": pa.array(rng.normal(0, 1e3, n), pa.float32()),
        "f64": pa.array(rng.normal(0, 1e6, n)),
        "flag": pa.array(rng.random(n) < 0.3),
        "text": pa.array([f"s_016um_{i // 7:05d}_{'ü' * (i % 3)}{i % 11}" for i in range(n)]),
        "raw": pa.array([bytes(rng.integers(0, 256, i % 9, dtype=np.uint8)) for i in range(n)],
                        pa.binary()),
    })


ENCODINGS = {
    "enc_delta": {"i32": "DELTA_BINARY_PACKED", "i64": "DELTA_BINARY_PACKED",
                  "text": "DELTA_LENGTH_BYTE_ARRAY", "raw": "DELTA_BYTE_ARRAY",
                  "f32": "BYTE_STREAM_SPLIT", "f64": "BYTE_STREAM_SPLIT"},
    "enc_split": {"i32": "BYTE_STREAM_SPLIT", "i64": "BYTE_STREAM_SPLIT",
                  "text": "DELTA_BYTE_ARRAY", "raw": "DELTA_LENGTH_BYTE_ARRAY", "flag": "RLE"},
}


def expected(path) -> dict:
    """``pd.read_parquet(path)`` as arrays an ``.npz`` holds without pickle."""
    import pandas as pd

    df = pd.read_parquet(path)
    out = {}
    for name in df.columns:
        col = df[name]
        if col.dtype.kind in "iufb":
            out[name] = col.to_numpy()
        elif all(isinstance(v, str) for v in col):
            out[name] = np.array(col.tolist(), dtype=str)
        else:
            vals = col.tolist()
            out[f"{name}__bytes"] = np.frombuffer(b"".join(vals), np.uint8)
            out[f"{name}__lengths"] = np.array([len(v) for v in vals], np.int64)
    return out


def expected_columns(npz) -> dict:
    """The ``{column: values}`` an ``.npz`` of :func:`expected` holds, in
    the reader's types (lists of ``str`` / ``bytes``, arrays)."""
    out = {}
    for key in npz.files:
        if key.endswith("__lengths"):
            continue
        if key.endswith("__bytes"):
            name = key[:-len("__bytes")]
            flat = npz[key].tobytes()
            ends = np.cumsum(npz[f"{name}__lengths"])
            out[name] = [flat[a:b] for a, b in zip((ends - npz[f"{name}__lengths"]).tolist(),
                                                    ends.tolist())]
        elif npz[key].dtype.kind == "U":
            out[key] = npz[key].tolist()
        else:
            out[key] = npz[key]
    return out


def hadoop_lz4(data: bytes, frames: int = 2) -> bytes:
    """``data`` as Hadoop's LZ4 codec frames it: ``frames`` pieces, each
    [big-endian u32 decompressed size][big-endian u32 compressed size][raw
    LZ4 block]."""
    import pyarrow as pa

    codec = pa.Codec("lz4_raw")
    step = -(-len(data) // frames) or 1
    out = bytearray()
    for i in range(0, max(len(data), 1), step):
        piece = data[i:i + step]
        block = codec.compress(piece, asbytes=True)
        out += len(piece).to_bytes(4, "big") + len(block).to_bytes(4, "big") + block
    return bytes(out)


def raw_lz4(data: bytes) -> bytes:
    import pyarrow as pa

    return pa.Codec("lz4_raw").compress(data, asbytes=True)


def write_pages(path, columns: dict, codec: int, compress) -> None:
    """``write_parquet``'s file (one row group, one PLAIN data page v1 a
    column, required columns) with every page body ``compress(plain)`` and
    the chunks' codec ``codec``."""
    from gridnext_tpu_torch.io import parquet as T

    n_rows = len(next(iter(columns.values())))
    out = bytearray(T.MAGIC)
    chunks, schema = [], [[(4, T._T_BINARY, "schema"), (5, T._T_I32, len(columns))]]
    total = 0
    for name, values in columns.items():
        ptype, plain, extra = T._column_bytes(name, values)
        body = compress(plain)
        page = [(1, T._T_I32, T.DATA_PAGE), (2, T._T_I32, len(plain)),
                (3, T._T_I32, len(body)),
                (5, T._T_STRUCT, [(1, T._T_I32, n_rows), (2, T._T_I32, T.PLAIN),
                                  (3, T._T_I32, T.RLE), (4, T._T_I32, T.RLE)])]
        header = T._encode_struct(page)
        offset = len(out)
        out += header + body
        size_c, size_u = len(header) + len(body), len(header) + len(plain)
        total += size_c
        chunks.append([(2, T._T_I64, offset), (3, T._T_STRUCT, [
            (1, T._T_I32, ptype), (2, T._T_LIST, (T._T_I32, [T.PLAIN, T.RLE])),
            (3, T._T_LIST, (T._T_BINARY, [name])), (4, T._T_I32, codec),
            (5, T._T_I64, n_rows), (6, T._T_I64, size_u), (7, T._T_I64, size_c),
            (9, T._T_I64, offset)])])
        schema.append(sorted([(1, T._T_I32, ptype), (3, T._T_I32, T.REQUIRED),
                              (4, T._T_BINARY, name)] + extra))
    row_group = [(1, T._T_LIST, (T._T_STRUCT, chunks)), (2, T._T_I64, total),
                 (3, T._T_I64, n_rows)]
    meta = T._encode_struct([(1, T._T_I32, 1), (2, T._T_LIST, (T._T_STRUCT, schema)),
                               (3, T._T_I64, n_rows),
                               (4, T._T_LIST, (T._T_STRUCT, [row_group])),
                               (6, T._T_BINARY, "gridnext_tpu_torch fixtures")])
    out += meta + len(meta).to_bytes(4, "little") + T.MAGIC
    with open(path, "wb") as fh:
        fh.write(out)


def codec5_columns(seed: int = 5) -> dict:
    df = positions_frame(9, 11, seed=seed)
    return {c: (df[c].tolist() if c == "barcode" else df[c].to_numpy()) for c in df.columns}


def fixtures(out_dir: str = OUT) -> dict:
    """Write every fixture into ``out_dir``; returns ``cases.json``'s dict."""
    import pandas as pd
    import pyarrow.parquet as pq

    sys.path.insert(0, REPO)
    os.makedirs(out_dir, exist_ok=True)
    cases = {}

    def keep(name, **what):
        path = os.path.join(out_dir, f"{name}.parquet")
        np.savez_compressed(os.path.join(out_dir, f"{name}.npz"), **expected(path))
        cases[name] = what

    df = positions_frame(12, 10, seed=1)
    for codec, comp in CODECS.items():
        for version in ("1.0", "2.0"):
            for dictionary in (True, False):
                name = f"{codec}_v{version[0]}_{'dict' if dictionary else 'plain'}"
                df.to_parquet(os.path.join(out_dir, f"{name}.parquet"), index=False,
                              compression=comp, data_page_version=version,
                              use_dictionary=dictionary, data_page_size=512)
                keep(name, codec=codec, page_version=int(version[0]), dictionary=dictionary)
    table = typed_table()
    for (name, encodings), (version, comp) in zip(ENCODINGS.items(),
                                                   (("2.0", "zstd"), ("1.0", "brotli"))):
        pq.write_table(table, os.path.join(out_dir, f"{name}.parquet"), use_dictionary=False,
                       column_encoding=encodings, data_page_version=version,
                       compression=comp, data_page_size=1024)
        keep(name, codec=comp, page_version=int(version[0]), encodings=encodings)
    pq.write_table(table, os.path.join(out_dir, "types_default.parquet"))
    keep("types_default", codec="snappy", page_version=1, dictionary=True)

    columns = codec5_columns()
    want = pd.DataFrame(columns)
    for name, compress in (("lz4_hadoop", hadoop_lz4), ("lz4_block", raw_lz4)):
        path = os.path.join(out_dir, f"{name}.parquet")
        write_pages(path, columns, 5, compress)
        pd.testing.assert_frame_equal(pd.read_parquet(path), want)
        keep(name, codec="lz4 (codec 5)", framing=name.split("_")[1], hand_made=True)

    with tempfile.TemporaryDirectory() as tmp:
        import chip_smoke

        srd, _ = chip_smoke.write_hd_dir(tmp, "hdE", chip_smoke.HD_PITCH_E,
                                         chip_smoke.HD_MARGIN_E)
        src = os.path.join(srd, "outs", "binned_outputs", chip_smoke.HD_BINNING, "spatial",
                           "tissue_positions.parquet")
        source = pq.read_table(src)
        for codec, comp in HD_CODECS.items():
            path = os.path.join(out_dir, f"hd384_{codec}.parquet")
            pq.write_table(source, path, compression=comp)
            if not pq.read_table(path).equals(source):
                raise SystemExit(f"{path} does not read back as slide E's table")
    with open(os.path.join(out_dir, "cases.json"), "w") as fh:
        json.dump(cases, fh, indent=1, sort_keys=True)
    return cases


def main() -> int:
    cases = fixtures()
    print(f"wrote {len(cases)} small fixtures and {len(HD_CODECS)} HD tables into {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
