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
with what each exercises, among them nulls (v1 and v2 pages, PLAIN,
dictionary and DELTA), INT96, FIXED_LEN_BYTE_ARRAY and DECIMAL columns;
:func:`write_optional` (numpy only) writes OPTIONAL columns with INT96 and
FLBA where pyarrow is absent. Phase 23 (b) reads ``hd384_<codec>.parquet``,
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


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def expected(path) -> dict:
    """``pd.read_parquet(path)`` as arrays an ``.npz`` holds without pickle:
    numeric and datetime columns as they are; object columns as their
    defined values (``<column>`` strings, ``<column>__bytes`` and
    ``__lengths``, ``<column>__bool`` or ``<column>__decimal`` as strings)
    and, where a value is missing, ``<column>__defined``."""
    import decimal

    import pandas as pd

    df = pd.read_parquet(path)
    out = {}
    for name in df.columns:
        col = df[name]
        if col.dtype.kind in "iufbM":
            out[name] = col.to_numpy()
            continue
        vals = col.tolist()
        defined = np.array([not _missing(v) for v in vals])
        if not defined.all():
            out[f"{name}__defined"] = defined
        vals = [v for v in vals if not _missing(v)]
        if all(isinstance(v, str) for v in vals):
            out[name] = np.array(vals, dtype=str)
        elif vals and all(isinstance(v, bool) for v in vals):
            out[f"{name}__bool"] = np.array(vals, bool)
        elif vals and all(isinstance(v, decimal.Decimal) for v in vals):
            out[f"{name}__decimal"] = np.array([str(v) for v in vals], dtype=str)
        else:
            out[f"{name}__bytes"] = np.frombuffer(b"".join(vals), np.uint8)
            out[f"{name}__lengths"] = np.array([len(v) for v in vals], np.int64)
    return out


def expected_columns(npz) -> dict:
    """The ``{column: values}`` an ``.npz`` of :func:`expected` holds, in
    the reader's types (lists of ``str`` / ``bytes`` / ``bool`` /
    ``Decimal``, arrays), each missing value as pandas gives it (NaN in a
    string column, None elsewhere)."""
    import decimal

    out = {}
    for key in npz.files:
        if key.endswith(("__lengths", "__defined")):
            continue
        name, _, kind = key.partition("__")
        if kind == "bytes":
            flat = npz[key].tobytes()
            ends = np.cumsum(npz[f"{name}__lengths"])
            vals = [flat[a:b] for a, b in zip((ends - npz[f"{name}__lengths"]).tolist(),
                                              ends.tolist())]
        elif kind == "bool":
            vals = npz[key].tolist()
        elif kind == "decimal":
            vals = [decimal.Decimal(v) for v in npz[key].tolist()]
        elif npz[key].dtype.kind == "U":
            vals = npz[key].tolist()
        else:
            out[key] = npz[key]
            continue
        if f"{name}__defined" in npz.files:
            missing = float("nan") if kind == "" else None
            it = iter(vals)
            vals = [next(it) if d else missing for d in npz[f"{name}__defined"].tolist()]
        out[name] = vals
    return out


def same_column(got, want) -> bool:
    """Whether a read column equals an expected one: arrays by value and
    dtype (NaN and NaT equal to themselves), lists value by value (a
    missing value equal to the same kind of missing value)."""
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and np.array_equal(got, want, equal_nan=want.dtype.kind in "fcM"))
    return (isinstance(got, list) and len(got) == len(want)
            and all(type(a) is type(b) and (a == b or (_missing(a) and _missing(b)))
                    for a, b in zip(got, want)))


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


def _levels(defined: np.ndarray) -> bytes:
    """Definition levels of bit width 1 in one bit-packed run of the
    RLE/bit-packed hybrid (groups of 8, the first value in bit 0)."""
    from gridnext_tpu_torch.io.parquet import _uvarint

    groups = -(-len(defined) // 8)
    bits = np.zeros(groups * 8, np.uint8)
    bits[:len(defined)] = defined
    return _uvarint((groups << 1) | 1) + np.packbits(bits, bitorder="little").tobytes()


def int96(ns: np.ndarray) -> np.ndarray:
    """datetime64[ns] values as INT96 (nanoseconds of the day, then the
    Julian day, little endian): (n, 12) uint8."""
    ns = np.asarray(ns, "datetime64[ns]").view(np.int64)
    day, nanos = np.divmod(ns, 86_400_000_000_000)
    out = np.empty((len(ns), 12), np.uint8)
    out[:, :8] = nanos.astype("<i8")[:, None].view(np.uint8)
    out[:, 8:] = (day + 2440588).astype("<i4")[:, None].view(np.uint8)
    return out


def write_optional(path, columns: dict, page_rows: int, versions=(1, 2)) -> None:
    """A Parquet file of OPTIONAL columns, one row group, UNCOMPRESSED PLAIN
    pages of ``page_rows`` rows, the pages' versions cycling through
    ``versions`` (v1: levels after a 4-byte length; v2: levels ahead of the
    values, counts in the header). ``columns``: ``{name: (values, defined)}``,
    ``defined`` a bool mask (None: no nulls) and ``values`` one a row (a
    null's value ignored): int32, int64 or float64 arrays, ``datetime64[ns]``
    arrays (written INT96), lists of ``str`` (UTF-8 BYTE_ARRAY) or lists of
    equal-length ``bytes`` (FIXED_LEN_BYTE_ARRAY). Needs numpy only: the
    card's machine rewrites positions with it."""
    from gridnext_tpu_torch.io import parquet as T

    n_rows = len(next(iter(columns.values()))[0])
    out = bytearray(T.MAGIC)
    chunks, schema = [], [[(4, T._T_BINARY, "schema"), (5, T._T_I32, len(columns))]]
    total = 0
    for name, (values, defined) in columns.items():
        defined = np.ones(n_rows, bool) if defined is None else np.asarray(defined, bool)
        extra = []
        if isinstance(values, np.ndarray) and values.dtype.kind == "M":
            ptype, cells = T.INT96, int96(values)
            plain = lambda idx: cells[idx].tobytes()                      # noqa: E731
        elif isinstance(values, np.ndarray):
            ptype = {np.dtype(np.int32): T.INT32, np.dtype(np.int64): T.INT64,
                     np.dtype(np.float64): T.DOUBLE}[values.dtype]
            arr = np.ascontiguousarray(values, T._PLAIN_DTYPES[ptype])
            plain = lambda idx, arr=arr: arr[idx].tobytes()               # noqa: E731
        elif isinstance(values[0], str):
            ptype, enc = T.BYTE_ARRAY, [v.encode() for v in values]
            plain = lambda idx, enc=enc: b"".join(                        # noqa: E731
                len(enc[i]).to_bytes(4, "little") + enc[i] for i in idx)
            extra = [(6, T._T_I32, T.UTF8), (10, T._T_STRUCT, [(1, T._T_STRUCT, [])])]
        else:
            ptype = T.FIXED_LEN_BYTE_ARRAY
            plain = lambda idx, vals=values: b"".join(vals[i] for i in idx)  # noqa: E731
            extra = [(2, T._T_I32, len(values[0]))]
        offset, size = len(out), 0
        for k, start in enumerate(range(0, n_rows, page_rows)):
            rows = np.arange(start, min(n_rows, start + page_rows))
            mask = defined[rows]
            levels, body = _levels(mask), plain(rows[mask].tolist())
            if versions[k % len(versions)] == 1:
                data = len(levels).to_bytes(4, "little") + levels + body
                page = [(1, T._T_I32, T.DATA_PAGE), (2, T._T_I32, len(data)),
                        (3, T._T_I32, len(data)),
                        (5, T._T_STRUCT, [(1, T._T_I32, len(rows)), (2, T._T_I32, T.PLAIN),
                                          (3, T._T_I32, T.RLE), (4, T._T_I32, T.RLE)])]
            else:
                data = levels + body
                page = [(1, T._T_I32, T.DATA_PAGE_V2), (2, T._T_I32, len(data)),
                        (3, T._T_I32, len(data)),
                        (8, T._T_STRUCT, [(1, T._T_I32, len(rows)),
                                          (2, T._T_I32, int((~mask).sum())),
                                          (3, T._T_I32, len(rows)), (4, T._T_I32, T.PLAIN),
                                          (5, T._T_I32, len(levels)), (6, T._T_I32, 0)])]
            header = T._encode_struct(page)
            out += header + data
            size += len(header) + len(data)
        total += size
        chunks.append([(2, T._T_I64, offset), (3, T._T_STRUCT, [
            (1, T._T_I32, ptype), (2, T._T_LIST, (T._T_I32, [T.PLAIN, T.RLE])),
            (3, T._T_LIST, (T._T_BINARY, [name])), (4, T._T_I32, 0),
            (5, T._T_I64, n_rows), (6, T._T_I64, size), (7, T._T_I64, size),
            (9, T._T_I64, offset)])])
        schema.append(sorted([(1, T._T_I32, ptype), (3, T._T_I32, T.OPTIONAL),
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


def optional_positions(table: dict, seed: int = 0) -> dict:
    """``write_optional``'s columns of a positions table (``read_parquet``'s
    ``{name: values}``): the six columns with no null, then an extra DOUBLE
    column with nulls, an INT96 acquisition time and a 16-byte
    FIXED_LEN_BYTE_ARRAY bin id."""
    n = len(table["barcode"])
    rng = np.random.default_rng(seed)
    out = {name: (values, None) for name, values in table.items()}
    out["qc_score"] = (rng.random(n), rng.random(n) > 0.3)
    out["acquired"] = (np.datetime64("2024-03-01T08:00", "ns")
                       + rng.integers(0, 10 ** 15, n).astype("timedelta64[ns]"), None)
    out["bin_id"] = ([i.to_bytes(8, "big") * 2 for i in range(n)], None)
    return out


def null_typed_table(n: int = 300, seed: int = 0):
    """:func:`typed_table` with about a fifth of every column null."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    table = typed_table(n, seed)
    return pa.table({name: pa.array(table[name].to_pylist(), table[name].type,
                                    mask=rng.random(n) < 0.2) for name in table.column_names})


def wide_types_table(n: int = 200, seed: int = 0):
    """INT96 timestamps (pyarrow's deprecated writer), FIXED_LEN_BYTE_ARRAY
    bytes and DECIMAL (FLBA and INT32), each with nulls, and the same
    without nulls."""
    import decimal

    import pyarrow as pa

    rng = np.random.default_rng(seed)
    null = lambda: rng.random(n) < 0.2                                      # noqa: E731
    ns = rng.integers(-10 ** 17, 10 ** 18, n)
    units = rng.integers(-10 ** 8, 10 ** 8, n)
    return pa.table({
        "when": pa.array(ns, pa.timestamp("ns"), mask=null()),
        "when_all": pa.array(ns, pa.timestamp("ns")),
        "fixed": pa.array([bytes(rng.integers(0, 256, 6, dtype=np.uint8)) for _ in range(n)],
                          pa.binary(6), mask=null()),
        "price": pa.array([decimal.Decimal(int(u)).scaleb(-3) for u in units],
                          pa.decimal128(12, 3), mask=null()),
        "small": pa.array([decimal.Decimal(int(u) // 100).scaleb(-2) for u in units],
                          pa.decimal128(7, 2)),
    })


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
    nulls = null_typed_table(400, seed=7)
    for name, kw in (("nulls_v1_dict", {"compression": "snappy"}),
                     ("nulls_v2_plain", {"data_page_version": "2.0", "use_dictionary": False,
                                         "compression": "zstd"}),
                     ("nulls_delta", {"data_page_version": "2.0", "use_dictionary": False,
                                      "column_encoding": ENCODINGS["enc_delta"],
                                      "compression": "gzip"})):
        pq.write_table(nulls, os.path.join(out_dir, f"{name}.parquet"), data_page_size=700,
                       **kw)
        keep(name, nulls=True, **{k: str(v) for k, v in kw.items()})
    wide = wide_types_table(200, seed=8)
    for name, kw in (("int96_flba_v1", {"compression": "brotli"}),
                     ("int96_flba_v2_plain", {"data_page_version": "2.0",
                                              "use_dictionary": False,
                                              "store_decimal_as_integer": True})):
        pq.write_table(wide, os.path.join(out_dir, f"{name}.parquet"),
                       use_deprecated_int96_timestamps=True, data_page_size=600, **kw)
        keep(name, types="INT96, FIXED_LEN_BYTE_ARRAY, DECIMAL", **{k: str(v)
                                                                   for k, v in kw.items()})
    write_optional(os.path.join(out_dir, "positions_optional.parquet"),
                   optional_positions(codec5_columns(seed=9), seed=9), page_rows=40)
    keep("positions_optional", hand_made=True,
         what="OPTIONAL positions in v1 and v2 pages, nulls, INT96 and FLBA columns")

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
