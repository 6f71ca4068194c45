"""The port's Parquet reader and writer against pandas and pyarrow.

The card has neither, so the port reads Visium HD positions with
``gridnext_tpu_torch.io.parquet`` (the standard library and numpy). Here,
files that ``DataFrame.to_parquet`` writes in every layout a positions file
may take (snappy, the default; gzip; uncompressed; no dictionary; several
row groups; data page v2; a 384 x 384 HD table) must read back equal to
``pd.read_parquet``; the port's writer must read back equal in pandas; a
zstd file, a null value and a nested column must raise errors that name
them. This is the only test file that imports pandas and pyarrow for the
port.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.io.spaceranger import hd_lattice_dims as jax_hd_dims
from gridnext_tpu_torch.io import (cohort_hd_lattice_dims, find_position_file,
                                   hd_lattice_dims, read_positions, read_positions_file)
from gridnext_tpu_torch.io.parquet import (ParquetError, read_parquet, snappy_decompress,
                                           write_parquet)

COLUMNS = ("barcode", "in_tissue", "array_row", "array_col", "pxl_row_in_fullres",
           "pxl_col_in_fullres")


def positions_frame(h, w, seed=0, pitch=58.46):
    """An HD-shaped positions table: a bin a row, real-HD barcode names."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(h), w)
    col = np.tile(np.arange(w), h)
    return pd.DataFrame({
        "barcode": [f"s_016um_{r:05d}_{c:05d}-1" for r, c in zip(row, col)],
        "in_tissue": (rng.random(h * w) < 0.6).astype(np.int64),
        "array_row": row, "array_col": col,
        "pxl_row_in_fullres": 31.7 + (row + 0.5) * pitch + rng.normal(0, 0.01, h * w),
        "pxl_col_in_fullres": 24.2 + (col + 0.5) * pitch})


def assert_read_equal(path):
    got = read_parquet(path)
    want = pd.read_parquet(path)
    assert list(got) == list(want.columns)
    for name in want.columns:
        if want[name].dtype.kind in "iufb":
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name].to_numpy())
        else:
            assert got[name] == want[name].tolist(), name


@pytest.mark.parametrize("kw", [
    {},                                            # snappy, dictionary pages, v1
    {"compression": "gzip"},
    {"compression": None},
    {"use_dictionary": False},
    {"row_group_size": 97},
    {"data_page_version": "2.0"},
    {"data_page_version": "2.0", "compression": "gzip", "row_group_size": 130},
], ids=["snappy", "gzip", "uncompressed", "plain", "row_groups", "page_v2",
        "page_v2_gzip_row_groups"])
def test_pandas_files_read_equal(tmp_path, kw):
    df = positions_frame(23, 19, seed=1)
    # several data pages a column chunk too
    df.to_parquet(tmp_path / "p.parquet", index=False, data_page_size=512, **kw)
    assert_read_equal(tmp_path / "p.parquet")


def test_hd_capture_area_table(tmp_path):
    """A 384 x 384 bin table (147,456 rows, the 16 um capture area) in
    pandas' default layout, through ``read_positions_file``."""
    df = positions_frame(384, 384, seed=2)
    path = tmp_path / "tissue_positions.parquet"
    df.to_parquet(path, index=False)
    assert_read_equal(path)
    pos = read_positions_file(path)
    want = pd.read_parquet(path).set_index("barcode")
    assert pos.barcodes == list(want.index) and len(pos.barcodes) == 147456
    for name in COLUMNS[1:]:
        assert pos[name].dtype == (np.int64 if name in COLUMNS[1:4] else np.float64)
        np.testing.assert_array_equal(pos[name], want[name].to_numpy())


def test_mixed_types_and_strings(tmp_path):
    """INT32, bytes, strings of several lengths and non-ASCII text (the
    general BYTE_ARRAY path), optional and required; other physical types
    raise, naming the type."""
    table = pa.table({
        "i32": pa.array([3, -7, 2 ** 30, 0], pa.int32()),
        "raw": pa.array([b"\x00\x01", b"", b"abc", b"\xff"], pa.binary()),
        "text": pa.array(["a", "béc", "", "long string here"]),
        "req": pa.array([1, 2, 3, 4], pa.int64()),
    }, schema=pa.schema([("i32", pa.int32()), ("raw", pa.binary()), ("text", pa.string()),
                         pa.field("req", pa.int64(), nullable=False)]))
    for kw in ({}, {"use_dictionary": False, "compression": "gzip"}):
        pq.write_table(table, tmp_path / "t.parquet", **kw)
        got = read_parquet(tmp_path / "t.parquet")
        assert got["i32"].dtype == np.int32
        np.testing.assert_array_equal(got["i32"], [3, -7, 2 ** 30, 0])
        assert got["raw"] == [b"\x00\x01", b"", b"abc", b"\xff"]
        assert got["text"] == ["a", "béc", "", "long string here"]
        np.testing.assert_array_equal(got["req"], [1, 2, 3, 4])
    assert list(read_parquet(tmp_path / "t.parquet", columns=("text", "i32"))) == \
        ["text", "i32"]
    for name, column in (("FLOAT", pa.array([1.5], pa.float32())),
                         ("BOOLEAN", pa.array([True]))):
        pq.write_table(pa.table({"x": column}), tmp_path / "o.parquet")
        with pytest.raises(ParquetError, match=name):
            read_parquet(tmp_path / "o.parquet")


def test_writer_reads_back_in_pandas(tmp_path):
    df = positions_frame(37, 41, seed=3)
    path = tmp_path / "w.parquet"
    write_parquet(path, {c: (df[c].tolist() if c == "barcode" else df[c].to_numpy())
                         for c in df.columns})
    back = pd.read_parquet(path)
    pd.testing.assert_frame_equal(back, df)
    assert pq.ParquetFile(path).metadata.num_row_groups == 1
    assert_read_equal(path)
    write_parquet(path, {"a": np.arange(5, dtype=np.int32), "b": ["x"] * 5})
    assert pd.read_parquet(path)["a"].dtype == np.int32
    with pytest.raises(ValueError, match="different lengths"):
        write_parquet(path, {"a": np.arange(3), "b": ["x"]})
    with pytest.raises(ValueError, match="dtype"):
        write_parquet(path, {"a": np.arange(3, dtype=np.int16)})


def test_refusals_name_what_they_refuse(tmp_path):
    df = positions_frame(5, 4)
    df.to_parquet(tmp_path / "z.parquet", index=False, compression="zstd")
    with pytest.raises(ParquetError, match="ZSTD"):
        read_parquet(tmp_path / "z.parquet")
    nulls = df.astype({"in_tissue": "float64"})
    nulls.loc[3, "in_tissue"] = np.nan
    for version in ("1.0", "2.0"):
        nulls.to_parquet(tmp_path / "n.parquet", index=False, data_page_version=version)
        with pytest.raises(ParquetError, match="null"):
            read_parquet(tmp_path / "n.parquet")
    pq.write_table(pa.table({"s": pa.array([{"a": 1}, {"a": 2}])}), tmp_path / "s.parquet")
    with pytest.raises(ParquetError, match="nested"):
        read_parquet(tmp_path / "s.parquet")
    (tmp_path / "x.parquet").write_bytes(b"not a parquet file")
    with pytest.raises(ParquetError, match="PAR1"):
        read_parquet(tmp_path / "x.parquet")
    with pytest.raises(ParquetError, match="no column"):
        read_parquet(tmp_path / "z.parquet", columns=("missing",))


def test_snappy_decoder_back_references():
    """Literals, 1-, 2- and 4-byte-offset copies and overlapping copies (a
    repeated pattern), in a hand-built block."""
    block = bytes([26,                       # 26 bytes out
                   0x0C, *b"abcd",          # literal of 4 (len - 1 = 3 << 2)
                   0x01 | (2 << 2), 4,      # copy, 1-byte offset 4, length 6: abcdab
                   0x02 | (5 << 2), 10, 0,  # copy, 2-byte offset 10, length 6
                   0x03 | (9 << 2), 1, 0, 0, 0])   # copy, offset 1, length 10 (overlap)
    want = b"abcd" + b"abcdab" + b"abcdab" + b"b" * 10
    assert snappy_decompress(block) == want
    with pytest.raises(ParquetError, match="SNAPPY"):
        snappy_decompress(bytes([4, 0x05, 9]))       # a copy before the start


def test_hd_positions_and_lattice_dims_match_jax(tmp_path):
    """``find_position_file`` / ``read_positions`` / ``hd_lattice_dims`` on
    Spaceranger HD layouts, against the JAX package (which reads with
    pandas)."""
    from gridnext_tpu.data import simulate_spaceranger_dir

    dirs = []
    for i, grid in enumerate(((12, 9), (8, 14))):
        sim = simulate_spaceranger_dir(tmp_path / f"hd{i}", seed=i, n_genes=4, n_classes=3,
                                       spaceranger_version="hd", hd_grid=grid,
                                       hd_binning="square_016um")
        dirs.append(sim["spaceranger_dir"])
        assert find_position_file(dirs[-1], "square_016um").endswith(
            "binned_outputs/square_016um/spatial/tissue_positions.parquet")
        pos = read_positions(dirs[-1], "square_016um")
        want = jax_read_positions(dirs[-1], hd_binning="square_016um")
        assert pos.barcodes == list(want.index)
        for name in COLUMNS[1:]:
            np.testing.assert_array_equal(pos[name], want[name].to_numpy())
        assert hd_lattice_dims(dirs[-1], "square_016um") == \
            jax_hd_dims(dirs[-1], "square_016um") == grid
    assert cohort_hd_lattice_dims(dirs, "square_016um") == (12, 14)
    with pytest.raises(ValueError, match="square_008um"):
        find_position_file(dirs[0], "square_008um")
