"""The port's Parquet reader and writer against pandas and pyarrow.

The card has neither, so the port reads Visium HD positions with
``gridnext_tpu_torch.io.parquet`` (the standard library, numpy and the
port's own codecs, ``csrc/parquet_codec.cpp``). Here, files that
``DataFrame.to_parquet`` and ``pq.write_table`` write in every layout a
positions file may take (snappy, the default; gzip; uncompressed; zstd,
brotli and lz4, each with page v1 and v2, dictionary or plain; several row
groups; the DELTA and BYTE_STREAM_SPLIT encodings; FLOAT and BOOLEAN
columns; a 384 x 384 HD table) must read back equal to
``pd.read_parquet``, and so must every committed fixture of
``tools/make_parquet_fixtures.py`` (against pandas and its ``.npz``); the
port's writer must read back equal in pandas; an LZO chunk, a ZSTD frame
that names a dictionary, INT96 and FIXED_LEN_BYTE_ARRAY columns, a null
value and a nested column must raise errors that name them; and an HD
directory with ZSTD positions must read and register as in the JAX
package. ``tests/test_torch_parquet_codecs.py`` holds the decoders
themselves. These two files and the fixture tool are the only ones that
import pandas and pyarrow for the port.
"""

import csv
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

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

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "parquet"


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_parquet_fixtures", REPO / "tools" / "make_parquet_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
CODEC_IDS = {"snappy": 1, "gzip": 2, "brotli": 4, "zstd": 6, "lz4_raw": 7}


def _codec_ids(path) -> set:
    """The codec ids of a file's column chunks, from its footer (pyarrow's
    metadata names LZ4_RAW "LZ4")."""
    from gridnext_tpu_torch.io.parquet import _CompactReader

    data = Path(path).read_bytes()
    meta = _CompactReader(data, len(data) - 8 - int.from_bytes(data[-8:-4], "little")).struct()
    return {chunk[3].get(4, 0) for group in meta[4] for chunk in group[1]}

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
    """``read_parquet`` equals ``pd.read_parquet`` column for column: dtype
    and values of numeric and datetime columns (NaN and NaT where pandas
    has them), the objects of the others (NaN or None where pandas has
    them)."""
    got = read_parquet(path)
    want = pd.read_parquet(path)
    assert list(got) == list(want.columns)
    for name in want.columns:
        col = want[name]
        expect = col.to_numpy() if col.dtype.kind in "iufbM" else col.tolist()
        assert TOOL.same_column(got[name], expect), name


@pytest.mark.parametrize("kw", [
    {},                                            # snappy, dictionary pages, v1
    {"compression": "gzip"},
    {"compression": None},
    {"use_dictionary": False},
    {"row_group_size": 97},
    {"data_page_version": "2.0"},
    {"data_page_version": "2.0", "compression": "gzip", "row_group_size": 130},
] + [{"compression": codec, "data_page_version": version, "use_dictionary": dictionary}
     for codec in ("zstd", "brotli", "lz4") for version in ("1.0", "2.0")
     for dictionary in (True, False)],
    ids=["snappy", "gzip", "uncompressed", "plain", "row_groups", "page_v2",
         "page_v2_gzip_row_groups"] + [
        f"{codec}_v{version}_{kind}" for codec in ("zstd", "brotli", "lz4")
        for version in (1, 2) for kind in ("dict", "plain")])
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
    general BYTE_ARRAY path), optional and required; FLOAT and BOOLEAN read
    as pandas reads them; INT96 and FIXED_LEN_BYTE_ARRAY, once refused,
    read as pandas reads them."""
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
    for column in (pa.array([1.5, -2.25, 3e38], pa.float32()),
                   pa.array([True, False, True, True, False, False, False, True, True])):
        pq.write_table(pa.table({"x": column}), tmp_path / "o.parquet")
        assert_read_equal(tmp_path / "o.parquet")
    for name, table, kw in (
            ("INT96", pa.table({"t": pa.array([0, 10 ** 9], pa.timestamp("ns"))}),
             {"use_deprecated_int96_timestamps": True}),
            ("FIXED_LEN_BYTE_ARRAY", pa.table({"f": pa.array([b"ab", b"cd"], pa.binary(2))}),
             {})):
        pq.write_table(table, tmp_path / "o.parquet", **kw)
        assert pq.ParquetFile(tmp_path / "o.parquet").schema.column(0).physical_type == name
        assert_read_equal(tmp_path / "o.parquet")


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
    columns = {c: (df[c].tolist() if c == "barcode" else df[c].to_numpy()) for c in df.columns}
    TOOL.write_pages(tmp_path / "lzo.parquet", columns, 3, lambda plain: plain)   # LZO's id
    with pytest.raises(OSError):
        pd.read_parquet(tmp_path / "lzo.parquet")
    with pytest.raises(ParquetError, match="codec LZO is not supported"):
        read_parquet(tmp_path / "lzo.parquet")

    def zstd_with_dictionary(plain):        # one raw block in a frame naming dictionary 42
        return ((0xFD2FB528).to_bytes(4, "little") + bytes([0x01, 0x00, 42])
                + (1 | (len(plain) << 3)).to_bytes(3, "little") + plain)

    TOOL.write_pages(tmp_path / "zd.parquet", columns, 6, zstd_with_dictionary)
    with pytest.raises(ParquetError, match="ZSTD page: refused: .*dictionary ID 42"):
        read_parquet(tmp_path / "zd.parquet")
    nulls = df.astype({"in_tissue": "float64"})
    nulls.loc[3, "in_tissue"] = np.nan
    for version in ("1.0", "2.0"):        # nulls, once refused: pandas' NaN
        nulls.to_parquet(tmp_path / "n.parquet", index=False, data_page_version=version)
        assert_read_equal(tmp_path / "n.parquet")
        assert np.isnan(read_parquet(tmp_path / "n.parquet")["in_tissue"][3])
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


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("encodings", sorted(TOOL.ENCODINGS))
def test_encodings_read_equal(encodings, version, tmp_path):
    """DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY,
    BYTE_STREAM_SPLIT and RLE booleans, over INT32, INT64, FLOAT, DOUBLE,
    BOOLEAN, string and bytes columns, several pages a chunk."""
    path = tmp_path / "e.parquet"
    for n, compression in ((300, None), (1, "zstd"), (2000, "snappy")):
        pq.write_table(TOOL.typed_table(n, seed=n), path, use_dictionary=False,
                       column_encoding=TOOL.ENCODINGS[encodings], data_page_version=version,
                       compression=compression, data_page_size=700)
        meta = pq.ParquetFile(path).metadata.row_group(0)
        used = {meta.column(i).path_in_schema: meta.column(i).encodings
                for i in range(meta.num_columns)}
        assert all(enc in used[col] for col, enc in TOOL.ENCODINGS[encodings].items())
        assert_read_equal(path)
    pq.write_table(pa.table({"x": pa.array([1, None, 3], pa.int32())}), path,
                   use_dictionary=False, column_encoding={"x": "DELTA_BINARY_PACKED"},
                   data_page_version=version)
    assert_read_equal(path)
    np.testing.assert_array_equal(read_parquet(path)["x"], [1, np.nan, 3])


def _fixture_names():
    return sorted(json.loads((FIXTURES / "cases.json").read_text()))


@pytest.mark.parametrize("name", _fixture_names())
def test_committed_fixtures_read_equal(name):
    """Each committed fixture reads equal to pandas and to the ``.npz`` the
    fixture tool wrote beside it (what the card checks in chip_smoke's phase
    23 (a))."""
    path = FIXTURES / f"{name}.parquet"
    assert_read_equal(path)
    got = read_parquet(path)
    want = TOOL.expected_columns(np.load(FIXTURES / f"{name}.npz"))
    assert list(got) == list(want)
    for col, values in want.items():
        assert TOOL.same_column(got[col], values), col


def test_hd_fixture_tables_equal_the_writers(tmp_path):
    """``hd384_{zstd,brotli,lz4_raw}.parquet`` read equal, column for column,
    to the table chip_smoke's ``write_hd_dir`` writes for slide E."""
    import chip_smoke

    srd, _ = chip_smoke.write_hd_dir(str(tmp_path), "hdE", chip_smoke.HD_PITCH_E,
                                     chip_smoke.HD_MARGIN_E)
    want = read_parquet(find_position_file(srd, chip_smoke.HD_BINNING))
    for codec in TOOL.HD_CODECS:
        path = FIXTURES / f"hd384_{codec}.parquet"
        assert _codec_ids(path) == {CODEC_IDS[codec]}
        got = read_parquet(path)
        assert list(got) == list(want) and got["barcode"] == want["barcode"]
        for col in list(want)[1:]:
            assert got[col].dtype == want[col].dtype
            np.testing.assert_array_equal(got[col], want[col])


def _zstd_positions(srd, boolean_tissue=True):
    """Rewrite an HD directory's positions with ZSTD pages (and a BOOLEAN
    ``in_tissue``, as some writers store it)."""
    path = Path(find_position_file(srd, "square_016um"))
    df = pd.read_parquet(path)
    if boolean_tissue:
        df["in_tissue"] = df["in_tissue"].astype(bool)
    df.to_parquet(path, index=False, compression="zstd")
    assert _codec_ids(path) == {CODEC_IDS["zstd"]}


def _optional_positions(srd):
    """Rewrite an HD directory's positions with ``write_optional``: OPTIONAL
    columns in v1 and v2 pages, an extra column with nulls, an INT96 and a
    FIXED_LEN_BYTE_ARRAY column."""
    path = Path(find_position_file(srd, "square_016um"))
    TOOL.write_optional(path, TOOL.optional_positions(read_parquet(path)), page_rows=100)
    md = pq.ParquetFile(path).metadata
    assert {md.schema.column(i).physical_type for i in range(md.num_columns)} >= {
        "INT96", "FIXED_LEN_BYTE_ARRAY"}
    assert pd.read_parquet(path)["qc_score"].isna().any()


def test_hd_zstd_positions_and_register_match_jax(tmp_path):
    """An HD directory whose positions parquet has ZSTD pages and a BOOLEAN
    ``in_tissue``: ``read_positions`` equals the JAX package's, and
    ``register --device cpu`` of a JAX-written HD model directory (24 x 24
    bins) writes the Loupe CSV that the JAX package's ``register`` writes."""
    _hd_register_matches_jax(tmp_path, _zstd_positions, bool)


def test_hd_optional_positions_with_int96_and_flba_register_match_jax(tmp_path):
    """The same with positions in OPTIONAL columns over v1 and v2 pages,
    beside an extra column with nulls, an INT96 and a FIXED_LEN_BYTE_ARRAY
    column (``write_optional``)."""
    _hd_register_matches_jax(tmp_path, _optional_positions, np.int64)


def test_null_in_tissue_raises_as_jax(tmp_path):
    """A null ``in_tissue`` or ``array_row``: JAX's route raises from pandas'
    ``astype(int)`` (a ``ValueError``: placing the in-tissue bins, and
    ``hd_lattice_dims``), and the port's ``read_positions`` raises a
    ``ValueError`` naming the column. A null in an extra column reads."""
    from gridnext_tpu import pipeline as jax_pipeline
    from gridnext_tpu.data import simulate_spaceranger_dir

    sim = simulate_spaceranger_dir(tmp_path / "hd", seed=4, n_genes=4, n_classes=3,
                                   spaceranger_version="hd", hd_grid=(8, 9),
                                   hd_binning="square_016um")
    srd = sim["spaceranger_dir"]
    path = Path(find_position_file(srd, "square_016um"))
    table = read_parquet(path)
    columns = TOOL.optional_positions(table)
    TOOL.write_optional(path, columns, page_rows=30)
    assert hd_lattice_dims(srd, "square_016um") == jax_hd_dims(srd, "square_016um") == (8, 9)
    defined = np.arange(len(table["barcode"])) != 5
    columns["array_row"] = (table["array_row"], defined)
    TOOL.write_optional(path, columns, page_rows=30)
    with pytest.raises(ValueError):
        jax_hd_dims(srd, "square_016um")
    with pytest.raises(ValueError, match="'array_row' holds 1 null"):
        read_positions(srd, "square_016um")
    columns["array_row"] = (table["array_row"], None)
    columns["in_tissue"] = (table["in_tissue"], defined)
    TOOL.write_optional(path, columns, page_rows=30)
    with pytest.raises(ValueError):
        jax_pipeline._spot_pixel_boxes(jax_read_positions(srd, hd_binning="square_016um"), 8,
                                       hex_coords=False)
    with pytest.raises(ValueError, match="'in_tissue' holds 1 null"):
        read_positions(srd, "square_016um")


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("layout", ["dictionary", "plain", "delta"])
def test_nulls_read_as_pandas(layout, version, tmp_path):
    """Columns with nulls of every type in v1 and v2 pages, PLAIN,
    dictionary and DELTA / BYTE_STREAM_SPLIT encoded, over three codecs:
    pandas' dtypes and values, NaN and None where pandas has them."""
    table = TOOL.null_typed_table(500, seed=len(layout) + int(version[0]))
    kw = {"dictionary": {}, "plain": {"use_dictionary": False},
          "delta": {"use_dictionary": False, "column_encoding": TOOL.ENCODINGS["enc_split"]}}
    for codec in ("snappy", "zstd", None):
        pq.write_table(table, tmp_path / "n.parquet", data_page_version=version,
                       compression=codec, data_page_size=600, **kw[layout])
        assert_read_equal(tmp_path / "n.parquet")
    got = read_parquet(tmp_path / "n.parquet")
    assert got["i32"].dtype == np.float64 and np.isnan(got["i32"]).any()
    assert None in got["flag"] and None in got["raw"]


def test_int96_flba_and_decimals_read_as_pandas(tmp_path):
    """INT96 timestamps (``datetime64[ns]``, NaT for nulls),
    FIXED_LEN_BYTE_ARRAY (``bytes``) and DECIMAL over FLBA, INT32 and INT64
    (``decimal.Decimal``), dictionary or plain, in v1 and v2 pages; and
    ``write_optional``'s hand-made OPTIONAL pages."""
    table = TOOL.wide_types_table(300, seed=3)
    for kw in ({}, {"use_dictionary": False, "data_page_version": "2.0"},
               {"store_decimal_as_integer": True, "compression": "zstd"}):
        pq.write_table(table, tmp_path / "w.parquet", use_deprecated_int96_timestamps=True,
                       data_page_size=500, **kw)
        assert_read_equal(tmp_path / "w.parquet")
    got = read_parquet(tmp_path / "w.parquet")
    assert got["when"].dtype == np.dtype("datetime64[ns]") and np.isnat(got["when"]).any()
    positions = {c: (v.tolist() if c == "barcode" else v.to_numpy())
                 for c, v in positions_frame(7, 9, seed=4).items()}
    TOOL.write_optional(tmp_path / "o.parquet", TOOL.optional_positions(positions),
                        page_rows=11)
    assert_read_equal(tmp_path / "o.parquet")


def _hd_register_matches_jax(tmp_path, rewrite, tissue_dtype):
    """``read_positions`` of a simulated HD directory whose positions
    ``rewrite`` rewrote equals the JAX package's, and ``register --device
    cpu`` of a JAX-written HD model directory (24 x 24 bins) writes the
    Loupe CSV that the JAX package's ``register`` writes."""
    import jax
    import jax.numpy as jnp

    from gridnext_tpu.cli import main as jax_main
    from gridnext_tpu.data import simulate_spaceranger_dir
    from gridnext_tpu.models import GridNet as JaxGridNet
    from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
    from gridnext_tpu.train import save_checkpoint
    from gridnext_tpu_torch.cli import main as port_main

    sim = simulate_spaceranger_dir(tmp_path / "hd", seed=4, n_genes=4, n_classes=3,
                                   spaceranger_version="hd", hd_grid=(24, 24),
                                   hd_binning="square_016um", image=True, spot_spacing_px=12)
    srd = sim["spaceranger_dir"]
    rewrite(srd)
    pos = read_positions(srd, "square_016um")
    want = jax_read_positions(srd, hd_binning="square_016um")
    assert want["in_tissue"].dtype == tissue_dtype
    assert pos.barcodes == list(want.index)
    for name in COLUMNS[1:]:
        np.testing.assert_array_equal(pos[name], want[name].to_numpy())
    assert hd_lattice_dims(srd, "square_016um") == jax_hd_dims(srd, "square_016um") == (24, 24)

    jg = JaxGridNet(patch_classifier=JaxTpuF(n_classes=3, stages=((16, 1),), stem_patch=4),
                    n_classes=3)
    rng = np.random.default_rng(1)

    def fill(path, leaf):                  # numpy weights; BatchNorm variances positive
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, jax.eval_shape(
        jg.init, jax.random.key(0), jnp.zeros((1, 2, 2, 8, 8, 3))))
    model = tmp_path / "model"
    model.mkdir()
    # the trainers' checkpoint payload, without an optimizer state
    save_checkpoint(str(model / "g_state.msgpack"), SimpleNamespace(
        params=variables["params"], batch_stats=variables.get("batch_stats", {}),
        extra_vars={}, step=0), include_opt_state=False)
    (model / "model.json").write_text(json.dumps({
        "classes": ["A", "B", "C"], "patch_px": 8, "window_px": 12,
        "model": "GridNet+TpuPatchClassifier",
        "tpu_f": {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"}, "image_f": "tpu",
        "hd_binning": "square_016um", "grid_dims": [24, 24], "patch_chunk": 64}))
    args = ["register", "--model", str(model), "--spaceranger", srd, "--images",
            sim["image_file"]]
    jax_main(args + ["--out", str(tmp_path / "jax.csv")])
    port_main(args + ["--out", str(tmp_path / "port.csv"), "--device", "cpu"])
    rows = []
    for name in ("jax.csv", "port.csv"):
        with open(tmp_path / name, newline="") as fh:
            rows.append(list(csv.reader(fh)))
    assert rows[0][0] == ["Barcode", "AARs"] and len(rows[0]) == int(want["in_tissue"].sum()) + 1
    assert rows[1] == rows[0]


def test_delta_decoders_refuse_corrupt_pages():
    """Hand-made DELTA pages: a prefix longer than the value before it, a
    suffix past the page and an oversized block raise ``ParquetError``."""
    from gridnext_tpu_torch.io import parquet

    def deltas(values):           # one block of 128 in 4 miniblocks, every delta equal
        step = values[1] - values[0] if len(values) > 1 else 0
        assert all(b - a == step for a, b in zip(values, values[1:]))
        zz = lambda v: v * 2 if v >= 0 else -v * 2 - 1  # noqa: E731
        head = bytes([0x80, 0x01, 4, len(values), zz(values[0])])
        return head + (bytes([zz(step), 0, 0, 0, 0]) if len(values) > 1 else b"")

    good = deltas([0, 1]) + deltas([1, 1]) + b"ab"
    assert parquet._delta_byte_array(good, 2, "c") == [b"a", b"ab"]
    with pytest.raises(ParquetError, match="corrupt DELTA_BYTE_ARRAY"):
        parquet._delta_byte_array(deltas([0, 5]) + deltas([1, 1]) + b"ab", 2, "c")
    with pytest.raises(ParquetError, match="corrupt DELTA_BYTE_ARRAY"):
        parquet._delta_byte_array(deltas([0, 1]) + deltas([1, 1]) + b"a", 2, "c")
    huge = bytes([0x80, 0x80, 0x80, 0x01, 1, 2, 0])            # a block of 2 ** 21 values
    with pytest.raises(ParquetError, match="DELTA_BINARY_PACKED values: corrupt: a block"):
        parquet._delta_binary_packed(huge, 2, 64, "c")
    with pytest.raises(ParquetError, match="truncated"):
        parquet._delta_binary_packed(deltas([3, 4, 5])[:-2], 3, 64, "c")
