"""The port's page decompressors (``csrc/parquet_codec.cpp``) against
pyarrow, ``zstandard`` and the system's Brotli encoder.

Every decoder of ``gridnext_tpu_torch.io.parquet.decompress`` must give
the bytes the reference codec compressed, byte for byte:

* ZSTD from ``zstandard`` (levels 1, 3, 19, 22, content checksum on and
  off, two frames with a skippable frame between them) and from
  ``pyarrow.compress``; a frame that names a dictionary raises, naming it;
* Brotli from ``pyarrow.compress`` at qualities 0, 5 and 11, from
  ``libbrotlienc`` (through ``ctypes``, here only) at windows 10 and 24,
  English text at quality 11 (the static dictionary and its transforms) and
  a hand-made stream of an uncompressed and a metadata meta-block;
* LZ4_RAW from ``pyarrow.Codec("lz4_raw")``; codec-5 pages in Hadoop's
  framing and as one raw block, read as pyarrow reads the same file;
* SNAPPY: the C++ decoder against the plain Python one;
* truncated and bit-flipped input raises ``ParquetError`` (or, where no
  check can see a flipped literal, decodes to a page of its size), and
  never crashes.

The Brotli dictionary asset is RFC 7932's (length and SHA-256);
``tests/test_torch_isolation.py`` checks that the C++ includes no codec
library's header and that reading loads none.
"""

import ctypes
import ctypes.util
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gridnext_tpu_torch.io import parquet
from gridnext_tpu_torch.io.parquet import ParquetError, decompress, read_parquet

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)
TEXT = (REPO / "README.md").read_bytes()[:60000]
INPUTS = {
    "empty": b"",
    "byte": b"x",
    "rle": b"\x07" * 300000,
    "random": RNG.integers(0, 256, 200000, dtype=np.uint8).tobytes(),
    "repetitive": (b"s_016um_00012_00034-1" * 50000)[:1 << 20],
    "text": TEXT,
    "int64": np.arange(40000, dtype=np.int64).tobytes(),
}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_parquet_fixtures", REPO / "tools" / "make_parquet_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _brotli_encoder():
    """``BrotliEncoderCompress`` of the system's libbrotlienc, or None."""
    name = ctypes.util.find_library("brotlienc") or "libbrotlienc.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.BrotliEncoderCompress.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_size_t, ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    lib.BrotliEncoderCompress.restype = ctypes.c_int

    def compress(data: bytes, quality: int, lgwin: int) -> bytes:
        cap = len(data) + 1024
        buf = ctypes.create_string_buffer(cap)
        size = ctypes.c_size_t(cap)
        assert lib.BrotliEncoderCompress(quality, lgwin, 0, len(data), data,
                                         ctypes.byref(size), buf)
        return buf.raw[:size.value]

    return compress


CODEC_IDS = {name: codec for codec, name in parquet._CODEC_NAMES.items()}


def _decompress(codec: str, data, size):
    return decompress(CODEC_IDS[codec], data, size)


def _bytes(codec: str, data, size):
    return bytes(_decompress(codec, data, size))


# -- ZSTD ---------------------------------------------------------------------------


@pytest.mark.parametrize("checksum", [False, True], ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19, 22])
def test_zstd_levels_and_checksum(level, checksum):
    comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    for name, data in INPUTS.items():
        if level >= 19 and name in ("random", "repetitive"):
            data = data[:65536]                  # the top levels compress slowly
        assert _bytes("ZSTD", comp.compress(data), len(data)) == data, name


def test_zstd_from_pyarrow_and_concatenated_frames():
    for name, data in INPUTS.items():
        frame = pa.compress(data, codec="zstd", asbytes=True)
        assert _bytes("ZSTD", frame, len(data)) == data, name
    a, b = INPUTS["text"], INPUTS["int64"]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    frames = (zstandard.ZstdCompressor(level=3, write_checksum=True).compress(a) + skippable
              + zstandard.ZstdCompressor(level=1, write_content_size=False).compress(b))
    assert _bytes("ZSTD", frames, len(a) + len(b)) == a + b
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frames) == a
    with pytest.raises(ParquetError, match="ZSTD page: corrupt: unknown frame magic"):
        _decompress("ZSTD", frames + b"\x00\x00\x00\x00", len(a) + len(b))


def test_zstd_dictionary_frame_is_refused():
    data = b"positions"
    # single segment, a 1-byte dictionary ID (7), a 1-byte content size, one raw last block
    frame = (0xFD2FB528).to_bytes(4, "little") + bytes([0x21, 7, len(data)]) + \
        (1 | (len(data) << 3)).to_bytes(3, "little") + data
    with pytest.raises(ParquetError, match="ZSTD page: refused: .*dictionary ID 7"):
        _decompress("ZSTD", frame, len(data))
    plain = frame[:4] + bytes([0x20, len(data)]) + frame[7:]     # the same frame, no ID
    assert _bytes("ZSTD", plain, len(data)) == data
    assert zstandard.ZstdDecompressor().decompress(plain) == data


# -- Brotli -------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [0, 5, 11])
def test_brotli_from_pyarrow(quality):
    codec = pa.Codec("brotli", compression_level=quality)
    for name, data in INPUTS.items():
        if quality == 11 and name in ("rle", "random", "repetitive"):
            data = data[:65536]
        assert _bytes("BROTLI", codec.compress(data, asbytes=True), len(data)) == data, name


@pytest.mark.parametrize("lgwin", [10, 24])
def test_brotli_windows(lgwin):
    compress = _brotli_encoder()
    assert compress is not None, "the system's libbrotlienc is needed to set the window"
    for quality in (1, 9):
        for name, data in INPUTS.items():
            assert _bytes("BROTLI", compress(data, quality, lgwin), len(data)) == data, \
                (quality, name)


def test_brotli_english_text_uses_the_dictionary():
    """Quality 11 on English text copies dictionary words through their
    transforms; a stream whose words the port's decoder could not find or
    transform would not decode."""
    for data in (TEXT, TEXT.upper(), TEXT[:2000]):
        stream = pa.Codec("brotli", compression_level=11).compress(data, asbytes=True)
        assert _bytes("BROTLI", stream, len(data)) == data


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        self.bits += [(value >> i) & 1 for i in range(n)]

    def align(self):
        self.bits += [0] * (-len(self.bits) % 8)

    def raw(self, data: bytes):
        self.align()
        for b in data:
            self.put(b, 8)

    def done(self) -> bytes:
        self.align()
        return bytes(sum(bit << i for i, bit in enumerate(self.bits[k:k + 8]))
                     for k in range(0, len(self.bits), 8))


def test_brotli_uncompressed_and_metadata_meta_blocks():
    payload = RNG.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    w = _BitWriter()
    w.put(0, 1)                                  # WBITS 16
    w.put(0, 1)                                  # ISLAST 0
    w.put(3, 2)                                  # MNIBBLES 0: metadata
    w.put(0, 1)                                  # reserved
    w.put(1, 2)                                  # MSKIPBYTES 1
    w.put(4, 8)                                  # MSKIPLEN - 1
    w.raw(b"meta!")
    w.put(0, 1)                                  # ISLAST 0
    w.put(0, 2)                                  # MNIBBLES 4
    w.put(len(payload) - 1, 16)                  # MLEN - 1
    w.put(1, 1)                                  # ISUNCOMPRESSED
    w.raw(payload)
    w.put(1, 1)                                  # ISLAST
    w.put(1, 1)                                  # ISLASTEMPTY
    stream = w.done()
    assert pa.decompress(stream, decompressed_size=len(payload), codec="brotli",
                         asbytes=True) == payload
    assert _bytes("BROTLI", stream, len(payload)) == payload
    large = bytes([0x11, 0x01]) + stream[1:]     # WBITS code 0010001: the large window
    with pytest.raises(ParquetError, match="BROTLI page: refused: the large-window"):
        _decompress("BROTLI", large, len(payload))


def test_brotli_dictionary_asset_is_rfc_7932s(monkeypatch, tmp_path):
    data = Path(parquet.BROTLI_DICTIONARY).read_bytes()
    assert len(data) == 122784
    assert hashlib.sha256(data).hexdigest() == \
        "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"
    assert data.startswith(b"timedownlifeleftbackcodedatashowonlysite")
    damaged = tmp_path / "brotli_dictionary.bin"
    damaged.write_bytes(data[:-1] + b"!")
    monkeypatch.setattr(parquet, "BROTLI_DICTIONARY", str(damaged))
    parquet._codecs.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="not RFC 7932's static dictionary"):
            _decompress("BROTLI", pa.compress(TEXT, codec="brotli", asbytes=True), len(TEXT))
    finally:
        parquet._codecs.cache_clear()


# -- LZ4 and SNAPPY -----------------------------------------------------------------


def test_lz4_raw_from_pyarrow():
    codec = pa.Codec("lz4_raw")
    for name, data in INPUTS.items():
        if data:
            assert _bytes("LZ4_RAW", codec.compress(data, asbytes=True), len(data)) == data, name
    assert _bytes("LZ4_RAW", b"\x00", 0) == b""      # the empty block: one token


@pytest.mark.parametrize("framing", ["hadoop", "block", "hadoop_one_frame"])
def test_lz4_codec5_pages_read_as_pyarrow_reads_them(framing, tmp_path):
    tool = _tool()
    columns = tool.codec5_columns(seed=11)
    compress = {"hadoop": tool.hadoop_lz4, "block": tool.raw_lz4,
                "hadoop_one_frame": lambda d: tool.hadoop_lz4(d, frames=1)}[framing]
    path = tmp_path / "lz4.parquet"
    tool.write_pages(path, columns, 5, compress)
    want = pd.read_parquet(path)
    got = read_parquet(path)
    assert got["barcode"] == want["barcode"].tolist()
    for name in list(columns)[1:]:
        np.testing.assert_array_equal(got[name], want[name].to_numpy())
    for data in (INPUTS["text"], INPUTS["int64"]):
        for page in (tool.hadoop_lz4(data, 3), tool.raw_lz4(data)):
            assert _bytes("LZ4", page, len(data)) == data


def test_lz4_hadoop_frames_that_do_not_account_fall_back_and_fail(tmp_path):
    """A frame whose decompressed size is wrong makes the page not Hadoop's;
    as one raw block it is corrupt: pyarrow and the port both refuse it."""
    tool = _tool()
    columns = {"a": np.arange(50, dtype=np.int64)}

    def lying(data):
        page = tool.hadoop_lz4(data, frames=1)
        return (len(data) - 1).to_bytes(4, "big") + page[4:]

    tool.write_pages(tmp_path / "bad.parquet", columns, 5, lying)
    with pytest.raises(OSError):
        pd.read_parquet(tmp_path / "bad.parquet")
    with pytest.raises(ParquetError, match="LZ4"):
        read_parquet(tmp_path / "bad.parquet")


def test_snappy_cpp_matches_python():
    codec = pa.Codec("snappy")
    for name, data in INPUTS.items():
        block = codec.compress(data, asbytes=True)
        assert _bytes("SNAPPY", block, len(data)) == parquet.snappy_decompress(block) == data, \
            name
    block = bytes([26, 0x0C, *b"abcd", 0x01 | (2 << 2), 4, 0x02 | (5 << 2), 10, 0,
                   0x03 | (9 << 2), 1, 0, 0, 0])   # test_torch_parquet's hand-built block
    assert _bytes("SNAPPY", block, 26) == parquet.snappy_decompress(block)
    with pytest.raises(ParquetError, match="SNAPPY page: corrupt: a match 9 bytes back"):
        _decompress("SNAPPY", bytes([4, 0x05, 9]), 4)


# -- corrupt input ------------------------------------------------------------------


def _corpus():
    data = TEXT[:20000] + np.arange(3000, dtype=np.int32).tobytes()
    enc = _brotli_encoder()
    return data, {
        "ZSTD": zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data),
        "BROTLI": pa.Codec("brotli", compression_level=9).compress(data, asbytes=True),
        "BROTLI_W10": enc(data, 5, 10) if enc else
        pa.Codec("brotli", compression_level=5).compress(data, asbytes=True),
        "LZ4_RAW": pa.Codec("lz4_raw").compress(data, asbytes=True),
        "LZ4": _tool().hadoop_lz4(data, 2),
        "SNAPPY": pa.Codec("snappy").compress(data, asbytes=True),
    }


DATA, CORPUS = _corpus()


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(codec=st.sampled_from(sorted(CORPUS)), cut=st.floats(0, 1, exclude_max=True),
       flips=st.lists(st.tuples(st.floats(0, 1, exclude_max=True), st.integers(0, 7)),
                      max_size=3))
def test_corrupt_input_raises(codec, cut, flips):
    """Truncated input always raises; bit-flipped input raises or decodes to
    a page of the size its header says (a flipped literal byte passes every
    check of a codec without a checksum)."""
    name = codec.split("_W")[0]
    good = CORPUS[codec]
    with pytest.raises(ParquetError, match=name):
        _decompress(name, good[:int(cut * len(good))], len(DATA))
    if flips:
        bad = bytearray(good)
        for where, bit in flips:
            bad[int(where * len(bad))] ^= 1 << bit
        try:
            out = _decompress(name, bytes(bad), len(DATA))
        except ParquetError as err:
            assert str(err).startswith(f"{name} page"), err
        else:
            assert len(out) == len(DATA)
            assert name in ("LZ4_RAW", "LZ4", "SNAPPY", "BROTLI") or bytes(out) == DATA


def test_decoders_refuse_output_past_the_page_size():
    for name in ("ZSTD", "BROTLI", "LZ4_RAW", "LZ4", "SNAPPY"):
        page = CORPUS[name]
        with pytest.raises(ParquetError, match=f"{name} page"):
            _decompress(name, page, len(DATA) - 1)
