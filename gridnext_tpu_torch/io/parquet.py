"""Parquet files in the standard library, numpy and the port's own codecs:
Visium HD positions.

Spaceranger writes a Visium HD array's bin positions as
``outs/binned_outputs/<binning>/spatial/tissue_positions.parquet``. The
JAX package reads it with ``pandas.read_parquet``; the card has neither
pandas nor pyarrow, so the port reads it here.

:func:`read_parquet` reads flat tables (one leaf column per field, no
nesting):

* the ``PAR1`` footer and the Thrift compact protocol of ``FileMetaData``
  and ``PageHeader`` (fields this reader does not use are skipped);
* dictionary pages and data pages v1 and v2, over several row groups;
* the encodings PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY, RLE (BOOLEAN),
  DELTA_BINARY_PACKED (INT32, INT64), DELTA_LENGTH_BYTE_ARRAY and
  DELTA_BYTE_ARRAY (BYTE_ARRAY) and BYTE_STREAM_SPLIT (FLOAT, DOUBLE,
  INT32, INT64), with RLE/bit-packed definition levels for optional
  columns (pandas writes every column as optional);
* the physical types BOOLEAN, INT32, INT64, INT96 (Julian-day timestamps,
  as ``datetime64[ns]``), FLOAT, DOUBLE, BYTE_ARRAY (UTF-8 strings where the
  schema says so, else ``bytes``) and FIXED_LEN_BYTE_ARRAY (``bytes``), and
  the DECIMAL logical type (``decimal.Decimal``);
* null values: the definition levels of optional columns in v1 and v2
  pages place the encoded values, and a column that holds a null comes back
  as pandas gives it (integers as float64 with NaN, floats with NaN,
  timestamps with NaT, booleans, bytes and decimals as objects with None,
  strings with NaN);
* the codecs UNCOMPRESSED, GZIP (``zlib``) and, through the host C++
  library ``csrc/parquet_codec.cpp`` (no zstd, lz4, brotli or snappy
  library), SNAPPY, BROTLI, ZSTD, LZ4_RAW and the deprecated LZ4 (Hadoop's
  framing or one raw block, as Arrow reads it). Brotli's static
  dictionary is the committed ``assets/brotli_dictionary.bin`` (RFC 7932
  Appendix A), checked against its SHA-256 when it is loaded.

Anything else raises an error that names it: nested or repeated columns,
LZO pages (which pyarrow does not read either), a ZSTD frame that names a
dictionary and a Brotli stream with the large-window extension.
:func:`snappy_decompress` is the plain Python version of the SNAPPY
decoder that the tests hold the C++ one against.

:func:`write_parquet` writes one row group of required columns, PLAIN and
UNCOMPRESSED, which pandas and pyarrow read back.
"""

from __future__ import annotations

import ctypes
import decimal
import functools
import hashlib
import os
import struct
import zlib

import numpy as np

MAGIC = b"PAR1"

# Parquet's enums (parquet.thrift)
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
_TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
               "FIXED_LEN_BYTE_ARRAY")
_CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
                5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
_ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                   5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                   7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY = 5, 6, 7
BYTE_STREAM_SPLIT = 9
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
REQUIRED, OPTIONAL, REPEATED = range(3)
UTF8, DECIMAL = 0, 5            # ConvertedType

_PLAIN_DTYPES = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}

# Thrift compact protocol type ids
_T_STOP, _T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = range(7)
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = range(7, 13)


class ParquetError(ValueError):
    """A file this reader cannot read, or a malformed one."""


# -- Thrift compact protocol --------------------------------------------------


def _varint(buf, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class _CompactReader:
    """Thrift compact-protocol structs as ``{field id: value}`` dicts."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def struct(self) -> dict:
        out, last = {}, 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _T_STOP:
                return out
            ttype, delta = head & 0x0F, head >> 4
            if delta:
                fid = last + delta
            else:
                raw, self.pos = _varint(self.buf, self.pos)
                fid = _unzigzag(raw)
            last = fid
            out[fid] = (ttype == _T_TRUE) if ttype in (_T_TRUE, _T_FALSE) else self.value(ttype)

    def value(self, ttype: int):
        buf = self.buf
        if ttype == _T_BYTE:
            self.pos += 1
            return struct.unpack_from("<b", buf, self.pos - 1)[0]
        if ttype in (_T_I16, _T_I32, _T_I64):
            raw, self.pos = _varint(buf, self.pos)
            return _unzigzag(raw)
        if ttype == _T_DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", buf, self.pos - 8)[0]
        if ttype == _T_BINARY:
            n, self.pos = _varint(buf, self.pos)
            self.pos += n
            return bytes(buf[self.pos - n:self.pos])
        if ttype in (_T_LIST, _T_SET):
            head = buf[self.pos]
            self.pos += 1
            size, etype = head >> 4, head & 0x0F
            if size == 15:
                size, self.pos = _varint(buf, self.pos)
            if etype in (_T_TRUE, _T_FALSE):      # a byte each: 1 true, 2 false
                self.pos += size
                return [b == _T_TRUE for b in buf[self.pos - size:self.pos]]
            return [self.value(etype) for _ in range(size)]
        if ttype == _T_MAP:
            size, self.pos = _varint(buf, self.pos)
            if not size:
                return {}
            kv = buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(size)}
        if ttype == _T_STRUCT:
            return self.struct()
        raise ParquetError(f"corrupt Thrift metadata: type id {ttype}")


def _zigzag(n: int) -> int:
    return n << 1 if n >= 0 else ((-n) << 1) - 1


def _uvarint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _encode_struct(fields) -> bytes:
    """Compact-protocol bytes of a struct given as ``[(field id, type id,
    value)]`` in ascending field order; a struct value is such a list, a
    list value ``(element type id, [values])``."""
    out = bytearray()
    last = 0
    for fid, ttype, value in fields:
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | ttype)
        else:
            out.append(ttype)
            out += _uvarint(_zigzag(fid))
        last = fid
        out += _encode_value(ttype, value)
    out.append(_T_STOP)
    return bytes(out)


def _encode_value(ttype: int, value) -> bytes:
    if ttype in (_T_I32, _T_I64):
        return _uvarint(_zigzag(int(value)))
    if ttype == _T_BINARY:
        value = value.encode() if isinstance(value, str) else bytes(value)
        return _uvarint(len(value)) + value
    if ttype == _T_STRUCT:
        return _encode_struct(value)
    if ttype == _T_LIST:
        etype, items = value
        head = (bytes([(len(items) << 4) | etype]) if len(items) < 15
                else bytes([0xF0 | etype]) + _uvarint(len(items)))
        return head + b"".join(_encode_value(etype, v) for v in items)
    raise ValueError(f"the writer does not encode Thrift type {ttype}")


# -- codecs ---------------------------------------------------------------------


def snappy_decompress(buf) -> bytes:
    """Decompress one raw Snappy block (the format of Parquet's SNAPPY
    pages: the uncompressed length as a varint, then literals and
    back-references)."""
    buf = memoryview(buf)
    n, pos = _varint(buf, 0)
    out = bytearray()
    end = len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                                  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                                  # copy, 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:                                # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = buf[pos] | (buf[pos + 1] << 8)
            pos += 2
        else:                                          # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        start = len(out) - off
        if off <= 0 or start < 0:
            raise ParquetError("corrupt SNAPPY page: a copy before the start")
        if off >= ln:
            out += out[start:start + ln]
        else:                                          # overlapping: a repeated pattern
            out += (out[start:] * (ln // off + 1))[:ln]
    if len(out) != n:
        raise ParquetError(f"corrupt SNAPPY page: {len(out)} bytes, header says {n}")
    return bytes(out)


_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = (
    ("pq_last_error", (ctypes.c_char_p, ctypes.c_int), ctypes.c_int),
    ("pq_snappy", (_VP, _LL, _VP, _LL), _LL),
    ("pq_lz4_raw", (_VP, _LL, _VP, _LL), _LL),
    ("pq_lz4_hadoop", (_VP, _LL, _VP, _LL), _LL),
    ("pq_zstd", (_VP, _LL, _VP, _LL), _LL),
    ("pq_brotli", (_VP, _LL, _VP, _LL), _LL),
    ("pq_brotli_dictionary", (_VP, _LL), ctypes.c_int),
    ("pq_delta_binary_packed", (_VP, _LL, _LL, ctypes.c_int, _VP, ctypes.POINTER(_LL)), _LL),
    ("pq_delta_byte_array", (_VP, _LL, _VP, _LL, _LL, _VP, _LL), _LL),
)
# codec id -> the C library's decoder
_NATIVE_CODECS = {1: "pq_snappy", 4: "pq_brotli", 5: "pq_lz4_hadoop", 6: "pq_zstd",
                  7: "pq_lz4_raw"}
_FAILURES = {-1: "truncated", -2: "corrupt", -3: "output larger than the page header says",
             -4: "refused"}
BROTLI_DICTIONARY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "assets", "brotli_dictionary.bin")
BROTLI_DICTIONARY_SHA256 = "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"
BROTLI_DICTIONARY_SIZE = 122784


@functools.lru_cache(maxsize=None)
def _codecs():
    """The C library, built first if needed, with RFC 7932's dictionary
    (checked against its SHA-256) handed to it; returns (library, the
    dictionary's buffer, kept alive here)."""
    from gridnext_tpu_torch.ops import _host

    lib = _host.library("parquet_codec", _SIGNATURES)
    with open(BROTLI_DICTIONARY, "rb") as fh:
        data = fh.read()
    if len(data) != BROTLI_DICTIONARY_SIZE or \
            hashlib.sha256(data).hexdigest() != BROTLI_DICTIONARY_SHA256:
        raise RuntimeError(f"{BROTLI_DICTIONARY} is not RFC 7932's static dictionary "
                           f"({len(data)} bytes; want {BROTLI_DICTIONARY_SIZE} with SHA-256 "
                           f"{BROTLI_DICTIONARY_SHA256})")
    buf = ctypes.create_string_buffer(data, len(data))
    if lib.pq_brotli_dictionary(ctypes.addressof(buf), len(data)):
        raise RuntimeError("the codec library refused the Brotli dictionary")
    return lib, buf


def _failed(lib, code: int, what: str) -> ParquetError:
    msg = ctypes.create_string_buffer(256)
    lib.pq_last_error(msg, 256)
    return ParquetError(f"{what}: {_FAILURES.get(code, code)}: {msg.value.decode()}")


def decompress(codec: int, body, size: int):
    """One page body of Parquet codec id ``codec`` decompressed to exactly
    ``size`` bytes, as a memoryview (UNCOMPRESSED: ``body`` itself). Raises
    :class:`ParquetError` naming the codec and what went wrong."""
    name = _CODEC_NAMES.get(codec, codec)
    if codec == 0:
        return memoryview(body)
    if codec == 2:
        try:
            out = memoryview(zlib.decompressobj(wbits=47).decompress(bytes(body)))  # gzip or zlib
        except zlib.error as err:
            raise ParquetError(f"GZIP page: corrupt: {err}") from None
    elif codec in _NATIVE_CODECS:
        lib, _ = _codecs()
        src = np.frombuffer(body, np.uint8)
        dst = np.empty(size, np.uint8)
        got = getattr(lib, _NATIVE_CODECS[codec])(src.ctypes.data, len(src), dst.ctypes.data,
                                                   size)
        if got < 0:
            raise _failed(lib, got, f"{name} page")
        out = memoryview(dst)[:got]
    else:
        raise ParquetError(f"parquet codec {name} is not supported (UNCOMPRESSED, SNAPPY, "
                           "GZIP, BROTLI, LZ4, ZSTD and LZ4_RAW are)")
    if len(out) != size:
        raise ParquetError(f"{name} page decompressed to {len(out)} bytes, header says {size}")
    return out


# -- encodings ------------------------------------------------------------------


def _rle_hybrid(buf, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid encoding (levels and
    dictionary indices), as int64."""
    out = np.zeros(count, np.int64)
    if bit_width == 0 or count == 0:
        return out
    weights = np.left_shift(np.int64(1), np.arange(bit_width, dtype=np.int64))
    byte_width = (bit_width + 7) // 8
    pos = n = 0
    while n < count:
        header, pos = _varint(buf, pos)
        if header & 1:                                 # bit-packed groups of 8
            nbytes = (header >> 1) * bit_width
            bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos),
                                 bitorder="little")
            pos += nbytes
            vals = bits.reshape(-1, bit_width).astype(np.int64) @ weights
            take = min(len(vals), count - n)
            out[n:n + take] = vals[:take]
        else:                                          # a run of one value
            value = int.from_bytes(buf[pos:pos + byte_width], "little")
            pos += byte_width
            take = min(header >> 1, count - n)
            out[n:n + take] = value
        n += take
    return out


def _byte_arrays(buf, count: int) -> list:
    """``count`` PLAIN BYTE_ARRAY values (each a 4-byte length and its
    bytes), one at a time."""
    buf = memoryview(buf)
    vals, pos = [], 0
    for _ in range(count):
        ln = int.from_bytes(buf[pos:pos + 4], "little")
        vals.append(bytes(buf[pos + 4:pos + 4 + ln]))
        pos += 4 + ln
    return vals


def _fixed_byte_arrays(buf, count: int):
    """The values of :func:`_byte_arrays` when all ``count`` have one length
    (HD barcodes), read as one array; None otherwise.
    ``tools/time_parquet.py`` times the two."""
    if not count or len(buf) < 4:
        return None
    rows = np.frombuffer(buf, np.uint8)
    ln = int.from_bytes(bytes(rows[:4]), "little")
    if len(rows) != count * (4 + ln):
        return None
    rows = rows.reshape(count, 4 + ln)
    if not (rows[:, :4].copy().view("<u4") == ln).all():
        return None
    flat = rows[:, 4:].tobytes()
    return [flat[i:i + ln] for i in range(0, count * ln, ln)]


def _fixed(buf, width: int, count: int) -> list:
    """``count`` values of ``width`` bytes each, laid end to end."""
    flat = bytes(buf[:width * count])
    if len(flat) != width * count:
        raise ParquetError(f"{count} values of {width} bytes run past the page")
    return [flat[i:i + width] for i in range(0, len(flat), width)] if width else [b""] * count


def _plain(buf, column, count: int):
    ptype = column.ptype
    if ptype in _PLAIN_DTYPES:
        return np.frombuffer(buf, _PLAIN_DTYPES[ptype], count).copy()
    if ptype == BOOLEAN:                               # bit-packed, first value in bit 0
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, (count + 7) // 8), bitorder="little")
        return bits[:count].astype(bool)
    if ptype == BYTE_ARRAY:
        vals = _fixed_byte_arrays(buf, count)
        return _byte_arrays(buf, count) if vals is None else vals
    if ptype == INT96:                                 # kept as 12 raw bytes a value
        return np.frombuffer(buf, np.uint8, 12 * count).reshape(count, 12).copy()
    return _fixed(buf, column.width, count)            # FIXED_LEN_BYTE_ARRAY


def _int96_datetimes(raw: np.ndarray) -> np.ndarray:
    """INT96 timestamps (nanoseconds of the day, then the Julian day, little
    endian) as ``datetime64[ns]``, as pyarrow hands them to pandas."""
    nanos = raw[:, :8].copy().view("<i8")[:, 0]
    days = raw[:, 8:].copy().view("<i4")[:, 0].astype(np.int64)
    return ((days - 2440588) * 86_400_000_000_000 + nanos).view("datetime64[ns]")


def _delta_binary_packed(buf, count: int, width: int, column: str):
    """``count`` DELTA_BINARY_PACKED values (int64, wrapping at ``width``
    bits) and the bytes they took, decoded by the C library."""
    lib, _ = _codecs()
    src = np.frombuffer(buf, np.uint8)
    out = np.empty(count, np.int64)
    used = ctypes.c_longlong(0)
    got = lib.pq_delta_binary_packed(src.ctypes.data, len(src), count, width, out.ctypes.data,
                                     ctypes.byref(used))
    if got < 0:
        raise _failed(lib, got, f"column {column!r}: DELTA_BINARY_PACKED values")
    return out, used.value


def _split_values(buf, lengths: np.ndarray, column: str) -> list:
    """The byte strings of ``lengths`` laid end to end in ``buf``."""
    if len(lengths) and (lengths.min() < 0 or int(lengths.sum()) > len(buf)):
        raise ParquetError(f"column {column!r}: value lengths past the page")
    if len(lengths) and (lengths == lengths[0]).all():   # one length: HD barcodes
        ln = int(lengths[0])
        flat = bytes(buf[:ln * len(lengths)])
        return [flat[i:i + ln] for i in range(0, len(flat), ln)] if ln else [b""] * len(lengths)
    ends = np.cumsum(lengths)
    flat = bytes(buf[:int(ends[-1])]) if len(ends) else b""
    return [flat[a:b] for a, b in zip((ends - lengths).tolist(), ends.tolist())]


def _delta_byte_array(buf, count: int, column: str) -> list:
    """DELTA_BYTE_ARRAY: prefix lengths and suffixes (DELTA_LENGTH_BYTE_ARRAY),
    each value the first prefix bytes of the one before it and its suffix,
    joined by the C library."""
    prefix, used = _delta_binary_packed(buf, count, 32, column)
    suffix, more = _delta_binary_packed(memoryview(buf)[used:], count, 32, column)
    tail = np.frombuffer(buf, np.uint8)[used + more:]
    lengths = prefix + suffix
    if count and (prefix[0] != 0 or (prefix < 0).any() or (suffix < 0).any()
                  or (prefix[1:] > lengths[:-1]).any() or int(suffix.sum()) > len(tail)):
        raise ParquetError(f"column {column!r}: corrupt DELTA_BYTE_ARRAY prefixes or suffixes")
    lib, _ = _codecs()
    out = np.empty(int(lengths.sum()) if count else 0, np.uint8)
    got = lib.pq_delta_byte_array(prefix.ctypes.data, suffix.ctypes.data, tail.ctypes.data,
                                  len(tail), count, out.ctypes.data, len(out))
    if got < 0:
        raise _failed(lib, got, f"column {column!r}: DELTA_BYTE_ARRAY values")
    return _split_values(memoryview(out), lengths, column)


def _take(values, idx: np.ndarray):
    if isinstance(values, list):
        return [values[i] for i in idx.tolist()]
    return values[idx]


class _Column:
    """One leaf column of the schema."""

    def __init__(self, element: dict):
        self.name = element[4].decode()
        self.ptype = element.get(1)
        rep = element.get(3, REQUIRED)
        if element.get(5) or self.ptype is None:
            raise ParquetError(f"column {self.name!r} is nested; only flat tables are read")
        if rep == REPEATED:
            raise ParquetError(f"column {self.name!r} is repeated; only flat tables are read")
        self.max_def = int(rep == OPTIONAL)
        self.width = element.get(2, 0)                  # FIXED_LEN_BYTE_ARRAY's length
        logical = element.get(10) or {}
        self.utf8 = element.get(6) == UTF8 or 1 in logical
        self.scale = None                               # DECIMAL's scale, else None
        if 5 in logical:
            self.scale = logical[5].get(1, 0)
        elif element.get(6) == DECIMAL:
            self.scale = element.get(7, 0)

    def values(self, buf, encoding: int, count: int, dictionary):
        if encoding == PLAIN:
            return _plain(buf, self, count)
        if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ParquetError(f"column {self.name!r}: dictionary-encoded page "
                                   "without a dictionary page")
            idx = (_rle_hybrid(memoryview(buf)[1:], buf[0], count) if count
                   else np.zeros(0, np.int64))
            return _take(dictionary, idx)
        ptype, name = self.ptype, self.name
        if encoding == RLE and ptype == BOOLEAN:       # a 4-byte length, then 1-bit runs
            ln = int.from_bytes(bytes(buf[:4]), "little")
            return _rle_hybrid(memoryview(buf)[4:4 + ln], 1, count).astype(bool)
        if encoding == DELTA_BINARY_PACKED and ptype in (INT32, INT64):
            vals, _ = _delta_binary_packed(buf, count, 32 if ptype == INT32 else 64, name)
            return vals.astype(np.int32) if ptype == INT32 else vals
        if encoding == DELTA_LENGTH_BYTE_ARRAY and ptype == BYTE_ARRAY:
            lengths, used = _delta_binary_packed(buf, count, 32, name)
            return _split_values(memoryview(buf)[used:], lengths, name)
        if encoding == DELTA_BYTE_ARRAY and ptype in (BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY):
            return _delta_byte_array(buf, count, name)
        if encoding == BYTE_STREAM_SPLIT and ptype in (INT32, INT64, FLOAT, DOUBLE,
                                                       FIXED_LEN_BYTE_ARRAY):
            # byte k of every value, then byte k + 1
            width = (self.width if ptype == FIXED_LEN_BYTE_ARRAY
                     else np.dtype(_PLAIN_DTYPES[ptype]).itemsize)
            raw = np.frombuffer(buf, np.uint8, count * width).reshape(width, count).T.copy()
            if ptype == FIXED_LEN_BYTE_ARRAY:
                return _fixed(raw.tobytes(), width, count)
            return raw.view(_PLAIN_DTYPES[ptype]).reshape(count)
        raise ParquetError(f"column {name!r}: encoding "
                           f"{_ENCODING_NAMES.get(encoding, encoding)} of "
                           f"{_TYPE_NAMES[ptype]} values is not supported")

    def levels(self, buf, count: int):
        """The defined slots of an optional column's page, from its
        definition levels, as a bool mask; None where every slot is."""
        defined = _rle_hybrid(buf, 1, count) == self.max_def
        return None if defined.all() else defined

    def chunk(self, data, meta: dict) -> list:
        """One column chunk, page by page: ``(values, mask)``, ``mask`` the
        page's defined slots (None: all) and ``values`` theirs."""
        codec = meta.get(4, 0)
        total = meta[5]
        pos = min(o for o in (meta.get(9), meta.get(11)) if o is not None and o > 0)
        dictionary, parts, seen = None, [], 0
        while seen < total:
            reader = _CompactReader(data, pos)
            header = reader.struct()
            body = memoryview(data)[reader.pos:reader.pos + header[3]]
            pos = reader.pos + header[3]
            ptype, size = header[1], header[2]
            if ptype == DICTIONARY_PAGE:
                dph = header[7]
                if dph.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                    raise ParquetError(f"column {self.name!r}: dictionary encoding "
                                       f"{_ENCODING_NAMES.get(dph[2], dph[2])}")
                dictionary = _plain(decompress(codec, body, size), self, dph[1])
            elif ptype == DATA_PAGE:
                dph = header[5]
                n = dph[1]
                raw = decompress(codec, body, size)
                off, mask = 0, None
                if self.max_def:
                    if dph.get(3, RLE) != RLE:
                        raise ParquetError(f"column {self.name!r}: definition levels "
                                           f"encoded {_ENCODING_NAMES.get(dph[3], dph[3])}")
                    ln = int.from_bytes(raw[:4], "little")
                    mask = self.levels(memoryview(raw)[4:4 + ln], n)
                    off = 4 + ln
                defined = n if mask is None else int(mask.sum())
                parts.append((self.values(memoryview(raw)[off:], dph[2], defined, dictionary),
                              mask))
                seen += n
            elif ptype == DATA_PAGE_V2:
                dph = header[8]
                n, nulls, rl, dl = dph[1], dph.get(2, 0), dph.get(6, 0), dph.get(5, 0)
                mask = self.levels(body[rl:rl + dl], n) if self.max_def else None
                defined = n if mask is None else int(mask.sum())
                if n - defined != nulls:
                    raise ParquetError(f"column {self.name!r}: the page's definition levels "
                                       f"hold {n - defined} nulls, its header {nulls}")
                vals = body[rl + dl:]
                if dph.get(7, True):
                    vals = decompress(codec, vals, size - rl - dl)
                parts.append((self.values(vals, dph[4], defined, dictionary), mask))
                seen += n
            elif ptype != INDEX_PAGE:
                raise ParquetError(f"column {self.name!r}: unknown page type {ptype}")
        return parts

    def joined(self, parts):
        """The chunks' pages as one column, as pandas gives it."""
        values = [v for v, _ in parts]
        if values and isinstance(values[0], list):
            values = [x for part in values for x in part]
            if self.utf8:
                values = [x.decode("utf-8") for x in values]
        elif values:
            values = np.concatenate(values)
        else:
            values = np.zeros(0, _PLAIN_DTYPES.get(self.ptype, np.float64))
        if self.scale is not None:                     # unscaled two's-complement integers
            values = [decimal.Decimal(int.from_bytes(x, "big", signed=True)
                                      if isinstance(x, bytes) else int(x)).scaleb(-self.scale)
                      for x in values]
        elif self.ptype == INT96:
            values = _int96_datetimes(values.reshape(-1, 12))
        if all(m is None for _, m in parts):
            return values
        mask = np.concatenate([np.ones(len(v), bool) if m is None else m for v, m in parts])
        if isinstance(values, list) or values.dtype == bool:   # objects with a missing value
            missing = float("nan") if self.utf8 else None
            it = iter(values if isinstance(values, list) else values.tolist())
            return [next(it) if d else missing for d in mask.tolist()]
        kind = values.dtype.kind
        out = np.full(len(mask), np.datetime64("NaT") if kind == "M" else np.nan,
                      values.dtype if kind in "fM" else np.float64)
        out[mask] = values
        return out


def read_parquet(path, columns=None) -> dict:
    """Read a flat Parquet table: ``{column name: values}`` in schema order.

    Numeric columns come back as numpy arrays of the dtype pandas gives
    their physical type (BOOLEAN bool, INT32 int32, INT64 int64, FLOAT
    float32, DOUBLE float64, INT96 datetime64[ns]), string columns as lists
    of ``str``, other BYTE_ARRAY and FIXED_LEN_BYTE_ARRAY columns as lists
    of ``bytes`` and DECIMAL columns as lists of ``decimal.Decimal``, each
    in file order over every row group. A column with a null comes back as
    pandas' numpy backend gives it: INT32 and INT64 as float64 with NaN,
    FLOAT and DOUBLE with NaN, INT96 with NaT, BOOLEAN as a list with None,
    strings with NaN and bytes and decimals with None.
    ``columns``: read only these (default all).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ParquetError(f"{path} is not a Parquet file (no PAR1 magic)")
    meta_len = int.from_bytes(data[-8:-4], "little")
    meta = _CompactReader(data, len(data) - 8 - meta_len).struct()
    schema = meta[2]
    leaves = [_Column(e) for e in schema[1:]]
    if len(leaves) != schema[0].get(5, len(leaves)):
        raise ParquetError("nested schema; only flat tables are read")
    names = [c.name for c in leaves]
    want = names if columns is None else list(columns)
    missing = [c for c in want if c not in names]
    if missing:
        raise ParquetError(f"{path} has no column(s) {missing}; it has {names}")
    parts = {c: [] for c in want}
    for group in meta.get(4, []):
        for leaf, chunk in zip(leaves, group[1]):
            if leaf.name in parts:
                if chunk.get(1):
                    raise ParquetError("column chunks in other files are not read")
                parts[leaf.name] += leaf.chunk(data, chunk[3])
    by_name = dict(zip(names, leaves))
    return {c: by_name[c].joined(parts[c]) for c in want}


# -- writer -----------------------------------------------------------------------


def _column_bytes(name: str, values):
    """(physical type, PLAIN bytes, extra schema fields) of one column."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "iuf":
        kinds = {np.dtype(np.int32): INT32, np.dtype(np.int64): INT64,
                 np.dtype(np.float64): DOUBLE}
        if values.dtype not in kinds:
            raise ValueError(f"column {name!r}: dtype {values.dtype} (int32, int64, "
                             "float64 and strings are written)")
        ptype = kinds[values.dtype]
        return ptype, np.ascontiguousarray(values, _PLAIN_DTYPES[ptype]).tobytes(), []
    encoded = [str(v).encode("utf-8") for v in values]
    lengths = np.array([len(v) for v in encoded], "<u4")
    body = b"".join(ln.tobytes() + v for ln, v in zip(lengths, encoded))
    return BYTE_ARRAY, body, [(6, _T_I32, UTF8), (10, _T_STRUCT, [(1, _T_STRUCT, [])])]


def write_parquet(path, columns: dict) -> None:
    """Write ``{name: values}`` as one row group of required columns, PLAIN
    encoded and UNCOMPRESSED. Values: int32, int64 or float64 numpy arrays,
    or sequences of strings, all of one length."""
    lengths = {len(v) for v in columns.values()}
    if len(lengths) != 1:
        raise ValueError(f"columns of different lengths: {sorted(lengths)}")
    n_rows = lengths.pop()
    out = bytearray(MAGIC)
    chunks, schema = [], [[(4, _T_BINARY, "schema"), (5, _T_I32, len(columns))]]
    total = 0
    for name, values in columns.items():
        ptype, body, extra = _column_bytes(name, values)
        page = [(1, _T_I32, DATA_PAGE), (2, _T_I32, len(body)), (3, _T_I32, len(body)),
                (5, _T_STRUCT, [(1, _T_I32, n_rows), (2, _T_I32, PLAIN), (3, _T_I32, RLE),
                                (4, _T_I32, RLE)])]
        header = _encode_struct(page)
        offset = len(out)
        out += header + body
        size = len(header) + len(body)
        total += size
        chunks.append([(2, _T_I64, offset), (3, _T_STRUCT, [
            (1, _T_I32, ptype), (2, _T_LIST, (_T_I32, [PLAIN, RLE])),
            (3, _T_LIST, (_T_BINARY, [name])), (4, _T_I32, 0), (5, _T_I64, n_rows),
            (6, _T_I64, size), (7, _T_I64, size), (9, _T_I64, offset)])])
        schema.append(sorted([(1, _T_I32, ptype), (3, _T_I32, REQUIRED),
                              (4, _T_BINARY, name)] + extra))
    row_group = [(1, _T_LIST, (_T_STRUCT, chunks)), (2, _T_I64, total),
                 (3, _T_I64, n_rows)]
    meta = _encode_struct([(1, _T_I32, 1), (2, _T_LIST, (_T_STRUCT, schema)),
                           (3, _T_I64, n_rows), (4, _T_LIST, (_T_STRUCT, [row_group])),
                           (6, _T_BINARY, "gridnext_tpu_torch")])
    out += meta + len(meta).to_bytes(4, "little") + MAGIC
    with open(path, "wb") as fh:
        fh.write(out)
