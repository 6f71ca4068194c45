"""The unified count caches' codec: gzip TSV matrices, written and read on a
thread pool with numpy and the standard library's ``zlib``.

The port's counterpart of the JAX package's native codec
(``gridnext_tpu/native/__init__.py:128-255``, ``native/fastio.cpp``), with
the same file:

* a header line ``<index_name><TAB><col>...``, then one line a row,
  ``<name><TAB><value>...``; integral values are written as integers
  (all of them with ``force_int``), others as ``%.17g``;
* gzip as a chain of RFC 1952 members: the header in one, then the rows
  cut into ~4 MB raw chunks, each its own member whose header carries
  ``FLG=FEXTRA``, ``XLEN=8`` and a ``GX`` subfield holding the member's
  total size as a little-endian u32 (``fastio.cpp:36-105``). zlib level 1.
  The file stays an ordinary ``.tsv.gz``; the size fields let a reader
  find every member without inflating (``fastio.cpp:227-259``).

The reader walks that chain, then inflates and parses the members on a
``concurrent.futures`` thread pool (``zlib`` releases the GIL while it
inflates, numpy while it scans). A member whose cells are all unsigned
integers is parsed in bulk: separator positions, then the digits of every
cell at once. Any other member (empty cells, floats, signs, CRLF lines) is
parsed line by line as :func:`parse_rows_slow` does: an empty cell is NaN,
as pandas reads it, and a row with the wrong number of cells raises. A gzip
file without the ``GX`` chain (pandas', a single member) inflates serially,
and its text is cut at line boundaries and parsed in parallel. A file that
starts a ``GX`` chain but breaks it raises ``ValueError`` naming the
framing; so does a gzip stream that ends early.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import itertools
import os
import struct
import warnings
import zlib
from typing import Optional, Sequence

import numpy as np

_HEADER_LEN = 20          # base header (10) + XLEN (2) + the GX subfield (8)
_TRAILER_LEN = 8          # CRC32 + ISIZE
_CHUNK_BYTES = 4 << 20    # raw bytes a row member holds (the JAX writer's)
_MAX_BULK_DIGITS = 15     # longer integers go the line-by-line way (float64-exact)
_tmp_serial = itertools.count()


def workers() -> int:
    """Threads of the codec's pool: the host's cores, at most 16 (the JAX
    writer's cap)."""
    return max(1, min(os.cpu_count() or 1, 16))


def _pool_map(fn, items):
    items = list(items)
    if len(items) <= 1 or workers() == 1:
        return [fn(it) for it in items]
    with concurrent.futures.ThreadPoolExecutor(min(workers(), len(items))) as pool:
        return list(pool.map(fn, items))


# -- formatting -------------------------------------------------------------------


def format_int_rows(values: np.ndarray, names: Optional[Sequence[bytes]] = None,
                    sep: int = 9) -> bytes:
    """The text of an integer matrix, one line a row: ``name`` then each
    value behind ``sep`` (with ``names``), or the values joined by ``sep``
    (without). Vectorised: every cell is a fixed-width slot of bytes, the
    unused ones masked out in one pass."""
    v = np.asarray(values, np.int64)
    n, k = v.shape
    if n == 0:
        return b""
    a = np.abs(v)
    n_digits = np.ones(v.shape, np.int8)
    power = 10
    while True:
        more = a >= power
        if not more.any():
            break
        n_digits += more
        power *= 10
    width = int(n_digits.max())
    slot = 2 + width                        # separator, sign, digits
    cells = np.empty((n, k, slot), np.uint8)
    keep = np.empty((n, k, slot), bool)
    cells[..., 0] = sep
    keep[..., 0] = True
    if names is None and k:
        keep[:, 0, 0] = False
    cells[..., 1] = ord("-")
    keep[..., 1] = v < 0
    for j in range(width):
        cells[..., 2 + j] = (a // 10 ** (width - 1 - j)) % 10 + 48
        keep[..., 2 + j] = n_digits >= width - j
    parts, masks = [cells.reshape(n, k * slot)], [keep.reshape(n, k * slot)]
    if names is not None:
        lens = np.fromiter((len(s) for s in names), np.int64, count=n)
        longest = max(int(lens.max()), 1)
        lead = np.frombuffer(b"".join(s.ljust(longest, b"\0") for s in names),
                             np.uint8).reshape(n, longest)
        parts.insert(0, lead)
        masks.insert(0, np.arange(longest) < lens[:, None])
    parts.append(np.full((n, 1), 10, np.uint8))
    masks.append(np.ones((n, 1), bool))
    return np.concatenate(parts, axis=1)[np.concatenate(masks, axis=1)].tobytes()


def _format_rows(names: Sequence[bytes], values: np.ndarray, force_int: bool) -> bytes:
    """Rows of the TSV: integers verbatim, other values as ``%.17g`` (the
    JAX writer's ``v == (int64)v`` rule)."""
    if values.dtype.kind in "iu":
        return format_int_rows(values, names)
    if force_int:
        return format_int_rows(np.trunc(values).astype(np.int64), names)
    integral = np.isfinite(values) & (values == np.trunc(values))
    if integral.all():
        return format_int_rows(values.astype(np.int64), names)
    lines = []
    for name, row, ok in zip(names, values, integral):
        cells = [b"%d" % int(x) if o else (b"%.17g" % x) for x, o in zip(row.tolist(), ok)]
        lines.append(b"\t".join([name] + cells) + b"\n")
    return b"".join(lines)


def gx_member(raw: bytes, level: int = 1) -> bytes:
    """``raw`` as one gzip member carrying its own size in a ``GX`` EXTRA
    subfield (MTIME 0, OS unknown: ``fastio.cpp:64-105``)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(raw) + co.flush()
    size = _HEADER_LEN + len(body) + _TRAILER_LEN
    if size > 0xFFFFFFFF or len(raw) > 0xFFFFFFFF:
        raise ValueError("a GX member must stay below 4 GiB")
    header = (b"\x1f\x8b\x08\x04" + b"\0\0\0\0" + b"\x00\xff"
              + struct.pack("<H2sHI", 8, b"GX", 4, size))
    return header + body + struct.pack("<II", zlib.crc32(raw), len(raw))


def write_tsv_matrix(path, index, columns, values: np.ndarray, index_name: str = "Gene",
                     gzip_level: Optional[int] = 1, force_int: bool = False) -> None:
    """Write a (rows x cols) numeric matrix as TSV; ``.gz`` paths as the
    ``GX`` member chain (level ``gzip_level``, default 1), others plain.

    The rows are formatted and compressed on the thread pool, written to a
    sibling temporary file and moved onto ``path`` with ``os.replace``, so
    an interrupted write never leaves a truncated cache."""
    values = np.asarray(values)
    if values.dtype.kind not in "iu":
        values = values.astype(np.float64, copy=False)
    if values.ndim != 2 or len(index) != values.shape[0] or len(columns) != values.shape[1]:
        raise ValueError(f"shape mismatch: values {values.shape} vs {len(index)} index "
                         f"names and {len(columns)} column names")
    gz = str(path).endswith(".gz")
    level = 1 if gzip_level is None or gzip_level < 0 else int(gzip_level)
    names = [str(s).encode() for s in index]
    n_rows, n_cols = values.shape
    chunk_rows = max(64, _CHUNK_BYTES // max(1, n_cols * 6 + 24))
    header = "\t".join([index_name] + [str(c) for c in columns]).encode() + b"\n"

    def chunk(lo):
        raw = _format_rows(names[lo:lo + chunk_rows], values[lo:lo + chunk_rows], force_int)
        return gx_member(raw, level) if gz else raw

    body = _pool_map(chunk, range(0, n_rows, chunk_rows))
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_serial)}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(gx_member(header, level) if gz else header)
            for b in body:
                fh.write(b)
        os.replace(tmp, str(path))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


# -- framing ----------------------------------------------------------------------


def gzip_member_format(path) -> Optional[str]:
    """A file's gzip framing: ``'native'`` (the first member carries the
    ``GX`` size subfield), ``'foreign'`` (gzip without it, e.g. pandas'
    single member) or None (not gzip). ``native/__init__.py:171-192``."""
    with open(str(path), "rb") as fh:
        head = fh.read(4096)
    return _framing(head)


def _framing(head) -> Optional[str]:
    if len(head) < 18 or head[:2] != b"\x1f\x8b" or head[2] != 8:
        return None
    if not head[3] & 0x04:
        return "foreign"
    xlen = int.from_bytes(head[10:12], "little")
    extra = head[12:12 + xlen]
    i = 0
    while i + 4 <= len(extra):
        sid, slen = extra[i:i + 2], int.from_bytes(extra[i + 2:i + 4], "little")
        if sid == b"GX" and slen == 4:
            return "native"
        i += 4 + slen
    return "foreign"


def member_chain(data) -> list:
    """``[(offset, size), ...]`` of the ``GX`` members of ``data``
    (``fastio.cpp:227-259``). Raises ValueError at the first member that
    is not one, or whose size runs past the end of the file."""
    members, off, n = [], 0, len(data)
    while off < n:
        where = f"GX member chain broken at byte {off} of {n}"
        if off + _HEADER_LEN + _TRAILER_LEN > n:
            raise ValueError(f"{where}: truncated member header")
        if bytes(data[off:off + 4]) != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{where}: not a gzip member with FEXTRA")
        xlen = int.from_bytes(data[off + 10:off + 12], "little")
        p, end, size = off + 12, off + 12 + xlen, 0
        while p + 4 <= end:
            slen = int.from_bytes(data[p + 2:p + 4], "little")
            if bytes(data[p:p + 2]) == b"GX" and slen == 4:
                size = int.from_bytes(data[p + 4:p + 8], "little")
                break
            p += 4 + slen
        if size < _HEADER_LEN + _TRAILER_LEN:
            raise ValueError(f"{where}: no GX size subfield")
        if off + size > n:
            raise ValueError(f"{where}: the member's {size} bytes run past the end "
                             "(truncated file)")
        members.append((off, size))
        off += size
    return members


def inflate(path) -> tuple:
    """``(framing, pieces)``: the file's text as a list of byte strings
    (the ``GX`` members inflated on the pool, in order; else one string).
    ``framing`` is ``'native'``, ``'foreign'`` or None (plain text)."""
    with open(str(path), "rb") as fh:
        data = fh.read()
    framing = _framing(data[:4096])
    if framing is None:
        return None, [data]
    if framing == "native":
        view = memoryview(data)
        try:
            chain = member_chain(view)
            pieces = _pool_map(lambda m: zlib.decompress(view[m[0]:m[0] + m[1]], 31), chain)
        except (ValueError, zlib.error) as e:
            raise ValueError(f"{path}: unreadable GX-framed gzip: {e}") from e
        return framing, pieces
    try:
        return framing, [gzip.decompress(data)]
    except (EOFError, OSError, zlib.error) as e:
        raise ValueError(f"{path}: unreadable gzip stream: {e}") from e


# -- parsing ----------------------------------------------------------------------


def _row_values(fields: bytes, n: int) -> np.ndarray:
    """One row's tab-separated numbers as float64; an empty cell is NaN (as
    pandas reads it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            values = np.fromstring(fields, dtype=np.float64, sep="\t")
        except (DeprecationWarning, ValueError):
            values = None
    if values is not None and len(values) == n:
        return values
    cells = fields.split(b"\t")
    if len(cells) != n:
        raise ValueError(f"a row has {len(cells)} values for {n} columns")
    return np.array([float(c) if c.strip() else np.nan for c in cells], np.float64)


def parse_rows_slow(text: bytes, n: int) -> tuple:
    """``(names, values)`` of TSV rows, one line at a time: blank lines
    skipped, CR/LF stripped, :func:`_row_values` for the cells."""
    names, rows = [], []
    for line in text.split(b"\n"):
        line = line.rstrip(b"\r\n")
        if not line:
            continue
        name, _, fields = line.partition(b"\t")
        names.append(name.decode())
        rows.append(_row_values(fields, n) if n else np.zeros(0, np.float64))
    values = np.stack(rows) if rows else np.zeros((0, n), np.float64)
    return names, values


def parse_rows(text: bytes, n: int) -> tuple:
    """``(names, values)`` of TSV rows with ``n`` cells each. In bulk
    where every line holds a name and ``n`` unsigned integers of at most
    15 digits; else :func:`parse_rows_slow` (same results, one line at a
    time)."""
    if n == 0 or not text:
        return parse_rows_slow(text, n)
    if not text.endswith(b"\n"):
        text += b"\n"
    b = np.frombuffer(text, np.uint8)
    is_nl = b == 10
    is_sep = is_nl | (b == 9)
    seps = np.flatnonzero(is_sep)
    lines = int(np.count_nonzero(is_nl))
    if len(seps) != lines * (n + 1):
        return parse_rows_slow(text, n)
    seps = seps.reshape(lines, n + 1)
    nl, first = seps[:, -1], seps[:, 0]
    if not is_nl[nl].all():
        return parse_rows_slow(text, n)       # a line without its n cells
    span = np.diff(seps, axis=1)              # cell length + 1
    if span.min() < 2 or span.max() > _MAX_BULK_DIGITS + 1:
        return parse_rows_slow(text, n)       # empty cells, long tokens
    digit = b - np.uint8(48)
    other = np.flatnonzero((digit > 9) & ~is_sep)
    if len(other) and (other > first[np.searchsorted(nl, other)]).any():
        return parse_rows_slow(text, n)       # a cell that is not an unsigned integer
    last = seps[:, 1:].ravel() - 1            # each cell's last digit
    span = span.ravel()
    values = digit[last].astype(np.float64)
    more, k = np.flatnonzero(span > 2), 1
    while len(more):
        values[more] += digit[last[more] - k] * 10.0 ** k
        k += 1
        more = more[span[more] > k + 1]
    starts = np.concatenate(([0], nl[:-1] + 1)).tolist()
    names = [text[s:t].decode() for s, t in zip(starts, first.tolist())]
    return names, values.reshape(lines, n)


def _line_pieces(pieces: list, parts: int) -> list:
    """The text after the header, as pieces that each end at a line end:
    the members as they are where each ends with a newline, else the text
    cut into ``parts`` pieces at line boundaries."""
    out = [p for p in pieces if p]
    if len(out) <= 1 and (not out or len(out[0]) <= _CHUNK_BYTES):
        return out
    if len(out) > 1 and all(p.endswith(b"\n") for p in out[:-1]):
        return out
    text = b"".join(out)
    out, start, step = [], 0, max(1, len(text) // parts)
    while start < len(text):
        cut = text.find(b"\n", start + step)
        cut = len(text) if cut < 0 else cut + 1
        out.append(text[start:cut])
        start = cut
    return out


def _split_header(pieces: list) -> tuple:
    """(header line, the remaining pieces)."""
    first = pieces[0] if pieces else b""
    cut = first.find(b"\n")
    if cut < 0:
        return first, pieces[1:]
    return first[:cut], [first[cut + 1:]] + pieces[1:]


def read_tsv_matrix(path, migrate: bool = False) -> tuple:
    """``(row_names, col_names, values)`` of a numeric TSV(.gz): the first
    column's names, the header's column names and the float64 matrix.

    ``migrate=True``: after reading a gzip file without the ``GX`` chain,
    rewrite it in the chain (value-exact: integers verbatim, other values
    as ``%.17g``), so later reads inflate on the pool. Only for the
    package's own caches; a rewrite that fails leaves the file as it was
    and warns."""
    framing, pieces = inflate(path)
    header, rest = _split_header(pieces)
    header = header.rstrip(b"\r\n").split(b"\t")
    index_name, columns = header[0].decode(), [c.decode() for c in header[1:]]
    parsed = _pool_map(lambda t: parse_rows(t, len(columns)),
                       _line_pieces(rest, 4 * workers()))
    rows = [name for names, _ in parsed for name in names]
    values = (np.concatenate([v for _, v in parsed]) if parsed
              else np.zeros((0, len(columns)), np.float64))
    if migrate and framing == "foreign" and os.access(str(path), os.W_OK):
        try:
            write_tsv_matrix(path, rows, columns, values, index_name=index_name or "Gene")
        except OSError as e:
            warnings.warn(f"{path}: could not rewrite the cache in the GX framing ({e}); "
                          "it stays single-member and inflates serially")
    return rows, columns, values


def read_row_names(path) -> list:
    """The first column of a TSV(.gz) below its header, without parsing
    the values (blank lines skipped)."""
    _, pieces = inflate(path)
    _, rest = _split_header(pieces)

    def names(text):
        return [ln.split(b"\t", 1)[0].decode() for ln in text.split(b"\n") if ln.strip()]

    return [g for part in _pool_map(names, _line_pieces(rest, 4 * workers())) for g in part]
