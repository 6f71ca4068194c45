"""OCDBT key-value stores and the zarr v2 arrays in them, read and written
in the standard library, numpy and the port's host C++: the layout of an
orbax checkpoint, without orbax or tensorstore.

An orbax checkpoint directory is an OCDBT database (tensorstore's B+tree
key-value store) whose keys are zarr v2 arrays: ``<name>/.zarray`` (JSON)
and ``<name>/<chunk>`` (a chunk, itself a ZSTD frame). On disk:

* ``manifest.ocdbt``: the magic ``0c db 3a 2a``, the file's length (u64
  little-endian), the format version (a varint, 0), a compression byte (0
  none, 1 ZSTD), the body (compressed or not), and the CRC-32C of every
  byte before it (u32 little-endian). The body: the config (uuid, manifest
  kind, the largest value stored inline, the largest decoded node, the
  version tree's arity, the compression method and, for ZSTD, its level as
  an int32), then the newest versions inline (a data-file table, then per
  version its generation, the root's height, location and statistics, and
  the commit time), then references to nodes of older versions.
* B+tree nodes in data files ``d/<hex>``, with the magic ``0c db 20 de``,
  the same header and checksum. A node's body: its height, a data-file
  table, then its entries. A leaf holds keys (prefix-compressed), value
  lengths and kinds, the out-of-line values' (file, offset), then the
  inline values. An interior node holds keys, each subtree's common-prefix
  length, location and statistics; a child's keys leave out its parent's
  key prefix and that common prefix.
* A data-file table names files by path from the database's directory: a
  root database can point into a sub-database's files, as orbax's root
  points into ``ocdbt.process_0/d/``. Values stored out of line are raw
  bytes at (file, offset, length).
* Varints are LEB128; arrays of fields are written field by field (every
  entry's first field, then every entry's second, ...).

:func:`read_store` reads the newest version of a database into a dict;
:func:`write_store` writes one version: nodes and manifest uncompressed
(compression byte 0, which tensorstore reads), values over
``MAX_INLINE_VALUE_BYTES`` out of line in one data file, leaves of at most
``NODE_ENTRIES`` entries under interior nodes of as many children.
:func:`read_zarr` and :func:`zarr_items` read and write zarr v2 arrays; a
written chunk is a ZSTD frame of raw (stored) blocks, valid RFC 8878 that
needs no encoder, so the ``.zarray`` names the compressor orbax names.
Numbered manifests, format versions other than 0, bad checksums, zarr
filters, Fortran order and compressors other than ZSTD (or none) raise a
``ValueError`` that names the file and what it refuses. ZSTD frames decode
with the port's decoder (``csrc/parquet_codec.cpp``'s ``pq_zstd``); the
checksum is its ``pq_crc32c``.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import struct
import time
import uuid
from typing import Callable, Mapping, Optional

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0

# the config written (orbax's own, but for nodes stored uncompressed)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_ENTRIES = 256

_EMPTY = 2 ** 64 - 1                   # the location of an empty tree's root
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_ZSTD_BLOCK = 1 << 17                  # largest raw block

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = (
    ("pq_last_error", (ctypes.c_char_p, ctypes.c_int), ctypes.c_int),
    ("pq_zstd", (_VP, _LL, _VP, _LL), _LL),
    ("pq_crc32c", (_VP, _LL, ctypes.c_uint32), ctypes.c_uint32),
)
_TOO_LARGE = -3


def _lib():
    from gridnext_tpu_torch.ops import _host

    return _host.library("parquet_codec", _SIGNATURES)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    buf = np.frombuffer(data, np.uint8)
    return int(_lib().pq_crc32c(buf.ctypes.data, len(buf), 0))


def zstd_decompress(frame, where: str, size: Optional[int] = None) -> bytes:
    """ZSTD frame(s) decoded by the port's decoder: exactly ``size`` bytes
    when given, else at most ``MAX_DECODED_NODE_BYTES`` (tensorstore's
    frames carry no content size; the buffer grows until it fits). Raises
    ``ValueError`` naming ``where``."""
    lib = _lib()
    src = np.frombuffer(frame, np.uint8)
    limit = MAX_DECODED_NODE_BYTES
    cap = size if size is not None else min(limit, max(1 << 16, 8 * len(src)))
    while True:
        dst = np.empty(max(cap, 1), np.uint8)
        got = lib.pq_zstd(src.ctypes.data, len(src), dst.ctypes.data, cap)
        if got == _TOO_LARGE and size is None and cap < limit:
            cap = min(limit, 4 * cap)
            continue
        if got < 0:
            msg = ctypes.create_string_buffer(256)
            lib.pq_last_error(msg, 256)
            raise ValueError(f"{where}: ZSTD frame does not decode: {msg.value.decode()}")
        if size is not None and got != size:
            raise ValueError(f"{where}: ZSTD frame decodes to {got} bytes, not {size}")
        return dst[:got].tobytes()


def zstd_raw_frame(data) -> bytes:
    """``data`` as one ZSTD frame of raw blocks (RFC 8878 3.1.1: single
    segment, 8-byte content size, no checksum)."""
    data = memoryview(bytes(data))
    out = [_ZSTD_MAGIC, b"\xe0", struct.pack("<Q", len(data))]
    starts = range(0, len(data), _ZSTD_BLOCK) if len(data) else [0]
    for i, start in enumerate(starts):
        block = data[start:start + _ZSTD_BLOCK]
        last = i == len(starts) - 1
        out.append((int(last) | len(block) << 3).to_bytes(3, "little"))
        out.append(block)
    return b"".join(out)


# -- reading ---------------------------------------------------------------------


class _Cursor:
    """Little-endian fields and LEB128 varints over one decoded body; a
    read past its end raises naming the file."""

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            self.fail(f"truncated: {n} bytes wanted at byte {self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail(f"a varint longer than 10 bytes at byte {self.pos}")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]


def _decode_file(data: bytes, magic: int, where: str) -> _Cursor:
    """Check a manifest's or node's header and checksum; the cursor over its
    (decompressed) body."""
    if len(data) < 18:
        raise ValueError(f"{where}: {len(data)} bytes is too short for an OCDBT file")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{where}: magic {got_magic:08x}, not OCDBT's {magic:08x}")
    if length != len(data):
        raise ValueError(f"{where}: header says {length} bytes, the file has {len(data)}")
    stored = struct.unpack("<I", data[-4:])[0]
    actual = crc32c(memoryview(data)[:-4])
    if stored != actual:
        raise ValueError(f"{where}: bad checksum: stored CRC-32C {stored:08x}, "
                         f"computed {actual:08x}")
    cur = _Cursor(bytes(data[12:-4]), where)
    version = cur.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{where}: OCDBT format version {version} is refused "
                         f"(this reader knows version {FORMAT_VERSION})")
    compression = cur.byte()
    if compression == 1:
        return _Cursor(zstd_decompress(cur.buf[cur.pos:], where), where)
    if compression != 0:
        raise ValueError(f"{where}: compression format {compression} is refused "
                         "(0 none and 1 ZSTD are read)")
    return _Cursor(cur.buf[cur.pos:], where)


def _data_file_table(cur: _Cursor) -> list:
    """Paths of a data-file table (prefix-compressed against the previous
    path; each path is its base path followed by its relative path)."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)                          # base-path lengths: part of the path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail(f"a data-file path shares {p} bytes with one of {len(prev)}")
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


def _keys(cur: _Cursor, n: int, extra: bool = False):
    """``n`` prefix-compressed keys (and, for interior nodes, the subtree
    common-prefix lengths, which sit between the lengths and the bytes)."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if extra else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            cur.fail(f"a key shares {p} bytes with one of {len(prev)}")
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, common


def _config(cur: _Cursor) -> dict:
    cfg = {"uuid": cur.take(16).hex(), "manifest_kind": cur.varint(),
           "max_inline_value_bytes": cur.varint(), "max_decoded_node_bytes": cur.varint(),
           "version_tree_arity_log2": cur.byte(), "compression": cur.varint()}
    if cfg["compression"] == 1:
        cfg["zstd_level"] = struct.unpack("<i", cur.take(4))[0]
    elif cfg["compression"] != 0:
        cur.fail(f"config compression method {cfg['compression']} is refused "
                 "(0 none and 1 ZSTD are read)")
    if cfg["manifest_kind"] != 0:
        cur.fail(f"manifest kind {cfg['manifest_kind']} (numbered manifests) is refused; "
                 "single-file manifests (kind 0) are read")
    return cfg


class _Files:
    """Data files of one database, read once each."""

    def __init__(self, root: str):
        self.root, self.cache = root, {}

    def read(self, path: str, offset: int, length: int, where: str) -> memoryview:
        if path not in self.cache:
            full = os.path.join(self.root, path)
            if not os.path.isfile(full):
                raise ValueError(f"{where}: refers to the missing data file {full}")
            with open(full, "rb") as fh:
                self.cache[path] = memoryview(fh.read())
        data = self.cache[path]
        if offset + length > len(data):
            raise ValueError(f"{where}: bytes {offset}..{offset + length} lie past the end "
                             f"of {os.path.join(self.root, path)} ({len(data)} bytes)")
        return data[offset:offset + length]


def read_manifest(root) -> dict:
    """The config and newest version of the database at ``root``:
    ``{"config", "height", "root": (path, offset, length) or None,
    "num_keys"}``."""
    where = os.path.join(str(root), "manifest.ocdbt")
    if not os.path.isfile(where):
        raise ValueError(f"{where}: no OCDBT manifest")
    with open(where, "rb") as fh:
        cur = _decode_file(fh.read(), MANIFEST_MAGIC, where)
    cfg = _config(cur)
    paths = _data_file_table(cur)
    n = cur.varint()
    if n == 0:
        cur.fail("the manifest holds no version")
    gens, heights = cur.varints(n), [cur.byte() for _ in range(n)]
    files, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
    num_keys = cur.varints(n)
    cur.varints(2 * n)                    # tree bytes, indirect value bytes
    [cur.u64() for _ in range(n)]         # commit times
    i = max(range(n), key=gens.__getitem__)
    if offsets[i] == _EMPTY and lengths[i] == _EMPTY:
        loc = None
    else:
        if files[i] >= len(paths):
            cur.fail(f"the root names data file {files[i]} of {len(paths)}")
        loc = (paths[files[i]], offsets[i], lengths[i])
    return {"config": cfg, "height": heights[i], "root": loc, "num_keys": num_keys[i]}


def read_store(root) -> dict:
    """Every key of the newest version of the OCDBT database at ``root``,
    as ``{key (str): value (bytes-like)}``."""
    root = str(root)
    manifest = read_manifest(root)
    files, out = _Files(root), {}
    if manifest["root"] is None:
        return out
    limit = manifest["config"]["max_decoded_node_bytes"]
    stack = [(manifest["root"], manifest["height"], b"")]
    while stack:
        (path, offset, length), height, prefix = stack.pop()
        where = f"{os.path.join(root, path)} (node at byte {offset})"
        node = _decode_file(files.read(path, offset, length, where), NODE_MAGIC, where)
        if len(node.buf) > limit:
            node.fail(f"a node of {len(node.buf)} bytes, over the config's {limit}")
        if node.byte() != height:
            node.fail(f"node height is not the {height} its parent gives")
        table = _data_file_table(node)
        n = node.varint()
        if height == 0:
            keys, _ = _keys(node, n)
            lengths = node.varints(n)
            kinds = [node.byte() for _ in range(n)]
            if any(k > 1 for k in kinds):
                node.fail(f"value kind {max(kinds)} is refused (0 inline, 1 out of line)")
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids, offs = node.varints(len(indirect)), node.varints(len(indirect))
            refs = dict(zip(indirect, zip(ids, offs)))
            for i, key in enumerate(keys):
                if i in refs:
                    fid, off = refs[i]
                    if fid >= len(table):
                        node.fail(f"a value names data file {fid} of {len(table)}")
                    value = files.read(table[fid], off, lengths[i], where)
                else:
                    value = node.take(lengths[i])
                out[(prefix + key).decode()] = value
        else:
            keys, common = _keys(node, n, extra=True)
            ids, offs, lens = node.varints(n), node.varints(n), node.varints(n)
            node.varints(3 * n)            # statistics
            for key, c, fid, off, ln in zip(keys, common, ids, offs, lens):
                if fid >= len(table) or c > len(key):
                    node.fail("an interior entry names a missing file or prefix")
                stack.append(((table[fid], off, ln), height - 1, prefix + key[:c]))
    return out


# -- writing ---------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _encode_file(body: bytes, magic: int) -> bytes:
    """Header (uncompressed), body, CRC-32C."""
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(body) + 4) \
        + _varint(FORMAT_VERSION) + b"\x00"
    data = head + body
    return data + struct.pack("<I", crc32c(data))


def _table(path: str) -> bytes:
    p = path.encode()
    return _varint(1) + _varint(len(p)) + _varint(0) + p


def _key_block(keys: list) -> bytes:
    """Keys without prefix compression (every shared prefix 0)."""
    return _varints([0] * (len(keys) - 1)) + _varints(len(k) for k in keys)


def write_store(root, items: Mapping[str, bytes]) -> None:
    """Write ``items`` as a fresh OCDBT database at ``root`` (a directory
    that holds no database yet): one data file ``d/<hex>`` with the
    out-of-line values and every node, then ``manifest.ocdbt``."""
    root = str(root)
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise ValueError(f"{root}: already holds an OCDBT database")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    path = f"d/{uuid.uuid4().hex}"
    table = _table(path)
    entries = sorted((k.encode(), bytes(v)) for k, v in items.items())
    chunks, pos = [], 0

    def put(data: bytes) -> int:
        nonlocal pos
        chunks.append(data)
        pos += len(data)
        return pos - len(data)

    level = []                  # (first key, offset, length, keys, tree bytes, indirect)
    for s in range(0, len(entries), NODE_ENTRIES):
        group = entries[s:s + NODE_ENTRIES]
        keys = [k for k, _ in group]
        out_of_line = [len(v) > MAX_INLINE_VALUE_BYTES for _, v in group]
        offsets = [put(v) for (_, v), far in zip(group, out_of_line) if far]
        body = b"".join([b"\x00", table, _varint(len(group)), _key_block(keys), *keys,
                         _varints(len(v) for _, v in group), bytes(out_of_line),
                         _varints([0] * len(offsets)), _varints(offsets),
                         *[v for (_, v), far in zip(group, out_of_line) if not far]])
        node = _encode_file(body, NODE_MAGIC)
        indirect = sum(len(v) for (_, v), far in zip(group, out_of_line) if far)
        level.append((keys[0], put(node), len(node), len(group), len(node), indirect))
    height = 0
    while len(level) > 1:
        height += 1
        parents = []
        for s in range(0, len(level), NODE_ENTRIES):
            group = level[s:s + NODE_ENTRIES]
            keys = [g[0] for g in group]
            cols = list(zip(*group))[1:]
            body = b"".join([bytes([height]), table, _varint(len(group)), _key_block(keys),
                             _varints([0] * len(group)), *keys, _varints([0] * len(group)),
                             *[_varints(c) for c in cols]])
            node = _encode_file(body, NODE_MAGIC)
            parents.append((keys[0], put(node), len(node), sum(cols[2]),
                            sum(cols[3]) + len(node), sum(cols[4])))
        level = parents
    with open(os.path.join(root, path), "wb") as fh:
        for c in chunks:
            fh.write(c)
    if level:
        _, offset, length, num_keys, tree_bytes, indirect = level[0]
    else:                               # an empty tree: tensorstore's empty root,
        offset = length = _EMPTY        # file 0 of a table naming ""
        num_keys = tree_bytes = indirect = 0
        table = _varints([1, 0, 0])
    config = b"".join([uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
                       _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]),
                       _varint(0)])
    version = b"".join([_varint(1), _varint(1), bytes([height]),
                        _varints([0, offset, length, num_keys, tree_bytes, indirect]),
                        struct.pack("<Q", time.time_ns())])
    manifest = _encode_file(config + table + version + _varint(0), MANIFEST_MAGIC)
    tmp = os.path.join(root, f"manifest.ocdbt.tmp-{os.getpid()}")
    with open(tmp, "wb") as fh:
        fh.write(manifest)
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))


# -- zarr v2 arrays --------------------------------------------------------------


def _zarr_dtype(spec, where: str) -> np.dtype:
    if not isinstance(spec, str):
        raise ValueError(f"{where}: structured zarr dtype {spec!r} is refused")
    try:
        dt = np.dtype(spec)
    except TypeError:
        raise ValueError(f"{where}: zarr dtype {spec!r} is refused "
                         "(numpy's bool, integer and float types are read)") from None
    if dt.kind not in "biuf":
        raise ValueError(f"{where}: zarr dtype {spec!r} is refused "
                         "(numpy's bool, integer and float types are read)")
    return dt


def _fill(value, dt: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_zarr(get: Callable, name: str, where: str) -> np.ndarray:
    """The zarr v2 array ``name`` of a key-value store (``get(key)``: the
    value's bytes, or None when absent); ``where`` names the store in
    errors."""
    at = f"{where} ({name}/.zarray)"
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"{at}: no such array")
    meta = json.loads(bytes(raw))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{at}: zarr_format {meta.get('zarr_format')!r} is refused (2 is read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{at}: order {meta['order']!r} is refused (C is read)")
    if meta.get("filters"):
        raise ValueError(f"{at}: zarr filters {meta['filters']!r} are refused")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{at}: compressor {comp.get('id')!r} is refused (zstd or none)")
    dt = _zarr_dtype(meta["dtype"], at)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dt), dt)
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    for index in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(str(i) for i in index) if index else "0")
        data = get(key)
        if data is None:
            continue
        if comp is not None:
            data = zstd_decompress(data, f"{where} ({key})", size=nbytes)
        elif len(data) != nbytes:
            raise ValueError(f"{where} ({key}): {len(data)} bytes, a chunk holds {nbytes}")
        chunk = np.frombuffer(data, dt).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    return out


def zarr_items(name: str, array: np.ndarray) -> dict:
    """``{key: bytes}`` of ``array`` as one-chunk zarr v2 under ``name``,
    in the form tensorstore writes for orbax (ZSTD compressor, '.'
    separator, C order)."""
    a = np.asarray(array)
    dt = a.dtype.newbyteorder("<") if a.dtype.byteorder == ">" else a.dtype
    a = a.astype(dt, copy=False)            # tobytes() below is C order
    meta = {"chunks": list(a.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dt.str, "fill_value": None,
            "filters": None, "order": "C", "shape": list(a.shape), "zarr_format": 2}
    chunk = ".".join("0" for _ in a.shape) if a.shape else "0"
    return {f"{name}/.zarray": json.dumps(meta, separators=(",", ":")).encode(),
            f"{name}/{chunk}": zstd_raw_frame(a.tobytes())}
