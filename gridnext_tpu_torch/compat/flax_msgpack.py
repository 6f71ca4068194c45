"""The flax msgpack checkpoint format, read and written with the standard
library and numpy.

The counterpart of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize``, which the JAX package's ``save_checkpoint`` and
``load_checkpoint`` use for a model directory's ``g_state.msgpack``; the
card machine has neither flax nor ``msgpack``. The format is msgpack
(maps, arrays, str, bin, nil, bool, ints and floats of every width) with
three extension types:

* 1, an ndarray: the msgpack array ``[shape, dtype name, C-order bytes]``
  (bfloat16 is widened to float32 on read: it is the high half of a
  float32);
* 2, a complex: ``[real, imag]``;
* 3, a numpy scalar, packed as a 0-d ndarray.

Arrays over 2**30 bytes are stored as ``{"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": ...}}`` maps of flat chunks.
:func:`packb` writes what ``msgpack_serialize`` writes for a tree of dicts
with str keys (sorted, as its ``tree_map`` copy sorts them), lists, Python
scalars, None and numpy leaves, byte for byte.
"""

from __future__ import annotations

import struct

import numpy as np

# msgpack's per-object limit is 2**31 - 1 bytes; flax chunks above this
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# -- decoding ------------------------------------------------------------------


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        return self.buf[start:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_value(code, self.take(n))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        handler = _HANDLERS.get(b)
        if handler is None:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")
        return handler(self)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


_HANDLERS = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.string(r.unpack(">B")),
    0xDA: lambda r: r.string(r.unpack(">H")),
    0xDB: lambda r: r.string(r.unpack(">I")),
    0xDC: lambda r: [r.value() for _ in range(r.unpack(">H"))],
    0xDD: lambda r: [r.value() for _ in range(r.unpack(">I"))],
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


class ExtType(tuple):
    """An extension object of a type the format does not define:
    ``(code, data)``, as ``msgpack.ExtType`` keeps it."""

    def __new__(cls, code: int, data: bytes):
        return super().__new__(cls, (code, data))


def _ndarray(data) -> np.ndarray:
    r = _Reader(data, raw=True)
    shape, dtype_name, buffer = r.value()
    if dtype_name == b"bfloat16":
        # bfloat16 is the high half of a float32: widen without ml_dtypes
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1).reshape(shape, order="C")


def _ext_value(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = _Reader(data, raw=False).value()
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return ExtType(code, bytes(data))


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data):
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data`` (bfloat16 arrays widened to float32; arrays are read-only views
    of ``data``)."""
    r = _Reader(data, raw=False)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the "
                         "msgpack object")
    return _unchunk(out)


# -- encoding ------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    form (``codes``; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 0x100:
        out += struct.pack(">BB", codes[0], n)
    elif n < 0x10000:
        out += struct.pack(">BH", codes[1], n)
    elif n < 0x100000000:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object of {n} items or bytes is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v + 0x100)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 0x100), (0xCD, ">BH", 0x10000),
                               (0xCE, ">BI", 0x100000000), (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                               (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _pack(out, [list(a.shape), a.dtype.name, a.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out += struct.pack(">Bd", 0xCB, v)
    elif type(v) is str:
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif type(v) is bytes:
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif type(v) in (list, tuple):
        _pack_len(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif type(v) is dict:
        _pack_len(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif type(v) is complex:
        body = bytearray()
        _pack(body, [v.real, v.imag])
        _pack_ext(out, _EXT_COMPLEX, bytes(body))
    else:
        raise TypeError(f"cannot serialize {type(v).__name__} in a flax msgpack tree")


def _sorted(tree):
    """The tree with every dict's keys sorted, as ``jax.tree_util.tree_map``
    rebuilds it."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _chunk(tree):
    """Arrays over MAX_CHUNK_SIZE bytes as flax's chunked-array maps (keys in
    flax's order)."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        step = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {_CHUNKED: True,
                "shape": {str(i): int(n) for i, n in enumerate(tree.shape)},
                "chunks": {str(i): flat[j:j + step]
                           for i, j in enumerate(range(0, flat.size, step))}}
    return tree


def packb(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``: dict keys sorted at
    every level, oversized arrays chunked."""
    out = bytearray()
    _pack(out, _chunk(_sorted(tree)))
    return bytes(out)
