#!/usr/bin/env python3
"""Write the Brotli static dictionary that the port's Parquet reader needs.

    python tools/extract_brotli_dictionary.py

writes ``gridnext_tpu_torch/assets/brotli_dictionary.bin``.

A Brotli stream may copy words from the 122,784-byte static dictionary of
RFC 7932, Appendix A. It is data, not code, and the port's decoder
(``gridnext_tpu_torch/csrc/parquet_codec.cpp``) reads it from the
committed asset. This tool reads those bytes out of the system's
``libbrotlicommon.so.1`` on the machine where it runs, through
``ctypes`` (``BrotliGetDictionary()`` returns ``{uint8
size_bits_by_length[32]; uint32 offsets_by_length[32]; size_t
data_size; const uint8 *data}``), checks the length, the SHA-256 below
and the per-length tables against the RFC's, and writes the asset.
Only this tool loads the library; the port never does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import sys

SIZE = 122784
SHA256 = "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"
# RFC 7932 section 8: NDBITS and DOFFSET by word length 0..24
SIZE_BITS = (0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8, 7, 7, 8, 7, 7, 6, 6,
             5, 5)
OFFSETS = (0, 0, 0, 0, 0, 4096, 9216, 21504, 35840, 44032, 53248, 63488, 74752, 87040,
           93696, 100864, 104704, 106752, 108928, 113536, 115968, 118528, 119872, 121280,
           122016)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "gridnext_tpu_torch", "assets", "brotli_dictionary.bin")


class _Dictionary(ctypes.Structure):
    _fields_ = [("size_bits_by_length", ctypes.c_uint8 * 32),
                ("offsets_by_length", ctypes.c_uint32 * 32),
                ("data_size", ctypes.c_size_t),
                ("data", ctypes.POINTER(ctypes.c_uint8))]


def read_dictionary(library: str = "libbrotlicommon.so.1") -> bytes:
    lib = ctypes.CDLL(library)
    lib.BrotliGetDictionary.restype = ctypes.POINTER(_Dictionary)
    d = lib.BrotliGetDictionary().contents
    data = ctypes.string_at(d.data, d.data_size)
    if len(data) != SIZE:
        raise SystemExit(f"{library}: a dictionary of {len(data)} bytes (RFC 7932: {SIZE})")
    if hashlib.sha256(data).hexdigest() != SHA256:
        raise SystemExit(f"{library}: the dictionary's SHA-256 is not RFC 7932's")
    if tuple(d.size_bits_by_length[:25]) != SIZE_BITS or \
            tuple(d.offsets_by_length[:25]) != OFFSETS:
        raise SystemExit(f"{library}: the per-length tables differ from RFC 7932's")
    return data


def main() -> int:
    data = read_dictionary()
    with open(OUT, "wb") as fh:
        fh.write(data)
    print(f"wrote {OUT} ({len(data)} bytes, sha256 {SHA256})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
