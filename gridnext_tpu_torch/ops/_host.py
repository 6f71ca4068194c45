"""Build and load the package's host C++ libraries (``csrc/*.cpp``).

The sibling of :mod:`gridnext_tpu_torch.ops._cuda` for code that runs on
the CPU: each source compiles with the host C++ compiler (``$CXX``, else
``g++``, the compiler ``nvcc`` drives) into its own shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
into ``gridnext_tpu_torch/_build/`` (ignored by git); the library name
carries a hash of the source and the flags, so an edited source rebuilds,
and the compiler writes a pid-unique temporary file that is renamed into
place, so a concurrent loader never sees half a library. A failed build
raises ``RuntimeError`` with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

from gridnext_tpu_torch.ops._cuda import BUILD_DIR, CSRC_DIR

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return cxx


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cpp`` (hash-named)."""
    with open(os.path.join(CSRC_DIR, f"{name}.cpp"), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` unless it is built; returns the path."""
    target = library_path(name)
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    res = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cpp")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"host build of {name}.cpp failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def library(name: str, signatures: tuple) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with each
    ``(function, argtypes, restype)`` of ``signatures`` declared."""
    lib = ctypes.CDLL(build(name))
    for fn_name, argtypes, restype in signatures:
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib
