"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``gridnext_tpu_torch/_build/`` (ignored by git); the library
name carries a hash of its source, so an edited kernel rebuilds and a stale
one is never loaded. :func:`build` compiles several sources at once, one
``nvcc`` process each, and returns ``ptxas``'s register and spill report.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C entry points of each library: name -> (argtypes, restype)
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ERROR_STRING = {"error_string": ([_I], ctypes.c_char_p)}
SIGNATURES = {
    "patch_gather": {
        **_ERROR_STRING,
        # imgs, b, h, w, y0, x0, slide, n, window, out, stream
        "gather_patches_u8": ([_VP, _LL, _LL, _LL, _VP, _VP, _VP, _LL, _I,
                               _VP, _VP], _I),
    },
    "hexcorrector": {
        **_ERROR_STRING,
        # x, weight, bias, nb, h, w, c_in, c_out, relu, out, stream
        "hex_layer_f32": ([_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP],
                          _I),
        # x, weight, bias, fg, nb, h, w, c_in, c_out, relu, out, stream
        "hex_layer_labels_f32": ([_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                  _VP, _VP], _I),
    },
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's install default
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` (hash-named)."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet.

    All ``nvcc`` processes start together and are waited for. Returns
    ``{name: {"seconds": s, "log": compiler output}}`` for each source
    compiled now (the log holds ``ptxas -v``'s registers and spills). Raises ``RuntimeError`` with the compiler output when a
    build fails.
    """
    names = list(SIGNATURES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    path = library_path(name)
    if not os.path.exists(path):
        build([name])
    lib = ctypes.CDLL(path)
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point of ``lib`` returned a CUDA error code."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
