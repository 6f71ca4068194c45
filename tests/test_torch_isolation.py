"""The port stands alone: no JAX, no JAX package, nothing the card lacks.

The card machine has PyTorch, numpy and scipy but no JAX, flax, pandas,
pyarrow, PIL or msgpack. The package, ``chip_smoke.py`` and the ``tools/time_*.py``
timers import none of them, except ``PIL`` inside ``ingest.decode_slide``
(the slide decoder, never called on the card) and inside the image writers
of ``data/simulate.py`` (``simulate_spaceranger_dir(image=True)`` and
``pseudo_visium_from_image``), as the JAX package writes its fixtures. Also here: the port's own
geometry equals the JAX package's.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gridnext_tpu import geometry as jax_geometry
from gridnext_tpu_torch import geometry

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "gridnext_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "pandas", "pyarrow", "msgpack", "gridnext_tpu")
# (file, function) pairs that may import PIL lazily
PIL_ALLOWED = {("ingest.py", "decode_slide"), ("simulate.py", "simulate_spaceranger_dir"),
               ("simulate.py", "pseudo_visium_from_image")}


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'gridnext_tpu', 'pandas', 'pyarrow', 'PIL', "
            "'msgpack'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _imports(tree):
    """(module name, enclosing function or None) of every import."""
    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
                continue
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, func
            elif isinstance(child, ast.ImportFrom) and child.module:
                yield child.module, func
            yield from walk(child, func)
    yield from walk(tree, None)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                                              REPO / "tools" / "time_favor.py",
                                                              REPO / "tools" / "time_denseblock.py",
                                                              REPO / "tools" / "time_gather_corrector.py",
                                                              REPO / "tools" / "time_register_slides.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for name, func in _imports(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"
        if top == "PIL":
            assert (path.name, func) in PIL_ALLOWED, \
                f"{path.name} imports PIL outside {sorted(PIL_ALLOWED)}"


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    row = rng.integers(0, 78, 200)
    col = 2 * rng.integers(0, 64, 200) + row % 2
    for fn in ("pseudo_hex_to_oddr", "oddr_to_pseudo_hex", "oddr_to_cartesian"):
        for got, want in zip(getattr(geometry, fn)(col, row),
                             getattr(jax_geometry, fn)(col, row)):
            np.testing.assert_array_equal(got, want)
        assert getattr(geometry, fn)(5, 3) == getattr(jax_geometry, fn)(5, 3)
    for radius in (1, 2, 3):
        assert geometry.hex_taps(radius) == jax_geometry.hex_taps(radius)
    assert geometry.HEX_TAPS_R1 == jax_geometry.HEX_TAPS_R1
    assert (geometry.VISIUM_H_ST, geometry.VISIUM_W_ST) == \
        (jax_geometry.VISIUM_H_ST, jax_geometry.VISIUM_W_ST)
