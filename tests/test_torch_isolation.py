"""The port stands alone: no JAX, no JAX package, nothing the card lacks.

The card machine has PyTorch, numpy and scipy but no JAX, flax, pandas,
scikit-learn, pyarrow, PIL, msgpack, orbax, tensorstore, anndata or zstd /
lz4 / brotli modules. The package, ``chip_smoke.py`` and the
``tools/time_*.py`` timers import none of them, except ``PIL`` inside
``ingest.decode_slide`` and ``data/simulate.py``'s
``pseudo_visium_from_image``, for images other than JPEG, TIFF and PNG only
(those go through the port's readers, ``io/jpeg.py``, ``io/tiff.py`` and
``io/png.py``), and ``anndata`` and the ``pandas`` it brings inside the
AnnData builders' gate (``io/anndata_io.py``). The
training commands that need no image (``pretrain-scbert``, ``train-graph``)
run end to end with ``--device cpu`` in a process that imports none of
them, and without a card their default ``cuda`` raises; so do the cohort
workflows (HVG, the scaler, PCA, CV) and ``config``, and ``train-count``
over a 1-rank gloo process group (``--coordinator``, ``--mesh``), and
``--profile-dir``, the reference-checkpoint converters and the small
public leftovers. Also here: the port's own geometry equals the JAX
package's.
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
FORBIDDEN = ("jax", "flax", "optax", "pandas", "pyarrow", "msgpack", "gridnext_tpu",
             "sklearn", "zstandard", "brotli", "lz4", "orbax", "tensorstore", "anndata")
# (file, function) pairs that may import PIL lazily
PIL_ALLOWED = {("ingest.py", "decode_slide"), ("simulate.py", "pseudo_visium_from_image")}
# the anndata gate of io/anndata_io.py: anndata, and the pandas it brings,
# imported only by the AnnData builders' gate
GATED = {("anndata_io.py", "_require_anndata", "anndata"),
         ("anndata_io.py", "_anndata_of", "pandas")}


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
            "'msgpack', 'sklearn', 'zstandard', 'brotli', 'lz4', 'orbax', 'tensorstore', "
            "'anndata'))\n"
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
                                                              REPO / "tools" / "time_register_slides.py",
                                                              REPO / "tools" / "time_export.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for name, func in _imports(tree):
        top = name.split(".")[0]
        if (path.name, func, top) in GATED:
            continue
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


def test_training_commands_run_without_jax(tmp_path):
    """``simulate``, ``prepare``, ``pretrain-scbert`` (tiny widths) and
    ``train-graph`` with ``--device cpu`` in one process that fails if any
    forbidden module is imported."""
    sc = ["--scbert-vocab", "30", "--scbert-dim", "8", "--scbert-depth", "1",
          "--scbert-heads", "2", "--scbert-dim-head", "4", "--scbert-features", "4"]
    runs = [["simulate", "--out", "sim", "--arrays", "1", "--genes", "20", "--classes", "3",
             "--gene2vec-names"],
            ["prepare", "--spaceranger", "sim/a0"],
            ["pretrain-scbert", "--spaceranger", "sim/a0", "--out", "lm", "--epochs", "1",
             "--batch-size", "256", "--redraw-every", "2", "--device", "cpu", *sc],
            ["train-graph", "--spaceranger", "sim/a0", "--annots", "sim/a0/a0_annotations.csv",
             "--out", "graph", "--steps", "3", "--device", "cpu"]]
    code = ("import sys\n"
            "from gridnext_tpu_torch import cli\n"
            f"for argv in {runs!r}:\n"
            "    cli.main(argv)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('PIL',)!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "saved pretrained LM to lm/scbert_lm.msgpack" in res.stdout
    assert "saved model to graph" in res.stdout
    assert (tmp_path / "lm" / "pretrain.json").exists()


def test_training_commands_default_to_cuda(monkeypatch, tmp_path):
    import torch

    from gridnext_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["pretrain-scbert", "--spaceranger", "x", "--out", str(tmp_path / "lm")],
                 ["train-graph", "--spaceranger", "x", "--annots", "x.csv", "--out",
                  str(tmp_path / "g")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert not any(tmp_path.iterdir())


def test_workflows_and_mesh_training_run_without_jax(tmp_path):
    """The cohort workflows and a 1-rank ``--mesh`` ``train-count`` in one
    process that fails if any forbidden module is imported."""
    code = ("import sys\n"
            "import numpy as np\n"
            "from gridnext_tpu_torch import cli, config, workflows\n"
            "cli.main(['simulate', '--out', 'sim', '--arrays', '2', '--genes', '30'])\n"
            "cli.main(['prepare', '--spaceranger', 'sim/a0', 'sim/a1'])\n"
            "caches = ['sim/a0/a0.unified.tsv.gz', 'sim/a1/a1.unified.tsv.gz']\n"
            "genes = workflows.select_hvgs_from_count_files(caches, n_top_genes=10)\n"
            "out = workflows.preprocess_cohorts(caches[:1], caches, device='cpu')\n"
            "assert len(genes) == 10 and out['n_pcs'] >= 1\n"
            "parts = workflows.grouped_partitions(['a', 'b', 'c'], 3)\n"
            "config.save_config(config.DenseNetConfig(), 'cfg.json')\n"
            "cli.main(['--coordinator', '127.0.0.1:%d,1,0', 'train-count', '--spaceranger',\n"
            "          'sim/a0', 'sim/a1', '--annots', 'sim/a0/a0_annotations.csv',\n"
            "          'sim/a1/a1_annotations.csv', '--out', 'm', '--epochs', '1',\n"
            "          '--device', 'cpu', '--mesh', 'data=1'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('PIL',)!r})\n"
            "assert not bad, bad\n")
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code % port], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[mesh {'data': 1}]" in res.stdout and "saved model to m" in res.stdout


def test_profile_dir_converters_and_leftovers_run_without_jax(tmp_path):
    """``--profile-dir`` around a command, a reference ``.pth`` through
    ``compat.torch_convert``, ``hex_neighbor_table`` and
    ``positions_to_coord_strings`` in one process that fails if any
    forbidden module is imported."""
    code = ("import glob, sys\n"
            "import torch\n"
            "from gridnext_tpu_torch import cli, geometry\n"
            "from gridnext_tpu_torch.compat import count_mlp_from_torch, load_torch_checkpoint\n"
            "from gridnext_tpu_torch.io import positions_to_coord_strings, read_positions\n"
            "from gridnext_tpu_torch.models import CountMLP\n"
            "cli.main(['--profile-dir', 'tr', 'simulate', '--out', 'sim', '--arrays', '1',\n"
            "          '--genes', '10'])\n"
            "assert len(glob.glob('tr/*.json')) == 1\n"
            "seq = torch.nn.Sequential(torch.nn.Linear(10, 500), torch.nn.Linear(500, 100),\n"
            "    torch.nn.BatchNorm1d(100), torch.nn.ReLU(), torch.nn.Linear(100, 100),\n"
            "    torch.nn.Linear(100, 50), torch.nn.BatchNorm1d(50), torch.nn.ReLU(),\n"
            "    torch.nn.Linear(50, 3)).eval()\n"
            "torch.save(seq.state_dict(), 'mlp.pth')\n"
            "f = load_torch_checkpoint(CountMLP(10, 3), 'mlp.pth', count_mlp_from_torch).eval()\n"
            "x = torch.randn(4, 10)\n"
            "with torch.no_grad():\n"
            "    torch.testing.assert_close(f(x), seq(x), rtol=1e-5, atol=1e-5)\n"
            "nb, ok = geometry.hex_neighbor_table()\n"
            "assert nb.shape == (78, 64, 6) and ok.sum() > 0\n"
            "pos = read_positions('sim/a0')\n"
            "assert len(positions_to_coord_strings(pos, pos.barcodes[:5])) == 5\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('PIL',)!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "profiler trace written to tr" in res.stdout


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cpp")), ids=lambda p: p.name)
def test_host_codecs_name_no_codec_library(path):
    """The host C++ libraries include the C++ standard library only: no
    zstd, lz4, brotli, snappy or zlib header, and no ``dlopen``."""
    src = path.read_text()
    includes = [line.split()[1] for line in src.splitlines() if line.startswith("#include")]
    assert includes and all(h.startswith("<c") or h in ("<algorithm>", "<atomic>", "<stdexcept>",
                                                        "<string>", "<thread>", "<vector>")
                            for h in includes), includes
    for word in ("dlopen", "zstd.h", "lz4.h", "lz4frame", "brotli/", "snappy.h", "snappy-c.h",
                 "zlib.h", "libzstd", "liblz4", "libbrotli", "libsnappy"):
        assert word not in src, word


def test_parquet_reader_loads_no_codec_library():
    """Reading every committed Parquet fixture (ZSTD, Brotli, LZ4, SNAPPY,
    GZIP pages) imports no codec module and maps no system codec library."""
    code = ("import glob, sys\n"
            "from gridnext_tpu_torch.io.parquet import read_parquet\n"
            "files = sorted(glob.glob('tests/data/parquet/*.parquet'))\n"
            "assert len(files) > 30, files\n"
            "for f in files:\n"
            "    read_parquet(f)\n"
            "maps = open('/proc/self/maps').read()\n"
            "bad = [n for n in ('libzstd', 'liblz4', 'libbrotli', 'libsnappy') if n in maps]\n"
            "assert not bad, bad\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pyarrow', 'pandas', "
            "'zstandard', 'brotli', 'lz4', 'snappy', 'jax', 'gridnext_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
