"""The port's ``simulate`` against the JAX package, and the port's count
workflow end to end on the CPU.

Covered:

- ``simulate_spaceranger_dir`` against JAX's for the v2, v1 and HD layouts
  (the 78 x 64 lattice and a square bin grid), real Visium v1 barcodes,
  gene2vec symbols and the fullres JPEG: every file's bytes equal (gzip
  files inflated; the HD parquet read back equal through pandas), the
  label grid and the returned fields equal;
- ``pseudo_visium_from_image`` (both templates), the Visium v1 template and
  ``lattice_positions`` against JAX's;
- ``python -m gridnext_tpu_torch simulate`` and ``prepare`` (subprocesses,
  no JAX imported), then ``train-count --device cpu`` and ``register
  --device cpu``: the cohort's files equal to the JAX CLI's ``simulate`` and
  ``prepare``, and the trained directory registered by the JAX CLI to the
  same CSV.
"""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from gridnext_tpu import cli as jax_cli
from gridnext_tpu.data import simulate as jax_simulate
from gridnext_tpu.data import template as jax_template
from gridnext_tpu.models.scbert import load_gene2vec_names
from gridnext_tpu_torch import cli
from gridnext_tpu_torch.data import simulate, template

REPO = Path(__file__).resolve().parents[1]


def _files(root) -> dict:
    """{relative path: bytes} below ``root``, gzip files inflated."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            data = Path(path).read_bytes()
            out[os.path.relpath(path, root)] = gzip.decompress(data) if name.endswith(".gz") \
                else data
    return out


def _assert_same_tree(got_root, want_root):
    got, want = _files(got_root), _files(want_root)
    assert sorted(got) == sorted(want)
    for rel in want:
        if rel.endswith(".parquet"):
            a = pd.read_parquet(os.path.join(got_root, rel))
            b = pd.read_parquet(os.path.join(want_root, rel))
            assert list(a.columns) == list(b.columns) and a.equals(b)
            assert list(a.dtypes) == list(b.dtypes)
        else:
            assert got[rel] == want[rel], rel


@pytest.mark.parametrize("kw", [
    {}, {"spaceranger_version": 1}, {"spaceranger_version": "hd"},
    {"spaceranger_version": "hd", "hd_grid": (14, 19), "hd_binning": "square_016um"},
    {"barcodes": "visium_v1", "n_classes": 6, "tissue_fraction": 0.9},
    {"gene_names": "gene2vec", "image": True, "spot_spacing_px": 9},
], ids=["v2", "v1", "hd", "hd_grid", "visium_v1", "gene2vec_image"])
def test_simulate_matches_jax(tmp_path, kw):
    kw = dict(kw)
    if kw.get("gene_names") == "gene2vec":
        kw["gene_names"] = load_gene2vec_names()[:37]
    want = jax_simulate.simulate_spaceranger_dir(tmp_path / "jax" / "a0", seed=4, n_genes=37,
                                                 **kw)
    got = simulate.simulate_spaceranger_dir(tmp_path / "port" / "a0", seed=4, n_genes=37, **kw)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    np.testing.assert_array_equal(got["label_grid"], want["label_grid"])
    assert got["label_grid"].dtype == want["label_grid"].dtype
    for key in ("class_names", "n_genes"):
        assert got[key] == want[key]
    for key in ("spaceranger_dir", "position_file", "annot_file", "image_file"):
        assert (got[key] is None) == (want[key] is None)
        if got[key] is not None:
            assert os.path.relpath(got[key], tmp_path / "port") == \
                os.path.relpath(want[key], tmp_path / "jax")


def test_simulate_refusals_match_jax(tmp_path):
    for kw in ({"tissue_fraction": 0.0}, {"hd_grid": (4, 4)},
               {"spaceranger_version": "hd", "hd_grid": (4, 4), "barcodes": "visium_v1"},
               {"barcodes": "other"}, {"spaceranger_version": "x"},
               {"gene_names": ["a", "b"]}):
        with pytest.raises(ValueError) as want:
            jax_simulate.simulate_spaceranger_dir(tmp_path / "jax", n_genes=5, **kw)
        with pytest.raises(ValueError) as got:
            simulate.simulate_spaceranger_dir(tmp_path / "port", n_genes=5, **kw)
        assert str(got.value) == str(want.value)


def test_template_and_lattice_match_jax(tmp_path):
    want = jax_template.visium_v1_template()
    got = template.visium_v1_template()
    assert list(got) == list(want.columns)
    for name in want.columns:
        np.testing.assert_array_equal(got[name], want[name].to_numpy())
    assert template.visium_v1_scalefactors() == jax_template.visium_v1_scalefactors()
    np.testing.assert_array_equal(template.visium_v1_barcode_grid(),
                                  jax_template.visium_v1_barcode_grid())
    for a, b in zip(simulate.lattice_positions(), jax_simulate.lattice_positions()):
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(0)
    roi = tmp_path / "roi image.png"
    Image.fromarray(rng.integers(0, 255, (160, 120, 3), dtype=np.uint8)).save(roi)
    for tmpl in ("visium_v1", "synthetic"):
        a = jax_simulate.pseudo_visium_from_image(roi, tmp_path / "jax" / tmpl, template=tmpl)
        b = simulate.pseudo_visium_from_image(roi, tmp_path / "port" / tmpl, template=tmpl,
                                              image_width_mm=8, spot_width_um=55)
        assert os.path.basename(a) == os.path.basename(b) == "roi_image"
        _assert_same_tree(tmp_path / "port" / tmpl, tmp_path / "jax" / tmpl)
    with pytest.raises(ValueError, match="template must be"):
        simulate.pseudo_visium_from_image(roi, tmp_path / "x", template="other")


def _port_cli(*args, cwd):
    """``python -m gridnext_tpu_torch`` in a subprocess that fails if JAX,
    pandas or the JAX package is imported."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['gridnext_tpu_torch'] + {list(args)!r}\n"
            "try:\n"
            "    runpy.run_module('gridnext_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'gridnext_tpu', 'pandas', 'pyarrow'))\n"
            "    assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_cli_simulate_prepare_train_register(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sim = ["--arrays", "3", "--genes", "40", "--classes", "3", "--seed", "7"]
    out = _port_cli("simulate", "--out", "port", *sim, cwd=tmp_path)
    assert out.count("simulated port/a") == 3
    jax_cli.main(["simulate", "--out", "jax", *sim])
    dirs = [f"port/a{i}" for i in range(3)]
    out = _port_cli("prepare", "--spaceranger", *dirs, "--min-detection", "0.05", cwd=tmp_path)
    assert "unified gene axis: 40 genes across 3 arrays" in out
    jax_cli.main(["prepare", "--spaceranger", *[f"jax/a{i}" for i in range(3)],
                  "--min-detection", "0.05"])
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")

    annots = [f"{d}/a{i}_annotations.csv" for i, d in enumerate(dirs)]
    cli.main(["train-count", "--spaceranger", *dirs, "--annots", *annots, "--out", "model",
              "--epochs", "2", "--device", "cpu", "--min-detection", "0.3"])
    meta = json.loads((tmp_path / "model" / "model.json").read_text())
    assert meta["model"] == "GridNetHex+CountMLP" and meta["n_genes"] == 40
    for i, d in enumerate(dirs):
        jax_cli.main(["register", "--model", "model", "--spaceranger", d,
                      "--out", f"jax{i}.csv"])
        cli.main(["register", "--model", "model", "--spaceranger", d, "--out", f"port{i}.csv",
                  "--device", "cpu"])
        want = (tmp_path / f"jax{i}.csv").read_text()
        assert (tmp_path / f"port{i}.csv").read_text() == want
        assert len(want.splitlines()) > 100
