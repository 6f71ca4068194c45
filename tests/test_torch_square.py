"""The port's square-lattice (Visium HD) route against the JAX package, on
the CPU.

Small lattices (20 x 16 and 18 x 14 bins, a 12 or 12.6 px pitch) and a
narrow ``TpuPatchClassifier`` f at 8-px patches, weights initialised in JAX
and moved off init by numpy noise, bridged into the port:

- the Cartesian corrector (eval and train-mode BatchNorm, with and without
  BatchNorm), ``GridNet``, ``GridNetMM`` and ``ConcatGridNet`` logits, and
  the ``grid_dims`` builders of ``modeldir``, within atol = rtol = 1e-5;
- ``fit_dense_lattice`` plans equal to JAX's: exact, fractional, irregular,
  overhanging and a slide smaller than the cohort-max grid;
- ``register_dense`` on an exact lattice (the port's per-bin route):
  labels equal to ``reg(wsi, pos)``'s and to JAX's tiling route's (up to
  near-ties, ``label_parity_report``);
- the fractional-pitch resample: patches within 1e-4 (0-255 scale) of the
  float64 oracle of the exact bin extents (the JAX test's
  ``_st_linear_oracle``) and within 5e-3 of JAX's ``_resampled_patches``,
  down- and upsampling; labels equal to JAX's up to near-ties. JAX computes
  its sample positions in float32, which puts its own patches 1e-3 to 3e-3
  from the oracle at these sizes (asserted below 2e-2, its test's bound);
  the port samples in float64, so it holds the oracle at any slide size.
  ``chip_smoke.jax_f32_band``, JAX's float32 weight arithmetic op by op,
  which the card reads against the oracle at full size, lies as far from
  the oracle as JAX's patches (within a factor of 2); it is 2e-3 to 5e-3
  from JAX's own patches, because XLA fuses some of those operations;
- ``dispatch_group`` and ``register_slides(hd_binning=)`` over simulated HD
  directories (two dense, one jittered): the same order and labels;
- ``to_loupe_annots(hex_coords=False)``: the CSV bytes JAX writes;
- ``python -m gridnext_tpu_torch register --device cpu`` on an HD model
  directory the JAX package wrote: the CSV ``python -m gridnext_tpu
  register`` writes, up to near-tie flips.
"""

import copy
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import gridnext_tpu.serving as jax_serving
from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.evaluate import to_loupe_annots as jax_to_loupe
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.models import ConcatGridNet as JaxConcatGridNet
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models.gridnet import _CartesianCorrector as JaxCartesian
from gridnext_tpu.train import create_train_state, make_gridwise_optimizer, save_checkpoint
from gridnext_tpu_torch import modeldir, serving
from gridnext_tpu_torch.compat.from_jax import load_gridnet
from gridnext_tpu_torch.evaluate import to_loupe_annots
from gridnext_tpu_torch.io import Positions, read_positions
from gridnext_tpu_torch.models import (ConcatGridNet, GridNet, GridNetHex,
                                       TpuPatchClassifier)
from gridnext_tpu_torch.models.gridnet import _CartesianCorrector
from gridnext_tpu_torch.serving import label_parity_report

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_serving import _st_linear_oracle  # noqa: E402  (the JAX tests' float64 oracle)

REPO = Path(__file__).resolve().parents[1]
N_CLASSES, PATCH, GENES = 3, 8, 10
CLASSES = ["A", "B", "C"]
F_KW = dict(stages=((16, 1),), stem_patch=4)
TPU_F = {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"}
BINNING = "square_016um"
HD_GRID = (20, 16)


def _moved(variables, seed=1):
    """Every leaf moved by numpy noise (numpy arrays); BatchNorm variances
    kept positive."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _positions(df):
    """A pandas positions frame (JAX's layout) as the port's Positions."""
    return Positions([str(b) for b in df.index],
                     {c: df[c].to_numpy(np.int64 if c in ("in_tissue", "array_row",
                                                          "array_col") else np.float64)
                      for c in ("in_tissue", "array_row", "array_col",
                                "pxl_row_in_fullres", "pxl_col_in_fullres")})


def _lattice_frame(hd_grid, pitch, origin, tissue=1.0, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(hd_grid[0]), hd_grid[1])
    cols = np.tile(np.arange(hd_grid[1]), hd_grid[0])
    return pd.DataFrame({
        "in_tissue": (rng.random(len(rows)) < tissue).astype(int),
        "array_row": rows, "array_col": cols,
        "pxl_row_in_fullres": np.rint(origin[0] + (rows + 0.5) * pitch).astype(int),
        "pxl_col_in_fullres": np.rint(origin[1] + (cols + 0.5) * pitch).astype(int)},
        index=[f"b{i}" for i in range(len(rows))])


@pytest.fixture(scope="module")
def gridnet():
    """(JAX GridNet, its moved variables, the port's GridNet) over the
    narrow TpuPatchClassifier with the BatchNorm Cartesian corrector."""
    jg = JaxGridNet(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                    n_classes=N_CLASSES)
    variables = _moved(jg.init(jax.random.key(0),
                               jnp.zeros((1, 2, 2, PATCH, PATCH, 3), jnp.float32)))
    g = load_gridnet(GridNet(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                             n_classes=N_CLASSES, f_dim=N_CLASSES), variables)
    return jg, variables, g.eval()


def _registrars(gridnet, window, h_st=HD_GRID[0], w_st=HD_GRID[1]):
    jg, variables, g = gridnet
    kw = dict(patch_size=PATCH, window_size=window, normalize=None, patch_chunk=64,
              h_st=h_st, w_st=w_st)
    jreg = jax_serving.SlideRegistrar.from_gridnet(jg, variables, extractor="xla", **kw)
    preg = serving.SlideRegistrar.from_gridnet(g, device="cpu", **kw)
    assert preg.hex_coords is False and preg.corrector_apply is g.corrector
    return jreg, preg


# -- models --------------------------------------------------------------------


@pytest.mark.parametrize("use_bn", [True, False], ids=["batchnorm", "no_batchnorm"])
def test_cartesian_corrector_matches_jax(use_bn):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 20, 16, 5)).astype(np.float32)
    jc = JaxCartesian(n_classes=N_CLASSES, use_bn=use_bn)
    variables = _moved(jc.init(jax.random.key(1), jnp.asarray(x)))
    corr = _CartesianCorrector(5, N_CLASSES, use_bn=use_bn)
    with torch.no_grad():
        for collection, layer, leaf, tensor, layout in corr.jax_entries():
            a = variables[collection][layer][leaf]
            tensor.copy_(torch.from_numpy(a.transpose(3, 2, 0, 1) if layout == "conv" else a))
    with torch.no_grad():
        _close(corr.eval()(torch.from_numpy(x)), jc.apply(variables, x, train=False))
        if use_bn:       # BatchNorm over (B, H, W) with the batch's statistics
            want, _ = jc.apply(variables, x, train=True, mutable=["batch_stats"])
            _close(corr.train()(torch.from_numpy(x)), want)


def test_gridnet_models_match_jax(gridnet):
    jg, variables, g = gridnet
    rng = np.random.default_rng(3)
    x = rng.random((1, 5, 4, PATCH, PATCH, 3)).astype(np.float32)
    with torch.no_grad():
        _close(g(torch.from_numpy(x)), jg.apply(variables, x))
        # train mode: the corrector's BatchNorm takes batch statistics, f stays
        # in eval (on a copy: a train-mode forward moves the running stats)
        want, _ = jg.apply(variables, x, train=True, mutable=["batch_stats"])
        _close(copy.deepcopy(g).train()(torch.from_numpy(x)), want)
    # the grid_dims builder of modeldir
    meta = {"model": "GridNet+TpuPatchClassifier", "tpu_f": TPU_F, "patch_chunk": 7,
            "grid_dims": [5, 4]}
    model = modeldir.grid_model_from_meta(meta, CLASSES, variables, device="cpu")
    assert isinstance(model, GridNet) and not model.training
    with torch.no_grad():
        _close(model(torch.from_numpy(x)),
               jax_modeldir.grid_model_from_meta(meta, CLASSES).apply(variables, x))

    # GridNetMM through mm_model_from_meta: a CountMLP count f, the TPU image f
    meta = {"model": "GridNetMM", "count_f": "mlp", "image_f": "tpu", "tpu_f": TPU_F,
            "patch_chunk": 6, "count_chunk": 5, "grid_dims": [5, 4]}
    jmm = jax_modeldir.mm_model_from_meta(meta, CLASSES)
    xc = rng.poisson(2.0, (1, 5, 4, GENES)).astype(np.float32)
    mm_vars = _moved(jmm.init(jax.random.key(4), (jnp.asarray(x), jnp.asarray(xc))), seed=5)
    mm = modeldir.mm_model_from_meta(meta, CLASSES, mm_vars, device="cpu")
    assert type(mm).__name__ == "GridNetMM" and isinstance(mm.corrector, _CartesianCorrector)
    with torch.no_grad():
        _close(mm((torch.from_numpy(x), torch.from_numpy(xc))),
               jmm.apply(mm_vars, (x, xc)))

    # ConcatGridNet: the corrector at the concat width, its convs at the root
    feats = rng.normal(size=(2, 9, 7, 6)).astype(np.float32)
    jcat = JaxConcatGridNet(n_classes=N_CLASSES)
    cat_vars = _moved(jcat.init(jax.random.key(5), jnp.asarray(feats)), seed=6)
    assert set(cat_vars["params"]) == {f"Conv_{i}" for i in range(4)}
    cat = load_gridnet(ConcatGridNet(6, N_CLASSES), cat_vars)
    with torch.no_grad():
        _close(cat(torch.from_numpy(feats)), jcat.apply(cat_vars, feats))
        np.testing.assert_array_equal(cat.patch_predictions(torch.from_numpy(feats)), feats)


def test_image_registrar_from_meta_square(gridnet):
    _, variables, _ = gridnet
    meta = {"model": "GridNet+TpuPatchClassifier", "tpu_f": TPU_F, "patch_px": PATCH,
            "window_px": 12, "patch_chunk": 64, "grid_dims": [20, 16],
            "hd_binning": BINNING}
    reg = modeldir.image_registrar_from_meta(meta, CLASSES, variables, device="cpu")
    assert (reg.h_st, reg.w_st, reg.hex_coords, reg.window_size, reg.normalize) == \
        (20, 16, False, 12, None)
    assert isinstance(reg.corrector_apply, _CartesianCorrector) and not reg.kernels


# -- the dense-lattice plan ----------------------------------------------------


def _plans_equal(got, want):
    assert (got is None) == (want is None), (got, want)
    if want is None:
        return
    assert got[0] == want[0] and len(got) == len(want)
    for a, b in zip(got[1:], want[1:]):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b), (a, b)


def test_fit_dense_lattice_matches_jax():
    cases = []
    exact = _lattice_frame(HD_GRID, 12, (20, 14), tissue=0.7, seed=1)
    cases.append(("exact", exact, HD_GRID, 12, (300, 240, 3)))
    frac = _lattice_frame(HD_GRID, 12.6, (30.7, 25.3), tissue=0.7, seed=4)
    cases.append(("resample", frac, HD_GRID, 13, (320, 280, 3)))
    cases.append((None, frac, HD_GRID, 8, (320, 280, 3)))        # window far from the pitch
    irregular = exact.copy()
    irregular.iloc[np.flatnonzero(irregular["in_tissue"] == 1)[0],
                   irregular.columns.get_loc("pxl_row_in_fullres")] += 1
    cases.append((None, irregular, HD_GRID, 12, (300, 240, 3)))
    cases.append((None, _lattice_frame(HD_GRID, 12.6, (30.7, -4.0)), HD_GRID, 13,
                  (320, 280, 3)))                                 # left overhang
    cases.append((None, _lattice_frame(HD_GRID, 12.6, (320 - 20 * 12.6 + 5.0, 25.3)),
                  HD_GRID, 13, (320, 280, 3)))                    # bottom overhang
    cases.append((None, exact, HD_GRID, 12, (200, 240, 3)))       # exact, leaves the image
    small = _lattice_frame((12, 10), 12, (20, 14), tissue=0.8, seed=2)
    cases.append(("exact", small, (16, 14), 12, (300, 240, 3)))   # cohort-max grid
    cases.append((None, small.iloc[:10], (16, 14), 12, (300, 240, 3)))   # one bin row
    for kind, frame, grid, window, shape in cases:
        want = jax_serving.fit_dense_lattice(frame, *grid, window, shape)
        got = serving.fit_dense_lattice(_positions(frame), *grid, window, shape)
        _plans_equal(got, want)
        assert (want[0] if want else None) == kind
    # a pad offset shifts the origin
    _plans_equal(serving.fit_dense_lattice(_positions(exact), *HD_GRID, 12, None, 7),
                 jax_serving.fit_dense_lattice(exact, *HD_GRID, 12, None, 7))
    # the plan's extent is the in-tissue extent, not the cohort grid
    plan = serving.fit_dense_lattice(_positions(small), 16, 14, 12)
    assert plan[-2:] == (12, 10) and plan[3].shape == (16, 14)


# -- register_dense --------------------------------------------------------------


@pytest.fixture(scope="module")
def hd_sims(tmp_path_factory):
    """Two simulated HD arrays (20 x 16 bins at 12 px, images) and a third
    whose positions are the first's jittered by up to 3 px (no dense plan)."""
    root = tmp_path_factory.mktemp("torch_square")
    sims = [simulate_spaceranger_dir(root / f"hd{i}", seed=3 + i, n_genes=4,
                                     n_classes=N_CLASSES, spaceranger_version="hd",
                                     hd_grid=HD_GRID, hd_binning=BINNING, image=True,
                                     spot_spacing_px=12)
            for i in range(2)]
    jit = simulate_spaceranger_dir(root / "hdj", seed=3, n_genes=4, n_classes=N_CLASSES,
                                   spaceranger_version="hd", hd_grid=HD_GRID,
                                   hd_binning=BINNING, image=True, spot_spacing_px=12)
    path = Path(jit["spaceranger_dir"], "outs", "binned_outputs", BINNING, "spatial",
                "tissue_positions.parquet")
    df = pd.read_parquet(path)
    rng = np.random.default_rng(9)
    for c in ("pxl_row_in_fullres", "pxl_col_in_fullres"):
        df[c] = df[c] + rng.integers(-3, 4, len(df))
    df.to_parquet(path, index=False)
    return sims + [jit]


def _wsi(sim):
    return np.array(Image.open(sim["image_file"]))


def test_register_dense_exact_matches_jax_and_per_bin(gridnet, hd_sims):
    jreg, preg = _registrars(gridnet, window=12)
    sim = hd_sims[0]
    wsi = _wsi(sim)
    pos = read_positions(sim["spaceranger_dir"], BINNING)
    jpos = jax_read_positions(sim["spaceranger_dir"], hd_binning=BINNING)
    plan = preg.dense_plan(torch.from_numpy(wsi), pos)
    assert plan[0] == "exact" and preg.dense_applicable(wsi, pos)
    got = preg.register_dense(wsi, pos, plan=plan)
    per_bin = preg(wsi, pos)
    logits, fg = preg.register_logits(wsi, pos)
    np.testing.assert_array_equal(got, per_bin)
    np.testing.assert_array_equal(got > 0, sim["label_grid"] > 0)
    np.testing.assert_array_equal(fg > 0, sim["label_grid"] > 0)
    want = jreg.register_dense(jnp.asarray(wsi), jpos)
    jlogits, _ = jreg.register_logits(jnp.asarray(wsi), jpos)
    label_parity_report(want, got, jlogits)
    label_parity_report(np.asarray(jreg(jnp.asarray(wsi), jpos)), per_bin, jlogits)
    _close(logits, jlogits, 1e-4)

    # guardrails: a hex registrar and irregular positions
    hexg = GridNetHex(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW), N_CLASSES, N_CLASSES)
    hexr = serving.SlideRegistrar.from_gridnet(hexg, patch_size=PATCH, normalize=None,
                                               device="cpu")
    assert hexr.dense_plan(wsi, pos) is None
    with pytest.raises(ValueError, match="square lattice"):
        hexr.register_dense(wsi, pos)
    bad = Positions(pos.barcodes, {k: v.copy() for k, v in pos.columns.items()})
    bad.columns["pxl_row_in_fullres"][np.flatnonzero(bad["in_tissue"] == 1)[0]] += 1
    with pytest.raises(ValueError, match="dense"):
        preg.register_dense(wsi, bad)


def test_register_dense_cohort_max_extent(gridnet, tmp_path):
    """A slide smaller than the cohort-max grid plans on its own extent;
    the extra rows and columns are background, as in JAX."""
    sim = simulate_spaceranger_dir(tmp_path / "small", seed=5, n_genes=4,
                                   n_classes=N_CLASSES, spaceranger_version="hd",
                                   hd_grid=(12, 10), hd_binning=BINNING, image=True,
                                   spot_spacing_px=12)
    jreg, preg = _registrars(gridnet, window=12, h_st=16, w_st=14)
    wsi = _wsi(sim)
    pos = read_positions(sim["spaceranger_dir"], BINNING)
    jpos = jax_read_positions(sim["spaceranger_dir"], hd_binning=BINNING)
    got = preg.register_dense(wsi, pos)
    assert got.shape == (16, 14) and (got[12:] == 0).all() and (got[:, 10:] == 0).all()
    jlogits, _ = jreg.register_logits(jnp.asarray(wsi), jpos)
    label_parity_report(jreg.register_dense(jnp.asarray(wsi), jpos), got, jlogits)
    label_parity_report(preg(wsi, pos), got, preg.register_logits(wsi, pos)[0])


def _band_oracle(wsi, patch, y0, x0, py, px, r, ex):
    """The float64 oracle (``_st_linear_oracle``) of the exact extents of
    bin row r's ex bins, (ex, P, P, 3). One call covers the row (bin c's
    output columns follow bin c - 1's, as the bins' extents do) on the
    slide rows around it: the triangle reaches less than 2 px beyond a bin,
    so 4 rows of margin keep every weight, and the crop ends only where the
    slide does."""
    lo = max(0, int(np.floor(y0 + r * py)) - 4)
    hi = min(wsi.shape[0], int(np.ceil(y0 + (r + 1) * py)) + 4)
    scale = (patch / py, patch / px)
    band = _st_linear_oracle(wsi[lo:hi], (patch, ex * patch), scale,
                             (-(y0 + r * py - lo) * scale[0], -x0 * scale[1]))
    return band.reshape(patch, ex, patch, 3).transpose(1, 0, 2, 3)


def _jax_dense_logits(jreg, patches, fg, ey, ex):
    """JAX's dense route up to the corrector's logits, from its patches."""
    feats = jreg._apply_f_sharded(jreg._normalize(patches))
    feats = jreg._pad_extent(feats, ey, ex)
    feats = jnp.where(jnp.asarray(fg).reshape(-1, 1) > 0, feats, jreg._bg_vec())
    return np.asarray(jreg.corrector_apply(feats.reshape(1, jreg.h_st, jreg.w_st, -1))[0])


@pytest.mark.parametrize("patch", [8, 16], ids=["downsample", "upsample"])
def test_resampled_patches_match_jax_and_oracle(gridnet, patch):
    """The fractional-pitch route (pitch 12.6 px, window 13) at 8-px patches
    (downsampling) and 16-px (upsampling)."""
    hd_grid = (18, 14)
    frame = _lattice_frame(hd_grid, 12.6, (30.7, 25.3), tissue=0.75, seed=7)
    pos = _positions(frame)
    rng = np.random.default_rng(7)
    wsi = rng.integers(0, 255, (290, 240, 3), dtype=np.uint8)
    jg, variables, g = gridnet
    kw = dict(window_size=13, normalize=None, patch_chunk=None, h_st=hd_grid[0],
              w_st=hd_grid[1])
    if patch == PATCH:
        jreg = jax_serving.SlideRegistrar.from_gridnet(jg, variables, patch_size=patch,
                                                       extractor="xla", **kw)
        preg = serving.SlideRegistrar.from_gridnet(g, patch_size=patch, device="cpu", **kw)
    else:   # an f at 16-px patches
        jg16 = JaxGridNet(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                          n_classes=N_CLASSES)
        v16 = _moved(jg16.init(jax.random.key(3), jnp.zeros((1, 2, 2, patch, patch, 3))))
        g16 = load_gridnet(GridNet(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                                   N_CLASSES, N_CLASSES), v16)
        jreg = jax_serving.SlideRegistrar.from_gridnet(jg16, v16, patch_size=patch,
                                                       extractor="xla", **kw)
        preg = serving.SlideRegistrar.from_gridnet(g16, patch_size=patch, device="cpu", **kw)
    plan = preg.dense_plan(wsi, pos)
    _plans_equal(plan, jreg.dense_plan(jnp.asarray(wsi), frame))
    _, y0, x0, py, px, fg, h_band, ey, ex = plan
    assert plan[0] == "resample"
    got = preg._resampled_patches(torch.from_numpy(wsi), y0, x0, py, px, h_band, ey, ex)
    got = got.numpy()
    want = np.asarray(jreg._resampled_patches(
        jnp.asarray(wsi), jnp.float32(y0), jnp.float32(x0), jnp.float32(py),
        jnp.float32(px), h_band=h_band, ey=ey, ex=ex))
    assert got.shape == want.shape == (ey * ex, patch, patch, 3) and got.dtype == np.float32
    oracle = np.concatenate([_band_oracle(wsi, patch, y0, x0, py, px, r, ex)
                             for r in range(ey)])
    port_err = float(np.abs(got - oracle).max())
    jax_err = float(np.abs(want - oracle).max())
    assert port_err < 1e-4, port_err
    assert jax_err < 2e-2, jax_err
    assert float(np.abs(got - want).max()) < 5e-3
    # the chip's reading of float32 sample positions: the float32 arithmetic
    # of JAX's weights, op by op (XLA fuses some of it, so the patches are not
    # JAX's to the bit), lies as far from the oracle as JAX's own patches
    import chip_smoke

    emulated = np.concatenate([chip_smoke.jax_f32_band(wsi, r, y0, x0, py, px, h_band, ex,
                                                       patch) for r in range(ey)])
    emulated_err = float(np.abs(emulated - oracle).max())
    assert 0.5 * jax_err <= emulated_err <= 2 * jax_err, (emulated_err, jax_err)
    # the route's labels: JAX's up to near-ties (judged with JAX's logits),
    # and the per-bin route's on at least 90 % of bins (different pixels)
    labels = preg.register_dense(wsi, pos, plan=plan)
    jlabels = np.asarray(jreg.register_dense(jnp.asarray(wsi), frame))
    label_parity_report(jlabels, labels, _jax_dense_logits(jreg, jnp.asarray(want), fg,
                                                           ey, ex))
    np.testing.assert_array_equal(labels > 0, fg > 0)
    agree = (labels[fg > 0] == preg(wsi, pos)[fg > 0]).mean()
    assert agree >= 0.9, agree
    # a chunk of a few bands at a time gives the same patches
    small = serving._RESAMPLE_CHUNK_FLOATS
    try:
        serving._RESAMPLE_CHUNK_FLOATS = 3 * h_band * ex * patch * 3
        chunked = preg._resampled_patches(torch.from_numpy(wsi), y0, x0, py, px, h_band,
                                          ey, ex)
    finally:
        serving._RESAMPLE_CHUNK_FLOATS = small
    np.testing.assert_array_equal(chunked.numpy(), got)


# -- dispatch and the serving loop -------------------------------------------------


def test_dispatch_group_and_register_slides_match_jax(gridnet, hd_sims):
    jreg, preg = _registrars(gridnet, window=12)
    files = [s["image_file"] for s in hd_sims]
    dirs = [s["spaceranger_dir"] for s in hd_sims]
    wsis = [_wsi(s) for s in hd_sims]
    poss = [read_positions(d, BINNING) for d in dirs]
    jposs = [jax_read_positions(d, hd_binning=BINNING) for d in dirs]
    jlogits = [jreg.register_logits(jnp.asarray(w), p)[0] for w, p in zip(wsis, jposs)]

    # J first: the dense slides come out first, then the per-bin one
    order = [2, 0, 1]
    got = serving.dispatch_group(preg, [(k, torch.from_numpy(wsis[k]), poss[k])
                                        for k in order])
    want = jax_serving.dispatch_group(jreg, [(k, jnp.asarray(wsis[k]), jposs[k])
                                             for k in order])
    assert [k for k, _, _ in got] == [k for k, _, _ in want] == [0, 1, 2]
    for (k, labels, _), (_, jlabels, _) in zip(got, want):
        label_parity_report(np.asarray(jlabels), labels, jlogits[k])
    # plans from the caller: None sends a dense slide per bin (in a batch of two)
    stats = {}
    got = serving.dispatch_group(preg, [(k, torch.from_numpy(wsis[k]), poss[k])
                                        for k in order], plans={0: None}, stats=stats)
    assert [k for k, _, _ in got] == [1, 2, 0] and stats == {"batched": 2}

    # the serving loop over files, positions read from the parquet
    for batch in (1, 3):
        got = list(serving.register_slides(preg, files, dirs, hd_binning=BINNING,
                                           slide_batch=batch))
        want = list(jax_serving.register_slides(jreg, files, dirs, hd_binning=BINNING,
                                                slide_batch=batch))
        assert [i for i, _, _ in got] == [i for i, _, _ in want]
        for (i, labels, pos), (_, jlabels, _) in zip(got, want):
            assert pos.barcodes == poss[i].barcodes
            label_parity_report(np.asarray(jlabels), labels, jlogits[i])
            np.testing.assert_array_equal(labels > 0, hd_sims[i]["label_grid"] > 0)


# -- Loupe export and the register command ------------------------------------------


def test_to_loupe_annots_square_matches_jax(hd_sims, tmp_path):
    sim = hd_sims[1]
    path = Path(sim["spaceranger_dir"], "outs", "binned_outputs", BINNING, "spatial",
                "tissue_positions.parquet")
    labels = np.random.default_rng(0).integers(0, N_CLASSES + 1, HD_GRID)
    for names in (CLASSES, None):
        jax_to_loupe(labels, path, tmp_path / "jax.csv", annot_names=names,
                     hex_coords=False)
        to_loupe_annots(labels, path, tmp_path / "port.csv", annot_names=names,
                        hex_coords=False)
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with pytest.raises(ValueError, match="larger than the model's grid_dims"):
        to_loupe_annots(labels[:10], path, tmp_path / "x.csv", hex_coords=False)


def _write_model_dir(d, g, sample, meta):
    """``save_checkpoint`` of a TrainState and ``model.json``, as the JAX
    package's trainers write them."""
    state = create_train_state(g, jax.random.key(0), sample, make_gridwise_optimizer(1e-3))
    state = state.replace(**_moved({"params": state.params,
                                    "batch_stats": state.batch_stats}))
    os.makedirs(d, exist_ok=True)
    save_checkpoint(os.path.join(d, "g_state.msgpack"), state)
    with open(os.path.join(d, "model.json"), "w") as fh:
        json.dump({"classes": CLASSES, **meta}, fh)
    return str(d)


def _csv_rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_register_command_hd_matches_jax(gridnet, hd_sims, tmp_path):
    jg, _, _ = gridnet
    meta = {"patch_px": PATCH, "window_px": 12, "model": "GridNet+TpuPatchClassifier",
            "tpu_f": TPU_F, "image_f": "tpu", "hd_binning": BINNING,
            "grid_dims": list(HD_GRID), "patch_chunk": 64, "dense_ingest": False}
    model_dir = _write_model_dir(tmp_path / "model", jg,
                                 jnp.zeros((1, 2, 2, PATCH, PATCH, 3)), meta)
    files = [s["image_file"] for s in hd_sims]
    dirs = [s["spaceranger_dir"] for s in hd_sims]
    args = ["register", "--model", model_dir, "--spaceranger", *dirs, "--images", *files]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "gridnext_tpu_torch", *args, "--out",
                          str(tmp_path / "port"), "--device", "cpu"], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    jmeta, jclasses, jvars = jax_modeldir.load_model_dir(model_dir)
    jreg = jax_modeldir.image_registrar_from_meta(jmeta, jclasses, jvars)
    for sim, srd in zip(hd_sims, dirs):
        name = f"{Path(srd).name}_loupe.csv"
        want, got = _csv_rows(tmp_path / "jax" / name), _csv_rows(tmp_path / "port" / name)
        assert [r[0] for r in got] == [r[0] for r in want] and got[0] == ["Barcode", "AARs"]
        jpos = jax_read_positions(srd, hd_binning=BINNING)
        logits, _ = jreg.register_logits(jnp.asarray(_wsi(sim)), jpos)
        grids = []
        for rows in (want, got):
            grid = np.zeros(HD_GRID, np.int64)
            for barcode, annot in rows[1:]:
                grid[int(jpos.loc[barcode, "array_row"]),
                     int(jpos.loc[barcode, "array_col"])] = CLASSES.index(annot) + 1
            grids.append(grid)
        label_parity_report(*grids, logits)
