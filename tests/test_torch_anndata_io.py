"""The port's AnnData tier (``io/anndata_io.py``) against the JAX package's
``io/anndata_io.py`` on the same simulated Spaceranger directories.

- ``assemble_visium_frames`` / ``concat_visium_frames``: index, columns and
  values equal to JAX's pandas frames (annotated with dropped and blank
  Loupe cells, numeric labels, and plain), over two arrays whose gene sets
  overlap (the outer join);
- ``resolve_imgpatch_dirs`` (caches byte-equal to JAX's), ``attach_imgpaths``;
- both packages' ``create_visium_anndata*`` through the shim ``anndata`` of
  ``tests/test_anndata_io.py``, and each one's ``ImportError`` without it;
- the consumers (``anndata_to_grids``, ``anndata_to_spot_arrays``,
  ``anndata_to_grid_arrays``, ``anndata_mm_to_grid_arrays``,
  ``MMAnnSpotDataset``) on one AnnData stand-in: grids and labels equal,
  patches within 1e-6;
- patch-cache names shared with the port's dataset factory (HD included).
"""

import builtins
import os
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

from gridnext_tpu.data.simulate import simulate_spaceranger_dir
from gridnext_tpu.io import anndata_io as jio
from gridnext_tpu_torch.io import anndata_io as tio
from tests.test_anndata_io import _shim_concat, _ShimAnnData

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """Two arrays with overlapping gene sets and images; array A's
    annotations lose 3 rows and get one blank cell."""
    root = tmp_path_factory.mktemp("sims")
    sims = [simulate_spaceranger_dir(root / "arrA", n_genes=5, n_classes=2, seed=0,
                                     image=True, gene_names=["G0", "G1", "G2", "G3", "G4"]),
            simulate_spaceranger_dir(root / "arrB", n_genes=5, n_classes=2, seed=1,
                                     image=True, gene_names=["G3", "G4", "G5", "G6", "G7"])]
    annot = sims[0]["annot_file"]
    df = pd.read_csv(annot, index_col=0).iloc[3:]
    df.iloc[0, 0] = None
    df.to_csv(annot)
    return sims


def _dirs(sims, key):
    return [s[key] for s in sims]


def _assert_frame(got, want, index=True):
    """A port Frame / CountFrame against a pandas DataFrame."""
    if index:
        assert list(got.index) == list(want.index)
    if isinstance(got, tio.CountFrame):
        assert list(got.columns) == list(want.columns)
        assert got.values.dtype == want.values.dtype
        np.testing.assert_array_equal(got.values, want.values)
        return
    assert list(got.columns) == list(want.columns)
    for k in want.columns:
        np.testing.assert_array_equal(got[k], want[k].to_numpy(), err_msg=k)
        if want[k].dtype != object:
            assert got[k].dtype.kind == want[k].dtype.kind or k in ("x_px", "y_px"), k


def _numeric_annots(sims, tmp_path):
    out = []
    for i, s in enumerate(sims):
        df = pd.read_csv(s["annot_file"], index_col=0)
        col = df.columns[0]
        codes = {v: j + 1 for j, v in enumerate(sorted(df[col].dropna().unique()))}
        df[col] = df[col].map(codes)
        path = tmp_path / f"num{i}.csv"
        df.to_csv(path)
        out.append(str(path))
    return out


@pytest.mark.parametrize("annots", ["loupe", "numeric", "none"])
def test_frames_match_jax(sims, annots, tmp_path):
    srdirs = _dirs(sims, "spaceranger_dir")
    files = {"loupe": _dirs(sims, "annot_file"), "numeric": _numeric_annots(sims, tmp_path),
             "none": None}[annots]
    want = jio.assemble_visium_frames(srdirs, annot_files=files)
    got = tio.assemble_visium_frames(srdirs, annot_files=files)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for gf, wf in zip(g, w):
            _assert_frame(gf, wf)
    if annots == "numeric":
        assert got[0][1]["annotation"].dtype == want[0][1]["annotation"].dtype
    for g, w in zip(tio.concat_visium_frames(got), jio.concat_visium_frames(want)):
        _assert_frame(g, w)


def test_resolve_and_attach_match_jax(sims, tmp_path):
    srdirs, imgs = _dirs(sims, "spaceranger_dir"), _dirs(sims, "image_file")
    jdirs = jio.resolve_imgpatch_dirs(srdirs, imgs, patch_size_px=6,
                                      save_patches_to=tmp_path / "jax")
    tdirs = tio.resolve_imgpatch_dirs(srdirs, imgs, patch_size_px=6,
                                      save_patches_to=tmp_path / "port", device=CPU)
    assert [os.path.basename(d) for d in tdirs] == [os.path.basename(d) for d in jdirs]
    for t, j in zip(tdirs, jdirs):
        assert sorted(os.listdir(t)) == sorted(os.listdir(j))
        for name in os.listdir(j):
            with open(os.path.join(t, name), "rb") as a, open(os.path.join(j, name), "rb") as b:
                assert a.read() == b.read(), name
    annots = _dirs(sims, "annot_file")
    want = jio.attach_imgpaths(jio.assemble_visium_frames(srdirs, annots), jdirs)
    got = tio.attach_imgpaths(tio.assemble_visium_frames(srdirs, annots), tdirs)
    for g, w in zip(got, want):
        _assert_frame(g[0], w[0])
        assert [os.path.basename(p) for p in g[1]["imgpath"]] == \
            [os.path.basename(p) for p in w[1]["imgpath"]]
        assert len(g[1]) > 0
    empty = tio.attach_imgpaths(tio.assemble_visium_frames(srdirs), [str(tmp_path / "no")] * 2)
    assert all(len(o) == 0 for _, o, _ in empty)


@pytest.fixture
def shim(monkeypatch):
    mod = types.ModuleType("anndata")
    mod.AnnData = _ShimAnnData
    mod.concat = _shim_concat
    monkeypatch.setitem(sys.modules, "anndata", mod)
    return mod


def _assert_adata(got, want):
    np.testing.assert_array_equal(got.X, want.X)
    assert got.X.dtype == want.X.dtype == np.float32
    for g, w in ((got.obs, want.obs), (got.var, want.var)):
        assert list(g.index) == list(w.index) and list(g.columns) == list(w.columns)
        for k in w.columns:
            np.testing.assert_array_equal(g[k].to_numpy(), w[k].to_numpy(), err_msg=k)


def test_builders_through_the_shim(sims, shim, tmp_path):
    srdirs, imgs = _dirs(sims, "spaceranger_dir"), _dirs(sims, "image_file")
    annots = _dirs(sims, "annot_file")
    _assert_adata(tio.create_visium_anndata(srdirs, annots),
                  jio.create_visium_anndata(srdirs, annots))
    want = jio.create_visium_anndata_img(srdirs, fullres_image_files=imgs, annot_files=annots,
                                         patch_size_px=6, save_patches_to=tmp_path / "jax")
    got = tio.create_visium_anndata_img(srdirs, fullres_image_files=imgs, annot_files=annots,
                                        patch_size_px=6, save_patches_to=tmp_path / "port",
                                        device=CPU)
    got.obs["imgpath"] = [os.path.basename(p) for p in got.obs["imgpath"]]
    want.obs["imgpath"] = [os.path.basename(p) for p in want.obs["imgpath"]]
    _assert_adata(got, want)
    with pytest.raises(ValueError, match="either patched image directories"):
        tio.create_visium_anndata_img(srdirs)


@pytest.mark.parametrize("builder", ["create_visium_anndata", "create_visium_anndata_img"])
def test_builders_raise_without_anndata(builder, monkeypatch):
    real_import = builtins.__import__

    def block(name, *args, **kwargs):
        if name == "anndata" or name.startswith("anndata."):
            raise ImportError("No module named 'anndata'")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "anndata", raising=False)
    monkeypatch.setattr(builtins, "__import__", block)
    for mod in (jio, tio):
        with pytest.raises(ImportError) as err:
            getattr(mod, builder)(["/nonexistent"])
        assert str(err.value) == "this function requires the optional 'anndata' package"


class _StandIn(_ShimAnnData):
    """The shim with a length and ``obsm`` (the consumers' duck type)."""

    def __init__(self, X=None, var=None, obs=None):
        super().__init__(X, var, obs)
        self.obsm = {"X_pca": self.X[:, ::-1] * 0.5}

    def __len__(self):
        return self.X.shape[0]

    def __getitem__(self, key):
        mask = np.asarray(key)
        return _StandIn(self.X[mask], self.var, self.obs.loc[mask])


def test_consumers_match_jax(sims, shim, tmp_path):
    srdirs, imgs = _dirs(sims, "spaceranger_dir"), _dirs(sims, "image_file")
    shim.AnnData = _StandIn
    adata = jio.create_visium_anndata_img(srdirs, fullres_image_files=imgs,
                                          annot_files=_dirs(sims, "annot_file"),
                                          patch_size_px=6, save_patches_to=tmp_path)
    kw = dict(h_st=78, w_st=64)
    first = adata[np.asarray(adata.obs["array"]) == "arrA"]
    labels = np.searchsorted(np.unique(first.obs["annotation"]), first.obs["annotation"])
    for use_pcs in (False, 2):
        for g, w in zip(tio.anndata_to_grids(first, labels, use_pcs=use_pcs, **kw),
                        jio.anndata_to_grids(first, labels, use_pcs=use_pcs, **kw)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for g, w in zip(tio.anndata_to_spot_arrays(adata, "annotation", use_pcs=use_pcs),
                        jio.anndata_to_spot_arrays(adata, "annotation", use_pcs=use_pcs)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(tio.anndata_to_grid_arrays(adata, "annotation", "array", **kw),
                    jio.anndata_to_grid_arrays(adata, "annotation", "array", **kw)):
        np.testing.assert_array_equal(g, w)
    (gi, gc), gy, gcl = tio.anndata_mm_to_grid_arrays(adata, "annotation", "array",
                                                      device=CPU, **kw)
    (wi, wc), wy, wcl = jio.anndata_mm_to_grid_arrays(adata, "annotation", "array", **kw)
    assert gi.device == CPU and gi.dtype == torch.float32
    np.testing.assert_allclose(gi.numpy(), wi, rtol=0, atol=1e-6)
    for g, w in ((gc, wc), (gy, wy), (gcl, wcl)):
        np.testing.assert_array_equal(g, w)
    tds = tio.MMAnnSpotDataset(adata, "annotation", device=CPU)
    jds = jio.MMAnnSpotDataset(adata, "annotation")
    assert len(tds) == len(jds) and list(tds.classes) == list(jds.classes)
    for i in (0, len(jds) // 2, len(jds) - 1):
        ((ti, tc), ty), ((ji, jc), jy) = tds[i], jds[i]
        np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tc, jc)
        assert ty == jy
    (ti, tc), ty = tds.materialize()
    (ji, jc), jy = jds.materialize()
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ty, jy)


def test_patch_cache_names_shared_with_the_factory(tmp_path):
    """HD arrays with unequal lattices: the builder's caches carry the
    cohort's largest lattice, and the port's factory reads them as they are
    (no re-extraction), under the names JAX's builder gives."""
    from gridnext_tpu_torch.data.datasets import create_visium_dataset

    binning = "square_008um"
    hd = [simulate_spaceranger_dir(tmp_path / f"arr{i}", n_genes=8, n_classes=3, seed=i,
                                   image=True, spaceranger_version="hd", hd_grid=grid,
                                   hd_binning=binning)
          for i, grid in enumerate([(6, 8), (8, 6)])]
    srdirs, imgs = _dirs(hd, "spaceranger_dir"), _dirs(hd, "image_file")
    tdirs = tio.resolve_imgpatch_dirs(srdirs, imgs, patch_size_px=12, hd_binning=binning,
                                      device=CPU)
    jdirs = jio.resolve_imgpatch_dirs(srdirs, imgs, patch_size_px=12, hd_binning=binning,
                                      save_patches_to=tmp_path / "jax")
    assert [os.path.basename(d) for d in tdirs] == [os.path.basename(d) for d in jdirs]
    assert all(f"_{binning}_8x8_patches12px" in d for d in tdirs)
    stamps = {d: {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d)}
              for d in tdirs}
    ds = create_visium_dataset(srdirs, use_count=False, spatial=True,
                               annot_files=_dirs(hd, "annot_file"), patch_size_px=12,
                               hd_binning=binning, grid_dims="auto", device=CPU)
    assert stamps == {d: {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d)}
                      for d in tdirs}
    x, y = ds[0]
    assert tuple(x.shape) == (8, 8, 12, 12, 3) and tuple(y.shape) == (8, 8)
