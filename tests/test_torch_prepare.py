"""The port's count data tier against the JAX package, on the CPU.

Cohorts from the JAX package's ``simulate_spaceranger_dir`` (30-60 genes,
small tissue ellipses; one array's feature IDs renamed and shuffled so the
cohort's gene sets differ and arrive unsorted). Covered:

- ``prepare_count_files``: the caches' inflated bytes, the returned order
  and the printed lines equal to JAX's, for one array, three arrays with
  different gene sets, the detection filter off, at 0, at 0.02 and at a
  rate that removes genes, and a Visium HD binning;
- the codec (``io/tsv_codec.py``): the writer against
  ``native.write_tsv_matrix`` (equal inflated bytes, a valid ``GX`` chain,
  integer and float matrices), the reader against ``native.read_tsv_matrix``
  on the ``GX`` chain, a single-member copy and a pandas-written file with
  NaN and float cells; the bulk parse equal to the line-by-line one; a
  member cut short mid-file, and a truncated single member, raise;
- migrate-on-first-read of a single-member ``.unified`` cache (and its
  opt-out and name gate), and the count-matrix cache's LRU order;
- the gene-axis checks: a second cache with its genes reversed makes the
  factory, ``CountGridDataset`` and ``CountSpotDataset`` raise JAX's
  ``ValueError``;
- ``distance_um_to_px`` on lattices of more than 10 spots; the factory's
  on-demand caches and ``patch_size_um``; ``MMSpotDataset``,
  ``to_splotch_annots``, ``load_count_dataset``, ``load_count_grid_dataset``
  and the Splotch ``CountGridDataset`` against JAX's.
"""

import gzip
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from gridnext_tpu import native
from gridnext_tpu.data import CountGridDataset as JaxCountGridDataset
from gridnext_tpu.data import CountSpotDataset as JaxCountSpotDataset
from gridnext_tpu.data import create_visium_dataset as jax_create_visium_dataset
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.data.datasets import load_count_dataset as jax_load_count_dataset
from gridnext_tpu.data.datasets import load_count_grid_dataset as jax_load_count_grid_dataset
from gridnext_tpu.io import prepare_count_files as jax_prepare
from gridnext_tpu.io.annotations import to_splotch_annots as jax_to_splotch
from gridnext_tpu.pipeline import distance_um_to_px as jax_distance_um_to_px
from gridnext_tpu.pipeline import grid_from_wsi_visium
from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.data import (CountGridDataset, CountSpotDataset, create_visium_dataset,
                                     load_count_dataset, load_count_grid_dataset)
from gridnext_tpu_torch.data import datasets as port_datasets
from gridnext_tpu_torch.io import tsv_codec
from gridnext_tpu_torch.io.annotations import to_splotch_annots
from gridnext_tpu_torch.io.unify import prepare_count_files
from gridnext_tpu_torch.pipeline import distance_um_to_px

BINNING = "square_016um"


def _inflated(path):
    with open(path, "rb") as fh:
        return gzip.decompress(fh.read())


def _rename_features(srd, seed):
    """Shuffle an array's feature IDs and rename a third of them (the
    cohort's union then differs from every array's axis and is unsorted)."""
    path = os.path.join(srd, "outs", "filtered_feature_bc_matrix", "features.tsv.gz")
    lines = _inflated(path).decode().splitlines()
    rng = np.random.default_rng(seed)
    ids = [ln.split("\t", 1)[0] for ln in lines]
    ids = [f"ENSG9{i[5:]}" if k % 3 == 0 else i for k, i in enumerate(ids)]
    ids = list(np.asarray(ids)[rng.permutation(len(ids))])
    with gzip.open(path, "wt") as fh:
        for i, ln in zip(ids, lines):
            fh.write(i + "\t" + ln.split("\t", 1)[1] + "\n")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("prepare")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=g, n_classes=3,
                                     tissue_fraction=0.3, image=True, spot_spacing_px=14)
            for i, g in enumerate((40, 60, 30))]
    _rename_features(sims[1]["spaceranger_dir"], 5)
    return sims


def _both_prepare(dirs, rate, capsys, **kw):
    want = jax_prepare(dirs, ".jax.tsv.gz", rate, **kw)
    want_out = capsys.readouterr().out
    got = prepare_count_files(dirs, ".port.tsv.gz", rate, **kw)
    assert capsys.readouterr().out == want_out
    assert [p.replace(".port.", ".jax.") for p in got] == want
    for g, w in zip(got, want):
        assert _inflated(g) == _inflated(w)
    return got


@pytest.mark.parametrize("arrays, rate", [((0,), 0.02), ((0, 1, 2), None), ((0, 1, 2), 0.0),
                                          ((0, 1, 2), 0.02), ((0, 1, 2), 0.45),
                                          ((2, 0), 0.45)])
def test_prepare_matches_jax(cohort, capsys, arrays, rate):
    dirs = [cohort[i]["spaceranger_dir"] for i in arrays]
    got = _both_prepare(dirs, rate, capsys)
    genes = tsv_codec.read_row_names(got[0])
    assert len(genes) > 0
    if rate == 0.45:
        assert len(genes) < len(tsv_codec.read_row_names(
            prepare_count_files(dirs, ".all.tsv.gz", None, verbose=False)[0]))


def test_prepare_hd_matches_jax(tmp_path, capsys):
    dirs = [simulate_spaceranger_dir(tmp_path / f"hd{i}", seed=i, n_genes=35,
                                     spaceranger_version="hd", hd_grid=(18, 22),
                                     hd_binning=BINNING)["spaceranger_dir"] for i in range(2)]
    got = _both_prepare(dirs, 0.02, capsys, hd_binning=BINNING)
    assert all(f".{BINNING}." not in p for p in got)      # the explicit suffix wins
    default = prepare_count_files(dirs, hd_binning=BINNING, verbose=False)
    assert default[0].endswith(f".{BINNING}.unified.tsv.gz")


def _matrix(seed, shape=(70, 45), floats=False):
    rng = np.random.default_rng(seed)
    values = rng.poisson(rng.gamma(2.0, 2.0, (shape[0], 1)), shape).astype(np.float64)
    values[0, :3] = [0, 123456789012, 7]
    if floats:
        values[rng.random(shape) < 0.1] = 0.1 * np.pi
        values[3, 4] = -2.5e-7
        values[5, 6] = -3
    genes = [f"ENSG{i:05d}" for i in rng.permutation(shape[0])]
    columns = [f"{i}_{i % 9}" for i in range(shape[1])]
    return genes, columns, values


@pytest.mark.parametrize("floats, force_int", [(False, True), (False, False), (True, False)])
def test_writer_matches_native(tmp_path, monkeypatch, floats, force_int):
    genes, columns, values = _matrix(1, floats=floats)
    want, got = tmp_path / "jax.tsv.gz", tmp_path / "port.tsv.gz"
    assert native.write_tsv_matrix(want, genes, columns, values, force_int=force_int)
    tsv_codec.write_tsv_matrix(got, genes, columns, values, force_int=force_int)
    assert _inflated(got) == _inflated(want)
    data = got.read_bytes()
    chain = tsv_codec.member_chain(data)
    assert chain[0][0] == 0 and sum(size for _, size in chain) == len(data)
    assert tsv_codec.gzip_member_format(got) == native.gzip_member_format(want) == "native"
    plain = tmp_path / "port.tsv"
    tsv_codec.write_tsv_matrix(plain, genes, columns, values, force_int=force_int)
    assert plain.read_bytes() == _inflated(want)
    # many members: rows cut into raw chunks (64 rows at least; 4 MB in use)
    monkeypatch.setattr(tsv_codec, "_CHUNK_BYTES", 10_000)
    genes, columns, values = _matrix(2, shape=(300, 20))
    many = tmp_path / "many.tsv.gz"
    tsv_codec.write_tsv_matrix(many, genes, columns, values, force_int=True)
    assert native.write_tsv_matrix(want, genes, columns, values, force_int=True)
    assert len(tsv_codec.member_chain(many.read_bytes())) == 1 + 5
    assert _inflated(many) == _inflated(want)


def _assert_same_read(got, want):
    assert got[0] == list(want[0]) and got[1] == list(want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_reader_matches_native(tmp_path, monkeypatch):
    monkeypatch.setattr(tsv_codec, "_CHUNK_BYTES", 10_000)
    genes, columns, values = _matrix(3, shape=(300, 40))
    multi = tmp_path / "multi.tsv.gz"
    tsv_codec.write_tsv_matrix(multi, genes, columns, values, force_int=True)
    assert len(tsv_codec.member_chain(multi.read_bytes())) == 6
    jax_multi = tmp_path / "jax.tsv.gz"
    assert native.write_tsv_matrix(jax_multi, genes, columns, values, force_int=True)
    _assert_same_read(tsv_codec.read_tsv_matrix(jax_multi), native.read_tsv_matrix(jax_multi))
    single = tmp_path / "single.tsv.gz"
    single.write_bytes(gzip.compress(_inflated(multi)))
    for path, framing in ((multi, "native"), (single, "foreign")):
        assert tsv_codec.gzip_member_format(path) == native.gzip_member_format(path) == framing
        _assert_same_read(tsv_codec.read_tsv_matrix(path), native.read_tsv_matrix(path))
        assert tsv_codec.read_row_names(path) == genes
    # pandas' file: empty cells (NaN) and floats, one member
    frame = pd.DataFrame(values[:50, :12], index=genes[:50], columns=columns[:12])
    frame.iloc[2, 3] = np.nan
    frame.iloc[7, 0] = 0.25
    frame.iloc[9, 11] = -1e-3
    frame.index.name = "Gene"
    pandas_file = tmp_path / "pandas.tsv.gz"
    frame.to_csv(pandas_file, sep="\t")
    got = tsv_codec.read_tsv_matrix(pandas_file)
    want = native.read_tsv_matrix(pandas_file)
    _assert_same_read(got, want)
    assert np.isnan(got[2][2, 3]) and got[2][7, 0] == 0.25


def test_bulk_parse_equals_line_parse():
    rng = np.random.default_rng(4)
    values = rng.integers(0, 10 ** rng.integers(1, 16, (40, 1)), (40, 25))
    text = tsv_codec.format_int_rows(values, [f"g{i}".encode() for i in range(40)])
    names, got = tsv_codec.parse_rows(text, 25)
    want_names, want = tsv_codec.parse_rows_slow(text, 25)
    assert names == want_names == [f"g{i}" for i in range(40)]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, values.astype(np.float64))
    for odd in (b"g\t1\t\n", b"g\t1\t-2\n", b"g\t1.5\t2\n", b"g\t1\t2\r\n", b"\ng\t3\t4\n"):
        np.testing.assert_array_equal(tsv_codec.parse_rows(odd, 2)[1],
                                      tsv_codec.parse_rows_slow(odd, 2)[1])
    with pytest.raises(ValueError, match="a row has 3 values for 2 columns"):
        tsv_codec.parse_rows(b"g\t1\t2\t3\n", 2)


def test_truncated_files_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(tsv_codec, "_CHUNK_BYTES", 10_000)
    genes, columns, values = _matrix(5, shape=(300, 20))
    multi = tmp_path / "multi.tsv.gz"
    tsv_codec.write_tsv_matrix(multi, genes, columns, values, force_int=True)
    data = multi.read_bytes()
    chain = tsv_codec.member_chain(data)
    cut = tmp_path / "cut.tsv.gz"
    cut.write_bytes(data[:chain[3][0] + chain[3][1] // 2])       # inside member 3
    with pytest.raises(ValueError, match="GX member chain broken"):
        tsv_codec.read_tsv_matrix(cut)
    single = tmp_path / "single.tsv.gz"
    packed = gzip.compress(_inflated(multi))
    single.write_bytes(packed[:len(packed) // 2])
    with pytest.raises(ValueError, match="unreadable gzip stream"):
        tsv_codec.read_tsv_matrix(single)


def test_migrate_on_first_read_and_lru(tmp_path, monkeypatch):
    genes, columns, values = _matrix(6)
    text = tsv_codec.format_int_rows(values.astype(np.int64), [g.encode() for g in genes])
    header = ("Gene\t" + "\t".join(columns) + "\n").encode()
    files = {}
    for name in ("x.unified.tsv.gz", "optout.unified.tsv.gz", "user.tsv.gz"):
        files[name] = tmp_path / name
        files[name].write_bytes(gzip.compress(header + text))
    port_datasets._MATRICES.clear()
    got = port_datasets._count_matrix(files["x.unified.tsv.gz"])
    assert tsv_codec.gzip_member_format(files["x.unified.tsv.gz"]) == "native"
    assert _inflated(files["x.unified.tsv.gz"]) == header + text
    _assert_same_read(got, (genes, columns, values))
    key = list(port_datasets._MATRICES)[-1]
    assert key[2] == os.path.getsize(files["x.unified.tsv.gz"])   # keyed on the new bytes
    port_datasets._count_matrix(files["user.tsv.gz"])
    assert tsv_codec.gzip_member_format(files["user.tsv.gz"]) == "foreign"
    monkeypatch.setenv("GNX_CACHE_MIGRATE", "0")
    port_datasets._count_matrix(files["optout.unified.tsv.gz"])
    assert tsv_codec.gzip_member_format(files["optout.unified.tsv.gz"]) == "foreign"

    # least recently used goes first: a hit moves its entry to the back
    paths = []
    for i in range(5):
        p = tmp_path / f"lru{i}.tsv"
        p.write_text(f"Gene\t0_0\ng{i}\t{i}\n")
        paths.append(str(p))
    port_datasets._MATRICES.clear()
    for p in paths[:4]:
        port_datasets._count_matrix(p)
    port_datasets._count_matrix(paths[0])
    assert [k[0] for k in port_datasets._MATRICES] == paths[1:4] + paths[:1]
    port_datasets._count_matrix(paths[4])
    assert [k[0] for k in port_datasets._MATRICES] == paths[2:4] + [paths[0], paths[4]]


@pytest.fixture()
def misaligned(tmp_path):
    """Two arrays prepared in separate runs; the second cache rewritten
    with the first's genes in reverse order."""
    sims = [simulate_spaceranger_dir(tmp_path / f"m{i}", seed=i, n_genes=30, n_classes=3,
                                     tissue_fraction=0.3) for i in range(2)]
    dirs = [s["spaceranger_dir"] for s in sims]
    caches = [jax_prepare([d], minimum_detection_rate=0.02, verbose=False)[0] for d in dirs]
    genes, columns, values = tsv_codec.read_tsv_matrix(caches[1])
    tsv_codec.write_tsv_matrix(caches[1], genes[::-1], columns, values[::-1], force_int=True)
    return dirs, caches, [s["annot_file"] for s in sims]


def _same_error(jax_fn, port_fn):
    with pytest.raises(ValueError) as want:
        jax_fn()
    with pytest.raises(ValueError) as got:
        port_fn()
    assert "count files do not share a gene axis" in str(want.value)
    assert str(got.value) == str(want.value)


def test_misaligned_gene_axes_raise_as_jax(misaligned):
    dirs, caches, annots = misaligned
    for spatial in (True, False):
        _same_error(lambda: jax_create_visium_dataset(dirs, use_image=False, spatial=spatial,
                                                      annot_files=annots),
                    lambda: create_visium_dataset(dirs, use_image=False, spatial=spatial,
                                                  annot_files=annots, device="cpu"))
    positions = [os.path.join(d, "outs", "spatial", "tissue_positions.csv") for d in dirs]
    _same_error(lambda: JaxCountGridDataset(caches), lambda: CountGridDataset(caches))
    _same_error(lambda: JaxCountSpotDataset(caches, annots, positions),
                lambda: CountSpotDataset(caches, annots, positions))
    # select_genes aligns the files by name: no error, the same vectors
    genes = tsv_codec.read_row_names(caches[0])[:7]
    want = JaxCountSpotDataset(caches, annots, positions, select_genes=genes).materialize()
    got = CountSpotDataset(caches, annots, positions, select_genes=genes).materialize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_distance_um_to_px_matches_jax(cohort, tmp_path):
    hd = simulate_spaceranger_dir(tmp_path / "hd", seed=1, n_genes=10, spaceranger_version="hd",
                                  hd_grid=(9, 13), hd_binning=BINNING, spot_spacing_px=7)
    for srd, binning in ((cohort[0]["spaceranger_dir"], None),
                         (cohort[1]["spaceranger_dir"], None), (hd["spaceranger_dir"], BINNING)):
        for um in (100.0, 55.0, 250.0, 33.3):
            assert distance_um_to_px(srd, um, hd_binning=binning) == \
                jax_distance_um_to_px(srd, um, hd_binning=binning)
    # the 10 rows pandas' sample(n=10, random_state=0) picks
    frame = pd.DataFrame({"i": np.arange(4992)})
    assert list(frame.sample(n=10, random_state=0).index) == \
        list(np.random.RandomState(0).choice(4992, 10, replace=False))
    cart = np.random.default_rng(0).random((12, 2))
    iu, ju = np.triu_indices(12, 1)
    np.testing.assert_allclose(geometry.pairwise_distances(cart),
                               np.linalg.norm(cart[iu] - cart[ju], axis=1))


def test_factory_writes_caches_and_mm_spots(cohort, tmp_path, capsys):
    src = [cohort[i] for i in (0, 2)]
    dirs = []
    for s in src:       # fresh copies: no caches yet
        dst = tmp_path / os.path.basename(s["spaceranger_dir"])
        shutil.copytree(s["spaceranger_dir"], dst,
                        ignore=shutil.ignore_patterns("a[0-9].*", "*_patches*"))
        shutil.copytree(s["spaceranger_dir"], tmp_path / "jax" / dst.name,
                        ignore=shutil.ignore_patterns("a[0-9].*", "*_patches*"))
        dirs.append(str(dst))
    jdirs = [str(tmp_path / "jax" / os.path.basename(d)) for d in dirs]
    annots = [s["annot_file"] for s in src]
    images = [s["image_file"] for s in src]
    got = create_visium_dataset(dirs, use_image=False, annot_files=annots,
                                minimum_detection_rate=0.1, device="cpu")
    assert "No unified countfiles detected" in capsys.readouterr().out
    want = jax_create_visium_dataset(jdirs, use_image=False, annot_files=annots,
                                     minimum_detection_rate=0.1)
    for d, j in zip(dirs, jdirs):
        name = os.path.basename(d) + ".unified.tsv.gz"
        assert _inflated(os.path.join(d, name)) == _inflated(os.path.join(j, name))
    for (x, y), (jx, jy) in zip((got[i] for i in range(2)), (want[i] for i in range(2))):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)

    # multimodal spots, the patch size from patch_size_um (100 um)
    px = jax_distance_um_to_px(jdirs[0], 100.0)
    mm = create_visium_dataset(dirs, fullres_image_files=images, spatial=False,
                               annot_files=annots, device="cpu")
    jmm = jax_create_visium_dataset(jdirs, fullres_image_files=images, spatial=False,
                                    annot_files=annots)
    assert len(mm) == len(jmm) > 0
    assert [mm.images.keys[i] for i, _, _ in mm._index] == [c for _, _, c in jmm._index]
    (xi, xc), y = mm.materialize()
    (_, jxc), jy = jmm.materialize()
    np.testing.assert_array_equal(xc, jxc)
    np.testing.assert_array_equal(y, jy)
    assert tuple(xi.shape) == (len(mm), px, px, 3)
    # the patches are lossless crops: JAX's uint8 grid at each spot
    grids = [grid_from_wsi_visium(im, d, patch_size=px, dtype=np.uint8)
             for im, d in zip(images, jdirs)]
    slide = mm.images.slide[mm._spots]
    for k, (i, _, _) in enumerate(mm._index):
        c, r = map(int, mm.images.keys[i].split("_"))
        ox, oy = geometry.pseudo_hex_to_oddr(c, r)
        np.testing.assert_array_equal(xi[k].numpy(), grids[slide[k]][oy, ox] / np.float32(255))
    (pi, pc), py = mm[3]
    np.testing.assert_array_equal(pc, jxc[3])
    assert py == jy[3] and tuple(pi.shape) == (px, px, 3)


def test_splotch_loaders_match_jax(cohort, tmp_path, capsys):
    dirs = [cohort[i]["spaceranger_dir"] for i in (0, 2)]
    loupe = [cohort[i]["annot_file"] for i in (0, 2)]
    caches = jax_prepare(dirs, ".splotch.tsv.gz", 0.02, verbose=False)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_to_splotch(loupe, dirs, tmp_path / "jax")
    to_splotch_annots(loupe, dirs, tmp_path / "port")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
    to_splotch_annots(loupe, dirs, tmp_path / "port", include_annots=["Layer2", "Layer1"])
    jax_to_splotch(loupe, dirs, tmp_path / "jax", include_annots=["Layer2", "Layer1"])
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
    splotch = [str(tmp_path / "port" / n) for n in names]
    genes = tsv_codec.read_row_names(caches[0])[::-2]
    for kw in ({}, {"select_genes": genes}):
        for got, want in zip(load_count_dataset(caches, splotch, **kw),
                             jax_load_count_dataset(caches, splotch, **kw)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(load_count_grid_dataset(caches, splotch, **kw),
                             jax_load_count_grid_dataset(caches, splotch, **kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        ds = CountGridDataset(caches, annot_files=splotch, annot_format="splotch", **kw)
        jds = JaxCountGridDataset(caches, annot_files=splotch, annot_format="splotch", **kw)
        for i in range(2):
            for g, w in zip(ds[i], jds[i]):
                np.testing.assert_array_equal(g, w)
    x, y = load_count_dataset(caches)
    assert x.shape[0] == len(y) and not y.any()
    missing = tmp_path / "missing.csv"
    missing.write_text("Barcode,AARs\nNOT_A_BARCODE,Layer1\n")
    with pytest.raises(ValueError, match="have no row"):
        to_splotch_annots([missing], dirs[:1], tmp_path / "port")


def test_count_matrix_cache_under_threads(tmp_path):
    """16 threads reading 6 files through the shared LRU (a short switch
    interval): every read is its file's matrix, and at most 4 entries stay."""
    import sys
    import threading

    paths = []
    for i in range(6):
        p = tmp_path / f"t{i}.tsv"
        p.write_text(f"Gene\t0_0\t1_1\ng{i}\t{i}\t{2 * i}\n")
        paths.append(str(p))
    port_datasets._MATRICES.clear()
    errors, interval = [], sys.getswitchinterval()

    def work(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, 6, 200):
            genes, _, values = port_datasets._count_matrix(paths[i])
            if genes != [f"g{i}"] or values.tolist() != [[i, 2 * i]]:
                errors.append((i, genes, values))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(port_datasets._MATRICES) <= 4
