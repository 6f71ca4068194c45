"""The port's multimodal ``register`` routes against the JAX package, on the
CPU.

Simulated Spaceranger directories (two hex arrays named ``outs``, square
Visium HD lattices of 12-px bins), their unified count caches written by
the JAX package's ``prepare_count_files``, and model directories written
as the JAX package's trainers write them (a TrainState checkpoint, weights
moved off init by numpy noise). Covered:

- the MEX readers (``find_feature_matrix_files``, ``read_feature_names``,
  ``read_feature_matrix``) against JAX's: equal paths, IDs, symbols and
  counts; the filtered matrix preferred over a raw one;
- ``scbert_count_transform`` against JAX's: equal outputs, the zero-overlap
  error, the fallback to the raw IDs without a features file;
- the image grid of one array (``pipeline.patch_grid``) against JAX's
  ``grid_from_wsi_visium(dtype=np.uint8) / 255``: exact, hex and square,
  with spots within ``window // 2`` of the border; the resized grid within
  1/255 of ``extract_patches_device``;
- dense-ingest grids against JAX's ``DenseWSIGridDataset``: exact, equal to
  the per-bin grid, and the same refusal of a pitch that is not the patch;
- ``python -m gridnext_tpu_torch register --device cpu`` on hex (scBERT and
  ``CountMLP`` count f, the latter at ``window_px`` 24) and square (per-bin
  and dense-ingest) multimodal directories: labels equal to JAX's model on
  JAX's lossless grid up to near-ties by JAX's logits, foreground equal;
- the square count route (``GridNet+CountMLP`` with ``grid_dims``): CSVs
  byte-identical to the JAX command's; the multimodal route's exits (a
  missing image, a missing or mismatched cache, no gene2vec gene) those
  of the JAX command;
- JAX's own ``register`` command, which writes and reads back a JPEG patch
  cache (and PIL-resizes windows): the same CSV rows and foreground, the
  patch and label gap printed; the port's command leaves the Spaceranger
  directories as they were.
"""

import csv
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import CountGridDataset as JaxCountGridDataset
from gridnext_tpu.data import DenseWSIGridDataset as JaxDenseWSIGridDataset
from gridnext_tpu.data import create_visium_dataset as jax_create_visium_dataset
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.geometry import pseudo_hex_to_oddr
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.io import spaceranger as jax_spaceranger
from gridnext_tpu.io.unify import read_unified_genes, unified_cache_path
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHexMM as JaxGridNetHexMM
from gridnext_tpu.models import GridNetMM as JaxGridNetMM
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.models import scBERT as JaxScBERT
from gridnext_tpu.models.scbert import load_gene2vec_names
from gridnext_tpu.pipeline import _spot_pixel_boxes as jax_spot_pixel_boxes
from gridnext_tpu.pipeline import extract_patches_device, grid_from_wsi_visium
from gridnext_tpu.train import create_train_state, make_gridwise_optimizer, save_checkpoint
from gridnext_tpu_torch import io, modeldir
from gridnext_tpu_torch.cli import main
from gridnext_tpu_torch.data import DenseWSIGridDataset, SlideGridDataset
from gridnext_tpu_torch.pipeline import patch_grid
from gridnext_tpu_torch.serving import label_parity_report


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    machine's cores, and multi-threaded small CPU ops contend badly there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_CLASSES, PATCH, GENES, VOCAB = 3, 16, 30, 40
CLASSES = ["A", "B", "C"]
TPU_F = {"stages": [[32, 1]], "stem_patch": 8, "norm": "rms"}
HD_TPU_F = {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"}
BINNING = "square_016um"
HD_GRID, HD_PITCH = (12, 14), 12
# cohort genes: every other gene2vec symbol from the second, half of them
# inside the model's first VOCAB gene2vec names and none the first
SYMBOLS = load_gene2vec_names()[1:2 * GENES + 1:2]


def _moved(variables, seed=1):
    rng = np.random.default_rng(seed)

    def move(path, a):
        if str(getattr(path[-1], "key", "")) == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, variables)


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


@pytest.fixture(scope="module")
def hex_cohort(tmp_path_factory):
    """Two hex arrays, both directories named ``outs``, with slides and
    unified caches (feature IDs mapping to gene2vec symbols)."""
    root = tmp_path_factory.mktemp("torch_register_mm")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=i, n_genes=GENES,
                                     n_classes=N_CLASSES, image=True, spot_spacing_px=10,
                                     tissue_fraction=frac, gene_names=SYMBOLS)
            for i, frac in enumerate((0.5, 0.35))]
    dirs = [str(Path(s["spaceranger_dir"]) / "outs") for s in sims]
    prepare_count_files(dirs, verbose=False)
    return root, dirs, [s["image_file"] for s in sims]


@pytest.fixture(scope="module")
def hd_cohort(tmp_path_factory):
    """Two Visium HD arrays: 12 x 14 bins at a 12-px pitch (an exact plan at
    12-px patches), slides and binned unified caches."""
    root = tmp_path_factory.mktemp("torch_register_mm_hd")
    sims = [simulate_spaceranger_dir(root / f"hd{i}", seed=5 + i, n_genes=GENES,
                                     n_classes=N_CLASSES, spaceranger_version="hd",
                                     hd_grid=HD_GRID, hd_binning=BINNING, image=True,
                                     spot_spacing_px=HD_PITCH, tissue_fraction=0.8)
            for i in range(2)]
    dirs = [s["spaceranger_dir"] for s in sims]
    prepare_count_files(dirs, verbose=False, hd_binning=BINNING)
    return root, dirs, [s["image_file"] for s in sims]


def _hex_mm_dir(root, dirs, count_f, window_px):
    genes = read_unified_genes(unified_cache_path(dirs[0]))
    if count_f == "scbert":
        count = JaxScBERT(n_genes=VOCAB, dim=16, depth=1, heads=2, dim_head=8,
                          nb_features=8, n_classes=N_CLASSES, generalized_attention=True)
        width = VOCAB
    else:
        count, width = JaxCountMLP(n_classes=N_CLASSES), len(genes)
    g = JaxGridNetHexMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((32, 1),),
                                                 stem_patch=8),
                        count_classifier=count, n_classes=N_CLASSES, patch_chunk=256,
                        count_chunk=64)
    meta = {"patch_px": PATCH, "window_px": window_px, "patch_chunk": 256,
            "count_chunk": 64, "n_genes": len(genes), "genes": genes,
            "log1p": count_f != "scbert", "count_f": count_f, "scbert_vocab": VOCAB,
            "scbert_dim": 16, "scbert_depth": 1, "scbert_heads": 2, "scbert_dim_head": 8,
            "scbert_features": 8, "hd_binning": None, "grid_dims": None, "image_f": "tpu",
            "tpu_f": TPU_F, "dense_ingest": False, "model": "GridNetHexMM"}
    sample = (jnp.zeros((1, 2, 2, PATCH, PATCH, 3)), jnp.zeros((1, 2, 2, width)))
    return _write_model_dir(root / f"model_{count_f}", g, sample, meta)


@pytest.fixture(scope="module")
def hex_dirs(hex_cohort):
    """scBERT count f at window == patch; CountMLP count f at window 24."""
    root, dirs, _ = hex_cohort
    return {"scbert": _hex_mm_dir(root, dirs, "scbert", None),
            "mlp": _hex_mm_dir(root, dirs, "mlp", 24)}


@pytest.fixture(scope="module")
def hd_mm_dirs(hd_cohort):
    root, dirs, _ = hd_cohort
    genes = read_unified_genes(unified_cache_path(dirs[0], BINNING))
    g = JaxGridNetMM(image_classifier=JaxTpuF(n_classes=N_CLASSES, stages=((16, 1),),
                                              stem_patch=4),
                     count_classifier=JaxCountMLP(n_classes=N_CLASSES),
                     n_classes=N_CLASSES, patch_chunk=64)
    sample = (jnp.zeros((1, 2, 2, HD_PITCH, HD_PITCH, 3)), jnp.zeros((1, 2, 2, len(genes))))
    out = {}
    for dense in (False, True):
        meta = {"patch_px": HD_PITCH, "window_px": None, "patch_chunk": 64,
                "count_chunk": None, "n_genes": len(genes), "genes": genes, "log1p": True,
                "count_f": "mlp", "hd_binning": BINNING, "grid_dims": list(HD_GRID),
                "image_f": "tpu", "tpu_f": HD_TPU_F, "dense_ingest": dense,
                "model": "GridNetMM"}
        out[dense] = _write_model_dir(root / f"model_mm_{dense}", g, sample, meta)
    return out


def _slide(image_file):
    return np.asarray(Image.open(image_file).convert("RGB"))


# -- readers and the count transform -------------------------------------------


@pytest.mark.parametrize("kind", ["hex", "hd"])
def test_feature_readers_match_jax(kind, hex_cohort, hd_cohort, tmp_path):
    _, dirs, _ = hex_cohort if kind == "hex" else hd_cohort
    hd = None if kind == "hex" else BINNING
    srd = dirs[0]
    if kind == "hex":
        # a raw matrix beside the filtered one must not shadow it
        srd = str(tmp_path / "outs")
        shutil.copytree(dirs[0], srd)
        shutil.copytree(Path(srd, "filtered_feature_bc_matrix"),
                        Path(srd, "raw_feature_bc_matrix"))
    want_files = jax_spaceranger.find_feature_matrix_files(srd, hd)
    assert io.find_feature_matrix_files(srd, hd) == want_files
    assert "filtered_feature_bc_matrix" in want_files["matrix"]
    names = jax_spaceranger.read_feature_names(srd, hd_binning=hd)
    assert io.read_feature_names(srd, hd_binning=hd) == names["gene_symbol"].to_dict()
    df = jax_spaceranger.read_feature_matrix(srd, hd_binning=hd)
    counts, ids, barcodes = io.read_feature_matrix(srd, hd_binning=hd)
    assert ids == list(df.index) and barcodes == list(df.columns)
    np.testing.assert_array_equal(counts, df.values)
    pick = list(df.columns[::-3])
    sub, _, cols = io.read_feature_matrix(srd, hd_binning=hd, barcodes=pick)
    assert cols == pick
    np.testing.assert_array_equal(sub, df[pick].values)
    with pytest.raises(KeyError):
        io.read_feature_matrix(srd, hd_binning=hd, barcodes=["NOT_A_BARCODE"])


def test_scbert_count_transform_matches_jax(hex_cohort, tmp_path, capsys):
    _, dirs, _ = hex_cohort
    raw = np.random.default_rng(0).poisson(
        1.0, (3, 5, len(read_unified_genes(unified_cache_path(dirs[0]))))).astype(np.float32)
    want, n_want = jax_modeldir.scbert_count_transform(dirs, None, VOCAB)
    want_out = capsys.readouterr().out
    got, n_got = modeldir.scbert_count_transform(dirs, None, VOCAB)
    assert capsys.readouterr().out == want_out and "20/" in want_out
    assert n_got == n_want == VOCAB
    np.testing.assert_array_equal(got(raw), want(raw))
    # the first gene2vec name alone: no cohort gene maps, the same error
    vocab1 = [jax_modeldir.scbert_count_transform, modeldir.scbert_count_transform]
    msgs = []
    for fn in vocab1:
        with pytest.raises(ValueError, match="no cohort gene symbols") as e:
            fn(dirs, None, 1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # without a features file the cache's own names are the symbols
    srd = tmp_path / "outs"
    shutil.copytree(dirs[0], srd)
    (srd / "filtered_feature_bc_matrix" / "features.tsv.gz").unlink()
    cache = unified_cache_path(str(srd))
    ids = read_unified_genes(cache)
    text = Path(cache).read_bytes()
    import gzip

    lines = gzip.decompress(text).decode().split("\n")
    lut = dict(zip(ids, SYMBOLS))
    lines = [lines[0]] + [("\t".join([lut[ln.split("\t", 1)[0]], ln.split("\t", 1)[1]])
                           if ln else ln) for ln in lines[1:]]
    Path(cache).write_bytes(gzip.compress("\n".join(lines).encode()))
    want, _ = jax_modeldir.scbert_count_transform([str(srd)], None, VOCAB)
    got, _ = modeldir.scbert_count_transform([str(srd)], None, VOCAB)
    np.testing.assert_array_equal(got(raw), want(raw))
    assert got(raw).any()


# -- image grids -------------------------------------------------------------------


def _border_spots(positions, shape, half):
    keep = positions["in_tissue"] == 1
    y = np.rint(positions["pxl_row_in_fullres"][keep])
    x = np.rint(positions["pxl_col_in_fullres"][keep])
    return int(((y < half) | (x < half) | (y >= shape[0] - half)
                | (x >= shape[1] - half)).sum())


@pytest.mark.parametrize("kind", ["hex", "square"])
def test_patch_grid_matches_jax_exactly(kind, tmp_path):
    """A full tissue ellipse reaches the lattice's edge spots, and the crop
    window is wider than twice the slide margin: edge spots read padding."""
    if kind == "hex":
        sim = simulate_spaceranger_dir(tmp_path / "b", seed=2, n_genes=4, image=True,
                                       spot_spacing_px=6, tissue_fraction=1.0)
        srd, hd, dims, patch = str(Path(sim["spaceranger_dir"]) / "outs"), None, (78, 64), 32
    else:
        sim = simulate_spaceranger_dir(tmp_path / "b", seed=2, n_genes=4,
                                       spaceranger_version="hd", hd_grid=(8, 9),
                                       hd_binning=BINNING, image=True, spot_spacing_px=12,
                                       tissue_fraction=1.0)
        srd, hd, dims, patch = sim["spaceranger_dir"], BINNING, (8, 9), 64
    wsi = _slide(sim["image_file"])
    positions = io.read_positions(srd, hd)
    assert _border_spots(positions, wsi.shape, patch // 2) > 0
    want = grid_from_wsi_visium(sim["image_file"], srd, patch_size=patch, h_st=dims[0],
                                w_st=dims[1], dtype=np.uint8, hd_binning=hd)
    got = patch_grid(torch.from_numpy(wsi.copy()), positions, patch, h_st=dims[0],
                     w_st=dims[1], hex_coords=hd is None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32) / 255.0)


def _jax_device_grid(image_file, srd, patch, window, dims=(78, 64)):
    """JAX's device crop + cubic resize (``extract_patches_device``) on the
    edge-padded slide, scattered like ``grid_from_wsi_visium``: /255."""
    img = np.pad(_slide(image_file), [(window // 2,) * 2, (window // 2,) * 2, (0, 0)],
                 mode="edge")
    x_ind, y_ind, x_px, y_px = jax_spot_pixel_boxes(jax_read_positions(srd), window)
    patches = np.asarray(extract_patches_device(jnp.asarray(img), y_px, x_px, window, patch))
    grid = np.zeros(dims + (patch, patch, 3), np.float32)
    grid[y_ind, x_ind] = patches.astype(np.float32) / 255.0
    return grid


def test_patch_grid_resize_matches_jax_device(hex_cohort):
    _, dirs, images = hex_cohort
    want = _jax_device_grid(images[0], dirs[0], PATCH, 24)
    got = patch_grid(torch.from_numpy(_slide(images[0]).copy()), io.read_positions(dirs[0]),
                     PATCH, 24).numpy()
    assert np.abs(got - want).max() <= 1 / 255 + 1e-7
    assert ((got > 0).any(axis=(2, 3, 4)) == (want > 0).any(axis=(2, 3, 4))).all()


def test_dense_ingest_matches_jax(hd_cohort):
    _, dirs, images = hd_cohort
    want = JaxDenseWSIGridDataset(images, dirs, None, patch_size=HD_PITCH,
                                  hd_binning=BINNING, grid_dims=HD_GRID)
    got = DenseWSIGridDataset(images, dirs, patch_size=HD_PITCH, hd_binning=BINNING,
                              grid_dims=HD_GRID, device="cpu")
    per_bin = SlideGridDataset(images, dirs, patch_size=HD_PITCH, hd_binning=BINNING,
                               h_st=HD_GRID[0], w_st=HD_GRID[1], device="cpu")
    for i in range(len(dirs)):
        grid, labels = got[i]
        np.testing.assert_array_equal(grid.numpy(), want[i][0])
        np.testing.assert_array_equal(grid.numpy(), per_bin[i][0].numpy())
        assert not labels.any()
    # a patch that is not the pitch: the same refusal
    msgs = []
    for ds in (JaxDenseWSIGridDataset(images, dirs, None, patch_size=10, hd_binning=BINNING,
                                      grid_dims=HD_GRID),
               DenseWSIGridDataset(images, dirs, patch_size=10, hd_binning=BINNING,
                                   grid_dims=HD_GRID, device="cpu")):
        with pytest.raises(ValueError, match="not an exact integer 10px-pitch") as e:
            ds[0]
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the register command ------------------------------------------------------------


def _csv_grid(path, srd, hd=None, dims=(78, 64)):
    """The label grid a Loupe CSV names, and its barcodes."""
    pos = jax_read_positions(srd, hd_binning=hd)
    grid = np.zeros(dims, np.int64)
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["Barcode", "AARs"]
    for barcode, annot in rows[1:]:
        col, row = int(pos.loc[barcode, "array_col"]), int(pos.loc[barcode, "array_row"])
        x, y = pseudo_hex_to_oddr(col, row) if hd is None else (col, row)
        grid[y, x] = CLASSES.index(annot) + 1 if annot else 0
    return grid, [r[0] for r in rows]


def _jax_reference(model_dir, srd, image, hd=None, dims=(78, 64)):
    """(labels, logits) of JAX's model on JAX's lossless grid: the uint8
    crops of ``grid_from_wsi_visium`` / 255 (the device resize where the
    window differs), the count grid of JAX's ``CountGridDataset`` through
    JAX's count transform; the tissue from the raw counts."""
    meta, classes, variables = jax_modeldir.load_model_dir(model_dir)
    g = jax_modeldir.mm_model_from_meta(meta, classes)
    patch, window = meta["patch_px"], meta.get("window_px")
    if window in (None, patch):
        xi = grid_from_wsi_visium(image, srd, patch_size=patch, h_st=dims[0], w_st=dims[1],
                                  dtype=np.uint8, hd_binning=hd).astype(np.float32) / 255.0
    else:
        xi = _jax_device_grid(image, srd, patch, window, dims)
    lattice = {} if hd is None else {"Visium": False, "h_st": dims[0], "w_st": dims[1]}
    xc, _ = JaxCountGridDataset([unified_cache_path(srd, hd)], **lattice)[0]
    if meta["count_f"] == "scbert":
        transform, _ = jax_modeldir.scbert_count_transform([srd], hd, meta["scbert_vocab"])
    else:
        transform = np.log1p
    logits = np.asarray(g.apply(variables, (jnp.asarray(xi[None]),
                                            jnp.asarray(transform(xc)[None])),
                                train=False))[0]
    return np.where(xc.sum(-1) > 0, logits.argmax(-1) + 1, 0), logits


@pytest.mark.parametrize("count_f", ["scbert", "mlp"])
def test_register_hex_mm_matches_jax(count_f, hex_cohort, hex_dirs, tmp_path):
    _, dirs, images = hex_cohort
    stages = main(["register", "--model", hex_dirs[count_f], "--images", *images,
                   "--spaceranger", *dirs, "--out", str(tmp_path / "port"), "--device",
                   "cpu"])
    assert set(stages) == {"decode", "count read", "crop + grid", "count transform",
                           "forward", "csv"}
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == ["00_outs_loupe.csv", "01_outs_loupe.csv"]
    for name, srd, image in zip(names, dirs, images):
        want, logits = _jax_reference(hex_dirs[count_f], srd, image)
        got, rows = _csv_grid(tmp_path / "port" / name, srd)
        label_parity_report(want, got, logits)
        assert len(rows) - 1 == (want > 0).sum()


@pytest.mark.parametrize("dense_ingest", [False, True])
def test_register_square_mm_matches_jax(dense_ingest, hd_cohort, hd_mm_dirs, tmp_path):
    _, dirs, images = hd_cohort
    main(["register", "--model", hd_mm_dirs[dense_ingest], "--images", *images,
          "--spaceranger", *dirs, "--out", str(tmp_path / "port"), "--device", "cpu"])
    for srd, image in zip(dirs, images):
        want, logits = _jax_reference(hd_mm_dirs[dense_ingest], srd, image, BINNING, HD_GRID)
        got, _ = _csv_grid(tmp_path / "port" / f"{Path(srd).name}_loupe.csv", srd,
                           BINNING, HD_GRID)
        label_parity_report(want, got, logits)
        assert (got > 0).sum() > 0


def _tree(root):
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in Path(root).rglob("*")}


@pytest.mark.parametrize("count_f", ["scbert", "mlp"])
def test_jax_register_command_jpeg_gap(count_f, hex_cohort, hex_dirs, tmp_path):
    """JAX's ``register`` crops through a JPEG patch cache it writes into the
    Spaceranger directories (and resizes windows with PIL); the port crops
    the slide losslessly and writes nothing there. The same rows and
    foreground; the gap is printed (``ROADMAP.md`` Queue 3)."""
    root, dirs, images = hex_cohort
    copies = []
    for i, srd in enumerate(dirs):
        copies.append(str(tmp_path / f"a{i}" / "outs"))
        shutil.copytree(srd, copies[-1])
    args = ["register", "--model", hex_dirs[count_f], "--images", *images,
            "--spaceranger", *copies]
    before = _tree(tmp_path)
    main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert {k: v for k, v in _tree(tmp_path).items() if not k.startswith("port")} == before
    jax_main(args + ["--out", str(tmp_path / "jax")])
    meta = json.loads(Path(hex_dirs[count_f], "model.json").read_text())
    jpeg = jax_create_visium_dataset(copies, use_count=False, use_image=True,
                                     fullres_image_files=images, patch_size_px=PATCH,
                                     window_size_px=meta["window_px"],
                                     minimum_detection_rate=None)
    lossless = SlideGridDataset(images, copies, patch_size=PATCH,
                                window_size=meta["window_px"], device="cpu")
    gaps, flips = [], 0
    for i, name in enumerate(["00_outs_loupe.csv", "01_outs_loupe.csv"]):
        want, want_rows = _csv_grid(tmp_path / "jax" / name, copies[i])
        got, got_rows = _csv_grid(tmp_path / "port" / name, copies[i])
        assert got_rows == want_rows
        np.testing.assert_array_equal(got > 0, want > 0)
        flips += int((got != want).sum())
        a, b = jpeg[i][0], lossless[i][0].numpy()
        gaps.append(np.abs(a - b)[want > 0] * 255)
    gap = np.concatenate([g.ravel() for g in gaps])
    print(f"JPEG gap ({count_f}, window_px {meta['window_px']}): patches max "
          f"{gap.max():.1f}, mean {gap.mean():.3f} (0-255); labels differ at {flips} of "
          f"{sum(len(g) for g in gaps)} spots")
    assert gap.max() > 0 and np.isfinite(gap).all()


def test_register_square_count_matches_jax_bytes(hd_cohort, tmp_path):
    root, dirs, _ = hd_cohort
    genes = read_unified_genes(unified_cache_path(dirs[0], BINNING))
    g = JaxGridNet(patch_classifier=JaxCountMLP(n_classes=N_CLASSES), n_classes=N_CLASSES)
    meta = {"n_genes": len(genes), "genes": genes, "log1p": True, "hd_binning": BINNING,
            "grid_dims": list(HD_GRID), "model": "GridNet+CountMLP"}
    model = _write_model_dir(tmp_path / "model", g, jnp.zeros((1, 4, 4, len(genes))), meta)
    args = ["register", "--model", model, "--spaceranger", *dirs]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["hd0_loupe.csv", "hd1_loupe.csv"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _exit_code(fn, args):
    with pytest.raises(SystemExit) as e:
        fn(args)
    return e.value.code


def _port_command(message):
    """A JAX command's message as the port words it: its advice names the
    port's own ``prepare``."""
    return message.replace("python -m gridnext_tpu prepare",
                           "python -m gridnext_tpu_torch prepare")


def test_register_mm_errors_match_jax(hex_cohort, hex_dirs, tmp_path):
    """A missing image, a missing cache, a cache of other genes and a cohort
    without a gene2vec gene exit as the JAX command exits, before any grid
    is built (no CSV)."""
    _, dirs, images = hex_cohort
    bare = tmp_path / "bare" / "outs"
    shutil.copytree(dirs[0], bare)
    Path(unified_cache_path(str(bare))).unlink()
    other = tmp_path / "model_other_genes"
    shutil.copytree(hex_dirs["mlp"], other)
    meta = json.loads((other / "model.json").read_text())
    (other / "model.json").write_text(json.dumps({**meta, "genes": meta["genes"][::-1]}))
    novocab = tmp_path / "model_novocab"
    shutil.copytree(hex_dirs["scbert"], novocab)
    meta = json.loads((novocab / "model.json").read_text())
    (novocab / "model.json").write_text(json.dumps({**meta, "scbert_vocab": 1}))
    out = ["--out", str(tmp_path / "x.csv")]
    cases = [["--model", hex_dirs["mlp"], "--spaceranger", *dirs, "--images", images[0]],
             ["--model", hex_dirs["mlp"], "--spaceranger", str(bare), "--images", images[0]],
             ["--model", str(other), "--spaceranger", dirs[0], "--images", images[0]],
             ["--model", str(novocab), "--spaceranger", dirs[0], "--images", images[0]]]
    for case in cases:
        want = _exit_code(jax_main, ["register", *case, *out])
        assert isinstance(want, str) and want.startswith("error:")
        assert _exit_code(main, ["register", *case, *out, "--device", "cpu"]) == \
            _port_command(want)
        assert not (tmp_path / "x.csv").exists()
