"""The port's exported artifacts (``torch.export`` of the registration, the
serving kernels as ``gridnext::`` custom ops) against the JAX package's
``jax.export`` artifacts, on the CPU.

Small models take one variables tree drawn from a numpy seed in the JAX
package's layout, which the weight bridge (``compat/from_jax.py``) loads
into the port's modules and the JAX modules apply as it is. For each artifact
kind the port's reloaded artifact gives the port's live labels, and JAX's
artifact's labels, up to near-ties of the port's live logits
(``label_parity_report``; the two packages' logits agree within 1e-4,
``tests/test_torch_serving.py``): the per-spot image artifact
(``SlideRegistrar.export``), the dense HD artifact (``export_dense``), the
count ``CountMLP`` and the multimodal grid forwards
(``export_grid_forward``, the latter with a tiny scBERT and an explicit
tissue mask). Also: the exported graph holds the custom ops and one
``map`` over f's chunks; the refusals; the ``export`` and
``serve-artifact`` commands, whose CSVs equal the JAX ``register``
command's; each package's loader refuses the other's artifact; ``serve
--mesh`` exits on an artifact (as JAX's does) and on a ``seq`` axis, and
serves an image directory over the mesh's shards.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import geometry as G
from gridnext_tpu import modeldir as jax_modeldir
from gridnext_tpu import serving as jax_serving
from gridnext_tpu.cli import main as jax_main
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io import read_positions as jax_read_positions
from gridnext_tpu.io.unify import read_unified_genes, unified_cache_path
from gridnext_tpu.models import CountMLP as JaxCountMLP
from gridnext_tpu.models import GridNet as JaxGridNet
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.server import load_artifact as jax_load_artifact
from gridnext_tpu_torch import cli, modeldir, serving
from gridnext_tpu_torch.compat.from_jax import (jax_variables, load_variables,
                                                save_model_dir)
from gridnext_tpu_torch.io import read_positions
from gridnext_tpu_torch.models import (CountMLP, GridNet, GridNetHex, GridNetHexMM,
                                       TpuPatchClassifier, scBERT)
from gridnext_tpu_torch.server import load_artifact
from gridnext_tpu_torch.serving import label_parity_report, load_exported_registration

N_CLASSES, PATCH = 3, 8
CLASSES = ["A", "B", "C"]
F_KW = dict(stages=((16, 1),), stem_patch=4)
TPU_F = {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"}


def numpy_variables(model, seed=1):
    """A variables tree in the JAX package's layout for the port's
    ``model`` (the bridge's ``jax_variables`` shapes), drawn from a numpy
    seed: He-scaled kernels, scales and variances near 1, small biases and
    means, orthogonal Gaussian FAVOR projections; loaded into ``model``."""
    from gridnext_tpu_torch.ops.favor import orthogonal_gaussian_matrix

    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key == "projection":
                gen = torch.Generator().manual_seed(int(rng.integers(2 ** 31)))
                out[key] = orthogonal_gaussian_matrix(*val.shape, generator=gen).numpy()
            elif key in ("kernel", "embedding"):
                fan_in = int(np.prod(val.shape[:-1])) if key == "kernel" else 1
                out[key] = (rng.normal(size=val.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            else:   # bias, mean
                out[key] = (rng.normal(size=val.shape) * 0.1).astype(np.float32)
        return out

    variables = fill(jax_variables(model))
    load_variables(model, variables)
    return variables


def _ops_in(blob) -> set:
    """The ``gridnext::`` ops and the ``map`` calls of an artifact's graph
    and its subgraphs (a map's body)."""
    ep = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for m in ep.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if "gridnext" in str(n.target) or "map" in str(n.target).lower()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    thread pools contend, and this file's exports ran 3x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_export")
    s = simulate_spaceranger_dir(root / "arr", seed=0, n_genes=10, n_classes=N_CLASSES,
                                 image=True, spot_spacing_px=16)
    s["wsi"] = np.asarray(Image.open(s["image_file"]))
    return s


@pytest.fixture(scope="module")
def hex_pair():
    """A GridNetHex(TpuPatchClassifier) in both packages, one set of weights."""
    jg = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                       n_classes=N_CLASSES)
    g = GridNetHex(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW), n_classes=N_CLASSES,
                   f_dim=N_CLASSES)
    variables = numpy_variables(g)
    jreg = jax_serving.SlideRegistrar.from_gridnet(
        jg, variables, patch_size=PATCH, normalize=None, patch_chunk=None,
        extractor="xla", corrector_apply=lambda grid: jg.apply(
            variables, grid, train=False,
            method=lambda m, x, train: m.corrector(x, train=train)))
    reg = serving.SlideRegistrar.from_gridnet(g, patch_size=PATCH, normalize=None,
                                              patch_chunk=100, device="cpu")
    return jreg, reg


def test_export_round_trip_matches_live_and_jax(sim, hex_pair):
    jreg, reg = hex_pair
    wsi, n_spots = sim["wsi"], 2048
    pos = read_positions(sim["spaceranger_dir"])
    live = reg(wsi, pos)
    logits, _ = reg.register_logits(wsi, pos)

    blob = reg.export(wsi.shape, n_spots=n_spots)
    assert _ops_in(blob) >= {"gridnext.gather_patches.default",
                             "gridnext.fused_hex_corrector_labels.default"}
    assert "map_impl" in _ops_in(blob)      # f's 21 chunks: one map
    fn = load_exported_registration(blob)
    ins = reg.spot_inputs(wsi.shape, pos, n_spots)
    assert all(a.dtype == np.int32 and a.shape == (n_spots,) for a in ins)
    got = fn(torch.from_numpy(wsi), *map(torch.from_numpy, ins)).numpy()
    assert got.shape == (G.VISIUM_H_ST, G.VISIUM_W_ST) and got.dtype == np.int32
    label_parity_report(live, got, logits)
    np.testing.assert_array_equal(got > 0, sim["label_grid"] > 0)

    # JAX's artifact of the same weights on the same inputs
    jpos = jax_read_positions(sim["spaceranger_dir"])
    jfn = jax_serving.load_exported_registration(jreg.export(wsi.shape, n_spots=n_spots))
    jins = jreg.spot_inputs(wsi.shape, jpos, n_spots)
    for a, b in zip(ins, jins):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jfn(jnp.asarray(wsi), *map(jnp.asarray, jins)))
    label_parity_report(want, got, logits)


def test_export_refusals(sim, hex_pair):
    _, reg = hex_pair
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        reg.export((64, 64), n_spots=128)
    pos = read_positions(sim["spaceranger_dir"])
    with pytest.raises(ValueError, match="exceed n_spots"):
        reg.spot_inputs(sim["wsi"].shape, pos, n_spots=4)
    # an artifact runs on the device type it is traced on
    with pytest.raises(ValueError, match="cannot export for platforms"):
        reg.export(sim["wsi"].shape, n_spots=128, platforms=["cuda"])
    serving.check_export_platforms("cpu", ["cpu", "CPU"])
    serving.check_export_platforms("cuda", ["gpu", "cuda"])
    with pytest.raises(ValueError, match="square-lattice"):
        reg.export_dense((64, 64, 3), 4, 4)


def test_export_dense_round_trip_matches_live_and_jax(tmp_path):
    binning, hd_grid = "square_016um", (20, 16)
    s = simulate_spaceranger_dir(tmp_path / "hd0", seed=3, n_genes=8, n_classes=N_CLASSES,
                                 spaceranger_version="hd", hd_grid=hd_grid,
                                 hd_binning=binning, image=True, spot_spacing_px=12)
    jg = JaxGridNet(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                    n_classes=N_CLASSES)
    g = GridNet(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW), n_classes=N_CLASSES,
                f_dim=N_CLASSES)
    variables = numpy_variables(g, seed=2)
    lattice = dict(h_st=hd_grid[0], w_st=hd_grid[1])
    reg = serving.SlideRegistrar.from_gridnet(g, patch_size=PATCH, window_size=12,
                                              normalize=None, patch_chunk=100,
                                              device="cpu", **lattice)
    jreg = jax_serving.SlideRegistrar.from_gridnet(jg, variables, patch_size=PATCH,
                                                   window_size=12, normalize=None,
                                                   patch_chunk=None, **lattice)
    wsi = np.asarray(Image.open(s["image_file"]))
    pos = read_positions(s["spaceranger_dir"], hd_binning=binning)
    plan = reg.dense_plan(wsi, pos)
    assert plan is not None and plan[0] == "exact"
    _, oy0, ox0, fg, ey, ex = plan
    live = reg.register_dense(wsi, pos, plan=plan)
    logits, _ = reg.register_logits(wsi, pos)

    blob = reg.export_dense(wsi.shape, ey, ex)
    assert "gridnext.gather_patches.default" in _ops_in(blob)
    fn = load_exported_registration(blob)
    got = fn(torch.from_numpy(wsi), torch.tensor(oy0, dtype=torch.int32),
             torch.tensor(ox0, dtype=torch.int32), torch.from_numpy(fg)).numpy()
    label_parity_report(live, got, logits)

    jfn = jax_serving.load_exported_registration(jreg.export_dense(wsi.shape, ey, ex))
    want = np.asarray(jfn(jnp.asarray(wsi), jnp.int32(oy0), jnp.int32(ox0),
                          jnp.asarray(fg)))
    label_parity_report(want, got, logits)


def test_export_grid_forward_count_matches_live_and_jax():
    h, w, ng = 12, 10, 6
    rng = np.random.default_rng(0)
    counts = rng.poisson(1.0, size=(1, h, w, ng)).astype(np.float32)
    counts[0, :4] = 0                                   # background rows
    jg = JaxGridNetHex(patch_classifier=JaxCountMLP(n_classes=N_CLASSES, hidden=(8, 8, 8, 8)),
                       n_classes=N_CLASSES)
    g = GridNetHex(CountMLP(ng, N_CLASSES, hidden=(8, 8, 8, 8)), n_classes=N_CLASSES,
                   f_dim=N_CLASSES).eval()
    variables = numpy_variables(g, seed=3)

    blob = serving.export_grid_forward(g, (h, w, ng))
    got = load_exported_registration(blob)(torch.from_numpy(counts)).numpy()
    with torch.no_grad():
        logits = g(torch.from_numpy(counts)).numpy()
    live = np.where(counts.any(-1), logits.argmax(-1) + 1, 0)
    label_parity_report(live[0], got[0], logits[0])
    assert (got[0, :4] == 0).all() and (got[0, 4:] > 0).any()

    want = np.asarray(jax_serving.load_exported_registration(
        jax_serving.export_grid_forward(jg, variables, (h, w, ng)))(jnp.asarray(counts)))
    label_parity_report(want[0], got[0], logits[0])


def test_export_grid_forward_scbert_mm_explicit_fg():
    """A GridNetHexMM with a tiny scBERT count f and a TpuPatchClassifier
    image f; the tissue mask is an input (it wins over zero and nonzero
    count rows)."""
    h, w, vocab = 6, 5, 16
    meta = {"patch_px": PATCH, "patch_chunk": 16, "count_chunk": 1, "count_f": "scbert",
            "scbert_vocab": vocab, "scbert_dim": 16, "scbert_depth": 1, "scbert_heads": 2,
            "scbert_dim_head": 8, "scbert_features": 8, "image_f": "tpu", "tpu_f": TPU_F,
            "model": "GridNetHexMM"}
    jg = jax_modeldir.mm_model_from_meta(meta, CLASSES)
    g = GridNetHexMM(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                     scBERT(n_genes=vocab, dim=16, depth=1, heads=2, dim_head=8,
                            nb_features=8, n_classes=N_CLASSES, generalized_attention=True),
                     n_classes=N_CLASSES, patch_chunk=16, count_chunk=1).eval()
    variables = numpy_variables(g, seed=4)
    rng = np.random.default_rng(3)
    imgs = rng.uniform(size=(1, h, w, PATCH, PATCH, 3)).astype(np.float32)
    counts = np.log2(1 + rng.poisson(2.0, size=(1, h, w, vocab))).astype(np.float32)
    counts[0, 0] = 0                    # a transformed-support hole...
    fg = np.ones((1, h, w), np.int32)   # ...that the raw counts call tissue
    fg[0, -1] = 0                       # and nonzero rows that are not

    shapes = ((h, w, PATCH, PATCH, 3), (h, w, vocab))
    blob = serving.export_grid_forward(g, shapes, explicit_fg=True)
    # the 30 count chunks as one map, the 2 image chunks unrolled
    # (FastAttention reaches FAVOR's op on the card only; the CPU runs its
    # plain products in the map's body)
    assert "map_impl" in _ops_in(blob)
    ins = [torch.from_numpy(a) for a in (imgs, counts, fg)]
    got = load_exported_registration(blob)(*ins).numpy()
    assert (got[0, 0] > 0).all() and (got[0, -1] == 0).all()
    with torch.no_grad():
        logits = g((ins[0], ins[1])).numpy()
    live = np.where(fg > 0, logits.argmax(-1) + 1, 0)
    label_parity_report(live[0], got[0], logits[0])

    jins = [jnp.asarray(a) for a in (imgs, counts, fg)]
    want = np.asarray(jax_serving.load_exported_registration(
        jax_serving.export_grid_forward(jg, variables, shapes, explicit_fg=True))(*jins))
    label_parity_report(want[0], got[0], logits[0])


# -- the commands ------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """A TpuPatchClassifier model directory, as ``train-image`` writes it."""
    d = str(tmp_path_factory.mktemp("image_model"))
    g = GridNetHex(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW), n_classes=N_CLASSES,
                   f_dim=N_CLASSES)
    save_model_dir(d, {"classes": CLASSES, "model": "GridNetHex+TpuPatchClassifier",
                       "patch_px": PATCH, "window_px": None, "patch_chunk": 256,
                       "tpu_f": TPU_F, "image_f": "tpu", "hd_binning": None,
                       "grid_dims": None}, numpy_variables(g, seed=5))
    return d


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_cohort")
    sims = [simulate_spaceranger_dir(root / f"a{i}", seed=10 + i, n_genes=10,
                                     n_classes=N_CLASSES, image=True, spot_spacing_px=16,
                                     tissue_fraction=frac)
            for i, frac in enumerate((0.5, 0.3))]
    return {"dirs": [s["spaceranger_dir"] for s in sims],
            "images": [s["image_file"] for s in sims],
            "shape": list(np.asarray(Image.open(sims[0]["image_file"])).shape[:2])}


def test_export_and_serve_artifact_commands_match_jax_register(image_dir, cohort, tmp_path):
    art = str(tmp_path / "reg.pt2")
    cli.main(["export", "--model", image_dir, "--out", art, "--device", "cpu",
              "--wsi-shape", *map(str, cohort["shape"]), "--n-spots", "2048"])
    side = json.loads(open(art + ".json").read())
    assert side["format"] == "torch.export" and side["device"] == "cpu"
    assert side["n_spots"] == 2048 and side["classes"] == CLASSES
    assert side["wsi_shape"] == cohort["shape"] + [3] and side["window_px"] == PATCH
    cli.main(["serve-artifact", "--artifact", art, "--spaceranger", *cohort["dirs"],
              "--images", *cohort["images"], "--out", str(tmp_path / "port"),
              "--device", "cpu"])
    jax_main(["register", "--model", image_dir, "--spaceranger", *cohort["dirs"],
              "--images", *cohort["images"], "--out", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        want = (tmp_path / "jax" / name).read_text()
        assert (tmp_path / "port" / name).read_text() == want
        assert len(want.splitlines()) > 20


def test_each_loader_refuses_the_other_packages_artifact(image_dir, cohort, tmp_path):
    shape = [*map(str, cohort["shape"])]
    jax_art, port_art = str(tmp_path / "jax.stablehlo"), str(tmp_path / "port.pt2")
    jax_main(["export", "--model", image_dir, "--out", jax_art, "--wsi-shape", *shape,
              "--n-spots", "2048"])
    cli.main(["export", "--model", image_dir, "--out", port_art, "--device", "cpu",
              "--wsi-shape", *shape, "--n-spots", "2048"])
    with pytest.raises(ValueError, match="JAX StableHLO"):
        load_artifact(jax_art, "cpu")
    with pytest.raises(SystemExit, match="JAX StableHLO"):
        cli.main(["serve-artifact", "--artifact", jax_art, "--spaceranger",
                  cohort["dirs"][0], "--images", cohort["images"][0], "--out",
                  str(tmp_path / "x.csv"), "--device", "cpu"])
    with pytest.raises(ValueError, match="not a jax.export"):
        jax_load_artifact(port_art)
    # an artifact of another device type
    side = json.loads(open(port_art + ".json").read())
    with open(port_art + ".json", "w") as fh:
        json.dump({**side, "device": "cuda"}, fh)
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        load_artifact(port_art, "cpu")


def test_export_count_and_mm_dirs_write_jax_sidecars(tmp_path):
    """The ``export`` command on a count and a multimodal directory: the
    sidecar's fields are JAX's command's, and the artifact gives the
    directory's live labels."""
    s = simulate_spaceranger_dir(tmp_path / "c0", seed=4, n_genes=12, n_classes=N_CLASSES,
                                 image=True, spot_spacing_px=16, tissue_fraction=0.4)
    srd = s["spaceranger_dir"]
    prepare_count_files([srd], verbose=False)
    genes = read_unified_genes(unified_cache_path(srd))
    d = tmp_path / "count"
    meta = {"classes": CLASSES, "n_genes": len(genes), "genes": genes, "log1p": True,
            "hd_binning": None, "grid_dims": None, "model": "GridNetHex+CountMLP"}
    save_model_dir(str(d), meta, numpy_variables(
        GridNetHex(CountMLP(len(genes), N_CLASSES), n_classes=N_CLASSES, f_dim=N_CLASSES),
        seed=6))
    for pkg, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
        main(["export", "--model", str(d), "--out", str(tmp_path / f"{pkg}.bin"), *extra])
    want = json.loads((tmp_path / "jax.bin.json").read_text())
    got = json.loads((tmp_path / "port.bin.json").read_text())
    assert {k: v for k, v in got.items() if k not in ("format", "device")} == want
    from gridnext_tpu_torch.compat.from_jax import load_model_dir
    from gridnext_tpu_torch.data import CountGridDataset

    x, _ = CountGridDataset([unified_cache_path(srd)])[0]
    fn = load_exported_registration((tmp_path / "port.bin").read_bytes())
    labels = fn(torch.from_numpy(np.log1p(x)[None]))[0].numpy()
    _, classes, variables = load_model_dir(str(d))
    g = modeldir.grid_model_from_meta(meta, classes, variables, device="cpu")
    with torch.no_grad():
        logits = g(torch.from_numpy(np.log1p(x)[None]))[0].numpy()
    label_parity_report(np.where(x.sum(-1) > 0, logits.argmax(-1) + 1, 0), labels, logits)

    # a multimodal directory (CountMLP count f): the sidecar's grid shapes
    d = tmp_path / "mm"
    save_model_dir(str(d), {**meta, "patch_px": PATCH, "patch_chunk": 64, "count_f": "mlp",
                            "image_f": "tpu", "tpu_f": TPU_F, "window_px": None,
                            "dense_ingest": False, "model": "GridNetHexMM"},
                   numpy_variables(GridNetHexMM(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                                                CountMLP(len(genes), N_CLASSES),
                                                n_classes=N_CLASSES), seed=7))
    for pkg, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
        main(["export", "--model", str(d), "--out", str(tmp_path / f"mm_{pkg}.bin"), *extra])
    want = json.loads((tmp_path / "mm_jax.bin.json").read_text())
    got = json.loads((tmp_path / "mm_port.bin.json").read_text())
    assert {k: v for k, v in got.items() if k not in ("format", "device")} == want
    assert got["grid_shapes"] == [[78, 64, PATCH, PATCH, 3], [78, 64, len(genes)]]


def test_serve_mesh_exits(image_dir, tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit, match="item 9"):
        cli.main(["serve", "--model", image_dir, "--mesh", "data=1,seq=2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="artifacts serialize the single-device path"):
        cli.main(["serve", "--artifact", str(tmp_path / "a.pt2"), "--mesh", "data=2",
                  "--device", "cpu"])

    class Httpd:                      # the served registrar, without listening
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    from gridnext_tpu_torch import server

    made = []
    monkeypatch.setattr(server, "make_server",
                        lambda service, *a, **k: made.append(service) or Httpd())
    cli.main(["serve", "--model", image_dir, "--mesh", "data=2", "--device", "cpu"])
    assert "serving over mesh {'data': 2}" in capsys.readouterr().out
    assert made[0].batcher.registrar.mesh.devices == [torch.device("cpu")] * 2
