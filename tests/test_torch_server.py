"""The port's resident registration server (``gridnext_tpu_torch/server.py``)
against the JAX package's, on the CPU.

The three ways to build a service (``from_registrar``, ``from_model_dir``
for count and multimodal directories, ``from_artifact``), the HTTP
protocol (healthz, metrics, register, the error codes), and the
micro-batcher (grouping, the square-lattice dense route, a malformed
submission, pre-fitted plans): the mirror of ``tests/test_server.py``.
Weights are drawn from a numpy seed in the JAX layout and reach both
packages through the weight bridge. Responses are held against the JAX
service's on the same request: labels up to near-ties of the port's
logits, ``n_foreground`` and the Loupe text equal.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu import serving as jax_serving
from gridnext_tpu.data import datasets as jax_datasets
from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.io import prepare_count_files
from gridnext_tpu.io.unify import read_unified_genes, unified_cache_path
from gridnext_tpu.models import GridNetHex as JaxGridNetHex
from gridnext_tpu.models import TpuPatchClassifier as JaxTpuF
from gridnext_tpu.server import RegistrationService as JaxService
from gridnext_tpu_torch import geometry as G
from gridnext_tpu_torch import modeldir
from gridnext_tpu_torch.compat.from_jax import save_model_dir
from gridnext_tpu_torch.io import read_positions
from gridnext_tpu_torch.models import CountMLP, GridNetHex, GridNetHexMM, TpuPatchClassifier
from gridnext_tpu_torch.server import (_UNFITTED, RegistrationService, _mm_grids,
                                       _MicroBatcher, load_artifact, make_server)
from gridnext_tpu_torch.serving import SlideRegistrar, label_parity_report
from tests.test_torch_export import numpy_variables

N_CLASSES, PATCH = 3, 8
CLASSES = ["L1", "L2", "L3"]
F_KW = dict(stages=((16, 1),), stem_patch=4)
TPU_F = {"stages": [[16, 1]], "stem_patch": 4, "norm": "rms"}
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_server")
    s = simulate_spaceranger_dir(root / "arr", seed=0, n_genes=10, n_classes=N_CLASSES,
                                 image=True, spot_spacing_px=16)
    s["srd"], s["image"] = str(s["spaceranger_dir"]), str(s["image_file"])
    prepare_count_files([s["srd"]], verbose=False)
    return s


@pytest.fixture(scope="module")
def registrars():
    """The port's registrar and the JAX package's (its XLA crop and
    corrector) of one GridNetHex(TpuPatchClassifier)."""
    g = GridNetHex(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW), n_classes=N_CLASSES,
                   f_dim=N_CLASSES)
    variables = numpy_variables(g, seed=11)
    jg = JaxGridNetHex(patch_classifier=JaxTpuF(n_classes=N_CLASSES, **F_KW),
                       n_classes=N_CLASSES)
    jreg = jax_serving.SlideRegistrar.from_gridnet(
        jg, variables, patch_size=PATCH, normalize=None, patch_chunk=None,
        extractor="xla", corrector_apply=lambda grid: jg.apply(
            variables, grid, train=False,
            method=lambda m, x, train: m.corrector(x, train=train)))
    reg = SlideRegistrar.from_gridnet(g, patch_size=PATCH, normalize=None,
                                      patch_chunk=None, device="cpu")
    return jreg, reg


@contextlib.contextmanager
def _serve(service):
    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_response(got, want, logits):
    """A port response against the JAX service's: labels up to near-ties
    of ``logits``, the rest equal."""
    label_parity_report(np.asarray(want["labels"]), np.asarray(got["labels"]), logits)
    for key in ("shape", "classes", "hex_coords", "n_foreground", "loupe_csv"):
        assert got.get(key) == want.get(key), key


def test_http_image_service_end_to_end(sim, registrars, tmp_path):
    jreg, reg = registrars
    service = RegistrationService.from_registrar(reg, CLASSES, model="GridNetHex+TinyTpuF")
    jservice = JaxService.from_registrar(jreg, CLASSES, model="GridNetHex+TinyTpuF")
    wsi = np.asarray(Image.open(sim["image"]))
    pos = read_positions(sim["srd"])
    logits, _ = reg.register_logits(wsi, pos)
    body = {"image": sim["image"], "spaceranger": sim["srd"], "loupe": True}
    want = jservice.handle_register(body)

    with _serve(service) as base:
        code, health = _get(base + "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["classes"] == CLASSES and health["needs_image"] is True
        assert health["backend"] == "cpu" and health["device_name"] == "cpu"

        out_csv = tmp_path / "srv_loupe.csv"
        code, resp = _post(base + "/register", {**body, "out": str(out_csv)})
        assert code == 200, resp
        _same_response(resp, want, logits)
        label_parity_report(reg(wsi, pos), np.asarray(resp["labels"]), logits)
        assert resp["shape"] == [G.VISIUM_H_ST, G.VISIUM_W_ST]
        assert out_csv.read_text() == resp["loupe_csv"]

        # bad requests are 400, an unknown route 404
        code, resp = _post(base + "/register", {"image": sim["image"]})
        assert code == 400 and "spaceranger" in resp["error"]
        code, resp = _post(base + "/register", {"spaceranger": sim["srd"]})
        assert code == 400 and "image" in resp["error"]
        code, resp = _post(base + "/register", {"image": "/nonexistent.jpg",
                                                "spaceranger": sim["srd"]})
        assert code == 400
        code, resp = _post(base + "/register", {"spaceranger": 123})
        assert code == 400 and "string" in resp["error"]
        code, resp = _post(base + "/register", {"image": ["x"], "spaceranger": sim["srd"]})
        assert code == 400 and "string" in resp["error"]
        code, _ = _get(base + "/bogus")
        assert code == 404

        code, metrics = _get(base + "/metrics")
        assert code == 200
        assert metrics["requests"] >= 1 and metrics["errors"] >= 3
        assert metrics["stage_seconds"].get("register", 0) > 0
        service.reset_metrics()                      # what --warmup does
        code, metrics = _get(base + "/metrics")
        assert metrics["requests"] == 0 and metrics["errors"] == 0
        assert metrics["stage_seconds"] == {} and metrics["dispatches"] == 0


def test_count_model_dir_service(sim, tmp_path):
    srd = sim["srd"]
    genes = read_unified_genes(unified_cache_path(srd))
    meta = {"classes": ["A", "B", "C"], "n_genes": len(genes), "genes": genes,
            "log1p": True, "hd_binning": None, "grid_dims": None,
            "model": "GridNetHex+CountMLP"}
    d = str(tmp_path / "count_model")
    save_model_dir(d, meta, numpy_variables(
        GridNetHex(CountMLP(len(genes), N_CLASSES), n_classes=N_CLASSES, f_dim=N_CLASSES),
        seed=12))
    service = RegistrationService.from_model_dir(d, device="cpu")
    assert service.needs_image is False
    got = service.handle_register({"spaceranger": srd, "loupe": True})
    want = JaxService.from_model_dir(d).handle_register({"spaceranger": srd, "loupe": True})
    assert got == want and got["loupe_csv"].startswith("Barcode,AARs")

    # the gene-axis guard: a model trained on other genes refuses the cache
    save_model_dir(d, {**meta, "n_genes": 2, "genes": ["g1", "g2"]},
                   numpy_variables(GridNetHex(CountMLP(2, N_CLASSES), n_classes=N_CLASSES,
                                              f_dim=N_CLASSES)))
    with pytest.raises(ValueError, match="gene set"):
        RegistrationService.from_model_dir(d, device="cpu").handle_register(
            {"spaceranger": srd})


def test_mm_model_dir_service(sim, tmp_path, monkeypatch):
    """A multimodal directory against the JAX service on the same pixels
    (JAX's patch cache written and read losslessly: PNG bytes under its
    .jpg names; ROADMAP Queue 3 item 4 for its JPEGs)."""
    srd = sim["srd"]
    genes = read_unified_genes(unified_cache_path(srd))
    meta = {"classes": ["A", "B", "C"], "patch_px": PATCH, "window_px": None,
            "patch_chunk": None, "count_chunk": None, "n_genes": len(genes), "genes": genes,
            "log1p": True, "count_f": "mlp", "image_f": "tpu", "tpu_f": TPU_F,
            "hd_binning": None, "grid_dims": None, "dense_ingest": False,
            "model": "GridNetHexMM"}
    d = str(tmp_path / "mm_model")
    variables = numpy_variables(GridNetHexMM(TpuPatchClassifier(n_classes=N_CLASSES, **F_KW),
                                             CountMLP(len(genes), N_CLASSES),
                                             n_classes=N_CLASSES), seed=13)
    save_model_dir(d, meta, variables)
    service = RegistrationService.from_model_dir(d, device="cpu")
    assert service.needs_image is True
    body = {"spaceranger": srd, "image": sim["image"], "loupe": True}
    got = service.handle_register(body)

    g = modeldir.mm_model_from_meta(meta, meta["classes"], variables, device="cpu")
    xi, xc = _mm_grids(sim["image"], srd, meta, None, None, PATCH, CPU)
    with torch.no_grad():
        logits = g((xi[None], torch.from_numpy(np.log1p(xc))[None]))[0].numpy()
    label_parity_report(np.where(xc.sum(-1) > 0, logits.argmax(-1) + 1, 0),
                        np.asarray(got["labels"]), logits)

    save = Image.Image.save
    monkeypatch.setattr(Image.Image, "save", lambda im, fp, format=None, **kw: save(
        im, fp, "PNG" if format == "JPEG" else format, **kw))
    monkeypatch.setattr(jax_datasets, "_decode_patch_batch", lambda paths: None)
    want = JaxService.from_model_dir(d).handle_register(body)
    _same_response(got, want, logits)


def test_artifact_service_matches_live(sim, registrars, tmp_path):
    _, reg = registrars
    wsi = np.asarray(Image.open(sim["image"]))
    pos = read_positions(sim["srd"])
    live = reg(wsi, pos)
    logits, _ = reg.register_logits(wsi, pos)
    n_spots = 2048
    art = tmp_path / "reg.pt2"
    art.write_bytes(reg.export(wsi.shape, n_spots=n_spots))
    (tmp_path / "reg.pt2.json").write_text(json.dumps(
        {"classes": CLASSES, "h_st": G.VISIUM_H_ST, "w_st": G.VISIUM_W_ST,
         "wsi_shape": list(wsi.shape), "window_px": reg.window_size, "n_spots": n_spots,
         "hex_coords": True, "model": "GridNetHex+TinyTpuF", "format": "torch.export",
         "device": "cpu"}))
    service = RegistrationService.from_artifact(str(art), device="cpu")
    assert service.info()["kind"] == "spots"
    small = tmp_path / "small.jpg"
    Image.fromarray(wsi[:64, :64]).save(small)
    with _serve(service) as base:
        code, resp = _post(base + "/register", {"image": sim["image"],
                                                "spaceranger": sim["srd"]})
        assert code == 200, resp
        label_parity_report(live, np.asarray(resp["labels"]), logits)
        # a slide of another shape: 400 with the static-shape message
        code, resp = _post(base + "/register", {"image": str(small),
                                                "spaceranger": sim["srd"]})
    assert code == 400 and "exported for" in resp["error"]


def test_load_artifact_validation(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        load_artifact(str(tmp_path / "missing.blob"), "cpu")
    blob = tmp_path / "orphan.blob"
    blob.write_bytes(b"xx")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        load_artifact(str(blob), "cpu")
    # a grid (count/MM) sidecar has no n_spots: the server refuses it
    (tmp_path / "orphan.blob.json").write_text(json.dumps(
        {"classes": ["a"], "grid_shapes": [[78, 64, 10]]}))
    with pytest.raises(ValueError, match="n_spots"):
        load_artifact(str(blob), "cpu")
    side = {"classes": ["a"], "h_st": 78, "w_st": 64, "wsi_shape": [64, 64, 3],
            "window_px": 8, "n_spots": 128}
    (tmp_path / "orphan.blob.json").write_text(json.dumps(side))
    with pytest.raises(ValueError, match="JAX StableHLO"):        # JAX's sidecar
        load_artifact(str(blob), "cpu")
    (tmp_path / "orphan.blob.json").write_text(json.dumps(
        {**side, "format": "torch.export", "device": "cpu"}))
    with pytest.raises(ValueError, match="not a torch.export artifact"):
        load_artifact(str(blob), "cpu")


class _FakeRegistrar:
    """The registrar surface the micro-batcher drives, recording its calls;
    a slide's labels are its positions value everywhere."""

    hex_coords = True
    device = CPU

    def __init__(self, calls=None):
        self.calls = [] if calls is None else calls

    def __call__(self, wsi, pos):
        self.calls.append(("single", pos))
        return np.full((2, 2), pos)

    def register_batch(self, wsis, poss):
        if any(p < 0 for p in poss):
            raise RuntimeError("boom")
        self.calls.append(("batch", tuple(poss)))
        return np.stack([np.full((2, 2), p) for p in poss])


def _wait_for(cond, what):
    deadline = time.time() + 60
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def test_micro_batcher_groups_concurrent_requests():
    """Requests that queue while a dispatch runs register in one
    ``register_batch``; results reach the right waiters; a dispatch error
    reaches every member of its group and the dispatcher lives on."""
    gate, entered = threading.Event(), threading.Event()

    class Held(_FakeRegistrar):
        def __call__(self, wsi, pos):
            entered.set()
            gate.wait()               # hold the dispatcher while others queue
            return super().__call__(wsi, pos)

    reg = Held()
    b = _MicroBatcher(reg, max_batch=8)
    results, errors = {}, {}

    def worker(i):
        try:
            results[i] = b.submit(np.zeros((4, 4, 3), np.uint8), i)
        except Exception as e:
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    threads[0].start()
    _wait_for(entered.is_set, "the dispatcher to take request 0")
    for t in threads[1:]:
        t.start()
    _wait_for(lambda: b._q.qsize() == 4, "4 requests to queue")
    gate.set()
    for t in threads:
        t.join(timeout=30)
    assert reg.calls[0] == ("single", 0) and reg.calls[1][0] == "batch"
    assert sorted(reg.calls[1][1]) == [1, 2, 3, 4] and b.batched_slides == 4
    for i in range(5):
        np.testing.assert_array_equal(results[i], np.full((2, 2), i))

    gate.clear()
    entered.clear()
    first = threading.Thread(target=worker, args=(10,))
    first.start()
    _wait_for(entered.is_set, "the dispatcher to take request 10")
    failing = [threading.Thread(target=worker, args=(i,)) for i in (-1, -2)]
    for t in failing:
        t.start()
    _wait_for(lambda: b._q.qsize() == 2, "the failing pair to queue")
    gate.set()
    for t in [first] + failing:
        t.join(timeout=30)
    assert isinstance(errors[-1], RuntimeError) and isinstance(errors[-2], RuntimeError)
    np.testing.assert_array_equal(results[10], np.full((2, 2), 10))
    assert b.submit(np.zeros((4, 4, 3), np.uint8), 7)[0, 0] == 7


class _FakeHDRegistrar(_FakeRegistrar):
    hex_coords = False

    def dense_plan(self, wsi, pos):
        return ("exact",) if pos % 2 == 0 else None     # evens have a dense plan

    def register_dense(self, wsi, pos, plan=None):
        self.calls.append(("dense", pos, plan))
        return np.full((2, 2), pos)


def test_micro_batcher_routes_square_hd_dense():
    """Square-lattice groups: slides with a dense plan register one by one
    through ``register_dense``; the rest batch."""
    reg = _FakeHDRegistrar()
    b = _MicroBatcher(reg, max_batch=8)
    waits = []
    for p in (0, 1, 2, 3):
        done, slot = threading.Event(), {}
        b._q.put((np.zeros((4, 4, 3), np.uint8), p, _UNFITTED, done, slot))
        waits.append((p, done, slot))
    for p, done, slot in waits:
        assert done.wait(60) and "error" not in slot
        np.testing.assert_array_equal(slot["labels"], np.full((2, 2), p))
    assert {c[1] for c in reg.calls if c[0] == "dense"} == {0, 2}
    rest = [v for c in reg.calls if c[0] != "dense"
            for v in (c[1] if isinstance(c[1], tuple) else (c[1],))]
    assert sorted(rest) == [1, 3]


def test_micro_batcher_survives_malformed_submission():
    b = _MicroBatcher(_FakeRegistrar(), max_batch=4)
    with pytest.raises(AttributeError):
        b.submit(object(), 3)          # no .shape: the grouping raises
    assert b._thread.is_alive()
    np.testing.assert_array_equal(b.submit(np.zeros((4, 4, 3), np.uint8), 7),
                                  np.full((2, 2), 7))


def test_micro_batcher_uses_prefitted_dense_plan():
    class NoRefit(_FakeHDRegistrar):
        def dense_plan(self, wsi, pos):
            raise AssertionError("the dispatcher must not refit a passed plan")

    reg = NoRefit()
    b = _MicroBatcher(reg, max_batch=4)
    out = b.submit(np.zeros((4, 4, 3), np.uint8), 5, plan=("exact", "prefit"))
    np.testing.assert_array_equal(out, np.full((2, 2), 5))
    assert reg.calls == [("dense", 5, ("exact", "prefit"))]
    # plan None: fitted, not a dense lattice -> the per-bin route
    np.testing.assert_array_equal(b.submit(np.zeros((4, 4, 3), np.uint8), 6, plan=None),
                                  np.full((2, 2), 6))
    assert reg.calls[-1] == ("single", 6)


def test_server_module_is_under_the_isolation_scan():
    """server.py is among the modules whose imports the isolation test
    holds to no JAX, no JAX package and nothing the card lacks."""
    from pathlib import Path

    import gridnext_tpu_torch.server as server
    from tests.test_torch_isolation import _modules

    assert "gridnext_tpu_torch.server" in set(_modules())
    assert Path(server.__file__).name == "server.py"
