"""Resident registration server: load once, register per HTTP request.

The port's copy of the JAX package's ``server.py``, the third serving shape
beside the ``register`` command (:func:`~gridnext_tpu_torch.serving.register_slides`)
and the exported artifacts (``export`` / ``serve-artifact``): the weights
are loaded once and stay on the card, and each request registers one
slide, so its latency is the card's work, not the model's construction.

Design:

* **Standard library only** (``http.server.ThreadingHTTPServer``).
* **Slides are referenced by path** (a shared volume): pixels never travel
  through the socket; responses carry the label grid and, on request, the
  Loupe CSV text.
* **Decode overlaps the card's work**: a request decodes its slide on its
  own handler thread, outside any lock, while the card registers earlier
  requests.
* **One thread owns the card for image models** (:class:`_MicroBatcher`):
  slides that queue while a dispatch runs register together in one
  ``register_batch``. The decoded slides stay numpy arrays until that
  thread copies them to the card, so no tensor crosses from one thread's
  stream to another's. Count, multimodal and artifact services register
  under a lock instead.

Protocol (JSON over HTTP)::

    GET  /healthz | /info   -> 200, service and model metadata
    GET  /metrics           -> 200, request counts and per-stage seconds
    POST /register          -> body {"spaceranger": DIR,
                                     "image": PATH,      # image and MM models
                                     "loupe": true,      # include the CSV text
                                     "out": PATH}        # write the CSV here
      response: {"labels": [[...]], "shape": [H, W], "classes": [...],
                 "n_foreground": N, "hex_coords": bool, "loupe_csv": "..."?,
                 "out": PATH?}   (labels: 0 = background, 1..C foreground)

Errors: 400 with ``{"error": msg}`` for bad requests (missing fields,
unknown paths, shape or gene-axis mismatches), 404 for unknown routes, 500
for unexpected failures.

Typical use::

    python -m gridnext_tpu_torch serve --model runs/img_model --port 8000 \\
        --warmup slide0.jpg spaceranger0/
    curl -s localhost:8000/register -d \\
        '{"image": "slide1.jpg", "spaceranger": "sr1/", "loupe": true}'

or in-process::

    service = RegistrationService.from_model_dir("runs/img_model")   # device="cuda"
    httpd = make_server(service, "127.0.0.1", 8000)
    httpd.serve_forever()
"""

from __future__ import annotations

import contextlib
import io as _io
import json
import os
import queue
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch.observability import StageTimer

__all__ = ["RegistrationService", "RegistrationHTTPServer", "make_server",
           "load_artifact"]

ARTIFACT_FORMAT = "torch.export"   # the sidecar's "format" of this package's artifacts


def load_artifact(path, device="cuda"):
    """Read and check an exported registration artifact and its sidecar.

    Returns ``(fn, sidecar dict)``, ``fn`` the loaded program
    (:func:`~gridnext_tpu_torch.serving.load_exported_registration`).
    Raises ``FileNotFoundError`` without the artifact or its ``.json``
    sidecar, and ``ValueError`` for a sidecar that misses a field, for an
    artifact of the JAX package (a StableHLO blob: the two packages'
    artifacts are not interchangeable), and for one exported for another
    device type than ``device``. The checks of ``serve-artifact`` and of
    the server.
    """
    from gridnext_tpu_torch.serving import load_exported_registration

    if not os.path.exists(path):
        raise FileNotFoundError(f"artifact {path} not found")
    sidecar_path = str(path) + ".json"
    if not os.path.exists(sidecar_path):
        raise FileNotFoundError(
            f"{sidecar_path} not found -- the JSON sidecar written by "
            "`export` must travel with the artifact (it carries the "
            "spot-input geometry and class names)")
    try:
        with open(sidecar_path) as fh:
            side = json.load(fh)
    except json.JSONDecodeError as e:
        raise ValueError(f"{sidecar_path} is not valid JSON ({e})")
    dense = side.get("kind") == "dense"
    if "n_spots" not in side and not dense:
        raise ValueError(
            "this sidecar has no n_spots -- count/MM grid artifacts are "
            "plain functions of in-memory grids; the server registers "
            "image artifacts (wsi -> labels)")
    required = {"classes", "h_st", "w_st", "wsi_shape", "window_px"}
    required |= {"extent"} if dense else set()
    missing = sorted(required - side.keys())
    if missing:
        raise ValueError(
            f"{sidecar_path} is missing required fields {missing} -- "
            "re-export the artifact (`export --model ... --wsi-shape H W`)")
    if side.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"{path} is not a {ARTIFACT_FORMAT} artifact of gridnext_tpu_torch (its "
            "sidecar names no such format): a JAX StableHLO artifact runs only "
            "in the JAX package; re-export with `python -m gridnext_tpu_torch export`")
    here = torch.device(device).type
    if side.get("device") != here:
        raise ValueError(
            f"this artifact was exported for {side.get('device')!r} but serves on "
            f"{here!r}: an artifact runs on the device type it was exported on; "
            "re-export there (export --device)")
    try:
        with open(path, "rb") as fh:
            fn = load_exported_registration(fh.read())
    except Exception as e:
        raise ValueError(f"{path} is not a torch.export artifact "
                         f"({type(e).__name__}: {e})")
    return fn, side


_UNFITTED = object()   # submit() sentinel: no pre-fitted dense plan


class _MicroBatcher:
    """Continuous micro-batching of concurrent slide requests.

    One dispatcher thread owns the card: each cycle it takes whatever
    requests queued while the previous dispatch ran (no added wait: a lone
    request dispatches alone), groups slides of one ``(H, W)`` shape, and
    registers each group through
    :func:`~gridnext_tpu_torch.serving.dispatch_group` (one
    ``register_batch`` for a stacked group; square-lattice slides with a
    dense plan through ``register_dense``, with the plans their requests
    fitted). Slides arrive as host arrays and reach the card on this
    thread.
    """

    def __init__(self, registrar, max_batch: int = 8):
        self.registrar = registrar
        self.max_batch = max(1, int(max_batch))
        self._q: queue.Queue = queue.Queue()
        self.dispatches = 0
        self.batched_slides = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gnx-serve-batcher")
        self._thread.start()

    def submit(self, wsi, positions, plan=_UNFITTED):
        """Block until the dispatcher registers this slide; returns the
        (H, W) label grid (or raises the dispatch's error).

        ``plan``: a dense plan fitted on the calling thread (None: fitted,
        not a dense lattice), so that the fit's least squares run
        concurrently across requests rather than on the dispatcher."""
        done = threading.Event()
        slot: dict = {}
        self._q.put((wsi, positions, plan, done, slot))
        while not done.wait(5.0):
            if not self._thread.is_alive():   # pragma: no cover - a guard
                raise RuntimeError("micro-batcher dispatcher thread died; "
                                   "restart the server")
        if "error" in slot:
            raise slot["error"]
        return slot["labels"]

    def _dispatch(self, group):
        from gridnext_tpu_torch.serving import dispatch_group

        try:
            items = [(k, wsi, pos) for k, (wsi, pos, _, _, _) in enumerate(group)]
            plans = {k: plan for k, (_, _, plan, _, _) in enumerate(group)
                     if plan is not _UNFITTED}
            stats: dict = {}
            for k, labels, _ in dispatch_group(self.registrar, items, plans=plans,
                                               stats=stats):
                _, _, _, done, slot = group[k]
                slot["labels"] = labels
                done.set()
            self.batched_slides += stats.get("batched", 0)
        except BaseException as e:  # deliver to every waiter, keep serving
            self._fail(group, e)

    @staticmethod
    def _fail(items, err):
        for _, _, _, done, slot in items:
            if not done.is_set():
                slot["error"] = err
                done.set()

    def _run(self):
        while True:
            batch = [self._q.get()]
            while len(batch) < self.max_batch:   # drain what piled up
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                groups: dict = {}
                for item in batch:
                    groups.setdefault(tuple(item[0].shape), []).append(item)
            except BaseException as e:
                # a malformed submission fails this batch's waiters, not the
                # dispatcher (every later submit would hang)
                self._fail(batch, e)
                continue
            for group in groups.values():
                self.dispatches += 1
                self._dispatch(group)


def _decode(image):
    """A request's slide, decoded on the handler thread (host memory).
    ``ingest.decode_slide`` is looked up at each call, so a caller may swap
    it (``np.load`` for ``.npy`` slides)."""
    from gridnext_tpu_torch import ingest

    if not os.path.exists(image):
        raise FileNotFoundError(f"image {image} not found")
    return ingest.decode_slide(image)


class RegistrationService:
    """A resident registration backend: one model (or artifact), many
    requests. Built by :meth:`from_model_dir` (an image, count or
    multimodal model directory), :meth:`from_artifact` (an ``export``-ed
    ``.pt2`` and its sidecar) or :meth:`from_registrar` (a
    :class:`~gridnext_tpu_torch.serving.SlideRegistrar` in the process).

    ``register_fn(image path or None, spaceranger dir, timer) -> (H, W)
    labels`` does a request's work (taking the card's lock or queueing on
    the batcher itself, so decoding stays concurrent); the service counts
    requests and writes Loupe CSVs. ``device``: where it registers.
    """

    def __init__(self, register_fn: Callable, classes: Sequence[str], *,
                 model: str = "", hex_coords: bool = True,
                 hd_binning: Optional[str] = None, needs_image: bool = True,
                 extra_info: Optional[dict] = None, device="cuda"):
        self._register_fn = register_fn
        self.classes = list(classes)
        self.model = model
        self.hex_coords = bool(hex_coords)
        self.hd_binning = hd_binning
        self.needs_image = bool(needs_image)
        self.extra_info = dict(extra_info or {})
        self.device = torch.device(device)
        self.timer = StageTimer()
        self.requests = 0
        self.errors = 0
        self._stats_lock = threading.Lock()

    # ---------------------------------------------------------------- build

    @classmethod
    def from_registrar(cls, registrar, classes: Sequence[str], *, model: str = "",
                       hd_binning: Optional[str] = None, max_batch: int = 8):
        """Serve a built :class:`~gridnext_tpu_torch.serving.SlideRegistrar`:
        concurrent requests micro-batch (:class:`_MicroBatcher`, up to
        ``max_batch`` same-shape slides a dispatch)."""
        from gridnext_tpu_torch.io import read_positions

        batcher = _MicroBatcher(registrar, max_batch=max_batch)

        def register_fn(image, srd, timer):
            if image is None:
                raise ValueError("this model registers slides; the request "
                                 "must carry an 'image' path")
            with timer("decode"):
                wsi = _decode(image)
            with timer("positions"):
                pos = read_positions(srd, hd_binning)
            plan = _UNFITTED
            if not registrar.hex_coords:
                # the dense-lattice fit (least squares over every bin) here,
                # concurrently across requests
                with timer("dense_fit"):
                    plan = registrar.dense_plan(wsi, pos)
            with timer("register"):             # the queue's wait and the dispatch
                return batcher.submit(wsi, pos, plan)

        svc = cls(register_fn, classes, model=model, hex_coords=registrar.hex_coords,
                  hd_binning=hd_binning, device=registrar.device,
                  extra_info={"window_px": registrar.window_size,
                              "patch_px": registrar.patch_size,
                              "max_batch": batcher.max_batch})
        svc.batcher = batcher
        return svc

    @classmethod
    def from_model_dir(cls, model_dir, max_batch: int = 8, device="cuda", mesh=None):
        """Resident service for a trained model directory (``model.json`` +
        ``g_state.msgpack``): image models through a ``SlideRegistrar``
        (requests micro-batched up to ``max_batch`` slides a dispatch; a
        serving ``mesh`` splits its spot axis over devices), count models
        through the grid model's forward, multimodal models through
        ``register_mm_grid`` (their grids built per request from the
        validated count caches). Graph models do not serve; a mesh serves
        image models only (ValueError otherwise)."""
        from gridnext_tpu_torch.compat.from_jax import load_model_dir
        from gridnext_tpu_torch.serving import resolve_device

        device = resolve_device(device)
        meta, classes, variables = load_model_dir(model_dir)
        name = meta.get("model", "")
        if name.endswith(("DenseNet121", "TpuPatchClassifier")):
            from gridnext_tpu_torch.modeldir import image_registrar_from_meta

            registrar = image_registrar_from_meta(meta, classes, variables, device=device,
                                                  mesh=mesh)
            return cls.from_registrar(registrar, classes, model=name,
                                      hd_binning=meta.get("hd_binning"),
                                      max_batch=max_batch)
        if mesh is not None:
            # a count / multimodal forward is one small dispatch: an ignored
            # mesh would misreport the serving topology
            raise ValueError(f"mesh serving applies to image models; "
                             f"{name!r} serves single-device")
        if name in ("GridNetHexMM", "GridNetMM"):
            return cls._mm_service(meta, classes, variables, device)
        if name.endswith("CountMLP"):
            return cls._count_service(meta, classes, variables, device)
        raise ValueError(f"don't know how to serve model {name!r}")

    @classmethod
    def _count_service(cls, meta, classes, variables, device):
        from gridnext_tpu_torch.data import CountGridDataset
        from gridnext_tpu_torch.io.unify import validated_unified_cache
        from gridnext_tpu_torch.modeldir import grid_model_from_meta

        g = grid_model_from_meta(meta, classes, variables, device=device)
        grid_dims = meta.get("grid_dims")
        lattice = {} if grid_dims is None else {
            "Visium": False, "h_st": int(grid_dims[0]), "w_st": int(grid_dims[1])}
        lock = threading.Lock()

        def register_fn(image, srd, timer):
            cfile = validated_unified_cache(srd, meta.get("hd_binning"),
                                            genes=meta.get("genes"))
            with timer("load"):
                x, _ = CountGridDataset([cfile], **lattice)[0]
            fg = x.sum(-1) > 0                 # the tissue, from the raw counts
            if meta.get("log1p"):
                x = np.log1p(x)
            with lock, timer("register"), torch.no_grad():
                logits = g(torch.as_tensor(x[None], device=device))[0]
                labels = (torch.argmax(logits, -1) + 1).to(torch.int32).cpu().numpy()
            return np.where(fg, labels, 0)

        return cls(register_fn, classes, model=meta.get("model", ""),
                   hex_coords=grid_dims is None, hd_binning=meta.get("hd_binning"),
                   needs_image=False, device=device)

    @classmethod
    def _mm_service(cls, meta, classes, variables, device):
        from gridnext_tpu_torch.io.unify import validated_unified_cache
        from gridnext_tpu_torch.modeldir import mm_model_from_meta
        from gridnext_tpu_torch.serving import register_mm_grid

        g = mm_model_from_meta(meta, classes, variables, device=device)
        grid_dims = tuple(meta["grid_dims"]) if meta.get("grid_dims") else None
        hd_binning = meta.get("hd_binning")
        patch_px = meta.get("patch_px", 128)
        lock = threading.Lock()
        # scBERT's gene2vec transform maps feature IDs to symbols through a
        # cohort array: the first request's (every cache is validated
        # against the same training gene axis, so any array gives it)
        state = {"transform": None}

        def count_transform(srd):
            if meta.get("count_f") == "scbert":
                if state["transform"] is None:
                    from gridnext_tpu_torch.modeldir import scbert_count_transform

                    state["transform"], _ = scbert_count_transform(
                        [srd], hd_binning, meta["scbert_vocab"])
                return state["transform"]
            return np.log1p if meta.get("log1p") else None

        def register_fn(image, srd, timer):
            if image is None:
                raise ValueError("multimodal models register (image, spaceranger) "
                                 "pairs; the request must carry an 'image' path")
            if not os.path.exists(image):
                raise FileNotFoundError(f"image {image} not found")
            validated_unified_cache(srd, hd_binning, genes=meta.get("genes"))
            with timer("load"):         # decode, count read, crop: this thread
                xi, xc = _mm_grids(image, srd, meta, grid_dims, hd_binning, patch_px,
                                   device)
            transform = count_transform(srd)
            with lock, timer("register"):
                return register_mm_grid(g, xi, xc, transform, device=device)

        return cls(register_fn, classes, model=meta.get("model", ""),
                   hex_coords=grid_dims is None, hd_binning=hd_binning, device=device)

    @classmethod
    def from_artifact(cls, path, device="cuda"):
        """Resident service for an ``export``-ed image-registration artifact
        (``.pt2`` + JSON sidecar): no model is constructed."""
        from gridnext_tpu_torch.io import read_positions
        from gridnext_tpu_torch.serving import resolve_device

        device = resolve_device(device)
        fn, side = load_artifact(path, device)
        hexc = side.get("hex_coords", True)
        hd_binning = side.get("hd_binning")
        lock = threading.Lock()

        def register_fn(image, srd, timer):
            if image is None:
                raise ValueError("artifact serving registers slides; the "
                                 "request must carry an 'image' path")
            with timer("decode"):
                wsi = _decode(image)
            with timer("positions"):
                pos = read_positions(srd, hd_binning)
            ins = artifact_inputs(side, wsi.shape, pos, image, srd)
            with lock, timer("register"):
                return run_artifact(fn, wsi, ins, device)

        return cls(register_fn, side["classes"], model=side.get("model", "artifact"),
                   hex_coords=hexc, hd_binning=hd_binning, device=device,
                   extra_info={"artifact": str(path), "window_px": side.get("window_px"),
                               "kind": side.get("kind", "spots")})

    # ------------------------------------------------------------- requests

    def register(self, spaceranger, image=None) -> np.ndarray:
        """Register one array -> (H, W) int label grid (0 = background)."""
        if not spaceranger or not isinstance(spaceranger, str):
            raise ValueError("request must carry a 'spaceranger' directory path string")
        if image is not None and not isinstance(image, str):
            raise ValueError("'image' must be a path string")
        if not os.path.isdir(spaceranger):
            raise FileNotFoundError(f"spaceranger dir {spaceranger} not found")
        with self._stats_lock:
            self.requests += 1
        return np.asarray(self._register_fn(image, spaceranger, self.timer))

    def note_error(self):
        """Count a failed request (handler threads are concurrent)."""
        with self._stats_lock:
            self.errors += 1

    def reset_metrics(self):
        """Zero the request and error counts and the stage times (after a
        warm-up, so ``/metrics`` describes steady serving)."""
        with self._stats_lock:
            self.requests = 0
            self.errors = 0
            self.timer.totals.clear()
            self.timer.counts.clear()
            batcher = getattr(self, "batcher", None)
            if batcher is not None:
                batcher.dispatches = 0
                batcher.batched_slides = 0

    def loupe_csv(self, labels, spaceranger) -> str:
        """Loupe-format (Barcode, AARs) CSV text of a label grid."""
        from gridnext_tpu_torch.evaluate import to_loupe_annots
        from gridnext_tpu_torch.io import find_position_file

        buf = _io.StringIO()
        to_loupe_annots(labels, find_position_file(spaceranger, self.hd_binning), buf,
                        annot_names=self.classes, hex_coords=self.hex_coords)
        return buf.getvalue()

    def handle_register(self, body: dict) -> dict:
        """One POST /register body -> the response dict (the HTTP-free core,
        callable in-process)."""
        labels = self.register(body.get("spaceranger"), image=body.get("image"))
        resp = {"labels": labels.tolist(), "shape": list(labels.shape),
                "classes": self.classes, "hex_coords": self.hex_coords,
                "n_foreground": int((labels > 0).sum())}
        if body.get("loupe") or body.get("out"):
            if body.get("out") is not None and not isinstance(body["out"], str):
                raise ValueError("'out' must be a path string")
            csv_text = self.loupe_csv(labels, body["spaceranger"])
            if body.get("out"):
                out = body["out"]
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                with open(out, "w") as fh:
                    fh.write(csv_text)
                resp["out"] = out
            if body.get("loupe"):
                resp["loupe_csv"] = csv_text
        return resp

    def info(self) -> dict:
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")
        return {"status": "ok", "model": self.model, "classes": self.classes,
                "hex_coords": self.hex_coords, "hd_binning": self.hd_binning,
                "needs_image": self.needs_image, "backend": self.device.type,
                "device_name": name, "requests": self.requests, **self.extra_info}

    def metrics(self) -> dict:
        out = {"requests": self.requests, "errors": self.errors,
               "stage_seconds": self.timer.summary(),
               "stage_counts": dict(self.timer.counts)}
        batcher = getattr(self, "batcher", None)
        if batcher is not None:
            out["dispatches"] = batcher.dispatches
            out["batched_slides"] = batcher.batched_slides
        return out


def _mm_grids(image, srd, meta, grid_dims, hd_binning, patch_px, device):
    """A multimodal request's (image grid on the card, raw count grid), as
    the ``register`` command builds them."""
    from gridnext_tpu_torch.data import DenseWSIGridDataset, create_visium_dataset

    if meta.get("dense_ingest") and grid_dims:
        xi = DenseWSIGridDataset([image], [srd], patch_size=patch_px,
                                 hd_binning=hd_binning, grid_dims=grid_dims,
                                 device=device)[0][0]
        xc = create_visium_dataset([srd], use_image=False, hd_binning=hd_binning,
                                   grid_dims=grid_dims, minimum_detection_rate=None)[0][0]
        return xi, xc
    (xi, xc), _ = create_visium_dataset(
        [srd], fullres_image_files=[image], patch_size_px=patch_px,
        window_size_px=meta.get("window_px"), hd_binning=hd_binning,
        grid_dims=grid_dims, device=device, minimum_detection_rate=None)[0]
    return xi, xc


def artifact_inputs(side: dict, wsi_shape, positions, image, srd):
    """The fixed-shape inputs of an image artifact (its sidecar ``side``)
    for one slide: its spot arrays (``serving.artifact_spot_inputs``), or
    a dense artifact's ``(oy0, ox0, fg)`` from an exact lattice plan.
    Raises ValueError, naming ``image`` or the Spaceranger directory
    ``srd``, for a slide of another shape, and for a lattice that is not
    exact or whose extent differs (shapes are static)."""
    from gridnext_tpu_torch.serving import artifact_spot_inputs, fit_dense_lattice

    if list(wsi_shape) != list(side["wsi_shape"]):
        raise ValueError(
            f"slide {image} is {tuple(wsi_shape)} but the artifact was exported for "
            f"{tuple(side['wsi_shape'])} (shapes are static; re-export with --wsi-shape)")
    if side.get("kind") != "dense":
        return artifact_spot_inputs(wsi_shape, positions, side["n_spots"],
                                    window_size=side["window_px"], h_st=side["h_st"],
                                    w_st=side["w_st"], hex_coords=side.get("hex_coords", True))
    plan = fit_dense_lattice(positions, side["h_st"], side["w_st"], side["window_px"],
                             tuple(side["wsi_shape"]))
    if plan is None or plan[0] != "exact":
        raise ValueError(f"{srd} is not an exact integer-pitch lattice; this dense "
                         "artifact can't serve it (use `register`)")
    _, oy0, ox0, fg, ey, ex = plan
    if [int(ey), int(ex)] != list(side["extent"]):
        raise ValueError(f"{srd} extent ({ey}, {ex}) differs from the artifact's "
                         f"{side['extent']} (shapes are static; re-export)")
    return oy0, ox0, fg


def run_artifact(fn, wsi, inputs, device) -> np.ndarray:
    """One call of a loaded image artifact: the slide (a host array, or a
    tensor already staged) and its fixed-shape inputs (the spot arrays, or
    a dense plan's ``(oy0, ox0, fg)``) copied to ``device`` on the calling
    thread, the labels back on the host."""
    args = [(wsi if isinstance(wsi, torch.Tensor)
             else torch.as_tensor(np.ascontiguousarray(wsi))).to(device)]
    args += [torch.as_tensor(np.asarray(a, np.int32)).to(device) for a in inputs]
    return fn(*args).cpu().numpy()


class _Handler(BaseHTTPRequestHandler):
    server_version = "gridnext-tpu-torch-serve"

    @property
    def service(self) -> RegistrationService:
        return self.server.service

    def _json(self, code: int, obj: dict):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path in ("/healthz", "/info"):
            self._json(200, self.service.info())
        elif self.path == "/metrics":
            self._json(200, self.service.metrics())
        else:
            self._json(404, {"error": f"unknown route {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/register":
            self._json(404, {"error": f"unknown route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            result = self.service.handle_register(body)
        except (ValueError, KeyError, TypeError, FileNotFoundError,
                json.JSONDecodeError) as e:
            self.service.note_error()
            with contextlib.suppress(OSError):   # the client may be gone
                self._json(400, {"error": str(e)})
            return
        except Exception as e:  # report it, keep the server thread
            self.service.note_error()
            traceback.print_exc()
            with contextlib.suppress(OSError):
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        try:
            self._json(200, result)
        except OSError:
            # the client left while the response was written: the
            # registration itself succeeded, so no error is counted
            self.log_message("client disconnected during response write")

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)


class RegistrationHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to one :class:`RegistrationService`. Its
    threads are daemons (a hung client cannot block shutdown)."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, service: RegistrationService, verbose: bool = False):
        self.service = service
        self.verbose = verbose
        super().__init__(addr, _Handler)


def make_server(service: RegistrationService, host: str = "127.0.0.1",
                port: int = 8000, verbose: bool = False):
    """Bind a :class:`RegistrationHTTPServer` (``port=0`` picks a free port;
    read it back from ``server.server_address[1]``)."""
    return RegistrationHTTPServer((host, port), service, verbose=verbose)
