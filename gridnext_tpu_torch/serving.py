"""Slide registration on the card: slide image -> label grid.

The main path of the port: crop one window per in-tissue spot
(:func:`~gridnext_tpu_torch.ops.patch_gather_cuda.gather_patches`), resize
it to the patch size where the window is larger or smaller
(:func:`~gridnext_tpu_torch.pipeline.resize_patches`), run the
spot classifier f in chunks, scatter its outputs into the 78x64 odd-right
grid with f(zero patch) on background cells, and run the folded hex
corrector with the argmax and background mask
(:func:`~gridnext_tpu_torch.ops.hexcorrector_cuda.fused_hex_corrector_labels`).

Typical use::

    registrar = SlideRegistrar.from_gridnet(model, patch_size=128)  # device="cuda"
    labels = registrar(wsi, positions)                 # (78, 64) int32 numpy
    labels_b = registrar.register_batch(wsis, positions_list)   # (N, 78, 64)
    to_loupe_annots(labels, position_file, out_csv, annot_names=classes)

Square-lattice models (Visium HD bins, ``GridNet``) index the grid by
(array_row, array_col) and run the Cartesian conv corrector; where the
bins form a dense regular lattice, :meth:`SlideRegistrar.register_dense`
takes them: through the per-bin gather when the pitch is the integer window
(``"exact"``: the crops tile the lattice), through a banded linear resample
of the exact bin extents when it is fractional (``"resample"``;
:func:`fit_dense_lattice` decides).

A cohort of slide files registers through :func:`register_slides`, which
overlaps decoding and staging (:class:`~gridnext_tpu_torch.ingest.SlideSource`)
with registration and batches same-shape slides (:func:`dispatch_group`).
Multimodal model directories (a count f beside an image f) register an
image grid and a count grid with :func:`register_mm_grid`; the ``register``
command builds them from the slides and the unified count caches
(:func:`gridnext_tpu_torch.data.create_visium_dataset`).

:meth:`SlideRegistrar.export`, :meth:`SlideRegistrar.export_dense` and
:func:`export_grid_forward` write the registration as a ``torch.export``
artifact (the JAX package's ``jax.export`` deployment unit): the weights
inside, the kernels as ``gridnext::`` custom ops, f's chunks as one
``map`` (:func:`~gridnext_tpu_torch.models.gridnet.map_chunks`);
:func:`load_exported_registration` runs it with no model code.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without CUDA they raise rather than carry on on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.models.gridnet import map_chunks
from gridnext_tpu_torch.observability import stage
from gridnext_tpu_torch.ops.hexcorrector_cuda import (
    CORRECTOR_RELU_FLAGS, as_f32_tensors, fused_hex_corrector,
    fused_hex_corrector_labels)
from gridnext_tpu_torch.ops.patch_gather_cuda import gather_patches
from gridnext_tpu_torch.pipeline import (imagenet_normalize, resize_matrices,
                                         resize_patches, scale_and_translate_linear,
                                         spot_pixel_arrays)

# Padded spot arrays round up to a multiple of this (the JAX package's
# compile-sharing bucket; kept so both pad the same way).
_SPOT_BUCKET = 128

# Floats in one band chunk's largest resample intermediate (bands x band
# rows x output columns x 3): 2^27 floats, 0.5 GB.
_RESAMPLE_CHUNK_FLOATS = 1 << 27


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def _mesh_device(mesh, device) -> torch.device:
    """A registrar's device: ``device``, or a serving mesh's first."""
    if mesh is None:
        return resolve_device(device)
    if not mesh.devices:
        raise ValueError("a registrar's mesh lists devices (parallel.make_mesh("
                         "shape, devices=[...])); training meshes span processes")
    return resolve_device(mesh.devices[0])


def _clamp_centers(y_px, x_px, wsi_shape, window_size: int,
                   pad_offset: int = 0):
    """Offset + clamp spot centers so the crop window stays in bounds.

    The crop origin is center - w//2 over ``window_size`` pixels, so the
    largest in-bounds center is H - (w - w//2).
    """
    p2 = window_size // 2
    y_px = np.clip(y_px + pad_offset, p2, wsi_shape[0] - (window_size - p2))
    x_px = np.clip(x_px + pad_offset, p2, wsi_shape[1] - (window_size - p2))
    return y_px, x_px


def _parked_spots(n: int, h_st: int, p2: int):
    """(oy, ox, y_px, x_px) int32 fill arrays for ``n`` padding spots.

    Padded spots park outside the lattice (``oy == h_st``; the scatter drops
    them) and crop a harmless corner window (centers at ``p2 = window // 2``).
    """
    return (np.full((n,), h_st, np.int32), np.zeros((n,), np.int32),
            np.full((n,), p2, np.int32), np.full((n,), p2, np.int32))


def artifact_spot_inputs(wsi_shape, positions, n_spots: int, *, window_size: int,
                         h_st: int, w_st: int, hex_coords: bool = True,
                         pad_offset: int = 0):
    """Fixed-length ``(oy, ox, y_px, x_px)`` int32 inputs of an exported
    registration artifact (:meth:`SlideRegistrar.export`), built from its
    sidecar's fields alone (``window_px``, ``h_st``, ``w_st``,
    ``hex_coords``), with no registrar or model.

    The live path's conventions: centers clamp so the window stays in the
    slide, and the padding spots park outside the lattice (``oy == h_st``,
    dropped by the scatter) and crop a harmless corner. Raises ValueError
    when the slide has more in-tissue spots than ``n_spots``.
    """
    oy_a, ox_a, y_a, x_a = spot_pixel_arrays(positions, h_st, w_st, hex_coords)
    y_a, x_a = _clamp_centers(y_a, x_a, wsi_shape, window_size, pad_offset)
    k = len(oy_a)
    if k > n_spots:
        raise ValueError(f"{k} in-tissue spots exceed n_spots={n_spots}")
    oy, ox, y_px, x_px = _parked_spots(n_spots, h_st, window_size // 2)
    oy[:k], ox[:k], y_px[:k], x_px[:k] = oy_a, ox_a, y_a, x_a
    return oy, ox, y_px, x_px


# Names of the device types an artifact may be exported for, by the device
# it is traced on (the JAX package's ``--platforms`` names included).
_PLATFORM_NAMES = {"cuda": ("cuda", "gpu"), "cpu": ("cpu",)}


def check_export_platforms(device, platforms) -> None:
    """Raise ValueError when ``platforms`` names a device type other than
    ``device``'s: an artifact holds the ops of the device it was traced on
    (its kernels, or their plain versions on the CPU) and runs there only,
    as the JAX package's Pallas artifacts run on their backend only.
    Export on the target device instead."""
    if not platforms:
        return
    here = torch.device(device).type
    mismatched = [p for p in platforms
                  if str(p).lower() not in _PLATFORM_NAMES.get(here, (here,))]
    if mismatched:
        raise ValueError(
            f"cannot export for platforms {mismatched} from a {here!r} device: an "
            "artifact runs the ops of the device it was traced on. Export on the "
            "target device (--device)")


class _Program(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces: the modules it runs
    are submodules (their weights the program's parameters and buffers);
    other tensors it reads (folded corrector weights, resize matrices) are
    lifted as constants."""

    def __init__(self, fn: Callable, modules=()):
        super().__init__()
        self.fn = fn
        self.parts = torch.nn.ModuleList([m for m in modules
                                          if isinstance(m, torch.nn.Module)])

    def forward(self, *args):
        return self.fn(*args)


def _export(fn: Callable, modules, args) -> bytes:
    """``torch.export`` of ``fn`` at the example ``args`` (their shapes and
    dtypes are the program's), saved with ``torch.export.save``: the bytes
    of one ``.pt2`` file. Chunk loops trace as one ``map``
    (:func:`~gridnext_tpu_torch.models.gridnet.map_chunks`)."""
    import io as _io

    program = _Program(fn, modules).eval()
    with torch.no_grad():
        exported = torch.export.export(program, tuple(args), strict=False)
    exported.example_inputs = None     # else the file keeps them (a whole slide)
    buf = _io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported_registration(blob: bytes) -> Callable:
    """Load an exported artifact (:meth:`SlideRegistrar.export`,
    :meth:`SlideRegistrar.export_dense`, :func:`export_grid_forward`): the
    bytes of its ``.pt2`` file. Returns ``fn(*inputs) -> labels``
    (a tensor on the artifact's device), which runs the saved program,
    weights included, with no model code; its ``gridnext::`` ops are
    registered by importing :mod:`gridnext_tpu_torch.ops`. Inputs must have
    the exported shapes (:meth:`SlideRegistrar.spot_inputs`)."""
    import io as _io

    exported = torch.export.load(_io.BytesIO(bytes(blob)))
    module = exported.module()

    def call(*inputs):
        with torch.no_grad():
            return module(*inputs)

    return call


def fit_dense_lattice(positions, h_st: int, w_st: int, window: int,
                      wsi_shape=None, pad_offset: int = 0):
    """Dense-lattice analysis of square-lattice positions: a plan or None.

    Fits ``center = origin + (idx + 1/2) * pitch`` per axis by least
    squares over the in-tissue bins inside the ``(h_st, w_st)`` lattice.
    Returns ``("exact", oy0, ox0, fg, ey, ex)`` when the pitch is exactly
    the integer ``window`` (the per-bin crops tile the lattice);
    ``("resample", y0, x0, py, px, fg, h_band, ey, ex)`` when the lattice
    is regular to 0.5 px with a fractional pitch (real Spaceranger HD: 16
    um over the microns per pixel) and ``window`` means the whole bin
    (|pitch - window| <= 1); None when the positions
    are not a dense regular lattice, or its in-tissue extent leaves the
    image. ``fg`` is the (h_st, w_st) int32 in-tissue mask and ``(ey, ex)``
    the in-tissue bin extent (largest index + 1): only that extent is
    read, so a slide smaller than a cohort-max ``(h_st, w_st)`` still plans
    and its extra rows and columns are background. The JAX package's
    ``fit_dense_lattice``, float64 throughout.
    """
    oy, ox, y_px, x_px = spot_pixel_arrays(positions, h_st, w_st, hex_coords=False)
    if len(oy) == 0 or len(np.unique(oy)) < 2 or len(np.unique(ox)) < 2:
        return None
    y_px = y_px.astype(np.float64) + pad_offset
    x_px = x_px.astype(np.float64) + pad_offset

    def fit(idx, px):
        a = np.stack([np.ones_like(idx, np.float64), idx], axis=1)
        (b0, pitch), *_ = np.linalg.lstsq(a, px, rcond=None)
        res = np.abs(px - (b0 + pitch * idx)).max()
        return b0, pitch, res

    by, pitch_y, res_y = fit(oy.astype(np.float64), y_px)
    bx, pitch_x, res_x = fit(ox.astype(np.float64), x_px)
    if max(res_y, res_x) > 0.5 or pitch_y <= 1 or pitch_x <= 1:
        return None
    fg = np.zeros((h_st, w_st), np.int32)
    fg[oy, ox] = 1
    ey, ex = int(oy.max()) + 1, int(ox.max()) + 1
    w = window
    h_img, w_img = ((wsi_shape[0], wsi_shape[1]) if wsi_shape is not None
                    else (np.inf, np.inf))
    # exact tiling when the fitted lattice is the integer window pitch; the
    # centers are already rounded to integers, and the per-bin crop origin
    # is center - w//2, so an integer intercept and pitch is exactness (a
    # least-squares fit of exact integer data leaves ~1e-12 of residue)
    tol = 1e-6
    int_pitch = (abs(pitch_y - w) < tol and abs(pitch_x - w) < tol
                 and res_y < tol and res_x < tol
                 and abs(by - round(by)) < tol and abs(bx - round(bx)) < tol)
    if int_pitch:
        oy0, ox0 = round(by) - w // 2, round(bx) - w // 2
        if oy0 >= 0 and ox0 >= 0 and oy0 + ey * w <= h_img and ox0 + ex * w <= w_img:
            return ("exact", oy0, ox0, fg, ey, ex)
        return None
    # a fractional (or shifted) regular lattice resamples, but only where
    # the window means the whole bin: a window far from the pitch asks for
    # center crops, which only the per-bin gather takes; an extent that
    # leaves the image (origin included) also stays per-bin, whose corner
    # clamp handles borders
    if abs(pitch_y - w) > 1.0 or abs(pitch_x - w) > 1.0:
        return None
    y0 = by - pitch_y / 2
    x0 = bx - pitch_x / 2
    h_band = int(np.ceil(pitch_y)) + 3
    if (y0 < 0 or x0 < 0 or y0 + ey * pitch_y > h_img
            or x0 + ex * pitch_x > w_img or h_band > h_img):
        return None
    return ("resample", float(y0), float(x0), float(pitch_y), float(pitch_x), fg,
            h_band, ey, ex)


class SlideRegistrar:
    """Full-slide registration: image -> label grid.

    Args:
      f_apply: ``f_apply(patches (N, P, P, 3) float) -> (N, f_dim)``: the
        spot classifier (a module or any callable, such as
        :func:`~gridnext_tpu_torch.ops.denseblock_cuda.build_densenet_fused_infer`'s
        ``infer``) on ``device``.
      corrector_kernels/biases/relu_flags: folded hex-corrector weights
        (:func:`~gridnext_tpu_torch.ops.hexcorrector_cuda.fold_corrector_params`);
        None with ``corrector_apply``.
      patch_size: patch side in pixels.
      window_size: crop window side (default ``patch_size``); other sizes
        are resized to ``patch_size`` (cubic, antialiased, as the JAX
        package's ``jax.image.resize``).
      normalize: 'imagenet' or None (``/255`` only).
      patch_chunk: f runs over the spot axis in chunks of this size.
      h_st, w_st: the label grid (default Visium's 78 x 64).
      hex_coords: True for Visium pseudo-hex positions; False for square
        bin lattices (Visium HD), indexed by (array_row, array_col).
      corrector_apply: ``corrector_apply(grid (B, H, W, f_dim)) -> (B, H,
        W, C)`` logits, in place of the hex-corrector kernels (the
        Cartesian conv corrector of square ``GridNet`` models).
      device: where registration runs; 'cuda' (default) raises without CUDA.
      mesh: a serving mesh (``parallel.make_mesh(shape, devices=[...])``)
        to split the flat spot axis over: padded to a multiple of its
        size, each shard's crop (one gather launch) and f run on its own
        device, the features move to the first device, where the
        corrector runs once (``device`` becomes the first device). f must
        be a module to run on another device (a copy there). The labels
        are the single-device ones.
    """

    def __init__(self, f_apply: Callable, corrector_kernels=None, corrector_biases=None,
                 relu_flags=CORRECTOR_RELU_FLAGS, *, patch_size: int = 128,
                 window_size: Optional[int] = None,
                 normalize: Optional[str] = "imagenet",
                 patch_chunk: Optional[int] = 624,
                 h_st: int = geometry.VISIUM_H_ST, w_st: int = geometry.VISIUM_W_ST,
                 hex_coords: bool = True, corrector_apply: Optional[Callable] = None,
                 device="cuda", mesh=None):
        self.mesh = mesh
        self.device = _mesh_device(mesh, device)
        self._shards = {}             # device -> (f_apply, resize matrices) of a shard
        if corrector_apply is None and not corrector_kernels:
            raise ValueError("the hex corrector needs corrector_kernels/"
                             "corrector_biases (fold_corrector_params or "
                             "from_gridnet); pass corrector_apply for another "
                             "corrector")
        if normalize not in (None, "imagenet"):
            raise ValueError(f"unknown normalize {normalize!r}")
        self.f_apply = f_apply
        self.corrector_apply = corrector_apply
        self.kernels = as_f32_tensors(corrector_kernels or [], self.device)
        self.biases = as_f32_tensors(corrector_biases or [], self.device)
        self.relu_flags = tuple(relu_flags)
        self.patch_size = patch_size
        self.window_size = window_size or patch_size
        # the resize's weight matrices, built once (None: no resize)
        self._resize = (None if self.window_size == patch_size else resize_matrices(
            self.window_size, self.window_size, patch_size, self.device))
        self.normalize = normalize
        self.patch_chunk = patch_chunk
        self.h_st, self.w_st = h_st, w_st
        self.hex_coords = hex_coords

    @classmethod
    def from_gridnet(cls, model, *, patch_size: int = 128,
                     normalize: Optional[str] = "imagenet", device="cuda", **kw):
        """Build from a :class:`~gridnext_tpu_torch.models.GridNetHex` or a
        square :class:`~gridnext_tpu_torch.models.GridNet` with its weights
        loaded; f moves to ``device`` and into eval mode (in place).

        A hex corrector's BatchNorm folds into its hex weights for the
        corrector kernels. A Cartesian corrector runs as its module (eval
        mode, on ``device``) with ``hex_coords=False`` by default; pass the
        lattice as ``h_st``/``w_st``.
        """
        from gridnext_tpu_torch.models.gridnet import _CartesianCorrector

        device = _mesh_device(kw.get("mesh"), device)
        f = model.patch_classifier.to(device).eval()
        if isinstance(model.corrector, _CartesianCorrector):
            kw.setdefault("hex_coords", False)
            return cls(f, corrector_apply=model.corrector.to(device).eval(),
                       patch_size=patch_size, normalize=normalize, device=device, **kw)
        kernels, biases, relu_flags = model.corrector.folded()
        return cls(f, kernels, biases, relu_flags, patch_size=patch_size,
                   normalize=normalize, device=device, **kw)

    # -- device-side stages -------------------------------------------------

    def _normalize(self, patches: torch.Tensor) -> torch.Tensor:
        patches = patches.float() / 255.0
        if self.normalize == "imagenet":
            patches = imagenet_normalize(patches)
        return patches

    def _extract_flat(self, wsis, y_c, x_c, slide):
        """(B, H, W, 3) uint8 slides + (N,) centers/slide ids -> (N, w, w, 3)
        uint8 crops of the window size."""
        w = self.window_size
        return gather_patches(wsis, y_c - w // 2, x_c - w // 2, w, slide)

    def _apply_f(self, crops: torch.Tensor, shard=None) -> torch.Tensor:
        """uint8 window crops -> (N, f_dim); resizes, normalizes and runs f
        chunk by chunk, so only one chunk of float patches is alive at a
        time. ``shard``: a mesh device's (f_apply, resize matrices)
        (default this registrar's)."""
        f_apply, resize = shard or (self.f_apply, self._resize)
        chunk = self.patch_chunk or crops.shape[0]
        return map_chunks(lambda part: f_apply(self._normalize(
            resize_patches(part, self.patch_size, resize))), crops, chunk)

    # -- the mesh's spot shards ---------------------------------------------

    def _shard(self, device: torch.device):
        """(f_apply, resize matrices) on a mesh device: this registrar's on
        its own device, a copy of the f module elsewhere (made once)."""
        if device == self.device:
            return self.f_apply, self._resize
        if device not in self._shards:
            import copy

            if not isinstance(self.f_apply, torch.nn.Module):
                raise ValueError("a mesh over several devices needs f as a module "
                                 f"(got {type(self.f_apply).__name__})")
            resize = (None if self._resize is None else resize_matrices(
                self.window_size, self.window_size, self.patch_size, device))
            self._shards[device] = (copy.deepcopy(self.f_apply).to(device).eval(), resize)
        return self._shards[device]

    def _sharded(self, n: int):
        """(shard length, [(device, rows)]) of a flat axis of ``n`` padded to
        a multiple of the mesh's size."""
        per = -(-n // self.mesh.size)
        return per, [(d, slice(i * per, (i + 1) * per))
                     for i, d in enumerate(self.mesh.devices)]

    def _feats_flat(self, wsis, y_c, x_c, slide):
        """Flat spot centers -> (N, f_dim) features on ``self.device``.
        Over a mesh the spot axis pads to a multiple of the mesh's size
        (padding spots crop slide 0's corner and are cut off after), and
        each shard crops its spots with one gather launch and runs f on
        its device; the features move to the first device. Off-mesh this
        is plain crop + f."""
        if self.mesh is None:
            return self._apply_f(self._extract_flat(wsis, y_c, x_c, slide))
        n = y_c.shape[0]
        per, shards = self._sharded(n)
        pad = per * self.mesh.size - n
        if pad:
            p2 = self.window_size // 2
            y_c = torch.cat([y_c, y_c.new_full((pad,), p2)])
            x_c = torch.cat([x_c, x_c.new_full((pad,), p2)])
            slide = torch.cat([slide, slide.new_zeros((pad,))])
        feats = []
        for dev, rows in shards:
            w = wsis if wsis.device == dev else wsis.to(dev)
            crops = self._extract_flat(w, y_c[rows].to(dev), x_c[rows].to(dev),
                                       slide[rows].to(dev))
            feats.append(self._apply_f(crops, self._shard(dev)).to(self.device))
        return torch.cat(feats)[:n]

    def _apply_f_sharded(self, patches: torch.Tensor) -> torch.Tensor:
        """:meth:`_apply_f` over the mesh's shards of a flat patch axis (the
        dense resample path: each device runs f on its shard; the features
        move to the first device). Off-mesh this is plain :meth:`_apply_f`."""
        if self.mesh is None:
            return self._apply_f(patches)
        n = patches.shape[0]
        per, shards = self._sharded(n)
        feats = []
        for dev, rows in shards:
            part = patches[rows]
            if part.shape[0]:
                feats.append(self._apply_f(part.to(dev), self._shard(dev)).to(self.device))
        return torch.cat(feats)

    def _bg_vec(self) -> torch.Tensor:
        # Background cells carry f(zero patch): in training grids background
        # cells are literal zeros, so the corrector learned its boundary
        # context from f(0). The zero patch therefore skips normalization.
        bg = torch.zeros((1, self.patch_size, self.patch_size, 3),
                         dtype=torch.float32, device=self.device)
        return self.f_apply(bg)[0]

    def _labels_from_grid(self, grid, fg):
        """(B, H, W, f_dim) grid + (B, H, W) fg mask -> (B, H, W) labels."""
        if self.corrector_apply is None:
            return fused_hex_corrector_labels(grid, fg, self.kernels, self.biases,
                                              self.relu_flags)
        labels = torch.argmax(self.corrector_apply(grid), dim=-1).to(torch.int32) + 1
        return torch.where(fg > 0, labels, 0)

    def _grid_fg(self, wsis, oy, ox, y_px, x_px):
        """(B, H, W, 3) slides + (B, S) spot arrays -> ((B, h_st, w_st, f_dim)
        f-output grid, (B, h_st, w_st) int32 fg mask)."""
        b, s = oy.shape
        slide = torch.arange(b, device=self.device).repeat_interleave(s)
        feats = self._feats_flat(wsis, y_px.reshape(-1), x_px.reshape(-1), slide)
        return self._scatter(feats.reshape(b, s, -1), oy, ox)

    def _scatter(self, feats, oy, ox):
        """(B, S, f_dim) spot features at (B, S) grid cells -> ((B, h_st,
        w_st, f_dim) grid with f(zero patch) on the other cells, (B, h_st,
        w_st) int32 fg mask)."""
        b, s = oy.shape
        bg_vec = self._bg_vec().to(feats.dtype)
        # Spots outside the lattice (the parked padding, oy == h_st) are
        # dropped explicitly: they scatter into an extra row h_st that is
        # cut off below (torch indexing would raise or wrap instead).
        keep = (oy >= 0) & (oy < self.h_st) & (ox >= 0) & (ox < self.w_st)
        oy = torch.where(keep, oy, torch.full_like(oy, self.h_st))
        ox = torch.where(keep, ox, torch.zeros_like(ox))
        bidx = torch.arange(b, device=self.device)[:, None].expand(b, s)
        grid = bg_vec.expand(b, self.h_st + 1, self.w_st, feats.shape[-1]).clone()
        grid[bidx, oy, ox] = feats
        fg = torch.zeros((b, self.h_st + 1, self.w_st), dtype=torch.int32,
                         device=self.device)
        fg[bidx, oy, ox] = 1
        return (grid[:, :self.h_st].contiguous(), fg[:, :self.h_st].contiguous())

    def _register(self, wsi, oy, ox, y_px, x_px):
        grid, fg = self._grid_fg(wsi[None], oy[None], ox[None], y_px[None],
                                 x_px[None])
        return self._labels_from_grid(grid, fg)[0]

    def _register_logits(self, wsi, oy, ox, y_px, x_px):
        """((H, W, C) float32 logits, (H, W) int32 fg mask) of one slide."""
        grid, fg = self._grid_fg(wsi[None], oy[None], ox[None], y_px[None],
                                 x_px[None])
        if self.corrector_apply is None:
            logits = fused_hex_corrector(grid, self.kernels, self.biases, self.relu_flags)
        else:
            logits = self.corrector_apply(grid)
        return logits[0].float(), fg[0]

    def _register_batch(self, wsis, oy, ox, y_px, x_px):
        """(B, H, W, 3) slides + (B, S) padded spot arrays -> (B, h, w)."""
        grid, fg = self._grid_fg(wsis, oy, ox, y_px, x_px)
        return self._labels_from_grid(grid, fg)

    # -- dense square lattices ---------------------------------------------

    def _band_plan(self, h_img: int, y0: float, x0: float, py: float, px: float,
                   h_band: int, ey: int):
        """(band tops, (ey,) row translations, column translation) of the
        lattice resample.

        The band tops are the JAX package's: ``sy = y0 + r * py`` and
        ``floor(sy) - 1`` in float32 (clipped into the slide), so each band
        reads the same rows. The translations map input pixels to patch
        pixels, ``-(sy - top) * P / py`` down the band and ``-x0 * P / px``
        across the slide, in float64 from the float64 fit: every bin
        samples its exact extent (float32 sample positions drift by ~1.5e-3
        px across a 22,577-px slide).
        """
        f32 = np.float32
        p = self.patch_size
        r = np.arange(ey)
        sy32 = f32(y0) + r.astype(f32) * f32(py)
        top = np.clip(np.floor(sy32).astype(np.int64) - 1, 0, h_img - h_band)
        sy = y0 + r * py
        return top, -(sy - top) * (p / py), -x0 * (p / px)

    def _resampled_bands(self, wsi, y0: float, x0: float, py: float, px: float,
                         h_band: int, ey: int, ex: int):
        """The banded lattice resample, chunk by chunk: yields raw (n * ex, P,
        P, 3) float32 patches of consecutive bin rows.

        Bin row r reads the ``h_band`` slide rows from its band top and
        resamples them (linear, antialiased: ``jax.image.scale_and_translate``
        through :func:`~gridnext_tpu_torch.pipeline.scale_and_translate_linear`)
        straight to ``(P, ex * P)``: the exact fractional bin extents at
        patch scale, with no gather and no per-bin resize. The weights are
        local to the band (renormalised inside it), as the JAX package's
        are. Bands go in chunks whose largest intermediate holds about
        ``_RESAMPLE_CHUNK_FLOATS`` floats.
        """
        p = self.patch_size
        top, ty, tx = self._band_plan(wsi.shape[0], y0, x0, py, px, h_band, ey)
        per = max(1, _RESAMPLE_CHUNK_FLOATS // (h_band * ex * p * wsi.shape[-1]))
        offs = torch.arange(h_band, device=wsi.device)
        for r0 in range(0, ey, per):
            r1 = min(ey, r0 + per)
            tops = torch.as_tensor(top[r0:r1], device=wsi.device)
            bands = wsi[tops[:, None] + offs]                  # (n, h_band, W, 3)
            out = scale_and_translate_linear(bands, (p, ex * p), (p / py, p / px),
                                             ty[r0:r1], tx)
            yield out.reshape(r1 - r0, p, ex, p, -1).permute(0, 2, 1, 3, 4).reshape(
                (r1 - r0) * ex, p, p, -1)

    def _resampled_patches(self, wsi, y0, x0, py, px, h_band: int, ey: int, ex: int):
        """All (ey * ex, P, P, 3) float32 patches of the lattice resample."""
        return torch.cat(list(self._resampled_bands(wsi, y0, x0, py, px, h_band, ey, ex)))

    def _register_dense_resampled(self, wsi, y0, x0, py, px, fg, h_band: int,
                                  ey: int, ex: int):
        """Fractional-pitch dense registration: banded resample -> f ->
        labels. The float patches go to f unrounded (``/255``). f runs on
        the in-tissue bins only; the background bins of the extent are
        resampled with their band but carry f(zero patch), as in the
        per-bin scatter."""
        inside = np.asarray(fg)[:ey, :ex].reshape(-1) > 0
        feats, r0 = [], 0
        for patches in self._resampled_bands(wsi, y0, x0, py, px, h_band, ey, ex):
            keep = np.flatnonzero(inside[r0:r0 + patches.shape[0]])
            r0 += patches.shape[0]
            if len(keep):
                feats.append(self._apply_f_sharded(
                    patches[torch.as_tensor(keep, device=wsi.device)]))
        oy, ox = (torch.as_tensor(a, device=self.device)[None]
                  for a in np.nonzero(inside.reshape(ey, ex)))
        grid, fg = self._scatter(torch.cat(feats)[None], oy, ox)
        return self._labels_from_grid(grid, fg)[0]

    def _dense_plan(self, wsi_shape, positions, pad_offset: int = 0):
        """:func:`fit_dense_lattice` for this registrar's lattice and window."""
        return fit_dense_lattice(positions, self.h_st, self.w_st, self.window_size,
                                 wsi_shape, pad_offset)

    def dense_plan(self, wsi, positions, pad_offset: int = 0):
        """The dense-lattice plan for these inputs, or None when
        :meth:`register_dense` would not take them (a hex registrar, or a
        lattice that is irregular, sparse or leaves the image). Pass it back
        as ``register_dense(plan=...)`` to skip the refit (two least-squares
        fits over every in-tissue bin)."""
        if self.hex_coords:
            return None
        return self._dense_plan(tuple(wsi.shape), positions, pad_offset)

    def dense_applicable(self, wsi, positions, pad_offset: int = 0) -> bool:
        """True when :meth:`register_dense` takes these inputs."""
        return self.dense_plan(wsi, positions, pad_offset) is not None

    @torch.inference_mode()
    def register_dense(self, wsi, positions, pad_offset: int = 0,
                       plan=None) -> np.ndarray:
        """Register a dense square bin lattice (Visium HD).

        Integer-pitch lattices (pitch == ``window_size``: the bins' crops
        tile the lattice) register through the per-bin route (``__call__``);
        fractional-pitch lattices through the banded resample of the exact
        bin extents, with no per-bin gather. Bins missing from
        ``positions`` are background.

        Needs ``hex_coords=False``; raises ValueError for positions that are
        not a dense regular lattice (use ``__call__`` there, or
        :meth:`dense_applicable` first). ``plan``: a :meth:`dense_plan`
        result, which skips the refit.

        Returns:
          (h_st, w_st) int32 label grid.
        """
        if self.hex_coords:
            raise ValueError("register_dense needs a square lattice (hex_coords=False)")
        wsi = self._to_device_slides(wsi, 3)
        if plan is None:
            plan = self._dense_plan(tuple(wsi.shape), positions, pad_offset)
        if plan is None:
            raise ValueError("positions are not a dense regular lattice (or it leaves "
                             "the image); use the per-bin registration path "
                             "(__call__) instead")
        if plan[0] == "exact":
            # the pitch is the window: the per-bin crops tile the lattice;
            # the gather takes them in a small share of f's time, and f
            # runs on the in-tissue bins only
            return self(wsi, positions, pad_offset)
        _, y0, x0, py, px, fg, h_band, ey, ex = plan
        labels = self._register_dense_resampled(wsi, y0, x0, py, px, fg, h_band, ey, ex)
        return labels.cpu().numpy()

    # -- host-side preparation ---------------------------------------------

    def _to_device_slides(self, wsi, ndim: int) -> torch.Tensor:
        wsi = torch.as_tensor(wsi).to(self.device)
        if wsi.dtype != torch.uint8 or wsi.dim() != ndim or wsi.shape[-1] != 3:
            want = "(N, H, W, 3)" if ndim == 4 else "(H, W, 3)"
            raise ValueError(f"expected {want} uint8 slide(s), got "
                             f"{tuple(wsi.shape)} {wsi.dtype}")
        return wsi.contiguous()

    def _spot_arrays(self, wsi_shape, positions, pad_offset):
        oy, ox, y_px, x_px = spot_pixel_arrays(positions, self.h_st, self.w_st,
                                               self.hex_coords)
        y_px, x_px = _clamp_centers(y_px, x_px, wsi_shape, self.window_size,
                                    pad_offset)
        return oy, ox, y_px, x_px

    def _padded_spots(self, wsi_shape, positions_list, pad_offset):
        """Per-slide spot arrays padded with parked spots to one common
        bucket-rounded length: four (B, S) int64 tensors on the device."""
        per = [self._spot_arrays(wsi_shape, p, pad_offset) for p in positions_list]
        n = len(per)
        # max(..., 1): an all-background batch still gets one parked column
        s_max = max(len(a[0]) for a in per)
        s_pad = -(-max(s_max, 1) // _SPOT_BUCKET) * _SPOT_BUCKET
        arrays = [np.tile(a, (n, 1)) for a in
                  _parked_spots(s_pad, self.h_st, self.window_size // 2)]
        for i, spots in enumerate(per):
            k = len(spots[0])
            for dst, src in zip(arrays, spots):
                dst[i, :k] = src
        return [torch.as_tensor(a.astype(np.int64), device=self.device)
                for a in arrays]

    def _prepared_inputs(self, wsi, positions, pad_offset: int):
        """Shared single-slide preamble of ``__call__`` and
        ``register_logits``: the slide on the device and its bucket-padded
        (S,) spot arrays."""
        wsi = self._to_device_slides(wsi, 3)
        oy, ox, y_px, x_px = self._padded_spots(wsi.shape, [positions], pad_offset)
        return wsi, oy[0], ox[0], y_px[0], x_px[0]

    # -- public entry points -----------------------------------------------

    @torch.inference_mode()
    def __call__(self, wsi, positions, pad_offset: int = 0) -> np.ndarray:
        """Register one slide.

        Args:
          wsi: (H, W, 3) uint8 image (tensor or numpy) in original pixel
            coordinates; spots within half a patch of the border read
            border-clamped pixels. Pass ``pad_offset`` if the image was
            pre-padded.
          positions: :class:`~gridnext_tpu_torch.io.spaceranger.Positions`.

        Returns:
          (h_st, w_st) int32 label grid, 0 background / 1..C foreground.
        """
        labels = self._register(*self._prepared_inputs(wsi, positions, pad_offset))
        return labels.cpu().numpy()

    @torch.inference_mode()
    def register_logits(self, wsi, positions, pad_offset: int = 0):
        """Register one slide, returning the corrector's class logits:
        ``((h_st, w_st, C) float32 logits, (h_st, w_st) int32 fg mask)``."""
        logits, fg = self._register_logits(
            *self._prepared_inputs(wsi, positions, pad_offset))
        return logits.cpu().numpy(), fg.cpu().numpy()

    @torch.inference_mode()
    def register_batch(self, wsis, positions_list: Sequence,
                       pad_offset: int = 0) -> np.ndarray:
        """Register N same-shape slides in one pass.

        Per-slide spot arrays pad to a common bucket-rounded length (padded
        entries park outside the lattice and the scatter drops them), and f
        sees the spots of all N slides as one batch.

        Args:
          wsis: (N, H, W, 3) uint8 stack of equally sized slides.
          positions_list: one Positions per slide.

        Returns:
          (N, h_st, w_st) int32 label grids.
        """
        wsis = self._to_device_slides(wsis, 4)
        n = len(positions_list)
        if wsis.shape[0] != n:
            raise ValueError(f"{wsis.shape[0]} slides vs {n} position sets")
        spots = self._padded_spots(wsis.shape[1:], positions_list, pad_offset)
        return self._register_batch(wsis, *spots).cpu().numpy()

    # -- exported artifacts --------------------------------------------------

    def spot_inputs(self, wsi_shape, positions, n_spots: int, pad_offset: int = 0):
        """Fixed-length ``(oy, ox, y_px, x_px)`` int32 numpy inputs of one
        slide for an :meth:`export` artifact, padded to exactly ``n_spots``
        with parked spots, as :meth:`register_batch` pads."""
        return artifact_spot_inputs(
            wsi_shape, positions, n_spots, window_size=self.window_size, h_st=self.h_st,
            w_st=self.w_st, hex_coords=self.hex_coords, pad_offset=pad_offset)

    def export(self, wsi_shape, n_spots: int, platforms=None) -> bytes:
        """The registration of one slide as a ``torch.export`` artifact.

        Returns the bytes of a ``.pt2`` file (``torch.export.save``) of
        ``(wsi, oy, ox, y_px, x_px) -> (h_st, w_st) int32 labels``: the
        crop, f, the scatter and the corrector with the labels, the weights
        in the file and the kernels as ``gridnext::`` custom ops. Reload it
        with :func:`load_exported_registration`, which builds no model.
        Shapes are static: ``wsi_shape`` = (H, W, 3) uint8 and ``n_spots``
        int32 spots (:meth:`spot_inputs`). The artifact runs on this
        registrar's device only (``platforms`` naming another raises).
        """
        self._check_no_mesh()
        check_export_platforms(self.device, platforms)
        if len(wsi_shape) != 3 or wsi_shape[-1] != 3:
            raise ValueError(f"wsi_shape must be (H, W, 3); got {wsi_shape}")
        # distinct example tensors: export would take aliased ones for one input
        spots = [torch.zeros((int(n_spots),), dtype=torch.int32, device=self.device)
                 for _ in range(4)]
        args = (torch.zeros(tuple(map(int, wsi_shape)), dtype=torch.uint8,
                            device=self.device), *spots)
        return _export(lambda wsi, oy, ox, y, x: self._register(
            wsi, oy.long(), ox.long(), y.long(), x.long()),
            (self.f_apply, self.corrector_apply), args)

    def _check_no_mesh(self) -> None:
        if self.mesh is not None:
            raise ValueError("export serializes the single-device path; "
                             "build the registrar with mesh=None")

    def _register_dense(self, wsi, oy0, ox0, fg, ey: int, ex: int):
        """An exact integer-pitch lattice: the ``(ey, ex)`` extent's bins
        crop at ``(oy0, ox0) + index * window`` in one gather, f runs on
        them all, and bins outside the in-tissue mask ``fg`` take f(zero
        patch), as in the per-bin scatter. The JAX package's
        ``_register_dense`` (a slice of the extent there)."""
        w = self.window_size
        iy = torch.arange(ey, device=self.device).repeat_interleave(ex)
        ix = torch.arange(ex, device=self.device).repeat(ey)
        crops = gather_patches(wsi[None], oy0 + iy * w, ox0 + ix * w, w)
        feats = self._apply_f(crops).reshape(ey, ex, -1)
        feats = torch.nn.functional.pad(feats, (0, 0, 0, self.w_st - ex, 0, self.h_st - ey))
        fg = fg.to(torch.int32)
        grid = torch.where(fg[..., None] > 0, feats, self._bg_vec().to(feats.dtype))
        return self._labels_from_grid(grid[None].contiguous(), fg[None])[0]

    def export_dense(self, wsi_shape, ey: int, ex: int, platforms=None) -> bytes:
        """The exact-pitch dense registration of :meth:`register_dense` as a
        ``torch.export`` artifact for a fixed ``wsi_shape`` and in-tissue bin
        extent ``(ey, ex)`` (from :meth:`dense_plan`'s ``("exact", oy0, ox0,
        fg, ey, ex)``). The loaded program takes ``(wsi, oy0, ox0, fg)``:
        the slide, the top-left pixel of bin (0, 0) as int32 scalars, and
        the (h_st, w_st) int32 in-tissue mask."""
        self._check_no_mesh()
        check_export_platforms(self.device, platforms)
        if self.hex_coords:
            raise ValueError("export_dense needs a square-lattice registrar "
                             "(hex_coords=False)")
        if len(wsi_shape) != 3 or wsi_shape[-1] != 3:
            raise ValueError(f"wsi_shape must be (H, W, 3); got {wsi_shape}")
        oy0, ox0 = (torch.zeros((), dtype=torch.int32, device=self.device) for _ in range(2))
        args = (torch.zeros(tuple(map(int, wsi_shape)), dtype=torch.uint8,
                            device=self.device), oy0, ox0,
                torch.zeros((self.h_st, self.w_st), dtype=torch.int32, device=self.device))
        ey, ex = int(ey), int(ex)
        return _export(lambda wsi, oy0, ox0, fg: self._register_dense(
            wsi, oy0.long(), ox0.long(), fg, ey, ex), (self.f_apply, self.corrector_apply), args)


def dispatch_group(registrar: SlideRegistrar, items, *, timer=None, plans=None,
                   stats=None):
    """Register one same-shape group of slides.

    On a square lattice, slides with a dense plan register one at a time
    through :meth:`SlideRegistrar.register_dense` and come out first; the
    plan (:meth:`SlideRegistrar.dense_plan`), not an exception, decides.
    Of the rest, a single slide goes through ``registrar(wsi, positions)``
    and a larger group is stacked on the device into one
    :meth:`SlideRegistrar.register_batch`.

    Args:
      items: sequence of ``(key, wsi, positions)``; ``key`` passes through
        untouched (a slide index, a request handle, ...).
      timer: optional :class:`~gridnext_tpu_torch.observability.StageTimer`;
        registration runs under ``timer("register")``.
      plans: optional ``{key: dense plan or None}`` fitted by the caller;
        keys present skip the fit here (None: not a dense lattice). Read
        on square lattices only.
      stats: optional dict; ``stats['batched']`` grows by the number of
        slides that went through ``register_batch``.

    Returns:
      list of ``(key, labels, positions)`` per item: the dense-routed items
      first, then the rest, each in order.
    """
    out = []
    if not registrar.hex_coords:
        rest = []
        for key, wsi, pos in items:
            plan = (plans[key] if plans is not None and key in plans
                    else registrar.dense_plan(wsi, pos))
            if plan is None:
                rest.append((key, wsi, pos))
                continue
            with stage(timer, "register"):
                out.append((key, registrar.register_dense(wsi, pos, plan=plan), pos))
        items = rest
        if not items:
            return out
    if len(items) == 1:
        key, wsi, pos = items[0]
        with stage(timer, "register"):
            return out + [(key, registrar(wsi, pos), pos)]
    keys, wsis, poss = zip(*items)
    with stage(timer, "register"):
        labels = registrar.register_batch(torch.stack(
            [torch.as_tensor(w, device=registrar.device) for w in wsis]), list(poss))
    if stats is not None:
        stats["batched"] = stats.get("batched", 0) + len(keys)
    return out + [(k, labels[j], p) for j, (k, p) in enumerate(zip(keys, poss))]


def register_slides(registrar: SlideRegistrar, image_files: Sequence,
                    spaceranger_dirs: Sequence, *, hd_binning=None,
                    slide_batch: int = 4, prefetch: Optional[int] = None,
                    source=None, stats=None):
    """Register a cohort of slide files with decode, staging and
    registration overlapped: the serving loop of the ``register`` command.

    Drives a :class:`~gridnext_tpu_torch.ingest.SlideSource` (decode on a
    background thread, pinned memory, an asynchronous copy to the card on a
    stream of its own) into the registrar, grouping same-shape slides into
    :meth:`SlideRegistrar.register_batch` calls of up to ``slide_batch``
    slides, so the card registers one batch while the host decodes and
    stages the next.

    Yields ``(index, label_grid, positions)`` per slide as each dispatch
    completes. Shape grouping may reorder slides across groups: ``index``
    (the position in ``image_files``) identifies each result. Per-stage
    seconds land in ``source.timer`` (decode / pin / positions / stage /
    register).

    Args:
      registrar: a :class:`SlideRegistrar`; on a square lattice, slides with
        a dense plan register through :meth:`SlideRegistrar.register_dense`
        (:func:`dispatch_group`).
      image_files: fullres slide images, one per array.
      spaceranger_dirs: matching Spaceranger dirs (positions per slide).
      hd_binning: the Visium HD binning whose positions parquet to read
        (e.g. ``"square_016um"``); None for Visium positions CSVs.
      slide_batch: most slides per ``register_batch`` call, and the cap on
        slides held across shape groups: at the cap the largest partial
        group registers even though it is not full. Leftover groups register
        at their size (a single slide through ``registrar(wsi, pos)``).
      prefetch: SlideSource queue depth (default ``slide_batch + 1``, so the
        next full batch decodes behind the current one).
      source: a pre-built SlideSource (image_files / spaceranger_dirs /
        hd_binning / prefetch are then ignored).
      stats: optional dict, passed to :func:`dispatch_group`.
    """
    if source is None:
        from gridnext_tpu_torch.ingest import SlideSource

        source = SlideSource(image_files, spaceranger_dirs, hd_binning=hd_binning,
                             prefetch=prefetch or slide_batch + 1,
                             device=registrar.device)
    timer = source.timer

    # Shape grouping must not hold unbounded device memory: a mixed-shape
    # cohort may never fill any one group, so the slides held across groups
    # are capped at slide_batch; at the cap the largest partial group goes.
    groups: dict = {}
    held = 0
    for i, wsi, pos in source:
        key = tuple(wsi.shape)
        groups.setdefault(key, []).append((i, wsi, pos))
        held += 1
        if len(groups[key]) >= slide_batch:
            key_to_flush = key
        elif held >= slide_batch:
            key_to_flush = max(groups, key=lambda k: len(groups[k]))
        else:
            continue
        group = groups.pop(key_to_flush)
        held -= len(group)
        yield from dispatch_group(registrar, group, timer=timer, stats=stats)
    for group in groups.values():
        if group:
            yield from dispatch_group(registrar, group, timer=timer, stats=stats)


def register_mm_grid(model, x_image, x_count_raw, count_transform: Optional[Callable] = None,
                     device="cuda", timer=None) -> np.ndarray:
    """Register one slide with a multimodal ``GridNetHexMM`` (Visium hex) or
    ``GridNetMM`` (a square lattice).

    Args:
      model: a ``GridNetHexMM`` or ``GridNetMM`` (e.g. from
        ``modeldir.mm_model_from_meta``); it is moved to ``device`` (in
        place).
      x_image: ``(H, W, P, P, 3)`` float32 patch grid, ``/255`` patches at
        the spots' cells and zeros elsewhere (as the JAX datasets build it);
        a tensor already on ``device`` is used as it is, without a copy.
      x_count_raw: ``(H, W, G)`` raw count grid (numpy).
      count_transform: maps raw counts to the count f's input
        (``modeldir.scbert_transform`` for an scBERT count f, ``np.log1p``),
        or None.
      device: where the forward runs; 'cuda' (default) raises without CUDA.
      timer: optional StageTimer: ``"count transform"`` and ``"forward"``
        (the labels back on the host).

    Returns:
      (H, W) int32 labels: argmax + 1 of the corrector's logits where the
      raw counts of a cell are nonzero (the tissue), 0 elsewhere.
    """
    device = resolve_device(device)
    x_count_raw = np.asarray(x_count_raw, np.float32)
    fg = x_count_raw.sum(-1) > 0        # the tissue, from the raw counts
    with stage(timer, "count transform"):
        x_count = (count_transform(x_count_raw) if count_transform is not None
                   else x_count_raw)
    model.to(device)
    with stage(timer, "forward"), torch.no_grad():
        xi = torch.as_tensor(x_image, dtype=torch.float32, device=device)
        xc = torch.as_tensor(x_count, dtype=torch.float32, device=device)
        logits = model((xi[None], xc[None]))[0]
        labels = (torch.argmax(logits, dim=-1) + 1).to(torch.int32).cpu().numpy()
    return np.where(fg, labels, 0).astype(np.int32)


def export_grid_forward(model, grid_shapes, platforms=None,
                        explicit_fg: bool = False) -> bytes:
    """A count or multimodal grid model's registration forward as a
    ``torch.export`` artifact: ``argmax(model(x)) + 1`` where the tissue
    is, 0 elsewhere, over fixed-shape float32 input grids, the weights in
    the file (the bytes of one ``.pt2``; reload with
    :func:`load_exported_registration`).

    ``model``: a grid model with its weights (``GridNet[Hex]`` of a count
    f, ``GridNetHexMM`` / ``GridNetMM``), in eval mode on the device the
    artifact targets. ``grid_shapes``: one ``(H, W, C)`` tuple, or a
    sequence of them (image, count) for the multimodal models; the program
    takes them batched as ``(1, H, W, ...)``. The tissue is any nonzero
    feature of the (last) count grid, or, with ``explicit_fg``, a trailing
    ``(1, H, W)`` int32 mask input: needed where the counts come
    pre-transformed by a map that zeroes a tissue cell (scBERT's gene2vec
    reindex), as in the JAX package's ``export_grid_forward``.
    """
    device = next(model.parameters()).device
    check_export_platforms(device, platforms)
    single = bool(len(grid_shapes)) and np.ndim(grid_shapes[0]) == 0
    shapes = (grid_shapes,) if single else tuple(grid_shapes)
    args = [torch.zeros((1,) + tuple(map(int, s)), dtype=torch.float32, device=device)
            for s in shapes]
    n_grids = len(args)
    if explicit_fg:
        args.append(torch.zeros((1, int(shapes[0][0]), int(shapes[0][1])),
                                dtype=torch.int32, device=device))
    model.eval()

    def forward(*xs):
        grids = xs[:n_grids]
        logits = model(grids[0] if single else tuple(grids))
        labels = torch.argmax(logits, dim=-1).to(torch.int32) + 1
        fg = (xs[-1] > 0) if explicit_fg else (grids[-1] != 0).any(dim=-1)
        return torch.where(fg, labels, torch.zeros_like(labels))

    return _export(forward, (model,), args)


def label_parity_report(want, got, logits, *, rel_tol: float = 1e-2,
                        abs_tol: float = 1e-3) -> int:
    """Assert two label grids agree except at near-ties of ``logits``.

    Two separately computed label grids (a kernel and its plain version, or
    the port and the JAX package) may flip an argmax where the top-2 logits
    are within float noise. The contract:

    - the grids agree everywhere except possibly where the reference's top-2
      logit margin is below ``abs_tol + rel_tol * scale``;
    - a flipped site lands on the reference's top-1 or runner-up class;
    - background/foreground (label 0 vs > 0) match exactly.

    Args:
      want: (H, W) reference label grid.
      got: (H, W) label grid under test.
      logits: (H, W, C) class logits of the reference path.

    Returns:
      the number of tolerated near-tie flips (0 = exact agreement).

    Raises:
      AssertionError: a structural mismatch or an over-tolerance flip.
    """
    want = np.asarray(want)
    got = np.asarray(got)
    logits = np.asarray(logits, np.float32)
    if not ((want > 0) == (got > 0)).all():
        bad = np.argwhere((want > 0) != (got > 0))
        raise AssertionError(
            f"background/foreground mismatch at {len(bad)} sites (first: "
            f"{bad[0].tolist()})")
    mism = want != got
    n_flips = int(mism.sum())
    if n_flips == 0:
        return 0
    order = np.argsort(logits, axis=-1)
    top1, top2 = order[..., -1], order[..., -2]
    v1 = np.take_along_axis(logits, top1[..., None], -1)[..., 0]
    v2 = np.take_along_axis(logits, top2[..., None], -1)[..., 0]
    margin = v1 - v2
    tol = abs_tol + rel_tol * np.maximum(np.abs(v1), np.abs(v2))
    wide = mism & (margin > tol)
    if wide.any():
        y, x = np.argwhere(wide)[0]
        raise AssertionError(
            f"{int(wide.sum())}/{n_flips} label flips exceed the near-tie "
            f"margin (first at ({y},{x}): want {want[y, x]} got {got[y, x]}"
            f", margin {margin[y, x]:.4g} > tol {tol[y, x]:.4g})")
    not_runner_up = mism & (got != top2 + 1) & (got != top1 + 1)
    if not_runner_up.any():
        y, x = np.argwhere(not_runner_up)[0]
        raise AssertionError(
            f"flip at ({y},{x}) to label {got[y, x]} which is neither the "
            f"top-1 ({top1[y, x] + 1}) nor runner-up ({top2[y, x] + 1}) class")
    return n_flips
