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

A cohort of slide files registers through :func:`register_slides`, which
overlaps decoding and staging (:class:`~gridnext_tpu_torch.ingest.SlideSource`)
with registration and batches same-shape slides (:func:`dispatch_group`).
Multimodal model directories (a count f beside an image f) register
pre-built image and count grids with :func:`register_mm_grid`.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without CUDA they raise rather than carry on on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.ops.hexcorrector_cuda import (
    CORRECTOR_RELU_FLAGS, as_f32_tensors, fused_hex_corrector,
    fused_hex_corrector_labels)
from gridnext_tpu_torch.ops.patch_gather_cuda import gather_patches
from gridnext_tpu_torch.pipeline import (_spot_pixel_boxes, imagenet_normalize,
                                         resize_matrices, resize_patches)

# Padded spot arrays round up to a multiple of this (the JAX package's
# compile-sharing bucket; kept so both pad the same way).
_SPOT_BUCKET = 128


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def spot_pixel_arrays(positions, h_st: int = geometry.VISIUM_H_ST,
                      w_st: int = geometry.VISIUM_W_ST):
    """Positions -> (oddr_y, oddr_x, y_px, x_px) arrays over in-tissue spots
    inside the lattice (pixel coords not yet offset for padding)."""
    ox, oy, x_px, y_px = _spot_pixel_boxes(positions, window=0)
    # lower bounds too: a malformed-parity spot's odd-right x of -1 must not
    # land on the last grid column
    keep = (oy >= 0) & (ox >= 0) & (oy < h_st) & (ox < w_st)
    return (oy[keep], ox[keep],
            y_px[keep].astype(np.int32), x_px[keep].astype(np.int32))


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


class SlideRegistrar:
    """Full-slide registration: image -> label grid.

    Args:
      f_apply: ``f_apply(patches (N, P, P, 3) float) -> (N, f_dim)``: the
        spot classifier (a module or any callable, such as
        :func:`~gridnext_tpu_torch.ops.denseblock_cuda.build_densenet_fused_infer`'s
        ``infer``) on ``device``.
      corrector_kernels/biases/relu_flags: folded hex-corrector weights
        (:func:`~gridnext_tpu_torch.ops.hexcorrector_cuda.fold_corrector_params`).
      patch_size: patch side in pixels.
      window_size: crop window side (default ``patch_size``); other sizes
        are resized to ``patch_size`` (cubic, antialiased, as the JAX
        package's ``jax.image.resize``).
      normalize: 'imagenet' or None (``/255`` only).
      patch_chunk: f runs over the spot axis in chunks of this size.
      device: where registration runs; 'cuda' (default) raises without CUDA.
    """

    def __init__(self, f_apply: Callable, corrector_kernels, corrector_biases,
                 relu_flags=CORRECTOR_RELU_FLAGS, *, patch_size: int = 128,
                 window_size: Optional[int] = None,
                 normalize: Optional[str] = "imagenet",
                 patch_chunk: Optional[int] = 624,
                 device="cuda"):
        self.device = resolve_device(device)
        if not corrector_kernels:
            raise ValueError("the hex corrector needs corrector_kernels/"
                             "corrector_biases (fold_corrector_params or "
                             "from_gridnet)")
        if normalize not in (None, "imagenet"):
            raise ValueError(f"unknown normalize {normalize!r}")
        self.f_apply = f_apply
        self.kernels = as_f32_tensors(corrector_kernels, self.device)
        self.biases = as_f32_tensors(corrector_biases, self.device)
        self.relu_flags = tuple(relu_flags)
        self.patch_size = patch_size
        self.window_size = window_size or patch_size
        # the resize's weight matrices, built once (None: no resize)
        self._resize = (None if self.window_size == patch_size else resize_matrices(
            self.window_size, self.window_size, patch_size, self.device))
        self.normalize = normalize
        self.patch_chunk = patch_chunk
        self.h_st, self.w_st = geometry.VISIUM_H_ST, geometry.VISIUM_W_ST

    @classmethod
    def from_gridnet(cls, model, *, patch_size: int = 128,
                     normalize: Optional[str] = "imagenet", device="cuda", **kw):
        """Build from a :class:`~gridnext_tpu_torch.models.GridNetHex` with
        its weights loaded. The corrector's BatchNorm folds into its hex
        weights; f moves to ``device`` and into eval mode (in place)."""
        device = resolve_device(device)
        kernels, biases, relu_flags = model.corrector.folded()
        f = model.patch_classifier.to(device).eval()
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

    def _apply_f(self, crops: torch.Tensor) -> torch.Tensor:
        """uint8 window crops -> (N, f_dim); resizes, normalizes and runs f
        chunk by chunk, so only one chunk of float patches is alive at a
        time."""
        chunk = self.patch_chunk or crops.shape[0]
        return torch.cat([
            self.f_apply(self._normalize(
                resize_patches(part, self.patch_size, self._resize)))
            for part in torch.split(crops, chunk)])

    def _bg_vec(self) -> torch.Tensor:
        # Background cells carry f(zero patch): in training grids background
        # cells are literal zeros, so the corrector learned its boundary
        # context from f(0). The zero patch therefore skips normalization.
        bg = torch.zeros((1, self.patch_size, self.patch_size, 3),
                         dtype=torch.float32, device=self.device)
        return self.f_apply(bg)[0]

    def _labels_from_grid(self, grid, fg):
        """(B, H, W, f_dim) grid + (B, H, W) fg mask -> (B, H, W) labels."""
        return fused_hex_corrector_labels(grid, fg, self.kernels, self.biases,
                                          self.relu_flags)

    def _grid_fg(self, wsis, oy, ox, y_px, x_px):
        """(B, H, W, 3) slides + (B, S) spot arrays -> ((B, h_st, w_st, f_dim)
        f-output grid, (B, h_st, w_st) int32 fg mask)."""
        b, s = oy.shape
        slide = torch.arange(b, device=self.device).repeat_interleave(s)
        crops = self._extract_flat(wsis, y_px.reshape(-1), x_px.reshape(-1), slide)
        feats = self._apply_f(crops).reshape(b, s, -1)
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
        logits = fused_hex_corrector(grid, self.kernels, self.biases,
                                     self.relu_flags)
        return logits[0].float(), fg[0]

    def _register_batch(self, wsis, oy, ox, y_px, x_px):
        """(B, H, W, 3) slides + (B, S) padded spot arrays -> (B, h, w)."""
        grid, fg = self._grid_fg(wsis, oy, ox, y_px, x_px)
        return self._labels_from_grid(grid, fg)

    # -- host-side preparation ---------------------------------------------

    def _to_device_slides(self, wsi, ndim: int) -> torch.Tensor:
        wsi = torch.as_tensor(wsi).to(self.device)
        if wsi.dtype != torch.uint8 or wsi.dim() != ndim or wsi.shape[-1] != 3:
            want = "(N, H, W, 3)" if ndim == 4 else "(H, W, 3)"
            raise ValueError(f"expected {want} uint8 slide(s), got "
                             f"{tuple(wsi.shape)} {wsi.dtype}")
        return wsi.contiguous()

    def _spot_arrays(self, wsi_shape, positions, pad_offset):
        oy, ox, y_px, x_px = spot_pixel_arrays(positions, self.h_st, self.w_st)
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


def _tctx(timer, stage: str):
    """``timer(stage)``, or a no-op context without a timer."""
    if timer is None:
        import contextlib

        return contextlib.nullcontext()
    return timer(stage)


def dispatch_group(registrar: SlideRegistrar, items, *, timer=None, stats=None):
    """Register one same-shape group of slides.

    A single slide goes through ``registrar(wsi, positions)``; a larger group
    is stacked on the device into one :meth:`SlideRegistrar.register_batch`.
    (The JAX package also routes square-lattice slides through its dense
    tiling path here; the port's registrar has no square lattice yet,
    ``ROADMAP.md`` Queue 1 item 3.)

    Args:
      items: sequence of ``(key, wsi, positions)``; ``key`` passes through
        untouched (a slide index, a request handle, ...).
      timer: optional :class:`~gridnext_tpu_torch.observability.StageTimer`;
        registration runs under ``timer("register")``.
      stats: optional dict; ``stats['batched']`` grows by the number of
        slides that went through ``register_batch``.

    Returns:
      list of ``(key, labels, positions)`` per item, in order.
    """
    if len(items) == 1:
        key, wsi, pos = items[0]
        with _tctx(timer, "register"):
            return [(key, registrar(wsi, pos), pos)]
    keys, wsis, poss = zip(*items)
    with _tctx(timer, "register"):
        labels = registrar.register_batch(torch.stack(
            [torch.as_tensor(w, device=registrar.device) for w in wsis]), list(poss))
    if stats is not None:
        stats["batched"] = stats.get("batched", 0) + len(keys)
    return [(k, labels[j], p) for j, (k, p) in enumerate(zip(keys, poss))]


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
      registrar: a :class:`SlideRegistrar` (hex lattice).
      image_files: fullres slide images, one per array.
      spaceranger_dirs: matching Spaceranger dirs (positions per slide).
      hd_binning: Visium HD binned outputs (not ported yet: raises).
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
                     device="cuda") -> np.ndarray:
    """Register one slide with a multimodal ``GridNetHexMM``.

    Args:
      model: a ``GridNetHexMM`` (e.g. from ``modeldir.mm_model_from_meta``);
        it is moved to ``device`` (in place).
      x_image: ``(H, W, P, P, 3)`` float32 patch grid, ``/255`` patches at
        the spots' cells and zeros elsewhere (as the JAX datasets build it).
      x_count_raw: ``(H, W, G)`` raw count grid (numpy).
      count_transform: maps raw counts to the count f's input
        (``modeldir.scbert_transform`` for an scBERT count f), or None.
      device: where the forward runs; 'cuda' (default) raises without CUDA.

    Returns:
      (H, W) int32 labels: argmax + 1 of the corrector's logits where the
      raw counts of a cell are nonzero (the tissue), 0 elsewhere.
    """
    device = resolve_device(device)
    x_count_raw = np.asarray(x_count_raw, np.float32)
    fg = x_count_raw.sum(-1) > 0
    x_count = count_transform(x_count_raw) if count_transform is not None else x_count_raw
    model.to(device)
    with torch.no_grad():
        xi = torch.as_tensor(x_image, dtype=torch.float32, device=device)
        xc = torch.as_tensor(x_count, dtype=torch.float32, device=device)
        logits = model((xi[None], xc[None]))[0]
        labels = (torch.argmax(logits, dim=-1) + 1).to(torch.int32).cpu().numpy()
    return np.where(fg, labels, 0).astype(np.int32)


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
