"""Host ingest: decode slides ahead and stage them onto the card.

Registering a cohort is three stages of very different cost:

  decode (host CPU, JPEG)  ->  copy to the card (PCIe)  ->  register (card)

:class:`SlideSource` overlaps them, as the JAX package's ``ingest`` does: a
background thread decodes slide N+1 while slide N is copied and slide N-1
registers. On the card the copy is asynchronous:

* the decode thread copies each decoded slide into a page-locked (pinned)
  host buffer, taken from a pool that is reused across slides (pinning a
  0.25 GB slide afresh would cost tens of ms);
* the decode thread also issues the host-to-card copy with
  ``non_blocking=True`` on a staging stream (one per card, kept for the
  process) and records an event after it, so the copy runs while the
  consumer's registration runs; the pinned buffer goes back to the pool,
  to be refilled only once that event has passed;
* before a slide is handed out, the consumer's stream waits on its event,
  and the slide's memory is marked as used by that stream
  (``record_stream``), so the caching allocator cannot give it to the next
  slide while the registration still reads it.

Prefetch is bounded: at most ``prefetch`` staged slides wait in the queue
(on the card, or on the host for the CPU) and the decode thread holds one
more. On the CPU (``device="cpu"``) staging is ``torch.from_numpy``: no
pinning, no stream.

Typical use::

    registrar = SlideRegistrar.from_gridnet(model)
    source = SlideSource(image_files, spaceranger_dirs)
    for i, wsi, positions in source:
        labels = registrar(wsi, positions)
    print(source.timer.report())          # per-stage seconds
    print(source.throughput())            # decode / stage GB/s
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch.observability import StageTimer


def decode_slide(image_file, convert: str = "RGB") -> np.ndarray:
    """Decode one slide to (H, W, 3) uint8 (every mode converts: the gather
    expects 3 channels).

    The file's first bytes pick the reader: a JPEG decodes with the port's
    codec (:func:`gridnext_tpu_torch.io.jpeg.read_jpeg`: baseline,
    progressive or lossless, Huffman- or arithmetic-coded, gray, YCbCr,
    RGB, CMYK or YCCK, any chroma sampling), a TIFF or BigTIFF with
    :func:`gridnext_tpu_torch.io.tiff.read_tiff` (1- to 16-bit and float
    gray, 8- and 16-bit RGB, RGBA and CMYK, CIELab, palette, ...) and a PNG
    with :func:`gridnext_tpu_torch.io.png.read_png` (every depth, Adam7);
    each gives Pillow's mode and array, converted once by
    :func:`gridnext_tpu_torch.io.pillow_modes.to_rgb`, so the pixels are
    ``np.asarray(Image.open(f).convert("RGB"))``'s, without PIL. A file of
    those formats that its reader refuses (as Pillow refuses it: a 12-bit
    or hierarchical JPEG, an ICCLab TIFF, a truncated file, ...) raises
    ``ValueError`` naming the file, and never reaches PIL. Other formats (BMP, WebP, ...) decode with PIL, and
    without PIL raise ``ImportError``.
    """
    from gridnext_tpu_torch.io import pillow_modes
    from gridnext_tpu_torch.io.jpeg import read_jpeg
    from gridnext_tpu_torch.io.png import SIGNATURE, read_png
    from gridnext_tpu_torch.io.tiff import HEADERS, read_tiff

    if convert == "RGB":
        with open(image_file, "rb") as fh:
            head = fh.read(8)
        if head[:3] == b"\xff\xd8\xff":
            return pillow_modes.to_rgb(*read_jpeg(image_file))
        if head[:4] in HEADERS:
            return pillow_modes.to_rgb(*read_tiff(image_file))
        if head == SIGNATURE:
            return pillow_modes.to_rgb(*read_png(image_file))
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{image_file}: slides other than JPEG, TIFF and PNG decode with "
                          "PIL, which is not installed") from e

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(image_file) as im:
        return np.asarray(im.convert(convert))


# One staging stream per card for the process. The caching allocator keeps
# the memory of a freed staged slide for the stream that allocated it, so a
# new stream per source would pay a fresh cudaMalloc for each of its first
# slides (~26 ms for a 0.25 GB slide on an H100).
_STAGING_STREAMS: dict = {}
_STAGING_LOCK = threading.Lock()


def _staging_stream(device: torch.device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _STAGING_LOCK:
        if index not in _STAGING_STREAMS:
            _STAGING_STREAMS[index] = torch.cuda.Stream(device=index)
        return _STAGING_STREAMS[index]


class _PinnedPool:
    """Page-locked host buffers, reused across slides.

    At most ``size`` buffers exist at once, over all shapes: a buffer of a
    shape no longer asked for is dropped for one of the new shape, so a
    cohort of distinct scan sizes does not pin a buffer set per size. A
    buffer comes back with the event of the copy that reads it and is
    handed out again only after that event has passed.
    """

    def __init__(self, size: int):
        self.size = size
        self.free = collections.deque()     # (buffer, event or None)
        self.count = 0
        self.cond = threading.Condition()

    def acquire(self, shape, stop: threading.Event) -> Optional[torch.Tensor]:
        """A buffer of ``shape``, or None once ``stop`` is set."""
        buf = old = None
        with self.cond:
            while True:
                match = next((k for k, (b, _) in enumerate(self.free)
                              if tuple(b.shape) == shape), None)
                if match is not None:
                    buf, event = self.free[match]
                    del self.free[match]
                    break
                if self.count < self.size:
                    self.count += 1
                    event = None
                    break
                if self.free:
                    # the oldest idle buffer of another shape makes room
                    old, event = self.free.popleft()
                    break
                if stop.is_set():
                    return None
                self.cond.wait(0.2)
        if event is not None:
            event.synchronize()
        del old
        if buf is None:
            buf = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
        return buf

    def release(self, buf: torch.Tensor, event=None) -> None:
        with self.cond:
            self.free.append((buf, event))
            self.cond.notify()


class SlideSource:
    """Iterate ``(index, staged_wsi, positions)`` with overlapped stages.

    Args:
      image_files: fullres slide images, one per array.
      spaceranger_dirs: optional matching Spaceranger dirs; when given, each
        item carries the array's :class:`~gridnext_tpu_torch.io.Positions`
        (else None), read on the decode thread.
      hd_binning: the Visium HD binning whose positions parquet each item
        carries (e.g. ``"square_016um"``; the parquet is parsed on the decode
        thread); None for Visium positions CSVs.
      prefetch: staged-slide queue depth (2 = double buffering); the
        pinned pool holds ``prefetch + 1`` buffers.
      decode: override the decode function (image_file -> (H, W, 3) uint8).
      timer: a :class:`StageTimer` (default: a new one); stages ``decode``,
        ``pin`` (on the card only: taking a pinned buffer from the pool,
        which allocates it on first use, and the copy into it),
        ``stage`` (issuing the copy to the card) and ``positions``, all on
        the decode thread.
      device: where slides are staged; 'cuda' (default) raises without CUDA.

    The JAX package's ``pack=`` (an RGBX -> int32 repack for the TPU's
    lanes) has no counterpart: the port's gather reads ``(H, W, 3)`` uint8
    directly.
    """

    def __init__(self, image_files: Sequence, spaceranger_dirs: Optional[Sequence] = None,
                 hd_binning: Optional[str] = None, prefetch: int = 2,
                 decode=None, timer: Optional[StageTimer] = None, device="cuda"):
        from gridnext_tpu_torch.serving import resolve_device

        if spaceranger_dirs is not None and len(spaceranger_dirs) != len(image_files):
            raise ValueError("need one spaceranger dir per image file")
        self.image_files = [str(f) for f in image_files]
        self.spaceranger_dirs = ([str(s) for s in spaceranger_dirs]
                                 if spaceranger_dirs is not None else None)
        self.hd_binning = hd_binning
        self.prefetch = max(1, int(prefetch))
        self.decode = decode or decode_slide
        self.timer = timer if timer is not None else StageTimer()
        self.device = resolve_device(device)
        self._iter_stop = None      # current iteration's cancel event
        self._worker = None
        self.bytes_decoded = 0
        self.bytes_staged = 0

    def _positions(self, i):
        if self.spaceranger_dirs is None:
            return None
        from gridnext_tpu_torch.io import read_positions

        return read_positions(self.spaceranger_dirs[i], self.hd_binning)

    def _stage(self, arr: np.ndarray, pool, stream, stop: threading.Event):
        """``(staged tensor, event or None)`` of one decoded slide, or None
        once ``stop`` is set. On the card: into a pinned buffer, then an
        asynchronous copy on the staging stream with an event after it; the
        buffer goes back to the pool with that event."""
        if pool is None:
            with self.timer("stage"):
                return torch.from_numpy(np.require(arr, requirements=("C", "W"))), None
        if arr.dtype != np.uint8 or arr.ndim != 3:
            raise ValueError(f"decoded to {arr.shape} {arr.dtype}, not (H, W, 3) uint8")
        with self.timer("pin"):
            buf = pool.acquire(tuple(arr.shape), stop)
            if buf is None:
                return None
            buf.copy_(torch.from_numpy(np.require(arr, requirements="C")))
        with self.timer("stage"):
            # allocated on the staging stream: the consumer marks it as used
            # by its own stream before reading it (record_stream)
            with torch.cuda.stream(stream):
                dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
                dev.copy_(buf, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        pool.release(buf, event)
        return dev, event

    def _decode_worker(self, out_q: queue.Queue, stop: threading.Event, pool, stream):
        # Every put is stop-aware: if the consumer abandons iteration (an
        # exception mid-loop, an early break), the thread must not block
        # forever on the bounded queue holding GB-scale slides.
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            for i, f in enumerate(self.image_files):
                if stop.is_set():
                    return
                with self.timer("decode"):
                    arr = self.decode(f)
                self.bytes_decoded += arr.nbytes
                # staged here, not by the consumer: the consumer is busy in
                # the registration (which returns labels on the host), so a
                # copy it issued could not run under the registration's kernels
                staged = self._stage(arr, pool, stream, stop)
                if staged is None:
                    return
                del arr
                self.bytes_staged += staged[0].numel() * staged[0].element_size()
                # the positions parse rides the decode thread too, off the
                # consumer's dispatch path
                if self.spaceranger_dirs is not None:
                    with self.timer("positions"):
                        pos = self._positions(i)
                else:
                    pos = None
                if not put((i, *staged, pos)):
                    return
            put(None)
        except BaseException as e:  # surface in the consumer, don't hang it
            put(e)

    def __len__(self):
        return len(self.image_files)

    def __iter__(self):
        cuda = self.device.type == "cuda"
        stream = _staging_stream(self.device) if cuda else None
        # a pool per iteration: buffers an abandoned iteration still holds
        # cannot starve the next one
        pool = _PinnedPool(self.prefetch + 1) if cuda else None
        staged: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()   # per iteration, so the source re-iterates
        self._iter_stop = stop
        worker = threading.Thread(target=self._decode_worker,
                                  args=(staged, stop, pool, stream),
                                  name="gnx-slide-decode", daemon=True)
        self._worker = worker
        worker.start()
        try:
            while True:
                # stop-aware get: if close() cancels mid-iteration the worker
                # exits without the None sentinel, and a bare get() would hang
                try:
                    item = staged.get(timeout=0.2)
                except queue.Empty:
                    if stop.is_set() and not worker.is_alive():
                        return          # cancelled: treat as exhausted
                    continue
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                i, dev, event, pos = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    dev.record_stream(consumer)
                yield i, dev, pos
        finally:
            # abandoned generator (consumer raised / broke early) or normal
            # exhaustion: cancel the decode thread and release any queued
            # slides rather than holding them for the process's life
            stop.set()
            try:
                while True:
                    staged.get_nowait()
            except queue.Empty:
                pass

    def close(self):
        """Cancel the in-flight iteration's decode thread (idempotent; the
        iterator's own cleanup takes this path when the consuming generator
        is closed or garbage-collected)."""
        if self._iter_stop is not None:
            self._iter_stop.set()

    def throughput(self) -> dict:
        """{'decode_gb_s', 'stage_gb_s'} from the accumulated stage timings.

        'stage' measures issuing the asynchronous copy; for the link's rate
        synchronize on the staged slides first (or read ``timer.summary()``
        around a whole consume loop).
        """
        t = self.timer.summary()
        out = {}
        if t.get("decode"):
            out["decode_gb_s"] = self.bytes_decoded / 1e9 / t["decode"]
        if t.get("stage"):
            out["stage_gb_s"] = self.bytes_staged / 1e9 / t["stage"]
        return out
