"""The port's slide ingest against the JAX package's, on the CPU.

- ``decode_slide`` bit-equal to JAX's on JPEG, RGBA and grayscale images;
- ``SlideSource`` yields the same ``(index, array, positions)`` as JAX's
  (positions read from simulated Spaceranger directories);
- the prefetch bound, a worker's exception in the consumer, ``break`` and
  ``close()`` stopping the decode thread and draining the queue;
- ``StageTimer`` gives the stages and counts JAX's gives;
- the pinned pool (its accounting runs on the CPU with plain tensors) and
  the entry point's default device.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gridnext_tpu.data import simulate_spaceranger_dir
from gridnext_tpu.ingest import SlideSource as JaxSlideSource
from gridnext_tpu.ingest import decode_slide as jax_decode_slide
from gridnext_tpu.observability import StageTimer as JaxStageTimer
from gridnext_tpu_torch import ingest
from gridnext_tpu_torch.ingest import SlideSource, decode_slide
from gridnext_tpu_torch.observability import StageTimer


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ingest")
    rng = np.random.default_rng(0)
    files, arrays = [], []
    for i in range(3):
        arr = rng.integers(0, 255, (48 + 8 * i, 64, 3), dtype=np.uint8)
        p = root / f"s{i}.png"              # lossless: exact round trips
        Image.fromarray(arr).save(p)
        files.append(str(p))
        arrays.append(arr)
    return files, arrays


def test_decode_slide_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
    cases = {"slide.jpg": Image.fromarray(rgb),
             "rgba.png": Image.fromarray(rng.integers(0, 255, (33, 31, 4), dtype=np.uint8),
                                         "RGBA"),
             "gray.png": Image.fromarray(rng.integers(0, 255, (29, 37), dtype=np.uint8), "L"),
             "gray.jpg": Image.fromarray(rng.integers(0, 255, (24, 40), dtype=np.uint8), "L")}
    for name, im in cases.items():
        im.save(tmp_path / name)
        got = decode_slide(tmp_path / name)
        want = jax_decode_slide(tmp_path / name)
        assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)


def test_slide_source_matches_jax(tmp_path):
    sims = [simulate_spaceranger_dir(tmp_path / f"a{i}", seed=i, n_genes=4, n_classes=3,
                                     image=True, spot_spacing_px=8) for i in range(2)]
    files = [s["image_file"] for s in sims] * 2
    dirs = [s["spaceranger_dir"] for s in sims] * 2
    want = list(JaxSlideSource(files, dirs, prefetch=2))
    src = SlideSource(files, dirs, prefetch=2, device="cpu")
    got = list(src)
    assert [i for i, _, _ in got] == [i for i, _, _ in want] == [0, 1, 2, 3]
    for (_, wsi, pos), (_, jwsi, jpos) in zip(got, want):
        assert isinstance(wsi, torch.Tensor) and wsi.dtype == torch.uint8
        np.testing.assert_array_equal(wsi.numpy(), np.asarray(jwsi))
        assert pos.barcodes == list(jpos.index)
        for col in ("in_tissue", "array_row", "array_col", "pxl_row_in_fullres",
                    "pxl_col_in_fullres"):
            np.testing.assert_array_equal(pos[col], jpos[col].to_numpy())
    assert src.bytes_decoded == src.bytes_staged == sum(w.numel() for _, w, _ in got)
    t = src.timer.summary()
    assert t["decode"] > 0 and t["stage"] > 0 and t["positions"] > 0 and "pin" not in t
    assert src.throughput()["decode_gb_s"] > 0 and src.throughput()["stage_gb_s"] > 0
    assert src.timer.counts == {"decode": 4, "positions": 4, "stage": 4}
    with pytest.raises(ValueError, match="one spaceranger dir"):
        SlideSource(files, dirs[:1], device="cpu")
    # Visium HD: each item's positions come from the binning's parquet
    hd = simulate_spaceranger_dir(tmp_path / "hd", seed=5, n_genes=4, n_classes=3,
                                  image=True, spaceranger_version="hd", hd_grid=(9, 7),
                                  hd_binning="square_016um", spot_spacing_px=8)
    jpos = JaxSlideSource([hd["image_file"]], [hd["spaceranger_dir"]],
                          hd_binning="square_016um")._positions(0)
    (_, wsi, pos), = SlideSource([hd["image_file"]], [hd["spaceranger_dir"]],
                                 hd_binning="square_016um", device="cpu")
    assert pos.barcodes == list(jpos.index) and len(pos.barcodes) == 63
    for col in ("in_tissue", "array_row", "array_col", "pxl_row_in_fullres",
                "pxl_col_in_fullres"):
        np.testing.assert_array_equal(pos[col], jpos[col].to_numpy())


@pytest.mark.parametrize("prefetch", [1, 3])
def test_slide_source_prefetch_bound(slides, prefetch):
    """At most ``prefetch`` staged slides queue and the decode thread holds
    one more: decoded - consumed never exceeds prefetch + 1."""
    files, arrays = slides
    decoded = []

    def decode(f):
        decoded.append(f)
        return decode_slide(f)

    src = SlideSource(files * 4, prefetch=prefetch, decode=decode, device="cpu")
    gaps = []
    for n, (i, wsi, _) in enumerate(src, start=1):
        time.sleep(0.05)                 # a slow consumer lets the worker run ahead
        gaps.append(len(decoded) - n)
        np.testing.assert_array_equal(wsi.numpy(), arrays[i % 3])
    assert max(gaps) <= prefetch + 1, gaps
    assert max(gaps) >= prefetch         # it did run ahead


def test_slide_source_worker_error_reaches_consumer(slides):
    files, _ = slides

    def decode(f):
        if f == files[1]:
            raise OSError(f"cannot decode {f}")
        return decode_slide(f)

    with pytest.raises(OSError, match="cannot decode"):
        list(SlideSource(files, decode=decode, device="cpu"))
    with pytest.raises(OSError, match="cannot decode"):
        list(JaxSlideSource(files, decode=decode))


def _decode_threads_alive():
    return any(t.name == "gnx-slide-decode" and t.is_alive() for t in threading.enumerate())


def _wait_decode_threads_gone(timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and _decode_threads_alive():
        time.sleep(0.05)
    return not _decode_threads_alive()


@pytest.mark.parametrize("how", ["break", "close"])
def test_slide_source_stops_and_drains(slides, how):
    files, _ = slides
    decoded = []

    def decode(f):
        decoded.append(f)
        return decode_slide(f)

    src = SlideSource(files * 4, prefetch=1, decode=decode, device="cpu")
    got = []
    if how == "break":
        for item in src:
            got.append(item)
            break
    else:
        it = iter(src)
        got.append(next(it))
        src.close()
        done = threading.Event()

        def drain():
            got.extend(it)
            done.set()

        threading.Thread(target=drain, daemon=True).start()
        assert done.wait(10.0), "iteration hung after close()"
    assert _wait_decode_threads_gone(), "decode thread alive after the consumer left"
    assert len(got) < len(files) * 4 - 1 and len(decoded) < len(files) * 4
    assert src._worker is not None and not src._worker.is_alive()
    # the source re-iterates after a cancelled run
    assert [i for i, _, _ in src] == list(range(len(files) * 4))


def test_stage_timer_matches_jax():
    ours, theirs = StageTimer(), JaxStageTimer()
    for name in ("decode", "stage", "decode", "register"):
        for t in (ours, theirs):
            with t(name):
                pass
    with pytest.raises(KeyError):
        with ours("register"):
            raise KeyError("inside a stage")
    with pytest.raises(KeyError):
        with theirs("register"):
            raise KeyError("inside a stage")
    assert ours.counts == theirs.counts == {"decode": 2, "stage": 1, "register": 2}
    assert set(ours.summary()) == set(theirs.summary())
    assert [ln.split(":")[0] for ln in ours.report().splitlines()] == sorted(
        ours.totals, key=lambda k: -ours.totals[k])

    # thread-safe: adds from more threads than cores, switching often, are not lost
    shared = StageTimer()

    def work():
        for _ in range(200):
            with shared("decode"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert shared.counts["decode"] == 200 * len(threads)


def test_pinned_pool_reuses_and_bounds(monkeypatch):
    """The pool hands a returned buffer out again (after its event), keeps
    at most ``size`` buffers over all shapes, and gives up once stopped."""
    made = []
    real_empty = torch.empty

    def empty(shape, dtype=None, pin_memory=False):
        assert pin_memory
        made.append(tuple(shape))
        return real_empty(shape, dtype=dtype)

    monkeypatch.setattr(ingest.torch, "empty", empty)

    class Event:
        def __init__(self):
            self.waited = 0

        def synchronize(self):
            self.waited += 1

    stop = threading.Event()
    pool = ingest._PinnedPool(2)
    a = pool.acquire((4, 5, 3), stop)
    b = pool.acquire((4, 5, 3), stop)
    ev = Event()
    pool.release(a, ev)
    assert pool.acquire((4, 5, 3), stop) is a and ev.waited == 1
    pool.release(a, None)
    c = pool.acquire((6, 5, 3), stop)         # a makes room for the new shape
    assert tuple(c.shape) == (6, 5, 3) and pool.count == 2
    assert made == [(4, 5, 3), (4, 5, 3), (6, 5, 3)]
    stop.set()
    assert pool.acquire((4, 5, 3), stop) is None        # b and c are out
    pool.release(b)
    assert pool.acquire((4, 5, 3), stop) is b


def test_pinned_pool_under_contention(monkeypatch):
    """Threads (more than cores, switching often) taking and returning
    buffers of two shapes: no buffer is out twice at once and the pool never
    holds more than its size."""
    real_empty = torch.empty
    monkeypatch.setattr(ingest.torch, "empty",
                        lambda shape, dtype=None, pin_memory=False: real_empty(shape, dtype=dtype))
    pool = ingest._PinnedPool(3)
    stop = threading.Event()
    out, lock, errors = set(), threading.Lock(), []

    def work(k):
        for j in range(100):
            buf = pool.acquire((2, 2, 3) if (j + k) % 3 else (3, 2, 3), stop)
            with lock:
                if id(buf) in out or pool.count > pool.size:
                    errors.append((k, j))
                out.add(id(buf))
            buf.fill_(k)
            time.sleep(0)
            if not bool((buf == k).all()):        # another thread wrote into it
                errors.append((k, j))
            with lock:
                out.discard(id(buf))
            pool.release(buf)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert pool.count <= 3 and len(pool.free) == pool.count


def test_slide_source_defaults_to_cuda(monkeypatch, slides):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlideSource(slides[0])
