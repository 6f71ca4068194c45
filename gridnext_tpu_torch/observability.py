"""Observability: profiler traces, stage timers, structured metric logging.

The port's copy of the JAX package's ``observability.py``:

* :func:`profile_trace` -- a ``torch.profiler`` trace of the enclosed block
  (CPU activity, and CUDA activity where a card is present), written as a
  Chrome trace JSON under a directory (the JAX package writes an xplane for
  TensorBoard; open this one in ``chrome://tracing`` or Perfetto);
  :func:`annotate` names a region of it (``record_function``).
* :class:`StageTimer` -- cheap named wall-clock stages with a summary dict.
* :class:`MetricsLogger` -- append-only JSONL of structured metric dicts
  (step, wall time, arbitrary scalars); :func:`read_metrics` reads it back.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed block with ``torch.profiler`` and write it to
    ``logdir/trace_<host>_<pid>_<time>.json`` (a Chrome trace: host ops,
    and the card's kernels and copies where CUDA is available)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        name = f"trace_{os.uname().nodename}_{os.getpid()}_{time.time_ns()}.json"
        prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """A named region of the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulating named wall-clock stages.

    >>> t = StageTimer()
    >>> with t("decode"): ...
    >>> with t("register"): ...
    >>> t.summary()  # {'decode': ..., 'register': ...}

    Stages may close concurrently (a decode thread beside the consumer), so
    the read-modify-write of a total holds a lock.
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return dict(self.totals)

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{k}: {v:.3f}s ({v / total * 100:.1f}%, n={self.counts[k]})"
                 for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


@contextlib.contextmanager
def stage(timer, name: str, device=None):
    """``timer(name)`` around the block, or nothing without a timer. With a
    CUDA ``device`` the card is synchronised before the stage closes, so the
    work the block queued is timed in it."""
    if timer is None:
        yield
        return
    with timer(name):
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


class MetricsLogger:
    """Append-only JSONL metric stream."""

    def __init__(self, path, flush_every: int = 1):
        self.path = str(path)
        self._fh = open(self.path, "a")
        self._since_flush = 0
        self._flush_every = flush_every
        self._t0 = time.time()

    def log(self, step: Optional[int] = None, **metrics):
        rec = {"wall_s": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            if isinstance(v, (bool, str, list, dict, type(None))):
                # kept as they are before the float attempt: float(True) and
                # float("007") would succeed and change the type
                rec[k] = v
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                if hasattr(v, "tolist"):
                    rec[k] = np.asarray(v).tolist() if hasattr(v, "shape") else v.tolist()
                else:
                    rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._since_flush += 1
        if self._since_flush >= self._flush_every:
            self._fh.flush()
            self._since_flush = 0

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path) -> list:
    """Read a MetricsLogger JSONL stream back as a list of dicts."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
