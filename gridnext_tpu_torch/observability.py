"""Stage timers: cheap named wall-clock stages with a summary dict.

The port's copy of the JAX package's ``observability.StageTimer``.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


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
