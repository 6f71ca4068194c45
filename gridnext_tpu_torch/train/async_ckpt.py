"""Asynchronous checkpoint writes: the train loop never stalls on I/O.

The port's ``AsyncCheckpointWriter`` (the JAX package's
``train/async_ckpt.py``). torch tensors change in place at the next
optimiser step, so :meth:`AsyncCheckpointWriter.save` copies the state on
the device when it is called (a few device-to-device copies queued on the
current stream, with an event after them); the background thread waits on
that event, copies the snapshot to the host and writes the msgpack file.
The write observes exactly the state passed in, never a later one.

Per-path coalescing keeps at most one pending write per file: if epoch
N+1's '.latest' is enqueued while epoch N's still waits, epoch N's snapshot
is dropped (its bytes would be overwritten at once), and a crash between
the two leaves the epoch N-1 file intact (writes are atomic renames).
"""

from __future__ import annotations

import threading

import torch

from gridnext_tpu_torch.train.loops import _payload_tree, write_payload


class AsyncCheckpointWriter:
    """Background checkpoint writer with per-path coalescing.

    Usage::

        writer = AsyncCheckpointWriter()
        writer.save(path, state, extra_meta={...})   # returns after the copy
        ...
        writer.wait()   # block until all enqueued writes are on disk
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: dict = {}          # path -> (payload, event, kwargs)
        self._in_flight = 0
        self._stop = False
        self._errors: list = []
        self._thread = None

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
                path = next(iter(self._pending))
                payload, event, extra_meta = self._pending.pop(path)
                self._in_flight += 1
            try:
                if event is not None:
                    event.synchronize()
                write_payload(path, payload, extra_meta)
            except BaseException as e:   # surfaces at wait() or the next save()
                with self._cv:
                    self._errors.append(e)
            finally:
                with self._cv:
                    self._in_flight -= 1
                    self._cv.notify_all()

    def _raise_errors_locked(self):
        """Re-raise the first recorded failure; later ones ride along as
        exception notes."""
        if not self._errors:
            return
        err, rest = self._errors[0], self._errors[1:]
        self._errors.clear()
        for other in rest:
            err.add_note(f"another background checkpoint write also failed: {other!r}")
        raise err

    def save(self, path, state, include_opt_state: bool = True, extra_meta=None):
        """Snapshot ``state`` on its device and enqueue its write to
        ``path``, replacing any not-yet-started write to the same path.
        Fails fast: an earlier background failure re-raises here."""
        payload = _payload_tree(state, include_opt_state)
        event = None
        dev = next((p.device for p in state.model.parameters()), torch.device("cpu"))
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        with self._cv:
            self._raise_errors_locked()
            self._pending[str(path)] = (payload, event, extra_meta)
            self._ensure_thread()
            self._cv.notify_all()

    def wait(self):
        """Block until every enqueued write is on disk; re-raise the first
        background failure."""
        with self._cv:
            while self._pending or self._in_flight:
                self._cv.wait()
            self._raise_errors_locked()

    def close(self):
        try:
            self.wait()
        finally:
            # stop and join even when wait() re-raises, or the parked worker
            # would leak
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=60)
