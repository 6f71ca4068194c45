"""Preemption-safe training: SIGTERM -> batch-boundary checkpoint -> resume.

The port's copy of the JAX package's ``train/preempt.py`` (pure Python):

* :func:`install_preemption_handler` installs a SIGTERM handler that only
  sets a flag -- no work happens in signal context.
* The trainers (``train/loops.py``) consult :func:`active` at every train
  and eval batch boundary; when triggered they write the ``'.latest'``
  resume checkpoint with ``batches_done`` (mid-epoch position) and raise
  :class:`TrainingPreempted`.
* ``resume=`` restores parameters, optimizer state and step AND
  fast-forwards the epoch's shuffle permutation past ``batches_done``, so
  the continued run replays the exact remaining batches.
* The CLI installs the handler for every ``train-*`` command and exits
  with code 75 (EX_TEMPFAIL) on preemption; rerunning the same command
  with ``--resume`` continues.

The flag is process-global because SIGTERM is: one guard serves every
trainer stage in a multi-stage command (train-mm's f_count -> f_image -> g).
"""

from __future__ import annotations

import signal
import threading

__all__ = ["TrainingPreempted", "PreemptionGuard",
           "install_preemption_handler", "active"]


class TrainingPreempted(RuntimeError):
    """Raised at a batch boundary after the resume checkpoint is on disk.

    ``checkpoint``: path of the ``'.latest'`` file to pass back via
    ``resume=`` / ``--resume`` (None if the trainer had no ``outfile`` to
    checkpoint to — the state is lost, matching a plain kill).
    """

    def __init__(self, checkpoint=None):
        self.checkpoint = checkpoint
        super().__init__(
            f"training preempted; resume from {checkpoint}" if checkpoint
            else "training preempted (no outfile — nothing checkpointed)")


class PreemptionGuard:
    """A latched flag set from signal context, read at batch boundaries.

    A plain bool attribute, NOT threading.Event: Event.set() takes a
    non-reentrant lock, so a second SIGTERM landing while the first
    handler invocation holds it would deadlock the main thread inside the
    handler -- exactly when the grace window is burning. Attribute
    assignment is async-signal-safe in CPython, and polling needs no lock.
    """

    def __init__(self):
        self._flag = False

    def trigger(self, *_signal_args):
        self._flag = True

    @property
    def triggered(self) -> bool:
        return self._flag

    def reset(self):
        self._flag = False


_active_lock = threading.Lock()
_active_guard: PreemptionGuard | None = None
_prev_handlers: dict = {}       # signal number -> previous disposition


def install_preemption_handler(signals=(signal.SIGTERM,)) -> PreemptionGuard:
    """Install the checkpoint-on-preemption guard (idempotent).

    Must run on the main thread (CPython signal rule). Returns the
    process-global guard; repeated calls return the same one.
    """
    global _active_guard
    with _active_lock:
        if _active_guard is None:
            _active_guard = PreemptionGuard()
        # hook any signals not yet covered -- a later caller asking for
        # (SIGTERM, SIGUSR1) after the CLI installed SIGTERM must not have
        # its SIGUSR1 request silently dropped
        for sig in signals:
            if sig not in _prev_handlers:
                _prev_handlers[sig] = signal.signal(sig,
                                                    _active_guard.trigger)
        return _active_guard


def uninstall_preemption_handler():
    """Remove the guard and restore every signal's previous disposition
    (in-process callers -- tests, notebooks -- must not leave a flag-setting
    handler that nobody polls swallowing real termination requests)."""
    global _active_guard
    with _active_lock:
        if _active_guard is not None:
            for sig, prev in _prev_handlers.items():
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            _prev_handlers.clear()
            _active_guard = None


def active() -> PreemptionGuard | None:
    """The installed guard, or None — trainers poll this each batch."""
    return _active_guard
