"""Multi-process execution: one process a card over ``torch.distributed``.

The JAX package runs one controller a host over its chips; the port runs
one process a card (a CPU process under ``--device cpu``). Every process
runs the same training program (the same model, the same shuffle, the same
epochs); :func:`initialize_multihost` wires them into one process group:

* launched by ``torchrun --nproc-per-node N -m gridnext_tpu_torch
  --multihost <command> ...``, it reads torchrun's environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``);
* wired by hand (``--coordinator host:port,num_processes,process_id``,
  the JAX package's spelling), it takes the address, the world size and
  the rank.

NCCL carries the collectives on CUDA, gloo on the CPU; a gloo group beside
an NCCL world carries the host's flags (the SIGTERM stop flag).

Batches: each rank builds only its rows of the global batch, the
balanced split of :func:`local_shard_indices` (the trainers take them
through ``mesh.shard_spot_batch`` / ``shard_grid_batch``).
:func:`global_spot_batch` / :func:`global_grid_batch` keep the JAX
package's process-local-IO surface: they check a mesh's axis order and
move rows a caller read itself onto the rank's device. File outputs
(checkpoints, metrics, model directories) come from the primary process
only (:func:`is_primary`); ``train/loops.py`` and the training commands
gate their writers on it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = None
_TIMEOUT = None           # initialize_multihost's timeout, for the sub-groups


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device="cuda",
                         timeout: Optional[float] = None) -> int:
    """Join this process to the process group; return its rank.

    Idempotent: a process already in a group returns its rank. Without a
    ``coordinator_address`` the group comes from torchrun's environment
    (``env://``); with one, from ``tcp://coordinator_address`` with
    ``num_processes`` and ``process_id``. ``backend`` defaults to NCCL for
    a CUDA ``device`` and gloo otherwise; on CUDA this process's card
    (:func:`local_device`) becomes the current one first. ``timeout``:
    seconds a collective (and the rendezvous) waits for the other ranks
    before it fails (None: torch's default, 30 minutes).
    """
    global _HOST_GROUP, _TIMEOUT
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                   if k not in os.environ]
        if missing:
            raise ValueError(
                f"no process group to join: {', '.join(missing)} unset. Launch with "
                "'torchrun --nproc-per-node N -m gridnext_tpu_torch --multihost "
                "<command> ...' or pass --coordinator host:port,num_processes,process_id")
        kw = {"init_method": "env://"}
        rank = int(os.environ["RANK"])
    else:
        kw = {"init_method": f"tcp://{coordinator_address}",
              "world_size": int(num_processes), "rank": int(process_id)}
        rank = int(process_id)
    if timeout is not None:
        kw["timeout"] = _TIMEOUT = datetime.timedelta(seconds=float(timeout))
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device, rank))
    dist.init_process_group(backend, **kw)
    _HOST_GROUP = (dist.new_group(backend="gloo", timeout=kw.get("timeout"))
                   if backend != "gloo" else dist.group.WORLD)
    return dist.get_rank()


def shutdown_multihost() -> None:
    """Leave the process group (a no-op outside one)."""
    global _HOST_GROUP, _TIMEOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = _TIMEOUT = None


def group_timeout():
    """The timeout :func:`initialize_multihost` was given (None: torch's
    default), which the mesh's sub-groups take too."""
    return _TIMEOUT


def host_group():
    """A gloo group over every rank for host (CPU) tensors."""
    return _HOST_GROUP


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns file outputs (checkpoints, metrics,
    model directories). Always true in a single process."""
    return process_index() == 0


def local_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` (torchrun), else the rank,
    modulo the visible cards; a CPU ``device`` unchanged."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        local = process_index() if rank is None else int(rank)
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def local_shard_indices(n_items: int, index: Optional[int] = None,
                        count: Optional[int] = None) -> range:
    """This process's contiguous slice of ``range(n_items)``: a balanced
    partition (sizes differ by at most 1, earlier processes take the
    remainder). ``index`` / ``count`` default to the rank and the world
    size, so a single process gets the whole range."""
    if count is None:
        count = process_count()
    if index is None:
        index = process_index()
    if not 0 <= index < count:
        raise ValueError(f"process index {index} outside [0, {count})")
    base, rem = divmod(n_items, count)
    start = index * base + min(index, rem)
    stop = start + base + (1 if index < rem else 0)
    return range(start, stop)


def _check_batch_axes_span_processes(mesh, batch_axes) -> None:
    """Check that the batch axes give the ranks contiguous rows.

    Raveling the rank grid over ``batch_axes`` (in axis order), the shard
    each rank holds must ascend with the rank in equal contiguous blocks,
    so that rank ``r``'s rows are :func:`local_shard_indices` of its
    block. A mesh ordered like ``--mesh spot=2,data=4`` breaks it; the
    error says how to order it.
    """
    if mesh.size == 1:
        return
    names = list(mesh.axis_names)
    batch = [a for a in batch_axes if a in names]
    order = ([names.index(a) for a in batch]
             + [i for i, a in enumerate(names) if a not in batch])
    ranks = np.transpose(np.arange(mesh.size).reshape(tuple(mesh.shape.values())), order)
    lead = int(np.prod([mesh.shape[a] for a in batch], dtype=int))
    ranks = ranks.reshape(lead, -1)
    shard_of = np.empty(mesh.size, np.int64)
    for i, row in enumerate(ranks):
        shard_of[row] = i
    if (np.diff(shard_of) < 0).any():
        raise ValueError(
            f"mesh axes {dict(mesh.shape)} cannot assemble process-local "
            "batches: the device->process assignment along the batch axis is "
            "not an ascending sequence of equal contiguous blocks. The batch "
            f"axes {tuple(batch)} must span processes contiguously -- put the "
            "process-spanning ('data') axis FIRST in the mesh spec (make_mesh "
            "preserves axis order; e.g. use data=N,spot=M, not spot=M,data=N), "
            "or pass fully replicated host batches (shard_*_batch) instead of "
            "the global_*_batch path")


def _to_local(tree, mesh):
    if isinstance(tree, dict):
        return {k: _to_local(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_local(v, mesh) for v in tree)
    return torch.as_tensor(tree).to(mesh.device)


def global_spot_batch(local_tree, mesh):
    """The JAX package's process-local-IO entry for spot batches. A rank
    of the port holds only its rows of the global batch, so this takes
    the rows the caller read (its :func:`local_shard_indices` of a global
    batch divisible by ``mesh.size``) and moves them onto the rank's
    device; it slices nothing. The contiguity check passes for any axis
    order here (the item axis spans every axis)."""
    _check_batch_axes_span_processes(mesh, tuple(mesh.axis_names))
    return _to_local(local_tree, mesh)


def global_grid_batch(local_tree, mesh, data_axis: str = "data"):
    """The JAX package's process-local-IO entry for grid batches: checks
    that ``data_axis`` gives the ranks contiguous blocks (JAX's message
    when it does not) and moves the grids the caller read (its block's
    :func:`local_shard_indices` over ``data``; the ranks of one ``spot``
    group read the same grids) onto the rank's device; it slices
    nothing."""
    _check_batch_axes_span_processes(mesh, (data_axis,))
    return _to_local(local_tree, mesh)
