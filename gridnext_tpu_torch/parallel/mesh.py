"""Meshes of the port: named axes over ranks (training) or devices (serving).

Axes, as in the JAX package:

* ``data`` -- the batch of Visium arrays (data parallel: gradients
  all-reduce);
* ``spot`` -- a grid's rows. f applies per spot, so the ranks of one
  ``spot`` group split a grid's rows for f and gather the features; the
  corrector g then runs on the whole grid.

Spot batches (spotwise training, MLM) shard their item axis over every
mesh axis, so a ``{'data': 4, 'spot': 2}`` mesh acts as 8-way data
parallelism there. The ``seq`` axis (sequence-parallel MLM) is not ported.

A training mesh (:func:`make_mesh` inside a process group) lays the ranks
out in the mesh's axis order, each rank one device, with a sub-group a
(axis, coordinates of the other axes). A serving mesh (``make_mesh(shape,
devices=[...])``, one process) lists the devices a flat spot axis splits
over (``serving.SlideRegistrar(mesh=...)``).
"""

from __future__ import annotations

import warnings
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gridnext_tpu_torch.parallel import collectives
from gridnext_tpu_torch.parallel.multihost import group_timeout, local_shard_indices

SEQ_LATER = ("the 'seq' mesh axis (sequence-parallel MLM) is not ported yet "
             "(ROADMAP.md Queue 1 item 9, its remainder)")


class Mesh:
    """Named axes over ``size`` positions.

    ``shape``: the axis sizes in order. A training mesh has ``rank`` (this
    process's position), ``device`` (its card), ``coords`` (its coordinate
    on each axis) and :meth:`group` (the ranks that share every other
    coordinate); a serving mesh has ``devices`` (one a position) and no
    process group.
    """

    def __init__(self, shape: Mapping[str, int], *, devices=None, rank: int = 0,
                 device=None, groups: Optional[dict] = None):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        self.rank = int(rank)
        self.device = torch.device(device) if device is not None else (
            self.devices[0] if self.devices else torch.device("cpu"))
        self._groups = groups or {}
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords = {a: int(i) for a, i in zip(self.shape, idx)}

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=int))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only on
        ``axis`` (None for an axis of size 1 or a single process)."""
        return self._groups.get(axis)

    @property
    def distributed(self) -> bool:
        """A training mesh inside a process group (one rank included)."""
        return self.devices is None and dist.is_initialized()

    def __repr__(self):
        return f"Mesh({self.shape})"


def default_mesh_shape(n_devices: int) -> dict:
    """data x spot factorization: prefer 2-way spot sharding when possible."""
    if n_devices % 2 == 0 and n_devices > 1:
        return {"data": n_devices // 2, "spot": 2}
    return {"data": n_devices, "spot": 1}


def _launch_hint(n: int) -> str:
    return (f"launch one process a card: 'torchrun --nproc-per-node {n} -m "
            "gridnext_tpu_torch --multihost <command> ...', or wire each process "
            f"with --coordinator host:port,{n},<rank>")


def make_mesh(mesh_shape: Optional[Mapping[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh; the default is 1-D ``data`` over every rank (or device).

    Inside a process group and without ``devices``: :func:`training_mesh`
    (so is a mesh of size 1 outside one). Otherwise a serving mesh over
    ``devices`` (default: the visible CUDA cards), which must hold at least
    the mesh's size.
    """
    if devices is None and dist.is_initialized():
        return training_mesh(mesh_shape)
    if "seq" in (mesh_shape or {}):
        raise NotImplementedError(SEQ_LATER)
    if devices is None:
        n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
        shape = dict(mesh_shape) if mesh_shape is not None else {"data": max(n_cuda, 1)}
        if _size(shape) == 1:
            return training_mesh(shape)
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    shape = dict(mesh_shape) if mesh_shape is not None else {"data": len(devices)}
    n = _size(shape)
    if len(devices) < n:
        raise ValueError(
            f"mesh shape {shape} needs {n} devices but only {len(devices)} visible "
            f"({[str(d) for d in list(devices)[:4]]}...); pass devices= (e.g. "
            f"['cpu'] * {n} on the CPU), or for training {_launch_hint(n)}")
    return Mesh(shape, devices=list(devices)[:n])


def training_mesh(mesh_shape: Optional[Mapping[str, int]] = None) -> Mesh:
    """The training mesh of this process group (every rank calls it, in the
    same order, as it builds the sub-groups): axis sizes that multiply to
    the world size (default 1-D ``data``). Outside a process group, a mesh
    of size 1 is one rank on this process's card (the CPU without one);
    any other size raises with the launch line."""
    if "seq" in (mesh_shape or {}):
        raise NotImplementedError(SEQ_LATER)
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = dict(mesh_shape) if mesh_shape is not None else {"data": world}
    n = _size(shape)
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} processes but the process "
                         f"group has {world}; {_launch_hint(n)}")
    if not dist.is_initialized():
        return Mesh(shape, rank=0, device="cuda" if torch.cuda.is_available() else "cpu")
    rank = dist.get_rank()
    return Mesh(shape, rank=rank, device=_rank_device(), groups=_axis_groups(shape, rank))


def _size(shape: Mapping[str, int]) -> int:
    return int(np.prod(list(shape.values()), dtype=int))


def _rank_device() -> torch.device:
    """The device this rank's tensors live on: its card under NCCL or a
    CUDA current device, else the CPU."""
    if dist.get_backend() == "nccl" or (torch.cuda.is_available()
                                        and torch.cuda.is_initialized()):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _axis_groups(shape: dict, rank: int) -> dict:
    """{axis: the group of ``rank``'s line along it}: every line of every
    axis of size > 1 becomes a group, in one order on every rank."""
    sizes = tuple(shape.values())
    ranks = np.arange(int(np.prod(sizes, dtype=int))).reshape(sizes)
    out = {}
    for ax, name in enumerate(shape):
        if sizes[ax] == 1:
            continue
        moved = np.moveaxis(ranks, ax, -1).reshape(-1, sizes[ax])
        for line in moved:
            group = dist.new_group([int(r) for r in line], timeout=group_timeout())
            if rank in line:
                out[name] = group
    return out


def _rows(n: int, index: int, count: int) -> slice:
    r = local_shard_indices(n, index, count)
    return slice(r.start, r.stop)


def spot_batch_rows(batch: int, mesh: Mesh) -> slice:
    """This rank's rows of a spot batch: the item axis over every axis."""
    if batch % mesh.size:
        raise ValueError(
            f"spot-batch dim {batch} is not divisible by the "
            f"mesh's {mesh.size} devices; pick a batch size that is a "
            f"multiple of the device count")
    return _rows(batch, mesh.rank, mesh.size)


def grid_batch_rows(batch: int, mesh: Mesh, data_axis: str = "data") -> slice:
    """This rank's grids of a grid batch: the batch over ``data_axis``."""
    data_n = mesh.axis_size(data_axis)
    if batch % data_n:
        raise ValueError(
            f"batch dim {batch} is not divisible by mesh axis "
            f"'{data_axis}'={data_n}; pick a batch size that is a "
            f"multiple of the data-parallel degree")
    return _rows(batch, mesh.coords.get(data_axis, 0), data_n)


def spot_rows(h: int, mesh: Mesh, spot_axis: str = "spot") -> Optional[collectives.SpotShard]:
    """This rank's share of a grid's ``h`` rows for f, or None where the
    mesh has no ``spot`` axis; a ``spot`` axis that does not divide ``h``
    warns and shares nothing (every rank of the group runs f on every
    row: the JAX package's data-only fallback)."""
    spot_n = mesh.axis_size(spot_axis)
    if spot_n == 1:
        return None
    if h % spot_n:
        warnings.warn(
            f"grid H={h} is not divisible by mesh axis "
            f"'{spot_axis}'={spot_n}; sharding this array over "
            f"'data' only (H replicates)", stacklevel=3)
        return None
    return collectives.SpotShard(mesh.group(spot_axis), mesh.coords[spot_axis], spot_n)


def _take_rows(tree, rows: slice):
    if isinstance(tree, dict):
        return {k: _take_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take_rows(v, rows) for v in tree)
    return tree[rows]


def shard_spot_batch(tree, mesh: Mesh):
    """This rank's rows of a spot-level batch (arrays, tensors or a tree of
    them): the item axis (dim 0) shards over every mesh axis, so a
    ``{'data': 4, 'spot': 2}`` mesh acts as 8-way data parallelism."""
    leaves = list(_leaves(tree))
    rows = spot_batch_rows(leaves[0].shape[0], mesh) if leaves else slice(None)
    return _take_rows(tree, rows)


def shard_grid_batch(tree, mesh: Mesh, data_axis: str = "data",
                     spot_axis: Optional[str] = "spot"):
    """This rank's grids of a batch of grids: the batch dim over ``data``.
    The ``spot`` axis splits each grid's rows inside the grid model
    (:func:`spot_rows`); a grid H it does not divide warns here and falls
    back to data-only sharding, and a batch dim ``data`` does not divide
    raises with the numbers spelled out."""
    leaves = list(_leaves(tree))
    if not leaves:
        return tree
    rows = grid_batch_rows(leaves[0].shape[0], mesh, data_axis)
    if spot_axis is not None:
        for x in leaves:
            if x.ndim >= 2:
                spot_rows(x.shape[1], mesh, spot_axis)
    return _take_rows(tree, rows)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def replicate(tree, mesh: Mesh):
    """Make every rank's copy rank 0's: a module's parameters and buffers,
    or a tree of tensors, broadcast in place (a no-op outside a process
    group). Returns ``tree``."""
    if not mesh.distributed:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = [t for t in _leaves(tree) if torch.is_tensor(t)]
    collectives.broadcast_(tensors)
    return tree


__all__ = ["Mesh", "SEQ_LATER", "default_mesh_shape", "grid_batch_rows", "make_mesh",
           "replicate", "shard_grid_batch", "shard_spot_batch", "spot_batch_rows",
           "spot_rows", "training_mesh"]
