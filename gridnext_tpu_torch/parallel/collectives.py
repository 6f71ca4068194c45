"""The collectives the trainers need, and the sharding context the models read.

Only ``all_reduce`` and ``broadcast`` are used, the two collectives every
``torch.distributed`` backend takes on CUDA tensors (gloo included):

* :func:`all_reduce` is a differentiable SUM: its backward all-reduces the
  gradient, so a loss summed over ranks differentiates to every rank's
  share (the BatchNorm statistics of the global batch, the gathered
  features of the ``spot`` axis);
* :func:`gather_rows` gathers a group's slices of one axis as the
  all-reduce of a zero-padded buffer (differentiable through it);
* :func:`all_reduce_grads` sums a list of gradients in one call a dtype;
* :func:`any_rank` is a MAX over the host group of a flag (the SIGTERM
  stop flag the trainers check at each batch);
* :func:`broadcast_` copies rank 0's tensors to every rank.

:data:`COUNTS` counts every collective launched, by name (set them to 0
with :func:`reset_counts`): ``all_reduce`` and ``broadcast`` count every
call, ``grads`` the gradient all-reduces among them, ``stop_flag`` the
host flags and ``favor_seq`` FAVOR's forward sums of (ctx, ksum) over a
``seq`` group (``ops/favor_cuda.seq_sum``; its backward's sums count as
``all_reduce`` only).

:func:`sharded` is the context the trainers set around a step on a mesh:
the group over which train-mode ``BatchNorm`` reduces its statistics
(``models/layers.py``), the ``spot`` group that splits a grid's rows for
f (``models/gridnet.apply_f_grid``), and this rank's rows of the global
batch, from which the random draws of dropout, augmentation and the MLM
mask take their rows (:func:`draw_rows`), so a sharded step draws what
one process draws for the whole batch. On a ``seq`` axis the context also
holds this rank's columns of the token axis (:class:`TokenShard`), which
the token-shaped draws take too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "broadcast": 0, "grads": 0, "stop_flag": 0, "favor_seq": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (not differentiable)."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM of ``t`` over ``group``, differentiable: the gradient that
    reaches ``t`` is the SUM over ranks of the gradients of the output."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, group)
    return all_reduce_(t.clone(), group)


def gather_rows(local: torch.Tensor, dim: int, index: int, count: int,
                group) -> torch.Tensor:
    """Concatenate ``count`` ranks' equal slices along ``dim`` (this rank's
    is slice ``index``): the all-reduce of a buffer zero outside each
    rank's slice. Differentiable: each slice takes the SUM over ranks of
    its gradient."""
    n = local.shape[dim]
    before = list(local.shape)
    before[dim] = index * n
    after = list(local.shape)
    after[dim] = (count - index - 1) * n
    full = torch.cat([local.new_zeros(before), local, local.new_zeros(after)], dim=dim)
    return all_reduce(full, group)


def all_reduce_grads(params: Sequence[torch.Tensor], group=None) -> None:
    """SUM every ``p.grad`` over ``group``, one flat all-reduce a dtype
    (a parameter without a gradient takes zeros, as the optimiser does)."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        COUNTS["grads"] += 1
        all_reduce_(flat, group)
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def any_rank(flag: bool, group) -> bool:
    """True on every rank of ``group`` (a gloo group: the flag is a host
    tensor) when ``flag`` is true on any."""
    t = torch.tensor([int(flag)])
    COUNTS["stop_flag"] += 1
    all_reduce_(t, group, dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Copy rank ``src``'s ``tensors`` into every rank's, one flat
    broadcast a dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        COUNTS["broadcast"] += 1
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


# -- the sharding context of a step ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpotShard:
    """This rank's share of a grid's rows: slice ``index`` of ``count``
    over ``group`` (the ranks that hold the same grids)."""
    group: object
    index: int
    count: int


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[start, stop)`` of a global batch of ``total``."""
    start: int
    stop: int
    total: int


@dataclasses.dataclass(frozen=True)
class TokenShard:
    """This rank's columns ``[start, stop)`` of a token axis of ``total``,
    the other columns held by the ranks of ``group`` (a ``seq`` axis)."""
    group: object
    start: int
    stop: int
    total: int


@dataclasses.dataclass
class _Context:
    batch_group: object = None
    spot: Optional[SpotShard] = None
    rows: Optional[RowShard] = None
    tokens: Optional[TokenShard] = None


_CONTEXT = _Context()


@contextlib.contextmanager
def sharded(batch_group=None, spot: Optional[SpotShard] = None,
            rows: Optional[RowShard] = None, tokens: Optional[TokenShard] = None):
    """Within the block, train-mode BatchNorm reduces over ``batch_group``
    (when it spans more than one rank), grid models split f over ``spot``
    and random draws take ``rows`` of the global batch's (and, along a
    token axis, the ``tokens`` columns)."""
    global _CONTEXT
    saved = _CONTEXT
    _CONTEXT = _Context(batch_group if group_size(batch_group) > 1 else None, spot, rows,
                        tokens)
    try:
        yield
    finally:
        _CONTEXT = saved


def batch_norm_group():
    """The group train-mode BatchNorm reduces over, or None (local)."""
    return _CONTEXT.batch_group


def spot_shard() -> Optional[SpotShard]:
    return _CONTEXT.spot


def draw_rows(draw: Callable, shape, token_dim: Optional[int] = None) -> torch.Tensor:
    """``draw(shape)``, or, inside :func:`sharded` with ``rows`` whose
    count is ``shape[0]``, this rank's rows of ``draw`` over the global
    batch (the same generator state gives one process's draw). With
    ``token_dim`` (the dim of ``shape`` that is a token axis) and
    ``tokens`` in the context whose count is ``shape[token_dim]``, the draw
    covers the global token axis too and this rank takes its columns."""
    rows, tokens = _CONTEXT.rows, _CONTEXT.tokens
    shape = list(shape)
    index = [slice(None)] * len(shape)
    if rows is not None and shape and shape[0] == rows.stop - rows.start:
        shape[0], index[0] = rows.total, slice(rows.start, rows.stop)
    if (tokens is not None and token_dim is not None and len(shape) > token_dim
            and shape[token_dim] == tokens.stop - tokens.start):
        shape[token_dim] = tokens.total
        index[token_dim] = slice(tokens.start, tokens.stop)
    if all(i == slice(None) for i in index):
        return draw(tuple(shape))
    return draw(tuple(shape))[tuple(index)]
