"""Grouped k-fold cross-validation (the register_BA44 notebooks' workflow),
the port's copy of the JAX package's ``workflows/cv.py``.

Arrays are grouped by individual, the unique individuals split into k
partitions, and each fold holds out the arrays whose individual is in its
partition, training afresh and collecting per-epoch train/val loss
histories. Fold curves summarize as mean +/- std across folds
(:func:`gridnext_tpu_torch.plotting.plot_cv_curves`).

This module is the grouping, partitioning and aggregation; the per-fold
training is whatever trainer the caller wires, typically the port's
:func:`~gridnext_tpu_torch.train.train_spotwise` or
:func:`~gridnext_tpu_torch.train.train_gridwise`, whose
``(state, val_history, train_history)`` triple :func:`cross_validate`
stacks. numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def grouped_partitions(groups: Sequence, n_folds: int = 4) -> List[np.ndarray]:
    """Split the unique group values into ``n_folds`` held-out partitions.

    Deterministic contiguous split of the sorted unique values -- the
    notebooks' ``individuals[:3], individuals[3:6], ...`` slicing
    (register_BA44_counts.ipynb cell 1) generalized to any k.
    """
    uniq = np.unique(np.asarray(groups))
    if not 2 <= n_folds <= len(uniq):
        raise ValueError(f"n_folds={n_folds} needs 2..{len(uniq)} "
                         f"(got {len(uniq)} unique groups)")
    return list(np.array_split(uniq, n_folds))


def partition_masks(groups: Sequence, partitions: Sequence[Sequence],
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield per-fold (train_mask, val_mask) over the arrays.

    ``groups[i]`` is array i's group value (e.g. its subject); the val mask
    selects arrays whose group is in the fold's held-out partition
    (register_BA44_counts.ipynb cell 5 semantics).
    """
    groups = np.asarray(groups)
    for p in partitions:
        val = np.isin(groups, np.asarray(p))
        if not val.any():
            raise ValueError(f"partition {list(np.asarray(p))} matches no "
                             f"arrays (groups: {list(np.unique(groups))})")
        if val.all():
            raise ValueError(f"partition {list(np.asarray(p))} holds out "
                             "every array; nothing left to train on")
        yield ~val, val


@dataclasses.dataclass
class CVResult:
    """Stacked fold histories: epoch losses, shape (n_folds, n_epochs)."""

    train_hist: np.ndarray
    val_hist: np.ndarray
    states: list               # per-fold trainer states (or None)
    partitions: List[np.ndarray]

    def summary(self) -> dict:
        """Across-fold mean/std curves (the notebooks' errorbar inputs)."""
        return {"train_mean": self.train_hist.mean(0),
                "train_std": self.train_hist.std(0),
                "val_mean": self.val_hist.mean(0),
                "val_std": self.val_hist.std(0)}


def cross_validate(fold_fn: Callable, groups: Sequence, *,
                   partitions: Optional[Sequence[Sequence]] = None,
                   n_folds: int = 4, verbose: bool = True) -> CVResult:
    """Run ``fold_fn`` once per held-out partition and stack histories.

    ``fold_fn(train_mask, val_mask, fold_index)`` must return the
    ``(state, val_history, train_history)`` triple both trainers return
    (``gridnext_tpu_torch.train``); it typically builds the fold's datasets from the
    masked array lists and calls ``train_spotwise``/``train_gridwise``.

    ``partitions`` defaults to :func:`grouped_partitions` over ``groups``;
    pass an explicit list (e.g. the notebooks' hand-chosen subject splits)
    to control fold membership.
    """
    if partitions is None:
        partitions = grouped_partitions(groups, n_folds)
    states, vals, trains = [], [], []
    for i, (tr, va) in enumerate(partition_masks(groups, partitions)):
        if verbose:
            held = ", ".join(str(g) for g in np.asarray(partitions[i]))
            print(f"Test Partition: {held}", flush=True)
        state, val_hist, train_hist = fold_fn(tr, va, i)
        states.append(state)
        vals.append(np.asarray(val_hist, float))
        trains.append(np.asarray(train_hist, float))
    n_ep = {len(v) for v in vals} | {len(t) for t in trains}
    if len(n_ep) != 1:
        raise ValueError(f"folds returned unequal history lengths {n_ep}; "
                         "fix num_epochs per fold before aggregating")
    return CVResult(np.stack(trains), np.stack(vals), states,
                    [np.asarray(p) for p in partitions])
