"""Training loops of the port: the JAX package's ``train/loops.py`` in
PyTorch, step for step.

* ``train_spotwise`` trains a spot classifier f with plain CE (or MSE);
  ``train_gridwise`` trains a grid model's corrector g (and, with
  ``f_lr``, its f) with the foreground-masked CE over ``(B, H, W, C)``
  logits: background (label 0) masked out, labels shifted to ``[0, N)``;
  ``train_mlm`` pretrains a token LM (``PerformerLM``) with the masked-LM
  objective (:func:`make_mlm_steps`).
* FAVOR+ projections are redrawn every ``redraw_every`` train steps
  (``train_spotwise`` and ``train_mlm``), redraw r from a generator seeded
  by r; checkpoints record ``redraws_done``.
* The optimiser is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
  0.999, eps 1e-8 outside the square root, bias correction) over parameter
  groups: :func:`make_gridwise_optimizer` gives g ``lr``, f ``f_lr`` or no
  update at all, and ``frozen_f_labels`` subtrees no update;
  :func:`make_masked_adam` trains the leaves a label function marks
  'train' and freezes the rest (optax's ``multi_transform`` with
  ``set_to_zero``, scBERT's fine-tuning); ``accum_iters
  > 1`` applies the mean of k gradients every k-th step as
  ``optax.MultiSteps`` does. A parameter that takes no update takes no
  gradient either (``requires_grad`` off), so a frozen f runs under
  ``torch.no_grad()`` inside the grid model.
* The epoch loop: the numpy shuffle of the JAX loop (same permutations,
  the same ``skip`` of a mid-epoch resume), partial batches padded with
  repeats of the last item and loss-masked labels, batches staged onto the
  card two deep on a side stream, metrics read two steps behind, epoch
  losses weighted by real items, the best-validation snapshot restored at
  the end, ``outfile`` and ``outfile.latest`` written every epoch end by a
  background writer, ``resume`` from a ``.latest`` and a SIGTERM guard
  polled at batch boundaries (``train/preempt.py``).
* ``mesh`` / ``mesh_shape`` (the JAX trainers' arguments) train over a
  process group, one process a card (:mod:`gridnext_tpu_torch.parallel`):
  the replicas start from rank 0's weights, each rank builds its rows of
  every padded global batch, the loss's count, the gradients and the
  metrics sum over the ranks (global-batch BatchNorm inside the step),
  a SIGTERM on any rank stops every rank at the same batch, and only rank 0
  writes files.
* Checkpoints are the JAX package's msgpack payload: ``params``,
  ``batch_stats``, ``extra_vars``, ``step`` and ``opt_state`` in the
  layout ``flax.serialization.to_state_dict`` gives the optax state the
  JAX trainers build, so each package resumes the other's ``.latest``.

Random draws (dropout, augmentation) come from ``torch.Generator``s seeded
by the step, so a resumed run draws what an uninterrupted one draws; torch
cannot draw JAX's bits. Initialisation draws flax's distributions from an
explicit generator (``train/init.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import sys
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridnext_tpu_torch.compat import flax_msgpack
from gridnext_tpu_torch.compat.from_jax import (from_jax_layout, jax_variables,
                                                load_checkpoint, load_variables,
                                                model_entries, to_jax_layout)
from gridnext_tpu_torch.models.layers import set_dropout_generator
from gridnext_tpu_torch.train import preempt
from gridnext_tpu_torch.train.init import flax_init_

# f-network collections inside the GridNet models
_F_KEYS = ("patch_classifier", "image_classifier", "count_classifier")

# seeds of the per-step generators (the JAX loop folds the step into keys 11,
# 19 and 13, uses key 17 for the MLM eval mask and splits key 7 per redraw)
_DROPOUT_SEED, _AUGMENT_SEED, _MLM_SEED, _MLM_EVAL_SEED, _REDRAW_SEED = 11, 19, 13, 17, 7


# -- the optimiser ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What the JAX trainers' optax transformation is, before it meets a
    model: ``kind`` 'adam' (``optax.adam(lr)`` over every parameter),
    'gridwise' (:func:`make_gridwise_optimizer`) or 'masked'
    (:func:`make_masked_adam`)."""
    kind: str
    lr: float
    f_lr: Optional[float] = None
    accum_iters: int = 1
    frozen_f_labels: Optional[Mapping[str, Callable]] = None
    param_labels: Optional[Callable] = None


def make_adam(lr: float) -> OptimizerSpec:
    """``optax.adam(lr)`` over every parameter."""
    return OptimizerSpec("adam", float(lr))


def make_gridwise_optimizer(lr: float = 1e-3, f_lr: Optional[float] = None,
                            accum_iters: int = 1,
                            frozen_f_labels: Optional[Mapping[str, Callable]] = None
                            ) -> OptimizerSpec:
    """g's Adam (``lr``) beside f's (``f_lr``; None: f takes no update).

    ``frozen_f_labels``: optional ``{f_key: label_fn}``, ``label_fn`` mapping
    that f's params subtree (JAX layout) to a congruent tree of 'train' /
    'frozen' labels, as in the JAX package; 'frozen' leaves take no update
    even when ``f_lr`` is given. ``accum_iters > 1``: ``optax.MultiSteps``.
    """
    return OptimizerSpec("gridwise", float(lr), None if f_lr is None else float(f_lr),
                         int(accum_iters), frozen_f_labels)


def make_masked_adam(lr: float, param_labels: Callable) -> OptimizerSpec:
    """``optax.multi_transform({'train': adam(lr), 'frozen': set_to_zero()},
    param_labels)``: ``param_labels`` maps the params tree (JAX layout) to a
    congruent tree of 'train' / 'frozen' labels (e.g.
    ``models.scbert.finetune_param_labels``); 'frozen' leaves take no
    update and no gradient."""
    return OptimizerSpec("masked", float(lr), param_labels=param_labels)


def _tree_set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _labels(spec: OptimizerSpec, params_tree: dict, paths) -> dict:
    """{params path: 'g' | 'f' | 'frozen' | 'adam'} (paths without the
    leading 'params')."""
    if spec.kind == "adam":
        return {p: "adam" for p in paths}
    if spec.kind == "masked":
        tree = spec.param_labels(params_tree)
        return {p: "train" if _tree_get(tree, p) == "train" else "frozen" for p in paths}
    frozen = dict(spec.frozen_f_labels or {})
    trees = {k: fn(params_tree[k]) for k, fn in frozen.items() if k in params_tree}
    out = {}
    for p in paths:
        if p[0] in trees:
            out[p] = "f" if _tree_get(trees[p[0]], p[1:]) == "train" else "frozen"
        else:
            out[p] = "f" if p[0] in _F_KEYS else "g"
    return out


class Optimizer:
    """An :class:`OptimizerSpec` bound to a model's parameters.

    ``step()`` (after ``backward``) applies the update, accumulating first
    under ``accum_iters``; :meth:`state_tree` / :meth:`load_state_tree`
    write and read optax's state-dict layout.
    """

    def __init__(self, spec: OptimizerSpec, model: nn.Module):
        self.spec = spec
        entries = [(path[1:], t, layout) for path, t, layout in model_entries(model)
                   if path[0] == "params"]
        covered = {id(t) for _, t, _ in entries}
        missing = [n for n, p in model.named_parameters() if id(p) not in covered]
        if missing:
            raise ValueError(f"parameters outside the JAX tree: {missing[:5]}")
        self.entries = entries
        shapes = {}
        for path, t, layout in entries:
            _tree_set(shapes, path, to_jax_layout(t, layout))
        self.labels = _labels(spec, shapes, [p for p, _, _ in entries])
        lrs = {"adam": spec.lr, "g": spec.lr, "train": spec.lr, "f": spec.f_lr,
               "frozen": None}
        self.groups = {}                    # label -> [param]
        for path, t, _ in entries:
            label = self.labels[path]
            trains = lrs[label] is not None
            t.requires_grad_(trains)
            if trains:
                self.groups.setdefault(label, []).append(t)
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": lrs[label], "label": label}
             for label, ps in self.groups.items()],
            betas=(0.9, 0.999), eps=1e-8) if self.groups else None
        self.trainable = [p for ps in self.groups.values() for p in ps]
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = None

    def zero_grad(self) -> None:
        for p in self.trainable:
            p.grad = None

    def step(self) -> None:
        """Apply this step's gradients (a parameter without one takes a zero
        gradient, as in optax, whose moments decay every step)."""
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        k = self.spec.accum_iters
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.trainable]
            n = self.mini_step
            for p, a in zip(self.trainable, self.acc):
                a.add_((p.grad - a) / (n + 1))      # optax's running mean
            self.mini_step = (n + 1) % k
            if self.mini_step:
                self.zero_grad()
                return
            for p, a in zip(self.trainable, self.acc):
                p.grad = a.clone()
                a.zero_()
            self.gradient_step += 1
        if self.adam is not None:
            self.adam.step()
        self.zero_grad()

    # -- optax state-dict layout ---------------------------------------------------

    def _adam_state(self, label: Optional[str]) -> dict:
        """``{'0': {count, mu, nu}, '1': {}}`` of the Adam over ``label``'s
        parameters (all for 'adam'); other leaves masked (``{}``)."""
        mu, nu, count = {}, {}, 0
        for path, t, layout in self.entries:
            if self.labels[path] != label:
                _tree_set(mu, path, {})
                _tree_set(nu, path, {})
                continue
            st = self.adam.state.get(t, {}) if self.adam is not None else {}
            if st:
                count = int(st["step"])
                m, v = st["exp_avg"], st["exp_avg_sq"]
            else:
                m = v = torch.zeros_like(t)
            _tree_set(mu, path, _jax_view(m, layout).clone())
            _tree_set(nu, path, _jax_view(v, layout).clone())
        return {"0": {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}, "1": {}}

    def state_tree(self) -> dict:
        """The optax state in ``to_state_dict`` layout: copies of the moments
        (and accumulated gradients) as torch tensors in the JAX layout, the
        counts as numpy int32 scalars."""
        if self.spec.kind == "adam":
            return self._adam_state("adam")
        if self.spec.kind == "masked":
            return {"inner_states": {"train": {"inner_state": self._adam_state("train")},
                                     "frozen": {"inner_state": {}}}}
        inner = {"g": {"inner_state": self._adam_state("g")},
                 "f": {"inner_state": self._adam_state("f")
                       if self.spec.f_lr is not None else {}},
                 "frozen": {"inner_state": {}}}
        state = {"inner_states": inner}
        if self.spec.accum_iters > 1:
            acc = {}
            by_id = {id(p): a for p, a in zip(self.trainable, self.acc or [])}
            for path, t, layout in self.entries:
                a = by_id.get(id(t))
                _tree_set(acc, path, _jax_view(a if a is not None else torch.zeros_like(t),
                                               layout).clone())
            state = {"acc_grads": acc,
                     "gradient_step": np.asarray(self.gradient_step, np.int32),
                     "inner_opt_state": state,
                     "mini_step": np.asarray(self.mini_step, np.int32),
                     "skip_state": {}}
        return state

    def load_state_tree(self, tree: dict) -> None:
        """Read optax's ``to_state_dict`` layout (JAX layout arrays)."""
        layouts = {path: (t, layout) for path, t, layout in self.entries}
        if self.spec.accum_iters > 1:
            self.mini_step = int(tree["mini_step"])
            self.gradient_step = int(tree["gradient_step"])
            self.acc = [None] * len(self.trainable)
            index = {id(p): i for i, p in enumerate(self.trainable)}
            for path, (t, layout) in layouts.items():
                if id(t) in index:
                    self.acc[index[id(t)]] = _tensor_like(
                        _tree_get(tree["acc_grads"], path), layout, t)
            tree = tree["inner_opt_state"]
        if self.spec.kind == "adam":
            adams = {"adam": tree}
        else:
            adams = {k: v["inner_state"] for k, v in tree["inner_states"].items()
                     if k in ("g", "f", "train")}
        for label, st in adams.items():
            if not st:
                continue
            count = int(st["0"]["count"])
            for path, (t, layout) in layouts.items():
                if self.labels[path] != label or count == 0:
                    continue
                mu = _tree_get(st["0"]["mu"], path)
                nu = _tree_get(st["0"]["nu"], path)
                self.adam.state[t] = {"step": torch.tensor(float(count)),
                                      "exp_avg": _tensor_like(mu, layout, t),
                                      "exp_avg_sq": _tensor_like(nu, layout, t)}


def _tensor_like(a, layout: str, t: torch.Tensor) -> torch.Tensor:
    """A JAX-layout array as a tensor shaped, typed and placed like ``t``."""
    return torch.tensor(np.array(from_jax_layout(a, layout)), dtype=t.dtype, device=t.device)


# -- the train state -------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """A model with its bound optimiser and the number of train steps taken
    (the JAX package's ``TrainState``: the parameters, BatchNorm statistics
    and FAVOR projections live in the model)."""
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def variables(self) -> dict:
        """The model's variables tree in the JAX layout (numpy)."""
        return jax_variables(self.model)


def create_train_state(model: nn.Module, tx: OptimizerSpec, *, generator=None,
                       device=None, init: bool = True) -> TrainState:
    """Bind ``tx`` to ``model`` (moved to ``device``), after redrawing its
    weights from flax's initialisers with ``generator`` (default: a CPU
    generator seeded 0) unless ``init=False``."""
    if init:
        flax_init_(model, generator if generator is not None
                   else torch.Generator().manual_seed(0))
    if device is not None:
        model.to(torch.device(device))
    return TrainState(model, Optimizer(tx, model), 0)


def load_f_params(state: TrainState, f_variables: Mapping,
                  key: str = "patch_classifier") -> TrainState:
    """Copy a trained f's variables tree (``params``, ``batch_stats``, and
    every other collection, e.g. an scBERT f's ``favor`` projections) into
    the grid model's f at ``key``."""
    load_variables(getattr(state.model, key), {c: v for c, v in f_variables.items()
                                                if v is not None})
    return state


# -- losses ----------------------------------------------------------------------


def _at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """Losses reduce in float32, or in float64 for a float64 model."""
    return t if t.dtype == torch.float64 else t.float()


def _total(n: torch.Tensor, reduce_count: Optional[Callable]) -> torch.Tensor:
    """The loss's denominator: ``n``, or on a mesh its sum over the ranks
    (``reduce_count``), so the ranks' losses add up to the global mean."""
    return (n if reduce_count is None else reduce_count(n)).clamp_min(1)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         reduce_count: Optional[Callable] = None):
    """Foreground-masked CE over ``(..., C)`` logits and ``(...)`` labels
    (0 background, 1..C foreground): (mean CE over foreground, n_correct,
    n_foreground). ``reduce_count``: the mesh's sum of the foreground count
    over the ranks (the mean is over the global batch's foreground)."""
    logits = _at_least_f32(logits.reshape(-1, logits.shape[-1]))
    labels = labels.reshape(-1)
    mask = labels > 0
    fg = (labels - 1).clamp_min(0)
    ce = F.cross_entropy(logits, fg, reduction="none")
    n = mask.sum()
    loss = torch.where(mask, ce, torch.zeros_like(ce)).sum() / _total(n, reduce_count)
    n_correct = (mask & (logits.argmax(-1) == fg)).sum()
    return loss, n_correct, n


def _spot_loss(logits: torch.Tensor, labels: torch.Tensor,
               reduce_count: Optional[Callable] = None):
    """Plain CE; labels < 0 mark padding rows, excluded from loss and
    accuracy."""
    logits = _at_least_f32(logits)
    mask = labels >= 0
    safe = labels.clamp_min(0)
    ce = F.cross_entropy(logits, safe, reduction="none")
    n = mask.sum()
    loss = torch.where(mask, ce, torch.zeros_like(ce)).sum() / _total(n, reduce_count)
    n_correct = (mask & (logits.argmax(-1) == safe)).sum()
    return loss, n_correct, n


def _spot_mse(preds: torch.Tensor, targets: torch.Tensor,
              reduce_count: Optional[Callable] = None):
    """Regression objective; non-finite target rows mark padding."""
    finite = torch.isfinite(targets)
    row_valid = finite.reshape(finite.shape[0], -1).all(1)
    safe = torch.where(finite, targets, torch.zeros_like(targets))
    per_row = ((_at_least_f32(preds) - safe) ** 2).reshape(preds.shape[0], -1).mean(1)
    n = row_valid.sum()
    mse = torch.where(row_valid, per_row, torch.zeros_like(per_row)).sum() / _total(
        n, reduce_count)
    return mse, torch.zeros((), dtype=torch.int64, device=preds.device), n


_LOSSES = {"grid": masked_cross_entropy, "spot": _spot_loss, "spot_mse": _spot_mse}


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by (``seed``, ``step``): the port's
    ``fold_in(key(seed), step)``."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        seed * 1_000_003 + int(step))


def _device_of(x) -> torch.device:
    return (x[0] if isinstance(x, (tuple, list)) else x).device


class _MeshStep:
    """What a step does on a training mesh: the sharding context around the
    forward and backward (global-batch BatchNorm over every rank, the
    ``spot`` share of grid rows, this rank's rows for the random draws),
    the loss's denominator summed over the ranks, the gradients summed
    after the backward, and the metrics summed for the report."""

    def __init__(self, rows: np.ndarray, batch_size: int, copies: int = 1):
        from gridnext_tpu_torch.parallel import collectives

        self.c = collectives
        # rows: the indices of this rank's (contiguous) rows of the batch
        self.rows = collectives.RowShard(int(rows[0]), int(rows[-1]) + 1, batch_size)
        self.copies = copies      # ranks that hold the same rows (a spot group)
        self.spot = None          # set a grid batch at a time (mesh.spot_rows)
        self.tokens = None        # this rank's token columns (a seq axis), a phase at a time

    def context(self):
        import torch.distributed as dist

        return self.c.sharded(dist.group.WORLD, self.spot, self.rows, self.tokens)

    def reduce_count(self, n: torch.Tensor) -> torch.Tensor:
        return self.c.all_reduce_(n.clone())

    def reduce_grads(self, params) -> None:
        self.c.all_reduce_grads(params)

    def reduce_metrics(self, loss, n_correct, n) -> dict:
        vals = self.c.all_reduce_(torch.stack([loss.detach().double(), n_correct.double(),
                                               n.double()]))
        # the copies of a spot group count their rows once each; their
        # losses already split the global one
        return {"loss": vals[0].to(loss.dtype), "n_correct": vals[1].long() // self.copies,
                "n": vals[2].long() // self.copies}


def _step_metrics(ms: Optional[_MeshStep], loss, n_correct, n) -> dict:
    """A step's device metrics, the global batch's on a mesh."""
    if ms is not None:
        return ms.reduce_metrics(loss, n_correct, n)
    return {"loss": loss.detach(), "n_correct": n_correct, "n": n}


def make_steps(state: TrainState, loss_kind: str, augment: Optional[Callable] = None,
               mesh_step: Optional[_MeshStep] = None):
    """(train_step, eval_step) closures over ``state``: ``train_step(x, y)``
    runs one optimiser step in train mode and returns the device metrics
    ``{loss, n_correct, n}``; ``eval_step(x, y)`` the metrics in eval mode,
    without gradients.

    ``augment``: optional ``fn(generator, x) -> x`` applied to the train
    batch only, with a generator seeded by the step
    (``pipeline.make_train_augment``). Dropout draws from a generator seeded
    by the step too. ``mesh_step``: this rank's part of a mesh's step (the
    trainers build it from ``mesh``); the metrics are then the global
    batch's.
    """
    loss_fn = _LOSSES[loss_kind]
    model = state.model
    ms = mesh_step
    context = ms.context if ms is not None else contextlib.nullcontext
    reduce_count = ms.reduce_count if ms is not None else None

    def train_step(x, y):
        dev = _device_of(x)
        model.train()
        set_dropout_generator(model, _step_generator(_DROPOUT_SEED, state.step, dev))
        with context():
            if augment is not None:
                x = augment(_step_generator(_AUGMENT_SEED, state.step, dev), x)
            loss, n_correct, n = loss_fn(model(x), y, reduce_count)
            loss.backward()
        if ms is not None:
            ms.reduce_grads(state.optimizer.trainable)
        state.optimizer.step()
        state.step += 1
        return _step_metrics(ms, loss, n_correct, n)

    def eval_step(x, y):
        model.eval()
        with torch.no_grad(), context():
            loss, n_correct, n = loss_fn(model(x), y, reduce_count)
        return _step_metrics(ms, loss, n_correct, n)

    return train_step, eval_step


def _mlm_mask(generator: torch.Generator, shape, mask_prob: float, device) -> torch.Tensor:
    """The positions an MLM step corrupts: each with probability
    ``mask_prob``, drawn from ``generator``."""
    return torch.rand(tuple(shape), generator=generator, device=device) < mask_prob


def mlm_loss(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             reduce_count: Optional[Callable] = None):
    """Masked-LM CE over ``(B, n, V)`` logits at the corrupted positions
    ``mask`` whose clean token ``y`` is not padding (-1): (mean CE,
    n_correct, n)."""
    valid = mask & (y >= 0)
    safe = y.clamp_min(0).long()
    logits = _at_least_f32(logits)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), safe.reshape(-1),
                         reduction="none").reshape(y.shape)
    n = valid.sum()
    loss = torch.where(valid, ce, torch.zeros_like(ce)).sum() / _total(n, reduce_count)
    n_correct = (valid & (logits.argmax(-1) == safe)).sum()
    return loss, n_correct, n


def make_mlm_steps(state: TrainState, *, mask_id: int, mask_prob: float = 0.15,
                   mesh_step: Optional[_MeshStep] = None):
    """(train_step, eval_step) for masked-LM pretraining: the JAX
    package's ``make_mlm_steps``.

    Batches are (x, y) with x a per-row dummy and y the clean ``(B, n)``
    integer tokens, -1 marking padding rows. Each step corrupts a
    ``mask_prob`` share of the tokens to ``mask_id`` (pad rows clamped to
    token 0 for the forward and left out of the loss) and minimises the CE
    of the clean token at the corrupted positions. The train mask is drawn
    from a generator seeded by the step, the eval mask from a fixed one
    (:func:`_mlm_mask` draws both), so validation losses compare across
    epochs. ``mesh_step`` as in :func:`make_steps`; on a ``seq`` axis a
    rank's mask is its rows and token columns of the global batch's.
    """
    from gridnext_tpu_torch.parallel.collectives import draw_rows

    model = state.model
    ms = mesh_step
    context = ms.context if ms is not None else contextlib.nullcontext
    reduce_count = ms.reduce_count if ms is not None else None

    def corrupt(generator, y):
        mask = draw_rows(lambda shape: _mlm_mask(generator, shape, mask_prob, y.device),
                         y.shape, token_dim=1)
        return torch.where(mask, torch.full_like(y, mask_id), y.clamp_min(0)).long(), mask

    def train_step(x, y):
        dev = y.device
        model.train()
        set_dropout_generator(model, _step_generator(_DROPOUT_SEED, state.step, dev))
        with context():
            tokens, mask = corrupt(_step_generator(_MLM_SEED, state.step, dev), y)
            loss, n_correct, n = mlm_loss(model(tokens), y, mask, reduce_count)
            loss.backward()
        if ms is not None:
            ms.reduce_grads(state.optimizer.trainable)
        state.optimizer.step()
        state.step += 1
        return _step_metrics(ms, loss, n_correct, n)

    def eval_step(x, y):
        model.eval()
        with torch.no_grad(), context():
            tokens, mask = corrupt(_step_generator(_MLM_EVAL_SEED, 0, y.device), y)
            loss, n_correct, n = mlm_loss(model(tokens), y, mask, reduce_count)
        return _step_metrics(ms, loss, n_correct, n)

    return train_step, eval_step


# -- batches ---------------------------------------------------------------------


def _is_dataset(data) -> bool:
    """Map-style dataset (yields (x, y) per index) vs (inputs, labels) pair."""
    return hasattr(data, "__getitem__") and not isinstance(
        data, (tuple, list)) and not hasattr(data, "ndim")


def _stack(parts):
    return torch.stack(parts) if torch.is_tensor(parts[0]) else np.stack(parts)


def _cast_labels(y, loss_kind: str):
    """The JAX loop's label casts: MSE targets to float32, unsigned spot
    labels to int32."""
    if loss_kind == "spot_mse" and not np.issubdtype(y.dtype, np.floating):
        y = y.astype(np.float32)
    if (loss_kind not in ("grid", "spot_mse")
            and np.issubdtype(y.dtype, np.unsignedinteger)):
        y = y.astype(np.int32)
    return y


def _pad_fill(loss_kind: str):
    """The label of a padding item: 0 for grid CE, -1 for spot CE, NaN
    targets for MSE."""
    return np.nan if loss_kind == "spot_mse" else (0 if loss_kind == "grid" else -1)


def _pad_batch(x, y, batch_size: int, loss_kind: str):
    """Pad a partial (x, y) minibatch to ``batch_size``: inputs repeat the
    final item (BatchNorm sees the pads as in the JAX loop), labels mark
    the pads for the masked losses (:func:`_pad_fill`), cast as the JAX
    loop casts them (:func:`_cast_labels`)."""
    y = _cast_labels(y, loss_kind)
    n_pad = batch_size - len(y)
    if n_pad <= 0:
        return x, y

    def pad_x(a):
        if torch.is_tensor(a):
            return torch.cat([a, a[-1:].expand((n_pad,) + tuple(a.shape[1:]))])
        return np.concatenate([a, np.repeat(a[-1:], n_pad, axis=0)])

    x = tuple(pad_x(a) for a in x) if isinstance(x, tuple) else pad_x(x)
    y = np.concatenate([y, np.full((n_pad,) + y.shape[1:], _pad_fill(loss_kind), y.dtype)])
    return x, y


def _iter_batches(data, batch_size, rng: Optional[np.random.Generator],
                  pad_kind: Optional[str] = None, skip: int = 0,
                  shard: Optional[Callable] = None, columns: Optional[slice] = None):
    """Yield (x, y, n_real) minibatches in the JAX loop's order.

    ``data``: an (inputs, labels) pair (``inputs`` an array or tensor, or a
    tuple of them; labels numpy) or a map-style dataset; a dataset with a ``batch(idx)``
    method builds a batch in one call (the slide datasets crop a batch in
    one gather launch), else its items are stacked. ``rng`` draws the
    epoch's permutation (None: file order); ``skip`` drops the first
    ``skip`` batches after the draw; ``pad_kind`` pads partial batches.
    ``shard``: on a mesh, :func:`_mesh_placement`'s function; only this
    rank's rows of each padded global batch are built (padding rows repeat
    the last item and carry the padding label), and ``n_real`` stays the
    global batch's. ``columns``: this rank's token columns of the labels
    (a ``seq`` axis).
    """

    def finish(x, y):
        n_real = len(y)
        if pad_kind is not None:
            x, y = _pad_batch(x, y, batch_size, pad_kind)
        return x, y, n_real

    def fetch(idx):
        if not _is_dataset(data):
            inputs, labels = data
            if isinstance(inputs, (tuple, list)):
                return tuple(_take(a, idx) for a in inputs), np.asarray(labels)[idx]
            return _take(inputs, idx), np.asarray(labels)[idx]
        if hasattr(data, "batch"):
            x, y = data.batch(idx)
            return x, np.asarray(y)
        items = [data[int(j)] for j in idx]
        xs = [it[0] for it in items]
        ys = np.stack([np.asarray(it[1]) for it in items])
        if isinstance(xs[0], (tuple, list)):
            return tuple(_stack(list(z)) for z in zip(*xs)), ys
        return _stack(xs), ys

    n = len(data) if _is_dataset(data) else len(data[1])
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for i in range(skip * batch_size, n, batch_size):
        idx = order[i:i + batch_size]
        if shard is None:
            yield finish(*fetch(idx))
            continue
        n_real = len(idx)
        full = np.concatenate([idx, np.repeat(idx[-1:], batch_size - n_real)])
        local, pad = shard((full, np.arange(batch_size) >= n_real))
        x, y = fetch(local)
        y = _cast_labels(np.array(y), pad_kind)
        if pad.any():
            y[pad] = _pad_fill(pad_kind)
        if columns is not None:
            y = np.ascontiguousarray(y[:, columns])
        yield x, y, n_real


def _take(a, idx):
    """Rows ``idx`` of a numpy array or a tensor (on its device)."""
    if torch.is_tensor(a):
        return a[torch.as_tensor(idx, device=a.device)]
    return np.asarray(a)[idx]


# Steps the epoch loop keeps dispatched but unread, and the staging depth.
_PIPELINE_DEPTH = 2


def _prefetch_to_device(batches, device, size: int = _PIPELINE_DEPTH):
    """Stage upcoming (x, y, n_real) batches onto ``device`` ``size`` ahead.

    On CUDA, host arrays are pinned and copied on a side stream; the
    consumer's stream waits on each batch's copy event (and the batch is
    recorded on that stream, so its memory is not reused early), letting
    the next batch's host work and copy overlap the current step. Tensors
    already on the device pass through.
    """
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(a):
        if torch.is_tensor(a):
            return a.to(device, non_blocking=True)
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if stream is not None \
            else t.to(device)

    def staged(batch):
        x, y, n_real = batch
        if stream is None:
            return (tuple(map(put, x)) if isinstance(x, tuple) else put(x)), put(y), n_real, None
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            x = tuple(map(put, x)) if isinstance(x, tuple) else put(x)
            y = put(y)
            event = torch.cuda.Event()
            event.record(stream)
        return x, y, n_real, event

    queue = collections.deque(staged(b) for b in itertools.islice(batches, size))
    while queue:
        x, y, n_real, event = queue.popleft()
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in (x if isinstance(x, tuple) else (x,)) + (y,):
                t.record_stream(current)
        queue.extend(staged(b) for b in itertools.islice(batches, 1))
        yield x, y, n_real


def _num_items(data) -> int:
    if data is None:
        return 0
    return len(data) if _is_dataset(data) else len(data[1])


# -- checkpoints -----------------------------------------------------------------


def _payload_tree(state: TrainState, include_opt_state: bool = True) -> dict:
    """The checkpoint payload with torch tensors (cloned, in the JAX
    layout) at its array leaves; :func:`_host_tree` makes it numpy."""
    tree: dict = {}
    for path, t, layout in model_entries(state.model):
        _tree_set(tree, path, _jax_view(t.detach(), layout).clone())
    payload = {"params": tree.get("params", {}),
               "batch_stats": tree.get("batch_stats"),
               "extra_vars": {k: v for k, v in tree.items()
                              if k not in ("params", "batch_stats")},
               "step": int(state.step)}
    if include_opt_state:
        payload["opt_state"] = state.optimizer.state_tree()
    return payload


def _jax_view(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "conv":
        return t.permute(2, 3, 1, 0)      # OIHW -> HWIO
    if layout == "dense":
        return t.t()
    return t


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return np.ascontiguousarray(tree.cpu().numpy())
    return tree


def save_checkpoint(path, state: TrainState, include_opt_state: bool = True,
                    extra_meta: Optional[Mapping] = None) -> None:
    """Write ``state`` as the JAX package's ``save_checkpoint`` does:
    ``params``, ``batch_stats``, ``extra_vars``, ``step``, ``opt_state``
    (optax's state-dict layout) and the ``extra_meta`` scalars (None values
    left out), msgpack written beside and renamed into place."""
    write_payload(path, _payload_tree(state, include_opt_state), extra_meta)


def write_payload(path, payload: dict, extra_meta: Optional[Mapping] = None) -> None:
    """Write a :func:`_payload_tree` (its tensors copied to the host here)
    with the ``extra_meta`` scalars."""
    payload = _host_tree(payload)
    if extra_meta:
        payload.update({k: v for k, v in extra_meta.items() if v is not None})
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(flax_msgpack.packb(payload))
    os.replace(tmp, path)   # atomic: a killed run never leaves a torn file


def _variables_of(payload: Mapping) -> dict:
    variables = {"params": payload["params"]}
    if payload.get("batch_stats") is not None:
        variables["batch_stats"] = payload["batch_stats"]
    variables.update(payload.get("extra_vars") or {})
    return variables


def _state_from_payload(payload: Mapping, state: TrainState) -> TrainState:
    load_variables(state.model, _variables_of(payload))
    if payload.get("opt_state") is not None:
        state.optimizer.load_state_tree(payload["opt_state"])
    state.step = int(payload.get("step", 0))
    return state


def restore_train_state(path, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (a freshly created state for the
    same model and optimiser) and return it."""
    return _state_from_payload(load_checkpoint(path), state)


def _snapshot(model: nn.Module) -> dict:
    """Device copies of every parameter and buffer (the best-val snapshot)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# -- the epoch loop --------------------------------------------------------------


def _resolve_mesh(mesh, mesh_shape):
    """Public trainers accept ``mesh`` (a :class:`~gridnext_tpu_torch.
    parallel.Mesh`) or ``mesh_shape`` (e.g. {'data': 4, 'spot': 2}, or
    'auto' for the default data x spot factorization over the ranks)."""
    if isinstance(mesh, (str, dict)):
        if mesh_shape is not None:
            raise ValueError("pass mesh= (a gridnext_tpu_torch.parallel.Mesh) OR "
                             f"mesh_shape=, not both (got mesh={mesh!r} "
                             f"and mesh_shape={mesh_shape!r})")
        # mesh='auto' / mesh={'data': 4} is a natural slip for mesh_shape=...
        mesh, mesh_shape = None, mesh
    if mesh is not None:
        return mesh
    if mesh_shape is None:
        return None
    from gridnext_tpu_torch.parallel.mesh import default_mesh_shape, training_mesh
    from gridnext_tpu_torch.parallel.multihost import process_count

    if isinstance(mesh_shape, str):
        if mesh_shape != "auto":
            raise ValueError(f"mesh_shape must be a dict or 'auto'; got {mesh_shape!r}")
        mesh_shape = default_mesh_shape(process_count())
    return training_mesh(mesh_shape)


def _mesh_placement(mesh, loss_kind, batch_size) -> Callable:
    """This rank's rows of every padded global batch: a function taking a
    tree of arrays (the batch's item indices) to this rank's rows. Grid
    batches shard over ``data`` (:func:`~gridnext_tpu_torch.parallel.mesh.
    shard_grid_batch`; the ``spot`` axis splits each grid's rows inside the
    grid model); spot and MLM batches shard their item axis over every mesh
    axis (``shard_spot_batch``). Padding to a fixed ``batch_size`` keeps
    the batch axis shardable; the masked losses ignore the pad items. MLM
    batches on a mesh with a ``seq`` axis go sequence-parallel: the rows
    over ``data`` (here), the token columns over ``seq``
    (:func:`_token_shard`)."""
    from gridnext_tpu_torch.parallel.mesh import shard_grid_batch, shard_spot_batch

    axis_sizes = dict(mesh.shape)
    seq = loss_kind == "mlm" and "seq" in axis_sizes
    div = axis_sizes.get("data", 1) if loss_kind == "grid" or seq else mesh.size
    if batch_size % div:
        raise ValueError(
            f"batch_size {batch_size} is not divisible by the mesh's batch "
            f"sharding factor {div} (mesh axes {axis_sizes}); pick a batch "
            "size divisible by it")
    if seq:
        return lambda tree: shard_grid_batch(tree, mesh, spot_axis=None)
    shard = shard_grid_batch if loss_kind == "grid" else shard_spot_batch
    return lambda tree: shard(tree, mesh)


def _token_len(data) -> int:
    """The token count of an MLM phase's rows (labels ``(N, n)``)."""
    return len(np.asarray(data[0][1])) if _is_dataset(data) else np.shape(data[1])[1]


def _token_shard(mesh, n_tokens: int):
    """(this rank's :class:`~gridnext_tpu_torch.parallel.collectives.
    TokenShard` of ``n_tokens``, or None where the tokens replicate; the
    ranks that hold the same rows and tokens) on a mesh with a ``seq``
    axis."""
    from gridnext_tpu_torch.parallel.collectives import TokenShard
    from gridnext_tpu_torch.parallel.mesh import token_columns

    cols = token_columns(n_tokens, mesh)
    if cols is None or mesh.axis_size("seq") == 1:
        return None, mesh.size // mesh.axis_size("data")
    return (TokenShard(mesh.group("seq"), cols.start, cols.stop, n_tokens),
            mesh.size // (mesh.axis_size("data") * mesh.axis_size("seq")))


def _run_training(state: TrainState, dataloaders, loss_kind, num_epochs, batch_size,
                  outfile, shuffle_seed, verbose, device, metrics_logger=None,
                  resume=None, augment=None, redraw_every: Optional[int] = None,
                  mlm: Optional[Mapping] = None, mesh=None):
    from gridnext_tpu_torch.models.performer import (fast_attentions, redraw_projections,
                                                     shard_sequence)

    # On a training mesh each rank builds its rows of every padded global
    # batch, the step sums the loss's count, the gradients and the metrics
    # over the ranks (global-batch BatchNorm inside), and only the primary
    # writes files
    shard = ms = None
    distributed = mesh is not None and mesh.distributed
    if distributed:
        from gridnext_tpu_torch.parallel import collectives, is_primary, replicate
        from gridnext_tpu_torch.parallel.mesh import spot_rows
        from gridnext_tpu_torch.parallel.multihost import host_group

        shard = _mesh_placement(mesh, loss_kind, batch_size)
        ms = _MeshStep(shard(np.arange(batch_size)), batch_size,
                       copies=mesh.size // mesh.axis_size("data") if loss_kind == "grid" else 1)
        if not is_primary():
            metrics_logger, verbose = None, False
    mesh_kw = {} if ms is None else {"mesh_step": ms}
    if loss_kind == "mlm":
        train_step, eval_step = make_mlm_steps(state, **(mlm or {}), **mesh_kw)
    else:
        train_step, eval_step = make_steps(state, loss_kind, augment=augment, **mesh_kw)
    rng = np.random.default_rng(shuffle_seed)
    redraws = bool(redraw_every) and bool(fast_attentions(state.model))

    start_epoch = start_batch = redraws_done = 0
    resumed_best = None
    if resume is not None:
        payload = load_checkpoint(resume)
        state = _state_from_payload(payload, state)
        start_epoch = int(payload.get("epochs_done", 0))
        start_batch = int(payload.get("batches_done", 0))
        if start_batch:
            # batches_done counts batches of the preempted run: another batch
            # size or seed would skip the wrong samples
            for key, cur in (("batch_size", batch_size), ("shuffle_seed", shuffle_seed)):
                saved = payload.get(key)
                if saved is not None and saved != cur:
                    raise ValueError(
                        f"mid-epoch resume: the checkpoint was written with "
                        f"{key}={saved} but this run uses {cur}; rerun with "
                        f"the original {key} (batches_done counts batches "
                        "of the preempted run's size)")
        rb = payload.get("best_val_loss")
        if rb is not None and np.isfinite(rb):
            resumed_best = float(rb)
        n_train = _num_items(dataloaders.get("train"))
        for _ in range(start_epoch):
            rng.permutation(max(n_train, 1))     # replay the epochs' shuffles
        if redraw_every:
            # a warm-started run fires its first redraw at the next boundary,
            # so the count is recorded rather than derived from the step
            done = payload.get("redraws_done")
            redraws_done = int(state.step) // redraw_every if done is None else int(done)

    if distributed:
        replicate(state.model, mesh)      # every replica starts from rank 0's
    ckpt_writer = None
    if outfile is not None and (not distributed or is_primary()):
        from gridnext_tpu_torch.train.async_ckpt import AsyncCheckpointWriter

        ckpt_writer = AsyncCheckpointWriter()

    best_loss = np.inf
    best = _snapshot(state.model)
    saw_val = False
    if resumed_best is not None:
        # the pre-resume best snapshot is the best-val file (written whenever
        # val improved); the current state if the file is gone
        best_loss, saw_val = resumed_best, True
        if outfile is not None and os.path.exists(outfile):
            keep = _snapshot(state.model)
            load_variables(state.model, _variables_of(load_checkpoint(outfile)))
            best = _snapshot(state.model)
            state.model.load_state_dict(keep)
    train_history, val_history = [], []
    since = time.time()

    guard = preempt.active()
    n_train_total = -(-_num_items(dataloaders.get("train")) // batch_size)

    def best_meta():
        return float(best_loss) if np.isfinite(best_loss) else None

    def preempt_checkpoint(epoch, batches_done):
        ckpt = None
        if ckpt_writer is not None:
            ckpt = str(outfile) + ".latest"
            ckpt_writer.save(ckpt, state, extra_meta={
                "epochs_done": epoch, "batches_done": batches_done,
                "batch_size": batch_size, "shuffle_seed": shuffle_seed,
                "redraws_done": redraws_done, "best_val_loss": best_meta()})
        if guard is not None:
            guard.reset()          # the trigger belongs to this run
        raise preempt.TrainingPreempted(ckpt)

    seq = distributed and loss_kind == "mlm" and "seq" in mesh.shape
    try:
        for epoch in range(start_epoch, num_epochs):
            epoch_skip = start_batch if epoch == start_epoch else 0
            if verbose:
                print(f"Epoch {epoch}/{num_epochs - 1}", flush=True)
                print("-" * 10, flush=True)
            for phase in ("train", "val"):
                if dataloaders.get(phase) is None:
                    continue
                # metrics stay on the device; the one from _PIPELINE_DEPTH
                # steps back is read each step (bounding the steps in flight)
                losses, corrs, ns, bszs = [], [], [], []
                columns = None
                if seq:
                    # this phase's token columns: FAVOR sums over the seq
                    # group, and ranks that hold the same tokens count once
                    ms.tokens, ms.copies = _token_shard(mesh, _token_len(dataloaders[phase]))
                    shard_sequence(state.model, ms.tokens)
                    if ms.tokens is not None:
                        columns = slice(ms.tokens.start, ms.tokens.stop)
                batches = _prefetch_to_device(
                    _iter_batches(dataloaders[phase], batch_size,
                                  rng if phase == "train" else None, pad_kind=loss_kind,
                                  skip=epoch_skip if phase == "train" else 0, shard=shard,
                                  columns=columns),
                    device)
                step_fn = train_step if phase == "train" else eval_step
                for x, y, n_real in batches:
                    if ms is not None and loss_kind == "grid":
                        ms.spot = spot_rows(y.shape[1], mesh)
                    m = step_fn(x, y)
                    if (phase == "train" and redraws
                            and state.step % redraw_every == 0):
                        # periodic FAVOR+ projection redraw, redraw r from
                        # its own generator (a resumed run draws the same)
                        redraw_projections(state.model, _step_generator(
                            _REDRAW_SEED, redraws_done, "cpu"))
                        redraws_done += 1
                    losses.append(m["loss"])
                    corrs.append(m["n_correct"])
                    ns.append(m["n"])
                    bszs.append(n_real)
                    lag = len(losses) - 1 - _PIPELINE_DEPTH
                    if lag >= 0:
                        losses[lag] = float(losses[lag])
                        corrs[lag] = int(corrs[lag])
                        ns[lag] = int(ns[lag])
                    stop = guard is not None and guard.triggered
                    if distributed:
                        # every rank stops at the same batch, or the next
                        # collective would wait for the ones that stopped
                        stop = collectives.any_rank(stop, host_group())
                    if stop:
                        preempt_checkpoint(epoch, epoch_skip + len(losses)
                                           if phase == "train" else n_train_total)
                losses = np.asarray([float(v) for v in losses], dtype=float)
                corrs = np.asarray([int(v) for v in corrs])
                ns = np.asarray([int(v) for v in ns])
                bszs = np.asarray(bszs)
                n_items = int(bszs.sum())
                if phase == "train" and epoch_skip and not len(losses):
                    continue       # resumed past the whole train phase
                if n_items == 0:
                    continue       # an empty phase logs no loss (no 0.0 "best")
                epoch_loss = float((losses * bszs).sum()) / max(n_items, 1)
                epoch_acc = int(corrs.sum()) / max(int(ns.sum()), 1)
                if verbose:
                    print(f"{phase} Loss: {epoch_loss:.4f} Acc: {epoch_acc:.4f}", flush=True)
                if metrics_logger is not None:
                    metrics_logger.log(step=int(state.step), epoch=epoch, phase=phase,
                                       loss=epoch_loss, acc=epoch_acc)
                if phase == "val":
                    saw_val = True
                    val_history.append(epoch_loss)
                    if epoch_loss < best_loss:
                        best_loss = epoch_loss
                        best = _snapshot(state.model)
                        if ckpt_writer is not None:
                            ckpt_writer.save(outfile, state)
                else:
                    train_history.append(epoch_loss)
            if ckpt_writer is not None:
                # the resume point: the latest state at each epoch end
                ckpt_writer.save(str(outfile) + ".latest", state, extra_meta={
                    "epochs_done": epoch + 1, "redraws_done": redraws_done,
                    "best_val_loss": best_meta()})
    except BaseException:
        if seq:
            shard_sequence(state.model, None)
        # drain enqueued writes (the best-val file may hold what the user
        # wants back) without masking the exception in flight
        if ckpt_writer is not None:
            try:
                ckpt_writer.close()
            except BaseException as e:
                print(f"warning: background checkpoint write failed: {e}", file=sys.stderr)
        raise

    if seq:
        shard_sequence(state.model, None)     # the returned model holds whole sequences
    if verbose:
        dt = time.time() - since
        print(f"Training complete in {dt // 60:.0f}m {dt % 60:.0f}s", flush=True)
        if saw_val:
            print(f"Best val loss: {best_loss:4f}", flush=True)
    if saw_val:
        state.model.load_state_dict(best)     # the best-validation weights
    elif ckpt_writer is not None:
        ckpt_writer.save(outfile, state)
    if ckpt_writer is not None:
        ckpt_writer.close()                   # every checkpoint on disk
    return state, val_history, train_history


def train_spotwise(model: nn.Module, dataloaders: Mapping, *, learning_rate: float = 1e-4,
                   num_epochs: int = 10, batch_size: int = 128, outfile=None,
                   state: Optional[TrainState] = None, tx: Optional[OptimizerSpec] = None,
                   generator: Optional[torch.Generator] = None, shuffle_seed: int = 0,
                   verbose: bool = True, redraw_every: Optional[int] = None,
                   loss: str = "ce", metrics_logger=None,
                   resume=None, augment=None, device="cuda", mesh=None, mesh_shape=None):
    """Train a spot classifier f: the JAX package's ``train_spotwise``.

    ``dataloaders`` maps 'train'/'val' to (inputs, labels) array pairs with
    labels in ``[0, n_classes)`` (float targets with ``loss='mse'``) or to
    map-style datasets. Without ``state`` the model's weights are drawn
    from flax's initialisers with ``generator`` and bound to Adam
    (``learning_rate``, or ``tx``). ``redraw_every`` redraws a Performer
    f's FAVOR+ projections every that many steps (each at its layer's
    ``ortho_scaling``). ``resume=<outfile>.latest`` continues
    an interrupted run (``num_epochs`` is the total). Runs on ``device``
    (default CUDA). Returns (state, val_history, train_history).

    Several cards: pass ``mesh`` (a :class:`~gridnext_tpu_torch.parallel.
    Mesh`) or ``mesh_shape`` (e.g. {'data': 8}, or 'auto') in every process
    of a process group (one a card; ``parallel.initialize_multihost``). The
    replicas start from rank 0's weights, each batch's item axis shards
    over every mesh axis (``batch_size`` divisible by the world size),
    partial batches pad with loss-masked items, BatchNorm normalises over
    the global batch, the gradients sum over the ranks, and only rank 0
    writes files: the trajectory is the single-process one within float
    rounding.
    """
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, mesh_shape)
    if state is None:
        state = create_train_state(model, tx or make_adam(learning_rate),
                                   generator=generator, device=device)
    else:
        state.model.to(device)
    kind = {"ce": "spot", "mse": "spot_mse"}[loss]
    return _run_training(state, dataloaders, kind, num_epochs, batch_size, outfile,
                         shuffle_seed, verbose, device, metrics_logger=metrics_logger,
                         resume=resume, augment=augment, redraw_every=redraw_every,
                         mesh=mesh)


def train_gridwise(model: nn.Module, dataloaders: Mapping, *, learning_rate: float = 1e-3,
                   f_lr: Optional[float] = None, accum_iters: int = 1,
                   num_epochs: int = 10, batch_size: int = 1, outfile=None,
                   state: Optional[TrainState] = None, tx: Optional[OptimizerSpec] = None,
                   generator: Optional[torch.Generator] = None, shuffle_seed: int = 0,
                   verbose: bool = True, metrics_logger=None, resume=None, augment=None,
                   device="cuda", mesh=None, mesh_shape=None):
    """Train a grid model g with the foreground-masked CE: the JAX
    package's ``train_gridwise``.

    ``dataloaders`` maps 'train'/'val' to (inputs, labels) pairs, inputs
    ``(N, H, W, ...)`` (a tuple for the multimodal models) and labels
    ``(N, H, W)`` with 0 background, or to map-style datasets. ``f_lr``
    trains f with its own Adam; otherwise f is frozen (and runs without
    gradients). Other arguments as :func:`train_spotwise`.

    On a mesh (``mesh`` / ``mesh_shape``, e.g. {'data': 4, 'spot': 2}) the
    grid batch shards over ``data`` (``batch_size`` divisible by its size)
    and the ranks of a ``spot`` group split each grid's rows for f and
    gather its features (a grid H the axis does not divide warns and runs
    f on every row); g runs on the whole grids with BatchNorm over the
    global batch.
    """
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, mesh_shape)
    if state is None:
        state = create_train_state(
            model, tx or make_gridwise_optimizer(learning_rate, f_lr, accum_iters),
            generator=generator, device=device)
    else:
        state.model.to(device)
    return _run_training(state, dataloaders, "grid", num_epochs, batch_size, outfile,
                         shuffle_seed, verbose, device, metrics_logger=metrics_logger,
                         resume=resume, augment=augment, mesh=mesh)


def mlm_token_len(n_tokens: int, mesh=None, mesh_shape=None) -> int:
    """The token-axis length ``train_mlm`` will actually run under a mesh.

    Sequence-parallel meshes (a ``seq`` axis) need the token axis divisible
    by the axis size; ``train_mlm`` pads indivisible array corpora with
    ``-1`` columns (ignored by the masked loss; map-style datasets pass
    through unpadded and replicate their tokens with a warning). Size
    length-sensitive model fields (``PerformerLM.max_seq_len``) with this
    so the padded batch passes the model's bounds check.
    """
    shape = mesh.shape if mesh is not None and not isinstance(mesh, (str, dict)) else (
        mesh if isinstance(mesh, dict) else mesh_shape)
    s = shape.get("seq", 1) if isinstance(shape, dict) else 1
    return int(n_tokens) + (-int(n_tokens)) % s


def train_mlm(model: nn.Module, dataloaders: Mapping, *, mask_id: int,
              mask_prob: float = 0.15, learning_rate: float = 1e-4, num_epochs: int = 10,
              batch_size: int = 4, outfile=None, state: Optional[TrainState] = None,
              tx: Optional[OptimizerSpec] = None, generator: Optional[torch.Generator] = None,
              shuffle_seed: int = 0, verbose: bool = True, redraw_every: Optional[int] = None,
              metrics_logger=None, resume=None, device="cuda", mesh=None, mesh_shape=None):
    """Masked-LM pretraining of a token LM: the JAX package's ``train_mlm``.

    ``dataloaders`` maps 'train'/'val' to clean integer token arrays
    ``(N, n)`` (binned expression in ``[0, bin_num]``, ``mask_id = bin_num +
    1``), to (dummy, tokens) pairs or to map-style datasets of them. Each
    step corrupts a fresh ``mask_prob`` share of the tokens
    (:func:`make_mlm_steps`); ``redraw_every`` redraws the FAVOR+
    projections every that many steps. Resume, preemption and the best-val
    snapshot (projections included) as in :func:`train_spotwise`, and so is
    a mesh: the rows shard over every axis, or, with a ``seq`` axis, over
    ``data`` with the tokens over ``seq`` (sequence-parallel: FAVOR sums its
    ctx and ksum over the ``seq`` group). There array corpora whose token
    axis ``seq`` does not divide are padded with ``-1`` columns, which the
    masked loss ignores (unsigned corpora are widened to int32 first, so
    the pad stays negative): :func:`mlm_token_len` gives the padded length.
    Returns (state, val_history, train_history).
    """
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, mesh_shape)
    seq_n = mesh.axis_size("seq") if mesh is not None else 1

    def as_pair(tokens):
        if tokens is None or isinstance(tokens, tuple) or _is_dataset(tokens):
            return tokens
        tokens = np.asarray(tokens)
        pad = (-tokens.shape[1]) % seq_n
        if pad:
            if tokens.dtype.kind == "u":
                tokens = tokens.astype(np.int32)     # a -1 pad must stay negative
            tokens = np.concatenate([tokens, np.full((len(tokens), pad), -1, tokens.dtype)],
                                    axis=1)
        return np.zeros((len(tokens), 1), np.int8), tokens

    pairs = {k: as_pair(v) for k, v in dataloaders.items()}
    if state is None:
        state = create_train_state(model, tx or make_adam(learning_rate),
                                   generator=generator, device=device)
    else:
        state.model.to(device)
    return _run_training(state, pairs, "mlm", num_epochs, batch_size, outfile, shuffle_seed,
                         verbose, device, metrics_logger=metrics_logger, resume=resume,
                         redraw_every=redraw_every,
                         mlm={"mask_id": mask_id, "mask_prob": mask_prob}, mesh=mesh)


__all__ = ["Optimizer", "OptimizerSpec", "TrainState", "create_train_state",
           "load_checkpoint", "load_f_params", "make_adam", "make_gridwise_optimizer",
           "make_masked_adam", "make_mlm_steps", "make_steps", "masked_cross_entropy",
           "mlm_loss", "mlm_token_len", "restore_train_state", "save_checkpoint",
           "train_gridwise", "train_mlm", "train_spotwise"]
