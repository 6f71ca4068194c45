"""Training loops of the port: the JAX package's ``train/loops.py`` in
PyTorch, step for step.

* ``train_spotwise`` trains a spot classifier f with plain CE (or MSE);
  ``train_gridwise`` trains a grid model's corrector g (and, with
  ``f_lr``, its f) with the foreground-masked CE over ``(B, H, W, C)``
  logits: background (label 0) masked out, labels shifted to ``[0, N)``.
* The optimiser is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
  0.999, eps 1e-8 outside the square root, bias correction) over parameter
  groups: :func:`make_gridwise_optimizer` gives g ``lr``, f ``f_lr`` or no
  update at all, and ``frozen_f_labels`` subtrees no update; ``accum_iters
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

# seeds of the per-step generators (the JAX loop folds the step into keys 11
# and 19)
_DROPOUT_SEED, _AUGMENT_SEED = 11, 19


# -- the optimiser ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What the JAX trainers' optax transformation is, before it meets a
    model: ``kind`` 'adam' (``optax.adam(lr)`` over every parameter) or
    'gridwise' (:func:`make_gridwise_optimizer`)."""
    kind: str
    lr: float
    f_lr: Optional[float] = None
    accum_iters: int = 1
    frozen_f_labels: Optional[Mapping[str, Callable]] = None


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
        lrs = {"adam": spec.lr, "g": spec.lr, "f": spec.f_lr, "frozen": None}
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
                     if k in ("g", "f")}
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


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Foreground-masked CE over ``(..., C)`` logits and ``(...)`` labels
    (0 background, 1..C foreground): (mean CE over foreground, n_correct,
    n_foreground)."""
    logits = _at_least_f32(logits.reshape(-1, logits.shape[-1]))
    labels = labels.reshape(-1)
    mask = labels > 0
    fg = (labels - 1).clamp_min(0)
    ce = F.cross_entropy(logits, fg, reduction="none")
    n = mask.sum()
    loss = torch.where(mask, ce, torch.zeros_like(ce)).sum() / n.clamp_min(1)
    n_correct = (mask & (logits.argmax(-1) == fg)).sum()
    return loss, n_correct, n


def _spot_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Plain CE; labels < 0 mark padding rows, excluded from loss and
    accuracy."""
    logits = _at_least_f32(logits)
    mask = labels >= 0
    safe = labels.clamp_min(0)
    ce = F.cross_entropy(logits, safe, reduction="none")
    n = mask.sum()
    loss = torch.where(mask, ce, torch.zeros_like(ce)).sum() / n.clamp_min(1)
    n_correct = (mask & (logits.argmax(-1) == safe)).sum()
    return loss, n_correct, n


def _spot_mse(preds: torch.Tensor, targets: torch.Tensor):
    """Regression objective; non-finite target rows mark padding."""
    finite = torch.isfinite(targets)
    row_valid = finite.reshape(finite.shape[0], -1).all(1)
    safe = torch.where(finite, targets, torch.zeros_like(targets))
    per_row = ((_at_least_f32(preds) - safe) ** 2).reshape(preds.shape[0], -1).mean(1)
    n = row_valid.sum()
    mse = torch.where(row_valid, per_row, torch.zeros_like(per_row)).sum() / n.clamp_min(1)
    return mse, torch.zeros((), dtype=torch.int64, device=preds.device), n


_LOSSES = {"grid": masked_cross_entropy, "spot": _spot_loss, "spot_mse": _spot_mse}


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by (``seed``, ``step``): the port's
    ``fold_in(key(seed), step)``."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        seed * 1_000_003 + int(step))


def _device_of(x) -> torch.device:
    return (x[0] if isinstance(x, (tuple, list)) else x).device


def make_steps(state: TrainState, loss_kind: str, augment: Optional[Callable] = None):
    """(train_step, eval_step) closures over ``state``: ``train_step(x, y)``
    runs one optimiser step in train mode and returns the device metrics
    ``{loss, n_correct, n}``; ``eval_step(x, y)`` the metrics in eval mode,
    without gradients.

    ``augment``: optional ``fn(generator, x) -> x`` applied to the train
    batch only, with a generator seeded by the step
    (``pipeline.make_train_augment``). Dropout draws from a generator seeded
    by the step too.
    """
    loss_fn = _LOSSES[loss_kind]
    model = state.model

    def train_step(x, y):
        dev = _device_of(x)
        model.train()
        set_dropout_generator(model, _step_generator(_DROPOUT_SEED, state.step, dev))
        if augment is not None:
            x = augment(_step_generator(_AUGMENT_SEED, state.step, dev), x)
        loss, n_correct, n = loss_fn(model(x), y)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "n_correct": n_correct, "n": n}

    def eval_step(x, y):
        model.eval()
        with torch.no_grad():
            loss, n_correct, n = loss_fn(model(x), y)
        return {"loss": loss, "n_correct": n_correct, "n": n}

    return train_step, eval_step


# -- batches ---------------------------------------------------------------------


def _is_dataset(data) -> bool:
    """Map-style dataset (yields (x, y) per index) vs (inputs, labels) pair."""
    return hasattr(data, "__getitem__") and not isinstance(
        data, (tuple, list)) and not hasattr(data, "ndim")


def _stack(parts):
    return torch.stack(parts) if torch.is_tensor(parts[0]) else np.stack(parts)


def _pad_batch(x, y, batch_size: int, loss_kind: str):
    """Pad a partial (x, y) minibatch to ``batch_size``: inputs repeat the
    final item (BatchNorm sees the pads as in the JAX loop), labels mark
    the pads for the masked losses (0 for grid CE, -1 for spot CE, NaN
    targets for MSE). Casts as the JAX loop does: MSE targets to float32,
    unsigned spot labels to int32."""
    if loss_kind == "spot_mse" and not np.issubdtype(y.dtype, np.floating):
        y = y.astype(np.float32)
    if (loss_kind not in ("grid", "spot_mse")
            and np.issubdtype(y.dtype, np.unsignedinteger)):
        y = y.astype(np.int32)
    n_pad = batch_size - len(y)
    if n_pad <= 0:
        return x, y

    def pad_x(a):
        if torch.is_tensor(a):
            return torch.cat([a, a[-1:].expand((n_pad,) + tuple(a.shape[1:]))])
        return np.concatenate([a, np.repeat(a[-1:], n_pad, axis=0)])

    x = tuple(pad_x(a) for a in x) if isinstance(x, tuple) else pad_x(x)
    fill = np.nan if loss_kind == "spot_mse" else (0 if loss_kind == "grid" else -1)
    y = np.concatenate([y, np.full((n_pad,) + y.shape[1:], fill, y.dtype)])
    return x, y


def _iter_batches(data, batch_size, rng: Optional[np.random.Generator],
                  pad_kind: Optional[str] = None, skip: int = 0):
    """Yield (x, y, n_real) minibatches in the JAX loop's order.

    ``data``: an (inputs, labels) pair (``inputs`` an array or tensor, or a
    tuple of them; labels numpy) or a map-style dataset; a dataset with a ``batch(idx)``
    method builds a batch in one call (the slide datasets crop a batch in
    one gather launch), else its items are stacked. ``rng`` draws the
    epoch's permutation (None: file order); ``skip`` drops the first
    ``skip`` batches after the draw; ``pad_kind`` pads partial batches.
    """

    def finish(x, y):
        n_real = len(y)
        if pad_kind is not None:
            x, y = _pad_batch(x, y, batch_size, pad_kind)
        return x, y, n_real

    if _is_dataset(data):
        n = len(data)
        order = rng.permutation(n) if rng is not None else np.arange(n)
        for i in range(skip * batch_size, n, batch_size):
            idx = order[i:i + batch_size]
            if hasattr(data, "batch"):
                x, y = data.batch(idx)
                yield finish(x, np.asarray(y))
                continue
            items = [data[int(j)] for j in idx]
            xs = [it[0] for it in items]
            ys = np.stack([np.asarray(it[1]) for it in items])
            if isinstance(xs[0], (tuple, list)):
                yield finish(tuple(_stack(list(z)) for z in zip(*xs)), ys)
            else:
                yield finish(_stack(xs), ys)
        return
    inputs, labels = data
    multi = isinstance(inputs, (tuple, list))
    n = len(labels)
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for i in range(skip * batch_size, n, batch_size):
        idx = order[i:i + batch_size]
        if multi:
            yield finish(tuple(_take(a, idx) for a in inputs), np.asarray(labels)[idx])
        else:
            yield finish(_take(inputs, idx), np.asarray(labels)[idx])


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


def _run_training(state: TrainState, dataloaders, loss_kind, num_epochs, batch_size,
                  outfile, shuffle_seed, verbose, device, metrics_logger=None,
                  resume=None, augment=None):
    train_step, eval_step = make_steps(state, loss_kind, augment=augment)
    rng = np.random.default_rng(shuffle_seed)

    start_epoch = start_batch = 0
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

    ckpt_writer = None
    if outfile is not None:
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
                "best_val_loss": best_meta()})
        if guard is not None:
            guard.reset()          # the trigger belongs to this run
        raise preempt.TrainingPreempted(ckpt)

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
                batches = _prefetch_to_device(
                    _iter_batches(dataloaders[phase], batch_size,
                                  rng if phase == "train" else None, pad_kind=loss_kind,
                                  skip=epoch_skip if phase == "train" else 0),
                    device)
                step_fn = train_step if phase == "train" else eval_step
                for x, y, n_real in batches:
                    m = step_fn(x, y)
                    losses.append(m["loss"])
                    corrs.append(m["n_correct"])
                    ns.append(m["n"])
                    bszs.append(n_real)
                    lag = len(losses) - 1 - _PIPELINE_DEPTH
                    if lag >= 0:
                        losses[lag] = float(losses[lag])
                        corrs[lag] = int(corrs[lag])
                        ns[lag] = int(ns[lag])
                    if guard is not None and guard.triggered:
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
                    "epochs_done": epoch + 1, "best_val_loss": best_meta()})
    except BaseException:
        # drain enqueued writes (the best-val file may hold what the user
        # wants back) without masking the exception in flight
        if ckpt_writer is not None:
            try:
                ckpt_writer.close()
            except BaseException as e:
                print(f"warning: background checkpoint write failed: {e}", file=sys.stderr)
        raise

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
                   verbose: bool = True, loss: str = "ce", metrics_logger=None,
                   resume=None, augment=None, device="cuda"):
    """Train a spot classifier f: the JAX package's ``train_spotwise``.

    ``dataloaders`` maps 'train'/'val' to (inputs, labels) array pairs with
    labels in ``[0, n_classes)`` (float targets with ``loss='mse'``) or to
    map-style datasets. Without ``state`` the model's weights are drawn
    from flax's initialisers with ``generator`` and bound to Adam
    (``learning_rate``, or ``tx``). ``resume=<outfile>.latest`` continues
    an interrupted run (``num_epochs`` is the total). Runs on ``device``
    (default CUDA). Returns (state, val_history, train_history).
    """
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    if state is None:
        state = create_train_state(model, tx or make_adam(learning_rate),
                                   generator=generator, device=device)
    else:
        state.model.to(device)
    kind = {"ce": "spot", "mse": "spot_mse"}[loss]
    return _run_training(state, dataloaders, kind, num_epochs, batch_size, outfile,
                         shuffle_seed, verbose, device, metrics_logger=metrics_logger,
                         resume=resume, augment=augment)


def train_gridwise(model: nn.Module, dataloaders: Mapping, *, learning_rate: float = 1e-3,
                   f_lr: Optional[float] = None, accum_iters: int = 1,
                   num_epochs: int = 10, batch_size: int = 1, outfile=None,
                   state: Optional[TrainState] = None, tx: Optional[OptimizerSpec] = None,
                   generator: Optional[torch.Generator] = None, shuffle_seed: int = 0,
                   verbose: bool = True, metrics_logger=None, resume=None, augment=None,
                   device="cuda"):
    """Train a grid model g with the foreground-masked CE: the JAX
    package's ``train_gridwise``.

    ``dataloaders`` maps 'train'/'val' to (inputs, labels) pairs, inputs
    ``(N, H, W, ...)`` (a tuple for the multimodal models) and labels
    ``(N, H, W)`` with 0 background, or to map-style datasets. ``f_lr``
    trains f with its own Adam; otherwise f is frozen (and runs without
    gradients). Other arguments as :func:`train_spotwise`.
    """
    from gridnext_tpu_torch.serving import resolve_device

    device = resolve_device(device)
    if state is None:
        state = create_train_state(
            model, tx or make_gridwise_optimizer(learning_rate, f_lr, accum_iters),
            generator=generator, device=device)
    else:
        state.model.to(device)
    return _run_training(state, dataloaders, "grid", num_epochs, batch_size, outfile,
                         shuffle_seed, verbose, device, metrics_logger=metrics_logger,
                         resume=resume, augment=augment)


__all__ = ["Optimizer", "OptimizerSpec", "TrainState", "create_train_state",
           "load_checkpoint", "load_f_params", "make_adam", "make_gridwise_optimizer",
           "make_steps", "masked_cross_entropy", "restore_train_state",
           "save_checkpoint", "train_gridwise", "train_spotwise"]
