"""Distillation of a trained model's spot classifier f into a fast student.

The JAX package's ``train/distill.py``: a teacher f (DenseNet-121 or a
``TpuPatchClassifier`` of an image directory, or the scBERT count f of a
multimodal one) is distilled into a ``TpuPatchClassifier`` (or a stateless
``CountMLP``) student; the teacher's correction network g is carried over
verbatim, so the student's directory registers with the teacher's g at the
student's speed. The loss targets the logits g consumes,

    mse_weight * MSE(s, t) + kl_weight * T^2 * KL(softmax(t / T) || softmax(s / T)),

and the agreement of the two registrations is measured, not assumed
(:func:`patch_agreement`, :func:`label_agreement`).

The student trains with the port's optax-exact Adam on minibatches drawn
with replacement from a resident pool, one ``randint`` per step from an
explicit ``torch.Generator`` on the pool's device; the teacher runs in eval
mode without gradients on the same rows (or on a row-aligned pool of its
own representation: ``teacher_inputs``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gridnext_tpu_torch.compat.from_jax import jax_variables, save_checkpoint
from gridnext_tpu_torch.train.loops import Optimizer, create_train_state, make_adam


def make_distill_step(teacher_apply: Callable, student: nn.Module, optimizer: Optimizer, *,
                      temperature: float = 2.0, kl_weight: float = 0.1,
                      mse_weight: float = 1.0) -> Callable:
    """One distillation update: ``step(pool, t_pool, idx) -> loss``.

    ``idx`` (int64 on the pools' device) picks the minibatch's rows of the
    student pool ``pool`` and of the teacher pool ``t_pool`` (the same
    tensor for shared inputs). The teacher (``teacher_apply(x) -> (B, C)``
    logits; a module is put in eval mode) runs without gradients, the
    student in train mode; ``optimizer`` (bound to ``student``) applies the
    gradient of the float32 loss, which the step returns detached.
    """
    if isinstance(teacher_apply, nn.Module):
        teacher_apply.eval()
    T = float(temperature)

    def step(pool, t_pool, idx):
        with torch.no_grad():
            t_logits = teacher_apply(t_pool[idx]).float()
        student.train()
        s_logits = student(pool[idx]).float()
        mse = torch.mean((s_logits - t_logits) ** 2)
        t_soft = F.log_softmax(t_logits / T, dim=-1)
        s_soft = F.log_softmax(s_logits / T, dim=-1)
        kl = torch.mean(torch.sum(t_soft.exp() * (t_soft - s_soft), dim=-1))
        loss = mse_weight * mse + kl_weight * (T * T) * kl
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def distill_patch_classifier(teacher_apply: Callable, student: nn.Module, patches, *,
                             steps: int = 2000, batch_size: int = 256,
                             learning_rate: float = 3e-4, temperature: float = 2.0,
                             kl_weight: float = 0.1, mse_weight: float = 1.0,
                             scan_chunk: int = 100, teacher_inputs=None,
                             generator: Optional[torch.Generator] = None,
                             verbose: bool = True):
    """Distil a frozen teacher into ``student`` over an input pool.

    Args:
      teacher_apply: ``teacher_apply(x) -> (B, C)`` logits of the teacher's
        input representation (an f module, or any callable).
      student: a stateless module mapping the pool's rows to (B, C) logits
        (``TpuPatchClassifier``, ``CountMLP(batch_norm=False)``); trained in
        place, on the pool's device.
      patches: ``(N, ...)`` student pool, a tensor on the device it trains
        on.
      teacher_inputs: an optional row-aligned ``(N, ...)`` teacher pool on
        the same device (an scBERT teacher's gene2vec tokens for a student
        that reads log1p counts of the same spots); default: the teacher
        reads ``patches``.
      steps: optimiser updates, each on ``batch_size`` rows drawn with
        replacement by ``generator`` (default: seeded 0 on the pool's
        device).
      scan_chunk: updates whose mean loss is one entry of the history.

    The student starts from flax's initialisers drawn by a CPU generator
    seeded 0.

    Returns:
      ``(variables, losses)``: the student's variables tree in the JAX
      layout (``{"params": ...}``) and the per-chunk mean loss history.
    """
    pool = patches
    t_pool = pool if teacher_inputs is None else teacher_inputs
    if len(t_pool) != len(pool):
        raise ValueError(f"teacher_inputs has {len(t_pool)} rows vs the student pool's "
                         f"{len(pool)}; they must be row-aligned views of the same items")
    device = pool.device
    state = create_train_state(student, make_adam(learning_rate), device=device)
    step = make_distill_step(teacher_apply, student, state.optimizer, temperature=temperature,
                             kl_weight=kl_weight, mse_weight=mse_weight)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    losses, done = [], 0
    while done < steps:
        n = min(scan_chunk, steps - done)
        total = torch.zeros((), device=device)
        for _ in range(n):
            idx = torch.randint(0, len(pool), (batch_size,), generator=gen, device=device)
            total += step(pool, t_pool, idx)
        losses.append(float(total / n))
        done += n
        if verbose:
            print(f"distill step {done}/{steps}: loss {losses[-1]:.5f}", flush=True)
    student.eval()
    return {"params": jax_variables(student)["params"]}, losses


def patch_agreement(teacher_apply: Callable, student_apply: Callable, patches,
                    batch_size: int = 512) -> float:
    """Fraction of the pool's rows on which teacher and student argmax
    agree (both run without gradients, ``batch_size`` rows a call)."""
    n = len(patches)
    if n == 0:
        raise ValueError("empty patch pool")
    agree = 0
    with torch.no_grad():
        for i in range(0, n, batch_size):
            chunk = patches[i:i + batch_size]
            t = torch.argmax(teacher_apply(chunk), -1)
            s = torch.argmax(student_apply(chunk), -1)
            agree += int((t == s).sum())
    return agree / n


def label_agreement(labels_a, labels_b) -> float:
    """Per-spot agreement of two registration label grids over the union
    foreground (0 = background; a spot foreground in one only disagrees)."""
    a, b = np.asarray(labels_a), np.asarray(labels_b)
    fg = (a > 0) | (b > 0)
    n = int(fg.sum())
    if n == 0:
        raise ValueError("no foreground spots to compare")
    return float((a[fg] == b[fg]).sum() / n)


def _rounded(distill_info: dict) -> dict:
    return {k: (round(float(v), 6) if isinstance(v, (int, float)) else v)
            for k, v in distill_info.items()}


def _write_dir(out_dir, variables: dict, meta: dict) -> None:
    """``g_state.msgpack`` (no optimiser state, step 0) and ``model.json``
    as the JAX package's distillation writers lay them out."""
    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(os.path.join(out_dir, "g_state.msgpack"), variables)
    with open(os.path.join(out_dir, "model.json"), "w") as fh:
        json.dump(meta, fh, indent=1)


def write_count_distilled_mm_dir(out_dir, teacher_meta: dict, classes, teacher_variables,
                                 student_f_variables, distill_info: Optional[dict] = None
                                 ) -> dict:
    """Write a multimodal model directory whose scBERT count f is replaced
    by a distilled ``CountMLP(batch_norm=False)`` student on log1p counts.

    The image f and the corrector (every collection) are carried over
    verbatim; the count f's entries of the other collections (scBERT's FAVOR
    projections) are dropped. ``model.json`` takes ``count_f: "mlp"``,
    ``log1p``, ``count_mlp_bn: false``, ``count_chunk: null`` and
    ``count_distilled_from: "scbert"``, and ``distill`` (numbers rounded to
    6 places). Returns the metadata."""
    params = dict(teacher_variables["params"])
    params["count_classifier"] = student_f_variables["params"]
    variables = {"params": params}
    batch_stats = teacher_variables.get("batch_stats")
    if batch_stats is not None:
        batch_stats = {k: v for k, v in batch_stats.items() if k != "count_classifier"}
        if batch_stats:
            variables["batch_stats"] = batch_stats
    for col, sub in teacher_variables.items():
        if col in ("params", "batch_stats"):
            continue
        kept = {k: v for k, v in sub.items() if k != "count_classifier"}
        if kept:
            variables[col] = kept
    meta = dict(teacher_meta)
    meta.update({"classes": list(classes), "count_f": "mlp", "log1p": True,
                 "count_mlp_bn": False, "count_chunk": None,
                 "count_distilled_from": "scbert"})
    if distill_info:
        meta["distill"] = _rounded(distill_info)
    _write_dir(out_dir, variables, meta)
    return meta


def write_distilled_model_dir(out_dir, teacher_meta: dict, classes, teacher_variables,
                              student_f_variables, student,
                              distill_info: Optional[dict] = None) -> dict:
    """Write a trained image model directory that serves the distilled f.

    The student's params replace ``patch_classifier``; the teacher's
    corrector (params and BatchNorm statistics) is carried over verbatim.
    ``model.json`` keeps the teacher's lattice and preprocessing fields,
    names ``GridNet[Hex]+TpuPatchClassifier`` with the student's ``tpu_f``
    architecture, and records ``distilled_from`` and ``distill``. Returns
    the metadata."""
    from gridnext_tpu_torch.models.tpu_f import tpu_f_arch_meta

    variables = {"params": {"patch_classifier": student_f_variables["params"],
                            "corrector": teacher_variables["params"]["corrector"]}}
    if (teacher_variables.get("batch_stats") or {}).get("corrector") is not None:
        variables["batch_stats"] = {"corrector": teacher_variables["batch_stats"]["corrector"]}
    g_name = "GridNet" if teacher_meta.get("grid_dims") is not None else "GridNetHex"
    meta = {k: teacher_meta.get(k) for k in
            ("patch_px", "window_px", "grid_dims", "hd_binning", "patch_chunk",
             "dense_ingest")}
    meta.update({"model": f"{g_name}+TpuPatchClassifier", "image_f": "tpu",
                 "tpu_f": tpu_f_arch_meta(student), "classes": list(classes),
                 "distilled_from": teacher_meta.get("model")})
    if distill_info:
        meta["distill"] = _rounded(distill_info)
    _write_dir(out_dir, variables, meta)
    return meta
