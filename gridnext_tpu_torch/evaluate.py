"""Foreground predictions of grid models, their consensus, and the Loupe
export of registered label grids.

The JAX package's ``evaluate.py``: :func:`all_fgd_predictions` (the
reference's ``utils.py:20-57``, with f-only and dihedral test-time
augmentation), :func:`consensus_softmax`, :func:`flatten_foreground` and
:func:`to_loupe_annots` (``utils.py:169-193``).
"""

from __future__ import annotations

import contextlib
import csv
import os
from typing import Optional, Sequence

import numpy as np
import torch

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.io.spaceranger import read_positions_file
from gridnext_tpu_torch.pipeline import dihedral_transform


def _model_device(model) -> torch.device:
    p = next(model.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def _forward(model, x, f_only: bool, tta: bool) -> torch.Tensor:
    """Logits of ``model`` (its f outputs with ``f_only``); with ``tta`` the
    log of the softmax averaged over the 8 dihedral orientations of the
    image patches (the image element of a multimodal pair)."""
    apply = model.patch_predictions if f_only else model
    if not tta:
        return apply(x)
    smax = 0.0
    for k in range(8):
        if isinstance(x, (tuple, list)):
            xt = type(x)((dihedral_transform(x[0], k),) + tuple(x[1:]))
        else:
            xt = dihedral_transform(x, k)
        smax = smax + torch.softmax(apply(xt).float(), dim=-1)
    return torch.log(smax / 8.0 + 1e-20)


def all_fgd_predictions(data, model, *, f_only: bool = False, batch_size: int = 1,
                        return_grids: bool = False, tta: bool = False):
    """Run a grid model over a dataset and collect foreground predictions.

    Args:
      data: ``(inputs, labels)``: inputs ``(N, H, W, ...)`` (a numpy array or
        a tensor; a tuple of them for multimodal models), labels ``(N, H, W)``
        integers with 0 = background.
      model: a GridNet-family module with its weights; it runs in eval mode
        without gradients on the device of its parameters.
      f_only: score ``patch_predictions`` (f's outputs) instead of the
        corrected grid (the reference's flag, ``utils.py:33-36``).
      batch_size: arrays per forward.
      return_grids: also return each array's ``(label_grid, softmax_grid)``,
        ``(H, W)`` / ``(H, W, C)`` (the inputs of ``evaluate --maps``).
      tta: average the softmax over the 8 flips and rotations of each image
        patch (inputs must be square patches ``(..., P, P, C)``); the
        logits are then log(mean softmax + 1e-20).

    Returns:
      ``(y_true, y_pred, y_smax)`` over the foreground spots of all arrays,
      flattened row-major: labels shifted to ``[0, N)``, argmax predictions
      and float32 softmax rows; plus the grid list with ``return_grids``.
    """
    inputs, labels = data
    multi = isinstance(inputs, (tuple, list))
    labels = np.asarray(labels)
    n = len(labels)
    if tta:
        probe = inputs[0] if multi else inputs
        shape = tuple(probe.shape)
        if len(shape) < 5 or shape[-2] != shape[-3]:
            raise ValueError(
                "tta needs square image-patch inputs (..., P, P, C); got "
                f"shape {shape} -- count-modality models have no "
                "patch orientation to average over")
    dev = _model_device(model)

    def on_device(a, sl):
        return torch.as_tensor(a[sl], device=dev)

    was_training = model.training
    model.eval()
    true_vals, pred_vals, pred_smax, grids = [], [], [], []
    try:
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            x = (tuple(on_device(a, sl) for a in inputs) if multi
                 else on_device(inputs, sl))
            with torch.no_grad():
                logits = _forward(model, x, f_only, tta).float()
                smax_b = torch.softmax(logits, dim=-1).cpu().numpy()
            logits = logits.cpu().numpy()
            y = labels[sl]
            if return_grids:
                grids.extend((y[j], smax_b[j]) for j in range(len(y)))
            fg = y.reshape(-1) > 0
            true_vals.append(y.reshape(-1)[fg].astype(np.int64) - 1)
            pred_vals.append(np.argmax(logits.reshape(-1, logits.shape[-1])[fg], axis=1))
            pred_smax.append(smax_b.reshape(-1, smax_b.shape[-1])[fg])
    finally:
        model.train(was_training)
    out = (np.concatenate(true_vals), np.concatenate(pred_vals), np.concatenate(pred_smax))
    return out + (grids,) if return_grids else out


def consensus_softmax(smax_list: Sequence[np.ndarray]) -> np.ndarray:
    """Cross-modality consensus: the mean of per-model softmax matrices (the
    register_pca.ipynb workflow's 'consensus(g_pca+g_img)')."""
    return np.stack([np.asarray(s) for s in smax_list]).mean(axis=0)


def flatten_foreground(pred_grid: np.ndarray, true_grid: np.ndarray):
    """Flatten one array's prediction map over its foreground spots,
    row-major over (H, W), labels shifted to ``[0, N)``.

    ``pred_grid`` is ``(H, W, C)`` or ``(C, H, W)``, channels-first detected
    by a shape mismatch with the ``(H, W)`` ``true_grid`` (channels-last
    when C == H == W). Returns ``(preds_fg (n_fg, C), true_fg (n_fg,))``.
    """
    pred_grid = np.asarray(pred_grid)
    true_grid = np.asarray(true_grid)
    if pred_grid.shape[:2] != true_grid.shape:  # channels-first input
        pred_grid = np.moveaxis(pred_grid, 0, -1)
    flat = pred_grid.reshape(-1, pred_grid.shape[-1])
    labels = true_grid.reshape(-1)
    fg = labels > 0
    return flat[fg], labels[fg] - 1


def to_loupe_annots(annot_grid, position_file, output_file,
                    annot_names: Optional[Sequence[str]] = None,
                    zero_bg: bool = True, hex_coords: bool = True):
    """Write a Loupe-format (Barcode, AARs) CSV from a label grid.

    ``annot_grid`` is (H, W) integer labels (foreground 1..N when
    ``zero_bg``, else 0..N-1); unlabeled in-tissue spots export as ''. The
    grid is odd-right (Visium); ``hex_coords=False`` (Visium HD square
    bins, whose positions may be a parquet) indexes it directly by
    (array_row, array_col). The file is byte-identical to the JAX
    package's (pandas ``to_csv`` with ``index=False``: minimal quoting,
    ``os.linesep`` line ends).
    """
    positions = read_positions_file(position_file)
    annot_grid = np.asarray(annot_grid).squeeze()

    keep = positions["in_tissue"].astype(int) == 1
    barcodes = [b for b, k in zip(positions.barcodes, keep) if k]
    if hex_coords:
        x, y = geometry.pseudo_hex_to_oddr(positions["array_col"][keep],
                                           positions["array_row"][keep])
        x, y = np.atleast_1d(x), np.atleast_1d(y)
        # an out-of-grid index would raise a bare IndexError, and a negative
        # one (malformed col/row parity -> x = -1) would wrap to the last column
        if len(y) and (int(y.max()) >= annot_grid.shape[0]
                       or int(x.max()) >= annot_grid.shape[1]
                       or int(x.min()) < 0 or int(y.min()) < 0):
            raise ValueError(
                f"positions map to odd-right extent "
                f"({int(y.min())}..{int(y.max())}, "
                f"{int(x.min())}..{int(x.max())}) but the label grid is "
                f"{annot_grid.shape[:2]} -- the array's lattice exceeds "
                "the model's grid (or a position row has invalid "
                "array_col/array_row parity)")
    else:
        x = positions["array_col"][keep].astype(int)
        y = positions["array_row"][keep].astype(int)
        if len(y) and (int(np.max(y)) >= annot_grid.shape[0]
                       or int(np.max(x)) >= annot_grid.shape[1]):
            raise ValueError(
                f"positions extend to ({int(np.max(y))}, {int(np.max(x))}) but "
                f"the label grid is {annot_grid.shape[:2]} -- the array's HD "
                "lattice is larger than the model's grid_dims (retrain with "
                "grid_dims='auto' over a cohort that covers this array)")

    with (contextlib.nullcontext(output_file) if hasattr(output_file, "write")
          else open(output_file, "w", newline="", encoding="utf-8")) as fh:
        writer = csv.writer(fh, lineterminator=os.linesep)
        writer.writerow(["Barcode", "AARs"])
        for bc, xi, yi in zip(barcodes, x, y):
            a = int(annot_grid[yi, xi]) - int(zero_bg)
            if a < 0:
                annot = ""
            elif annot_names is not None:
                annot = annot_names[a]
            else:
                annot = a
            writer.writerow([bc, annot])
