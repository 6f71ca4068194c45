"""Evaluation figures: ROC/PR grids, confusion heatmaps, label maps.

The JAX package's ``plotting.py`` (the reference's performance_curves,
plot_confusion, misclass_density, plot_class_boundaries, plot_label_tensor
and the hexagdly-style renderers), with numpy arrays in and channels-last
softmax grids ``(H, W, C)``. The curves and AUCs come from
:mod:`gridnext_tpu_torch.metrics`; the confusion heatmap is drawn with
matplotlib alone. matplotlib is imported inside each figure function, so
the module imports on a machine without it (the numpy helpers
:func:`misclass_density` and :func:`class_boundary_segments` need none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gridnext_tpu_torch import geometry
from gridnext_tpu_torch.metrics import auc, confusion_matrix, precision_recall_curve, roc_curve


# The two one-vs-rest curve families of the performance report: (x-label,
# y-label, curve_fn(y_binary, scores) -> (xs, ys)).
def _roc_xy(y, s):
    fpr, tpr, _ = roc_curve(y, s)
    return fpr, tpr


def _pr_xy(y, s):
    precision, recall, _ = precision_recall_curve(y, s)
    return recall, precision


_CURVE_FAMILIES = (("FPR", "TPR", _roc_xy), ("Recall", "Precision", _pr_xy))


def performance_curves(true, smax, class_names: Optional[Sequence[str]] = None,
                       condition_names: Optional[Sequence[str]] = None,
                       panel_columns: int = 4):
    """One-vs-rest ROC + PR curve grid; returns (fig, ax, mAUROC, mAUPRC).

    ``smax`` is one (n, C) array or a list of them (conditions overlaid,
    named by ``condition_names``); the macro averages come back per
    condition, over the classes present in ``true`` (an absent class's AUC
    is nan and left out). ROC panels fill the top half, PR panels the
    bottom, ``panel_columns`` classes a row.
    """
    from matplotlib import pyplot as plt

    if isinstance(smax, list):
        if condition_names is None:
            raise ValueError("Must provide names for each condition plotted")
        conditions = list(zip(condition_names, smax))
    else:
        conditions = [("", smax)]
    n_classes = conditions[0][1].shape[1]
    onehot = np.equal.outer(np.asarray(true), np.arange(n_classes)).astype(int)

    # every curve and AUC up front: aucs[family, class, condition]
    curves = {}
    aucs = np.zeros((len(_CURVE_FAMILIES), n_classes, len(conditions)))
    for fi, (_, _, curve_fn) in enumerate(_CURVE_FAMILIES):
        for c in range(n_classes):
            for ci, (_, scores) in enumerate(conditions):
                if not onehot[:, c].any():
                    aucs[fi, c, ci] = np.nan      # class absent from `true`
                    continue
                xs, ys = curve_fn(onehot[:, c], scores[:, c])
                aucs[fi, c, ci] = auc(xs, ys)
                curves[fi, c, ci] = (xs, ys)

    rows_per_family = -(-n_classes // panel_columns)
    n_row = rows_per_family * len(_CURVE_FAMILIES)
    fig, ax = plt.subplots(n_row, panel_columns, figsize=(4 * panel_columns, 4 * n_row),
                           constrained_layout=True, squeeze=False)
    for a in ax.ravel():
        a.axis("off")
    for (fi, c, ci), (xs, ys) in curves.items():
        a = ax[fi * rows_per_family + c // panel_columns, c % panel_columns]
        a.plot(xs, ys, label=f"{conditions[ci][0]} (AUC={aucs[fi, c, ci]:.3f})")
    for fi, (xlabel, ylabel, _) in enumerate(_CURVE_FAMILIES):
        for c in range(n_classes):
            a = ax[fi * rows_per_family + c // panel_columns, c % panel_columns]
            a.axis("on")
            a.set(xlabel=None, ylabel=None, xlim=(0, 1), ylim=(0, 1))
            a.set_xlabel(xlabel, fontsize=12)
            a.set_ylabel(ylabel, fontsize=12)
            if a.get_legend_handles_labels()[0]:    # an absent class has no curves
                a.legend(fontsize=12)
            if class_names is not None:
                a.set_title(class_names[c], fontsize=14)
    macro = np.nanmean(aucs, axis=1)                # (family, condition)
    return fig, ax, macro[0], macro[1]


def plot_cv_curves(train_hist, val_hist, ylabel: str = "Loss", ax=None):
    """Across-fold mean +/- std learning curves (an errorbar per epoch) of
    ``(n_folds, n_epochs)`` train and validation losses."""
    from matplotlib import pyplot as plt

    train_hist = np.asarray(train_hist, float)
    val_hist = np.asarray(val_hist, float)
    fig = None
    if ax is None:
        fig, ax = plt.subplots(1)
    ax.errorbar(np.arange(train_hist.shape[1]), train_hist.mean(0), yerr=train_hist.std(0),
                label="train")
    ax.errorbar(np.arange(val_hist.shape[1]), val_hist.mean(0), yerr=val_hist.std(0),
                label="val")
    ax.set(xlabel="Epoch", ylabel=ylabel)
    ax.legend()
    return fig, ax


def plot_confusion(y_true, y_pred, class_names=None, figsize=None):
    """Row-normalised confusion heatmap annotated with spot counts, over all
    of ``class_names`` (labels ``0..len - 1``) when given, else over the
    labels present."""
    from matplotlib import pyplot as plt

    if class_names is None:
        class_names = np.unique(np.concatenate([np.asarray(y_true).ravel(),
                                                np.asarray(y_pred).ravel()]))
        labels = class_names
    else:
        labels = np.arange(len(class_names))
    counts = confusion_matrix(y_true, y_pred, labels=labels)
    fractions = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)

    fig, ax = plt.subplots(1, figsize=figsize)
    im = ax.imshow(fractions, cmap="magma",
                   vmin=0.0, vmax=max(float(fractions.max()), 1e-12), aspect="auto")
    for (i, j), v in np.ndenumerate(counts):
        ax.text(j, i, f"{v:d}", ha="center", va="center",
                color="black" if fractions[i, j] > 0.5 * fractions.max() else "white")
    ticks = np.arange(len(labels))
    ax.set_xticks(ticks, [str(c) for c in class_names], rotation=90)
    ax.set_yticks(ticks, [str(c) for c in class_names])
    fig.colorbar(im, ax=ax).set_label("fraction of spots")
    ax.set(ylabel="True label", xlabel="Predicted label")
    return fig, ax


def misclass_density(out_softmax: np.ndarray, true: np.ndarray) -> np.ndarray:
    """Per-spot misclassification probability 1 - p(correct class) of an
    ``(H, W, C)`` softmax grid against ``(H, W)`` labels (0 background,
    where the density is 0)."""
    out_softmax = np.asarray(out_softmax)
    true = np.asarray(true).astype(np.int64)     # uint grids would underflow at -1
    fg = true > 0
    idx = np.maximum(true - 1, 0)
    p_correct = np.take_along_axis(out_softmax, idx[..., None], axis=-1)[..., 0]
    return np.where(fg, 1.0 - p_correct, 0.0)


def class_boundary_segments(true: np.ndarray) -> np.ndarray:
    """(n_segments, 2, 2) unit line segments ((x0, y0), (x1, y1)) between
    4-adjacent cells of an ``(H, W)`` label grid whose labels differ, in
    image coordinates (pixel centres at integers)."""
    true = np.asarray(true)
    segs = []
    yy, xx = np.nonzero(true[:, 1:] != true[:, :-1])      # vertical borders
    if len(xx):
        x = xx + 0.5
        segs.append(np.stack([np.stack([x, yy - 0.5], 1),
                              np.stack([x, yy + 0.5], 1)], axis=1))
    yy, xx = np.nonzero(true[1:, :] != true[:-1, :])      # horizontal borders
    if len(xx):
        y = yy + 0.5
        segs.append(np.stack([np.stack([xx - 0.5, y], 1),
                              np.stack([xx + 0.5, y], 1)], axis=1))
    if not segs:
        return np.zeros((0, 2, 2))
    return np.concatenate(segs, axis=0)


def plot_class_boundaries(base_image: np.ndarray, true: np.ndarray):
    """A per-spot scalar map (e.g. the misclassification density) over the
    foreground, with the class borders drawn white."""
    from matplotlib import pyplot as plt
    from matplotlib.collections import LineCollection
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    true = np.asarray(true)
    fig, ax = plt.subplots(1)
    ax.set_axis_off()
    ax.imshow(np.zeros_like(true), cmap="gray")
    fgd = ax.imshow(np.ma.masked_where(true == 0, base_image), cmap="plasma")
    ax.add_collection(LineCollection(class_boundary_segments(true), colors="w",
                                     linewidths=1.0))
    cax = make_axes_locatable(ax).append_axes("right", size="5%", pad=0.05)
    fig.colorbar(fgd, cax=cax).set_label("Misclassification Probability")
    return fig


def plot_label_tensor(label_grid, class_names=None, Visium: bool = False, ax=None,
                      legend: bool = True):
    """Scatter an ``(H, W)`` integer label grid, one colour a class; at the
    Visium spots' true hex positions when ``Visium``."""
    from matplotlib import pyplot as plt

    label_grid = np.asarray(label_grid)
    if class_names is None:
        fg_vals = np.sort(np.unique(label_grid[label_grid > 0]))
    else:
        fg_vals = np.arange(1, len(class_names) + 1)
    if ax is None:
        _, ax = plt.subplots(1, figsize=(10, 8))
    ax.set_aspect("equal")
    ax.invert_yaxis()
    for fgv in fg_vals:
        yy, xx = np.nonzero(label_grid == fgv)
        lbl = fgv if class_names is None else class_names[fgv - 1]
        if len(xx):
            if Visium:
                col, row = geometry.oddr_to_pseudo_hex(xx, yy)
                px, py = geometry.pseudo_to_true_hex(col, row)
            else:
                px, py = xx, yy
            ax.scatter(px, py, label=lbl, s=10)
        else:
            ax.scatter([], [], label=lbl, s=10)
    ax.axis("off")
    if legend:
        ax.legend(bbox_to_anchor=(1, 0), loc="lower left")
    return ax


def plot_hextensor(grid, layout: str = "odd-r", cmap: str = "Greys", ax=None,
                   mask: Sequence[int] = ()):
    """Render a 2-D grid as hexagons: ``'odd-r'`` (Visium, odd rows shifted
    right, pointy-top; the package's layout) or ``'odd-q'`` (hexagdly's odd
    columns shifted down, flat-top). ``mask`` lists cell numbers to leave
    out, counted row-major for odd-r and column-major for odd-q."""
    from matplotlib import pyplot as plt
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import RegularPolygon

    grid = np.asarray(grid)
    if grid.ndim != 2:
        raise ValueError("plot_hextensor takes a single (H, W) channel")
    if layout not in ("odd-r", "odd-q"):
        raise ValueError(layout)
    h, w = grid.shape
    if layout == "odd-q":
        order = [(y, x) for x in range(w) for y in range(h)]
    else:
        order = [(y, x) for y in range(h) for x in range(w)]
    skip = set(mask)
    hexagons, intensities = [], []
    for npix, (y, x) in enumerate(order):
        if npix in skip:
            continue
        if layout == "odd-r":
            cx, cy = geometry.oddr_to_cartesian(x, y)
            center, orientation = (float(cx), -float(cy)), 0.0
        else:
            center, orientation = (x * np.sqrt(3) / 2, -(y + (x % 2) * 0.5)), np.pi / 6
        hexagons.append(RegularPolygon(center, 6, radius=0.577349, orientation=orientation))
        intensities.append(grid[y, x])
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 10))
    p = PatchCollection(hexagons, cmap=cmap, alpha=0.9, edgecolors="k", linewidth=1)
    p.set_array(np.asarray(intensities))
    ax.add_collection(p)
    ax.autoscale_view()
    ax.set_aspect("equal")
    ax.set_axis_off()
    return ax


def plot_squaretensor(grid, cmap: str = "Greys", ax=None):
    """Cartesian pcolor rendering of a 2-D grid."""
    from matplotlib import pyplot as plt

    grid = np.asarray(grid)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    ax.set_axis_off()
    ax.pcolor(grid, cmap=cmap, edgecolors="k", linewidths=0.4)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_frame_on(True)
    return ax
