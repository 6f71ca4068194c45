"""Classification metrics of the ``evaluate`` command, in numpy.

The JAX package takes these from scikit-learn (``cli.py:1880-1914``,
``plotting.py``); the card machine has no scikit-learn, so the port
computes them here with scikit-learn's definitions:

* :func:`confusion_matrix` over ``labels`` (pairs with a label outside
  them dropped);
* :func:`roc_auc_score` of a binary truth: the Mann-Whitney statistic with
  tie-averaged ranks (nan, as scikit-learn gives, when one class is absent);
* :func:`average_precision_score`: the step-wise sum over the distinct
  score thresholds, not interpolated;
* :func:`roc_curve` (collinear points dropped, as ``drop_intermediate``
  does), :func:`precision_recall_curve` and :func:`auc`;
* :func:`classification_report` (the dict of ``output_dict=True``): per label
  ``precision``, ``recall``, ``f1-score`` and ``support``, then
  ``accuracy`` (or ``micro avg`` when the labels do not cover the data),
  ``macro avg`` and ``weighted avg``, a zero division scored as
  ``zero_division``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def confusion_matrix(y_true, y_pred, labels: Optional[Sequence] = None) -> np.ndarray:
    """(n_labels, n_labels) int64 counts: row = true label, column =
    predicted, in the order of ``labels`` (default: the sorted union)."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    labels = np.union1d(y_true, y_pred) if labels is None else np.asarray(labels)
    if labels.size == 0:
        raise ValueError("'labels' should contain at least one label.")
    n = labels.size
    if y_true.size == 0:
        return np.zeros((n, n), np.int64)
    if not np.intersect1d(y_true, labels).size:
        raise ValueError("At least one label specified must be in y_true")
    index = {v: i for i, v in enumerate(labels.tolist())}
    t = np.array([index.get(v, n) for v in y_true.tolist()], np.int64)
    p = np.array([index.get(v, n) for v in y_pred.tolist()], np.int64)
    keep = (t < n) & (p < n)
    return np.bincount(t[keep] * n + p[keep], minlength=n * n).reshape(n, n).astype(np.int64)


def _threshold_counts(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, highest first:
    the false and true positives of ``score >= threshold`` (float64)."""
    y_true = np.asarray(y_true).ravel().astype(bool)
    y_score = np.asarray(y_score).ravel()
    if y_true.shape != y_score.shape:
        raise ValueError(f"y_true has {y_true.size} entries, y_score {y_score.size}")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("y_score holds a non-finite value")
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    idx = np.concatenate([np.flatnonzero(np.diff(y_score)), [y_true.size - 1]])
    tps = np.cumsum(y_true.astype(np.float64))[idx]
    fps = 1.0 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) of a binary truth, starting at (0, 0) with an
    infinite threshold; points collinear with their neighbours dropped
    (scikit-learn's default ``drop_intermediate``). A rate whose class is
    absent is nan throughout."""
    fps, tps, thresholds = _threshold_counts(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.flatnonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                    True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    fps, tps = np.r_[0.0, fps], np.r_[0.0, tps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) of a binary truth at each distinct
    score, recall decreasing, ending at (precision 1, recall 0). Without a
    positive the recall is 1 throughout."""
    fps, tps, thresholds = _threshold_counts(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1])


def auc(x, y) -> float:
    """Trapezoidal area under the curve of monotonic ``x``."""
    x, y = np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError(f"x has {x.size} points, y {y.size}")
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area under curve, "
                         "but x.shape = %s" % x.shape)
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1.0
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of a binary truth: the probability that a
    positive outscores a negative, ties counting one half (the Mann-Whitney
    U over the positives' tie-averaged ranks). nan when one class is
    absent."""
    y_true = np.asarray(y_true).ravel().astype(bool)
    y_score = np.asarray(y_score, np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="stable")
    s = y_score[order]
    starts = np.r_[0, np.flatnonzero(np.diff(s)) + 1]
    ends = np.r_[starts[1:], s.size]
    # the mean rank (1-based) of each tie group, spread over its members
    ranks = np.empty(s.size, np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def average_precision_score(y_true, y_score) -> float:
    """Sum over the distinct thresholds of (recall step) x precision."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _divide(num, den, zero_division: float):
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = np.full(num.shape, float(zero_division))
    np.divide(num, den, out=out, where=den != 0)
    return out


def _prf(tp, pred, true, zero_division):
    return (_divide(tp, pred, zero_division), _divide(tp, true, zero_division),
            _divide(2.0 * tp, true + pred, zero_division))


def classification_report(y_true, y_pred, labels: Optional[Sequence] = None,
                          target_names: Optional[Sequence[str]] = None,
                          zero_division: float = 0) -> dict:
    """Per-label precision, recall, F1 and support, and their averages, as
    scikit-learn's ``classification_report(..., output_dict=True)`` gives
    them."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    present = np.union1d(y_true, y_pred)
    if labels is None:
        labels, micro_is_accuracy = present, True
    else:
        labels = np.asarray(labels)
        micro_is_accuracy = set(labels.tolist()) >= set(present.tolist())
    if target_names is None:
        target_names = [f"{v}" for v in labels.tolist()]
    elif len(target_names) != len(labels):
        raise ValueError(f"labels size, {len(labels)}, does not match size of "
                         f"target_names, {len(target_names)}")
    # every sample counts towards its own label's sums, whatever the other side
    is_true = y_true[None, :] == labels[:, None]
    is_pred = y_pred[None, :] == labels[:, None]
    tp = (is_true & is_pred).sum(axis=1).astype(np.float64)
    pred = is_pred.sum(axis=1).astype(np.float64)
    true = is_true.sum(axis=1).astype(np.float64)
    p, r, f = _prf(tp, pred, true, zero_division)
    headers = ("precision", "recall", "f1-score", "support")
    report = {name: dict(zip(headers, map(float, row)))
              for name, row in zip(target_names, zip(p, r, f, true))}
    micro = _prf(tp.sum(), pred.sum(), true.sum(), zero_division)
    if true.sum() > 0:
        weighted = tuple(np.average(a, weights=true) for a in (p, r, f))
    else:
        weighted = tuple(np.mean(a) for a in (p, r, f))
    support = float(true.sum())
    for heading, (ap, ar, af) in (
            ("accuracy" if micro_is_accuracy else "micro avg", micro),
            ("macro avg", tuple(np.mean(a) for a in (p, r, f))),
            ("weighted avg", weighted)):
        report[heading] = dict(zip(headers, (float(ap), float(ar), float(af), support)))
    if "accuracy" in report:
        report["accuracy"] = report["accuracy"]["precision"]
    return report
