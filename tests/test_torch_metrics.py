"""The port's numpy metrics (``gridnext_tpu_torch/metrics.py``) against
scikit-learn, which the JAX package's ``evaluate`` uses.

Counts must be exact and floats within 1e-12: the confusion matrix, the
classification report's dict (keys in scikit-learn's order, ``accuracy``
or ``micro avg``, absent classes, zero divisions), the binary AUROC (tied
scores, a single class), the average precision and the ROC / PR curves
and their trapezoidal area; with cases drawn by hypothesis.
"""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn import metrics as sk

from gridnext_tpu_torch import metrics

TOL = 1e-12


def _report_close(got, want):
    assert list(got) == list(want)
    for key, row in want.items():
        if isinstance(row, dict):
            assert list(got[key]) == list(row), key
            for k, v in row.items():
                assert got[key][k] == pytest.approx(v, abs=TOL), (key, k)
        else:
            assert got[key] == pytest.approx(row, abs=TOL), key


def _ranking_close(y, s):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_auc = sk.roc_auc_score(y, s)
        want_ap = sk.average_precision_score(y, s)
        want_roc = sk.roc_curve(y, s)
        want_pr = sk.precision_recall_curve(y, s)
    got_auc = metrics.roc_auc_score(y, s)
    assert (np.isnan(want_auc) and np.isnan(got_auc)) or \
        got_auc == pytest.approx(want_auc, abs=TOL)
    assert metrics.average_precision_score(y, s) == pytest.approx(want_ap, abs=TOL)
    for got, want in zip(metrics.roc_curve(y, s), want_roc):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(metrics.precision_recall_curve(y, s), want_pr):
        np.testing.assert_array_equal(got, want)
    if 0 < np.sum(y) < len(y):
        fpr, tpr, _ = want_roc
        assert metrics.auc(fpr, tpr) == pytest.approx(sk.auc(fpr, tpr), abs=TOL)
        rec, prec = want_pr[1], want_pr[0]
        assert metrics.auc(rec, prec) == pytest.approx(sk.auc(rec, prec), abs=TOL)


@pytest.mark.parametrize("case", ["all_present", "absent_in_true", "absent_in_both",
                                  "single_class", "pred_outside_labels"])
def test_report_and_confusion_match_sklearn(case):
    rng = np.random.default_rng(0)
    y_true = rng.integers(0, 4, 200)
    y_pred = np.where(rng.random(200) < 0.6, y_true, rng.integers(0, 4, 200))
    labels = [0, 1, 2, 3]
    if case == "absent_in_true":
        y_true[y_true == 2] = 1
    elif case == "absent_in_both":
        y_true[y_true == 3] = 0
        y_pred[y_pred == 3] = 1
    elif case == "single_class":
        y_true[:] = 2
    elif case == "pred_outside_labels":
        y_pred[:7] = 5                  # scikit-learn then reports 'micro avg'
    names = [f"Class {i}" for i in labels]
    want = sk.classification_report(y_true, y_pred, labels=labels, target_names=names,
                                    output_dict=True, zero_division=0)
    got = metrics.classification_report(y_true, y_pred, labels=labels, target_names=names,
                                        zero_division=0)
    _report_close(got, want)
    assert ("micro avg" in got) == (case == "pred_outside_labels")
    cm = metrics.confusion_matrix(y_true, y_pred, labels=labels)
    assert cm.dtype == np.int64
    np.testing.assert_array_equal(cm, sk.confusion_matrix(y_true, y_pred, labels=labels))
    # without labels: the sorted union, names its string
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _report_close(metrics.classification_report(y_true, y_pred),
                      sk.classification_report(y_true, y_pred, output_dict=True,
                                               zero_division=0))
        np.testing.assert_array_equal(metrics.confusion_matrix(y_true, y_pred),
                                      sk.confusion_matrix(y_true, y_pred))


def test_ranking_ties_and_single_class_match_sklearn():
    rng = np.random.default_rng(1)
    y = rng.random(300) < 0.3
    for s in (rng.random(300),                         # distinct scores
              np.round(rng.random(300), 1),            # heavy ties
              np.full(300, 0.5),                       # one tie group
              np.where(y, 0.9, 0.1).astype(np.float32)):  # separable
        _ranking_close(y, s)
    _ranking_close(np.zeros(20, bool), rng.random(20))    # no positive
    _ranking_close(np.ones(20, bool), rng.random(20))     # no negative
    assert np.isnan(metrics.roc_auc_score(np.ones(5, bool), np.arange(5.0)))


def test_auc_refuses_like_sklearn():
    for x in ([0.0], [0.0, 1.0, 0.5]):
        with pytest.raises(ValueError) as want:
            sk.auc(x, np.ones(len(x)))
        with pytest.raises(ValueError) as got:
            metrics.auc(x, np.ones(len(x)))
        assert str(got.value) == str(want.value)
    assert metrics.auc([1.0, 0.5, 0.0], [1.0, 1.0, 0.0]) == sk.auc([1.0, 0.5, 0.0],
                                                                  [1.0, 1.0, 0.0])


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 4), st.integers(0, 5)),
                min_size=1, max_size=80),
       st.integers(1, 5))
def test_drawn_labels_match_sklearn(rows, n_labels):
    y_true = np.array([r[0] for r in rows]) % n_labels
    y_pred = np.array([r[1] for r in rows])
    score = np.array([r[2] for r in rows]) / 5.0      # few values: many ties
    labels = list(range(n_labels))
    want = sk.classification_report(y_true, y_pred, labels=labels,
                                    target_names=[str(v) for v in labels],
                                    output_dict=True, zero_division=0)
    _report_close(metrics.classification_report(y_true, y_pred, labels=labels,
                                                target_names=[str(v) for v in labels],
                                                zero_division=0), want)
    np.testing.assert_array_equal(metrics.confusion_matrix(y_true, y_pred, labels),
                                  sk.confusion_matrix(y_true, y_pred, labels=labels))
    _ranking_close(y_true == 0, score)
