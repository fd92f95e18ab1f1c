"""The port's evaluation (``deeplearning4j_torch/eval``) held against the
JAX package's: every evaluation class fed the same labels and
predictions (the port's as tensors, the reference's as numpy arrays, from
one numpy seed) gives the same statistics within 1e-12, alone and after
``merge`` of two accumulators; the HTML reports are the same text.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_torch import eval as TE
from deeplearning4j_tpu import eval as JE

TOL = 1e-12


def _probs(rng, n, k):
    z = rng.standard_normal((n, k))
    e = np.exp(z)
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, n, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]


def _binary(rng, n, k):
    return (rng.random((n, k)) < 0.4).astype(np.float32)


def _sigm(rng, n, k):
    return (1 / (1 + np.exp(-rng.standard_normal((n, k))))).astype(np.float32)


def _reg(rng, n, k):
    return rng.standard_normal((n, k)).astype(np.float32)


def _mask(rng, n):
    return (rng.random(n) < 0.8).astype(np.float32)


# name: (constructor args, labels, predictions, masked, metrics)
CASES = {
    "Evaluation": ((5,), {"top_n": 2}, _onehot, _probs, True,
                   lambda e: [e.accuracy(), e.top_n_accuracy(),
                              e.precision(), e.recall(), e.f1(),
                              e.matthews_correlation(),
                              *[e.precision(c) for c in range(5)],
                              *[e.recall(c) for c in range(5)],
                              *[e.f1(c) for c in range(5)],
                              e.confusion, e.stats()]),
    "EvaluationBinary": ((3,), {}, _binary, _sigm, True,
                         lambda e: [f(i) for i in range(3) for f in
                                    (e.accuracy, e.precision, e.recall,
                                     e.f1)]),
    "RegressionEvaluation": ((3,), {}, _reg, _reg, True,
                             lambda e: [f(i) for i in range(3) for f in
                                        (e.mse, e.mae, e.rmse, e.r2,
                                         e.pearson)] + [e.stats()]),
    "ROC": ((), {"num_thresholds": 50}, _binary, _sigm, True,
            lambda e: [e.auc(), e.auc_pr(), *e.roc_curve(), *e.pr_curve()]),
    "ROC/exact": ((), {"num_thresholds": 0}, _binary, _sigm, False,
                  lambda e: [e.auc(), e.auc_pr(), *e.roc_curve(),
                             *e.pr_curve()]),
    "ROCBinary": ((3,), {"num_thresholds": 50}, _binary, _sigm, False,
                  lambda e: [e.average_auc(), e.stats(),
                             *[e.auc(i) for i in range(3)],
                             *[e.auc_pr(i) for i in range(3)]]),
    "ROCMultiClass": ((4,), {"num_thresholds": 50}, _onehot, _probs, False,
                      lambda e: [e.average_auc(),
                                 *[e.auc(i) for i in range(4)]]),
    "EvaluationCalibration": ((), {"num_bins": 10}, _binary, _sigm, True,
                              lambda e: [*e.reliability(),
                                         e.expected_calibration_error()]),
}


def _feed(name, seed):
    args, kw, lab, pred, masked, _ = CASES[name]
    cls = name.split("/")[0]
    k = args[0] if args else 1
    rng = np.random.default_rng(seed)
    n = 40
    y, p = lab(rng, n, k), pred(rng, n, k)
    if not args:  # a single column
        y, p = y[:, 0], p[:, 0]
    m = _mask(rng, n) if masked else None
    j = getattr(JE, cls)(*args, **kw)
    t = getattr(TE, cls)(*args, **kw)
    j.eval(y, p, mask=m)
    t.eval(torch.from_numpy(y), torch.from_numpy(p),
           mask=None if m is None else torch.from_numpy(m))
    return j, t


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
        else:
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_evaluation_matches_reference(name):
    j, t = _feed(name, 0)
    metrics = CASES[name][-1]
    _same(metrics(t), metrics(j))


@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_evaluation_matches_reference(name):
    j, t = _feed(name, 1)
    j2, t2 = _feed(name, 2)
    j.merge(j2)
    t.merge(t2)
    metrics = CASES[name][-1]
    _same(metrics(t), metrics(j))


def test_bf16_predictions_are_read_as_f32():
    rng = np.random.default_rng(3)
    y, p = _onehot(rng, 16, 4), _probs(rng, 16, 4)
    t = TE.Evaluation(4)
    t.eval(torch.from_numpy(y), torch.from_numpy(p).to(torch.bfloat16))
    j = JE.Evaluation(4)
    j.eval(y, torch.from_numpy(p).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(t.confusion, j.confusion)


def test_html_reports_equal():
    j, t = _feed("Evaluation", 4)
    assert TE.export_evaluation_to_html(t) == JE.export_evaluation_to_html(j)
    jr, tr = _feed("ROC", 5)
    jc, tc = _feed("EvaluationCalibration", 6)
    assert TE.export_roc_charts_to_html(tr, calibration=tc) == \
        JE.export_roc_charts_to_html(jr, calibration=jc)
