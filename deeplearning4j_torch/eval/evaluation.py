"""Evaluation — counterpart of ``deeplearning4j_tpu/eval/evaluation.py``,
kept in the port as its own copy: ``Evaluation`` (accuracy, precision,
recall, F1, confusion matrix, top-N), ``EvaluationBinary``,
``RegressionEvaluation``, ``ROC``, ``ROCBinary``, ``ROCMultiClass`` and
``EvaluationCalibration``, each with ``merge``.

The accumulators hold numpy state on the host, as the reference's do;
labels, predictions and masks are numpy arrays or tensors on any device
(a tensor is copied to the host, a bf16 or f16 one as f32), so the same
predictions give the reference's statistics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _to_np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


class _Mergeable:
    """Distributed-evaluation protocol (IEvaluation.merge parity — the
    reference evaluates ANY IEvaluation across the cluster and reduces:
    dl4j-spark ``IEvaluateFlatMapFunction.java`` +
    ``IEvaluationReduceFunction.java``). Subclasses list their additive
    accumulator fields in ``_STATE_FIELDS``; everything needed for
    per-process accumulate -> allgather -> merge follows:

    - ``state()``: accumulators as a flat dict of numpy arrays (allgatherable)
    - ``load_state(d)``: overwrite accumulators from such a dict
    - ``merge(other)``: combine two accumulators (additive by default)
    - ``new_like()``: empty instance with the same configuration
    """

    _STATE_FIELDS: Tuple[str, ...] = ()

    def state(self) -> Dict[str, np.ndarray]:
        return {f: np.asarray(getattr(self, f)) for f in self._STATE_FIELDS}

    def load_state(self, d: Dict[str, np.ndarray]):
        for f in self._STATE_FIELDS:
            cur = getattr(self, f)
            v = d[f]
            setattr(self, f, type(cur)(v) if isinstance(cur, (int, float))
                    else np.asarray(v))
        return self

    def merge(self, other):
        for f in self._STATE_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    def new_like(self):
        raise NotImplementedError


def _labels_to_idx(labels):
    labels = _to_np(labels)
    if labels.ndim >= 2 and labels.shape[-1] > 1:
        return labels.argmax(-1)
    return labels.astype(np.int64).reshape(labels.shape[0], *labels.shape[1:-1]) if labels.ndim >= 2 else labels.astype(np.int64)


@dataclass
class Prediction:
    """eval/meta/Prediction.java — which example landed in which confusion
    cell, for error inspection (``record_metadata`` on :class:`Evaluation`)."""

    actual: int
    predicted: int
    metadata: object = None


class _AutoId(int):
    """Marker for auto-generated running-index metadata ids: merge offsets
    ONLY these (position in the concatenated stream); user-supplied ids —
    even ints — are never rewritten."""


class Evaluation(_Mergeable):
    """eval/Evaluation.java — multiclass classification metrics.

    Accepts (B, K) batches or time-series (B, T, K) with optional (B, T) mask.

    ``record_metadata=True`` captures a :class:`Prediction` per example on
    EVERY eval call (auto-numbering batches without ids); passing
    ``eval(..., metadata=[...])`` captures that batch regardless — the
    reference's ``eval(labels, out, recordMetaData)`` overload records
    exactly the batches that supply ids. Inspect with
    :meth:`prediction_errors` /
    :meth:`predictions_by_actual_class` / :meth:`predictions_by_predicted_class`.
    Predictions merge by concatenation; they ride along ``merge()`` but are
    NOT part of the numpy ``state()`` dict (the distributed allgather path
    exchanges fixed-shape accumulators only — DL4J likewise excludes
    metadata from its Spark reduce)."""

    _STATE_FIELDS = ("confusion", "top_n_correct", "top_n_total")

    def new_like(self) -> "Evaluation":
        return Evaluation(self.num_classes, self.top_n,
                          record_metadata=self.record_metadata)

    def merge(self, other):
        super().merge(other)
        # auto ids are running indices local to OTHER's stream: offset them
        # past this instance's predictions so merged ids stay unique and
        # equal to the position in the concatenated stream (exactly what one
        # instance over the whole stream assigns); explicit user ids are
        # never rewritten
        base = len(self.predictions)
        self.predictions.extend(
            Prediction(pr.actual, pr.predicted, _AutoId(pr.metadata + base))
            if isinstance(pr.metadata, _AutoId) else pr
            for pr in getattr(other, "predictions", ()))
        return self

    def __init__(self, num_classes: int, top_n: int = 1,
                 record_metadata: bool = False):
        self.num_classes = num_classes
        self.top_n = top_n
        self.record_metadata = record_metadata
        self.predictions: List[Prediction] = []
        self.confusion = np.zeros((num_classes, num_classes), np.int64)
        self.top_n_correct = 0
        self.top_n_total = 0

    def eval(self, labels, predictions, mask=None, metadata=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        meta = list(metadata) if metadata is not None else None
        if meta is not None and len(meta) != y.shape[0]:
            raise ValueError(
                f"metadata has {len(meta)} entries for a batch of "
                f"{y.shape[0]} examples — one id per example required")
        # explicit ids capture THIS batch (the reference's
        # eval(labels, out, recordMetaData) overload records exactly the
        # batches that supply ids); record_metadata=True captures every
        # batch, auto-numbering the ones without ids
        capture = self.record_metadata or meta is not None
        if y.ndim == 3:  # time series: flatten with mask
            if mask is not None:
                m = _to_np(mask).astype(bool).reshape(-1)
            else:
                m = np.ones(y.shape[0] * y.shape[1], bool)
            if meta is not None:  # one id per (example, timestep)
                T = y.shape[1]
                meta = [(mid, t) for mid in meta for t in range(T)]
                meta = [x for x, keep in zip(meta, m) if keep]
            y = y.reshape(-1, y.shape[-1])[m]
            p = p.reshape(-1, p.shape[-1])[m]
        yi = y.argmax(-1)
        pi = p.argmax(-1)
        np.add.at(self.confusion, (yi, pi), 1)
        if capture:
            base = len(self.predictions)
            if meta is None:
                meta = [_AutoId(i) for i in range(base, base + len(yi))]
            self.predictions.extend(
                Prediction(int(a), int(b), mid)
                for a, b, mid in zip(yi, pi, meta))
        if self.top_n > 1:
            topn = np.argsort(-p, axis=-1)[:, : self.top_n]
            self.top_n_correct += int((topn == yi[:, None]).any(-1).sum())
            self.top_n_total += len(yi)
        return self

    # --- prediction metadata (eval/meta/Prediction.java) ---
    def prediction_errors(self) -> List[Prediction]:
        """Misclassified examples (getPredictionErrors)."""
        return [pr for pr in self.predictions if pr.actual != pr.predicted]

    def predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        return [pr for pr in self.predictions if pr.actual == cls]

    def predictions_by_predicted_class(self, cls: int) -> List[Prediction]:
        return [pr for pr in self.predictions if pr.predicted == cls]

    # --- metrics (Evaluation.java getters) ---
    @property
    def num_examples(self) -> int:
        return int(self.confusion.sum())

    def accuracy(self) -> float:
        n = self.confusion.sum()
        return float(np.trace(self.confusion) / n) if n else 0.0

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.top_n_total if self.top_n_total else 0.0

    def true_positives(self) -> np.ndarray:
        return np.diag(self.confusion)

    def false_positives(self) -> np.ndarray:
        return self.confusion.sum(0) - np.diag(self.confusion)

    def false_negatives(self) -> np.ndarray:
        return self.confusion.sum(1) - np.diag(self.confusion)

    def precision(self, cls: Optional[int] = None) -> float:
        tp, fp = self.true_positives(), self.false_positives()
        if cls is not None:
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        # macro-average over classes that appear (DL4J convention)
        seen = (self.confusion.sum(1) + self.confusion.sum(0)) > 0
        vals = [float(tp[k] / (tp[k] + fp[k])) if tp[k] + fp[k] else 0.0
                for k in range(self.num_classes) if seen[k]]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        tp, fn = self.true_positives(), self.false_negatives()
        if cls is not None:
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        seen = (self.confusion.sum(1) + self.confusion.sum(0)) > 0
        vals = [float(tp[k] / (tp[k] + fn[k])) if tp[k] + fn[k] else 0.0
                for k in range(self.num_classes) if seen[k]]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def matthews_correlation(self) -> float:
        c = self.confusion.astype(np.float64)
        t = c.sum()
        s = np.trace(c)
        pk = c.sum(0)
        tk = c.sum(1)
        num = s * t - tk @ pk
        den = np.sqrt(t * t - pk @ pk) * np.sqrt(t * t - tk @ tk)
        return float(num / den) if den else 0.0

    def stats(self) -> str:
        """Evaluation.stats() textual report."""
        lines = [
            f"# examples: {self.num_examples}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} accuracy: {self.top_n_accuracy():.4f}")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion))
        return "\n".join(lines)

class EvaluationBinary(_Mergeable):
    """EvaluationBinary.java — per-output independent binary metrics."""

    _STATE_FIELDS = ("tp", "fp", "tn", "fn")

    def new_like(self) -> "EvaluationBinary":
        return EvaluationBinary(self.n, self.threshold)

    def __init__(self, num_outputs: int, threshold: float = 0.5):
        self.n = num_outputs
        self.threshold = threshold
        self.tp = np.zeros(num_outputs, np.int64)
        self.fp = np.zeros(num_outputs, np.int64)
        self.tn = np.zeros(num_outputs, np.int64)
        self.fn = np.zeros(num_outputs, np.int64)

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels).reshape(-1, self.n) > 0.5
        p = _to_np(predictions).reshape(-1, self.n) >= self.threshold
        if mask is not None:
            m = _to_np(mask).astype(bool).reshape(-1)
            y, p = y[m], p[m]
        self.tp += (y & p).sum(0)
        self.fp += (~y & p).sum(0)
        self.tn += (~y & ~p).sum(0)
        self.fn += (y & ~p).sum(0)
        return self

    def accuracy(self, i: int) -> float:
        t = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / t) if t else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0


class RegressionEvaluation(_Mergeable):
    """RegressionEvaluation.java — per-column MSE/MAE/RMSE/R²/correlation."""

    _STATE_FIELDS = ("count", "sum_err2", "sum_abs_err", "sum_y", "sum_y2",
                     "sum_p", "sum_p2", "sum_yp")

    def new_like(self) -> "RegressionEvaluation":
        return RegressionEvaluation(self.n)

    def __init__(self, num_columns: int):
        self.n = num_columns
        self.count = 0
        self.sum_err2 = np.zeros(num_columns)
        self.sum_abs_err = np.zeros(num_columns)
        self.sum_y = np.zeros(num_columns)
        self.sum_y2 = np.zeros(num_columns)
        self.sum_p = np.zeros(num_columns)
        self.sum_p2 = np.zeros(num_columns)
        self.sum_yp = np.zeros(num_columns)

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels).reshape(-1, self.n).astype(np.float64)
        p = _to_np(predictions).reshape(-1, self.n).astype(np.float64)
        if mask is not None:
            m = _to_np(mask).astype(bool).reshape(-1)
            y, p = y[m], p[m]
        self.count += len(y)
        self.sum_err2 += ((p - y) ** 2).sum(0)
        self.sum_abs_err += np.abs(p - y).sum(0)
        self.sum_y += y.sum(0)
        self.sum_y2 += (y ** 2).sum(0)
        self.sum_p += p.sum(0)
        self.sum_p2 += (p ** 2).sum(0)
        self.sum_yp += (y * p).sum(0)
        return self

    def mse(self, i: int = 0) -> float:
        return float(self.sum_err2[i] / self.count) if self.count else 0.0

    def mae(self, i: int = 0) -> float:
        return float(self.sum_abs_err[i] / self.count) if self.count else 0.0

    def rmse(self, i: int = 0) -> float:
        return float(np.sqrt(self.mse(i)))

    def r2(self, i: int = 0) -> float:
        if not self.count:
            return 0.0
        ss_tot = self.sum_y2[i] - self.sum_y[i] ** 2 / self.count
        return float(1.0 - self.sum_err2[i] / ss_tot) if ss_tot else 0.0

    def pearson(self, i: int = 0) -> float:
        n = self.count
        num = n * self.sum_yp[i] - self.sum_y[i] * self.sum_p[i]
        den = np.sqrt(n * self.sum_y2[i] - self.sum_y[i] ** 2) * np.sqrt(n * self.sum_p2[i] - self.sum_p[i] ** 2)
        return float(num / den) if den else 0.0

    def stats(self) -> str:
        cols = [f"col {i}: MSE={self.mse(i):.5f} MAE={self.mae(i):.5f} RMSE={self.rmse(i):.5f} R2={self.r2(i):.5f}"
                for i in range(self.n)]
        return "\n".join(cols)


class ROC(_Mergeable):
    """ROC.java — binary ROC/AUC + precision-recall curve via threshold sweep.

    ``num_thresholds=0`` keeps exact scores (DL4J "exact" mode); otherwise a
    fixed-width histogram of scores is accumulated (streaming-friendly —
    and the mode to use for DISTRIBUTED evaluation: exact-mode state is
    variable-length and only merges when every process saw equal counts).
    """

    _STATE_FIELDS = ("pos_hist", "neg_hist")  # histogram mode

    def new_like(self) -> "ROC":
        return ROC(self.num_thresholds)

    def state(self):
        if self.num_thresholds:
            return super().state()
        return {"scores": (np.concatenate(self._scores) if self._scores
                           else np.zeros(0)),
                "labels": (np.concatenate(self._labels) if self._labels
                           else np.zeros(0))}

    def load_state(self, d):
        if self.num_thresholds:
            return super().load_state(d)
        self._scores = [np.asarray(d["scores"])]
        self._labels = [np.asarray(d["labels"])]
        return self

    def merge(self, other: "ROC") -> "ROC":
        if self.num_thresholds:
            return super().merge(other)
        self._scores.extend(other._scores)
        self._labels.extend(other._labels)
        return self

    def __init__(self, num_thresholds: int = 200):
        self.num_thresholds = num_thresholds
        if num_thresholds:
            self.pos_hist = np.zeros(num_thresholds + 1, np.int64)
            self.neg_hist = np.zeros(num_thresholds + 1, np.int64)
        else:
            self._scores: List[np.ndarray] = []
            self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels).reshape(-1)
        p = _to_np(predictions).reshape(-1)
        if y.size and _to_np(labels).ndim >= 2 and _to_np(labels).shape[-1] == 2:
            # two-column one-hot: positive class is column 1 (DL4J convention)
            y = _to_np(labels)[..., 1].reshape(-1)
            p = _to_np(predictions)[..., 1].reshape(-1)
        if mask is not None:
            m = _to_np(mask).astype(bool).reshape(-1)
            y, p = y[m], p[m]
        if self.num_thresholds:
            bins = np.clip((p * self.num_thresholds).astype(int), 0, self.num_thresholds)
            np.add.at(self.pos_hist, bins[y > 0.5], 1)
            np.add.at(self.neg_hist, bins[y <= 0.5], 1)
        else:
            self._scores.append(p)
            self._labels.append(y)
        return self

    def _curve_counts(self):
        """(tp, fp, P, N) in DESCENDING-threshold order: index 0 is the
        above-max threshold (tp=fp=0); the last index classifies everything
        positive. fpr/tpr derived from this are monotone non-decreasing, so
        integration needs no re-sorting (re-sorting ties at fpr=0 is exactly
        what mis-ordered saturated-score curves before)."""
        if self.num_thresholds:
            tp = np.concatenate([[0], np.cumsum(self.pos_hist[::-1])])
            fp = np.concatenate([[0], np.cumsum(self.neg_hist[::-1])])
            P, N = self.pos_hist.sum(), self.neg_hist.sum()
            return tp, fp, P, N
        p = np.concatenate(self._scores) if self._scores else np.zeros(0)
        y = np.concatenate(self._labels) if self._labels else np.zeros(0)
        order = np.argsort(-p, kind="stable")
        y_sorted = y[order] > 0.5
        tp = np.concatenate([[0], np.cumsum(y_sorted)])
        fp = np.concatenate([[0], np.cumsum(~y_sorted)])
        return tp, fp, y_sorted.sum(), (~y_sorted).sum()

    def roc_curve(self) -> Tuple[np.ndarray, np.ndarray]:
        """(fpr, tpr) from (0,0) to (1,1), descending threshold."""
        tp, fp, P, N = self._curve_counts()
        tpr = tp / max(P, 1)
        fpr = fp / max(N, 1)
        return fpr, tpr

    def auc(self) -> float:
        fpr, tpr = self.roc_curve()
        return float(np.trapezoid(tpr, fpr))

    def pr_curve(self) -> Tuple[np.ndarray, np.ndarray]:
        tp, fp, P, N = self._curve_counts()
        denom = np.maximum(tp + fp, 1)
        precision = np.where(tp + fp > 0, tp / denom, 1.0)
        recall = tp / max(P, 1)
        return recall, precision

    def auc_pr(self) -> float:
        r, p = self.pr_curve()
        return float(np.trapezoid(p, r))


class _ROCList(_Mergeable):
    """Shared plumbing for per-output / per-class ROC collections
    (:class:`ROCBinary`, :class:`ROCMultiClass`): a list of :class:`ROC`
    accumulators with prefixed flat state dicts, pairwise merge and AUC
    aggregation. Subclasses own the eval semantics."""

    _key = "o"  # state-dict prefix

    def state(self):
        return {f"{self._key}{k}_{f}": v for k, r in enumerate(self.rocs)
                for f, v in r.state().items()}

    def load_state(self, d):
        for k, r in enumerate(self.rocs):
            r.load_state({f: d[f"{self._key}{k}_{f}"] for f in r.state()})
        return self

    def merge(self, other):
        for r, o in zip(self.rocs, other.rocs):
            r.merge(o)
        return self

    def auc(self, i: int) -> float:
        return self.rocs[i].auc()

    def average_auc(self) -> float:
        return float(np.mean([r.auc() for r in self.rocs]))


class ROCBinary(_ROCList):
    """ROCBinary.java:28 — independent binary ROC/AUC per output column.

    For networks with ``n`` independent sigmoid outputs (multi-label):
    per-output ROC/AUC/PR, unlike :class:`EvaluationBinary`'s fixed-threshold
    counts. Accepts (B, n) or time-series (B, T, n); ``mask`` may be
    per-example (B,)/(B, 1)/(B, T) or PER-OUTPUT with the same shape as the
    labels (DL4J supports per-output masking for multi-label time series)."""

    def new_like(self) -> "ROCBinary":
        return ROCBinary(self.n, self.num_thresholds)

    def __init__(self, num_outputs: int, num_thresholds: int = 200):
        self.n = num_outputs
        self.num_thresholds = num_thresholds
        self.rocs = [ROC(num_thresholds) for _ in range(num_outputs)]

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        y2 = y.reshape(-1, self.n)
        p2 = p.reshape(-1, self.n)
        m2 = None
        if mask is not None:
            m = _to_np(mask)
            if m.shape == y.shape:  # per-output mask
                m2 = m.reshape(-1, self.n).astype(bool)
            else:  # per-example/timestep: keep or drop whole rows —
                # a (B,) mask against (B, T, n) labels broadcasts over T;
                # DL4J's column-vector (B, 1) / (B, T, 1) shapes squeeze
                m = m.astype(bool)
                while m.ndim > y.ndim - 1 and m.shape[-1] == 1:
                    m = m[..., 0]
                m = np.broadcast_to(
                    m.reshape(m.shape + (1,) * (y.ndim - 1 - m.ndim)),
                    y.shape[:-1])
                rows = m.reshape(-1)
                y2, p2 = y2[rows], p2[rows]
        for k, roc in enumerate(self.rocs):
            if m2 is not None:
                keep = m2[:, k]
                roc.eval(y2[keep, k], p2[keep, k])
            else:
                roc.eval(y2[:, k], p2[:, k])
        return self

    def auc_pr(self, output: int) -> float:
        return self.rocs[output].auc_pr()

    def roc_curve(self, output: int):
        return self.rocs[output].roc_curve()

    def pr_curve(self, output: int):
        return self.rocs[output].pr_curve()

    def stats(self) -> str:
        lines = [f"output {k}: AUC={self.auc(k):.4f} AUPRC={self.auc_pr(k):.4f}"
                 for k in range(self.n)]
        lines.append(f"average AUC: {self.average_auc():.4f}")
        return "\n".join(lines)


class ROCMultiClass(_ROCList):
    """ROCMultiClass.java — one-vs-all ROC per class."""

    _key = "c"

    def new_like(self) -> "ROCMultiClass":
        return ROCMultiClass(len(self.rocs), self.rocs[0].num_thresholds
                             if self.rocs else 200)

    def __init__(self, num_classes: int, num_thresholds: int = 200):
        self.rocs = [ROC(num_thresholds) for _ in range(num_classes)]

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels)
        p = _to_np(predictions)
        y2 = y.reshape(-1, y.shape[-1])
        p2 = p.reshape(-1, p.shape[-1])
        if mask is not None:
            m = _to_np(mask).astype(bool).reshape(-1)
            y2, p2 = y2[m], p2[m]
        for k, roc in enumerate(self.rocs):
            roc.eval(y2[:, k], p2[:, k])
        return self


class EvaluationCalibration(_Mergeable):
    """EvaluationCalibration.java — reliability diagram + residual histogram."""

    _STATE_FIELDS = ("bin_counts", "bin_pos", "bin_prob_sum")

    def new_like(self) -> "EvaluationCalibration":
        return EvaluationCalibration(self.num_bins)

    def __init__(self, num_bins: int = 10):
        self.num_bins = num_bins
        self.bin_counts = np.zeros(num_bins, np.int64)
        self.bin_pos = np.zeros(num_bins, np.int64)
        self.bin_prob_sum = np.zeros(num_bins)

    def eval(self, labels, predictions, mask=None):
        y = _to_np(labels).reshape(-1)
        p = _to_np(predictions).reshape(-1)
        if _to_np(labels).ndim >= 2 and _to_np(labels).shape[-1] > 1:
            yl = _to_np(labels).reshape(-1, _to_np(labels).shape[-1])
            pl = _to_np(predictions).reshape(-1, yl.shape[-1])
            y, p = yl.reshape(-1), pl.reshape(-1)
        bins = np.clip((p * self.num_bins).astype(int), 0, self.num_bins - 1)
        np.add.at(self.bin_counts, bins, 1)
        np.add.at(self.bin_pos, bins[y > 0.5], 1)
        np.add.at(self.bin_prob_sum, bins, p)
        return self

    def reliability(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mean predicted prob, empirical frequency) per bin."""
        c = np.maximum(self.bin_counts, 1)
        return self.bin_prob_sum / c, self.bin_pos / c

    def expected_calibration_error(self) -> float:
        conf, freq = self.reliability()
        w = self.bin_counts / max(self.bin_counts.sum(), 1)
        return float(np.sum(w * np.abs(conf - freq)))
