"""Evaluation metrics of the ported objectives, on the host in numpy.

The port's counterpart of ``lightgbm_tpu/metrics.py`` (reference:
src/metric/regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp), trimmed to the metrics of the ported objectives:
``l1``, ``l2``, ``rmse``, ``binary_logloss``, ``binary_error``, ``auc``,
``multi_logloss`` and ``multi_error`` (with ``multi_error_top_k``).
Metrics run off the training hot path: the scores come to the host once
per evaluation, and each metric is the reference's float64 numpy
arithmetic, so both packages give the same value on the same scores.  Other metric names raise "not yet
ported"; ``metric="None"`` evaluates nothing.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .config import Config, canonical_metric
from .utils.log import LightGBMError

EvalResult = Tuple[str, float, bool]  # (name, value, higher_better)


class Metric:
    name = "none"
    higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray]) -> None:
        self.label = np.asarray(label, np.float64)
        self.weight = (None if weight is None
                       else np.asarray(weight, np.float64))
        self.sum_weight = (float(len(self.label)) if weight is None
                           else float(np.sum(self.weight)))

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(pointwise * self.weight) / self.sum_weight)
        return float(np.mean(pointwise))

    def evaluate(self, score: np.ndarray,
                 convert: Callable) -> List[EvalResult]:
        raise NotImplementedError


class _PointwiseMetric(Metric):
    """Average of a pointwise loss over converted predictions."""

    def point_loss(self, pred: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def evaluate(self, score, convert):
        pred = np.asarray(convert(score), np.float64)
        return [(self.name, self._avg(self.point_loss(pred)),
                 self.higher_better)]


class L2Metric(_PointwiseMetric):
    name = "l2"

    def point_loss(self, p):
        return (p - self.label) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def evaluate(self, score, convert):
        [(_, v, hb)] = super().evaluate(score, convert)
        return [(self.name, float(np.sqrt(v)), hb)]


class L1Metric(_PointwiseMetric):
    name = "l1"

    def point_loss(self, p):
        return np.abs(p - self.label)


class BinaryLoglossMetric(_PointwiseMetric):
    name = "binary_logloss"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1.0 - eps)
        return -(self.label * np.log(p) + (1.0 - self.label) * np.log(1.0 - p))


class BinaryErrorMetric(_PointwiseMetric):
    name = "binary_error"

    def point_loss(self, p):
        return np.where(self.label > 0, p <= 0.5, p > 0.5).astype(np.float64)


class AUCMetric(Metric):
    """reference: binary_metric.hpp:160, weighted AUC with ties."""
    name = "auc"
    higher_better = True

    def evaluate(self, score, convert):
        s = np.asarray(score, np.float64)
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        return [(self.name, _binary_auc(s, y, w), True)]


def _binary_auc(s, y, w):
    """Weighted AUC: in descending-score order a pair is ranked right when
    the positive comes first; a group of tied scores gets half credit."""
    order = np.argsort(-s, kind="stable")
    s, y, w = s[order], y[order], w[order]
    pos_w = w * (y > 0)
    neg_w = w * (y <= 0)
    if len(s) == 0:
        return 1.0
    boundary = np.concatenate([[True], s[1:] != s[:-1]])
    gid = np.cumsum(boundary) - 1
    ng = gid[-1] + 1
    gp = np.bincount(gid, weights=pos_w, minlength=ng)
    gn = np.bincount(gid, weights=neg_w, minlength=ng)
    tp, tn = pos_w.sum(), neg_w.sum()
    if tp <= 0 or tn <= 0:
        return 1.0
    cn_after = tn - np.cumsum(gn)
    correct = np.sum(gp * (cn_after + 0.5 * gn))
    return float(correct / (tp * tn))


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def evaluate(self, score, convert):
        p = np.asarray(convert(score), np.float64)   # (N, K)
        il = self.label.astype(np.int64)
        pl = np.clip(p[np.arange(len(il)), il], 1e-15, 1.0)
        return [(self.name, self._avg(-np.log(pl)), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def evaluate(self, score, convert):
        p = np.asarray(convert(score), np.float64)
        il = self.label.astype(np.int64)
        k = self.config.multi_error_top_k
        if k <= 1:
            err = (np.argmax(p, axis=1) != il).astype(np.float64)
            return [(self.name, self._avg(err), False)]
        # top-k error (reference: multiclass_metric.hpp:139): wrong when k
        # or more classes score strictly above the label's
        pl = p[np.arange(len(il)), il]
        err = (np.sum(p > pl[:, None], axis=1) >= k).astype(np.float64)
        return [(f"multi_error@{k}", self._avg(err), False)]


_METRIC_CLASSES = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
}


def default_metric_for_objective(objective: str) -> str:
    """The metric of ``metric=""`` (reference: the objective's default)."""
    return {"regression": "l2", "binary": "binary_logloss",
            "multiclass": "multi_logloss",
            "multiclassova": "multi_logloss"}.get(objective, "l2")


def create_metrics(config: Config, objective_name: str) -> List[Metric]:
    """The metrics of ``config.metric`` (reference: metric.cpp:22); a
    comma-separated string or a list, "" for the objective's default,
    "None" for none."""
    raw = config.metric
    if raw in ("", None):
        names = [default_metric_for_objective(objective_name)]
    else:
        if isinstance(raw, str):
            names = [x.strip() for x in raw.split(",") if x.strip()]
        else:
            names = list(raw)
        names = [canonical_metric(n) for n in names]
    out = []
    for n in names:
        if n in ("none", ""):
            continue
        cls = _METRIC_CLASSES.get(n)
        if cls is None:
            raise LightGBMError(f"metric {n!r} is not yet ported to "
                                "lightgbm_torch")
        out.append(cls(config))
    return out
