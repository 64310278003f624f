"""Evaluation metrics, on the host in numpy.

The port's counterpart of ``lightgbm_tpu/metrics.py`` (reference:
src/metric/regression_metric.hpp, binary_metric.hpp, multiclass_metric.hpp,
xentropy_metric.hpp, rank_metric.hpp, map_metric.hpp), every metric of the
reference: the regression metrics ``l1``, ``l2``, ``rmse``, ``r2``,
``quantile``, ``huber``, ``fair``, ``poisson``, ``mape``, ``gamma``,
``gamma_deviance`` and ``tweedie``; ``binary_logloss``, ``binary_error``,
``auc`` and ``average_precision``; ``multi_logloss``, ``multi_error`` (with
``multi_error_top_k``) and ``auc_mu``; ``cross_entropy``,
``cross_entropy_lambda`` and ``kldiv``; and the ranking metrics ``ndcg``
and ``map`` at the cutoffs of ``eval_at`` over the query boundaries a
Dataset's ``group`` gives.
Metrics run off the training hot path: the scores come to the host once
per evaluation, and each metric is the reference's float64 numpy
arithmetic, so both packages give the same value on the same scores.
``metric="None"`` evaluates nothing.
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

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None) -> None:
        self.label = np.asarray(label, np.float64)
        self.query_boundaries = query_boundaries
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


class R2Metric(_PointwiseMetric):
    name = "r2"
    higher_better = True

    def evaluate(self, score, convert):
        pred = np.asarray(convert(score), np.float64)
        w = self.weight if self.weight is not None else np.ones_like(
            self.label)
        ybar = np.sum(self.label * w) / np.sum(w)
        ss_res = np.sum(w * (self.label - pred) ** 2)
        ss_tot = np.sum(w * (self.label - ybar) ** 2)
        return [(self.name, float(1.0 - ss_res / max(ss_tot, 1e-300)), True)]


class QuantileMetric(_PointwiseMetric):
    name = "quantile"

    def point_loss(self, p):
        a = self.config.alpha
        d = self.label - p
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"

    def point_loss(self, p):
        a = self.config.alpha
        d = np.abs(p - self.label)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"

    def point_loss(self, p):
        c = self.config.fair_c
        d = np.abs(p - self.label)
        return c * c * (d / c - np.log1p(d / c))


class PoissonMetric(_PointwiseMetric):
    name = "poisson"

    def point_loss(self, p):
        return p - self.label * np.log(np.maximum(p, 1e-10))


class MAPEMetric(_PointwiseMetric):
    name = "mape"

    def point_loss(self, p):
        return np.abs((self.label - p) / np.maximum(1.0, np.abs(self.label)))


class GammaMetric(_PointwiseMetric):
    """The negative log-likelihood of a gamma of unit shape (reference:
    regression_metric.hpp:257)."""
    name = "gamma"

    def point_loss(self, p):
        psafe = np.maximum(p, 1e-10)
        return self.label / psafe + np.log(psafe)


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"

    def point_loss(self, p):
        eps = 1e-10
        r = self.label / np.maximum(p, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(r, eps), eps))
                      + r - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"

    def point_loss(self, p):
        rho = self.config.tweedie_variance_power
        psafe = np.maximum(p, 1e-10)
        a = self.label * np.power(psafe, 1.0 - rho) / (1.0 - rho)
        b = np.power(psafe, 2.0 - rho) / (2.0 - rho)
        return -a + b


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


class AveragePrecisionMetric(Metric):
    """reference: binary_metric.hpp:271"""
    name = "average_precision"
    higher_better = True

    def evaluate(self, score, convert):
        s = np.asarray(score, np.float64)
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-s, kind="stable")
        y, w = y[order], w[order]
        pos_w = w * (y > 0)
        cum_pos = np.cumsum(pos_w)
        cum_all = np.cumsum(w)
        total_pos = cum_pos[-1] if len(cum_pos) else 0.0
        if total_pos <= 0:
            return [(self.name, 1.0, True)]
        precision = cum_pos / np.maximum(cum_all, 1e-300)
        ap = np.sum(precision * pos_w) / total_pos
        return [(self.name, float(ap), True)]


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


class AucMuMetric(Metric):
    """reference: multiclass_metric.hpp:184 — the mean over class pairs of
    the AUC of the two classes' rows, ranked by the difference of their
    raw scores, every pair weighted alike (``auc_mu_weights`` is not
    ported: training with it raises)."""
    name = "auc_mu"
    higher_better = True

    def evaluate(self, score, convert):
        p = np.asarray(score, np.float64)
        if p.ndim == 1:
            p = p[:, None]
        k = p.shape[1]
        il = self.label.astype(np.int64)
        w = self.weight if self.weight is not None else np.ones(len(il))
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                mask = (il == a) | (il == b)
                if not mask.any():
                    continue
                s = p[mask, a] - p[mask, b]
                y = (il[mask] == a).astype(np.float64)
                aucs.append(_binary_auc(s, y, w[mask]))
        val = float(np.mean(aucs)) if aucs else 1.0
        return [(self.name, val, True)]


class CrossEntropyMetric(_PointwiseMetric):
    name = "cross_entropy"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1.0 - eps)
        y = self.label
        return -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))


class CrossEntropyLambdaMetric(Metric):
    """Cross-entropy on p = 1 - exp(-z), z = log1p(exp(score)) the
    objective's output."""
    name = "cross_entropy_lambda"

    def evaluate(self, score, convert):
        eps = 1e-15
        z = np.maximum(np.asarray(convert(score), np.float64), eps)
        y = self.label
        p = np.clip(1.0 - np.exp(-z), eps, 1.0 - eps)
        loss = -(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))
        return [(self.name, self._avg(loss), False)]


class KLDivMetric(_PointwiseMetric):
    name = "kldiv"

    def point_loss(self, p):
        eps = 1e-15
        p = np.clip(p, eps, 1.0 - eps)
        y = np.clip(self.label, eps, 1.0 - eps)
        return (y * np.log(y / p)
                + (1.0 - y) * np.log((1.0 - y) / (1.0 - p)))


def _compact_queries(qb, *arrays):
    """The rows of (nq, 2) [start, size] query spans gathered into a
    contiguous layout: cumulative boundaries and the gathered arrays; 1-D
    cumulative boundaries pass through."""
    qb = np.asarray(qb, np.int64)
    if qb.ndim != 2:
        return (qb,) + arrays
    starts, sizes = qb[:, 0], qb[:, 1]
    if len(starts):
        idx = np.concatenate([np.arange(s, s + z)
                              for s, z in zip(starts, sizes)])
    else:
        idx = np.zeros(0, np.int64)
    cum = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return (cum,) + tuple(a[idx] for a in arrays)


class NDCGMetric(Metric):
    """reference: rank_metric.hpp:20 + dcg_calculator.cpp; NDCG@k for each
    k of ``eval_at``, averaged over queries (a query without a positive
    gain counts 1)."""
    name = "ndcg"
    higher_better = True

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        if query_boundaries is None:
            raise LightGBMError("ndcg metric requires query information")
        gains = self.config.label_gain
        max_label = int(self.label.max()) + 1 if len(self.label) else 1
        if gains is None:
            gains = (2.0 ** np.arange(max(max_label, 32))) - 1.0
        self.label_gain = np.asarray(gains, np.float64)

    def evaluate(self, score, convert):
        ks = self.config.eval_at or [1, 2, 3, 4, 5]
        qb, s, lab = _compact_queries(self.query_boundaries,
                                      np.asarray(score, np.float64),
                                      self.label)
        nq = len(qb) - 1
        qid = np.repeat(np.arange(nq), np.diff(qb))
        lab = lab.astype(np.int64)
        gain = self.label_gain[np.clip(lab, 0, len(self.label_gain) - 1)]
        # rank within the query by descending score (stable)
        order = np.lexsort((-s, qid))
        rank = np.empty(len(s), np.int64)
        rank[order] = np.arange(len(s)) - qb[qid[order]]
        disc = 1.0 / np.log2(rank + 2.0)
        # the ideal ranking: descending gain within the query
        iorder = np.lexsort((-gain, qid))
        irank = np.empty(len(s), np.int64)
        irank[iorder] = np.arange(len(s)) - qb[qid[iorder]]
        idisc = 1.0 / np.log2(irank + 2.0)
        out = []
        qw = np.ones(nq)
        for k in ks:
            m = rank < k
            im = irank < k
            dcg = np.bincount(qid, weights=gain * disc * m, minlength=nq)
            idcg = np.bincount(qid, weights=gain * idisc * im, minlength=nq)
            ok = idcg > 0
            nd = np.where(ok, dcg / np.maximum(idcg, 1e-300), 1.0)
            out.append((f"ndcg@{int(k)}", float(np.average(nd, weights=qw)),
                        True))
        return out


class MAPMetric(Metric):
    """reference: map_metric.hpp:21 (MAP@k over binary relevance, label >
    0); a query without a relevant row counts 1."""
    name = "map"
    higher_better = True

    def init(self, label, weight, query_boundaries=None):
        super().init(label, weight, query_boundaries)
        if query_boundaries is None:
            raise LightGBMError("map metric requires query information")

    def evaluate(self, score, convert):
        ks = self.config.eval_at or [1, 2, 3, 4, 5]
        qb, s, lab = _compact_queries(self.query_boundaries,
                                      np.asarray(score, np.float64),
                                      self.label)
        nq = len(qb) - 1
        qid = np.repeat(np.arange(nq), np.diff(qb))
        rel = (lab > 0).astype(np.float64)
        order = np.lexsort((-s, qid))
        rank = np.empty(len(s), np.int64)
        rank[order] = np.arange(len(s)) - qb[qid[order]]
        out = []
        for k in ks:
            srel = rel[order]
            sqid = qid[order]
            srank = rank[order]
            # the relevant rows at or above each rank of its query
            cum = np.cumsum(srel) - np.repeat(
                np.concatenate([[0.0], np.cumsum(np.bincount(
                    sqid, weights=srel, minlength=nq))[:-1]]), np.diff(qb))
            prec = cum / (srank + 1.0)
            m = (srank < k) & (srel > 0)
            num = np.bincount(sqid, weights=prec * m, minlength=nq)
            npos = np.bincount(sqid, weights=srel, minlength=nq)
            denom = np.minimum(npos, k)
            ok = denom > 0
            ap = np.where(ok, num / np.maximum(denom, 1e-300), 1.0)
            out.append((f"map@{int(k)}", float(np.mean(ap)), True))
        return out


_METRIC_CLASSES = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric, "r2": R2Metric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric,
    "ndcg": NDCGMetric, "map": MAPMetric,
}


def default_metric_for_objective(objective: str) -> str:
    """The metric of ``metric=""`` (reference: the objective's default)."""
    return {
        "regression": "l2", "regression_l1": "l1", "huber": "huber",
        "fair": "fair", "poisson": "poisson", "quantile": "quantile",
        "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
        "binary": "binary_logloss", "multiclass": "multi_logloss",
        "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
        "cross_entropy_lambda": "cross_entropy_lambda",
        "lambdarank": "ndcg", "rank_xendcg": "ndcg"}.get(objective, "l2")


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
            raise LightGBMError(f"Unknown metric {n}")
        out.append(cls(config))
    return out
