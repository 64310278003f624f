"""Objective functions: label checks, gradients, leaf renewal and output
transforms.

The port's counterpart of ``lightgbm_tpu/objectives.py`` (reference:
include/LightGBM/objective_function.h:38-120).  Every objective of the
reference trains: binary logloss, the regression family (L2, L1, huber,
fair, poisson, quantile, MAPE, gamma, tweedie), cross-entropy and its
lambda form, multiclass softmax and one-vs-all multiclass, and the ranking
objectives ``lambdarank`` and ``rank_xendcg`` (ranking.py).  Gradients and
``convert_output`` work in float32 torch on the device of the score, with
the reference's operations in the reference's order, so the sign, clip and
L2 gradients are bit-equal to the JAX package's and the others differ only
where torch's and XLA's float32 ``exp``, ``sigmoid`` and ``log1p`` round
differently.  A multiclass objective takes the (N, K) score and returns
(N, K) gradients.  Label checks run at ``init``, never in a gradient call,
so a gradient call holds no host read and can run inside a CUDA graph.

``boost_from_score`` runs on the host.  Label means are taken in float64 and
rounded to float32 as the reference's float32 ``jnp.mean`` result is
rounded; for 0/1 labels the sum is exact either way, so the two agree.  The
percentile objectives (L1, quantile, MAPE) boost from
``_weighted_percentile``, the reference's host numpy copied unchanged.  The
multiclass objectives boost from 0.

Leaf renewal (``need_renew_leaf``: L1, quantile, MAPE; reference:
RenewTreeOutput) sets each leaf of a grown tree to a percentile of its
in-bag rows' residuals, on the device (``_leaf_percentile``: sorts,
cumulative counts and segment minima in float32 torch ops, weights summed
in exact fixed point, no host read).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config, canonical_objective
from .ops.histogram import dequantize, hist_shifts, quantize
from .utils.log import LightGBMError

_EPS = 1e-15


class ObjectiveFunction:
    """Base class (reference: objective_function.h:38)."""

    name = "none"
    num_model_per_iteration = 1
    is_ranking = False
    # True when each grown tree's leaves are renewed from the residuals
    # (renew_leaf_values); such an objective trains eager
    need_renew_leaf = False
    # False when get_gradients does host work each iteration (rank_xendcg's
    # draw), so the fused iteration cannot capture it
    jit_safe_gradients = True

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self._on_device = {}

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None,
             position: Optional[np.ndarray] = None, n: int = 0) -> None:
        self.num_data = n
        self.label = np.asarray(label, np.float32)
        self.weight = None if weight is None else np.asarray(weight, np.float32)
        self._on_device = {}

    def _tensor(self, name: str, device: torch.device) -> Optional[torch.Tensor]:
        """The float32 array ``name`` on ``device``, copied there once."""
        key = (name, str(device))
        if key not in self._on_device:
            a = getattr(self, name)
            self._on_device[key] = (None if a is None
                                    else torch.as_tensor(a).to(device))
        return self._on_device[key]

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise LightGBMError(f"objective {self.name!r} does not train in "
                            "lightgbm_torch yet")

    def state_attrs(self) -> Tuple[str, ...]:
        """Attributes that change from one iteration to the next and that a
        checkpoint carries (reference: objectives.py:85); none here."""
        return ()

    def set_state_attr(self, name: str, value: np.ndarray,
                       device: torch.device) -> None:
        """A checkpoint's value of the state attribute ``name``, on
        ``device``."""
        setattr(self, name, torch.as_tensor(value).to(device))

    def boost_from_score(self) -> float:
        return 0.0

    def _apply_weight(self, grad, hess):
        w = self._tensor("weight", grad.device)
        if w is not None:
            if grad.dim() == 2:
                w = w[:, None]
            grad = grad * w
            hess = hess * w
        return grad, hess

    def _weighted_label_mean(self) -> float:
        """The label mean (weighted when weights exist) as the float32 the
        reference's ``jnp.mean`` / weighted ratio returns."""
        y = self.label.astype(np.float64)
        if self.weight is not None:
            w = self.weight.astype(np.float64)
            return float(np.float32(np.sum(y * w) / np.sum(w)))
        return float(np.float32(np.sum(y) / len(y)))

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw

    def renew_leaf_values(self, score: torch.Tensor, leaf_id: torch.Tensor,
                          num_leaves: int, sample_mask: torch.Tensor
                          ) -> torch.Tensor:
        """(num_leaves,) renewed leaf values (reference: RenewTreeOutput)."""
        raise NotImplementedError


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:94"""
    name = "regression"

    def init(self, label, weight, **kw):
        if self.config.reg_sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        super().init(label, weight, **kw)

    def get_gradients(self, score):
        grad = score - self._tensor("label", score.device)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        return self._weighted_label_mean()

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
            return (torch.sign(r) * r * r).numpy()
        return raw


class RegressionL1(ObjectiveFunction):
    """reference: regression_objective.hpp:208 (leaves renewed to the
    weighted median)"""
    name = "regression_l1"
    need_renew_leaf = True

    def get_gradients(self, score):
        diff = score - self._tensor("label", score.device)
        grad = torch.sign(diff)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        return _weighted_percentile(self.label, self.weight, 0.5)

    def renew_leaf_values(self, score, leaf_id, num_leaves, sample_mask):
        resid = self._tensor("label", score.device) - score
        return _leaf_percentile(resid, leaf_id, num_leaves, 0.5,
                                self._tensor("weight", score.device),
                                sample_mask)


class Huber(ObjectiveFunction):
    """reference: regression_objective.hpp:294"""
    name = "huber"

    def get_gradients(self, score):
        diff = score - self._tensor("label", score.device)
        a = self.config.alpha
        grad = torch.clamp(diff, -a, a)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        return self._weighted_label_mean()


class Fair(ObjectiveFunction):
    """reference: regression_objective.hpp:352"""
    name = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        diff = score - self._tensor("label", score.device)
        grad = c * diff / (torch.abs(diff) + c)
        # a float32 c * c divided (a Python number over a tensor would be
        # a reciprocal times c * c, rounded twice)
        hess = torch.full_like(diff, c * c) / ((torch.abs(diff) + c) ** 2)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        # RegressionFairLoss inherits RegressionL2loss's weighted label
        # mean (hpp:352 : public L2loss)
        return self._weighted_label_mean()


class _LogLink(ObjectiveFunction):
    """The log-link objectives: boost from log(weighted label mean), output
    exp(raw)."""

    def boost_from_score(self):
        return float(np.log(max(self._weighted_label_mean(), _EPS)))

    def convert_output(self, raw):
        r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
        return torch.exp(r).numpy()


class Poisson(_LogLink):
    """reference: regression_objective.hpp:399 (log link)"""
    name = "poisson"

    def init(self, label, weight, **kw):
        if np.any(label < 0):
            raise LightGBMError("poisson objective requires non-negative "
                                "labels")
        super().init(label, weight, **kw)

    def get_gradients(self, score):
        ex = torch.exp(score)
        grad = ex - self._tensor("label", score.device)
        hess = torch.exp(score + self.config.poisson_max_delta_step)
        return self._apply_weight(grad, hess)


class Quantile(ObjectiveFunction):
    """reference: regression_objective.hpp:482"""
    name = "quantile"
    need_renew_leaf = True

    def get_gradients(self, score):
        a = self.config.alpha
        delta = score - self._tensor("label", score.device)
        grad = torch.where(delta >= 0, 1.0 - a, -a).to(torch.float32)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        return _weighted_percentile(self.label, self.weight, self.config.alpha)

    def renew_leaf_values(self, score, leaf_id, num_leaves, sample_mask):
        resid = self._tensor("label", score.device) - score
        return _leaf_percentile(resid, leaf_id, num_leaves, self.config.alpha,
                                self._tensor("weight", score.device),
                                sample_mask)


class MAPE(ObjectiveFunction):
    """reference: regression_objective.hpp:580"""
    name = "mape"
    need_renew_leaf = True

    def init(self, label, weight, **kw):
        super().init(label, weight, **kw)
        # 1 / max(1, |label|) in float32, times the row weights
        self._mape_w = np.float32(1.0) / np.maximum(np.float32(1.0),
                                                    np.abs(self.label))
        if self.weight is not None:
            self._mape_w = self._mape_w * self.weight

    def get_gradients(self, score):
        # gradients scale by 1/max(1, |label|); hessians are the plain row
        # weights, not the label weights (regression_objective.hpp:615-631:
        # hessians[i] = 1.0f, or weights_[i] when weighted)
        diff = score - self._tensor("label", score.device)
        grad = torch.sign(diff) * self._tensor("_mape_w", score.device)
        w = self._tensor("weight", score.device)
        hess = torch.ones_like(score) if w is None else w
        return grad, hess

    def boost_from_score(self):
        return _weighted_percentile(self.label, self._mape_w, 0.5)

    def renew_leaf_values(self, score, leaf_id, num_leaves, sample_mask):
        resid = self._tensor("label", score.device) - score
        return _leaf_percentile(resid, leaf_id, num_leaves, 0.5,
                                self._tensor("_mape_w", score.device),
                                sample_mask)


class Gamma(_LogLink):
    """reference: regression_objective.hpp:681 (log link)"""
    name = "gamma"

    def get_gradients(self, score):
        y = self._tensor("label", score.device)
        e = torch.exp(-score)
        grad = 1.0 - y * e
        hess = y * e
        return self._apply_weight(grad, hess)


class Tweedie(_LogLink):
    """reference: regression_objective.hpp:718 (log link)"""
    name = "tweedie"

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        y = self._tensor("label", score.device)
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = -y * e1 + e2
        hess = -y * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._apply_weight(grad, hess)


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp:22"""
    name = "binary"

    def init(self, label, weight, **kw):
        u = np.unique(label[~np.isnan(label)])
        if not np.all(np.isin(u, [0.0, 1.0])):
            raise LightGBMError("binary objective requires 0/1 labels")
        super().init(label, weight, **kw)
        n_pos = float(np.sum(label > 0))
        n_neg = float(len(label) - n_pos)
        self._label_weights = (1.0, 1.0)
        if self.config.is_unbalance and n_pos > 0 and n_neg > 0:
            if n_pos > n_neg:
                self._label_weights = (1.0, n_pos / n_neg)
            else:
                self._label_weights = (n_neg / n_pos, 1.0)
        elif self.config.scale_pos_weight != 1.0:
            self._label_weights = (1.0, self.config.scale_pos_weight)

    def get_gradients(self, score):
        sig = self.config.sigmoid
        y = self._tensor("label", score.device)
        p = torch.sigmoid(sig * score)
        wn, wp = self._label_weights
        lw = torch.where(y > 0, wp, wn).to(torch.float32)
        grad = sig * (p - y) * lw
        hess = sig * sig * p * (1.0 - p) * lw
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return 0.0
        pavg = min(max(self._weighted_label_mean(), 1e-9), 1.0 - 1e-9)
        return float(np.log(pavg / (1.0 - pavg)) / self.config.sigmoid)

    def convert_output(self, raw):
        # scaled in float64 like the reference's NumPy operand, then float32
        r = torch.as_tensor(self.config.sigmoid * np.asarray(raw),
                            dtype=torch.float32)
        return torch.sigmoid(r).numpy()


class _Multiclass(ObjectiveFunction):
    """K trees per iteration over integer labels in [0, K); the one-hot
    label matrix lives on the device beside the labels."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class

    def init(self, label, weight, **kw):
        k = self.config.num_class
        il = label.astype(np.int64)
        if np.any((il < 0) | (il >= k)):
            raise LightGBMError(f"multiclass labels must be in [0, {k})")
        super().init(label, weight, **kw)
        self.onehot = np.eye(k, dtype=np.float32)[il]


class MulticlassSoftmax(_Multiclass):
    """reference: multiclass_objective.hpp:25 — one tree per class per
    iteration."""
    name = "multiclass"

    def get_gradients(self, score):
        # score: (N, K); jax.nn.softmax's operations
        e = torch.exp(score - score.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        grad = p - self._tensor("onehot", score.device)
        hess = 2.0 * p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def convert_output(self, raw):
        r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
        return torch.softmax(r, dim=-1).numpy()


class MulticlassOVA(_Multiclass):
    """reference: multiclass_objective.hpp:187 — K independent binary
    problems."""
    name = "multiclassova"

    def get_gradients(self, score):
        sig = self.config.sigmoid
        p = torch.sigmoid(sig * score)
        grad = sig * (p - self._tensor("onehot", score.device))
        hess = sig * sig * p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def convert_output(self, raw):
        # scaled in float64 like the reference's NumPy operand, then float32
        r = torch.as_tensor(self.config.sigmoid * np.asarray(raw),
                            dtype=torch.float32)
        p = torch.sigmoid(r)
        return (p / p.sum(dim=-1, keepdim=True)).numpy()


class CrossEntropy(ObjectiveFunction):
    """reference: xentropy_objective.hpp:45 — labels in [0, 1]."""
    name = "cross_entropy"

    def init(self, label, weight, **kw):
        if np.any((label < 0) | (label > 1)):
            raise LightGBMError("cross_entropy labels must be in [0, 1]")
        super().init(label, weight, **kw)

    def get_gradients(self, score):
        p = torch.sigmoid(score)
        grad = p - self._tensor("label", score.device)
        hess = p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        pavg = min(max(self._weighted_label_mean(), 1e-9), 1.0 - 1e-9)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, raw):
        r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
        return torch.sigmoid(r).numpy()


class CrossEntropyLambda(ObjectiveFunction):
    """reference: xentropy_objective.hpp:186 — the log1p(exp) form."""
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        y = self._tensor("label", score.device)
        w = self._tensor("weight", score.device)
        ep = torch.exp(score)
        if w is None:
            z = torch.log1p(ep)
            grad = ep / (1.0 + ep) * (1.0 - y / torch.clamp(z, min=_EPS))
            sig = ep / (1.0 + ep)
            hess = sig * (1.0 - sig) * (1.0 - y / torch.clamp(z, min=_EPS)) \
                + sig * sig * y / torch.clamp(z * z, min=_EPS)
            return grad, hess
        z = torch.log1p(ep) * w
        sig = ep / (1.0 + ep)
        grad = sig * w * (1.0 - y / torch.clamp(z, min=_EPS))
        hess = sig * (1.0 - sig) * w * (1.0 - y / torch.clamp(z, min=_EPS)) \
            + (sig * w) ** 2 * y / torch.clamp(z * z, min=_EPS)
        return grad, hess

    def boost_from_score(self):
        # the unweighted label mean, weighted or not (the reference's)
        y = self.label.astype(np.float64)
        pavg = float(np.float32(np.sum(y) / len(y)))
        pavg = min(max(pavg, 1e-9), 1.0 - 1e-9)
        return float(np.log(np.expm1(-np.log1p(-pavg))) if pavg < 1 else 0.0)

    def convert_output(self, raw):
        r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
        return torch.log1p(torch.exp(r)).numpy()


# ---------------------------------------------------------------------------
# percentiles
# ---------------------------------------------------------------------------

def _weighted_percentile(values, weights, alpha) -> float:
    """The reference's PercentileFun / WeightedPercentileFun
    (regression_objective.hpp:19,51) on the host, bit-faithful: the
    unweighted form interpolates along the DESCENDING order at position
    (n-1)*(1-alpha) with `v1 - (v1 - v2) * bias` evaluated in f64 and
    rounded to the label dtype (label_t = float); the weighted form walks
    the weighted CDF with upper_bound and interpolates only when the
    straddling weight gap >= 1.0."""
    v32 = np.asarray(values, np.float32)
    n = len(v32)
    if n == 0:
        return 0.0
    if n == 1:
        return float(v32[0])
    if weights is None:
        float_pos = (n - 1) * (1.0 - alpha)
        pos = int(float_pos) + 1
        if pos < 1:
            return float(v32.max())
        if pos >= n:
            return float(v32.min())
        bias = float_pos - (pos - 1)
        desc = np.sort(v32)[::-1]
        v1 = np.float64(desc[pos - 1])
        v2 = np.float64(desc[pos])
        return float(np.float32(v1 - (v1 - v2) * bias))
    w = np.asarray(weights, np.float64)
    order = np.argsort(v32, kind="stable")
    cw = np.cumsum(w[order])
    threshold = cw[-1] * alpha
    pos = int(np.searchsorted(cw, threshold, side="right"))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(v32[order[pos]])
    v1 = np.float64(v32[order[pos - 1]])
    v2 = np.float64(v32[order[pos]])
    if cw[pos] - cw[pos - 1] >= 1.0:
        return float(np.float32(
            (threshold - cw[pos - 1]) / (cw[pos] - cw[pos - 1]) * (v2 - v1)
            + v1))
    return float(np.float32(v1))


def _exclusive_cumsum(x):
    """[0, x0, x0 + x1, ...]: the cumulative sum shifted by one."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0)[:-1]])


def _leaf_percentile(resid, leaf_id, num_leaves, alpha, weight, sample_mask):
    """(num_leaves,) alpha-percentile of each leaf's in-bag residuals, on
    the device (reference: RenewTreeOutput in regression_objective.hpp;
    ``lightgbm_tpu/objectives.py:528-626``).  PercentileFun when unweighted
    (order statistics of the leaf's in-bag subset, interpolated along the
    descending order), WeightedPercentileFun otherwise (the weighted CDF
    walked with upper_bound; interpolated only when the straddling weight
    is >= 1.0).  float32, as the JAX package computes it outside
    ``jax_enable_x64``; a leaf with no in-bag row gets 0.  resid, weight:
    (n,) float32; leaf_id: (n,) every row's leaf; sample_mask: (n,), nonzero
    in bag, or None.  The weighted form sums the weights in exact fixed
    point (``ops/histogram.py``'s shift, found on the device), so the
    renewal is the same on every device and run, and equal to the JAX
    package's wherever its float32 sums are exact.  No value is read on
    the host."""
    L = int(num_leaves)
    n = resid.shape[0]
    dev = resid.device
    if n == 0:
        return torch.zeros(L, dtype=resid.dtype, device=dev)
    iota = torch.arange(n, device=dev)
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if sample_mask is None
            else sample_mask != 0)
    # two keys (leaf, residual): sort by residual, then stably by leaf
    o1 = torch.sort(resid, stable=True).indices
    o2 = torch.sort(leaf_id[o1], stable=True).indices
    order = o1[o2]
    sl = leaf_id[order].long()
    sr = resid[order]
    sm = mask[order]
    # a row's rank among its leaf's in-bag rows (1-based)
    cm = torch.cumsum(sm.long(), 0)
    leaf_cnt = torch.zeros(L, dtype=torch.long, device=dev).index_add_(
        0, sl, sm.long())
    leaf_start_cnt = _exclusive_cumsum(leaf_cnt)
    rank = cm - leaf_start_cnt[sl]

    def segment_min(v):
        return torch.full((L,), n, dtype=torch.long, device=dev).scatter_reduce_(
            0, sl, v, "amin")

    def subset_value_at(asc_idx):
        """Each leaf's asc_idx-th (0-based) in-bag residual."""
        tgt = torch.where(sm & (rank - 1 == torch.clamp(asc_idx, min=0)[sl]),
                          iota, n)
        return sr[torch.clamp(segment_min(tgt), 0, n - 1)]

    c = leaf_cnt
    if weight is None:
        # PercentileFun: interpolate along the DESCENDING subset order at
        # float_pos = (c-1)*(1-alpha); v1 = desc[pos-1], v2 = desc[pos]
        float_pos = (c - 1).to(sr.dtype) * (1.0 - alpha)
        pos = torch.floor(float_pos).long() + 1
        bias = float_pos - (pos - 1)
        v1 = subset_value_at(c - pos)       # ascending index of desc[pos-1]
        v2 = subset_value_at(c - 1 - pos)
        ret = v1 - (v1 - v2) * bias
        vmin = subset_value_at(torch.zeros_like(c))
        ret = torch.where(pos < 1, subset_value_at(c - 1), ret)
        ret = torch.where(pos >= c, vmin, ret)
        ret = torch.where(c <= 1, vmin, ret)
        return torch.where(c > 0, ret, 0.0).to(resid.dtype)
    # WeightedPercentileFun on the in-bag subset.  The weights' running
    # sums are exact fixed point, as the histograms' are (a float32 scan
    # or atomic sum on the card rounds in an order that varies from run to
    # run): each in-leaf CDF and leaf total is rounded to float32 once
    sw = weight[order] * sm
    shift = hist_shifts(sw.abs().amax()[None], n)[0]
    q = quantize(sw, shift)
    leaf_q = torch.zeros(L, dtype=torch.long, device=dev).index_add_(0, sl, q)
    cw_in = dequantize(torch.cumsum(q, 0) - _exclusive_cumsum(leaf_q)[sl],
                       shift)
    leaf_tot = dequantize(leaf_q, shift)
    threshold = alpha * leaf_tot
    # pos = upper_bound(cdf, threshold): the first in-bag row with cdf > thr
    first = segment_min(torch.where(sm & (cw_in > threshold[sl]), iota, n))
    found = first < n
    at = torch.clamp(first, 0, n - 1)
    pos_rank = torch.where(found, rank[at], c + 1) - 1  # 0-based subset index
    pos_rank = torch.minimum(pos_rank, c - 1)           # pos = min(pos, c-1)
    v2 = subset_value_at(pos_rank)
    v1 = subset_value_at(pos_rank - 1)
    cdf_pos = torch.where(found, cw_in[at], leaf_tot)   # in-leaf cdf at pos
    w_pos = torch.where(found, sw[at], 0.0)
    cdf_prev = cdf_pos - w_pos
    interp = (threshold - cdf_prev) / torch.clamp(w_pos, min=1e-300) \
        * (v2 - v1) + v1
    ret = torch.where(w_pos >= 1.0, interp, v1)
    ret = torch.where((pos_rank <= 0) | (pos_rank >= c - 1), v2, ret)
    ret = torch.where(c <= 1, subset_value_at(torch.zeros_like(c)), ret)
    return torch.where(c > 0, ret, 0.0).to(resid.dtype)


_OBJECTIVE_CLASSES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    objective_function.cpp:72)."""
    name = canonical_objective(str(config.objective))
    if name == "none":
        return None
    if name in ("lambdarank", "rank_xendcg"):
        from .ranking import LambdarankNDCG, RankXENDCG
        return (LambdarankNDCG(config) if name == "lambdarank"
                else RankXENDCG(config))
    cls = _OBJECTIVE_CLASSES.get(name)
    if cls is None:
        raise LightGBMError(f"Unknown objective {name}")
    return cls(config)
