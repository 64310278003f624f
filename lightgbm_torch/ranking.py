"""Ranking objectives: LambdaRank-NDCG and XE-NDCG.

The port's counterpart of ``lightgbm_tpu/ranking.py`` (reference:
src/objective/rank_objective.hpp: LambdarankNDCG :139, RankXENDCG :385).
Queries are bucketed by size on the host into padded (Q, M) blocks, M = 8,
16, 32, ...; each bucket's gradients are a few dense float32 torch ops on
the score's device: lambdarank forms the sorted-space top-K pairs of every
query, (Q, K, M) tensors, instead of the reference's per-query double
loops.  A bucket whose queries all have one size and follow each other in
the row order (``_contiguous_span``; MSLR-shaped data, ~120 documents a
query, is one such bucket) reads its scores as a slice and writes its
gradients back as one slice-add; any other bucket gathers its scores and
scatters its gradients by index.

Everything an iteration reads is built on its device at the first call
(the bucket index, label, gain, discount and 1/maxDCG tensors), and nothing in
``LambdarankNDCG.get_gradients`` reads a device value on the host or
branches on one, so the fused iteration captures it in its head graph
(models/gbdt.py); the position biases are updated in place.  Rows are
sorted within a query with ``torch.sort(stable=True)`` on the negated
masked score, which orders ties by their position in the query, as the JAX
package's stable ``lax.sort`` does.  Every sum (the pairs' lambdas, the
softmax, the position biases' per-position sums over a padded (positions,
rows) gather) folds in halves (``_fold_sum``), the discounts come from the
host and the normalisation's log2 runs in float64: on equal scores (the
first iteration) the card's gradients equal the CPU's bit for bit, and
every device repeats its own.  ``RankXENDCG`` draws its per-iteration gammas
on the host from ``np.random.RandomState(objective_seed)``, as the JAX
package does, and so trains on the eager iteration.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .objectives import ObjectiveFunction
from .utils.log import LightGBMError

_NEG = -1e30
# pair elements (K x M per query) of one chunk of a lambdarank bucket; each
# of the chunk's dozen (q, K, M) float32 temporaries is at most 64 MiB
_PAIR_BUDGET = 1 << 24


def default_label_gain(max_label: int = 31) -> np.ndarray:
    return (2.0 ** np.arange(max_label + 1)) - 1.0


def query_spans(query_boundaries) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, sizes) from 1-D cumulative boundaries or (nq, 2) [start,
    size] spans."""
    qb = np.asarray(query_boundaries, np.int64)
    if qb.ndim == 2:
        return qb[:, 0], qb[:, 1]
    return qb[:-1], np.diff(qb)


class _QueryBuckets(NamedTuple):
    sizes: List[int]                  # padded M per bucket
    doc_index: List[np.ndarray]       # (Qb, M) flat doc indices, -1 = pad
    inv_max_dcg: List[np.ndarray]     # (Qb,) per query
    query_ids: List[np.ndarray]       # (Qb,) original query index


def _bucketize(query_boundaries: np.ndarray, labels: np.ndarray,
               label_gain: np.ndarray, truncation_level: int
               ) -> _QueryBuckets:
    """Queries by padded size (8, 16, 32, ... up to the largest query), with
    each query's 1/maxDCG at the truncation level in float64 (reference:
    DCGCalculator::CalMaxDCGAtK); 0 for a query without a positive gain."""
    starts, sizes = query_spans(query_boundaries)
    nq = len(starts)
    max_m = int(sizes.max()) if nq else 1
    bucket_sizes: List[int] = []
    m = 8
    while m < max_m:
        bucket_sizes.append(m)
        m *= 2
    bucket_sizes.append(max(m, 8))

    inv_max = np.zeros(nq)
    gains = label_gain[np.clip(labels.astype(np.int64), 0,
                               len(label_gain) - 1)]
    disc_all = 1.0 / np.log2(np.arange(max_m) + 2.0)
    for qi in range(nq):
        g = np.sort(gains[starts[qi]:starts[qi] + sizes[qi]])[::-1]
        g = g[:truncation_level]
        md = float(np.sum(g * disc_all[:len(g)]))
        inv_max[qi] = 1.0 / md if md > 0 else 0.0

    which = np.searchsorted(bucket_sizes, sizes)
    out_sizes, out_idx, out_inv, out_qids = [], [], [], []
    for bi, m in enumerate(bucket_sizes):
        qsel = np.where(which == bi)[0]
        if len(qsel) == 0:
            continue
        idx = np.full((len(qsel), m), -1, np.int64)
        for r, qi in enumerate(qsel):
            s, z = starts[qi], sizes[qi]
            idx[r, :z] = np.arange(s, s + z)
        out_sizes.append(m)
        out_idx.append(idx)
        out_inv.append(inv_max[qsel])
        out_qids.append(qsel)
    return _QueryBuckets(out_sizes, out_idx, out_inv, out_qids)


def _contiguous_span(idx: np.ndarray):
    """(offset, true size) when every query of the bucket has one true size
    and their rows follow each other in the row order, else None: then the
    bucket's scores are a slice reshaped and padded, and its gradients one
    slice-add."""
    q, m = idx.shape
    valid = idx >= 0
    z = int(valid[0].sum())
    if z == 0 or not (valid.sum(axis=1) == z).all() or not valid[:, :z].all():
        return None
    off = int(idx[0, 0])
    expect = off + np.arange(q * z, dtype=np.int64).reshape(q, z)
    if not np.array_equal(idx[:, :z], expect):
        return None
    return off, z


class _Bucket(NamedTuple):
    """One bucket's tensors on the device."""
    span: Optional[Tuple[int, int]]
    idx: torch.Tensor        # (Q, M) int64 doc index, pads at 0
    scatter: torch.Tensor    # (Q * M,) int64 doc index, pads at n
    valid: torch.Tensor      # (Q, M) bool
    inv: torch.Tensor        # (Q,) float32 1/maxDCG
    lab: torch.Tensor        # (Q, M) float32 label
    gain: torch.Tensor       # (Q, M) float32 label gain
    disc: torch.Tensor       # (M,) float32 1/log2(position + 2)


def _fold_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` by halving folds: elementwise adds in one fixed
    order, so the float32 result is the same on every device (torch's
    reductions order their adds by device and shape)."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        y = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        if n % 2:
            y.narrow(dim, 0, 1).add_(x.narrow(dim, n - 1, 1))
        x = y
    return x.squeeze(dim)


def _bucket_scores(score: torch.Tensor, b: _Bucket) -> torch.Tensor:
    """A bucket's (Q, M) padded scores: slice, reshape and pad on a
    contiguous bucket, a gather otherwise."""
    q, m = b.idx.shape
    if b.span is not None:
        off, z = b.span
        s = score[off:off + q * z].reshape(q, z)
        return torch.nn.functional.pad(s, (0, m - z)) if z < m else s
    return score[b.idx.reshape(-1)].reshape(q, m)


def _bucket_scatter_add(vec: torch.Tensor, vals: torch.Tensor,
                        b: _Bucket) -> None:
    """Add a bucket's (Q, M) values into the (n + 1,) vector, pads into its
    last entry, which the caller drops.  Every row lies in one bucket slot,
    so each of the n entries receives one value, on every device."""
    if b.span is not None:
        off, z = b.span
        q = b.idx.shape[0]
        vec[off:off + q * z] += vals[:, :z].reshape(-1)
    else:
        vec.index_add_(0, b.scatter, vals.reshape(-1))


def _lambdarank_chunk(s, lab, v, imd, gain, disc, sigma: float, norm: bool,
                      K: int):
    """Pairwise lambdas of q padded queries, (q, M) each (reference:
    rank_objective.hpp:180 GetGradientsForOneQuery, which iterates ``for i
    < min(truncation_level, cnt): for j in (i, cnt)`` over the documents
    sorted by score): the (q, K, M) pairs of the top K against every later
    document, in sorted space, then moved back to the query's order."""
    q, M = s.shape
    masked = torch.where(v, s, _NEG)
    # a stable ascending sort of -masked; + 0.0 makes -0.0 keys +0.0, so
    # that every sort the card may pick orders the two alike
    order = torch.sort(-masked + 0.0, dim=-1, stable=True).indices
    ss = masked.gather(1, order)
    labs = lab.gather(1, order)
    gains_s = gain.gather(1, order)
    vs = v.gather(1, order)
    best = masked.amax(dim=-1, keepdim=True)
    worst = torch.where(v, s, -_NEG).amin(dim=-1, keepdim=True)
    has_range = best != worst

    sk, labk, gk, vk = ss[:, :K], labs[:, :K], gains_s[:, :K], vs[:, :K]
    sd = sk[:, :, None] - ss[:, None, :]                   # (q, K, M)
    sgn = torch.sign(labk[:, :, None] - labs[:, None, :])
    ar = torch.arange(M, device=s.device)
    upper = ar[None, :] > ar[:K, None]                     # j > a
    pair_valid = (vk[:, :, None] & vs[:, None, :] & (sgn != 0)
                  & upper[None])
    delta = ((gk[:, :, None] - gains_s[:, None, :]).abs()
             * (disc[:K][None, :, None] - disc[None, None, :]).abs()
             * imd[:, None, None])
    if norm:
        delta = torch.where(has_range[..., None],
                            delta / (0.01 + sd.abs()), delta)
    # p = sigmoid(-sigma * (s_high - s_low)); the higher-labelled document
    # of the pair is position a when sgn > 0, else position j
    p = torch.sigmoid(-sigma * sgn * sd)
    lam = -sigma * p * delta                               # the high doc's
    hs = sigma * sigma * p * (1.0 - p) * delta
    lam = torch.where(pair_valid, lam, 0.0)
    hs = torch.where(pair_valid, hs, 0.0)
    slam = sgn * lam                                       # signed for a
    g_sorted = -_fold_sum(slam, 1)
    g_sorted[:, :K] += _fold_sum(slam, 2)
    h_sorted = _fold_sum(hs, 1)
    h_sorted[:, :K] += _fold_sum(hs, 2)
    if norm:
        # log2(1 + x) / x in float64, rounded once: the same float32 on
        # every device
        sum_lambdas = (-2.0 * _fold_sum(_fold_sum(lam, 2), 1)).double()
        factor = torch.where(
            sum_lambdas > 0,
            torch.log2(1.0 + sum_lambdas) / sum_lambdas.clamp(min=1e-20),
            1.0).float()
        g_sorted = g_sorted * factor[:, None]
        h_sorted = h_sorted * factor[:, None]
    g = torch.empty_like(g_sorted).scatter_(1, order, g_sorted)
    h = torch.empty_like(h_sorted).scatter_(1, order, h_sorted)
    return g, h


def _lambdarank_bucket(scores, labels_q, valid, inv_max_dcg, gains_q, disc,
                       sigma: float, norm: bool, trunc: int,
                       chunk: Optional[int] = None):
    """Pairwise lambdas of one padded bucket, (Q, M) scores, labels, valid
    flags and gains, (Q,) 1/maxDCG and the (M,) position discounts;
    returns (grad, hess), (Q, M).  The queries go through in chunks of
    ``chunk`` (by default as many as ``_PAIR_BUDGET`` pair elements
    hold)."""
    Q, M = scores.shape
    K = min(trunc, M)
    if chunk is None:
        chunk = max(1, _PAIR_BUDGET // (K * M))
    if Q <= chunk:
        return _lambdarank_chunk(scores, labels_q, valid, inv_max_dcg,
                                 gains_q, disc, sigma, norm, K)
    gs, hs = [], []
    for a in range(0, Q, chunk):
        g, h = _lambdarank_chunk(scores[a:a + chunk], labels_q[a:a + chunk],
                                 valid[a:a + chunk],
                                 inv_max_dcg[a:a + chunk],
                                 gains_q[a:a + chunk], disc, sigma, norm, K)
        gs.append(g)
        hs.append(h)
    return torch.cat(gs), torch.cat(hs)


class _RankingObjective(ObjectiveFunction):
    """The buckets of a ranking objective and their device tensors."""

    is_ranking = True

    def _init_buckets(self, label, query_boundaries, label_gain):
        if query_boundaries is None:
            raise LightGBMError(f"{self.name} requires query information "
                                "(set group)")
        self.qb = np.asarray(query_boundaries, np.int64)
        covered = int(query_spans(self.qb)[1].sum())
        if self.qb.ndim == 1 and covered != len(label):
            raise LightGBMError(f"sum of query sizes ({covered}) does not "
                                f"match the number of rows ({len(label)})")
        self.label_gain_np = np.asarray(label_gain, np.float64)
        self.buckets = _bucketize(self.qb, np.asarray(label),
                                  self.label_gain_np,
                                  self.config.lambdarank_truncation_level)
        self._spans = [_contiguous_span(ix) for ix in self.buckets.doc_index]
        self._dev: Dict[str, List[_Bucket]] = {}

    def _device_buckets(self, device: torch.device) -> List[_Bucket]:
        """Every bucket's tensors on ``device``, built at its first call."""
        key = str(device)
        if key not in self._dev:
            lab = np.asarray(self.label, np.float64)
            gains = self.label_gain_np[np.clip(
                lab.astype(np.int64), 0, len(self.label_gain_np) - 1)]
            n = len(lab)

            def t(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=dtype).to(device)

            out = []
            for ix, inv, span in zip(self.buckets.doc_index,
                                     self.buckets.inv_max_dcg, self._spans):
                safe = np.maximum(ix, 0)
                out.append(_Bucket(
                    span=span, idx=t(safe, torch.int64),
                    scatter=t(np.where(ix >= 0, ix, n).reshape(-1),
                              torch.int64),
                    valid=t(ix >= 0, torch.bool),
                    inv=t(inv, torch.float32),
                    lab=t(lab[safe], torch.float32),
                    gain=t(gains[safe], torch.float32),
                    disc=t(1.0 / np.log2(np.arange(ix.shape[1]) + 2.0),
                           torch.float32)))
            self._dev[key] = out
        return self._dev[key]


class LambdarankNDCG(_RankingObjective):
    """reference: rank_objective.hpp:139, with position-debiased lambdarank
    (:44-66 the score shift, :303 UpdatePositionBiasFactors)."""
    name = "lambdarank"

    def init(self, label, weight, query_boundaries=None, position=None,
             n=0):
        super().init(label, weight, n=n)
        c = self.config
        label = np.asarray(label)
        lg = c.label_gain
        if lg is None:
            lg = default_label_gain(max(int(np.max(label)) if len(label)
                                        else 1, 31))
        max_label = int(np.max(label)) if len(label) else 0
        if max_label >= len(lg):
            raise LightGBMError(f"label {max_label} exceeds label_gain size")
        self._init_buckets(label, query_boundaries, lg)
        self._positions = None
        self.pos_biases: Optional[torch.Tensor] = None
        if position is not None:
            pos = np.asarray(position, np.int64).reshape(-1)
            if len(pos) != n:
                raise LightGBMError(
                    f"position has {len(pos)} entries for {n} rows")
            if len(pos) and pos.min() < 0:
                raise LightGBMError("positions must be non-negative")
            self.num_position_ids = int(pos.max()) + 1 if len(pos) else 0
            self._positions = pos
            self._pos_counts = np.bincount(
                pos, minlength=self.num_position_ids).astype(np.float32)
            # the rows of each position, padded with n (a zero entry)
            P = self.num_position_ids
            width = int(self._pos_counts.max()) if P else 0
            rows = np.full((P, max(width, 1)), n, np.int64)
            order = np.argsort(pos, kind="stable")
            start = np.concatenate([[0], np.cumsum(self._pos_counts)
                                    .astype(np.int64)])
            for p in range(P):
                seg = order[start[p]:start[p + 1]]
                rows[p, :len(seg)] = seg
            self._pos_rows = rows
            self._pos_reg = float(c.lambdarank_position_bias_regularization)
            self._pos_lr = float(c.learning_rate)

    def _position_tensors(self, device):
        """The positions, per-position counts and row lists on ``device``,
        and the biases, allocated there at the first call and updated in
        place after."""
        key = ("positions", str(device))
        if key not in self._on_device:
            self._on_device[key] = (
                torch.as_tensor(self._positions).to(device),
                torch.as_tensor(self._pos_counts).to(device),
                torch.as_tensor(self._pos_rows).to(device))
            self.pos_biases = torch.zeros(self.num_position_ids,
                                          dtype=torch.float32, device=device)
        return self._on_device[key]

    def state_attrs(self):
        """The position biases, updated every iteration (reference:
        ranking.py:272-273)."""
        return ("pos_biases",) if self._positions is not None else ()

    def set_state_attr(self, name, value, device):
        """Restored biases written into the tensor the fused head graph
        updates in place, allocated first if no iteration ran yet."""
        self._position_tensors(device)
        getattr(self, name).copy_(torch.as_tensor(value))

    def get_gradients(self, score):
        c = self.config
        n = score.shape[0]
        dev = score.device
        if self._positions is not None:
            positions, _, _ = self._position_tensors(dev)
            score = score + self.pos_biases[positions]
        grad = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        hess = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        for b in self._device_buckets(dev):
            g, h = _lambdarank_bucket(
                _bucket_scores(score, b), b.lab, b.valid, b.inv, b.gain,
                b.disc, sigma=float(c.sigmoid), norm=bool(c.lambdarank_norm),
                trunc=int(c.lambdarank_truncation_level))
            _bucket_scatter_add(grad, g, b)
            _bucket_scatter_add(hess, h, b)
        grad, hess = self._apply_weight(grad[:n], hess[:n])
        if self._positions is not None:
            self._update_position_bias(grad, hess)
        return grad, hess

    def _update_position_bias(self, grad, hess) -> None:
        """A Newton-Raphson step on the per-position bias factors
        (reference: rank_objective.hpp:303 UpdatePositionBiasFactors),
        written into ``pos_biases`` in place."""
        _, counts, rows = self._position_tensors(grad.device)
        zero = grad.new_zeros(1)
        d1 = -_fold_sum(torch.cat([grad, zero])[rows], 1)
        d2 = -_fold_sum(torch.cat([hess, zero])[rows], 1)
        d1 = d1 - self.pos_biases * self._pos_reg * counts
        d2 = d2 - self._pos_reg * counts
        self.pos_biases.add_(self._pos_lr * d1 / (d2.abs() + 0.001))


def _xendcg_bucket(scores, phi, valid):
    """XE-NDCG gradients of one padded bucket (reference:
    rank_objective.hpp:401-452)."""
    masked = torch.where(valid, scores, _NEG)
    e = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    rho = e / _fold_sum(e, 1)[:, None]
    rho = torch.where(valid, rho, 0.0)
    inv_denom = 1.0 / _fold_sum(phi * valid, 1)[:, None].clamp(min=1e-15)
    l1 = -phi * inv_denom + rho
    params1 = torch.where(valid, l1 / (1.0 - rho).clamp(min=1e-15), 0.0)
    sum_l1 = _fold_sum(params1, 1)[:, None]
    l2 = rho * (sum_l1 - params1)
    params2 = torch.where(valid, l2 / (1.0 - rho).clamp(min=1e-15), 0.0)
    sum_l2 = _fold_sum(params2, 1)[:, None]
    l3 = rho * (sum_l2 - params2)
    grad = torch.where(valid, l1 + l2 + l3, 0.0)
    hess = torch.where(valid, rho * (1.0 - rho), 0.0)
    return grad, hess


class RankXENDCG(_RankingObjective):
    """reference: rank_objective.hpp:385 (XE-NDCG, arxiv 1911.09798)."""
    name = "rank_xendcg"
    jit_safe_gradients = False   # a fresh host draw every iteration

    def init(self, label, weight, query_boundaries=None, position=None,
             n=0):
        super().init(label, weight, n=n)
        label = np.asarray(label)
        self._init_buckets(label, query_boundaries, default_label_gain(
            max(int(np.max(label)) if len(label) else 1, 31)))
        self._label_np = label
        self._rng = np.random.RandomState(self.config.objective_seed)

    def get_gradients(self, score):
        n = score.shape[0]
        dev = score.device
        grad = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        hess = torch.zeros(n + 1, dtype=torch.float32, device=dev)
        # fresh gammas each iteration (reference: rands_ per query)
        gamma = self._rng.rand(n)
        phi_flat = np.power(2.0, self._label_np.astype(np.int64)) - gamma
        for b, ix in zip(self._device_buckets(dev), self.buckets.doc_index):
            phi = torch.as_tensor(phi_flat[np.maximum(ix, 0)],
                                  dtype=torch.float32).to(dev)
            g, h = _xendcg_bucket(_bucket_scores(score, b), phi, b.valid)
            _bucket_scatter_add(grad, g, b)
            _bucket_scatter_add(hess, h, b)
        return self._apply_weight(grad[:n], hess[:n])
