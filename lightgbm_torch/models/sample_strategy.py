"""Row sampling strategies: bagging and GOSS.

The port's counterpart of ``lightgbm_tpu/models/sample_strategy.py``
(reference: src/boosting/sample_strategy.cpp, bagging.hpp:15, goss.hpp:19).
A strategy returns each iteration a {0, 1} float32 in-bag mask over the
padded rows and the gradients it scales, (N,) or, for K class trees, (N, K)
with every class of a row scaled alike (reference:
sample_strategy.py:140-146, :210-234); the engine multiplies the mask
into the count channel and hands the grower a compaction capacity
(models/gbdt.py, ops/compact.py).  The masks are drawn with
``utils.random.uniform``, which equals the reference's ``jax.random.uniform``
bit for bit, under the reference's keys, so both packages sample the same
rows.  ``n`` is the row count padded to 256, as in the reference: GOSS's
``k_top`` and the pos/neg labels are the padded ones (pad rows are
negatives with zero gradients).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.random import prng_key, uniform


class SampleStrategy:
    """Returns (mask, grad, hess) per iteration; mask == 1 means in-bag."""

    def __init__(self, config: Config, num_data: int,
                 label: Optional[np.ndarray] = None,
                 device: torch.device = torch.device("cpu")):
        self.config = config
        self.num_data = num_data
        self.label = label
        self.device = device

    def is_active(self) -> bool:
        return False

    def mask_key(self, iteration: int) -> int:
        """Two iterations with the same key draw the same mask, so the
        in-bag count the compaction capacity reads back is cached on it."""
        return iteration

    def sample(self, iteration: int, grad: torch.Tensor, hess: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mask = torch.ones(grad.shape[0], dtype=torch.float32,
                          device=grad.device)
        return mask, grad, hess

    def fused_mode(self, iteration: int) -> str:
        """How the fused iteration gets this iteration's mask (reference:
        sample_strategy.py:55-61): ``none`` (no sampling), ``mask_arg``
        (the epoch's mask, drawn before the replay and copied into the
        graph's input) or ``traced`` (drawn inside the graph from a key
        the host writes into a device buffer)."""
        return "none"

    def expected_fraction(self, iteration: int) -> float:
        """The expected in-bag share of this iteration's mask: the fused
        path's analytic compaction capacity reads it."""
        return 1.0


class BaggingSampleStrategy(SampleStrategy):
    """Fraction bagging, pos/neg-balanced bagging and, with query
    boundaries, ``bagging_by_query`` (reference: bagging.hpp); the mask is
    redrawn every ``bagging_freq`` iterations.  By query, one draw per query
    keeps or drops its rows together; rows outside every query (the pad)
    take the out-of-range query id, whose mask entry is 0."""

    def __init__(self, config: Config, num_data: int, label=None,
                 device: torch.device = torch.device("cpu"),
                 query_boundaries=None):
        super().__init__(config, num_data, label, device)
        c = config
        self.use_posneg = (c.pos_bagging_fraction < 1.0
                           or c.neg_bagging_fraction < 1.0)
        self.active = (c.bagging_freq > 0
                       and (c.bagging_fraction < 1.0 or self.use_posneg))
        if self.active and self.use_posneg and label is not None:
            self._is_pos = torch.as_tensor(np.asarray(label) > 0,
                                           device=device)
        self._qid = None
        if self.active and c.bagging_by_query \
                and query_boundaries is not None:
            from ..ranking import query_spans
            starts, sizes = query_spans(query_boundaries)
            nq = len(starts)
            qid = np.full(num_data, nq, np.int64)
            for qi in range(nq):
                qid[starts[qi]:starts[qi] + sizes[qi]] = qi
            self._qid = torch.as_tensor(qid, device=device)
            self._nq = nq
        self._mask = None
        self._mask_epoch = -1

    def is_active(self) -> bool:
        return self.active

    def mask_key(self, iteration: int) -> int:
        # the mask is a pure function of the bagging epoch
        return iteration // max(self.config.bagging_freq, 1)

    def fused_mode(self, iteration: int) -> str:
        return "mask_arg" if self.active else "none"

    def sample(self, iteration: int, grad, hess):
        if not self.active:
            return super().sample(iteration, grad, hess)
        m = self.epoch_mask(iteration)
        mg = m if grad.dim() == 1 else m[:, None]
        return m, grad * mg, hess * mg

    def epoch_mask(self, iteration: int) -> torch.Tensor:
        """The (cached) in-bag mask of this iteration's bagging epoch."""
        c = self.config
        epoch = self.mask_key(iteration)
        if self._mask is None or epoch != self._mask_epoch:
            key = prng_key(c.bagging_seed * 131071 + epoch)
            if self._qid is not None:
                u = uniform(key, self._nq, self.device)
                qmask = torch.cat([u < c.bagging_fraction,
                                   torch.zeros(1, dtype=torch.bool,
                                               device=self.device)])
                self._mask = qmask[self._qid].to(torch.float32)
            elif self.use_posneg:
                u = uniform(key, self.num_data, self.device)
                frac = torch.where(self._is_pos, c.pos_bagging_fraction,
                                   c.neg_bagging_fraction)
                self._mask = (u < frac).to(torch.float32)
            else:
                u = uniform(key, self.num_data, self.device)
                self._mask = (u < c.bagging_fraction).to(torch.float32)
            self._mask_epoch = epoch
        return self._mask


class GOSSStrategy(SampleStrategy):
    """Gradient-based one-side sampling (reference: goss.hpp:19): keep the
    ``top_rate`` share of rows by |grad * hess| (for K classes by the sum
    over the classes of |grad_k * hess_k|), draw ``other_rate`` of the rest
    and amplify their gradients, every class's alike, by (1 - top_rate) /
    other_rate."""

    def is_active(self) -> bool:
        return True

    def _is_warmup(self, iteration: int) -> bool:
        # no sampling for the first 1 / learning_rate iterations
        return iteration < 1.0 / max(self.config.learning_rate, 1e-12)

    def mask_key(self, iteration: int) -> int:
        # every warmup iteration has the same all-ones mask
        return -1 if self._is_warmup(iteration) else iteration

    def fused_mode(self, iteration: int) -> str:
        # warmup iterations are unsampled
        return "none" if self._is_warmup(iteration) else "traced"

    def key_seed(self, iteration: int) -> int:
        """The seed of this iteration's draw, ``PRNGKey(seed)``'s."""
        return self.config.bagging_seed * 524287 + iteration

    def expected_fraction(self, iteration: int) -> float:
        if self._is_warmup(iteration):
            return 1.0
        c = self.config
        return min(1.0, c.top_rate + (1.0 - c.top_rate) * c.other_rate)

    def sample(self, iteration: int, grad, hess):
        if self._is_warmup(iteration):
            return SampleStrategy.sample(self, iteration, grad, hess)
        return self.sample_keyed(prng_key(self.key_seed(iteration)), grad,
                                 hess)

    def sample_keyed(self, key, grad, hess):
        """The draw under ``key`` (two Python ints, or two 0-d tensors that
        a captured iteration reads): the same ops either way."""
        c = self.config
        n = self.num_data
        mag = torch.abs(grad * hess)
        if mag.dim() == 2:
            mag = mag.sum(dim=1)
        k_top = max(1, int(c.top_rate * n))
        thresh = torch.sort(mag).values[n - k_top]
        is_top = mag >= thresh
        u = uniform(key, n, grad.device)
        keep_rest = ~is_top & (u < c.other_rate)
        amp = (1.0 - c.top_rate) / max(c.other_rate, 1e-12)
        mask = (is_top | keep_rest).to(torch.float32)
        # amp rounds to float32 before it scales, as in the reference
        scale = torch.where(keep_rest, amp, 1.0) * mask
        if grad.dim() == 2:
            scale = scale[:, None]
        return mask, grad * scale, hess * scale


def create_sample_strategy(config: Config, num_data: int, label=None,
                           device: torch.device = torch.device("cpu"),
                           query_boundaries=None) -> SampleStrategy:
    """reference: SampleStrategy::CreateSampleStrategy
    (sample_strategy.h:30); ``query_boundaries`` of the training rows for
    ``bagging_by_query``."""
    if (str(config.data_sample_strategy).strip().lower() == "goss"
            or str(config.boosting).strip().lower() == "goss"):
        return GOSSStrategy(config, num_data, label, device)
    return BaggingSampleStrategy(config, num_data, label, device,
                                 query_boundaries)
