"""Row compaction of a sampled tree: the in-bag rows first, in their order.

The port's counterpart of ``lightgbm_tpu/ops/compact.py:53-65``
(``plan_sample_rows``) and ``:96-127`` (``compact_transposed_view``);
reference analog: the ``bag_data_indices_`` prefix of src/boosting/
bagging.hpp.  One stable partition per tree gathers the rows with a
positive mask to the front of a view of ``capacity`` rows that every
histogram pass of the tree reads, so histogram passes scale with the
sampled row count.  Positions past the in-bag count hold out-of-bag rows,
whose weights the mask already set to zero: they add nothing to any sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SamplePlan(NamedTuple):
    perm: torch.Tensor    # (capacity,) int64 source row of each position
    nc: torch.Tensor      # () int64 in-bag rows (the caller keeps nc <=
                          # capacity)


def plan_sample_rows(mask: torch.Tensor, capacity: int) -> SamplePlan:
    """Stable partition: rows with ``mask > 0`` first, in their order, then
    the rest in theirs; the permutation truncated to ``capacity``."""
    in_bag = mask > 0
    key = (~in_bag).to(torch.int8)
    perm = torch.argsort(key, stable=True)
    return SamplePlan(perm=perm[:capacity], nc=in_bag.sum())


def compact_transposed_view(bins_T: torch.Tensor, perm: torch.Tensor,
                            *rows: torch.Tensor):
    """The (G, capacity) contiguous bins of the plan's rows and each (N,)
    per-row tensor of ``rows`` gathered the same way."""
    bins_h = bins_T.index_select(1, perm).contiguous()
    return (bins_h,) + tuple(r.index_select(0, perm).contiguous()
                             for r in rows)
