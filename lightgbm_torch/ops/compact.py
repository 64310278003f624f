"""Row compaction of a sampled tree, and the slot-sorted block plan of a
histogram round.

The port's counterpart of ``lightgbm_tpu/ops/compact.py``.

- ``plan_sample_rows`` (:53-65), ``compact_transposed_view`` (:96-127) and
  ``compact_row_views`` (:79-93); reference analog: the
  ``bag_data_indices_`` prefix of src/boosting/bagging.hpp.  One stable
  partition per tree gathers the rows with a positive mask to the front of
  a view of ``capacity`` rows that every histogram pass of the tree reads,
  so histogram passes scale with the sampled row count.  Positions past the
  in-bag count hold out-of-bag rows, whose weights the mask already set to
  zero: they add nothing to any sum.
- ``BlockPlan``, ``plan_blocks`` and ``plan_single_slot`` (:130-203);
  reference analog: src/treelearner/data_partition.hpp, which keeps the
  rows of one leaf contiguous.  Rows are sorted by histogram slot and each
  slot's run is cut into blocks of T rows, so every block belongs to one
  slot; a position past its run points at the pad row ``n``.  The plan
  equals the JAX package's element for element, so the sorted histogram
  kernels (kernels/hist_sorted.py) read the same blocks.
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


def check_compact_supported(hist_backend: str) -> None:
    """Compaction serves the backends that read rows in their natural order
    (reference: ops/compact.py:68-76; the port is single-device)."""
    if hist_backend == "pallas":
        raise ValueError("row compaction supports the stream/segsum/onehot/"
                         "scatter histogram backends only")


def compact_row_views(bins_T: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, cnt: torch.Tensor, capacity: int):
    """The compacted natural-order views the ``scatter`` backend reads:
    (bins_c (G, capacity), grad_c, hess_c, cnt_c, perm); grad and hess are
    (N,) or (K, N), gathered on their last axis (reference:
    lightgbm_tpu/ops/grow.py:1878-1890); the caller gathers each round's
    slots through ``perm``."""
    perm = plan_sample_rows(cnt, capacity).perm
    return compact_transposed_view(bins_T, perm, grad, hess, cnt) + (perm,)


def compact_transposed_view(bins_T: torch.Tensor, perm: torch.Tensor,
                            *rows: torch.Tensor):
    """The (G, capacity) contiguous bins of the plan's rows and each
    per-row tensor of ``rows``, (N,) or (K, N), gathered the same way on its
    last axis: one partition serves every class (reference:
    lightgbm_tpu/ops/grow.py:1805-1813)."""
    bins_h = bins_T.index_select(1, perm).contiguous()
    return (bins_h,) + tuple(r.index_select(r.dim() - 1, perm).contiguous()
                             for r in rows)


class BlockPlan(NamedTuple):
    gather_idx: torch.Tensor  # (NB*T,) int32 source row per position; n = pad
    scalars: torch.Tensor     # (NB, 3) int32 (slot | -1, is_first, is_last)
    counts: torch.Tensor      # (S,) int32 rows per slot


def num_blocks(n: int, num_slots: int, block_rows: int) -> int:
    """Worst-case block count: every slot may add one partial block."""
    return -(-n // block_rows) + num_slots


def plan_blocks(slot: torch.Tensor, num_slots: int,
                block_rows: int) -> BlockPlan:
    """The slot-sorted block plan of one histogram round.  slot: (N,) int32,
    negative = the row is not needed.  Trailing pad blocks keep the last
    real block's slot with first = last = 0, and gather only the pad row."""
    dev = slot.device
    n = slot.shape[0]
    T, S = block_rows, num_slots
    NB = num_blocks(n, S, T)
    i32, i64 = torch.int32, torch.int64
    key = torch.where(slot >= 0, slot, S).to(i32)
    sorted_key, perm = torch.sort(key, stable=True)
    run_start = torch.searchsorted(
        sorted_key, torch.arange(S + 1, dtype=i32, device=dev)).to(i64)
    counts = run_start[1:] - run_start[:-1]
    blocks_per_slot = -(-counts // T)
    blk_off = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                         torch.cumsum(blocks_per_slot, 0)])
    total_blocks = blk_off[S]
    b = torch.arange(NB, dtype=i64, device=dev)
    s_of_b = torch.searchsorted(blk_off, b, right=True) - 1
    s_of_b = torch.clamp(s_of_b, 0, S - 1)
    local = b - blk_off[s_of_b]
    pos = run_start[s_of_b] + local * T
    real = b < total_blocks
    first = real & (local == 0)
    last = real & (local == blocks_per_slot[s_of_b] - 1)
    last_slot = torch.where(blocks_per_slot > 0,
                            torch.arange(S, dtype=i64, device=dev), 0).max()
    scalars = torch.stack([torch.where(real, s_of_b, last_slot),
                           first.to(i64), last.to(i64)], dim=1).to(i32)
    gpos = pos[:, None] + torch.arange(T, dtype=i64, device=dev)[None, :]
    in_run = real[:, None] & (gpos < run_start[s_of_b + 1][:, None])
    src = perm[torch.clamp(gpos, 0, n - 1)]
    gather_idx = torch.where(in_run, src, n).reshape(-1).to(i32)
    return BlockPlan(gather_idx=gather_idx, scalars=scalars,
                     counts=counts.to(i32))


def plan_single_slot(n: int, block_rows: int,
                     device: torch.device = torch.device("cpu")) -> BlockPlan:
    """The root's plan: every row in slot 0, in its order; no sort."""
    T = block_rows
    NB = num_blocks(n, 1, T)
    i32 = torch.int32
    b = torch.arange(NB, dtype=i32, device=device)
    nb_real = -(-n // T)
    real = b < nb_real
    scalars = torch.stack([torch.where(real, 0, -1).to(i32),
                           (b == 0).to(i32), (b == nb_real - 1).to(i32)],
                          dim=1)
    gpos = (b[:, None].to(torch.int64) * T
            + torch.arange(T, dtype=torch.int64, device=device)[None, :]
            ).reshape(-1)
    gather_idx = torch.where(gpos < n, gpos, n).to(i32)
    return BlockPlan(gather_idx=gather_idx, scalars=scalars,
                     counts=torch.full((1,), n, dtype=i32, device=device))
