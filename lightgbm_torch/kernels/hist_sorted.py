"""Slot histograms over slot-sorted row blocks.  The CUDA kernels' wrappers
and their plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/hist_kernel.py:357-393``
(``build_histograms_sorted``: the ``_hist_direct`` kernel for Bmax <= 128,
``_hist_nibble`` above).  Given the row-major (N, G) bins (uint8, or the
int16 storage of 16-bit bins where a group is wider than 256 bins,
kernels/layout.py), a block
plan (ops/compact.py: the (NB*T,) int32 gather index of every block
position, the pad row N where a position is past its slot's run, and the
(NB, 3) int32 (slot, first, last) of every block) and the (N,) float32
grad, hess and count weights, it returns the (S, G, Bmax, 3) float32
(grad, hess, count) histograms of the plan's slots: grad and hess exact
fixed point at ``shift``, counts exact (ops/histogram.py), slots with no
rows zero.  The TPU's one-hot contraction, its 16-bin hi/lo split, its
bf16 hi/lo weights and its four-bins-per-int32 packing are not copied;
the packing also cuts the TPU kernel's bins to a byte, so K7 takes the
contract (any Bmax above 128) and not that packing: over 16-bit bins it
runs up to 65 536 bins.
``hist_sorted`` launches K6 (``hist_direct_cuda``) or K7
(``hist_nibble_cuda``) for tensors on a CUDA device and runs
``hist_sorted_plain`` only for tensors on the CPU; a kernel that fails to
build or launch raises.

K6 and K7 are one kernel (``csrc/hist_sorted.cu`` ``direct_kernel``): it
adds the plan's rows into shared-memory tiles of one slot x groups x bins,
in the 20-byte cells of the row-order kernels' tile pass
(``csrc/hist_tile.cuh``); ``sorted_plan`` picks its tiles, ranges of plan
blocks and threads from the plan's shapes alone, K7's apart from K6's, and
past 256 bins, where one group's cells exceed a block's shared memory, a
bin-tile axis.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.histogram import hist3_plain
from ..utils.log import LightGBMError
from . import build
from .hist_wide import (CELL_BYTES, SMEM_BLOCK, SMEM_SM, SMS, THREADS,
                        _cdiv)
from .layout import bin_bytes

# the largest Bmax K6 takes; K7 takes the rest (up to 256 over uint8 bins,
# 65 536 over 16-bit bins)
DIRECT_MAX_BINS = 128
# the most groups a K7 tile holds
NIBBLE_GROUPS = 8


class SortedPlan(NamedTuple):
    """One K6 or K7 launch, in the field order the C side reads.

    A block holds a tile of one slot x ``groups_per_tile`` groups x
    ``bins_per_tile`` bins (``smem`` bytes, 20 a cell) and walks
    ``blocks_per_range`` consecutive plan blocks, flushing the tile when
    the slot changes and at the end; ``ranges`` x ``group_tiles`` x
    ``bin_tiles`` blocks of ``threads`` threads cover every plan block,
    group and bin.  A tile holds all Bmax bins (``bin_tiles`` 1) unless one
    group's cells exceed the budget, which only 16-bit bins reach (Bmax >
    11 622): then a tile holds one group and a range of the bins, and a row
    whose bin lies outside it skips."""
    groups_per_tile: int
    group_tiles: int
    blocks_per_range: int
    ranges: int
    threads: int
    smem: int
    bins_per_tile: int
    bin_tiles: int


SORTED_PLAN_FIELDS = SortedPlan._fields


@functools.lru_cache(maxsize=1024)
def sorted_plan(NB: int, T: int, S: int, G: int, Bmax: int) -> SortedPlan:
    """The launch plan of K6 (Bmax <= 128) or K7 (above) over NB plan
    blocks of T positions, S slots, G groups and Bmax bins: 256 threads a
    block; two waves of blocks over the card, or one at a single slot (the
    root), where every block flushes into the same cells and fewer, longer
    ranges flush less (NVIDIA H100, scripts/torch_hist_bench.py: 256
    threads beat 128 and 512, and at the root two plan blocks a range beat
    one).  K7's tile holds at most NIBBLE_GROUPS groups, so that four
    blocks share an SM: at T = 1024 positions only 256 threads of a block
    have rows, and 8 groups beat tiles of 28, 16, 12 and 4 at every S."""
    return _sorted_plan(NB, T, S, G, Bmax, SMEM_BLOCK, 256,
                        1 if S == 1 else 2,
                        0 if Bmax <= DIRECT_MAX_BINS else NIBBLE_GROUPS)


def _sorted_plan(NB: int, T: int, S: int, G: int, Bmax: int,
                 smem_budget: int, threads: int, waves: int,
                 max_groups: int = 0) -> SortedPlan:
    """``sorted_plan`` with the block's shared-memory budget, its threads,
    the waves of blocks wanted and the most groups a tile (0: no limit)
    given, so that tests reach many group tiles and ranges at small shapes.

    Groups: all that fit in the budget and the limit, else an even share, a
    multiple of 4 where it fits (a row's group bins then load as whole
    words).  Bins: all of them, unless past 256 bins one group's cells
    exceed the budget; then one group a tile and an even share of the bins.
    Ranges: the fewest plan blocks a range that make ``waves`` waves of
    blocks over the card (0: one range), so that a block flushes once per
    slot run of its range and the plan's trailing pad blocks do not leave
    SMs idle."""
    per_group = Bmax * CELL_BYTES
    bin_tiles = (1 if Bmax <= 256 or per_group <= smem_budget
                 else _cdiv(Bmax, max(smem_budget // CELL_BYTES, 1)))
    bpt = _cdiv(Bmax, bin_tiles)
    cap = max(1, smem_budget // (bpt * CELL_BYTES))
    if max_groups > 0:
        cap = min(cap, max_groups)
    if bin_tiles > 1:
        cap = 1
    tiles = _cdiv(G, cap)
    gpt = _cdiv(G, tiles)
    if tiles > 1 and 4 * _cdiv(gpt, 4) <= cap:
        gpt = 4 * _cdiv(gpt, 4)
    group_tiles = _cdiv(G, gpt)
    smem = gpt * bpt * CELL_BYTES
    per_sm = max(1, min(THREADS // threads, SMEM_SM // (smem + 1024)))
    blocks = _cdiv(waves * SMS * per_sm, group_tiles * bin_tiles)
    per_range = _cdiv(max(NB, 1), blocks) if blocks else max(NB, 1)
    return SortedPlan(gpt, group_tiles, per_range,
                      _cdiv(max(NB, 1), per_range), threads, smem, bpt,
                      bin_tiles)


def plan_arg(plan: SortedPlan) -> ctypes.Array:
    """The plan as the C side's int64 array."""
    return (ctypes.c_int64 * len(SORTED_PLAN_FIELDS))(*plan)


def hist_sorted(bins, gather_idx, scalars, grad, hess, cnt, num_slots: int,
                max_bins: int, shift: int, block_rows: int) -> torch.Tensor:
    """(S, G, Bmax, 3) float32 histograms of the plan's slots."""
    if bins.device.type == "cuda":
        kernel = (hist_direct_cuda if max_bins <= DIRECT_MAX_BINS
                  else hist_nibble_cuda)
        return kernel(bins, gather_idx, scalars, grad, hess, cnt, num_slots,
                      max_bins, shift, block_rows)
    if bins.device.type == "cpu":
        return hist_sorted_plain(bins, gather_idx, scalars, grad, hess, cnt,
                                 num_slots, max_bins, shift, block_rows)
    raise LightGBMError(f"hist_sorted has no kernel for device "
                        f"{bins.device}")


def hist_sorted_plain(bins, gather_idx, scalars, grad, hess, cnt,
                      num_slots: int, max_bins: int, shift: int,
                      block_rows: int) -> torch.Tensor:
    """Plain PyTorch version: every plan position that holds a row, with its
    block's slot, through the 3-channel contract."""
    idx = gather_idx.to(torch.int64)
    slot = scalars[:, 0].repeat_interleave(block_rows)
    keep = (idx < bins.shape[0]) & (slot >= 0) & (slot < num_slots)
    rows = idx[keep]
    return hist3_plain(bins[rows].t(), slot[keep], grad[rows], hess[rows],
                       cnt[rows], num_slots, max_bins, shift)


def _launch(kernel: str, bins, gather_idx, scalars, grad, hess, cnt,
            num_slots: int, max_bins: int, shift: int,
            block_rows: int) -> torch.Tensor:
    dev = bins.device
    width = bin_bytes(bins)
    build.check_operands(kernel, dev, (
        ("bins", bins, bins.dtype), ("gather_idx", gather_idx, torch.int32),
        ("scalars", scalars, torch.int32), ("grad", grad, torch.float32),
        ("hess", hess, torch.float32), ("cnt", cnt, torch.float32)))
    n, G = bins.shape
    nb = scalars.shape[0]
    if (any(tuple(x.shape) != (n,) for x in (grad, hess, cnt))
            or tuple(scalars.shape) != (nb, 3)
            or tuple(gather_idx.shape) != (nb * block_rows,)
            or num_slots < 1 or G < 1 or block_rows < 1):
        raise LightGBMError(f"{kernel}: shapes do not agree")
    hist = torch.empty((num_slots, G, max_bins, 3), dtype=torch.float32,
                       device=dev)
    acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    fn = getattr(build.load(kernel), build.SIGNATURES[kernel][0])
    plan = sorted_plan(nb, block_rows, num_slots, G, max_bins)
    rc = fn(bins.data_ptr(), width, n, G, gather_idx.data_ptr(),
            scalars.data_ptr(),
            nb, block_rows, grad.data_ptr(), hess.data_ptr(), cnt.data_ptr(),
            num_slots, max_bins, float(2.0 ** shift), float(2.0 ** -shift),
            acc.data_ptr(), hist.data_ptr(), plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"{kernel} kernel launch failed (cudaError "
                            f"{rc}, plan {tuple(plan)})")
    return hist


def hist_direct_cuda(bins, gather_idx, scalars, grad, hess, cnt,
                     num_slots: int, max_bins: int, shift: int,
                     block_rows: int) -> torch.Tensor:
    """Launch K6 (csrc/hist_sorted.cu, Bmax <= 128) on the current stream,
    under ``sorted_plan`` of the shapes."""
    if not 0 < max_bins <= DIRECT_MAX_BINS:
        raise LightGBMError(f"hist_direct takes Bmax <= {DIRECT_MAX_BINS}, "
                            f"got {max_bins}")
    hist = _launch("hist_direct", bins, gather_idx, scalars, grad, hess, cnt,
                   num_slots, max_bins, shift, block_rows)
    build.count_launch(hist_direct_cuda, bin_bytes(bins))
    return hist


def hist_nibble_cuda(bins, gather_idx, scalars, grad, hess, cnt,
                     num_slots: int, max_bins: int, shift: int,
                     block_rows: int) -> torch.Tensor:
    """Launch K7 (csrc/hist_sorted.cu, 128 < Bmax <= 256 over uint8 bins,
    up to 65 536 over 16-bit bins) on the current stream, under
    ``sorted_plan`` of the shapes."""
    top = 256 if bin_bytes(bins) == 1 else 65536
    if not DIRECT_MAX_BINS < max_bins <= top:
        raise LightGBMError(f"hist_nibble takes {DIRECT_MAX_BINS} < Bmax <= "
                            f"{top} over {bins.dtype} bins, got {max_bins}")
    hist = _launch("hist_nibble", bins, gather_idx, scalars, grad, hess, cnt,
                   num_slots, max_bins, shift, block_rows)
    build.count_launch(hist_nibble_cuda, bin_bytes(bins))
    return hist


build.init_counts(hist_direct_cuda)
build.init_counts(hist_nibble_cuda)
