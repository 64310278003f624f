"""K-class slot histograms of rows in their natural order (batched
multiclass).  The CUDA kernel's wrapper, its plain PyTorch version, and the
launch plan that K5 (scatter_hist.py) and K8 share.

Counterpart of ``lightgbm_tpu/pallas/hist_kernel.py:305-354``
(``build_histograms_wide``, the ``_hist_wide`` kernel) and of the K-class
form of ``lightgbm_tpu/pallas/scatter_hist_kernel.py``
(``build_histograms_scatter_k``), which compute the same function.  Given
the (G, N) bins (uint8, or the int16 storage of 16-bit bins where a group
is wider than 256 bins, kernels/layout.py), each class's (K, N) int32
histogram slot of every row (negative: the row adds nothing to that
class), the (K, N) float32 grad and hess, the (N,) count weights shared by
the classes and one fixed-point shift per class, it returns the (K, S, G,
Bmax, 3) float32 (grad, hess, count) histograms: class k's grad and hess
exact fixed point at its shift, counts exact (ops/histogram.py).  The TPU
kernel's VMEM gate (``wide_hist_fits``: Bmax <= 128 and a 12 MB block) and
its per-class fallback are not copied: the kernel takes any Bmax (up to
256 for uint8 bins, 65 536 for 16-bit) and any K * S.  ``hist_wide``
launches the kernel for tensors on a CUDA device and runs
``hist_wide_plain`` only for tensors on the CPU; a kernel that fails to
build or launch raises.

The kernel (``csrc/hist_rows.cu``, which also serves K5 at K = 1) adds rows
into shared-memory tiles of one class's slots x as many groups as fit x
bins (``csrc/hist_tile.cuh``, the tile pass K2's histograms share), or,
where one pair's Bmax cells exceed a block's shared memory, of a range of
the bins; ``hist_plan`` picks that layout, and the row ranges, from the
launch's shapes and the tile's cell size alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.histogram import hist3_plain, scale_table
from ..utils.log import LightGBMError
from . import build
from .layout import bin_bytes

# the H100 (sm_90) limits a plan keeps to
SMS = 132                   # streaming multiprocessors
SMEM_BLOCK = 232448         # a block's dynamic shared memory
SMEM_SM = 233472            # an SM's shared memory, 1 KB of it per block
THREADS = 1024              # threads a block, the most an SM holds at the
                            # kernel's 64 registers
CELL_BYTES = 20             # K5/K8: five 32-bit words per (pair, group, bin)
                            # cell (K2: route_hist.CELL_BYTES, INT_CELL_BYTES)


class HistPlan(NamedTuple):
    """One launch of the tile pass (csrc/hist_tile.cuh: K5, K8 and K2's
    histograms), in the field order the C side reads.

    A block holds a tile of ``pairs_per_tile`` class-major (class, slot)
    pairs (pair = class * S + slot) x ``groups_per_tile`` groups x
    ``bins_per_tile`` bins in ``smem`` bytes of shared memory.
    ``pair_tiles`` x ``group_tiles`` x ``bin_tiles`` tiles cover every
    pair, group and bin, and each runs once per range of ``rows_per_range``
    rows (``row_ranges`` of them), in a block of ``threads`` threads.  A
    tile holds all Bmax bins (``bin_tiles`` 1) unless one pair's Bmax cells
    exceed the budget, which only 16-bit bins reach (Bmax > 11 622 at 20-
    byte cells, 14 528 at 16, 29 056 at 8): then a tile holds one pair of
    one group and a range of bins, and a row whose bin lies outside it
    skips."""
    pairs_per_tile: int
    groups_per_tile: int
    pair_tiles: int
    group_tiles: int
    row_ranges: int
    rows_per_range: int
    threads: int
    smem: int
    bins_per_tile: int
    bin_tiles: int


PLAN_FIELDS = HistPlan._fields


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def hist_plan(n: int, G: int, K: int, S: int, Bmax: int,
              cell_bytes: int = CELL_BYTES) -> HistPlan:
    """The launch plan of one tile pass over ``n`` rows, G groups, K
    classes, S slots and Bmax bins, in cells of ``cell_bytes`` bytes (K5 and
    K8: the default; K2: 16, its int form 8).

    A block's tile holds the S pairs of one class and as many groups as
    fit in a block's shared memory, so that the block reads one class's
    slots and weights once for all its groups; or, where one group's S
    pairs do not fit, an even share of them and one group.  Rows then split
    into the fewest ranges that give a full wave of blocks over the card
    and a last wave at least 85 % full, each thread at least 4 rows.
    Cached: a training run asks for the same few shapes every round."""
    return _plan(n, G, K, S, Bmax, SMEM_BLOCK, THREADS, cell_bytes)


def _plan(n: int, G: int, K: int, S: int, Bmax: int, smem_budget: int,
          threads: int, cell_bytes: int = CELL_BYTES) -> HistPlan:
    """``hist_plan`` with the block's shared memory and threads given, so
    that tests can reach plans of many tiles, bin tiles and row ranges at
    small shapes."""
    # bins tile only past 256 (16-bit bins: the 8-bit kernel has no bin
    # axis), where one pair's cells exceed the budget
    bin_tiles = (1 if Bmax <= 256
                 else _cdiv(Bmax, max(smem_budget // cell_bytes, 1)))
    bpt = _cdiv(Bmax, bin_tiles)           # an even share of the bins
    cap = max(1, smem_budget // (bpt * cell_bytes))
    if S <= cap:
        ppt, gpt = S, min(G, cap // S)
    else:
        ppt, gpt = _cdiv(S, _cdiv(S, cap)), 1
    pair_tiles, group_tiles = _cdiv(K * S, ppt), _cdiv(G, gpt)
    smem = ppt * gpt * bpt * cell_bytes
    per_sm = max(1, min(THREADS // threads, SMEM_SM // (smem + 1024)))
    wave = SMS * per_sm
    blocks = pair_tiles * group_tiles * bin_tiles
    r_max = min(_cdiv(max(n, 1), 4 * threads), 65535)
    ranges, best = 1, 0.0
    for r in range(1, r_max + 1):
        fill = r * blocks / (_cdiv(r * blocks, wave) * wave)
        if r * blocks >= wave and fill >= 0.85:
            ranges = r
            break
        if fill > best + 1e-9:
            ranges, best = r, fill
    rows_per_range = 4 * _cdiv(_cdiv(max(n, 1), ranges), 4)
    return HistPlan(ppt, gpt, pair_tiles, group_tiles,
                    _cdiv(max(n, 1), rows_per_range), rows_per_range,
                    threads, smem, bpt, bin_tiles)


def plan_arg(plan: HistPlan) -> ctypes.Array:
    """The plan as the C side's int64 array."""
    return (ctypes.c_int64 * len(PLAN_FIELDS))(*plan)


def hist_wide(bins_T, slot, grad, hess, cnt, num_slots: int, max_bins: int,
              shifts, scales=None) -> torch.Tensor:
    """(K, S, G, Bmax, 3) float32 histograms of each class's slots;
    ``scales`` is the (2, K) device table of ``shifts``
    (ops/histogram.scale_table), or None to build it here."""
    if bins_T.device.type == "cuda":
        return hist_wide_cuda(bins_T, slot, grad, hess, cnt, num_slots,
                              max_bins, shifts, scales)
    if bins_T.device.type == "cpu":
        return hist_wide_plain(bins_T, slot, grad, hess, cnt, num_slots,
                               max_bins, shifts, scales)
    raise LightGBMError(f"hist_wide has no kernel for device "
                        f"{bins_T.device}")


def hist_wide_plain(bins_T, slot, grad, hess, cnt, num_slots: int,
                    max_bins: int, shifts, scales=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: ``hist3_plain`` once
    per class (``scales`` is the kernel's copy of ``shifts`` and is not
    read)."""
    return torch.stack([hist3_plain(bins_T, slot[k], grad[k], hess[k], cnt,
                                    num_slots, max_bins, shifts[k])
                        for k in range(slot.shape[0])])


def hist_wide_cuda(bins_T, slot, grad, hess, cnt, num_slots: int,
                   max_bins: int, shifts, scales=None) -> torch.Tensor:
    """Launch csrc/hist_rows.cu (``lgbt_hist_wide``) on the current stream,
    under ``hist_plan`` of the shapes."""
    dev = bins_T.device
    if scales is None:
        scales = scale_table(shifts, dev)
    width = bin_bytes(bins_T)
    build.check_operands("hist_wide", dev, (
        ("bins_T", bins_T, bins_T.dtype), ("slot", slot, torch.int32),
        ("grad", grad, torch.float32), ("hess", hess, torch.float32),
        ("cnt", cnt, torch.float32), ("scales", scales, torch.float32)))
    G, n = bins_T.shape
    K = slot.shape[0] if slot.dim() == 2 else 0
    if (K < 1 or any(tuple(x.shape) != (K, n) for x in (slot, grad, hess))
            or tuple(cnt.shape) != (n,) or len(shifts) != K
            or tuple(scales.shape) != (2, K)
            or num_slots < 1 or not 0 < max_bins <= 256 ** width or G < 1):
        raise LightGBMError("hist_wide: shapes do not agree")
    plan = hist_plan(n, G, K, num_slots, max_bins)
    hist = torch.empty((K, num_slots, G, max_bins, 3), dtype=torch.float32,
                       device=dev)
    acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    fn = build.load("hist_wide").lgbt_hist_wide
    rc = fn(bins_T.data_ptr(), width, n, G, K, slot.data_ptr(),
            grad.data_ptr(), hess.data_ptr(), cnt.data_ptr(), num_slots,
            max_bins, scales.data_ptr(), acc.data_ptr(), hist.data_ptr(),
            plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"hist_wide kernel launch failed "
                            f"(cudaError {rc}, plan {tuple(plan)})")
    build.count_launch(hist_wide_cuda, width)
    return hist


build.init_counts(hist_wide_cuda)
