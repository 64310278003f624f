"""Route replay: every row's leaf after a tree's growth rounds, in one pass.
The CUDA kernel's wrapper, its launch plan, the record packing it reads,
and its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/stream_kernel.py:636-711``
(``route_replay``).  A sampled tree grows on the compacted in-bag rows
(ops/compact.py); the rows outside the view still need their leaf for the
score update.  Instead of one route-only K2 pass over all N rows per
round, the grower keeps each round's (L, 16) int32 route records
(kernels/layout.py) and this kernel applies rounds 0..R-1 in order to every
row, starting from leaf 0, with the numeric decision of K2's route step
(EFB unbundling, NaN and zero-as-missing default directions, the
threshold).  A child outside [0, L) stops the row at -1.  The grower sends
no categorical tree here, as in the reference.  The result equals the chain
of route-only K2 passes row for row.  ``route_replay`` launches the kernel
for tensors on a CUDA device and runs ``route_replay_plain`` only for
tensors on the CPU; a kernel that fails to build or launch raises.

The kernel (``csrc/route_replay.cu``) first packs each record into the 8
bytes the decision reads (``pack_records``; a record that does not fit is
special and is read whole from global memory), then runs persistent blocks
over tiles of rows (``replay_plan``), the packed table in shared memory,
each thread loading its rows' records and bins together.  Over 16-bit bins
(groups wider than 256 bins; kernels/layout.py) a record whose threshold or
missing bin does not fit its 9-bit field is special too, and the kernel
compares a row's bin past 255 as 256.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.log import LightGBMError
from . import build
from .hist_wide import SMEM_BLOCK, SMEM_SM, SMS, _cdiv
from .layout import (R_BUNDLED, R_CHOSEN, R_DEFLEFT, R_GROUP, R_MZBIN,
                     R_NANBIN, R_NEWID, R_THR, ROUTE_FIELDS, bin_bytes)
from .route_hist import numeric_go_left

# the packed record's second word (csrc/route_replay.cu): bits 0-8 the
# threshold bin plus one, clamped to [0, 256] (a bin goes left when below
# it), then the NaN and zero-as-missing bins (0x1ff: none) and three flags
PACK_BITS = {"nan_shift": 9, "mz_shift": 18, "default_left_bit": 27,
             "chosen_bit": 28, "special_bit": 31}
BIN_NONE = 0x1ff
ROWS_PER_THREAD = 4                # rows a thread routes in one tile
MAX_THREADS = 512                  # threads a block at most
SM_THREADS = 2048                  # threads an SM holds
TAB_STAGE_MAX = 64 * 1024          # the largest packed table a block stages


class ReplayPlan(NamedTuple):
    """One K3 launch, in the field order the C side reads.

    ``blocks`` persistent blocks of ``threads`` threads take the
    ``tiles`` tiles of ``rows_per_tile`` rows in turn (block b tiles b,
    b + blocks, ...).  ``tab_bytes`` > 0: the packed table is staged in
    that many bytes of shared memory."""
    rows_per_tile: int
    threads: int
    tiles: int
    blocks: int
    tab_bytes: int


REPLAY_PLAN_FIELDS = ReplayPlan._fields


def _round16(x: int) -> int:
    return -(-x // 16) * 16


@functools.lru_cache(maxsize=256)
def replay_plan(n: int, G: int, R: int, L: int) -> ReplayPlan:
    """The launch plan of one K3 launch over ``n`` rows of G groups and R
    rounds of L leaves: 256 threads, up to 4 rows a thread in a tile (NVIDIA
    H100, scripts/torch_hist_bench.py: 4 rows a thread beat 2 and 3, and
    128 or 512 threads did no better)."""
    return _replay_plan(n, G, R, L, SMEM_BLOCK, 256, ROWS_PER_THREAD)


def _replay_plan(n: int, G: int, R: int, L: int, smem_budget: int,
                 threads: int, rows_per_thread: int,
                 stage_tab: bool = True) -> ReplayPlan:
    """``replay_plan`` with the block's shared memory, its threads and rows
    a thread given, and the table's staging allowed or not, so that tests
    and the bench reach every path.

    Table: staged where it takes at most TAB_STAGE_MAX and half the budget;
    R = 0 reads nothing.  Tiles: at most ``threads * rows_per_thread``
    rows, a multiple of 16, the fewest that fill whole waves of blocks; at
    most one wave of blocks, each taking its tiles in turn.  G does not
    enter: every row reads its bins from global memory."""
    cap = threads * rows_per_thread
    tab = _round16(8 * R * (L + 1))
    if not (R > 0 and stage_tab and tab <= min(TAB_STAGE_MAX,
                                                 smem_budget // 2)):
        tab = 0
    per_sm = max(1, min(SM_THREADS // threads, SMEM_SM // (tab + 1024)))
    wave = SMS * per_sm
    tiles = _cdiv(max(n, 1), cap)
    tiles = max(tiles, min(wave, _cdiv(max(n, 1), 16)))
    if tiles > wave:
        tiles = wave * _cdiv(tiles, wave)
    rows_per_tile = min(cap, _round16(_cdiv(max(n, 1), tiles)))
    tiles = _cdiv(max(n, 1), rows_per_tile)
    return ReplayPlan(rows_per_tile, threads, tiles, min(tiles, wave), tab)


def plan_arg(plan: ReplayPlan) -> ctypes.Array:
    """The plan as the C side's int64 array."""
    return (ctypes.c_int64 * len(REPLAY_PLAN_FIELDS))(*plan)


def pack_records(tabs: torch.Tensor, G: int,
                 wide: bool = False) -> torch.Tensor:
    """(R, L + 1, 2) int32 packed records of the (R, L, 16) int32 route
    records, as csrc/route_replay.cu's pack kernel writes them: a leaf not
    split that round packs to (0, 0), and so does leaf L, the stop leaf a
    row takes when its child lies outside [0, L); a split leaf to (new id |
    group << 16, the threshold bin plus one clamped to [0, 256] | NaN bin
    << 9 | zero bin << 18 | default-left << 27 | 1 << 28), missing bins
    outside [0, 255] as 0x1ff (none); a record that does not fit (an EFB
    bundle, a child outside [0, min(L, 2**16)), a group outside [0,
    min(G, 2**16)); with ``wide``, 16-bit bins, also a threshold or a NaN
    or zero bin past 255) to (0, 1 << 28 | 1 << 31), special: the kernel
    reads it whole."""
    t = tabs.to(torch.int64)
    R, L = t.shape[0], t.shape[1]
    chosen = t[..., R_CHOSEN] > 0
    new_id, group, thr = t[..., R_NEWID], t[..., R_GROUP], t[..., R_THR]
    special = ((t[..., R_BUNDLED] > 0) | (new_id < 0)
               | (new_id >= min(L, 0x10000)) | (group < 0)
               | (group >= min(G, 0x10000)))
    if wide:
        special = (special | (thr > 255) | (t[..., R_NANBIN] > 255)
                   | (t[..., R_MZBIN] > 255))

    def code(b):
        return torch.where((b >= 0) & (b <= 255), b, BIN_NONE)

    p = PACK_BITS
    chosen_bit = 1 << p["chosen_bit"]
    w1 = (torch.clamp(thr + 1, 0, 256) | code(t[..., R_NANBIN])
          << p["nan_shift"] | code(t[..., R_MZBIN]) << p["mz_shift"]
          | (t[..., R_DEFLEFT] > 0).to(torch.int64) << p["default_left_bit"]
          | chosen_bit)
    w1 = torch.where(special, chosen_bit | 1 << p["special_bit"], w1)
    w0 = torch.where(special, 0, new_id | group << 16)
    out = torch.zeros((R, L + 1, 2), dtype=torch.int64, device=tabs.device)
    out[:, :L, 0] = torch.where(chosen, w0, 0)
    out[:, :L, 1] = torch.where(chosen, w1, 0)
    # the low 32 bits as int32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def route_replay(bins_T: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """(N,) int32 leaf of every row after the (R, L, 16) int32 route
    records ``tabs``, applied in order from leaf 0; bins_T: (G, N) uint8
    or the int16 storage of 16-bit bins."""
    if bins_T.device.type == "cuda":
        return route_replay_cuda(bins_T, tabs)
    if bins_T.device.type == "cpu":
        return route_replay_plain(bins_T, tabs)
    raise LightGBMError(f"route_replay has no kernel for device "
                        f"{bins_T.device}")


def route_replay_plain(bins_T: torch.Tensor,
                       tabs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: K2's numeric route step, round by round; a
    child outside [0, L) stops the row at -1."""
    n = bins_T.shape[1]
    L = tabs.shape[1]
    rows = torch.arange(n, device=bins_T.device)
    lid = torch.zeros(n, dtype=torch.int32, device=bins_T.device)
    for r in range(tabs.shape[0]):
        rec = tabs[r][lid.clamp(min=0).to(torch.int64)]
        go_left, _ = numeric_go_left(bins_T, rows, rec)
        nxt = torch.where((rec[:, R_CHOSEN] > 0) & ~go_left, rec[:, R_NEWID],
                          lid)
        nxt = torch.where((nxt >= 0) & (nxt < L), nxt, -1)
        lid = torch.where(lid >= 0, nxt, lid)
    return lid


def route_replay_cuda(bins_T: torch.Tensor,
                      tabs: torch.Tensor) -> torch.Tensor:
    """Launch csrc/route_replay.cu on the current stream, under
    ``replay_plan`` of the shapes."""
    dev = bins_T.device
    width = bin_bytes(bins_T)
    build.check_operands("route_replay", dev, (
        ("bins_T", bins_T, bins_T.dtype), ("tabs", tabs, torch.int32)))
    if (bins_T.dim() != 2 or tabs.dim() != 3
            or tabs.shape[2] != len(ROUTE_FIELDS) or bins_T.shape[0] < 1
            or (tabs.shape[0] > 0 and tabs.shape[1] < 1)):
        raise LightGBMError("route_replay: shapes do not agree")
    G, n = bins_T.shape
    R, L = tabs.shape[0], tabs.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    packed = torch.empty((max(R * (L + 1), 1), 2), dtype=torch.int32,
                         device=dev)
    plan = replay_plan(n, G, R, L)
    fn = build.load("route_replay").lgbt_route_replay
    rc = fn(bins_T.data_ptr(), width, n, G, tabs.data_ptr(), R, L,
            packed.data_ptr(), out.data_ptr(), plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"route_replay kernel launch failed "
                            f"(cudaError {rc}, plan {tuple(plan)})")
    build.count_launch(route_replay_cuda, width)
    return out


build.init_counts(route_replay_cuda)
