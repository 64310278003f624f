"""SciPy CSR rows to group bins on the card: the CUDA kernel's wrapper, its
plain PyTorch version and the chunked upload that feeds it.

No ``pallas_call`` site: the counterpart of the JAX package's host
``construct_binned_sparse`` (``lightgbm_tpu/binning.py:988``), which fills
a sparse Dataset's bins in O(nnz) in NumPy; the port keeps a copy of it as
the host oracle (``binning.construct_binned_sparse``).  The kernel reads
the tables of ``bin_rows.bin_tables`` and a (G,) table of each group's bin
of an implicit 0.0 (``zero_bins``).  Its Dataset form writes the (n, G)
bins of ``construct_binned_sparse`` byte for byte; its predict form
(``transpose`` and the tables' ``sentinel`` features) writes the (G, n)
bins that ``bin_rows`` writes of the densified rows, which K1 reads.

``bin_csr`` launches the kernel (``csrc/bin_csr.cu``) for tensors on a
CUDA device and runs ``bin_csr_plain`` only for tensors on the CPU; a
kernel that fails to build or launch raises.  The kernel's tiles are rows
cut by entries (``bin_csr_plan``, a pure function of the row pointers).
``bin_csr_matrix`` uploads a SciPy matrix in chunks of rows whose values
and column indices hold at most ``bin_rows.CHUNK_BYTES``, cuts each
chunk's tiles from the row pointers it holds on the host, and bins each
chunk into one output tensor.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import build
from .bin_rows import (BUNDLED, CHUNK_BYTES, F_COLUMN, F_DEFAULT_BIN,
                       F_FLAGS, F_IN_GROUP, F_POSITION, FEAT_FIELDS,
                       BinTables, _align16, _feature_bins, _wait,
                       storage_dtype)
from .hist_wide import SMEM_BLOCK, SMEM_SM, SMS

# bytes a stored entry takes on the card: an int32 column and a float64
ENTRY_BYTES = 12
THREADS = 256
# persistent blocks an SM; a block's keys and row offsets share an SM's
# shared memory with as many others (less the KB each block reserves)
BLOCKS_PER_SM = 6
# most entries a tile before the blocks take more than one round of tiles
TILE_ENTRIES = 2048
# where fewer rows than this fit a block over every group (the wide form):
# tiles of WIDE_ROWS rows, each over group ranges that fit
WIDE_ROWS = 16
# the kernel's 64-bit key, low to high: the bin in the group, the entry's
# index in its tile, its feature's position in the group + 1
KEY_BIN_BITS = 16
KEY_INDEX_BITS = 25
KEY_POSITION_BITS = 64 - KEY_BIN_BITS - KEY_INDEX_BITS


class CsrPlan(NamedTuple):
    """One launch, in the field order the C side reads: ``blocks``
    persistent blocks of ``threads`` threads loop over the ``tiles`` x
    ``ranges`` (row tile, group range) pairs (pair i in block i %
    blocks; row tile i // ranges, range i % ranges), a row tile of at most
    ``max_rows`` rows, a group range of ``range_groups`` groups (one range
    of every group but in the wide form); ``smem`` bytes of keys and row
    offsets a block."""
    tiles: int
    ranges: int
    range_groups: int
    max_rows: int
    blocks: int
    threads: int
    smem: int


CSR_PLAN_FIELDS = CsrPlan._fields


def _smem(rows: int, groups: int) -> int:
    """A block's bytes: a 64-bit key a (row, group) cell, rows an odd
    number of keys apart, then the tile's row offsets (int32)."""
    return _align16(8 * rows * (groups | 1)) + _align16(4 * (rows + 1))


def bin_csr_plan(indptr: np.ndarray, G: int,
                 sm_count: int = SMS) -> Tuple[CsrPlan, np.ndarray]:
    """The launch plan over the CSR rows of ``indptr`` (n + 1 row pointers)
    binned into G groups on a card of ``sm_count`` SMs, and the (tiles +
    1,) int32 first rows of its tiles.  A block's keys and offsets fit
    ``SMEM_SM // BLOCKS_PER_SM - 1024`` bytes: a tile over every group of
    at most as many rows as fit there, or, where fewer than WIDE_ROWS do
    (the wide form), of WIDE_ROWS rows over even group ranges that fit.
    The entries go to BLOCKS_PER_SM * sm_count blocks in whole rounds of
    at most TILE_ENTRIES a tile: the chunk's entries cut evenly, each cut
    moved to the first row that starts at or after it, then tiles of more
    rows than fit cut again."""
    indptr = np.asarray(indptr, np.int64)
    n = len(indptr) - 1
    budget = min(SMEM_BLOCK, SMEM_SM // BLOCKS_PER_SM - 1024)
    cap = budget // (8 * (G | 1) + 4)
    while cap > 0 and _smem(cap, G) > budget:
        cap -= 1
    if cap >= WIDE_ROWS:
        ranges, range_groups = 1, G
    else:
        cap = WIDE_ROWS
        fit = (budget - _align16(4 * (cap + 1))) // (8 * cap) - 1
        range_groups = -(-G // -(-G // fit))
        ranges = -(-G // range_groups)
    slots = BLOCKS_PER_SM * sm_count
    nnz = int(indptr[-1] - indptr[0]) if n > 0 else 0
    parts = slots * max(1, -(-nnz // (slots * TILE_ENTRIES)))
    targets = indptr[0] + np.arange(1, parts, dtype=np.int64) * nnz // parts
    cuts = np.unique(np.concatenate([
        [0], np.searchsorted(indptr, targets, side="left"), [max(n, 0)]]))
    pieces = -(-np.diff(cuts) // cap)
    step = np.arange(int(pieces.sum())) - np.repeat(
        np.cumsum(pieces) - pieces, pieces)
    starts = np.append(np.repeat(cuts[:-1], pieces) + cap * step,
                       max(n, 0)).astype(np.int32)
    tiles = len(starts) - 1
    max_rows = int(np.diff(starts).max()) if tiles else 0
    plan = CsrPlan(tiles, ranges, range_groups, max_rows,
                   min(slots, tiles * ranges), THREADS,
                   _smem(max_rows, range_groups))
    return plan, starts


def launch_plan(indptr: np.ndarray, tables: BinTables,
                device: torch.device) -> Tuple[CsrPlan, torch.Tensor]:
    """The plan ``bin_csr_cuda`` launches these rows (host row pointers
    from 0) under, with its tile starts on ``device``.  Raises where a
    tile's entries reach the key's entry index (2**KEY_INDEX_BITS):
    ``chunk_rows`` keeps a chunk below that unless one row holds more, and
    where a bundle's feature position passes the key's position field."""
    indptr = np.asarray(indptr, np.int64)
    plan, starts = bin_csr_plan(indptr, tables.num_groups, SMS)
    most = int(np.diff(indptr[starts]).max()) if plan.tiles else 0
    if most >= 1 << KEY_INDEX_BITS:
        raise LightGBMError(
            f"bin_csr: a tile of {most} entries reaches the kernel's "
            f"2**{KEY_INDEX_BITS} entry index; chunk_rows keeps a chunk "
            f"below it unless a single row holds that many")
    if len(tables.host_feats) and int(
            tables.host_feats[:, F_POSITION].max()) + 1 >= \
            1 << KEY_POSITION_BITS:
        raise LightGBMError("bin_csr: a group of more features than the "
                            "kernel's key can order")
    return plan, torch.from_numpy(starts).to(device)

def zero_bins(tables: BinTables) -> np.ndarray:
    """(G,) int32: each group's bin of an implicit 0.0, where every cell
    starts.  A feature alone in its group: its bin of 0.0 (the predict
    form's sentinel rule too); a bundle: its shared default bin 0."""
    host = tables._replace(bounds=tables.bounds.cpu(), cats=tables.cats.cpu(),
                           cat_bins=tables.cat_bins.cpu())
    zero = torch.zeros(1, dtype=torch.float64)
    out = np.zeros(tables.num_groups, np.int32)
    for g in range(tables.num_groups):
        recs = tables.host_feats[tables.host_group_start[g]:
                                 tables.host_group_start[g + 1]]
        if len(recs) == 1 and not int(recs[0][F_FLAGS]) & BUNDLED:
            out[g] = int(_feature_bins(zero, host, recs[0])[0])
    return out


def bin_csr(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
            tables: BinTables, zeros: torch.Tensor, out: torch.Tensor,
            row0: int = 0, transpose: bool = False,
            plan: Optional[Tuple[CsrPlan, torch.Tensor]] = None
            ) -> torch.Tensor:
    """Bin the CSR rows (``indptr`` int64 (n + 1,) from 0, ``indices``
    int32 and ``data`` float64 of ``indptr[n]`` entries) into rows [row0,
    row0 + n) of ``out``: (N, G), or (G, N) with ``transpose``, of the
    tables' storage dtype; ``zeros`` is ``zero_bins`` as an int32 tensor;
    ``plan`` the kernel's ``launch_plan`` of these rows, if the caller
    has it.  Returns ``out``."""
    if indices.device.type == "cuda":
        return bin_csr_cuda(indptr, indices, data, tables, zeros, out, row0,
                            transpose, plan)
    if indices.device.type == "cpu":
        return bin_csr_plain(indptr, indices, data, tables, zeros, out, row0,
                             transpose)
    raise LightGBMError(f"bin_csr has no kernel for device {indices.device}")


def _last_per_row(rows: torch.Tensor) -> torch.Tensor:
    """Of entries whose rows do not decrease, those that are the last of
    their row."""
    keep = torch.ones_like(rows, dtype=torch.bool)
    keep[:-1] = rows[1:] != rows[:-1]
    return keep


def bin_csr_plain(indptr: torch.Tensor, indices: torch.Tensor,
                  data: torch.Tensor, tables: BinTables, zeros: torch.Tensor,
                  out: torch.Tensor, row0: int = 0,
                  transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract, the host
    ``construct_binned_sparse`` column by column: each group's cells start
    at its zero bin; a lone feature's last stored entry of a row, then a
    bundle's features in the group's order, each its last non-default
    entry of a row, overwrite them."""
    _check_shapes("bin_csr_plain", indptr, indices, data, tables, zeros, out,
                  row0, transpose)
    n = indptr.shape[0] - 1
    dev = indices.device
    counts = indptr[1:] - indptr[:-1]
    row_of = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    idx = indices.to(torch.int64)
    # the entries column by column, each column's in stored order (so its
    # rows do not decrease)
    order = torch.argsort(idx, stable=True)
    starts = torch.searchsorted(
        idx[order], torch.arange(tables.num_features + 1, device=dev)).tolist()
    zl = zeros.tolist()
    for g in range(tables.num_groups):
        recs = tables.host_feats[tables.host_group_start[g]:
                                 tables.host_group_start[g + 1]]
        col = torch.full((n,), zl[g], dtype=torch.int64, device=dev)
        for rec in recs:
            c = int(rec[F_COLUMN])
            sel = order[starts[c]:starts[c + 1]]
            b = _feature_bins(data[sel], tables, rec)
            rows = row_of[sel]
            if int(rec[F_FLAGS]) & BUNDLED:
                d = int(rec[F_DEFAULT_BIN])
                nd = b != d
                rows, b = rows[nd], b[nd]
                b = int(rec[F_IN_GROUP]) + torch.where(b > d, b - 1, b)
            last = _last_per_row(rows)
            col[rows[last]] = b[last]
        # 16-bit bins as their int16 bytes
        col = torch.where(col >= 2 ** 15, col - 2 ** 16, col).to(out.dtype)
        if transpose:
            out[g, row0:row0 + n] = col
        else:
            out[row0:row0 + n, g] = col
    return out


def _check_shapes(name, indptr, indices, data, tables, zeros, out, row0,
                  transpose):
    n = indptr.shape[0] - 1
    n_out = out.shape[1] if transpose else out.shape[0]
    G = out.shape[0] if transpose else out.shape[1]
    if (indptr.dim() != 1 or n < 0 or indices.dim() != 1
            or data.shape != indices.shape or out.dim() != 2
            or G != tables.num_groups or zeros.shape != (G,) or row0 < 0
            or row0 + n > n_out
            or out.dtype != storage_dtype(tables.out_bytes)):
        raise LightGBMError(f"{name}: shapes do not agree (indptr "
                            f"{tuple(indptr.shape)}, {indices.shape[0]} "
                            f"entries, out {tuple(out.shape)} {out.dtype}, "
                            f"{tables.num_groups} groups)")


def bin_csr_cuda(indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, tables: BinTables, zeros: torch.Tensor,
                 out: torch.Tensor, row0: int = 0, transpose: bool = False,
                 plan: Optional[Tuple[CsrPlan, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Launch csrc/bin_csr.cu on the current stream under ``plan`` (a
    ``launch_plan`` of these rows; cut here from the row pointers, read
    back from the card, where None)."""
    dev = indices.device
    build.check_operands("bin_csr", dev, (
        ("indptr", indptr, torch.int64), ("indices", indices, torch.int32),
        ("data", data, torch.float64), ("feats", tables.feats, torch.int32),
        ("col_entry", tables.col_entry, torch.int32),
        ("bounds", tables.bounds, torch.float64),
        ("cats", tables.cats, torch.int64),
        ("cat_bins", tables.cat_bins, torch.int32),
        ("zero_bins", zeros, torch.int32),
        ("records", tables.csr_records, torch.int32),
        ("out", out, storage_dtype(tables.out_bytes))))
    _check_shapes("bin_csr", indptr, indices, data, tables, zeros, out, row0,
                  transpose)
    n = indptr.shape[0] - 1
    if plan is None:
        plan = launch_plan(indptr.cpu().numpy(), tables, dev)
    plan, starts = plan
    if starts.device != dev or starts.dtype != torch.int32 or \
            starts.shape != (plan.tiles + 1,) or not starts.is_contiguous():
        raise LightGBMError(f"bin_csr: the plan's tile starts "
                            f"({starts.dtype}, {tuple(starts.shape)} on "
                            f"{starts.device}) do not fit {plan}")
    fn = getattr(build.load("bin_csr"), build.SIGNATURES["bin_csr"][0])
    rc = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), n,
            tables.num_features, tables.feats.data_ptr(),
            tables.feats.numel() // len(FEAT_FIELDS), tables.num_groups,
            tables.col_entry.data_ptr(), tables.bounds.data_ptr(),
            tables.bounds.numel(), tables.cats.data_ptr(),
            tables.cat_bins.data_ptr(), tables.cats.numel(),
            zeros.data_ptr(), tables.csr_records.data_ptr(), out.data_ptr(),
            tables.out_bytes, out.shape[1] if transpose else out.shape[0],
            row0, int(transpose), starts.data_ptr(),
            (ctypes.c_int64 * len(CSR_PLAN_FIELDS))(*plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"bin_csr kernel launch failed (cudaError {rc}, "
                            f"plan {tuple(plan)})")
    build.count_launch(bin_csr_cuda, tables.out_bytes)
    return out


build.init_counts(bin_csr_cuda)


def chunk_rows(indptr: np.ndarray, chunk_bytes: int = CHUNK_BYTES):
    """[(r0, r1)] row ranges whose stored entries take at most
    ``chunk_bytes`` on the card (a row with more takes a chunk of its
    own)."""
    n = len(indptr) - 1
    per = max(1, chunk_bytes // ENTRY_BYTES)
    out, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + per, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        out.append((r0, r1))
        r0 = r1
    return out


def bin_csr_matrix(X, tables: BinTables, transpose: bool = False,
                   times: Optional[Dict[str, float]] = None,
                   chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The bins of a SciPy CSR matrix on the tables' device: (N, G), or
    (G, N) with ``transpose``.  The rows go up in chunks (``chunk_rows``),
    each with its tiles (``launch_plan``) and binned by ``bin_csr`` as it
    arrives; ``data`` is read as float64
    whatever its type.  A dict passed as ``times`` receives the seconds of
    the uploads (``upload``) and of the binning (``binning``), each stage
    then waited for."""
    n, F = X.shape
    if F != tables.num_features:
        raise LightGBMError(f"bin_csr_matrix: {F} columns for "
                            f"{tables.num_features} features")
    dev = tables.feats.device
    out = torch.empty((tables.num_groups, n) if transpose
                      else (n, tables.num_groups),
                      dtype=storage_dtype(tables.out_bytes), device=dev)
    zeros = torch.from_numpy(zero_bins(tables)).to(dev)
    indptr = np.asarray(X.indptr, np.int64)
    spent = {"upload": 0.0, "binning": 0.0}
    for r0, r1 in chunk_rows(indptr, chunk_bytes):
        t0 = time.perf_counter()
        lo, hi = int(indptr[r0]), int(indptr[r1])
        host_ptr = indptr[r0:r1 + 1] - lo
        plan = launch_plan(host_ptr, tables, dev)
        ptr = torch.from_numpy(host_ptr).to(dev)
        ind = torch.from_numpy(np.ascontiguousarray(
            X.indices[lo:hi], dtype=np.int32)).to(dev)
        val = torch.from_numpy(np.ascontiguousarray(
            X.data[lo:hi], dtype=np.float64)).to(dev)
        if times is not None:
            _wait(dev)
        t1 = time.perf_counter()
        bin_csr(ptr, ind, val, tables, zeros, out, r0, transpose, plan)
        if times is not None:
            _wait(dev)
        spent["upload"] += t1 - t0
        spent["binning"] += time.perf_counter() - t1
        del ptr, ind, val, plan
    if times is not None:
        times.update(spent)
    return out
