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
kernel that fails to build or launch raises.  ``bin_csr_matrix`` uploads a
SciPy matrix in chunks of rows whose values and column indices hold at
most ``bin_rows.CHUNK_BYTES`` and bins each chunk into one output tensor.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import build
from .bin_rows import (BUNDLED, CHUNK_BYTES, F_COLUMN, F_DEFAULT_BIN,
                       F_FLAGS, F_IN_GROUP, FEAT_FIELDS, BinTables,
                       _feature_bins, _wait, storage_dtype)

# rows of one block's tile: its threads set the tile's cells to the zero
# bins, then each warp takes a row
TILE_ROWS = 64
# bytes a stored entry takes on the card: an int32 column and a float64
ENTRY_BYTES = 12


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
            row0: int = 0, transpose: bool = False) -> torch.Tensor:
    """Bin the CSR rows (``indptr`` int64 (n + 1,) from 0, ``indices``
    int32 and ``data`` float64 of ``indptr[n]`` entries) into rows [row0,
    row0 + n) of ``out``: (N, G), or (G, N) with ``transpose``, of the
    tables' storage dtype; ``zeros`` is ``zero_bins`` as an int32 tensor.
    Returns ``out``."""
    if indices.device.type == "cuda":
        return bin_csr_cuda(indptr, indices, data, tables, zeros, out, row0,
                            transpose)
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
                 out: torch.Tensor, row0: int = 0,
                 transpose: bool = False) -> torch.Tensor:
    """Launch csrc/bin_csr.cu on the current stream, TILE_ROWS rows a
    block."""
    dev = indices.device
    build.check_operands("bin_csr", dev, (
        ("indptr", indptr, torch.int64), ("indices", indices, torch.int32),
        ("data", data, torch.float64), ("feats", tables.feats, torch.int32),
        ("col_entry", tables.col_entry, torch.int32),
        ("bounds", tables.bounds, torch.float64),
        ("cats", tables.cats, torch.int64),
        ("cat_bins", tables.cat_bins, torch.int32),
        ("zero_bins", zeros, torch.int32),
        ("out", out, storage_dtype(tables.out_bytes))))
    _check_shapes("bin_csr", indptr, indices, data, tables, zeros, out, row0,
                  transpose)
    n = indptr.shape[0] - 1
    fn = getattr(build.load("bin_csr"), build.SIGNATURES["bin_csr"][0])
    rc = fn(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), n,
            tables.num_features, tables.feats.data_ptr(),
            tables.feats.numel() // len(FEAT_FIELDS), tables.num_groups,
            tables.col_entry.data_ptr(), tables.bounds.data_ptr(),
            tables.bounds.numel(), tables.cats.data_ptr(),
            tables.cat_bins.data_ptr(), tables.cats.numel(),
            zeros.data_ptr(), out.data_ptr(), tables.out_bytes,
            out.shape[1] if transpose else out.shape[0], row0,
            int(transpose), TILE_ROWS,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"bin_csr kernel launch failed (cudaError {rc})")
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
    each binned by ``bin_csr`` as it arrives; ``data`` is read as float64
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
        ptr = torch.from_numpy(indptr[r0:r1 + 1] - lo).to(dev)
        ind = torch.from_numpy(np.ascontiguousarray(
            X.indices[lo:hi], dtype=np.int32)).to(dev)
        val = torch.from_numpy(np.ascontiguousarray(
            X.data[lo:hi], dtype=np.float64)).to(dev)
        if times is not None:
            _wait(dev)
        t1 = time.perf_counter()
        bin_csr(ptr, ind, val, tables, zeros, out, r0, transpose)
        if times is not None:
            _wait(dev)
        spent["upload"] += t1 - t0
        spent["binning"] += time.perf_counter() - t1
        del ptr, ind, val
    if times is not None:
        times.update(spent)
    return out
