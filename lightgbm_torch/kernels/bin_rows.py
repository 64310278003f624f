"""Raw rows to group bins on the card: the CUDA kernel's wrapper, its plain
PyTorch version, its tables and the chunked upload that feeds it.

No ``pallas_call`` site: the counterpart of the JAX package's native host
binner (``lightgbm_tpu/native/binner.cpp`` ``lgbt_value_to_bin``, called
from ``lightgbm_tpu/binning.py``) and of the port's own NumPy
``binning.construct_binned``.  Given a (n, F) float64 matrix, the training
``BinMapper``s and the groups in their device order
(``binning.device_group_order``), it returns the (n, G) bins of
``construct_binned`` byte for byte, or their transpose (G, n), which K1
reads, in the card storage of ``layout.bins_to_torch`` (uint8, or 16-bit
bins as int16 bytes).  Its predict form (``sentinel`` features) also
re-bins a split categorical feature's NaN, negative and unseen values to
the sentinel bin ``num_bins`` that ``Booster.predict`` walks right, and
widens the bins to 16 bits where that bin passes 255.

``bin_rows`` launches the kernel (``csrc/bin_rows.cu``) for tensors on a
CUDA device and runs ``bin_rows_plain`` only for tensors on the CPU; a
kernel that fails to build or launch raises.  ``bin_matrix`` uploads a
host matrix in chunks of at most ``CHUNK_BYTES`` and bins each chunk
into one output tensor.
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..binning import BIN_CATEGORICAL, MISSING_NAN, BinMapper, _group_nbins
from ..utils.log import LightGBMError
from . import build
from .hist_wide import SMEM_SM, SMS

# (entries, len(FEAT_FIELDS)) int32 records, one per feature of each group
# in the group's order (its group and its position there last); the C
# side's enum follows this order
FEAT_FIELDS = ("column", "flags", "num_bins", "default_bin", "bounds_start",
               "bounds_len", "cats_start", "cats_len", "in_group", "group",
               "position")
(F_COLUMN, F_FLAGS, F_NUM_BINS, F_DEFAULT_BIN, F_BOUNDS_START, F_BOUNDS_LEN,
 F_CATS_START, F_CATS_LEN, F_IN_GROUP, F_GROUP,
 F_POSITION) = range(len(FEAT_FIELDS))
CATEGORICAL, MISSING_NAN_FLAG, SENTINEL, BUNDLED = 1, 2, 4, 8
# bin_csr's compact record of each column, (F, len(CSR_RECORD_FIELDS))
# int32 (two int4 a column), the fields its kernel reads: the table
# (bounds or categories) of its feature's kind; group -1 where the column
# has no feature.  A numeric feature of at most two bounds is flagged
# CSR_INLINE and holds its first bound's float64 bits in (start, len), low
# word first (+inf for one bound): its bin is (bound < value).  The C
# side's enum follows this order
CSR_RECORD_FIELDS = ("group", "flags", "position", "in_group", "num_bins",
                     "default_bin", "start", "len")
CSR_INLINE = 16

# the raw rows one upload chunk holds at most (float64 bytes)
CHUNK_BYTES = 256 << 20
THREADS = 256
# the staged kernel: persistent blocks, four an SM, each within BLOCK_BYTES
# of shared memory (four blocks and their reserved KB fill an SM's):
# a ring of two tiles of about STAGE_BYTES of rows each, the tile's
# (row, group) words and, where they fit, the tables
BLOCKS_PER_SM = 4
BLOCK_BYTES = SMEM_SM // BLOCKS_PER_SM - 1024
STAGE_BYTES = 16 * 1024
MAX_TILE_ROWS = 1024
INT64_MIN = -(2 ** 63)


class BinTables(NamedTuple):
    """What the kernel reads, on one device, and the sizes it checks."""
    feats: torch.Tensor        # (entries * FEAT_FIELDS,) int32 records
    group_start: torch.Tensor  # (G + 1,) int32
    bounds: torch.Tensor       # float64 upper bounds of numeric features
    cats: torch.Tensor         # int64 categories, sorted per feature
    cat_bins: torch.Tensor     # int32 bin of each sorted category
    col_entry: torch.Tensor    # (F,) int32 each column's record, -1: none
    num_features: int
    num_groups: int
    out_bytes: int             # 1: uint8 bins, 2: 16-bit (int16 storage)
    table_bytes: int           # the tables' bytes in a block's shared memory
    host_feats: np.ndarray     # feats on the host, for the plain version
    host_group_start: np.ndarray
    csr_records: torch.Tensor  # (F, 8) int32 csr_records, for bin_csr


class BinPlan(NamedTuple):
    """One launch, in the field order the C side reads.  Staged: ``blocks``
    persistent blocks of ``threads`` threads loop over ``tiles`` tiles of
    ``tile_rows`` rows (tile i in block i % blocks), each tile's raw
    values in one of two ``stage_bytes`` halves of a ring, its (row,
    group) words in ``word_bytes``, the tables in ``table_bytes`` (0: read
    from global memory), ``smem`` bytes in all.  Unstaged: one block a
    tile of ``tile_rows`` rows, a thread a (row, group) pair, no shared
    memory."""
    tile_rows: int
    tiles: int
    blocks: int
    threads: int
    staged: int
    stage_bytes: int
    word_bytes: int
    table_bytes: int
    smem: int


BIN_PLAN_FIELDS = BinPlan._fields


def _align16(b: int) -> int:
    return (b + 15) & ~15


def bin_plan(n: int, F: int, G: int = 1, sm_count: int = SMS,
             table_bytes: int = 0) -> BinPlan:
    """The launch plan over n rows of F raw values binned into G groups on
    a card of ``sm_count`` SMs, with tables of ``table_bytes``: tiles of
    as many rows as fit in STAGE_BYTES (1 to MAX_TILE_ROWS, fewer where a
    block's ring and words would pass BLOCK_BYTES), BLOCKS_PER_SM
    persistent blocks an SM at most, the tables in shared memory where
    they fit beside the ring; rows too wide for two of them and their words
    in BLOCK_BYTES are read from global memory, THREADS rows a block."""
    per_row = 8 * F
    stride = G | 1          # the C side's odd word stride

    def words(rows):
        return _align16(4 * rows * stride)

    if 2 * per_row + words(1) > BLOCK_BYTES:
        tiles = -(-n // THREADS)
        return BinPlan(THREADS, tiles, tiles, THREADS, 0, 0, 0, 0, 0)
    rows = max(1, min(MAX_TILE_ROWS, STAGE_BYTES // per_row,
                      BLOCK_BYTES // (2 * per_row + 4 * stride)))
    while 2 * rows * per_row + words(rows) > BLOCK_BYTES:
        rows -= 1
    stage = rows * per_row
    base = 2 * stage + words(rows)
    tb = table_bytes if base + table_bytes <= BLOCK_BYTES else 0
    tiles = -(-n // rows)
    return BinPlan(rows, tiles, min(tiles, BLOCKS_PER_SM * sm_count),
                   THREADS, 1, stage, words(rows), tb, base + tb)


def launch_plan(x: torch.Tensor, tables: BinTables) -> BinPlan:
    """The plan ``bin_rows_cuda`` launches these rows under."""
    n, F = x.shape
    return bin_plan(n, F, tables.num_groups, SMS, tables.table_bytes)


def bin_tables(bin_mappers: Sequence[BinMapper], groups: List[List[int]],
               device: torch.device, sentinel: Sequence[int] = ()
               ) -> BinTables:
    """The kernel's tables for ``groups`` (in their device order, as
    ``construct_binned`` stores them).  ``sentinel``: the categorical
    features whose NaN, negative and unseen values go to bin ``num_bins``
    (the predict form; each alone in its group), which widens the bins to
    16 bits where such a feature has more than 255 bins."""
    sentinel = set(int(f) for f in sentinel)
    feats, starts, bounds, cats, cat_bins = [], [0], [], [], []
    n_bounds = n_cats = 0
    col_entry = np.full(len(bin_mappers), -1, np.int32)
    for gi, g in enumerate(groups):
        in_group = 1
        for pos, f in enumerate(g):
            col_entry[f] = len(feats)
            m = bin_mappers[f]
            flags = BUNDLED if len(g) > 1 else 0
            if m.bin_type == BIN_CATEGORICAL:
                flags |= CATEGORICAL
                c = np.asarray(m.categories, np.int64)
                order = np.argsort(c, kind="stable")
                cats.append(c[order])
                cat_bins.append(order.astype(np.int32))
                if f in sentinel:
                    if len(g) > 1:
                        raise LightGBMError("a sentinel feature must be alone "
                                            "in its group")
                    flags |= SENTINEL
                rec = (f, flags, m.num_bins, m.default_bin, 0, 0, n_cats,
                       len(c), in_group, gi, pos)
                n_cats += len(c)
            else:
                b = np.asarray(m.upper_bounds, np.float64)
                if len(b) == 0:
                    raise LightGBMError(f"feature {f} has no upper bounds")
                if m.missing_type == MISSING_NAN:
                    flags |= MISSING_NAN_FLAG
                bounds.append(b)
                rec = (f, flags, m.num_bins, m.default_bin, n_bounds, len(b),
                       0, 0, in_group, gi, pos)
                n_bounds += len(b)
            feats.append(rec)
            in_group += m.num_bins - 1
        starts.append(len(feats))
    widest = max((_group_nbins(g, bin_mappers) for g in groups), default=1)
    wide_sentinel = any(bin_mappers[f].num_bins > 255 for f in sentinel)
    out_bytes = 2 if widest > 256 or wide_sentinel else 1
    host_feats = np.asarray(feats, np.int32).reshape(-1, len(FEAT_FIELDS))
    host_starts = np.asarray(starts, np.int32)

    def dev(parts, dtype):
        # one element at least, so that every pointer the kernel gets is
        # a real allocation
        a = np.concatenate(parts) if parts else np.zeros(0, dtype)
        a = a.astype(dtype) if len(a) else np.zeros(1, dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    t_feats, t_bounds, t_cats, t_cat_bins = (
        dev([host_feats.reshape(-1)], np.int32), dev(bounds, np.float64),
        dev(cats, np.int64), dev(cat_bins, np.int32))
    # the C side's copy in shared memory: float64 and int64 first
    table_bytes = _align16(8 * (t_bounds.numel() + t_cats.numel())
                           + 4 * (t_feats.numel() + len(bin_mappers)
                                  + t_cat_bins.numel()))
    return BinTables(t_feats, torch.from_numpy(host_starts).to(device),
                     t_bounds, t_cats, t_cat_bins,
                     torch.from_numpy(col_entry).to(device), len(bin_mappers),
                     len(groups), out_bytes, table_bytes, host_feats,
                     host_starts, torch.from_numpy(csr_records(
                         host_feats, len(bin_mappers),
                         np.concatenate(bounds) if bounds else np.zeros(0)
                         )).to(device))


def csr_records(host_feats: np.ndarray, num_features: int,
                bounds: np.ndarray, inline: bool = True) -> np.ndarray:
    """(F, len(CSR_RECORD_FIELDS)) int32: each column's feature record in
    bin_csr's compact form (group -1: no feature), ``bounds`` the tables'
    float64 upper bounds; ``inline``: numeric features of at most two
    bounds hold their first (CSR_INLINE)."""
    out = np.zeros((num_features, len(CSR_RECORD_FIELDS)), np.int32)
    out[:, 0] = -1
    if len(host_feats):
        f = host_feats
        cat = (f[:, F_FLAGS] & CATEGORICAL) != 0
        start = np.where(cat, f[:, F_CATS_START], f[:, F_BOUNDS_START])
        size = np.where(cat, f[:, F_CATS_LEN], f[:, F_BOUNDS_LEN])
        flags = f[:, F_FLAGS].copy()
        if inline:
            short = ~cat & (size <= 2)
            first = np.where(size[short] == 2,
                             bounds[start[short]], np.inf).astype("<f8")
            words = first.view("<i4").reshape(-1, 2)
            flags[short] |= CSR_INLINE
            start[short], size[short] = words[:, 0], words[:, 1]
        out[f[:, F_COLUMN]] = np.stack([
            f[:, F_GROUP], flags, f[:, F_POSITION], f[:, F_IN_GROUP],
            f[:, F_NUM_BINS], f[:, F_DEFAULT_BIN], start, size], axis=1)
    return out


def storage_dtype(out_bytes: int) -> torch.dtype:
    return torch.uint8 if out_bytes == 1 else torch.int16


def bin_rows(x: torch.Tensor, tables: BinTables, out: torch.Tensor,
             row0: int = 0, transpose: bool = False) -> torch.Tensor:
    """Bin the (n, F) float64 rows ``x`` into rows [row0, row0 + n) of
    ``out``: (N, G), or (G, N) with ``transpose``, of the tables' storage
    dtype.  Returns ``out``."""
    if x.device.type == "cuda":
        return bin_rows_cuda(x, tables, out, row0, transpose)
    if x.device.type == "cpu":
        return bin_rows_plain(x, tables, out, row0, transpose)
    raise LightGBMError(f"bin_rows has no kernel for device {x.device}")


def _feature_bins(v: torch.Tensor, tables: BinTables,
                  rec: np.ndarray) -> torch.Tensor:
    """int64 bins of one feature's float64 values (BinMapper.transform, and
    the predict form's sentinel)."""
    flags = int(rec[F_FLAGS])
    nan = torch.isnan(v)
    if flags & CATEGORICAL:
        c0, nc = int(rec[F_CATS_START]), int(rec[F_CATS_LEN])
        cats = tables.cats[c0:c0 + nc]
        bins = tables.cat_bins[c0:c0 + nc].to(torch.int64)

        def lookup(iv):
            if nc == 0:
                return torch.zeros_like(iv, dtype=torch.bool), \
                    torch.zeros_like(iv)
            pos = torch.searchsorted(cats, iv).clamp_(max=nc - 1)
            return cats[pos] == iv, bins[pos]

        # NaN -> -1, then NumPy's int64 cast on x86-64: INT64_MIN out of
        # range and at +-inf
        w = torch.where(nan, torch.full_like(v, -1.0), v)
        inside = (w >= -2.0 ** 63) & (w < 2.0 ** 63)
        iv = torch.where(inside, torch.where(inside, w, 0.0).to(torch.int64),
                         torch.full_like(w, INT64_MIN, dtype=torch.int64))
        hit, b = lookup(iv)
        out = torch.where(hit, b, torch.zeros_like(b))
        if flags & SENTINEL:
            ic = w.clamp(-1.0, 2.0 ** 62).to(torch.int64)
            hit, _ = lookup(ic)
            out = torch.where((ic >= 0) & hit, out,
                              torch.full_like(out, int(rec[F_NUM_BINS])))
        return out
    b0, nb = int(rec[F_BOUNDS_START]), int(rec[F_BOUNDS_LEN])
    w = torch.where(nan, torch.zeros_like(v), v).contiguous()
    out = torch.searchsorted(tables.bounds[b0:b0 + nb], w).clamp_(max=nb - 1)
    if flags & MISSING_NAN_FLAG:
        out = torch.where(nan, torch.full_like(out, int(rec[F_NUM_BINS]) - 1),
                          out)
    return out


def bin_rows_plain(x: torch.Tensor, tables: BinTables, out: torch.Tensor,
                   row0: int = 0, transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: torch.searchsorted
    on float64 per feature, then the group assembly of construct_binned
    (an EFB bundle's last non-default feature wins)."""
    _check_shapes("bin_rows_plain", x, tables, out, row0, transpose)
    n = x.shape[0]
    for g in range(tables.num_groups):
        recs = tables.host_feats[tables.host_group_start[g]:
                                 tables.host_group_start[g + 1]]
        col = torch.zeros(n, dtype=torch.int64, device=x.device)
        for rec in recs:
            b = _feature_bins(x[:, int(rec[F_COLUMN])], tables, rec)
            if not int(rec[F_FLAGS]) & BUNDLED:
                col = b
                continue
            d = int(rec[F_DEFAULT_BIN])
            local = torch.where(b > d, b - 1, b)
            col = torch.where(b != d, int(rec[F_IN_GROUP]) + local, col)
        # 16-bit bins as their int16 bytes
        col = torch.where(col >= 2 ** 15, col - 2 ** 16, col).to(out.dtype)
        if transpose:
            out[g, row0:row0 + n] = col
        else:
            out[row0:row0 + n, g] = col
    return out


def _check_shapes(name, x, tables, out, row0, transpose):
    n_out = out.shape[1] if transpose else out.shape[0]
    G = out.shape[0] if transpose else out.shape[1]
    if (x.dim() != 2 or x.shape[1] != tables.num_features or out.dim() != 2
            or G != tables.num_groups or row0 < 0
            or row0 + x.shape[0] > n_out
            or out.dtype != storage_dtype(tables.out_bytes)):
        raise LightGBMError(f"{name}: shapes do not agree (x "
                            f"{tuple(x.shape)}, out {tuple(out.shape)} "
                            f"{out.dtype}, {tables.num_features} features, "
                            f"{tables.num_groups} groups)")


def plan_arg(plan: BinPlan) -> ctypes.Array:
    """The plan as the C side's int64 array."""
    return (ctypes.c_int64 * len(BIN_PLAN_FIELDS))(*plan)


def bin_rows_cuda(x: torch.Tensor, tables: BinTables, out: torch.Tensor,
                  row0: int = 0, transpose: bool = False) -> torch.Tensor:
    """Launch csrc/bin_rows.cu on the current stream, under
    ``launch_plan`` of the shapes."""
    dev = x.device
    build.check_operands("bin_rows", dev, (
        ("x", x, torch.float64), ("feats", tables.feats, torch.int32),
        ("group_start", tables.group_start, torch.int32),
        ("col_entry", tables.col_entry, torch.int32),
        ("bounds", tables.bounds, torch.float64),
        ("cats", tables.cats, torch.int64),
        ("cat_bins", tables.cat_bins, torch.int32),
        ("out", out, storage_dtype(tables.out_bytes))))
    _check_shapes("bin_rows", x, tables, out, row0, transpose)
    n, F = x.shape
    plan = launch_plan(x, tables)
    fn = getattr(build.load("bin_rows"), build.SIGNATURES["bin_rows"][0])
    rc = fn(x.data_ptr(), n, F, tables.feats.data_ptr(),
            tables.feats.numel() // len(FEAT_FIELDS),
            tables.group_start.data_ptr(), tables.num_groups,
            tables.col_entry.data_ptr(), tables.bounds.data_ptr(),
            tables.bounds.numel(), tables.cats.data_ptr(),
            tables.cat_bins.data_ptr(), tables.cats.numel(), out.data_ptr(),
            tables.out_bytes, out.shape[1] if transpose else out.shape[0],
            row0, int(transpose), plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"bin_rows kernel launch failed (cudaError "
                            f"{rc}, plan {tuple(plan)})")
    build.count_launch(bin_rows_cuda, tables.out_bytes)
    return out


build.init_counts(bin_rows_cuda)


def bin_matrix(X: np.ndarray, tables: BinTables, transpose: bool = False,
               times: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """The bins of a host (N, F) matrix on the tables' device: (N, G), or
    (G, N) with ``transpose``.  The rows go up in chunks of at most
    ``CHUNK_BYTES`` of float64, each binned by ``bin_rows`` as it arrives.
    A dict passed as ``times`` receives the seconds of the uploads
    (``upload``) and of the binning (``binning``), each stage then waited
    for."""
    n, F = X.shape
    dev = tables.feats.device
    out = torch.empty((tables.num_groups, n) if transpose
                      else (n, tables.num_groups),
                      dtype=storage_dtype(tables.out_bytes), device=dev)
    step = max(1, CHUNK_BYTES // (8 * max(F, 1)))
    spent = {"upload": 0.0, "binning": 0.0}
    for r0 in range(0, n, step):
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(X[r0:r0 + step],
                                                  dtype=np.float64)).to(dev)
        if times is not None:
            _wait(dev)
        t1 = time.perf_counter()
        bin_rows(x, tables, out, r0, transpose)
        if times is not None:
            _wait(dev)
        spent["upload"] += t1 - t0
        spent["binning"] += time.perf_counter() - t1
        del x
    if times is not None:
        times.update(spent)
    return out


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
