"""TreeSHAP over packed leaf paths: the CUDA kernel's wrapper, its launch
plan and its plain PyTorch version.

Replaces no ``pallas_call``: the JAX package's device TreeSHAP is one jitted
``lax.scan`` over padded (L, D, N) path tensors in float32
(``lightgbm_tpu/shap.py:337`` ``_shap_device``).  The port computes the same
function in float64 throughout, so that a row on a split threshold decides
as the exact host walk does.  For every row, tree and leaf: the decision of
every node on the leaf's path (``_all_decisions``: a float64 compare, NaN
and zero-as-missing by the node's missing type, default left), each unique
feature slot's one fraction (1 when every occurrence of the feature on the
path goes the row's way), the path polynomial extended over the slots, and
each slot's unwound sum times the leaf value added to ``phi[row, class,
feature]``.  The arithmetic of one (row, leaf) is the host walk's
(``shap._extend_path``, ``_unwound_path_sum``) with its divisions replaced
by the small-integer ratios of ``shap_factors`` and the slot's 1 / z
(``ShapTables.rzfrac``), and a slot the row does not go (one fraction 0)
taking one sum a leaf scaled by its 1 / z; over the slots in
``_leaf_paths`` order (the host walk extends a repeated feature last), so
the two agree to float64 rounding, not bit for bit.  Each tree's
contributions are summed from 0 and the trees' sums added in tree order,
so any launch plan and any row chunking give the same bytes.

``tree_shap`` launches the kernel (``csrc/tree_shap.cu``) for tensors on a
CUDA device and runs ``tree_shap_plain`` only for tensors on the CPU.  A
kernel that fails to build or launch raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import build
from .hist_wide import SMS

MAX_DEPTH = 24            # csrc/tree_shap.cu kMaxDepth: slots of a path
OCC_SLOT_BITS = 5         # occurrence word: node << 6 | slot << 1 | left
# the plain version's (rows, L, D + 1) temporaries: at most this many values
PLAIN_CHUNK_VALUES = 1 << 24
# the launch plan (csrc/tree_shap.cu): one thread a row; a few blocks an SM
# before the trees are split into groups; the trees' partial sums at most
# this many bytes; a block's decision words and its accumulators in shared
# memory at most these many bytes
THREADS = 128
BLOCKS_PER_SM = 8
PARTIAL_BYTES = 256 << 20
DEC_BYTES = 16 * 1024
ACC_BYTES = 32 * 1024
BUCKETS = (8, 16, 24)     # the path lengths the kernel is unrolled for
# the small-integer ratios of the extend and the unwound sums, each a
# (25, 25) table [a][b] in the C side's order (csrc/tree_shap.cu enum)
FACTOR_TABLES = ("ext_up", "ext_keep", "hot_up", "hot_next", "cold_up")


class ShapTables(NamedTuple):
    """The packed tables of T numeric trees of at most L leaves and D path
    slots (``shap.shap_tables``), numpy arrays on the host or tensors."""
    split_feature: object   # (T, L - 1) int32
    threshold: object       # (T, L - 1) float64
    decision_type: object   # (T, L - 1) int32: missing type in bits 2-3,
                            # default left bit 1
    leaf_value: object      # (T, L) float64
    tree_class: object      # (T,) int32
    feat: object            # (T, L, D) int32 feature of each slot, -1 pad
    zfrac: object           # (T, L, D) float64 merged zero fraction
    rzfrac: object          # (T, L, D) float64 1 / zfrac, 0 where it is 0
    occ: object             # (T, L, D) int32 path occurrences, -1 pad
    plen: object            # (T, L) int32 unique path length, 0 pad leaf


class ShapPlan(NamedTuple):
    """One launch, in the field order the C side reads: ``tiles`` row tiles
    of ``threads`` rows (grid x) times ``groups`` contiguous tree groups of
    ``trees_per_group`` trees (grid y); the kernel unrolled for paths of
    ``bucket`` slots; each row's node decisions in ``dec_words`` 32-bit
    words of shared memory (0: decided at each path occurrence); each
    row's per-tree sums of its features in shared memory where
    ``shared_acc`` (else in device memory); ``smem`` bytes a block."""
    threads: int
    tiles: int
    groups: int
    trees_per_group: int
    bucket: int
    dec_words: int
    shared_acc: int
    smem: int


SHAP_PLAN_FIELDS = ShapPlan._fields


def shap_plan(n_rows: int, n_trees: int, sm_count: int, n_features: int = 1,
              num_leaves: int = 2, depth: int = MAX_DEPTH,
              partial_bytes: int = PARTIAL_BYTES) -> ShapPlan:
    """The launch plan of n_rows rows over n_trees trees of at most
    ``num_leaves`` leaves and ``depth`` path slots on a card of
    ``sm_count`` SMs.  Where the row tiles alone give fewer than
    BLOCKS_PER_SM blocks an SM, the trees split into contiguous groups
    (enough for that many blocks, one tree a group at most), as long as
    the trees' (T, n_features, n_rows) float64 partial sums fit in
    ``partial_bytes``; else one group.  Decision words and accumulators in
    shared memory where they fit DEC_BYTES and ACC_BYTES."""
    tiles = -(-n_rows // THREADS)
    want = BLOCKS_PER_SM * sm_count
    groups = 1
    if (0 < tiles < want and n_trees > 1
            and 8 * n_trees * n_features * n_rows <= partial_bytes):
        groups = min(n_trees, -(-want // tiles))
    per = max(1, -(-n_trees // groups))
    groups = max(1, -(-n_trees // per))
    bucket = next(b for b in BUCKETS if depth <= b)
    words = -(-(num_leaves - 1) // 32)
    if 4 * THREADS * words > DEC_BYTES:
        words = 0
    shared_acc = int(8 * THREADS * n_features <= ACC_BYTES)
    return ShapPlan(THREADS, tiles, groups, per, bucket, words, shared_acc,
                    4 * THREADS * words + 8 * THREADS * n_features
                    * shared_acc)


def plan_arg(plan: ShapPlan) -> ctypes.Array:
    """The plan as the C side's int64 array."""
    return (ctypes.c_int64 * len(SHAP_PLAN_FIELDS))(*plan)


def shap_factors() -> np.ndarray:
    """(5, 25, 25) float64: the ratios the kernel reads from its constant
    table (``FACTOR_TABLES`` order), each a correctly rounded division, 0
    outside its range (b < a): (b + 1) / (a + 1) and (a - b) / (a + 1) of
    the extend's step a, b; (a + 1) / (b + 1), (a - b) / (b + 1) and
    (a + 1) / (a - b) of an unwound sum over a slots at step b."""
    a = np.arange(MAX_DEPTH + 1, dtype=np.float64)[:, None]
    b = np.arange(MAX_DEPTH + 1, dtype=np.float64)[None, :]
    below = b < a
    with np.errstate(divide="ignore", invalid="ignore"):
        tabs = ((b + 1) / (a + 1), (a - b) / (a + 1), (a + 1) / (b + 1),
                (a - b) / (b + 1), (a + 1) / (a - b))
    return np.stack([np.where(below, t, 0.0) for t in tabs])


def reciprocal_zfrac(zfrac: np.ndarray) -> np.ndarray:
    """1 / z of each slot's zero fraction, 0 where z is 0 (the kernel's
    ``rzfrac``: a cold slot of zero fraction 0 adds nothing)."""
    nz = zfrac != 0
    return np.where(nz, 1.0 / np.where(nz, zfrac, 1.0), 0.0)


def tree_shap(X_T: torch.Tensor, tables: ShapTables,
              num_class: int) -> torch.Tensor:
    """(N, K, F + 1) float64 contributions of (F, N) float64 rows, the last
    column of each class 0 (the caller adds the expected values)."""
    if X_T.device.type == "cuda":
        return tree_shap_cuda(X_T, tables, num_class)
    if X_T.device.type == "cpu":
        return tree_shap_plain(X_T, tables, num_class)
    raise LightGBMError(f"tree_shap has no kernel for device {X_T.device}")


def _check_tables(X_T, tables, num_class):
    T, L, D = tables.feat.shape
    if (X_T.dim() != 2 or tuple(tables.leaf_value.shape) != (T, L)
            or tuple(tables.split_feature.shape) != (T, L - 1)
            or tuple(tables.threshold.shape) != (T, L - 1)
            or tuple(tables.decision_type.shape) != (T, L - 1)
            or tuple(tables.tree_class.shape) != (T,)
            or tuple(tables.zfrac.shape) != (T, L, D)
            or tuple(tables.rzfrac.shape) != (T, L, D)
            or tuple(tables.occ.shape) != (T, L, D)
            or tuple(tables.plen.shape) != (T, L) or not 0 < D <= MAX_DEPTH
            or num_class < 1):
        raise LightGBMError("tree_shap: table shapes do not agree")
    return T, L, D


def tree_shap_cuda(X_T: torch.Tensor, tables: ShapTables,
                   num_class: int) -> torch.Tensor:
    """Launch csrc/tree_shap.cu on the current stream under ``shap_plan``
    of the shapes (and, where the plan splits the trees, its second pass
    adding their partial sums)."""
    dev = X_T.device
    i32, f64 = torch.int32, torch.float64
    build.check_operands("tree_shap", dev, (
        ("X_T", X_T, f64), ("split_feature", tables.split_feature, i32),
        ("threshold", tables.threshold, f64),
        ("decision_type", tables.decision_type, i32),
        ("leaf_value", tables.leaf_value, f64),
        ("tree_class", tables.tree_class, i32), ("feat", tables.feat, i32),
        ("zfrac", tables.zfrac, f64), ("rzfrac", tables.rzfrac, f64),
        ("occ", tables.occ, i32), ("plen", tables.plen, i32)))
    T, L, D = _check_tables(X_T, tables, num_class)
    F, n = X_T.shape
    k = int(num_class)
    phi_T = torch.zeros((k, F + 1, n), dtype=f64, device=dev)
    if n and T:
        plan = shap_plan(n, T, SMS, F, L, D)
        # the partial slices, or the device scratch, or nothing
        acc = torch.zeros((T if plan.groups > 1 else int(
            not plan.shared_acc), F, n), dtype=f64, device=dev)
        fn = build.load("tree_shap").lgbt_tree_shap
        rc = fn(X_T.data_ptr(), n, F, tables.split_feature.data_ptr(),
                tables.threshold.data_ptr(), tables.decision_type.data_ptr(),
                tables.leaf_value.data_ptr(), tables.tree_class.data_ptr(),
                tables.feat.data_ptr(), tables.zfrac.data_ptr(),
                tables.rzfrac.data_ptr(), tables.occ.data_ptr(),
                tables.plen.data_ptr(), T, L, D, k, acc.data_ptr(),
                phi_T.data_ptr(), plan_arg(plan),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise LightGBMError(f"tree_shap kernel launch failed "
                                f"(cudaError {rc}, plan {tuple(plan)})")
        tree_shap_cuda.launches += 1
    return phi_T.permute(2, 0, 1)


tree_shap_cuda.launches = 0


def decisions_plain(X_T: torch.Tensor, split_feature: torch.Tensor,
                    threshold: torch.Tensor,
                    decision_type: torch.Tensor) -> torch.Tensor:
    """(N, nodes) bool: each row goes left at each numeric node
    (``shap._all_decisions``' numeric branch)."""
    v = X_T[split_feature.long()].t()                       # (N, nodes)
    nanv = torch.isnan(v)
    mt = (decision_type >> 2) & 3
    default_left = (decision_type & 2) != 0
    missing = nanv | ((mt == 1) & (v.abs() < 1e-35))
    go = torch.where(nanv, 0.0, v) <= threshold
    return torch.where(missing & (mt != 0), default_left, go)


def hot_slots_plain(X_T: torch.Tensor, tables: ShapTables,
                    t: int) -> torch.Tensor:
    """(N, L, D) bool: each slot of each leaf of tree t whose every path
    occurrence goes the row's way (its one fraction is 1)."""
    n = X_T.shape[1]
    _, L, D = tables.feat.shape
    dec = decisions_plain(X_T, tables.split_feature[t],
                          tables.threshold[t], tables.decision_type[t])
    occ = tables.occ[t].long()                                  # (L, D)
    valid = occ >= 0
    node = torch.where(valid, occ >> 6, 0)
    slot = torch.where(valid, (occ >> 1) & ((1 << OCC_SLOT_BITS) - 1), 0)
    left = (occ & 1) > 0
    cold = valid & (dec[:, node] != left)                       # (N, L, D)
    cnt = torch.zeros((n, L, D), dtype=torch.int32, device=X_T.device)
    cnt.scatter_add_(2, slot.expand(n, L, D), cold.to(torch.int32))
    return cnt == 0


def tree_sums_plain(X_T: torch.Tensor, tables: ShapTables, t0: int,
                    t1: int) -> torch.Tensor:
    """(t1 - t0, N, F) float64: each tree's contributions to its class,
    summed from 0 leaf by leaf, slot by slot (the kernel's per-tree
    accumulator), with the kernel's operations in its order: the extend
    by the ``ext_*`` ratios, a hot slot's unwound sum by ``hot_*``, a cold
    slot's as the leaf's one sum by ``cold_up`` times its 1 / z."""
    F, n = X_T.shape
    _, L, D = tables.feat.shape
    # rows are independent: chunks of them bound the temporaries
    chunk = max(1, PLAIN_CHUNK_VALUES // (L * (D + 1)))
    if n > chunk:
        return torch.cat([tree_sums_plain(X_T[:, s:s + chunk], tables, t0,
                                          t1)
                          for s in range(0, n, chunk)], dim=1)
    dev = X_T.device
    f64 = torch.float64
    fac = torch.as_tensor(shap_factors(), device=dev)
    ext_up, ext_keep, hot_up, hot_next, cold_up = fac[:, :, :D + 1]
    out = torch.zeros((t1 - t0, n, F), dtype=f64, device=dev)
    for t in range(t0, t1):
        plen = tables.plen[t].long()                            # (L,)
        hot = hot_slots_plain(X_T, tables, t)                   # (N, L, D)
        z = tables.zfrac[t]                                     # (L, D)
        # extend: pw[i] = pw[i] (z (k - i) / (k + 1))
        #                 + o pw[i - 1] (i / (k + 1))
        pw = torch.zeros((n, L, D + 1), dtype=f64, device=dev)
        pw[:, :, 0] = 1.0
        for k in range(1, D + 1):
            act = (k <= plen)[None, :, None]
            scaled = pw * (z[:, k - 1, None] * ext_keep[k])[None]
            up = scaled[:, :, 1:] + pw[:, :, :-1] * ext_up[k, :-1]
            new = torch.cat([scaled[:, :, :1], torch.where(
                hot[:, :, k - 1, None], up, scaled[:, :, 1:])], dim=2)
            pw = torch.where(act, new, pw)
        # the unwound sums, all slots of a leaf at once
        top = pw.gather(2, plen[None, :, None].expand(n, L, 1))
        cold = torch.zeros((n, L, 1), dtype=f64, device=dev)
        u = top.expand(n, L, D)
        total = torch.zeros((n, L, D), dtype=f64, device=dev)
        for j in range(D - 1, -1, -1):
            act = (j < plen)[None, :, None]
            p = pw[:, :, j, None]
            cold = torch.where(act, cold + p * cold_up[plen, j][:, None],
                               cold)
            total = torch.where(act, total + u * hot_up[plen, j][:, None],
                                total)
            u = torch.where(act, p - u * (z * hot_next[plen, j][:, None]),
                            u)
        o = hot.to(f64)
        total = torch.where(hot, total, cold * tables.rzfrac[t])
        slots = torch.arange(D, device=dev)[None, :] < plen[:, None]
        w = torch.where(slots[None], (total * (o - z))
                        * tables.leaf_value[t][:, None], 0.0)
        f = torch.where(slots, tables.feat[t].long(), F)         # (L, D)
        acc = torch.zeros((n, F + 1), dtype=f64, device=dev)
        acc.index_add_(1, f.reshape(-1), w.reshape(n, L * D))
        out[t - t0] = acc[:, :F]
    return out


def tree_shap_plain(X_T: torch.Tensor, tables: ShapTables,
                    num_class: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: each tree's sum
    (``tree_sums_plain``) added to its class's contributions in tree
    order, the bytes of the kernel under any plan."""
    F, n = X_T.shape
    cls = [int(c) for c in tables.tree_class.tolist()]
    phi = torch.zeros((n, int(num_class), F + 1), dtype=torch.float64,
                      device=X_T.device)
    for t in range(len(cls)):
        phi[:, cls[t], :F] += tree_sums_plain(X_T, tables, t, t + 1)[0]
    return phi
