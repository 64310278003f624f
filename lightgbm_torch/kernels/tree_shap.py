"""TreeSHAP over packed leaf paths: the CUDA kernel's wrapper and its plain
PyTorch version.

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
(``shap._extend_path``, ``_unwound_path_sum``) over the slots in
``_leaf_paths`` order; the host walk extends a repeated feature last, so
the two agree to float64 rounding, not bit for bit.

``tree_shap`` launches the kernel (``csrc/tree_shap.cu``) for tensors on a
CUDA device and runs ``tree_shap_plain`` only for tensors on the CPU.  A
kernel that fails to build or launch raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.log import LightGBMError
from . import build

MAX_DEPTH = 24            # csrc/tree_shap.cu kMaxDepth: slots of a path
OCC_SLOT_BITS = 5         # occurrence word: node << 6 | slot << 1 | left
# the plain version's (rows, L, D + 1) temporaries: at most this many values
PLAIN_CHUNK_VALUES = 1 << 24


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
    occ: object             # (T, L, D) int32 path occurrences, -1 pad
    plen: object            # (T, L) int32 unique path length, 0 pad leaf


def tree_shap(X_T: torch.Tensor, tables: ShapTables,
              num_class: int) -> torch.Tensor:
    """(N, K, F + 1) float64 contributions of (F, N) float64 rows, the last
    column of each class 0 (the caller adds the expected values)."""
    if X_T.device.type == "cuda":
        return tree_shap_cuda(X_T, tables, num_class)
    if X_T.device.type == "cpu":
        return tree_shap_plain(X_T, tables, num_class)
    raise LightGBMError(f"tree_shap has no kernel for device {X_T.device}")


def tree_shap_cuda(X_T: torch.Tensor, tables: ShapTables,
                   num_class: int) -> torch.Tensor:
    """Launch csrc/tree_shap.cu on the current stream: one thread a row."""
    dev = X_T.device
    i32, f64 = torch.int32, torch.float64
    build.check_operands("tree_shap", dev, (
        ("X_T", X_T, f64), ("split_feature", tables.split_feature, i32),
        ("threshold", tables.threshold, f64),
        ("decision_type", tables.decision_type, i32),
        ("leaf_value", tables.leaf_value, f64),
        ("tree_class", tables.tree_class, i32), ("feat", tables.feat, i32),
        ("zfrac", tables.zfrac, f64), ("occ", tables.occ, i32),
        ("plen", tables.plen, i32)))
    T, L, D = tables.feat.shape
    if (X_T.dim() != 2 or tuple(tables.leaf_value.shape) != (T, L)
            or tuple(tables.split_feature.shape) != (T, L - 1)
            or tuple(tables.threshold.shape) != (T, L - 1)
            or tuple(tables.decision_type.shape) != (T, L - 1)
            or tuple(tables.tree_class.shape) != (T,)
            or tuple(tables.zfrac.shape) != (T, L, D)
            or tuple(tables.occ.shape) != (T, L, D)
            or tuple(tables.plen.shape) != (T, L) or not 0 < D <= MAX_DEPTH
            or num_class < 1):
        raise LightGBMError("tree_shap: table shapes do not agree")
    F, n = X_T.shape
    k = int(num_class)
    phi_T = torch.zeros((k, F + 1, n), dtype=f64, device=dev)
    if n and T:
        fn = build.load("tree_shap").lgbt_tree_shap
        rc = fn(X_T.data_ptr(), n, F, tables.split_feature.data_ptr(),
                tables.threshold.data_ptr(), tables.decision_type.data_ptr(),
                tables.leaf_value.data_ptr(), tables.tree_class.data_ptr(),
                tables.feat.data_ptr(), tables.zfrac.data_ptr(),
                tables.occ.data_ptr(), tables.plen.data_ptr(), T, L, D, k,
                phi_T.data_ptr(),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if rc != 0:
            raise LightGBMError(f"tree_shap kernel launch failed "
                                f"(cudaError {rc})")
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


def tree_shap_plain(X_T: torch.Tensor, tables: ShapTables,
                    num_class: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract, one tree at a time
    over (rows x leaves x slots) in float64: the same operations of each
    (row, leaf) in the same order, and the slots' contributions added to
    ``phi`` leaf by leaf, slot by slot, in tree order."""
    F, n = X_T.shape
    T, L, D = tables.feat.shape
    # rows are independent: chunks of them bound the temporaries
    chunk = max(1, PLAIN_CHUNK_VALUES // (L * (D + 1)))
    if n > chunk:
        return torch.cat([tree_shap_plain(X_T[:, s:s + chunk], tables,
                                          num_class)
                          for s in range(0, n, chunk)])
    k = int(num_class)
    dev = X_T.device
    phi = torch.zeros((n, k, F + 1), dtype=torch.float64, device=dev)
    jj = torch.arange(D + 1, dtype=torch.float64, device=dev)
    for t in range(T):
        plen = tables.plen[t].long()                            # (L,)
        dec = decisions_plain(X_T, tables.split_feature[t],
                              tables.threshold[t], tables.decision_type[t])
        occ = tables.occ[t].long()                              # (L, D)
        valid = occ >= 0
        node = torch.where(valid, occ >> 6, 0)
        slot = torch.where(valid, (occ >> 1) & ((1 << OCC_SLOT_BITS) - 1), 0)
        left = (occ & 1) > 0
        cold = valid & (dec[:, node] != left)                   # (N, L, D)
        cnt = torch.zeros((n, L, D), dtype=torch.float64, device=dev)
        cnt.scatter_add_(2, slot.expand(n, L, D), cold.to(torch.float64))
        o = torch.where(cnt == 0, 1.0, 0.0).to(torch.float64)   # (N, L, D)
        z = tables.zfrac[t]                                     # (L, D)
        # extend: pw[j] = z pw[j] (d - j) / (d + 1) + o pw[j - 1] j / (d + 1)
        pw = torch.zeros((n, L, D + 1), dtype=torch.float64, device=dev)
        pw[:, :, 0] = 1.0
        for d in range(1, D + 1):
            act = (d <= plen)[None, :, None]
            a = z[None, :, d - 1, None] * pw * (d - jj) / (d + 1)
            b = o[:, :, d - 1, None] * pw[:, :, :-1] * jj[1:] / (d + 1)
            new = torch.cat([a[:, :, :1], a[:, :, 1:] + b], dim=2)
            pw = torch.where(act & (jj <= d), new, pw)
        # each slot's unwound sum, all slots of a leaf at once
        d = plen.to(torch.float64)[None, :, None]               # (1, L, 1)
        next_one = pw.gather(2, plen[None, :, None].expand(n, L, 1)).expand(
            n, L, D).clone()
        total = torch.zeros((n, L, D), dtype=torch.float64, device=dev)
        hot = o != 0
        zero = z[None] != 0
        for j in range(D - 1, -1, -1):
            act = (j < plen)[None, :, None]
            q = (d - j) / (d + 1)
            tmp = torch.where(hot, next_one * (d + 1) / ((j + 1) * torch.where(
                hot, o, 1.0)), 0.0)
            alt = torch.where(zero, (pw[:, :, j, None] / torch.where(
                zero, z[None], 1.0)) / q, 0.0)
            total = torch.where(act, total + torch.where(hot, tmp, alt),
                                total)
            next_one = torch.where(act & hot,
                                   pw[:, :, j, None] - tmp * z[None] * q,
                                   next_one)
        slots = torch.arange(D, device=dev)[None, :] < plen[:, None]
        w = torch.where(slots[None], total * (o - z[None])
                        * tables.leaf_value[t][None, :, None], 0.0)
        f = torch.where(slots, tables.feat[t].long(), F)         # (L, D)
        cls = int(tables.tree_class[t])
        phi[:, cls].index_add_(1, f.reshape(-1), w.reshape(n, L * D))
    phi[:, :, F] = 0.0
    return phi
