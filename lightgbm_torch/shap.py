"""SHAP feature contributions (pred_contrib).

The port's copy of ``lightgbm_tpu/shap.py`` (reference: src/io/tree.cpp
TreeSHAP, Lundberg's exact algorithm, used by GBDT::PredictContrib,
gbdt.cpp:655).  Output layout as the reference's: (N, F+1) with the expected
value in the last column, (N, K*(F+1)) for K classes.  Two paths: the exact
float64 host walk, copied from the JAX package so that both give the same
bytes, and the device TreeSHAP (``predict_contrib_device``), which builds
each tree's packed leaf-path tables here and runs
``kernels/tree_shap.py`` over every row, tree and leaf in float64.
``Booster.predict`` chooses between them.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .kernels.bin_rows import CHUNK_BYTES
from .kernels.tree_shap import (MAX_DEPTH, ShapTables, reciprocal_zfrac,
                                tree_shap)
from .tree import Tree


class _PathElem:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, feature_index, zero_fraction, one_fraction, pweight):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight


def _extend_path(path: List[_PathElem], zero_fraction, one_fraction, feature_index):
    path.append(_PathElem(feature_index, zero_fraction, one_fraction,
                          1.0 if len(path) == 0 else 0.0))
    d = len(path) - 1
    for i in range(d - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) / (d + 1)
        path[i].pweight = zero_fraction * path[i].pweight * (d - i) / (d + 1)


def _unwind_path(path: List[_PathElem], path_index):
    d = len(path) - 1
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[d].pweight
    for i in range(d - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (d + 1) / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction * (d - i) / (d + 1)
        else:
            path[i].pweight = path[i].pweight * (d + 1) / (zero_fraction * (d - i))
    for i in range(path_index, d):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_path_sum(path: List[_PathElem], path_index):
    d = len(path) - 1
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[d].pweight
    total = 0.0
    for i in range(d - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (d + 1) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * ((d - i) / (d + 1))
        elif zero_fraction != 0:
            total += (path[i].pweight / zero_fraction) / ((d - i) / (d + 1))
    return total


def _decision(tree: Tree, node: int, x: np.ndarray) -> bool:
    f = int(tree.split_feature[node])
    v = x[f]
    dt = int(tree.decision_type[node])
    if dt & 1:  # categorical
        if np.isnan(v) or v < 0:
            return False
        c = int(v)
        kcat = int(tree.threshold_bin[node])
        s, e = tree.cat_boundaries[kcat], tree.cat_boundaries[kcat + 1]
        if c // 32 >= e - s:
            return False
        return bool((int(tree.cat_threshold[s + c // 32]) >> (c % 32)) & 1)
    missing_type = (dt >> 2) & 3
    is_missing = np.isnan(v) or (missing_type == 1 and abs(v) < 1e-35)
    if is_missing and missing_type != 0:
        return bool(dt & 2)  # default left
    if np.isnan(v):
        v = 0.0
    return v <= tree.threshold[node]


def _tree_shap(tree: Tree, x: np.ndarray, phi: np.ndarray, node: int,
               path: List[_PathElem], parent_zero_fraction: float,
               parent_one_fraction: float, parent_feature_index: int) -> None:
    path = [
        _PathElem(p.feature_index, p.zero_fraction, p.one_fraction, p.pweight)
        for p in path
    ]
    _extend_path(path, parent_zero_fraction, parent_one_fraction,
                 parent_feature_index)
    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, len(path)):
            w = _unwound_path_sum(path, i)
            el = path[i]
            phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) * \
                tree.leaf_value[leaf]
        return
    hot = _decision(tree, node, x)
    hot_child = int(tree.left_child[node] if hot else tree.right_child[node])
    cold_child = int(tree.right_child[node] if hot else tree.left_child[node])
    w_node = _node_weight(tree, node)
    w_hot = _child_weight(tree, hot_child)
    w_cold = _child_weight(tree, cold_child)
    hot_zero_fraction = w_hot / w_node if w_node > 0 else 0.0
    cold_zero_fraction = w_cold / w_node if w_node > 0 else 0.0
    incoming_zero = 1.0
    incoming_one = 1.0
    f = int(tree.split_feature[node])
    # undo previous split on the same feature along the path
    path_index = next((i for i in range(len(path))
                       if path[i].feature_index == f), -1)
    if path_index >= 0:
        incoming_zero = path[path_index].zero_fraction
        incoming_one = path[path_index].one_fraction
        _unwind_path(path, path_index)
    _tree_shap(tree, x, phi, hot_child, path,
               hot_zero_fraction * incoming_zero, incoming_one, f)
    _tree_shap(tree, x, phi, cold_child, path,
               cold_zero_fraction * incoming_zero, 0.0, f)


def _node_weight(tree: Tree, node: int) -> float:
    if node < 0:
        return float(tree.leaf_count[~node])
    return float(tree.internal_count[node])


_child_weight = _node_weight


def _all_decisions(tree: Tree, X: np.ndarray) -> np.ndarray:
    """(N, n_internal) bool — each row's decision at EVERY internal node
    (vectorised _decision); TreeSHAP consults off-path nodes too."""
    n = X.shape[0]
    ni = max(tree.num_leaves - 1, 0)
    dec = np.zeros((n, ni), bool)
    for node in range(ni):
        f = int(tree.split_feature[node])
        v = X[:, f]
        dt = int(tree.decision_type[node])
        if dt & 1:  # categorical
            iv = np.where(np.isnan(v) | (v < 0), -1, v).astype(np.int64)
            kcat = int(tree.threshold_bin[node])
            s, e = tree.cat_boundaries[kcat], tree.cat_boundaries[kcat + 1]
            words = np.asarray(tree.cat_threshold[s:e], np.uint32)
            word_idx = iv // 32
            ok = (iv >= 0) & (word_idx < (e - s))
            w = words[np.clip(word_idx, 0, max(e - s - 1, 0))]
            dec[:, node] = ok & (((w >> (iv % 32).astype(np.uint32)) & 1) > 0)
            continue
        missing_type = (dt >> 2) & 3
        nanv = np.isnan(v)
        is_missing = nanv | ((missing_type == 1) & (np.abs(v) < 1e-35))
        go = np.where(nanv, 0.0, v) <= tree.threshold[node]
        if missing_type != 0:
            go = np.where(is_missing, bool(dt & 2), go)
        dec[:, node] = go
    return dec


def _tree_shap_batch(tree: Tree, dec: np.ndarray, phi: np.ndarray) -> None:
    """Row-vectorised exact TreeSHAP: the recursion order over nodes is
    row-independent; only the hot/cold assignment and the path fractions vary
    per row, carried as (N,) vectors (same math as the scalar reference
    implementation above / src/io/tree.cpp TreeSHAP)."""
    n = dec.shape[0]
    leaf_value = np.asarray(tree.leaf_value, np.float64)

    def node_weight(node):
        return (float(tree.leaf_count[~node]) if node < 0
                else float(tree.internal_count[node]))

    def recurse(node, feat_idx, zf, of, pw, pz, po, pf):
        # copy-extend the path (reference copies the path per call)
        d = len(feat_idx)
        feat_idx = feat_idx + [pf]
        zf = np.vstack([zf, pz[None, :]])
        of = np.vstack([of, po[None, :]])
        pw = np.vstack([pw, np.full((1, n), 1.0 if d == 0 else 0.0)])
        for i in range(d - 1, -1, -1):
            pw[i + 1] += po * pw[i] * (i + 1) / (d + 1)
            pw[i] = pz * pw[i] * (d - i) / (d + 1)

        if node < 0:  # leaf: unwound path sums -> phi
            dd = len(feat_idx) - 1
            for i in range(1, len(feat_idx)):
                ofi, zfi = of[i], zf[i]
                next_one = pw[dd].copy()
                total = np.zeros(n)
                for j in range(dd - 1, -1, -1):
                    tmp = np.where(
                        ofi != 0,
                        next_one * (dd + 1) / ((j + 1) * np.where(ofi != 0,
                                                                  ofi, 1.0)),
                        0.0)
                    safe_z = np.where(zfi != 0, zfi, 1.0)
                    alt = np.where(zfi != 0,
                                   (pw[j] / safe_z) / ((dd - j) / (dd + 1)),
                                   0.0)
                    total += np.where(ofi != 0, tmp, alt)
                    next_one = pw[j] - tmp * zfi * ((dd - j) / (dd + 1))
                phi[:, feat_idx[i]] += total * (ofi - zfi) * leaf_value[~node]
            return

        lc, rc = int(tree.left_child[node]), int(tree.right_child[node])
        hot_is_left = dec[:, node]
        w_node = node_weight(node)
        w_l, w_r = node_weight(lc), node_weight(rc)
        zl = w_l / w_node if w_node > 0 else 0.0
        zr = w_r / w_node if w_node > 0 else 0.0
        f = int(tree.split_feature[node])
        inc_zero = np.ones(n)
        inc_one = np.ones(n)
        if f in feat_idx:
            pi = feat_idx.index(f)
            inc_zero = zf[pi].copy()
            inc_one = of[pi].copy()
            # unwind the previous occurrence of this feature
            dd = len(feat_idx) - 1
            ofi, zfi = of[pi], zf[pi]
            next_one = pw[dd].copy()
            for j in range(dd - 1, -1, -1):
                tmp = pw[j].copy()
                upd = np.where(ofi != 0,
                               next_one * (dd + 1) / ((j + 1) * np.where(
                                   ofi != 0, ofi, 1.0)),
                               pw[j] * (dd + 1) / (np.where(zfi != 0, zfi,
                                                            1.0) * (dd - j)))
                pw[j] = upd
                next_one = tmp - upd * zfi * (dd - j) / (dd + 1)
            feat_idx = feat_idx[:pi] + feat_idx[pi + 1:]
            zf = np.delete(zf, pi, axis=0)
            of = np.delete(of, pi, axis=0)
            pw = pw[:-1]

        # zero fractions are child_weight/node_weight regardless of hot/cold;
        # only the one fraction depends on the row's decision
        z_left = zl * inc_zero
        o_left = np.where(hot_is_left, inc_one, 0.0)
        z_right = zr * inc_zero
        o_right = np.where(hot_is_left, 0.0, inc_one)
        recurse(lc, list(feat_idx), zf.copy(), of.copy(), pw.copy(),
                z_left, o_left, f)
        recurse(rc, list(feat_idx), zf.copy(), of.copy(), pw.copy(),
                z_right, o_right, f)

    recurse(0, [], np.zeros((0, n)), np.zeros((0, n)), np.zeros((0, n)),
            np.ones(n), np.ones(n), -1)


def _leaf_paths(tree: Tree, max_depth: int):
    """Per-leaf padded path arrays for the device TreeSHAP kernel.

    For each leaf: the root-to-leaf path compressed to UNIQUE features
    (duplicate occurrences merge exactly as TreeSHAP's unwind does: zero
    fractions multiply, hot requires every occurrence hot). Returns
      feat      (L, D) int32   unique feature per slot (-1 pad)
      zfrac     (L, D) f64     merged zero fraction per slot
      occ_node  (L, R) int32   raw path node ids (-1 pad)
      occ_left  (L, R) bool    path goes LEFT at that node
      occ_slot  (L, R) int32   unique-feature slot of the occurrence
      plen      (L,)   int32   unique path length
    """
    L = tree.num_leaves
    ni = L - 1
    parent = {}
    for i in range(ni):
        lc, rc = int(tree.left_child[i]), int(tree.right_child[i])
        parent[lc] = (i, True)
        parent[rc] = (i, False)
    D = max_depth
    feat = np.full((L, D), -1, np.int64)
    zfrac = np.ones((L, D), np.float64)
    occ_node = np.full((L, D), -1, np.int64)
    occ_left = np.zeros((L, D), bool)
    occ_slot = np.zeros((L, D), np.int64)
    plen = np.zeros(L, np.int64)
    for leaf in range(L):
        # walk up: list of (node, went_left)
        raw = []
        cur = ~leaf
        while cur in parent:
            node, went_left = parent[cur]
            raw.append((node, went_left))
            cur = node
        raw.reverse()
        slots: List[int] = []
        for r, (node, went_left) in enumerate(raw):
            f = int(tree.split_feature[node])
            w_node = _node_weight(tree, node)
            child = int(tree.left_child[node] if went_left
                        else tree.right_child[node])
            zf = _node_weight(tree, child) / w_node if w_node > 0 else 0.0
            if f in slots:
                si = slots.index(f)
            else:
                si = len(slots)
                slots.append(f)
                feat[leaf, si] = f
            zfrac[leaf, si] *= zf
            occ_node[leaf, r] = node
            occ_left[leaf, r] = went_left
            occ_slot[leaf, r] = si
        plen[leaf] = len(slots)
    return feat, zfrac, occ_node, occ_left, occ_slot, plen


def _raw_tree_depth(tree: Tree) -> int:
    L = tree.num_leaves
    depth = {0: 0}
    best = 0
    for i in range(L - 1):
        for c in (int(tree.left_child[i]), int(tree.right_child[i])):
            if c >= 0:
                depth[c] = depth[i] + 1
            else:
                best = max(best, depth[i] + 1)
    return best


def device_depth(trees: List[Tree]) -> int:
    """The trees' maximum raw depth when the device TreeSHAP can take them:
    every tree numeric and 0 < depth <= MAX_DEPTH (the kernel's per-row
    path arrays); else 0."""
    has_cat = any((np.asarray(t.decision_type[:max(t.num_leaves - 1, 0)])
                   & 1).any() for t in trees)
    max_d = max((_raw_tree_depth(t) for t in trees if t.num_leaves > 1),
                default=0)
    return max_d if trees and not has_cat and 0 < max_d <= MAX_DEPTH \
        else 0


def shap_tables(trees: List[Tree], num_class: int, max_depth: int):
    """(ShapTables of numpy arrays, (K,) expected values) of numeric trees
    for the device TreeSHAP (the contract of lightgbm_tpu/shap.py:337-397).
    Each tree with more than one leaf gets: its nodes' split feature,
    float64 threshold and decision type; its leaves' values and the packed
    paths of ``_leaf_paths`` (the unique feature and merged zero fraction
    of each slot and its reciprocal (0 where it is 0), the unique path
    length, and each raw path occurrence packed as node << 6 | slot << 1 |
    went left, -1 past the path).  A
    single-leaf tree adds only its value to its class's expected value."""
    k = max(num_class, 1)
    base = np.zeros(k)
    multi = []
    for ti, t in enumerate(trees):
        if t.num_leaves > 1:
            base[ti % k] += t.expected_value()
            multi.append((ti, t))
        else:
            base[ti % k] += t.leaf_value[0] if len(t.leaf_value) else 0.0
    T = len(multi)
    L = max((t.num_leaves for _, t in multi), default=2)
    ni = L - 1
    D = max_depth
    split_feature = np.zeros((T, ni), np.int32)
    threshold = np.full((T, ni), np.inf)
    decision_type = np.zeros((T, ni), np.int32)
    leaf_value = np.zeros((T, L))
    tree_class = np.zeros(T, np.int32)
    feat = np.full((T, L, D), -1, np.int32)
    zfrac = np.ones((T, L, D))
    occ = np.full((T, L, D), -1, np.int32)
    plen = np.zeros((T, L), np.int32)
    for i, (ti, t) in enumerate(multi):
        nt = t.num_leaves - 1
        split_feature[i, :nt] = t.split_feature[:nt]
        threshold[i, :nt] = t.threshold[:nt]
        decision_type[i, :nt] = np.asarray(t.decision_type[:nt], np.int64)
        leaf_value[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
        tree_class[i] = ti % k
        f_, z_, on_, ol_, os_, pl_ = _leaf_paths(t, D)
        feat[i, :t.num_leaves] = f_
        zfrac[i, :t.num_leaves] = z_
        occ[i, :t.num_leaves] = np.where(on_ >= 0,
                                         (on_ << 6) | (os_ << 1) | ol_, -1)
        plen[i, :t.num_leaves] = pl_
    return ShapTables(split_feature, threshold, decision_type, leaf_value,
                      tree_class, feat, zfrac, reciprocal_zfrac(zfrac), occ,
                      plen), base


def predict_contrib_device(trees: List[Tree], X: np.ndarray, num_class: int,
                           device: torch.device, max_depth: int,
                           chunk_bytes: int = CHUNK_BYTES) -> np.ndarray:
    """TreeSHAP of every row on ``device`` (``kernels/tree_shap.py``: the
    CUDA kernel on the card, its plain version on the CPU), the expected
    values added on the host; numeric trees of raw depth ``max_depth`` at
    most.  The tables go up once; the rows go up, one launch each, in
    chunks whose float64 values and (K, F + 1) contributions fit in
    ``chunk_bytes`` (``bin_rows``' upload chunk), so the device holds one
    chunk's rows and contributions at a time.  The same layout as
    ``predict_contrib``."""
    n, nf = X.shape
    k = max(num_class, 1)
    host, base = shap_tables(trees, k, max_depth)
    tables = ShapTables(*(torch.as_tensor(a).to(device) for a in host))
    rows = max(1, chunk_bytes // (8 * (nf + k * (nf + 1))))
    out = np.empty((n, k, nf + 1), np.float64)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        X_T = torch.as_tensor(np.ascontiguousarray(X[s:e].T, np.float64))
        out[s:e] = tree_shap(X_T.to(device), tables, k).cpu().numpy()
    out[:, :, nf] += base[None, :]
    if k == 1:
        return out[:, 0, :]
    return out.reshape(n, k * (nf + 1))


def predict_contrib(trees: List[Tree], X: np.ndarray, num_class: int) -> np.ndarray:
    """The exact host walk (lightgbm_tpu/shap.py:496-539, less its device
    branch): float64, rows in chunks of 16 384."""
    n, nf = X.shape
    k = max(num_class, 1)
    out = np.zeros((n, k, nf + 1), np.float64)
    for ti, tree in enumerate(trees):
        kk = ti % k
        if tree.num_leaves <= 1:
            out[:, kk, nf] += tree.leaf_value[0] if len(tree.leaf_value) else 0.0
            continue
        out[:, kk, nf] += tree.expected_value()
        # chunk rows: the batched recursion keeps O(depth^2 * chunk) copies
        # of the path arrays alive along the DFS
        for s in range(0, n, 16384):
            e = min(s + 16384, n)
            dec = _all_decisions(tree, X[s:e])
            phi = np.zeros((e - s, nf + 1), np.float64)
            _tree_shap_batch(tree, dec, phi)
            out[s:e, kk, :nf] += phi[:, :nf]
    if k == 1:
        return out[:, 0, :]
    return out.reshape(n, k * (nf + 1))
