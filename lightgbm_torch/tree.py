"""Tree model structure (host side).

The port's copy of ``lightgbm_tpu/tree.py``'s host ``Tree`` (reference:
include/LightGBM/tree.h:27 — flat-array binary tree: split feature, bin + real
thresholds, child pointers with ~leaf encoding, leaf values/counts,
categorical bitsets; src/io/tree.cpp serialization).  ``predict_raw`` is the
float64 host walk that the device kernels are held against.  The grower's
``TreeArrays`` and ``finalize_tree`` (reference: tree.py:205) turn a grown
tree into a host ``Tree``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional

import numpy as np

# bin-space direction flags of a split (reference: lightgbm_tpu ops/split.py
# DIR_*), used by the bin-space tree arrays of models/gbdt._tree_to_device
DIR_DEFAULT_LEFT = 1   # missing values go left
DIR_CATEGORICAL = 2    # categorical split


class TreeArrays(NamedTuple):
    """A grown tree in bin space, node and leaf arrays padded to the
    num_leaves budget L (reference: tree.py TreeArrays).  Child pointers: a
    value >= 0 is an internal node, a value < 0 encodes leaf ~value.  The
    arrays are torch tensors while the tree lives on the device and numpy
    arrays after the transfer; ``num_leaves`` is a Python int."""
    split_feature: Any      # (L,) i32
    threshold_bin: Any      # (L,) i32 feature-local bin, left = bin <= t
    dir_flags: Any          # (L,) i32 DIR_* bits
    left_child: Any         # (L,) i32
    right_child: Any        # (L,) i32
    split_gain: Any         # (L,) f32
    internal_value: Any     # (L,) f32 node output if it were a leaf
    internal_weight: Any    # (L,) f32 sum of hessians
    internal_count: Any     # (L,) f32
    cat_bitset: Any         # (L, Bmax) bool left-side bins
    leaf_value: Any         # (L,) f32
    leaf_weight: Any        # (L,) f32
    leaf_count: Any         # (L,) f32
    leaf_parent: Any        # (L,) i32 node index, -1 for the root
    num_leaves: int
    leaf_depth: Any         # (L,) i32


@dataclass
class Tree:
    """Host-side tree with real-valued thresholds (model IO + raw prediction).

    ``shrinkage`` records the cumulative learning-rate factor applied to leaf values
    (reference: Tree::Shrinkage, tree.h)."""

    num_leaves: int
    split_feature: np.ndarray        # (num_leaves-1,) int32
    threshold_bin: np.ndarray        # (num_leaves-1,) int32
    threshold: np.ndarray            # (num_leaves-1,) float64 — real split value
    decision_type: np.ndarray        # (num_leaves-1,) uint8 — LightGBM-compatible bits
    left_child: np.ndarray
    right_child: np.ndarray
    split_gain: np.ndarray
    internal_value: np.ndarray
    internal_weight: np.ndarray
    internal_count: np.ndarray
    leaf_value: np.ndarray           # (num_leaves,) float64
    leaf_weight: np.ndarray
    leaf_count: np.ndarray
    cat_boundaries: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    cat_threshold: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    shrinkage: float = 1.0
    is_linear: bool = False
    # linear-tree fields (reference: tree.h leaf_const_/leaf_coeff_/leaf_features_)
    leaf_const: Optional[np.ndarray] = None        # (num_leaves,) float64
    leaf_features: Optional[List[List[int]]] = None
    leaf_coeff: Optional[List[List[float]]] = None

    # LightGBM decision_type bit layout (reference: tree.h kCategoricalMask etc.)
    _CAT_MASK = 1
    _DEFAULT_LEFT_MASK = 2
    # missing type in bits 2-3: 0 none, 1 zero, 2 nan
    @staticmethod
    def make_decision_type(is_cat: bool, default_left: bool, missing_type: int) -> int:
        d = 0
        if is_cat:
            d |= Tree._CAT_MASK
        if default_left:
            d |= Tree._DEFAULT_LEFT_MASK
        d |= (missing_type & 3) << 2
        return d

    def shrink(self, rate: float) -> None:
        """Scale the outputs by the learning rate (reference: Tree::Shrinkage);
        a linear tree's constants and coefficients too."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        self.shrinkage *= rate
        if self.is_linear and self.leaf_const is not None:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [[c * rate for c in cs] for cs in self.leaf_coeff]

    def add_bias(self, bias: float) -> None:
        """Fold a constant into the tree (reference: Tree::AddBias, used by
        boost_from_average so saved models are self-contained)."""
        self.leaf_value = self.leaf_value + bias
        self.internal_value = self.internal_value + bias
        if self.is_linear and self.leaf_const is not None:
            self.leaf_const = self.leaf_const + bias

    @property
    def num_cat(self) -> int:
        return int(len(self.cat_boundaries) - 1) if len(self.cat_threshold) else 0

    # ------------------------------------------------------------------
    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """Vectorised raw-feature prediction (reference: Tree::Predict / tree.h:135
        NumericalDecision: missing handling + `value <= threshold` goes left)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.full(n, self.leaf_value[0] if len(self.leaf_value) else 0.0)
        node = np.zeros(n, dtype=np.int64)
        out_leaf = np.full(n, -1, dtype=np.int64)
        active = node >= 0
        # max path length bounded by number of internal nodes
        for _ in range(self.num_leaves - 1):
            if not active.any():
                break
            idx = node[active]
            f = self.split_feature[idx]
            v = X[active, f]
            dt = self.decision_type[idx]
            is_cat = (dt & self._CAT_MASK) != 0
            default_left = (dt & self._DEFAULT_LEFT_MASK) != 0
            missing_type = (dt >> 2) & 3
            nan_mask = np.isnan(v)
            zero_missing = missing_type == 1
            nan_missing = missing_type == 2
            miss = (zero_missing & (nan_mask | (np.abs(v) < 1e-35))) \
                | (nan_missing & nan_mask)
            # NumericalDecision: a NaN at a node whose missing type is not
            # NaN is compared as 0.0
            go_left = np.where(nan_mask & ~nan_missing, 0.0, v) \
                <= self.threshold[idx]
            # categorical: membership in bitset
            if is_cat.any():
                ci = idx[is_cat]
                vi = v[is_cat]
                iv = np.where(np.isnan(vi), -1, vi).astype(np.int64)
                gl = np.zeros(len(ci), dtype=bool)
                for j, (node_i, cat_v) in enumerate(zip(ci, iv)):
                    k = self._cat_index_of_node(node_i)
                    if k >= 0 and cat_v >= 0:
                        s, e = self.cat_boundaries[k], self.cat_boundaries[k + 1]
                        word = cat_v // 32
                        if word < e - s:
                            gl[j] = bool((self.cat_threshold[s + word] >> (cat_v % 32)) & 1)
                go_left[is_cat] = gl
                miss = miss & ~is_cat
            go_left = np.where(miss, default_left, go_left)
            nxt = np.where(go_left, self.left_child[idx], self.right_child[idx])
            leaf_hit = nxt < 0
            sel = np.where(active)[0]
            out_leaf[sel[leaf_hit]] = ~nxt[leaf_hit]
            node[sel] = nxt
            active = node >= 0
        out_leaf = np.where(out_leaf < 0, 0, out_leaf)
        if self.is_linear and self.leaf_const is not None:
            return self._linear_output(X, out_leaf)
        return self.leaf_value[out_leaf]

    def _linear_output(self, X: np.ndarray, leaf: np.ndarray) -> np.ndarray:
        """Linear-leaf prediction: const + coeff . x; rows with NaN in any
        used feature fall back to the regular constant leaf output
        (reference: Tree::Predict linear branch, tree.h)."""
        out = self.leaf_const[leaf].astype(np.float64).copy()
        for ln in range(self.num_leaves):
            feats = self.leaf_features[ln] if self.leaf_features else []
            rows = np.where(leaf == ln)[0]
            if len(rows) == 0 or not feats:
                continue
            sub = X[np.ix_(rows, feats)]
            nan_rows = np.isnan(sub).any(axis=1)
            lin = sub @ np.asarray(self.leaf_coeff[ln], np.float64)
            out[rows] = np.where(nan_rows, self.leaf_value[ln],
                                 out[rows] + lin)
        return out

    def predict_leaf_raw(self, X: np.ndarray) -> np.ndarray:
        """Leaf index per row (pred_leaf path)."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        saved = self.leaf_value
        try:
            self.leaf_value = np.arange(self.num_leaves, dtype=np.float64)
            return self.predict_raw(X).astype(np.int32)
        finally:
            self.leaf_value = saved

    def _cat_index_of_node(self, node_i: int) -> int:
        """Index into cat_boundaries for a categorical node: the threshold_bin field of a
        categorical node stores its categorical-split ordinal."""
        return int(self.threshold_bin[node_i])

    # -- SHAP-style expected-value helpers ------------------------------
    def expected_value(self) -> float:
        if self.num_leaves <= 1:
            return float(self.leaf_value[0]) if len(self.leaf_value) else 0.0
        total = self.internal_count[0] if len(self.internal_count) else 0
        if total <= 0:
            return 0.0
        return float(np.sum(self.leaf_value[:self.num_leaves] *
                            self.leaf_count[:self.num_leaves]) / max(total, 1.0))


def finalize_tree(arrays: TreeArrays, bin_mappers,
                  learning_rate: float = 1.0) -> Tree:
    """Host Tree of numpy TreeArrays: bin thresholds become real thresholds
    (the bin's upper bound), bin bitsets become category-value bitsets, the
    padding is trimmed, and the leaf values are shrunk by the learning rate
    (reference: tree.py finalize_tree)."""
    nl = int(arrays.num_leaves)
    ni = max(nl - 1, 0)
    split_feature = np.asarray(arrays.split_feature[:ni], np.int32)
    thr_bin = np.asarray(arrays.threshold_bin[:ni], np.int32)
    dirf = np.asarray(arrays.dir_flags[:ni], np.int32)
    cat_bits = (np.asarray(arrays.cat_bitset[:ni]) if ni
                else np.zeros((0, 1), bool))
    threshold = np.zeros(ni, np.float64)
    decision_type = np.zeros(ni, np.uint8)
    cat_boundaries = [0]
    cat_words: List[np.ndarray] = []
    thr_out = thr_bin.copy()
    n_cat = 0
    for i in range(ni):
        m = bin_mappers[int(split_feature[i])]
        if dirf[i] & DIR_CATEGORICAL:
            left_bins = np.where(cat_bits[i])[0]
            cats = m.categories[left_bins[left_bins < len(m.categories)]]
            words = np.zeros(int(cats.max()) // 32 + 1 if len(cats) else 1,
                             np.uint32)
            for c in cats:
                words[int(c) // 32] |= np.uint32(1 << (int(c) % 32))
            cat_words.append(words)
            cat_boundaries.append(cat_boundaries[-1] + len(words))
            thr_out[i] = n_cat
            threshold[i] = float(n_cat)
            n_cat += 1
            decision_type[i] = Tree.make_decision_type(True, False, 0)
        else:
            threshold[i] = m.bin_to_threshold(int(thr_bin[i]))
            decision_type[i] = Tree.make_decision_type(
                False, bool(dirf[i] & DIR_DEFAULT_LEFT), int(m.missing_type))

    def f64(a, size):
        return np.asarray(a[:size], np.float64)

    tree = Tree(
        num_leaves=max(nl, 1), split_feature=split_feature,
        threshold_bin=thr_out, threshold=threshold,
        decision_type=decision_type,
        left_child=np.asarray(arrays.left_child[:ni], np.int32),
        right_child=np.asarray(arrays.right_child[:ni], np.int32),
        split_gain=f64(arrays.split_gain, ni),
        internal_value=f64(arrays.internal_value, ni),
        internal_weight=f64(arrays.internal_weight, ni),
        internal_count=f64(arrays.internal_count, ni),
        leaf_value=f64(arrays.leaf_value, max(nl, 1)),
        leaf_weight=f64(arrays.leaf_weight, max(nl, 1)),
        leaf_count=f64(arrays.leaf_count, max(nl, 1)),
        cat_boundaries=np.asarray(cat_boundaries, np.int32),
        cat_threshold=(np.concatenate(cat_words) if cat_words
                       else np.zeros(0, np.uint32)))
    if learning_rate != 1.0:
        tree.shrink(learning_rate)
    return tree
