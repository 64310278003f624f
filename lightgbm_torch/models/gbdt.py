"""The boosting engine, minimal: holds a model and its training data.

The port's counterpart of ``lightgbm_tpu/models/gbdt.py`` (reference:
src/boosting/gbdt.h GBDT).  Batch prediction needs the engine for what it
holds: the training Dataset (its bin mappers and routing layout), the
objective, the trees and the output averaging.  ``load_init_model`` seeds it
with an existing model and rebuilds the training score with the bin-space
tree walk, as continued training does in the reference (gbdt.py:2542-2598).
Growing trees comes with training: ``train_one_iter`` raises.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..device_data import DeviceData
from ..kernels.predict import tree_max_depth
from ..objectives import ObjectiveFunction
from ..ops.predict import _walk_one_tree
from ..tree import DIR_CATEGORICAL, DIR_DEFAULT_LEFT, Tree
from ..utils.log import LightGBMError


class GBDT:
    """The main booster (reference: src/boosting/gbdt.h GBDT class)."""

    boosting_type = "gbdt"
    _average_output = False

    def __init__(self, config: Config, train_data,
                 objective: Optional[ObjectiveFunction]):
        self.config = config
        self.train_data = train_data          # basic.Dataset (constructed)
        self.objective = objective
        self.models: List[Tree] = []          # host trees, iteration-major
        self.iter_ = 0
        self.num_class = config.num_class
        self.num_tree_per_iteration = (objective.num_model_per_iteration
                                       if objective is not None
                                       else config.num_class)
        self.dd: DeviceData = train_data.device_data()
        self.device = self.dd.device
        self.num_data = train_data.num_data()
        k = self.num_tree_per_iteration
        n_pad = self.dd.bins.shape[0]
        self._score_shape = (n_pad,) if k == 1 else (n_pad, k)
        self.score = torch.zeros(self._score_shape, dtype=torch.float32,
                                 device=self.device)
        self.init_scores = [0.0] * k

    def train_one_iter(self, *args, **kwargs) -> bool:
        raise LightGBMError("training is not yet ported to lightgbm_torch; "
                            "train(..., num_boost_round=0, init_model=...) "
                            "serves an existing model")

    def load_init_model(self, trees: List[Tree],
                        num_tree_per_iteration: int) -> None:
        """Seed the engine with an existing model's trees and rebuild the
        training score (reference: GBDT::ResetTrainingData +
        model-continuation init, src/boosting/gbdt.cpp:259-263)."""
        k = self.num_tree_per_iteration
        if num_tree_per_iteration != k:
            raise LightGBMError(
                f"init_model has {num_tree_per_iteration} trees/iteration but "
                f"this training run needs {k}")
        if len(trees) % k != 0:
            raise LightGBMError("init_model tree count is not a multiple of "
                                "num_tree_per_iteration")
        budget = self.config.num_leaves
        worst = max((t.num_leaves for t in trees), default=0)
        if worst > budget:
            raise LightGBMError(
                f"init_model contains a tree with {worst} leaves but this "
                f"training run's num_leaves budget is {budget}; continue with "
                f"num_leaves >= {worst}")
        self.models = list(trees)
        self.iter_ = len(trees) // k
        # loaded trees already contain the folded init bias (AddBias at save
        # time), so the restored score is exactly the summed tree outputs plus
        # any user-provided init_score offsets
        score = torch.zeros(self._score_shape, dtype=torch.float32,
                            device=self.device)
        base = self.train_data.get_init_score_padded(self._score_shape[0], k)
        if base is not None:
            score = score + torch.as_tensor(base, device=self.device)
        for it in range(self.iter_):
            for kk in range(k):
                score = self._add_tree_to_score(
                    score, self.models[it * k + kk], self.dd, kk)
        self.score = score
        # prevent re-folding the from-average bias into future first trees
        self.init_scores = [0.0] * k

    def _add_tree_to_score(self, score: torch.Tensor, tree: Tree,
                           dd: DeviceData, kk: int) -> torch.Tensor:
        fields, leaf_value = _tree_to_device(tree, self.config.num_leaves,
                                             dd.max_bins, self.train_data,
                                             dd.device)
        # the walk is stationary once a row reaches its leaf, so the tree's
        # exact depth gives the same leaves as the reference's num_leaves
        # bound in fewer steps
        leaf = _walk_one_tree(fields, dd.bins, dd.routing,
                              tree_max_depth(tree))
        delta = leaf_value[leaf.long()]
        if score.dim() == 1:
            return score + delta
        score = score.clone()
        score[:, kk] += delta
        return score

    def _trim_trailing_trivial(self) -> None:
        """Drop trailing no-op iterations (every class tree single-leaf with
        zero output) (reference: gbdt.cpp:436-447 stops without keeping the
        splitless tree)."""
        k = self.num_tree_per_iteration
        while self.iter_ > 0 and len(self.models) >= k:
            tail = self.models[-k:]
            if not all(t.num_leaves <= 1 and all(v == 0.0 for v in t.leaf_value)
                       for t in tail):
                break
            del self.models[-k:]
            self.iter_ -= 1


def _tree_to_device(tree: Tree, num_leaves_budget: int, max_bins: int,
                    train_data, device: torch.device):
    """Host Tree -> padded bin-space tensors for score walks: ((split_feature,
    threshold_bin, dir_flags, left_child, right_child, cat_bitset),
    leaf_value f32)."""
    L = num_leaves_budget
    Bmax = max_bins

    def pad1(a, size, dtype, fill=0):
        out = np.full(size, fill, dtype)
        out[:len(a)] = a
        return out

    n_int = len(tree.split_feature)
    dirf = np.zeros(n_int, np.int32)
    cat_bits = np.zeros((L, Bmax), bool)
    mappers = train_data.bin_mappers()
    thr_bin = np.asarray(tree.threshold_bin, np.int64).copy()
    for i in range(n_int):
        dt = int(tree.decision_type[i])
        f = int(tree.split_feature[i])
        m = mappers[f]
        if dt & 1:
            dirf[i] |= DIR_CATEGORICAL
            # rebuild the bin-space bitset from the category-value bitset
            kcat = int(tree.threshold_bin[i])
            s, e = tree.cat_boundaries[kcat], tree.cat_boundaries[kcat + 1]
            words = tree.cat_threshold[s:e]
            for b, c in enumerate(m.categories):
                c = int(c)
                if c // 32 < len(words) and (int(words[c // 32]) >> (c % 32)) & 1:
                    cat_bits[i, b] = True
        else:
            if dt & 2:
                dirf[i] |= DIR_DEFAULT_LEFT
            # bin threshold from the real threshold
            thr_bin[i] = int(np.searchsorted(m.upper_bounds, tree.threshold[i],
                                             side="left"))

    def t(a):
        return torch.as_tensor(a, device=device)

    fields = (t(pad1(tree.split_feature, L, np.int32)),
              t(pad1(thr_bin, L, np.int32)),
              t(pad1(dirf, L, np.int32)),
              t(pad1(tree.left_child, L, np.int32)),
              t(pad1(tree.right_child, L, np.int32)),
              t(cat_bits))
    return fields, t(pad1(tree.leaf_value, L, np.float32))


def create_boosting(config: Config, train_data, objective) -> GBDT:
    """reference: Boosting::CreateBoosting (boosting.cpp:42); gbdt only."""
    t = config.boosting
    if t in ("gbdt", "gbrt"):
        return GBDT(config, train_data, objective)
    raise LightGBMError(f"boosting={t!r} is not yet ported to lightgbm_torch")
