"""Leaf-value refit on the device: the port's counterpart of
``lightgbm_tpu/refit.py`` (reference: TreeLearner::FitByExistingTree,
tree_learner.h:28-115; GBDT::RefitTree, gbdt.cpp).

``Booster.refit`` (model_io.refit_model) walks every tree over every row on
the host.  ``refit_leaf_values`` computes the same leaf values with the
card doing the walks:

* **Leaf assignment** is one K3 launch a tree (``kernels/route_replay.py``,
  the replay a sampled tree's rows take after growth): the finished tree's
  splits are turned back into per-round (L, 16) int32 route records, the
  layout the grower builds (``kernels/layout.py``), route-only, and every
  row of the refit ``Dataset`` goes through all rounds in one pass.  A
  ``Dataset`` binned with the training mappers (``reference=``) makes the
  bin comparison ``bin(v) <= thr_bin`` the host walk's ``v <=
  upper_bound[thr_bin]``, so the leaves are the host walk's, row for row.
  A tree with a categorical split, which K3 does not route, takes the
  bin-space walk of the score rebuild (``ops/predict._walk_one_tree``).
* **Leaf sums** are float64 ``np.bincount`` on the host, in row order,
  over each tree's leaf ids copied to the host once: a float64
  ``index_add_`` on the card adds in atomic order, not row order, and its
  result would differ from the CPU's.  The gradients are the objective's
  on CPU tensors, so a refit on the card equals one on the CPU byte for
  byte.  The decay blend ``decay * old + (1 - decay) * (-sum_g / (sum_h +
  l2)) * shrinkage`` is FitByExistingTree's.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .kernels.layout import build_route_tables
from .kernels.route_replay import route_replay
from .tree import DIR_DEFAULT_LEFT, Tree
from .utils.log import LightGBMError, log_debug, log_info


# ---------------------------------------------------------------------------
# the replay schedule of a finished tree
# ---------------------------------------------------------------------------

def _replay_schedule(tree: Tree, mappers) -> Optional[
        Tuple[List[List[Tuple[int, int, int, int, int]]], np.ndarray]]:
    """A grow-order replay schedule recovered from a finished tree
    (reference: lightgbm_tpu/refit.py:54-102).

    Breadth first from the root: replay leaf 0 is the root; a split at
    replay id ``l`` keeps ``l`` for its left child and gives the next fresh
    id to its right child (the grower's ids, so the records' new ids are in
    range).  The splits at depth ``d`` form replay round ``d``: siblings
    at one depth touch distinct ids.  Returns ``(rounds, iperm)``,
    ``rounds[d]`` a list of ``(replay_lid, feature, thr_bin, dir_flags,
    newid)`` and ``iperm[replay_lid]`` the tree's leaf index, or None for a
    tree K3 cannot replay (a single leaf, or a categorical split)."""
    L = tree.num_leaves
    if L < 2 or tree.num_cat > 0:
        return None
    iperm = np.zeros(L, np.int64)
    rounds: List[List[Tuple[int, int, int, int, int]]] = []
    next_id = 1
    frontier: List[Tuple[int, int]] = [(0, 0)]       # (node, replay_lid)
    while frontier:
        this_round: List[Tuple[int, int, int, int, int]] = []
        nxt: List[Tuple[int, int]] = []
        for node, lid in frontier:
            f = int(tree.split_feature[node])
            dt = int(tree.decision_type[node])
            if dt & Tree._CAT_MASK:
                return None
            # the bin-space direction flags, from the LightGBM
            # decision_type bits as models/gbdt._tree_to_device reads them
            dirf = DIR_DEFAULT_LEFT if dt & Tree._DEFAULT_LEFT_MASK else 0
            thr_bin = int(np.searchsorted(mappers[f].upper_bounds,
                                          tree.threshold[node], side="left"))
            newid = next_id
            next_id += 1
            this_round.append((lid, f, thr_bin, dirf, newid))
            for child, clid in ((int(tree.left_child[node]), lid),
                                (int(tree.right_child[node]), newid)):
                if child < 0:
                    iperm[clid] = ~child
                else:
                    nxt.append((child, clid))
        rounds.append(this_round)
        frontier = nxt
    return rounds, iperm


def _tree_depth(tree: Tree) -> int:
    """The longest root-to-leaf edge count (the fallback walk's bound)."""
    if tree.num_leaves < 2:
        return 1
    depth = {0: 1}
    best = 1
    for node in range(len(tree.split_feature)):
        d = depth.get(node, 1)
        best = max(best, d)
        for child in (int(tree.left_child[node]),
                      int(tree.right_child[node])):
            if child >= 0:
                depth[child] = d + 1
    return best


def route_records(rounds, routing, L_pad: int,
                  device: torch.device) -> torch.Tensor:
    """A replay schedule's (R, L_pad, 16) int32 route records on
    ``device``: each round's split leaves with their feature, threshold
    bin, direction flags and new id, route-only (every histogram slot -1);
    a leaf a round does not split keeps its id (reference:
    ``_build_tabs_buf``, lightgbm_tpu/refit.py:120-149)."""
    tabs = []
    none = torch.full((L_pad,), -1, dtype=torch.int64)
    for splits in rounds:
        cols = np.zeros((5, L_pad), np.int64)
        for lid, f, t, d, nid in splits:
            cols[:, lid] = (1, nid, f, t, d)
        chosen, newid, feat, thr, dirf = (torch.from_numpy(c).to(device)
                                          for c in cols)
        tabs.append(build_route_tables(chosen, newid, feat, thr, dirf,
                                       none.to(device), none.to(device),
                                       none.to(device), routing))
    if not tabs:
        return torch.zeros((0, L_pad, 16), dtype=torch.int32, device=device)
    return torch.stack(tabs)


# ---------------------------------------------------------------------------
# leaf assignment
# ---------------------------------------------------------------------------

def device_leaf_ids(trees: List[Tree], dataset) -> List[Tuple[np.ndarray,
                                                              str]]:
    """Every row's leaf in every tree, as host (N,) int64 arrays with their
    kind: ``replay`` (one K3 launch over the Dataset's (G, N) bins, 8- or
    16-bit), ``walk`` (a categorical tree, the bin-space walk) or
    ``trivial`` (a single leaf).  The record tables are padded to a
    multiple of 8 leaves (at least 8), as the JAX package pads them; K3
    stops a row at -1 only for a child outside them, which a schedule never
    makes, and that is checked."""
    from .models.gbdt import _tree_to_device
    from .ops.predict import _walk_one_tree

    dd = dataset.device_data()
    mappers = dataset.bin_mappers()
    n = dataset.num_data()
    schedules = [_replay_schedule(t, mappers) for t in trees]
    L_max = max([t.num_leaves for t in trees] + [2])
    L_pad = max(8, -(-L_max // 8) * 8)
    bins_T = dd.bins.t().contiguous()
    out: List[Tuple[np.ndarray, str]] = []
    for tree, sched in zip(trees, schedules):
        if tree.num_leaves < 2:
            out.append((np.zeros(n, np.int64), "trivial"))
            continue
        if sched is not None:
            rounds, iperm = sched
            tabs = route_records(rounds, dd.routing, L_pad, dd.device)
            lids = route_replay(bins_T, tabs)[:n].cpu().numpy()
            if n and int(lids.min()) < 0:
                raise LightGBMError("refit: a row's replay left the tree's "
                                    "records")
            out.append((iperm[lids], "replay"))
        else:
            fields, _ = _tree_to_device(tree, L_max, dd.max_bins, dataset,
                                        dd.device)
            lids = _walk_one_tree(fields, dd.bins, dd.routing,
                                  _tree_depth(tree))[:n]
            out.append((lids.cpu().numpy().astype(np.int64), "walk"))
    return out


# ---------------------------------------------------------------------------
# the refit loop (model_io.refit_model's, on a Dataset)
# ---------------------------------------------------------------------------

def refit_leaf_values(booster, dataset,
                      decay_rate: float = 0.9) -> Dict[str, Any]:
    """Refit ``booster``'s leaf values in place on ``dataset`` (labelled;
    binned with the training mappers through ``reference=`` for exact
    routing), tree after tree as the reference does: tree ``i``'s
    gradients are taken at the score of the trees refitted before it
    (reference: lightgbm_tpu/refit.py:178-272).  Returns a report: the
    trees, ``route_replay_passes`` (K3 launches), ``walk_fallback_passes``,
    ``trivial`` and ``decay_rate``."""
    from .config import Config
    from .model_io import _objective_string
    from .objectives import create_objective

    dataset.construct()
    y = dataset.get_label()
    if y is None:
        raise LightGBMError("refit requires labeled data")
    y = np.asarray(y, np.float64)
    w = dataset.get_weight()
    n = dataset.num_data()

    trees = (list(booster.engine.models) if booster._engine is not None
             else list(booster._loaded_trees.trees))
    k = booster.num_model_per_iteration()
    cfg = booster.config if booster._engine is not None else Config()
    obj_name = _objective_string(booster).split(" ")[0]
    cfg2 = copy.copy(cfg)
    cfg2.objective = obj_name if obj_name else "regression"
    try:
        obj = create_objective(cfg2)
        obj.init(y, w, n=n)
    except Exception as e:
        log_debug(f"refit: objective unavailable ({e}); leaf values kept")
        obj = None

    report = {"trees": len(trees), "route_replay_passes": 0,
              "walk_fallback_passes": 0, "trivial": 0,
              "decay_rate": float(decay_rate)}
    leaf_ids = device_leaf_ids(trees, dataset)

    score = np.zeros((n, k), np.float64)
    for i, (tree, (leaf, kind)) in enumerate(zip(trees, leaf_ids)):
        report["route_replay_passes" if kind == "replay" else
               "walk_fallback_passes" if kind == "walk" else "trivial"] += 1
        kk = i % k
        if obj is not None and tree.num_leaves >= 1:
            g, h = obj.get_gradients(torch.from_numpy(
                (score if k > 1 else score[:, 0]).astype(np.float32)))
            g, h = g.numpy(), h.numpy()
            if k > 1:
                g, h = g[:, kk], h[:, kk]
            L = tree.num_leaves
            sum_g = np.bincount(leaf, weights=g, minlength=L)
            sum_h = np.bincount(leaf, weights=h, minlength=L)
            cnt = np.bincount(leaf, minlength=L)
            new_vals = (-sum_g / (sum_h + cfg2.lambda_l2 + 1e-15)
                        * tree.shrinkage)
            tree.leaf_value = np.where(cnt > 0,
                                       decay_rate * tree.leaf_value
                                       + (1 - decay_rate) * new_vals,
                                       tree.leaf_value)
        score[:, kk] += tree.leaf_value[leaf]
    log_info(f"refit: {report['route_replay_passes']} route-replay + "
             f"{report['walk_fallback_passes']} walk-fallback + "
             f"{report['trivial']} trivial trees (decay_rate={decay_rate})")
    return report
