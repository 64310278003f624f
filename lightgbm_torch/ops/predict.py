"""Batched tree traversal on binned data (plain torch).

The port's counterpart of ``lightgbm_tpu/ops/predict.py:29-60`` and
``ops/grow.py::feature_local_bin`` (reference: src/boosting/
gbdt_prediction.cpp + tree.h:135).  All rows walk one tree in lockstep: a
loop of gather/select steps bounded by the tree's depth.  The reference is
plain JAX here too (no Pallas kernel), so plain torch ops are the port.
"""
from __future__ import annotations

import torch

from ..device_data import RoutingLayout
from ..kernels.layout import bin_values
from ..tree import DIR_CATEGORICAL, DIR_DEFAULT_LEFT


def feature_local_bin(group_bin: torch.Tensor, feat: torch.Tensor,
                      routing: RoutingLayout) -> torch.Tensor:
    """Map a group-local stored bin (uint8, or the int16 storage of a
    16-bit bin, read as unsigned) to the feature-local bin for per-row
    routing."""
    span_start = routing.span_start[feat]
    default_bin = routing.default_bin[feat]
    nb = routing.num_bins[feat]
    v = bin_values(group_bin)
    # bundled: the stored span holds the nb-1 non-default bins from span_start
    ls = v - span_start
    in_span = (ls >= 0) & (ls < nb - 1)
    fb_b = torch.where(in_span, ls + (ls >= default_bin).to(torch.int32),
                       default_bin)
    return torch.where(routing.bundled[feat], fb_b, v)


def _walk_one_tree(tree_slice, bins: torch.Tensor, routing: RoutingLayout,
                   max_depth: int) -> torch.Tensor:
    """Leaf index per row for one tree.  ``tree_slice`` = (split_feature,
    threshold_bin, dir_flags, left_child, right_child, cat_bitset), padded
    bin-space arrays of one tree (models/gbdt._tree_to_device)."""
    (split_feature, threshold_bin, dir_flags, left_child, right_child,
     cat_bitset) = tree_slice
    n = bins.shape[0]
    bmax = cat_bitset.shape[-1]
    flat_bits = cat_bitset.reshape(-1)
    node = torch.zeros(n, dtype=torch.int32, device=bins.device)
    for _ in range(max_depth):
        active = node >= 0
        ni = node.clamp(min=0).long()
        f = split_feature[ni].long()
        grp = routing.feat_group[f].long()
        gb = torch.gather(bins, 1, grp[:, None])[:, 0]
        fb = feature_local_bin(gb, f, routing)
        d = dir_flags[ni]
        is_cat = (d & DIR_CATEGORICAL) != 0
        default_left = (d & DIR_DEFAULT_LEFT) != 0
        nan_bin = routing.nan_bin[f]
        is_nan = (nan_bin >= 0) & (fb == nan_bin)
        go_left_num = torch.where(is_nan, default_left, fb <= threshold_bin[ni])
        go_left_cat = flat_bits[ni * bmax + fb.long()]
        go_left = torch.where(is_cat, go_left_cat, go_left_num)
        nxt = torch.where(go_left, left_child[ni], right_child[ni])
        node = torch.where(active, nxt, node)
    # trivial trees (num_leaves <= 1, zero-filled child arrays) never reach a
    # negative child; resolve those rows to leaf 0 instead of gathering padding
    return torch.where(node < 0, ~node, torch.zeros_like(node))
