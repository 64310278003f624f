"""Carry a model's trees and grown tree arrays across, with no model file
between.

The JAX package's host ``tree.Tree`` holds numpy arrays; ``trees_from_arrays``
takes those fields (as dicts, e.g. ``dataclasses.asdict`` of each tree) and
builds the port's Trees, and ``booster_from_arrays`` builds a zero-round
port Booster that holds them, as ``train(params, train_set, 0,
init_model=...)`` does from model text.  ``tree_arrays_from_numpy`` takes a
grown ``TreeArrays`` of the JAX package, fetched as numpy, and builds the
port's ``TreeArrays`` of torch tensors, so that two grown trees compare
field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

from .basic import Booster, Dataset
from .config import resolve_aliases
from .tree import Tree, TreeArrays

# dtype of each array field, as the model-text reader makes them
_ARRAY_DTYPES = {
    "split_feature": np.int32, "threshold_bin": np.int32,
    "threshold": np.float64, "decision_type": np.uint8,
    "left_child": np.int32, "right_child": np.int32,
    "split_gain": np.float64, "internal_value": np.float64,
    "internal_weight": np.float64, "internal_count": np.float64,
    "leaf_value": np.float64, "leaf_weight": np.float64,
    "leaf_count": np.float64, "cat_boundaries": np.int32,
    "cat_threshold": np.uint32,
}
_TREE_FIELDS = {f.name for f in dataclasses.fields(Tree)}


def trees_from_arrays(tree_dicts: Sequence[Mapping[str, Any]]) -> List[Tree]:
    """Port Trees from per-tree field dicts (the fields of ``tree.Tree``;
    ``num_leaves`` and the node and leaf arrays are required, the rest
    default as in a model file)."""
    out = []
    for d in tree_dicts:
        unknown = set(d) - _TREE_FIELDS
        if unknown:
            raise ValueError(f"unknown tree fields {sorted(unknown)}")
        kw: Dict[str, Any] = {}
        for name, value in d.items():
            dtype = _ARRAY_DTYPES.get(name)
            kw[name] = (np.array(value, dtype) if dtype is not None
                        else _copy_value(value))
        nl = int(kw["num_leaves"])
        for name in ("split_gain", "internal_value", "internal_weight",
                     "internal_count"):
            kw.setdefault(name, np.zeros(max(nl - 1, 0)))
        for name in ("leaf_weight", "leaf_count"):
            kw.setdefault(name, np.zeros(nl))
        kw.setdefault("threshold_bin", np.zeros(max(nl - 1, 0), np.int32))
        out.append(Tree(**kw))
    return out


def _copy_value(v):
    if isinstance(v, list):
        return [list(x) if isinstance(x, list) else x for x in v]
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def booster_from_arrays(tree_dicts: Sequence[Mapping[str, Any]],
                        train_set: Dataset, params: Dict[str, Any],
                        num_tree_per_iteration: int = 1) -> Booster:
    """A zero-round Booster on ``train_set`` holding the given trees."""
    params = resolve_aliases(dict(params))
    params["num_iterations"] = 0
    if params.get("objective") is None:
        params["objective"] = "regression"
    booster = Booster(params=params, train_set=train_set)
    booster.engine.load_init_model(trees_from_arrays(tree_dicts),
                                   num_tree_per_iteration)
    return booster


# dtype of each TreeArrays field in the port
_TREE_ARRAY_DTYPES = {"cat_bitset": np.bool_, "split_gain": np.float32,
                      "internal_value": np.float32,
                      "internal_weight": np.float32,
                      "internal_count": np.float32, "leaf_value": np.float32,
                      "leaf_weight": np.float32, "leaf_count": np.float32}


def tree_arrays_from_numpy(d: Mapping[str, Any]) -> TreeArrays:
    """The port's TreeArrays (CPU torch tensors) of a grown tree given as
    numpy fields keyed by the field names of ``TreeArrays``.  Integer
    fields become int32, value fields float32, ``num_leaves`` an int."""
    import torch

    fields = {"num_leaves": int(np.asarray(d["num_leaves"]))}
    for name in TreeArrays._fields:
        if name != "num_leaves":
            dtype = _TREE_ARRAY_DTYPES.get(name, np.int32)
            fields[name] = torch.as_tensor(np.asarray(d[name]).astype(dtype))
    return TreeArrays(**fields)
