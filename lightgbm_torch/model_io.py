"""Model serialization in the LightGBM text format (read AND write).

The port's copy of ``lightgbm_tpu/model_io.py``: the same reader and writer,
and the same JSON dump (``dump_model_dict``),
so a model round-trips to the same bytes through either package.

Reference: src/boosting/gbdt_model_text.cpp:315 (SaveModelToString), src/io/tree.cpp
(Tree::ToString / Tree constructor-from-string). Writing the reference's exact format
gives free interop: models trained here load in stock LightGBM and vice versa, and the
format doubles as a golden-file test oracle.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from .binning import BIN_CATEGORICAL
from .tree import Tree
from .utils.log import LightGBMError, log_warning

_MODEL_VERSION = "v4"


def _fmt_double(x: float) -> str:
    """High-precision repr that round-trips (reference: ArrayToString<true>)."""
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return repr(float(x))


def _join(arr, fmt=str) -> str:
    return " ".join(fmt(x) for x in arr)


def _objective_string(booster) -> str:
    if booster._engine is not None and booster.engine.objective is not None:
        obj = booster.engine.objective
        name = obj.name
        c = booster.config
        if name == "binary":
            return f"binary sigmoid:{c.sigmoid:g}"
        if name in ("multiclass", "multiclassova"):
            return f"{name} num_class:{c.num_class}"
        if name in ("quantile", "huber"):
            return f"{name} alpha:{c.alpha:g}"
        if name == "fair":
            return f"fair fair_c:{c.fair_c:g}"
        if name == "tweedie":
            return f"tweedie tweedie_variance_power:{c.tweedie_variance_power:g}"
        return name
    if booster._loaded_trees is not None:
        return booster._loaded_trees.objective_string
    return "regression"


def _feature_infos(booster) -> List[str]:
    if booster._engine is None:
        lt = booster._loaded_trees
        return lt.feature_infos if lt.feature_infos else \
            ["none"] * (lt.max_feature_idx + 1)
    infos = []
    for m in booster.train_set.bin_mappers():
        if m.is_trivial:
            infos.append("none")
        elif m.bin_type == BIN_CATEGORICAL:
            infos.append(":".join(str(int(c)) for c in m.categories))
        else:
            # reference: [min_val:max_val] of the sampled data
            # (gbdt_model_text.cpp writes BinMapper min/max)
            lo, hi = float(m.min_val), float(m.max_val)
            if lo == 0.0 and hi == 0.0 and len(m.upper_bounds):
                ub = m.upper_bounds
                lo = float(ub[0])
                hi = float(ub[-2]) if len(ub) >= 2 else lo
            infos.append(f"[{_fmt_double(lo)}:{_fmt_double(hi)}]")
    return infos


def tree_to_string(tree: Tree, index: int) -> str:
    nl = tree.num_leaves
    ni = max(nl - 1, 0)
    lines = [f"Tree={index}"]
    lines.append(f"num_leaves={nl}")
    lines.append(f"num_cat={tree.num_cat}")
    if ni:
        lines.append("split_feature=" + _join(tree.split_feature.astype(int)))
        lines.append("split_gain=" + _join(tree.split_gain, lambda x: f"{x:g}"))
        # categorical nodes store the cat ordinal in threshold
        lines.append("threshold=" + _join(tree.threshold, _fmt_double))
        lines.append("decision_type=" + _join(tree.decision_type.astype(int)))
        lines.append("left_child=" + _join(tree.left_child.astype(int)))
        lines.append("right_child=" + _join(tree.right_child.astype(int)))
    else:
        for key in ("split_feature", "split_gain", "threshold", "decision_type",
                    "left_child", "right_child"):
            lines.append(f"{key}=")
    lines.append("leaf_value=" + _join(tree.leaf_value, _fmt_double))
    lines.append("leaf_weight=" + _join(tree.leaf_weight, _fmt_double))
    lines.append("leaf_count=" + _join(np.asarray(tree.leaf_count).astype(int)))
    if ni:
        lines.append("internal_value=" + _join(tree.internal_value, lambda x: f"{x:g}"))
        lines.append("internal_weight=" + _join(tree.internal_weight, lambda x: f"{x:g}"))
        lines.append("internal_count=" + _join(np.asarray(tree.internal_count).astype(int)))
    else:
        lines.append("internal_value=")
        lines.append("internal_weight=")
        lines.append("internal_count=")
    if tree.num_cat > 0:
        lines.append("cat_boundaries=" + _join(tree.cat_boundaries.astype(int)))
        lines.append("cat_threshold=" + _join(tree.cat_threshold.astype(int)))
    lines.append(f"is_linear={1 if tree.is_linear else 0}")
    if tree.is_linear and tree.leaf_const is not None:
        # reference grammar: src/io/tree.cpp:384-408
        lines.append("leaf_const=" + _join(tree.leaf_const,
                                           lambda x: f"{x:.17g}"))
        nf = [len(c) for c in (tree.leaf_coeff or [[]] * tree.num_leaves)]
        lines.append("num_features=" + _join(np.asarray(nf)))
        parts = []
        for i in range(tree.num_leaves):
            if nf[i] > 0:
                parts.append(" ".join(str(int(f))
                                      for f in tree.leaf_features[i]) + " ")
            parts.append(" ")
        lines.append("leaf_features=" + "".join(parts).rstrip())
        parts = []
        for i in range(tree.num_leaves):
            if nf[i] > 0:
                parts.append(" ".join(f"{c:.17g}"
                                      for c in tree.leaf_coeff[i]) + " ")
            parts.append(" ")
        lines.append("leaf_coeff=" + "".join(parts).rstrip())
    lines.append(f"shrinkage={tree.shrinkage:g}")
    lines.append("")
    lines.append("")
    return "\n".join(lines)


def save_model_string(booster, num_iteration: Optional[int] = None,
                      start_iteration: int = 0,
                      importance_type: str = "split") -> str:
    trees = booster._all_trees()
    k = booster.num_model_per_iteration()
    total_iteration = len(trees) // max(k, 1)
    start_iteration = max(0, min(start_iteration, total_iteration))
    if num_iteration is None:
        # LightGBM semantics (basic.py save_model): None -> best_iteration if set
        bi = getattr(booster, "best_iteration", -1)
        num_iteration = bi if bi and bi > 0 else None
    if num_iteration is not None and num_iteration > 0:
        end = min(start_iteration + num_iteration, total_iteration)
    else:
        end = total_iteration
    use = trees[start_iteration * k:end * k]

    num_class = (booster.config.num_class if booster._engine is not None
                 else booster._loaded_trees.num_class)
    feature_names = booster.feature_name()

    lines = ["tree"]
    lines.append(f"version={_MODEL_VERSION}")
    lines.append(f"num_class={num_class}")
    lines.append(f"num_tree_per_iteration={k}")
    lines.append("label_index=0")
    lines.append(f"max_feature_idx={booster.num_feature() - 1}")
    lines.append(f"objective={_objective_string(booster)}")
    if booster._average_output():
        lines.append("average_output")
    lines.append("feature_names=" + " ".join(feature_names))
    lines.append("feature_infos=" + " ".join(_feature_infos(booster)))

    tree_strs = [tree_to_string(t, i) for i, t in enumerate(use)]
    tree_sizes = [len(s) + 1 for s in tree_strs]  # +1 for the joining newline
    lines.append("tree_sizes=" + _join(tree_sizes))
    lines.append("")
    body = "\n".join(lines) + "\n"
    body += "\n".join(tree_strs)
    if tree_strs:
        body += "\n"
    body += "end of trees\n"

    imp = booster.feature_importance(importance_type)
    pairs = sorted(((int(v), feature_names[i]) for i, v in enumerate(imp) if v > 0),
                   key=lambda p: -p[0])
    body += "\nfeature_importances:\n"
    for v, name in pairs:
        body += f"{name}={v}\n"
    body += "\nparameters:\n"
    params = booster.params if isinstance(getattr(booster, "params", None), dict) else {}
    for key, val in sorted(params.items()):
        body += f"[{key}: {val}]\n"
    body += "end of parameters\n"
    # training DataFrame category lists, so predict-time frames remap their
    # codes to training's (reference: basic.py dump pandas_categorical)
    if booster._engine is not None:
        pc = booster.engine.train_data.pandas_categorical
    else:
        pc = booster._loaded_trees.pandas_categorical
    if pc is not None:
        import json as _json

        def _json_default(o):
            # numpy scalars keep their numeric identity; anything else
            # (datetimes etc.) stringifies — predict-time alignment
            # str()-matches those (basic.py _to_2d_float)
            if isinstance(o, np.integer):
                return int(o)
            if isinstance(o, np.floating):
                return float(o)
            return str(o)

        body += ("\npandas_categorical:"
                 + _json.dumps(pc, default=_json_default) + "\n")
    else:
        body += "\npandas_categorical:null\n"
    return body


class LoadedModel:
    """Parsed model file (used when no training engine is attached)."""

    def __init__(self):
        self.trees: List[Tree] = []
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.objective_string = "regression"
        self.average_output = False
        self.parameters: Dict[str, str] = {}
        self.pandas_categorical = None

    def convert_output(self, raw):
        obj = self.objective_string.split(" ")[0] if self.objective_string else ""
        return self._convert(obj, raw)

    def _convert(self, obj, raw):
        if obj == "binary":
            sigmoid = 1.0
            for part in self.objective_string.split(" ")[1:]:
                if part.startswith("sigmoid:"):
                    sigmoid = float(part.split(":")[1])
            return 1.0 / (1.0 + np.exp(-sigmoid * np.asarray(raw)))
        if obj == "multiclass":
            e = np.exp(raw - np.max(raw, axis=-1, keepdims=True))
            return e / e.sum(axis=-1, keepdims=True)
        if obj == "multiclassova":
            p = 1.0 / (1.0 + np.exp(-np.asarray(raw)))
            return p / p.sum(axis=-1, keepdims=True)
        if obj in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        if obj == "cross_entropy":
            return 1.0 / (1.0 + np.exp(-np.asarray(raw)))
        if obj == "cross_entropy_lambda":
            return np.log1p(np.exp(raw))
        return raw


def _parse_array(s: str, dtype):
    s = s.strip()
    if not s:
        return np.zeros(0, dtype)
    return np.asarray([dtype(x) for x in s.split(" ") if x], dtype=dtype)


def load_model_string(model_str: str) -> LoadedModel:
    lines = model_str.split("\n")
    if not lines or lines[0].strip() != "tree":
        raise LightGBMError("Model string is not a LightGBM model "
                            "(missing 'tree' header)")
    lm = LoadedModel()
    for ln in reversed(lines[-8:]):
        ln = ln.strip()
        if ln.startswith("pandas_categorical:"):
            payload = ln[len("pandas_categorical:"):]
            if payload and payload != "null":
                import json as _json
                try:
                    lm.pandas_categorical = _json.loads(payload)
                except ValueError:
                    pass
            break
    i = 0
    end_seen = False
    # header
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line.startswith("Tree="):
            i -= 1
            break
        if line == "end of trees":
            end_seen = True
            break
        if "=" in line:
            key, _, val = line.partition("=")
            if key == "num_class":
                lm.num_class = int(val)
            elif key == "num_tree_per_iteration":
                lm.num_tree_per_iteration = int(val)
            elif key == "max_feature_idx":
                lm.max_feature_idx = int(val)
            elif key == "objective":
                lm.objective_string = val
            elif key == "feature_names":
                lm.feature_names = val.split(" ") if val else []
            elif key == "feature_infos":
                lm.feature_infos = val.split(" ") if val else []
        elif line == "average_output":
            lm.average_output = True

    # trees
    while i < len(lines):
        line = lines[i].strip()
        if line == "end of trees":
            end_seen = True
            break
        if not line.startswith("Tree="):
            i += 1
            continue
        block: Dict[str, str] = {}
        i += 1
        while i < len(lines):
            ln = lines[i].strip()
            if not ln:
                i += 1
                if i < len(lines) and (lines[i].strip().startswith("Tree=")
                                       or lines[i].strip() == "end of trees"):
                    break
                continue
            if ln.startswith("Tree=") or ln == "end of trees":
                break
            key, _, val = ln.partition("=")
            block[key] = val
            i += 1
        lm.trees.append(_tree_from_block(block, len(lm.trees)))
    if not end_seen:
        # a complete save always writes the marker (save_model_string) —
        # its absence means the file was cut mid-write or mid-copy
        raise LightGBMError(
            f"truncated model text: missing 'end of trees' marker after "
            f"{len(lm.trees)} parsed tree(s)")
    return lm


def _tree_from_block(block: Dict[str, str], index: int = 0) -> Tree:
    try:
        return _tree_from_block_checked(block, index)
    except (KeyError, ValueError, IndexError) as e:
        # a cleanly saved model never produces these — a half-written line,
        # a missing array, or a garbled count means the text was cut/corrupt
        raise LightGBMError(
            f"truncated model text: tree {index} block is incomplete or "
            f"corrupt ({type(e).__name__}: {e})")


def _check_tree_arrays(block: Dict[str, str], index: int, nl: int,
                       t: Tree) -> None:
    ni = max(nl - 1, 0)
    wants = (("leaf_value", t.leaf_value, nl),
             ("split_feature", t.split_feature, ni),
             ("threshold", t.threshold, ni),
             ("decision_type", t.decision_type, ni),
             ("left_child", t.left_child, ni),
             ("right_child", t.right_child, ni))
    for name, arr, want in wants:
        if len(arr) != want:
            raise LightGBMError(
                f"truncated model text: tree {index} has {len(arr)} "
                f"{name} entries but num_leaves={nl} needs {want}")


def _tree_from_block_checked(block: Dict[str, str], index: int) -> Tree:
    nl = int(block.get("num_leaves", "1"))
    if nl < 1:
        raise LightGBMError(
            f"truncated model text: tree {index} has num_leaves={nl}")
    num_cat = int(block.get("num_cat", "0"))
    thr = _parse_array(block.get("threshold", ""), float)
    t = Tree(
        num_leaves=nl,
        split_feature=_parse_array(block.get("split_feature", ""), int).astype(np.int32),
        threshold_bin=thr.astype(np.int32) if len(thr) else np.zeros(0, np.int32),
        threshold=thr.astype(np.float64),
        decision_type=_parse_array(block.get("decision_type", ""), int).astype(np.uint8),
        left_child=_parse_array(block.get("left_child", ""), int).astype(np.int32),
        right_child=_parse_array(block.get("right_child", ""), int).astype(np.int32),
        split_gain=_parse_array(block.get("split_gain", ""), float),
        internal_value=_parse_array(block.get("internal_value", ""), float),
        internal_weight=_parse_array(block.get("internal_weight", ""), float),
        internal_count=_parse_array(block.get("internal_count", ""), float),
        leaf_value=_parse_array(block.get("leaf_value", ""), float),
        leaf_weight=_parse_array(block.get("leaf_weight", ""), float),
        leaf_count=_parse_array(block.get("leaf_count", ""), float),
        shrinkage=float(block.get("shrinkage", "1")),
        is_linear=bool(int(block.get("is_linear", "0"))),
        leaf_const=(np.asarray([float(v) for v in
                                block["leaf_const"].split()])
                    if "leaf_const" in block else None),
    )
    _check_tree_arrays(block, index, nl, t)
    if t.is_linear and "num_features" in block:
        nf = _parse_array(block.get("num_features", ""), int)
        feats_flat = _parse_array(block.get("leaf_features", ""), int)
        coeff_flat = _parse_array(block.get("leaf_coeff", ""), float)
        lf, lc, pf, pc = [], [], 0, 0
        for i in range(nl):
            cnt = int(nf[i]) if i < len(nf) else 0
            lf.append([int(v) for v in feats_flat[pf:pf + cnt]])
            lc.append([float(v) for v in coeff_flat[pc:pc + cnt]])
            pf += cnt
            pc += cnt
        t.leaf_features = lf
        t.leaf_coeff = lc
    if num_cat > 0:
        t.cat_boundaries = _parse_array(block["cat_boundaries"], int).astype(np.int32)
        t.cat_threshold = _parse_array(block["cat_threshold"], int).astype(np.uint32)
    # threshold_bin for categorical nodes is the cat ordinal (already in threshold)
    if len(t.decision_type):
        cat_nodes = (t.decision_type & 1) != 0
        t.threshold_bin = np.where(cat_nodes, thr.astype(np.int64), 0).astype(np.int32)
    return t


def dump_model_dict(booster, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    importance_type: str = "split") -> Dict[str, Any]:
    """JSON model dump (reference: GBDT::DumpModel, gbdt_model_text.cpp:25;
    the port's copy of lightgbm_tpu/model_io.py:437-512)."""
    trees = booster._all_trees()
    k = booster.num_model_per_iteration()
    total_iteration = len(trees) // max(k, 1)
    start_iteration = max(0, min(start_iteration, total_iteration))
    end = (min(start_iteration + num_iteration, total_iteration)
           if num_iteration else total_iteration)
    use = trees[start_iteration * k:end * k]
    fnames = booster.feature_name()

    def node_json(t: Tree, node: int):
        if node < 0:
            leaf = ~node
            return {
                "leaf_index": int(leaf),
                "leaf_value": float(t.leaf_value[leaf]),
                "leaf_weight": float(t.leaf_weight[leaf]) if leaf < len(t.leaf_weight) else 0.0,
                "leaf_count": int(t.leaf_count[leaf]) if leaf < len(t.leaf_count) else 0,
            }
        dt = int(t.decision_type[node])
        is_cat = bool(dt & 1)
        d = {
            "split_index": int(node),
            "split_feature": int(t.split_feature[node]),
            "split_gain": float(t.split_gain[node]),
            "threshold": (float(t.threshold[node]) if not is_cat else
                          _cat_threshold_str(t, node)),
            "decision_type": "==" if is_cat else "<=",
            "default_left": bool(dt & 2),
            "missing_type": ["None", "Zero", "NaN"][min((dt >> 2) & 3, 2)],
            "internal_value": float(t.internal_value[node]),
            "internal_weight": float(t.internal_weight[node]),
            "internal_count": int(t.internal_count[node]),
            "left_child": node_json(t, int(t.left_child[node])),
            "right_child": node_json(t, int(t.right_child[node])),
        }
        return d

    def _cat_threshold_str(t: Tree, node: int) -> str:
        kcat = int(t.threshold_bin[node])
        s, e = t.cat_boundaries[kcat], t.cat_boundaries[kcat + 1]
        cats = []
        for w in range(s, e):
            word = int(t.cat_threshold[w])
            for b in range(32):
                if word >> b & 1:
                    cats.append((w - s) * 32 + b)
        return "||".join(str(c) for c in cats)

    out = {
        "name": "tree",
        "version": _MODEL_VERSION,
        "num_class": (booster.config.num_class if booster._engine is not None
                      else booster._loaded_trees.num_class),
        "num_tree_per_iteration": k,
        "label_index": 0,
        "max_feature_idx": booster.num_feature() - 1,
        "objective": _objective_string(booster),
        "average_output": booster._average_output(),
        "feature_names": fnames,
        "feature_infos": {},
        "tree_info": [
            {"tree_index": i, "num_leaves": t.num_leaves, "num_cat": t.num_cat,
             "shrinkage": t.shrinkage,
             "tree_structure": node_json(t, 0 if t.num_leaves > 1 else ~0)}
            for i, t in enumerate(use)
        ],
    }
    imp = booster.feature_importance(importance_type)
    out["feature_importances"] = {fnames[i]: float(v)
                                  for i, v in enumerate(imp) if v > 0}
    return out


def refit_model(booster, data, label, decay_rate: float = 0.9, **kwargs):
    """Refit leaf values on new data (reference: GBDT::RefitTree,
    gbdt.cpp; lightgbm_tpu/model_io.py:514-570), on the host: each tree in
    turn, every row's leaf by the host walk (``Tree.predict_leaf_raw``),
    the objective's gradients at the score of the trees refitted so far
    (the port's objectives on CPU tensors), per-leaf sums in float64 row
    order (``np.bincount``), and new = decay * old + (1 - decay) *
    (-sum_g / (sum_h + lambda_l2)) * shrinkage where a leaf holds rows.
    Returns a new Booster; this one is unchanged."""
    import copy as _copy

    import torch

    from .basic import Booster
    from .config import Config
    from .objectives import create_objective
    X = np.asarray(data, np.float64)
    y = np.asarray(label, np.float64)
    k = booster.num_model_per_iteration()
    out = Booster(model_str=booster.model_to_string())
    lt = out._loaded_trees
    n = X.shape[0]
    score = np.zeros((n, k), np.float64)
    cfg = booster.config if booster._engine is not None else Config()
    obj_name = _objective_string(booster).split(" ")[0]
    cfg2 = _copy.copy(cfg)
    cfg2.objective = obj_name if obj_name else "regression"
    try:
        obj = create_objective(cfg2)
        obj.init(y, None, n=n)
    except Exception:
        obj = None
    for i, t in enumerate(lt.trees):
        kk = i % k
        leaf = t.predict_leaf_raw(X)
        if obj is not None:
            g, h = obj.get_gradients(torch.from_numpy(
                (score if k > 1 else score[:, 0]).astype(np.float32)))
            g, h = g.numpy(), h.numpy()
            if k > 1:
                g, h = g[:, kk], h[:, kk]
            sum_g = np.bincount(leaf, weights=g, minlength=t.num_leaves)
            sum_h = np.bincount(leaf, weights=h, minlength=t.num_leaves)
            new_vals = (-sum_g / (sum_h + cfg2.lambda_l2 + 1e-15)
                        * t.shrinkage)
            has_data = np.bincount(leaf, minlength=t.num_leaves) > 0
            t.leaf_value = np.where(
                has_data, decay_rate * t.leaf_value
                + (1 - decay_rate) * new_vals, t.leaf_value)
        score[:, kk] += t.leaf_value[leaf]
    return out
