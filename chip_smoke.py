#!/usr/bin/env python3
"""Smoke run of lightgbm_torch on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py [--seed 0] [--rows 1000000] [--trees 500]

Phases, each printing one JSON line:

0. device: the card (``nvidia-smi``), torch and CUDA versions.
1. build: every CUDA kernel of the package compiled from ``csrc/`` with
   nvcc for sm_90a, all sources at once.
2. small: seeded models over data with NaN, zero-as-missing, categorical
   and EFB-bundled features (binary and 3-class, with and without
   prediction early stop) served through ``train(..., 0, init_model=...)``
   and ``Booster.predict``.  The CUDA kernel must equal its plain PyTorch
   version bit for bit (both add the same float32 leaf values in the same
   tree order), and ``predict`` must match the float64 host walk within
   rtol 1e-4 / atol 1e-5.
3. full: the repo's north-star shape, HIGGS-like data (28 numeric features,
   max_bin 63) and a seeded synthetic 500-tree x 255-leaf binary model
   written as LightGBM model text: ``Dataset`` over 1M rows, ``train(params,
   ds, 0, init_model=path)``, ``predict`` on 1M more rows.  The kernel's
   launch count is read around that ``predict`` call alone; then the kernel
   is held bit for bit against its plain version on all rows, the scores
   against the host walk on a 20 000-row subsample, and the kernel, the
   plain version, the host walk and ``predict`` are timed.

Then a ``kernels`` line (each ported kernel's launches on the main path,
error against its plain version, time, plain time and bound), the card's
name and power limit as nvidia-smi prints them, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device the script exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM rate, and the
# float32 rate outside the tensor cores.  The data sheet gives no int32 rate;
# the float32 one counts an FMA as two operations, so it is the highest rate
# the card's CUDA cores are quoted at and the bound it gives is the least.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCES = {"predict_stream": "lightgbm_torch/kernels/csrc/predict_stream.cu"}
KERNEL_REPLACES = {"predict_stream": "lightgbm_tpu/pallas/predict_kernel.py:176"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------
# data and models, all from a seed
# --------------------------------------------------------------------------

def make_higgs_like(n, f, seed):
    """HIGGS-shaped task: 28 continuous features and a nonlinear logit (the
    generator of bench.py, copied)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, f).astype(np.float32)
    logit = (2.0 * X[:, 0] - 1.4 * X[:, 1] + 1.2 * X[:, 2] * X[:, 3]
             + 0.8 * np.sin(3 * X[:, 4]) + 0.7 * X[:, 5] * X[:, 5]
             - 0.6 * np.abs(X[:, 6]) + 0.5 * X[:, 7])
    p = 1.0 / (1.0 + np.exp(-1.2 * logit))
    y = (rs.rand(n) < p).astype(np.float64)
    return X, y


def make_mixed(n, seed):
    """NaNs (column 0), a zero-heavy column (1), a categorical column with
    NaN (2), a mutually exclusive sparse pair that EFB bundles (3, 4), and
    dense noise; labels in {0, 1, 2}."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 7)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    X[:, 2] = rs.randint(0, 8, n)
    X[rs.rand(n) < 0.05, 2] = np.nan
    a = rs.rand(n)
    X[:, 3] = np.where(a < 0.1, rs.rand(n) + 0.5, 0.0)
    X[:, 4] = np.where(a > 0.9, rs.rand(n) + 0.5, 0.0)
    y = rs.randint(0, 3, n).astype(np.float64)
    return X, y


def adversarial_categories(X, col, seed):
    """Category values the training data never had: NaN, unseen, negative,
    fractional and far out of range."""
    rs = np.random.RandomState(seed)
    X = X.copy()
    n = len(X)
    for frac, v in ((0.05, np.nan), (0.03, 77.0), (0.03, -3.0), (0.03, 2.7),
                    (0.01, 1e12)):
        X[rs.rand(n) < frac, col] = v
    return X


def random_tree(rs, mappers, num_leaves, cat_prob=0.1):
    """A tree grown leaf-wise by splitting a random leaf num_leaves-1 times.
    Numeric thresholds are drawn from the bin upper bounds of the feature;
    categorical nodes send a random subset of the seen categories left.
    Leaf values are float32-representable, in +-0.1."""
    from lightgbm_torch.binning import BIN_CATEGORICAL, MISSING_NAN
    from lightgbm_torch.tree import Tree

    feats = [f for f, m in enumerate(mappers) if not m.is_trivial]
    ni = num_leaves - 1
    split_feature = np.zeros(ni, np.int32)
    threshold = np.zeros(ni, np.float64)
    decision_type = np.zeros(ni, np.uint8)
    left = np.zeros(ni, np.int32)
    right = np.zeros(ni, np.int32)
    cat_boundaries, cat_threshold = [0], []
    slot = {0: None}          # leaf -> (parent node, is left child)
    for s in range(ni):
        leaf = int(rs.choice(sorted(slot)))
        if slot[leaf] is not None:
            p, is_left = slot[leaf]
            (left if is_left else right)[p] = s
        left[s], right[s] = ~leaf, ~(s + 1)
        slot[leaf], slot[s + 1] = (s, True), (s, False)
        cats = [f for f in feats if mappers[f].bin_type == BIN_CATEGORICAL]
        nums = [f for f in feats if f not in cats]
        f = int(rs.choice(cats if cats and rs.rand() < cat_prob else nums))
        m = mappers[f]
        split_feature[s] = f
        if m.bin_type == BIN_CATEGORICAL:
            chosen = [int(c) for c in m.categories if rs.rand() < 0.5]
            words = np.zeros(max(chosen, default=0) // 32 + 1, np.uint32)
            for c in chosen:
                words[c // 32] |= np.uint32(1 << (c % 32))
            threshold[s] = len(cat_boundaries) - 1
            cat_threshold.extend(int(w) for w in words)
            cat_boundaries.append(len(cat_threshold))
            decision_type[s] = 1
        else:
            n_num = m.num_bins - (1 if m.missing_type == MISSING_NAN else 0)
            threshold[s] = float(m.upper_bounds[rs.randint(max(n_num - 1, 1))])
            decision_type[s] = (Tree.make_decision_type(
                False, bool(rs.rand() < 0.5), int(m.missing_type)))
    leaf_value = rs.uniform(-0.1, 0.1, num_leaves).astype(np.float32)
    z = np.zeros
    return Tree(num_leaves=num_leaves, split_feature=split_feature,
                threshold_bin=np.where(decision_type & 1, threshold,
                                       0).astype(np.int32),
                threshold=threshold, decision_type=decision_type,
                left_child=left, right_child=right, split_gain=z(ni),
                internal_value=z(ni), internal_weight=z(ni),
                internal_count=z(ni),
                leaf_value=leaf_value.astype(np.float64),
                leaf_weight=z(num_leaves), leaf_count=z(num_leaves),
                cat_boundaries=np.asarray(cat_boundaries, np.int32),
                cat_threshold=np.asarray(cat_threshold, np.uint32))


def write_model(path, trees, num_feature, k):
    """LightGBM model text holding ``trees`` (k trees per iteration)."""
    from lightgbm_torch.model_io import tree_to_string

    objective = ("binary sigmoid:1" if k == 1
                 else f"multiclass num_class:{k}")
    body = [tree_to_string(t, i) for i, t in enumerate(trees)]
    head = ["tree", "version=v4", f"num_class={k}",
            f"num_tree_per_iteration={k}", "label_index=0",
            f"max_feature_idx={num_feature - 1}", f"objective={objective}",
            "feature_names=" + " ".join(f"Column_{i}"
                                        for i in range(num_feature)),
            "tree_sizes=" + " ".join(str(len(s) + 1) for s in body), ""]
    Path(path).write_text("\n".join(head) + "\n" + "\n".join(body)
                          + "\nend of trees\n")


def ops_needed(rec):
    """Operations one routing step needs on these inputs, for each node
    record of one tree ((L, 16) int32, kernels/predict.NODE_FIELDS): bin
    address, threshold compare, child select and leaf test (4); a
    categorical node adds the bitset word address (1), an EFB-bundled node
    the unbundling (subtract, range test, adjust: 3), and each missing-value
    bin of a numeric node its test (compare, and: 2)."""
    from lightgbm_torch.kernels import predict as tpk

    is_cat = rec[:, tpk.F_ISCAT] > 0
    missing = ((rec[:, tpk.F_HASNAN] > 0).astype(np.int64)
               + (rec[:, tpk.F_HASMZ] > 0))
    return (4 + is_cat + 3 * (rec[:, tpk.F_BUNDLED] > 0)
            + 2 * np.where(is_cat, 0, missing))


def node_record_bytes(rec):
    """Bytes of node record the kernel reads at each node of one tree: three
    16-byte quads, the missing-value quad on a numeric node, a bitset word on
    a categorical one."""
    from lightgbm_torch.kernels import predict as tpk

    return 48 + np.where(rec[:, tpk.F_ISCAT] > 0, 4, 16)


def path_sum(inp, use, node_weight, max_depth):
    """Sum over all rows of ``node_weight`` over the nodes each row visits,
    computed by the kernel itself walking a table of per-leaf path sums in
    place of the leaf values (float32 sums of integers below 2**24 are
    exact).  The launch is not on the main path and the count was read."""
    import torch
    from lightgbm_torch.kernels import predict as tpk

    nodes, lv, words, _ = inp.classes[0]
    recs = nodes.cpu().numpy()
    tab = np.zeros(tuple(lv.shape), np.float32)
    for i, t in enumerate(use):
        sums = tpk.leaf_path_sums(t, node_weight(recs[i]))
        tab[i, :len(sums)] = sums
    out = tpk.predict_stream_cuda(inp.bins_T, nodes,
                                  torch.as_tensor(tab, device=lv.device),
                                  words, max_depth)
    return float(out.double().sum().item())


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def cuda_ms(fn, reps, warmup=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def serve(X, y, trees, k, params, ds_kw, tmp):
    """A saved model served through the public entry points: model text ->
    Dataset -> train(0, init_model) -> Booster."""
    import lightgbm_torch as lt

    path = Path(tmp) / f"model_{len(trees)}_{k}.txt"
    write_model(path, trees, X.shape[1], k)
    return lt.train(params, lt.Dataset(X, label=y, **ds_kw), 0,
                    init_model=str(path))


def check_kernel_against_plain(bst, X, es=None):
    """Run the CUDA kernel and its plain version on the inputs of a device
    batch walk; raise unless they are equal bit for bit.  Returns the
    inputs, the kernel's outputs and the largest difference seen (0.0)."""
    import torch
    from lightgbm_torch.kernels import predict as tpk

    use, k, _, _ = bst._resolve_tree_slice(0, None)
    inp = bst._device_predict_inputs(X, use, k, es)
    if inp is None:
        raise RuntimeError("the device path declined this batch")
    outs, err = [], 0.0
    for nodes, lv, words, depths in inp.classes:
        got = tpk.predict_stream_cuda(inp.bins_T, nodes, lv, words,
                                      int(max(depths)), inp.es_freq,
                                      inp.es_margin)
        want = tpk.predict_stream_plain(inp.bins_T, nodes, lv, words, depths,
                                        inp.es_freq, inp.es_margin)
        diff = (got - want).abs().max().item() if len(got) else 0.0
        if not torch.equal(got, want):
            raise RuntimeError(f"CUDA kernel differs from its plain version "
                               f"(max abs {diff})")
        outs.append(got)
        err = max(err, diff)
    return inp, outs, err


def phase_small(seed, tmp):
    """Mixed features, binary and 3-class, with and without early stop, and
    a zero-as-missing Dataset."""
    import lightgbm_torch as lt
    from lightgbm_torch.basic import _host_predict

    n = 30_000
    X, y = make_mixed(n, seed)
    Xt = adversarial_categories(make_mixed(n, seed + 1)[0], 2, seed + 2)
    rs = np.random.RandomState(seed + 3)
    results = []
    # max_bin 63 keeps the EFB bundle within the uint8 bins the kernel reads
    cases = [("binary", 1, {"max_bin": 63}, None),
             ("binary_es", 1, {"max_bin": 63}, (5, 1.0)),
             ("multiclass", 3, {"max_bin": 63}, None),
             ("zero_as_missing", 1, {"max_bin": 63, "zero_as_missing": True},
              None)]
    for name, k, extra, es in cases:
        params = {"objective": "binary" if k == 1 else "multiclass",
                  "num_leaves": 31, "verbosity": -1, **extra}
        if k > 1:
            params["num_class"] = k
        ds_kw = {"categorical_feature": [2], "params": dict(extra)}
        mappers = lt.Dataset(X, label=y, **ds_kw).bin_mappers()
        trees = [random_tree(rs, mappers, 31) for _ in range(15 * k)]
        label = y if k > 1 else (y > 0).astype(np.float64)
        bst = serve(X, label, trees, k, params, ds_kw, tmp)
        groups = bst.engine.train_data.binned.group_features
        if not any(len(g) > 1 for g in groups):
            raise RuntimeError("the mixed data must bundle features (EFB)")
        check_kernel_against_plain(bst, Xt, es)
        kw = ({"pred_early_stop": True, "pred_early_stop_freq": es[0],
               "pred_early_stop_margin": es[1]} if es else {})
        pred = bst.predict(Xt, raw_score=True, **kw)
        use, _, _, _ = bst._resolve_tree_slice(0, None)
        host = _host_predict(Xt, use, k, bool(es), *(es or (10, 10.0)))
        np.testing.assert_allclose(pred, host, rtol=RTOL, atol=ATOL)
        if es:
            full = bst.predict(Xt, raw_score=True)
            if not np.abs(full - pred).max() > 1e-6:
                raise RuntimeError("early stop did not bite")
        results.append({"case": name, "k": k, "rows": len(Xt),
                        "trees": len(trees),
                        "max_abs_err_vs_host": float(np.abs(pred - host).max()),
                        "kernel_equals_plain": True})
    emit({"phase": "small", "cases": results})


def phase_full(seed, rows, n_trees, num_leaves, tmp, smi, sub_rows=20_000):
    """The north-star shape through the public entry points."""
    import torch
    import lightgbm_torch as lt
    from lightgbm_torch import kernels
    from lightgbm_torch.basic import _host_predict, _to_2d_float
    from lightgbm_torch.kernels import predict as tpk

    t0 = time.perf_counter()
    X, y = make_higgs_like(rows, 28, seed)
    Xs, _ = make_higgs_like(rows, 28, seed + 1)
    params = {"objective": "binary", "num_leaves": num_leaves, "max_bin": 63,
              "verbosity": -1}
    ds = lt.Dataset(X, label=y, params=dict(params)).construct()
    t_data = time.perf_counter() - t0
    rs = np.random.RandomState(seed + 2)
    trees = [random_tree(rs, ds.bin_mappers(), num_leaves)
             for _ in range(n_trees)]
    path = Path(tmp) / "full.txt"
    write_model(path, trees, 28, 1)
    t0 = time.perf_counter()
    bst = lt.train(params, ds, 0, init_model=str(path))
    torch.cuda.synchronize()
    t_train0 = time.perf_counter() - t0

    bst.predict(Xs[:sub_rows])             # warm the host side once
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pred = bst.predict(Xs, raw_score=True)
    t_predict = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if pred.shape != (rows,) or not np.isfinite(pred).all():
        raise RuntimeError("predict returned a wrong shape or non-finite "
                           "scores")
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"kernel {name} was not launched on the main "
                               "path")

    inp, (got,), err = check_kernel_against_plain(bst, Xs)
    if not np.array_equal(got.cpu().numpy().astype(np.float64), pred):
        raise RuntimeError("predict differs from the kernel's output")
    use, _, _, _ = bst._resolve_tree_slice(0, None)
    t0 = time.perf_counter()
    host = _host_predict(Xs[:sub_rows].astype(np.float64), use, 1, False, 10,
                         10.0)
    t_host = time.perf_counter() - t0
    np.testing.assert_allclose(pred[:sub_rows], host, rtol=RTOL, atol=ATOL)

    # host stages of the device path as predict runs them (its float64 copy
    # of the rows made first, as predict makes it)
    breakdown = {}
    bst._device_predict_inputs(_to_2d_float(Xs), use, 1, None,
                               times=breakdown)
    nodes, lv, words, depths = inp.classes[0]
    maxd = int(max(depths))
    ms = cuda_ms(lambda: tpk.predict_stream_cuda(inp.bins_T, nodes, lv, words,
                                                 maxd), reps=5)
    plain_ms = cuda_ms(lambda: tpk.predict_stream_plain(inp.bins_T, nodes, lv,
                                                        words, depths),
                       reps=1, warmup=0)
    # the work this data needs: node visits, the operations of each visit
    # from its node's flags plus one add per row and tree, and the node
    # record bytes the visits read (from L2 once the model is resident)
    visits = path_sum(inp, use, lambda r: np.ones(len(r)), maxd)
    n_ops = path_sum(inp, use, ops_needed, maxd) + rows * len(use)
    record_bytes = path_sum(inp, use, node_record_bytes, maxd)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (inp.bins_T, nodes, lv, words)) + 4 * rows
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / CORE_OPS_PER_S * 1e3
    kernel = {"name": "predict_stream", "route": "cuda",
              "source": KERNEL_SOURCES["predict_stream"],
              "replaces": KERNEL_REPLACES["predict_stream"],
              "launches": launches["predict_stream"],
              "max_abs_err": err,
              "ms": ms, "plain_ms": plain_ms,
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "library_ms": None}
    emit({"phase": "full", "card": smi, "rows": rows, "features": 28, "trees": n_trees,
          "num_leaves": num_leaves, "max_depth": maxd,
          "dataset_s": t_data, "train0_s": t_train0, "predict_s": t_predict,
          "predict_rows_per_s": rows / t_predict,
          "kernel_ms": ms, "kernel_rows_per_s": rows / (ms / 1e3),
          "plain_ms": plain_ms, "host_walk_s": t_host,
          "host_walk_rows": sub_rows,
          "max_abs_err_vs_host": float(np.abs(pred[:sub_rows] - host).max()),
          "predict_breakdown_s": breakdown, "node_visits": visits,
          "bytes": n_bytes, "ops": n_ops, "ops_per_visit": n_ops / visits,
          "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
          "node_record_bytes": record_bytes,
          "node_record_gb_per_s": record_bytes / (ms / 1e3) / 1e9})
    return kernel


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=500)
    ap.add_argument("--leaves", type=int, default=255)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the GPU",
              file=sys.stderr)
        return 2
    import lightgbm_torch
    from lightgbm_torch.kernels import build

    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "package": lightgbm_torch.__version__})
    t0 = time.perf_counter()
    built = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": built,
          "ptxas": {n: [ln.strip() for ln in
                        (build.BUILD_DIR / f"{n}.log").read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in built}})
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        phase_small(args.seed, tmp)
        kernel = phase_full(args.seed, args.rows, args.trees, args.leaves,
                            tmp, smi)
    emit({"kernels": [kernel]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
