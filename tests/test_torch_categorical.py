"""Categorical splits in the port against the JAX package, on the CPU.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode, its backends pinned, since its CPU defaults differ from the
device defaults the port takes) and through the port with
``device_type="cpu"``, where every kernel wrapper runs its plain PyTorch
version.

Tolerances and why:

- The split scan on dyadic histograms: every sum is exact in float32 and
  the gains are the same float32 operations, so gains, features,
  thresholds, flags, left sums and the left-bin sets are bit-equal; sorts
  are stable in both packages, so categories whose ratios tie go to the
  same side.
- Whole training on dyadic custom gradients: model text byte-identical to
  the JAX package's same backend.
- Real binary gradients: float sums in different orders, so trees are
  identical in structure and raw scores agree within atol 2e-4, the bound
  tests/test_torch_train.py holds numeric training to, except where a
  forward and a reversed subset tie (one partition, sides swapped): there
  the sums' rounding picks one, and the test holds the two packages to the
  same features, gains within rtol 1e-4 and disjoint sets.
- Prediction: the plain K1 adds exact float32 leaf values in tree order,
  bit-equal to a float32 sum of the host walk; against the JAX package's
  predictions rtol 1e-4 / atol 1e-5, tests/test_torch_predict.py's bound
  for its bf16 leaf encoding.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.basic import Booster as JBooster
from lightgbm_tpu.ops.histogram import _hist_segsum
from lightgbm_tpu.ops.split import \
    categorical_left_bitset as j_categorical_left_bitset
from lightgbm_tpu.ops.split import \
    gather_feature_histograms as j_gather_feature_histograms
from lightgbm_tpu.ops.split import find_best_splits as j_find_best_splits
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import predict_kernel as jpk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.basic import Booster as TBooster
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.kernels import predict as tpk
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops import split as tsplit

from test_torch_multiclass import _dyadic_mc_fobj
from test_torch_quantized import _pow2_fobj
from test_torch_train import _datasets, _dyadic_fobj

CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-4, 1e-5
CAT = [5, 6, 7]          # one-hot (3), mid (40, NaN, negative), Zipf (200)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)
    monkeypatch.setattr(jpk, "_INTERPRET", True)


def _cat_data(n, seed, k=1):
    """NaN (0), zero-heavy (1) and dense (2) numeric columns, a mutually
    exclusive sparse pair of few values that EFB bundles (3, 4), and three
    categorical columns: 3 categories (5); 40 with NaN and negative values
    (6); 200 drawn from a Zipf law (7).  A binary label, or K classes."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 8)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    a = rs.rand(n)
    X[:, 3] = np.where(a < 0.1, rs.randint(1, 9, n), 0.0)
    X[:, 4] = np.where(a > 0.9, rs.randint(1, 9, n), 0.0)
    X[:, 5] = rs.randint(0, 3, n)
    mid = rs.randint(0, 40, n).astype(float)
    mid[rs.rand(n) < 0.05] = np.nan
    neg = rs.rand(n) < 0.03
    mid[neg] = -rs.randint(1, 4, neg.sum())
    X[:, 6] = mid
    p = 1.0 / np.arange(1, 201) ** 1.1
    X[:, 7] = rs.choice(200, n, p=p / p.sum())
    eff_mid = rs.randn(41)
    eff_wide = rs.randn(200)
    m = np.where(np.isnan(mid) | (mid < 0), 40, mid).astype(int)
    base = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 0.3 * X[:, 3]
            + (X[:, 5] == 1) + eff_mid[m] + 0.7 * eff_wide[X[:, 7].astype(
                int)])
    if k == 1:
        return X, (base + 0.3 * rs.randn(n) > 0.5).astype(float)
    logits = np.stack([base, 2 * X[:, 1] - (X[:, 5] == 2),
                       eff_mid[m] - X[:, 2]], axis=1)
    return X, np.argmax(logits + 0.5 * rs.randn(n, k), axis=1).astype(float)


def _cat_kinds(models):
    """(one-hot, sorted, reversed) categorical nodes over a port booster's
    grown trees, from their device arrays."""
    kinds = np.zeros(3, int)
    for e in models:
        a = e["arrays"]
        ni = max(int(a.num_leaves) - 1, 0)
        d = a.dir_flags[:ni].numpy()
        cat = (d & tsplit.DIR_CATEGORICAL) != 0
        oh = cat & ((d & tsplit.DIR_CAT_ONEHOT) != 0)
        rev = cat & ((d & tsplit.DIR_CAT_REVERSED) != 0)
        kinds += [oh.sum(), (cat & ~oh & ~rev).sum(), rev.sum()]
    return kinds


# ------------------------------------------------------------- split scan

_S = 8


@functools.lru_cache(maxsize=None)
def _scan_case():
    """Dyadic (S, G, Bmax, 2) histograms of 4000 rows in 8 slots, with the
    two packages' layouts.  The second half of the rows repeats the first
    with the mid column's categories shifted by 20, so bins c and c + 20 of
    that feature hold equal sums in every slot: their ratios tie."""
    half = 2000
    X, y = _cat_data(half, 31)
    X2 = X.copy()
    ok = ~np.isnan(X2[:, 6]) & (X2[:, 6] >= 0)
    X[ok, 6] = X[ok, 6] % 20
    X2[ok, 6] = X[ok, 6] + 20
    Xa = np.concatenate([X, X2])
    ya = np.concatenate([y, y])
    jds, tds = _datasets(Xa, ya, {"max_bin": 63, "verbosity": -1}, cat=CAT)
    jdd = jds.device_data()
    rs = np.random.RandomState(5)
    n_pad = jdd.bins.shape[0]
    n = len(Xa)

    def twin(v):
        out = np.zeros(n_pad, v.dtype)
        out[:n] = np.concatenate([v, v])
        return out

    slot = twin(rs.randint(-1, _S, half).astype(np.int32))
    effect = 1.5 * (ya[:half] - 0.5) + 0.25 * rs.randn(half)
    grad = twin((np.round(16 * effect) / 16).astype(np.float32))
    hess = twin((np.round(8 * rs.rand(half)) / 16 + 0.25).astype(np.float32))
    cnt = (np.arange(n_pad) < n).astype(np.float32)
    h3 = np.asarray(_hist_segsum(jdd.bins, jnp.asarray(slot),
                                 jnp.asarray(grad), jnp.asarray(hess),
                                 jnp.asarray(cnt), _S, jdd.max_bins))
    valid = slot >= 0
    pg = np.array([grad[valid & (slot == s)].sum(dtype=np.float64)
                   for s in range(_S)], np.float32)
    ph = np.array([hess[valid & (slot == s)].sum(dtype=np.float64)
                   for s in range(_S)], np.float32)
    pc = h3[:, 0, :, 2].sum(axis=-1).astype(np.float32)
    return jds, tds, h3[..., :2].copy(), pg, ph, pc


_CAT_PARAMS = {
    "small_groups": dict(min_data_per_group=5, cat_smooth=1.0),
    "defaults": dict(),
    "threshold_cap_2": dict(min_data_per_group=5, cat_smooth=1.0,
                            max_cat_threshold=2),
    "all_one_hot": dict(min_data_per_group=5, max_cat_to_onehot=64),
    "max_delta_step": dict(min_data_per_group=5, cat_smooth=1.0,
                           max_delta_step=0.25),
    "regularized": dict(min_data_per_group=10, cat_smooth=4.0, cat_l2=1.0,
                        lambda_l1=0.5, lambda_l2=2.0, min_data_in_leaf=20,
                        min_gain_to_split=0.1),
}
_SCAN_KEYS = ("lambda_l1", "lambda_l2", "min_data_in_leaf",
              "min_sum_hessian_in_leaf", "min_gain_to_split",
              "max_delta_step")


def _scans(case, col):
    """The two packages' find_best_splits and left-bin sets of every slot's
    winner, under one parameter set and feature mask."""
    jds, tds, hist, pg, ph, pc = _scan_case()
    p = {"lambda_l1": 0.0, "lambda_l2": 0.0, "min_data_in_leaf": 5,
         "min_sum_hessian_in_leaf": 1e-3, "min_gain_to_split": 0.0,
         "max_delta_step": 0.0, **_CAT_PARAMS[case]}
    cat = tsplit.CatParams(**{k: p[k] for k in tsplit.CatParams._fields
                              if k in p})
    F = tds.device_data().num_features
    mask = None if col is None else np.isin(np.arange(F), col)
    jl, tl_ = jds.device_data().layout, tds.device_data().layout
    j = j_find_best_splits(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jl, *(p[k] for k in _SCAN_KEYS[:5]),
        col_mask=None if mask is None else jnp.asarray(mask),
        max_delta_step=p["max_delta_step"], **cat._asdict())
    t = tsplit.find_best_splits(
        torch.as_tensor(hist), torch.as_tensor(pg), torch.as_tensor(ph),
        torch.as_tensor(pc), tl_, *(p[k] for k in _SCAN_KEYS),
        None if mask is None else torch.as_tensor(mask), cat)
    feat = np.array(j.feature)
    cnt_factor = pc / np.maximum(ph, tsplit.EPS_HESS)
    jhf = np.asarray(j_gather_feature_histograms(
        jnp.asarray(hist), jl, jnp.asarray(pg), jnp.asarray(ph)))
    jbits = np.asarray(j_categorical_left_bitset(
        jnp.asarray(jhf[np.arange(_S), feat]), j.threshold, j.dir_flags,
        jl.valid_mask[feat], cat.cat_smooth, cat.min_data_per_group,
        jnp.asarray(cnt_factor)))
    thf = tsplit.gather_feature_histograms(
        torch.as_tensor(hist), tl_, torch.as_tensor(pg), torch.as_tensor(ph))
    tf = torch.as_tensor(feat).long()
    tbits = tsplit.categorical_left_bitset(
        thf[torch.arange(_S), tf], t.threshold, t.dir_flags,
        tl_.valid_mask[tf], cat.cat_smooth, cat.min_data_per_group,
        torch.as_tensor(cnt_factor))
    return j, t, jbits, tbits.numpy()


@pytest.mark.parametrize("col", [None, [5], [6], [7], [2, 6]],
                         ids=["all", "one_hot_3", "mid_40", "zipf_200",
                              "mixed"])
@pytest.mark.parametrize("case", sorted(_CAT_PARAMS))
def test_find_best_splits_bit_equal_on_dyadic_histograms(case, col):
    """Every field of each slot's best split, and the left bins of the
    winner, bit-equal to the JAX package's, over all features and over
    each categorical feature alone."""
    j, t, jbits, tbits = _scans(case, col)
    assert t.feat_ok is None and j.feat_ok is None
    for name in tsplit.SplitResult._fields[:-1]:
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            err_msg=name)
    np.testing.assert_array_equal(tbits, jbits)
    cat = (t.dir_flags.numpy() & tsplit.DIR_CATEGORICAL) != 0
    if col is not None and col != [2, 6] and case != "defaults":
        assert (t.gain.numpy() > 0).any() and cat[t.gain.numpy() > 0].all()


def test_scans_cover_every_kind_and_tie():
    """The cases above reach one-hot, forward and reversed subsets, the cap
    of max_cat_threshold, and winners whose bins tie in ratio with a bin
    left out: the stable sort decides them."""
    kinds = set()
    for case in ("small_groups", "threshold_cap_2", "all_one_hot"):
        for col in ([5], [6], [7], None):
            _, t, _, bits = _scans(case, col)
            d = t.dir_flags.numpy()
            ok = (t.gain.numpy() > 0) & ((d & tsplit.DIR_CATEGORICAL) != 0)
            for s in np.flatnonzero(ok):
                if d[s] & tsplit.DIR_CAT_ONEHOT:
                    kinds.add("one_hot")
                else:
                    kinds.add("reversed" if d[s] & tsplit.DIR_CAT_REVERSED
                              else "forward")
                    if case == "threshold_cap_2":
                        assert 1 <= bits[s].sum() <= 2
                        kinds.add("capped")
            if col == [6]:
                # feature 6's bin of category c and of c + 20 tie; a winner
                # takes one of a tied pair without the other somewhere
                m = _scan_case()[1].binned.bin_mappers[6]
                pos = {int(c): b for b, c in enumerate(m.categories)}
                pairs = [(pos[c], pos[c + 20]) for c in range(20)
                         if c in pos and c + 20 in pos]
                if any(bits[s, a] != bits[s, b] for s in np.flatnonzero(ok)
                       for a, b in pairs):
                    kinds.add("tie_split")
    assert kinds >= {"one_hot", "forward", "reversed", "capped",
                     "tie_split"}, kinds


def test_min_data_per_group_leaves_small_categories_out():
    """At the default of 100 rows a category, no bin of the 200-category
    Zipf feature below 100 rows ever goes left."""
    jds, tds, hist, pg, ph, pc = _scan_case()
    _, t, _, bits = _scans("defaults", [7])
    lay = tds.device_data().layout
    hf = tsplit.gather_feature_histograms(
        torch.as_tensor(hist), lay, torch.as_tensor(pg), torch.as_tensor(ph))
    hc = tsplit.round_int(hf[:, 7, :, 1] * torch.as_tensor(
        pc / np.maximum(ph, tsplit.EPS_HESS))[:, None]).numpy()
    assert (hc < 100).any() and (hc >= 100).any()
    ok = t.gain.numpy() > 0
    assert ok.any()
    assert not (bits[ok] & (hc[ok] < 100)).any()


# ------------------------------------------------------- whole training

_BASE = {"objective": "none", "hist_precision": "single",
         "min_data_in_leaf": 5, "verbosity": -1, "min_data_per_group": 5,
         "cat_smooth": 1.0, "max_bin": 63}
_GOSS = {"data_sample_strategy": "goss", "top_rate": 0.5, "other_rate": 0.25,
         "learning_rate": 0.5}
# name: (classes, rows, leaves, split budget, backend, fobj, extra params)
_TRAIN = {
    "stream_sprint": (1, 3000, 127, 64, "stream", "dyadic", {}),
    "stream_defaults": (1, 4000, 31, 8, "stream", "dyadic",
                        {"min_data_per_group": 100, "cat_smooth": 10.0}),
    "scatter_63": (1, 3000, 31, 8, "scatter", "dyadic", {}),
    "scatter_255": (1, 3000, 31, 8, "scatter", "dyadic", {"max_bin": 255}),
    "pallas_63": (1, 3000, 31, 8, "pallas", "dyadic", {}),
    "pallas_255": (1, 3000, 31, 8, "pallas", "dyadic", {"max_bin": 255}),
    # S = 64 and 127 leaves: numeric data would fuse these trees
    "goss": (1, 3000, 127, 64, "stream", "dyadic", _GOSS),
    "bagging": (1, 3000, 31, 8, "stream", "dyadic",
                {"bagging_fraction": 0.7, "bagging_freq": 1}),
    "mc_lockstep": (3, 2000, 31, 8, "stream", "mc", {}),
    "mc_per_class": (3, 2000, 31, 8, "stream", "mc",
                     {"multiclass_batched": False}),
    "mc_pallas": (3, 2000, 31, 8, "pallas", "mc", {}),
    "quantized": (1, 3000, 31, 8, "stream", "pow2",
                  {"use_quantized_grad": True, "learning_rate": 0.5}),
}
_FOBJ = {"dyadic": _dyadic_fobj, "mc": _dyadic_mc_fobj, "pow2": _pow2_fobj}


def _train(pkg, case, iters=3):
    k, n, leaves, splits, backend, fobj, extra = _TRAIN[case]
    X, y = _cat_data(n, n + k, k)
    p = {**_BASE, "num_leaves": leaves, "max_splits_per_round": splits,
         "hist_backend": backend, **extra}
    if k > 1:
        p.update(objective="multiclass", num_class=k)
    kw = CPU if pkg is lt else {}
    bst = pkg.Booster({**p, **kw}, pkg.Dataset(
        X, label=y, categorical_feature=CAT,
        params={"max_bin": p["max_bin"], **kw}))
    for _ in range(iters):
        bst.update(fobj=_FOBJ[fobj])
    return bst


def _trees_text(bst):
    return bst.model_to_string().split("\nparameters:")[0]


@pytest.mark.parametrize("case", sorted(_TRAIN))
def test_dyadic_training_byte_identical_to_jax(case, monkeypatch):
    """Three iterations on dyadic gradients: the model text byte-identical
    to the JAX package's same backend, every tree with categorical nodes.
    A sampled categorical tree never takes K3, and under stream the
    route-only sprint and the per-round full-row passes route by the
    bitsets through K2."""
    calls = {"replay": 0, "route_only": 0}
    orig_replay, orig_k2 = tgrow.route_replay, tgrow.route_and_hist

    def replay(*a):
        calls["replay"] += 1
        return orig_replay(*a)

    def k2(*a):
        calls["route_only"] += not a[10]            # with_hist
        return orig_k2(*a)

    monkeypatch.setattr(tgrow, "route_replay", replay)
    monkeypatch.setattr(tgrow, "route_and_hist", k2)
    tb = _train(lt, case)
    eng = tb.engine
    # the grown trees, before the text flushes them: every one categorical
    n_trees = len(eng._lazy_trees)
    assert n_trees == 3 * _TRAIN[case][0]
    assert all(_cat_kinds([e]).sum() > 0 for e in eng._lazy_trees)
    assert eng.grow_params.cat is not None
    jb = _train(lgb, case)
    assert _trees_text(tb) == _trees_text(jb)
    assert calls["replay"] == 0
    if case in ("stream_sprint", "goss", "bagging"):
        assert calls["route_only"] > 0
    if case == "goss":
        assert eng.last_compact_rows > 0
        assert eng.route_only_passes_per_tree() > 1


def test_fusion_gate_is_off_for_categorical_trees():
    """The grower's fusion gate: a compacted stream tree at S = 64 fuses on
    numeric data and never with a categorical feature (K3's records carry
    no bitsets)."""
    p = tgrow.GrowParams(num_leaves=127, max_depth=-1, max_splits_per_round=64,
                         lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=5,
                         min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                         max_delta_step=0.0, route_fusion=True)
    assert tgrow.fusion_applies(p, 2048)
    assert not tgrow.fusion_applies(p._replace(cat=tsplit.CatParams()), 2048)
    assert not tgrow.fusion_applies(p, 0)


def test_categorical_kinds_in_training():
    """Over the training cases' trees, one-hot, sorted and reversed
    categorical nodes all occur."""
    total = np.zeros(3, int)
    for case in ("stream_sprint", "scatter_63", "mc_lockstep"):
        total += _cat_kinds(_train(lt, case).engine._lazy_trees)
    assert (total > 0).all(), total


def test_config_carries_the_categorical_parameters():
    """The five parameters are Config fields with the reference's defaults,
    no longer unknown keys."""
    c = TConfig.from_params({"min_data_per_group": 7, "cat_l2": 2,
                             "max_cat_threshold": "9"})
    assert (c.min_data_per_group, c.cat_l2, c.max_cat_threshold,
            c.cat_smooth, c.max_cat_to_onehot) == (7, 2.0, 9, 10.0, 4)
    assert "cat_l2" not in c._unknown


# ------------------------------------------------------- real gradients

@functools.lru_cache(maxsize=None)
def _real_pair(n=3000, iters=10):
    """The JAX package's segsum booster and the port's, trained on real
    binary gradients at the reference's categorical defaults."""
    X, y = _cat_data(n, 3)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "max_bin": 63, "learning_rate": 0.1, "verbosity": -1,
         "max_splits_per_round": 1}
    jb = lgb.train({**p, "hist_backend": "segsum",
                    "hist_precision": "single"},
                   lgb.Dataset(X, label=y, categorical_feature=CAT), iters)
    tb = lt.train({**p, **CPU}, lt.Dataset(X, label=y, categorical_feature=CAT,
                                          params=CPU), iters)
    return X, jb, tb


def _structure(t):
    return (t.num_leaves, list(t.split_feature), list(t.threshold),
            list(t.decision_type), list(t.left_child), list(t.right_child),
            list(t.cat_boundaries), list(t.cat_threshold))


def test_real_gradients_match_jax_segsum():
    """Ten trees on 3000 rows: every tree identical in structure, category
    sets included, and raw scores within 2e-4."""
    X, jb, tb = _real_pair()
    jt, tt = jb.engine.models, tb.engine.models
    assert len(jt) == len(tt) == 10
    assert [_structure(t) for t in tt] == [_structure(t) for t in jt]
    assert all(t.num_cat > 0 for t in tt)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-4)


def _cat_set(t, i):
    k = int(t.threshold_bin[i])
    w = t.cat_threshold[t.cat_boundaries[k]:t.cat_boundaries[k + 1]]
    return {c for c in range(32 * len(w)) if (int(w[c // 32]) >> (c % 32)) & 1}


def test_real_gradients_tie_forward_and_reversed_subsets():
    """Where every category of a leaf is eligible, the forward prefix of
    length k and the reversed prefix of the rest are one partition with
    its sides swapped: their gains are equal but for float rounding, and
    the two packages' sums, added in different orders, pick different
    ones (ROADMAP.md section 3: the port takes the eligible totals in
    float64).  At 6000 rows the trees may all agree; where one differs, it
    has the same split features and gains within rtol 1e-4, and its
    differing category sets are disjoint."""
    X, jb, tb = _real_pair(6000, 3)
    pairs = list(zip(jb.engine.models, tb.engine.models))
    first = next((i for i, (a, b) in enumerate(pairs)
                  if _structure(a) != _structure(b)), None)
    if first is None:
        return
    a, b = pairs[first]
    assert list(a.split_feature) == list(b.split_feature)
    assert list(a.decision_type) == list(b.decision_type)
    # gains are differences of float32 terms, on scores that two trees of
    # float-order differences have already moved apart
    np.testing.assert_allclose(b.split_gain, a.split_gain, rtol=1e-4)
    flips = [i for i in range(a.num_leaves - 1) if a.decision_type[i] & 1
             and _cat_set(a, i) != _cat_set(b, i)]
    assert flips
    assert all(not (_cat_set(a, i) & _cat_set(b, i)) for i in flips)


# ------------------------------------------------------------ prediction

def _rows_with_new_categories(n, seed):
    """Held-out rows whose categorical columns also hold categories never
    seen in training, NaN and negative values."""
    X, _ = _cat_data(n, seed)
    rs = np.random.RandomState(seed + 1)
    for f, new in ((5, 7), (6, 45), (7, 500)):
        X[rs.rand(n) < 0.04, f] = new
        X[rs.rand(n) < 0.04, f] = np.nan
        X[rs.rand(n) < 0.04, f] = -2
    return X


def test_port_model_predicts_as_host_walk_and_jax(monkeypatch, tmp_path):
    """A port-trained categorical model goes through the plain K1 with the
    sentinel re-bin of NaN, unseen and negative categories: bit-equal to a
    float32 sum of the host walk's trees, and within the bf16 bound of
    the JAX package's predictions of the same model text (device and host
    walk), whose host walk the port's equals exactly."""
    monkeypatch.setattr(JBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    X, jb, tb = _real_pair()
    Xt = _rows_with_new_categories(1500, 11)
    use, k, _, _ = tb._resolve_tree_slice(0, None)
    inp = tb._device_predict_inputs(Xt, use, k)
    assert inp is not None
    assert any(t.num_cat > 0 for t in use)
    nodes, lv, words, depths = inp.classes[0]
    got = tpk.predict_stream(inp.bins_T, nodes, lv, words, depths)
    want = np.zeros(len(Xt), np.float32)
    for t in use:
        want += t.predict_raw(Xt).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)

    p_port = tb.predict(Xt, raw_score=True)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 10 ** 9)
    p_host = tb.predict(Xt, raw_score=True)
    np.testing.assert_allclose(p_port, p_host, rtol=RTOL, atol=ATOL)
    path = tmp_path / "port.txt"
    tb.save_model(path)
    jl = lgb.Booster(model_file=str(path))
    np.testing.assert_allclose(jl.predict(Xt, raw_score=True), p_port,
                               rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(JBooster, "_DEVICE_PREDICT_MIN_ROWS", 10 ** 9)
    np.testing.assert_array_equal(jl.predict(Xt, raw_score=True), p_host)
    np.testing.assert_allclose(jl.predict(Xt), tb.predict(Xt), rtol=0,
                               atol=1e-6)
    assert lt.Booster(model_file=str(path)).model_to_string() == \
        jl.model_to_string()


def test_validation_walk_matches_jax_on_unseen_categories():
    """Validation scores walk the binned rows, where an unseen, NaN or
    negative category sits in the training mapper's bin 0 (ops/predict.py);
    ``predict`` sends it right.  The port's validation scores equal the
    JAX package's, which differ from its own predictions on those rows
    (ROADMAP.md section 3)."""
    X, y = _cat_data(3000, 3)
    Xv = _rows_with_new_categories(1000, 12)
    yv = (np.nan_to_num(Xv[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "max_bin": 63, "verbosity": -1, "max_splits_per_round": 8,
         "min_data_per_group": 5, "cat_smooth": 1.0,
         "metric": "binary_logloss"}
    jtr = lgb.Dataset(X, label=y, categorical_feature=CAT)
    jb = lgb.train({**p, "hist_backend": "segsum",
                    "hist_precision": "single"}, jtr, 10,
                   valid_sets=[lgb.Dataset(Xv, label=yv, reference=jtr)])
    ttr = lt.Dataset(X, label=y, categorical_feature=CAT, params=CPU)
    tb = lt.train({**p, **CPU}, ttr, 10,
                  valid_sets=[lt.Dataset(Xv, label=yv, reference=ttr)])
    jv = np.asarray(jb.engine._valid_scores[0]).reshape(-1)[:len(Xv)]
    tv = tb.engine.valid_scores[0].numpy().reshape(-1)[:len(Xv)]
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2e-4)
    off = np.abs(jv - jb.predict(Xv, raw_score=True)) > 1e-3
    assert off.any()
    new = np.zeros(len(Xv), bool)
    for f in CAT:
        m = tb.engine.train_data.binned.bin_mappers[f]
        v = Xv[:, f]
        new |= np.isnan(v) | (v < 0) | ~np.isin(v, m.categories)
    assert new[off].all()
