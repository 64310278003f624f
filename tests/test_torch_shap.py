"""SHAP contributions (pred_contrib) of the port against the JAX package.

Models are trained by the port on the CPU and loaded from their model text
into both packages, so both walk the same trees.  Tolerances:

- the exact host walk (``lightgbm_torch/shap.py``, a copy of the JAX
  package's) byte-identical to the JAX package's;
- the stock fixture ``stock_pred_binary_contrib.txt``: atol 1e-12, as
  tests/test_golden.py holds the JAX package;
- ``tree_shap_plain`` (the device TreeSHAP's plain version, float64)
  against the host walk: rtol 1e-9 / atol 1e-12 of the row's scale, since
  it extends a repeated feature's slot in another order;
- against the JAX package's float32 device TreeSHAP (``_shap_device``, run
  on the CPU through LGBTPU_SHAP_DEVICE=1 as tests/test_shap_batch.py runs
  it): rtol 2e-4 / atol 2e-5 on rows off the split thresholds, that test's
  bound;
- additivity: contributions sum to the float64 host raw score within 1e-9
  relative, and to ``predict(raw_score=True)`` on the K1 path within
  predict's rtol 1e-4 / atol 1e-5.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu import shap as jshap

import lightgbm_torch as lt
from lightgbm_torch import basic as tbasic
from lightgbm_torch import shap as tshap
from lightgbm_torch.basic import Booster as TBooster
from lightgbm_torch.basic import _host_predict
from lightgbm_torch.kernels import tree_shap as kts
from lightgbm_torch.tree import Tree

CPU = {"device_type": "cpu"}
FIX = Path(__file__).parent / "fixtures"
F = 7


def _rows(rs, n):
    X = rs.randn(n, F)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 2] = 0.0
    X[:, 5] = rs.randint(0, 5, n)
    return X


def _binary(rs):
    X = _rows(rs, 2000)
    y = (X[:, 1] + np.nan_to_num(X[:, 0]) + 0.7 * X[:, 2]
         + 0.3 * rs.randn(2000) > 0).astype(float)
    return X, y, {"objective": "binary"}, {}


def _zero_as_missing(rs):
    X, y, p, kw = _binary(rs)
    return X, y, {**p, "zero_as_missing": True}, kw


def _multiclass(rs):
    X = _rows(rs, 2000)
    y = ((X[:, 1] > 0).astype(int) + (X[:, 3] > 0.5)).astype(float)
    return X, y, {"objective": "multiclass", "num_class": 3}, {}


def _categorical(rs):
    X = _rows(rs, 2000)
    y = (np.isin(X[:, 5], [1, 3]) + 0.5 * X[:, 1]
         + 0.2 * rs.randn(2000) > 0.5).astype(float)
    return X, y, {"objective": "binary", "max_cat_to_onehot": 1}, {
        "categorical_feature": [5]}


MAKERS = {"binary": _binary, "zero_as_missing": _zero_as_missing,
          "multiclass": _multiclass, "categorical": _categorical}
NUMERIC = ("binary", "zero_as_missing", "multiclass")


@pytest.fixture(scope="module")
def models():
    """name -> (trained port Booster, its model text, test rows)."""
    out = {}
    for i, (name, make) in enumerate(sorted(MAKERS.items())):
        rs = np.random.RandomState(40 + i)
        X, y, obj, ds_kw = make(rs)
        params = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
                  **obj, **CPU}
        bst = lt.train(params, lt.Dataset(X, label=y, params=dict(params),
                                          **ds_kw), 6)
        out[name] = (bst, bst.model_to_string(), _rows(rs, 400))
    return out


@pytest.fixture
def device_shap(monkeypatch):
    """A record of the device TreeSHAP's calls (their devices)."""
    calls = []
    real = tbasic.predict_contrib_device

    def record(*args, **kwargs):
        calls.append(args[3])
        return real(*args, **kwargs)

    monkeypatch.setattr(tbasic, "predict_contrib_device", record)
    return calls


def _scale(c):
    return np.abs(c).max(axis=1, keepdims=True) + 1.0


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_host_walk_byte_identical_to_jax(models, name):
    _, text, Xt = models[name]
    jb = lgb.Booster(model_str=text)
    tb = lt.Booster(model_str=text, params=CPU)
    got = tshap.predict_contrib(tb._all_trees(), Xt,
                                tb.num_model_per_iteration())
    want = jb.predict(Xt, pred_contrib=True)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_leaf_paths_equal_jax(models, name):
    bst, _, _ = models[name]
    for t in bst._all_trees():
        if t.num_leaves <= 1:
            continue
        D = tshap._raw_tree_depth(t)
        assert D == jshap._raw_tree_depth(t)
        for a, b in zip(tshap._leaf_paths(t, D), jshap._leaf_paths(t, D)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _stock():
    rows = [[np.nan if v == "" else float(v) for v in line.split(",")]
            for line in (FIX / "golden_X.csv").read_text().splitlines()]
    return np.asarray(rows), lt.Booster(
        model_file=str(FIX / "stock_binary.model"), params=CPU)


def test_stock_contrib_fixture_host_walk():
    X, bst = _stock()
    np.testing.assert_allclose(
        tshap.predict_contrib(bst._all_trees(), X, 1),
        np.loadtxt(FIX / "stock_pred_binary_contrib.txt"), rtol=0,
        atol=1e-12)


def test_stock_contrib_fixture_plain(device_shap):
    X, bst = _stock()
    got = bst.predict(X, pred_contrib=True)
    assert device_shap == [torch.device("cpu")]
    np.testing.assert_allclose(
        got, np.loadtxt(FIX / "stock_pred_binary_contrib.txt"), rtol=0,
        atol=1e-12)


@pytest.mark.parametrize("name", NUMERIC)
def test_plain_against_host_walk(models, device_shap, name):
    bst, text, Xt = models[name]
    host = tshap.predict_contrib(bst._all_trees(), Xt,
                                 bst.num_model_per_iteration())
    for b in (bst, lt.Booster(model_str=text, params=CPU)):
        got = b.predict(Xt, pred_contrib=True)
        np.testing.assert_allclose(got, host, rtol=1e-9,
                                   atol=1e-12 * _scale(host).max())
        assert np.all(np.abs(got - host) <= 1e-9 * _scale(host))
    assert len(device_shap) == 2


@pytest.mark.parametrize("name", ("binary", "multiclass"))
def test_plain_against_jax_device_shap(models, monkeypatch, name):
    """Rows off the thresholds: no feature within 1e-4 of a split value,
    so the float32 compare of the JAX kernel decides as float64 does."""
    _, text, Xt = models[name]
    tb = lt.Booster(model_str=text, params=CPU)
    trees = tb._all_trees()
    thr = np.concatenate([t.threshold[:t.num_leaves - 1] for t in trees])
    feats = np.concatenate([t.split_feature[:t.num_leaves - 1]
                            for t in trees])
    near = np.zeros(len(Xt), bool)
    for f, v in zip(feats, thr):
        near |= np.abs(Xt[:, f] - v) < 1e-4
    Xo = Xt[~near]
    assert len(Xo) > 200
    monkeypatch.setenv("LGBTPU_SHAP_DEVICE", "1")
    want = lgb.Booster(model_str=text).predict(Xo, pred_contrib=True)
    got = tb.predict(Xo, pred_contrib=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_plain_kernel_contract_on_tables(models):
    """``tree_shap`` on CPU tensors is ``tree_shap_plain``, and its last
    column is zero (the expected values are the host's)."""
    bst, _, Xt = models["multiclass"]
    trees = bst._all_trees()
    host, base = tshap.shap_tables(trees, 3, tshap.device_depth(trees))
    tabs = kts.ShapTables(*(torch.as_tensor(a) for a in host))
    X_T = torch.as_tensor(np.ascontiguousarray(Xt.T))
    a = kts.tree_shap(X_T, tabs, 3)
    b = kts.tree_shap_plain(X_T, tabs, 3)
    assert a.shape == (len(Xt), 3, F + 1) and a.dtype == torch.float64
    assert torch.equal(a, b)
    assert (a[:, :, F] == 0).all()
    np.testing.assert_allclose(
        base, [sum(t.expected_value() for t in trees[c::3])
               for c in range(3)])


def test_plain_in_row_chunks(models, monkeypatch):
    """The plain version over row chunks (its temporaries bounded) gives
    the bytes of one pass over all rows."""
    bst, _, Xt = models["binary"]
    trees = bst._all_trees()
    host, _ = tshap.shap_tables(trees, 1, tshap.device_depth(trees))
    tabs = kts.ShapTables(*(torch.as_tensor(a) for a in host))
    X_T = torch.as_tensor(np.ascontiguousarray(Xt.T))
    whole = kts.tree_shap_plain(X_T, tabs, 1)
    L, D = host.feat.shape[1:]
    monkeypatch.setattr(kts, "PLAIN_CHUNK_VALUES", 7 * L * (D + 1))
    assert torch.equal(kts.tree_shap_plain(X_T, tabs, 1), whole)


@pytest.mark.parametrize("name", ("binary", "multiclass"))
def test_device_contrib_in_row_chunks(models, monkeypatch, name):
    """predict_contrib_device launches once a row chunk (the rows' values
    and contributions within ``chunk_bytes``) and gives the bytes of one
    launch over all rows."""
    bst, _, Xt = models[name]
    trees = bst._all_trees()
    k = bst.num_model_per_iteration()
    depth = tshap.device_depth(trees)
    cpu = torch.device("cpu")
    whole = tshap.predict_contrib_device(trees, Xt, k, cpu, depth)
    calls = []
    real = tshap.tree_shap

    def record(X_T, tables, num_class):
        calls.append(X_T.shape[1])
        return real(X_T, tables, num_class)

    monkeypatch.setattr(tshap, "tree_shap", record)
    chunked = tshap.predict_contrib_device(
        trees, Xt, k, cpu, depth, chunk_bytes=7 * 8 * (F + k * (F + 1)))
    assert calls == [7] * (len(Xt) // 7) + [len(Xt) % 7]
    assert chunked.tobytes() == whole.tobytes()


def _chain(n_int, n_feat, rs):
    """A zigzag chain of ``n_int`` numeric nodes: node i splits feature
    i % n_feat, NaN missing (zero-as-missing at i % 4 == 1), default left
    at every third node, and keeps one leaf child, so the deepest leaves'
    paths hold min(n_int, n_feat) unique slots."""
    i = np.arange(n_int)
    left = np.where(i % 2 == 0, ~i, i + 1)
    right = np.where(i % 2 == 0, i + 1, ~i)
    left[-1], right[-1] = ~(n_int - 1), ~n_int
    leaf_count = rs.randint(1, 50, n_int + 1).astype(np.float64)
    internal_count = np.zeros(n_int)
    for j in range(n_int - 1, -1, -1):
        internal_count[j] = sum(leaf_count[~c] if c < 0 else
                                internal_count[c] for c in (left[j],
                                                            right[j]))
    return Tree(
        num_leaves=n_int + 1, split_feature=i % n_feat,
        threshold_bin=np.zeros(n_int, np.int32),
        threshold=0.3 * rs.randn(n_int),
        decision_type=(np.where(i % 3 == 0, 2, 0)
                       | np.where(i % 4 == 1, 1, 2) << 2).astype(np.uint8),
        left_child=left, right_child=right, split_gain=np.ones(n_int),
        internal_value=np.zeros(n_int), internal_weight=internal_count,
        internal_count=internal_count, leaf_value=rs.randn(n_int + 1),
        leaf_weight=leaf_count, leaf_count=leaf_count)


@pytest.mark.parametrize("n_feat", (24, 13))
def test_device_contrib_on_deep_paths(n_feat):
    """Paths of 24 raw nodes, 24 unique slots (the kernel's most) or 13
    with repeated features: the device TreeSHAP's plain version within
    1e-9 of each row's scale of the exact host walk, and additive."""
    rs = np.random.RandomState(n_feat)
    trees = [_chain(24, n_feat, rs), _chain(17, n_feat, rs)]
    assert tshap.device_depth(trees) == kts.MAX_DEPTH
    host_tabs, _ = tshap.shap_tables(trees, 1, kts.MAX_DEPTH)
    assert host_tabs.plen.max() == min(24, n_feat)
    X = 0.5 * rs.randn(300, 24)
    X[rs.rand(300, 24) < 0.05] = np.nan
    X[rs.rand(300, 24) < 0.05] = 0.0
    got = tshap.predict_contrib_device(trees, X, 1, torch.device("cpu"),
                                       kts.MAX_DEPTH)
    host = tshap.predict_contrib(trees, X, 1)
    assert np.all(np.abs(got - host) <= 1e-9 * _scale(host))
    raw = sum(t.predict_raw(X) for t in trees)
    np.testing.assert_allclose(got.sum(axis=1), raw, rtol=1e-9, atol=1e-12)


def test_gate_takes_the_host_walk(models, device_shap):
    """Categorical trees and a tree deeper than 24 take the exact host
    walk; numeric trees take the device TreeSHAP from one row."""
    bst, _, Xt = models["categorical"]
    assert any((t.decision_type[:t.num_leaves - 1] & 1).any()
               for t in bst._all_trees())
    assert tshap.device_depth(bst._all_trees()) == 0
    got = bst.predict(Xt, pred_contrib=True)
    assert device_shap == []
    assert got.tobytes() == tshap.predict_contrib(bst._all_trees(), Xt,
                                                  1).tobytes()
    bst, _, Xt = models["binary"]
    bst.predict(Xt[:1], pred_contrib=True)
    assert device_shap == [torch.device("cpu")]
    # a chain 25 deep: node i splits feature i % F, its left child a leaf
    n_int = 25
    chain = Tree(
        num_leaves=n_int + 1, split_feature=np.arange(n_int) % F,
        threshold_bin=np.zeros(n_int, np.int32),
        threshold=np.linspace(-2, 2, n_int),
        decision_type=np.zeros(n_int, np.uint8),
        left_child=~np.arange(n_int),
        right_child=np.append(np.arange(1, n_int), ~n_int),
        split_gain=np.ones(n_int), internal_value=np.zeros(n_int),
        internal_weight=np.ones(n_int),
        internal_count=np.ones(n_int),
        leaf_value=np.linspace(-1, 1, n_int + 1),
        leaf_weight=np.ones(n_int + 1), leaf_count=np.ones(n_int + 1))
    assert tshap._raw_tree_depth(chain) == 25
    assert tshap.device_depth([chain]) == 0


@pytest.mark.parametrize("name", NUMERIC)
def test_additivity(models, device_shap, monkeypatch, name):
    bst, _, Xt = models[name]
    k = bst.num_model_per_iteration()
    contrib = bst.predict(Xt, pred_contrib=True).reshape(len(Xt), k, F + 1)
    use = bst._all_trees()
    host = _host_predict(Xt, use, k, False, 10, 10.0).reshape(len(Xt), k)
    np.testing.assert_allclose(contrib.sum(axis=2), host, rtol=1e-9,
                               atol=1e-12)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    raw = bst.predict(Xt, raw_score=True).reshape(len(Xt), k)
    np.testing.assert_allclose(contrib.sum(axis=2), raw, rtol=1e-4,
                               atol=1e-5)


def test_multiclass_layout(models):
    """(N, K (F + 1)): class c's contributions in columns c (F + 1) ..,
    its expected value last, equal to the JAX package's layout."""
    bst, text, Xt = models["multiclass"]
    trees = bst._all_trees()
    host = tshap.predict_contrib(trees, Xt, 3)
    assert host.shape == (len(Xt), 3 * (F + 1))
    want = lgb.Booster(model_str=text).predict(Xt, pred_contrib=True)
    assert host.tobytes() == want.tobytes()
    # the device TreeSHAP's plain version, in the same layout
    got = bst.predict(Xt, pred_contrib=True)
    assert got.shape == host.shape
    assert np.all(np.abs(got - host) <= 1e-9 * _scale(host))
    for c in range(3):
        ev = sum(t.expected_value() for t in trees[c::3])
        np.testing.assert_allclose(got[:, c * (F + 1) + F], ev, rtol=1e-12)


@pytest.mark.parametrize("est", ["regressor", "classifier"])
def test_estimators_pred_contrib(est):
    rs = np.random.RandomState(9)
    X = _rows(rs, 600)
    y = X[:, 1] + np.nan_to_num(X[:, 0]) + 0.1 * rs.randn(600)
    if est == "regressor":
        m = lt.LGBMRegressor(n_estimators=4, num_leaves=7, verbose=-1,
                             device_type="cpu").fit(X, y)
    else:
        m = lt.LGBMClassifier(n_estimators=4, num_leaves=7, verbose=-1,
                              device_type="cpu").fit(X, (y > 0).astype(int))
    got = m.predict(X[:100], pred_contrib=True)
    want = lgb.Booster(model_str=m.booster_.model_to_string()).predict(
        X[:100], pred_contrib=True)
    assert got.shape == (100, F + 1)
    # numeric trees: the device TreeSHAP's plain version (float64, another
    # summation order); the host walk byte for byte
    assert np.all(np.abs(got - want) <= 1e-9 * _scale(want))
    host = tshap.predict_contrib(m.booster_._all_trees(), X[:100], 1)
    assert host.tobytes() == want.tobytes()
    leaf = m.predict(X[:100], pred_leaf=True)
    np.testing.assert_array_equal(leaf, lgb.Booster(
        model_str=m.booster_.model_to_string()).predict(X[:100],
                                                        pred_leaf=True))
