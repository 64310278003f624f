"""The port's host walk at a NaN: stock LightGBM's ``NumericalDecision``.

A NaN at a numerical node of missing type none is compared as 0.0 (it goes
where 0.0 goes, not the default way); zero-as-missing and NaN-missing nodes
keep their default direction, categorical nodes their bitset.  The walk is
held to a transcription of ``Tree::NumericalDecision`` (include/LightGBM/
tree.h) written here, on a stock LightGBM model and a model the port
trains, over rows with NaN in features that had none in training.  The
same rows predict the same bytes below and at ``_DEVICE_PREDICT_MIN_ROWS``
(the device path's plain versions on the CPU), and ``pred_contrib`` sums to
the raw score within 1e-9.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_torch as lt

CPU = {"device_type": "cpu"}
FIXTURES = Path(__file__).resolve().parent / "fixtures"


def numerical_decision(tree, node, fval):
    """Tree::NumericalDecision and CategoricalDecision, node by node: True
    when the row goes left."""
    dt = int(tree.decision_type[node])
    if dt & 1:
        if np.isnan(fval) or fval < 0:
            return False
        c = int(fval)
        k = int(tree.threshold_bin[node])
        s, e = tree.cat_boundaries[k], tree.cat_boundaries[k + 1]
        return c // 32 < e - s and bool(
            (int(tree.cat_threshold[s + c // 32]) >> (c % 32)) & 1)
    missing_type = (dt >> 2) & 3
    if np.isnan(fval) and missing_type != 2:
        fval = 0.0
    if (missing_type == 1 and -1e-35 < fval < 1e-35) \
            or (missing_type == 2 and np.isnan(fval)):
        return bool(dt & 2)
    return fval <= tree.threshold[node]


def walk(trees, X):
    """(N, trees) leaf of each row in each tree."""
    out = np.zeros((len(X), len(trees)), np.int32)
    for j, t in enumerate(trees):
        for i, x in enumerate(X):
            node = 0
            while t.num_leaves > 1 and node >= 0:
                f = int(t.split_feature[node])
                node = (t.left_child[node] if numerical_decision(t, node, x[f])
                        else t.right_child[node])
            out[i, j] = ~node if t.num_leaves > 1 else 0
    return out


def _with_nan(X, rs, cols):
    X = X.copy()
    for c in cols:
        X[rs.rand(len(X)) < 0.3, c] = np.nan
    return X


@pytest.fixture(scope="module")
def stock():
    bst = lt.Booster(model_file=str(FIXTURES / "stock_binary.model"),
                     params=CPU)
    X = np.asarray([[np.nan if v == "" else float(v) for v in line.split(",")]
                    for line in (FIXTURES / "golden_X.csv").read_text()
                    .splitlines()])
    return bst, X


@pytest.fixture
def trained():
    """A binary model trained on rows without NaN, so every numeric node
    is of missing type none or zero."""
    rs = np.random.RandomState(5)
    n = 3000
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.3, 4] = 0.0
    y = (X[:, 0] - X[:, 1] + 0.5 * X[:, 4] + 0.3 * rs.randn(n)
         > 0.2).astype(float)
    ds = lt.Dataset(X, label=y, params=CPU)
    bst = lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
                    **CPU}, ds, 5)
    return bst, X


@pytest.mark.parametrize("which", ["stock", "trained"])
def test_host_walk_follows_numerical_decision(which, stock, trained):
    bst, X = stock if which == "stock" else trained
    trees = bst._all_trees()
    types = {(int(d) >> 2) & 3 for t in trees
             for d in t.decision_type[:t.num_leaves - 1]}
    assert 0 in types
    Xn = _with_nan(X[:400], np.random.RandomState(1), range(X.shape[1]))
    leaves = walk(trees, Xn)
    np.testing.assert_array_equal(bst.predict(Xn, pred_leaf=True), leaves)
    # the raw score is the sum of those leaves' values (in the walk's
    # float64 order, within one ulp of the sum here)
    want = sum(np.asarray(t.leaf_value)[leaves[:, j]]
               for j, t in enumerate(trees))
    np.testing.assert_allclose(bst.predict(Xn, raw_score=True), want,
                               rtol=1e-15, atol=1e-15)


def test_same_bytes_below_and_at_the_device_minimum(trained):
    """19 999 rows take the host walk, 20 000 the device path (bin_rows
    bins a NaN at a feature of missing type none as 0.0, K1 walks bins):
    the rows they share predict the same bytes.  The leaf values are set
    to multiples of 1/64 first, so that K1's float32 sum and the walk's
    float64 sum are both exact and only a decision could tell them
    apart."""
    bst, X = trained
    for ti, t in enumerate(bst._all_trees()):
        for leaf in range(t.num_leaves):
            bst.set_leaf_output(ti, leaf, np.round(t.leaf_value[leaf] * 64)
                                / 64)
    rs = np.random.RandomState(2)
    rows = X[rs.randint(0, len(X), 20_000)]
    rows = _with_nan(rows, rs, [0, 1, 4])
    assert bst._device_cat_features(20_000, bst._all_trees(), 1) is not None
    assert bst._device_cat_features(19_999, bst._all_trees(), 1) is None
    at = bst.predict(rows, raw_score=True)
    below = bst.predict(rows[:19_999], raw_score=True)
    assert at[:19_999].tobytes() == below.tobytes()
    leaf_at = bst.predict(rows, pred_leaf=True)
    leaf_below = bst.predict(rows[:19_999], pred_leaf=True)
    assert leaf_at[:19_999].tobytes() == leaf_below.tobytes()


@pytest.mark.parametrize("which", ["stock", "trained"])
def test_contributions_sum_to_the_raw_score(which, stock, trained):
    bst, X = stock if which == "stock" else trained
    Xn = _with_nan(X[:300], np.random.RandomState(3), range(X.shape[1]))
    contrib = bst.predict(Xn, pred_contrib=True)
    raw = bst.predict(Xn, raw_score=True)
    np.testing.assert_allclose(contrib.sum(axis=1), raw, rtol=0, atol=1e-9)
