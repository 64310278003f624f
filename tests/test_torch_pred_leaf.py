"""pred_leaf of the port against the JAX package, and SciPy sparse input.

Models are trained by the port on the CPU; the JAX package loads their
model text and walks each tree on the host (lightgbm_tpu/basic.py
:1414-1418).  The port's Booster on its training Dataset takes the device
path once the batch reaches ``_DEVICE_PREDICT_MIN_ROWS`` (lowered here): the
rows binned by ``bin_rows``' plain version and K1's leaf form
(``kernels/predict.py::predict_leaf_plain``) launched once per class.  Leaf
indices are integers: every comparison is exact.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb

import lightgbm_torch as lt
from lightgbm_torch import basic as tbasic
from lightgbm_torch.basic import Booster as TBooster
from lightgbm_torch.kernels import predict as tpk
from lightgbm_torch.utils.log import LightGBMError

CPU = {"device_type": "cpu"}


def _binary_nan(rs):
    X = rs.randn(1500, 6)
    X[rs.rand(1500) < 0.1, 0] = np.nan
    X[rs.rand(1500) < 0.3, 2] = 0.0
    y = (X[:, 1] + np.nan_to_num(X[:, 0]) + 0.5 * X[:, 2]
         + 0.3 * rs.randn(1500) > 0).astype(float)
    Xt = rs.randn(500, 6)
    Xt[rs.rand(500) < 0.1, 0] = np.nan
    Xt[:60, 2] = 0.0
    return X, y, Xt, {"objective": "binary", "zero_as_missing": True}, {}


def _wide_bins(rs):
    """A continuous column at max_bin 400: a group past 256 bins, so the
    bins are 16-bit."""
    X, y, Xt, _, kw = _binary_nan(rs)
    w = rs.rand(len(X))
    y = ((y > 0) ^ (w > 0.9)).astype(float)
    return (np.column_stack([X, w]), y,
            np.column_stack([Xt, rs.rand(len(Xt))]),
            {"objective": "binary", "max_bin": 400}, kw)


def _categorical(rs):
    n = 1500
    X = 0.3 * rs.randn(n, 5)
    X[:, 3] = rs.randint(0, 6, n)
    X[rs.rand(n) < 0.05, 3] = np.nan
    y = (3.0 * np.isin(X[:, 3], [1, 4]) + X[:, 0]
         + 0.1 * rs.randn(n) > 1.0).astype(float)
    Xt = X[:500].copy()
    Xt[rs.rand(500) < 0.1, 3] = np.nan
    Xt[rs.rand(500) < 0.05, 3] = 77.0        # unseen
    Xt[rs.rand(500) < 0.05, 3] = -3.0        # negative
    return (X, y, Xt, {"objective": "binary", "max_cat_to_onehot": 1},
            {"categorical_feature": [3]})


def _multiclass(rs):
    X = rs.randn(1500, 6)
    y = ((X[:, 0] + X[:, 1] > 0).astype(int)
         + (X[:, 2] > 0.5).astype(int)).astype(float)
    return (X, y, rs.randn(500, 6),
            {"objective": "multiclass", "num_class": 3}, {})


MAKERS = {"binary_nan": _binary_nan, "wide_bins": _wide_bins,
          "categorical": _categorical, "multiclass": _multiclass}


@pytest.fixture(scope="module")
def models():
    """name -> (the port's trained Booster, the JAX package's Booster on its
    model text, test rows)."""
    out = {}
    for i, (name, make) in enumerate(sorted(MAKERS.items())):
        X, y, Xt, obj, ds_kw = make(np.random.RandomState(60 + i))
        params = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
                  **obj, **CPU}
        bst = lt.train(params, lt.Dataset(X, label=y, params=dict(params),
                                          **ds_kw), 5)
        out[name] = (bst, lgb.Booster(model_str=bst.model_to_string()), Xt)
    return out


@pytest.fixture
def leaf_launches(monkeypatch):
    """The device batch path from 100 rows, and the classes K1's leaf form
    was launched for."""
    calls = []
    real = tbasic.predict_leaf

    def record(bins_T, nodes, lv, words, depths, out, col0, col_step):
        calls.append((col0, col_step, bins_T.dtype))
        return real(bins_T, nodes, lv, words, depths, out, col0, col_step)

    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    monkeypatch.setattr(tbasic, "predict_leaf", record)
    return calls


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_device_pred_leaf_equals_jax(models, leaf_launches, name):
    bst, jb, Xt = models[name]
    k = bst.num_model_per_iteration()
    got = bst.predict(Xt, pred_leaf=True)
    want = jb.predict(Xt, pred_leaf=True)
    assert got.dtype == np.int32 and got.shape == (len(Xt), bst.num_trees())
    np.testing.assert_array_equal(got, want)
    wide = name == "wide_bins"
    assert leaf_launches == [
        (c, k, torch.int16 if wide else torch.uint8) for c in range(k)]


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_host_pred_leaf_equals_jax(models, name):
    """Below the device batch size, and on a Booster loaded from its text,
    the host walk of each tree."""
    bst, jb, Xt = models[name]
    want = jb.predict(Xt, pred_leaf=True)
    np.testing.assert_array_equal(bst.predict(Xt, pred_leaf=True), want)
    loaded = lt.Booster(model_str=bst.model_to_string(), params=CPU)
    np.testing.assert_array_equal(loaded.predict(Xt, pred_leaf=True), want)


@pytest.mark.parametrize("name", ("binary_nan", "multiclass"))
@pytest.mark.parametrize("start,num", [(1, 3), (2, None), (0, 2)])
def test_pred_leaf_iteration_windows(models, leaf_launches, name, start,
                                     num):
    bst, jb, Xt = models[name]
    got = bst.predict(Xt, pred_leaf=True, start_iteration=start,
                      num_iteration=num)
    want = jb.predict(Xt, pred_leaf=True, start_iteration=start,
                      num_iteration=num)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_plain_leaf_form_equals_walk(models, monkeypatch, name):
    """predict_leaf_plain over the device tables writes each class's trees
    into its columns, each the plain walk of that tree (the score form's
    leaves)."""
    bst, _, Xt = models[name]
    use, k, _, _ = bst._resolve_tree_slice(0, None)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 1)
    inp = bst._device_predict_inputs(Xt, use, k)
    out = torch.full((len(Xt), len(use)), -1, dtype=torch.int32)
    for c, (nodes, lv, words, depths) in enumerate(inp.classes):
        tpk.predict_leaf(inp.bins_T, nodes, lv, words, depths, out, c, k)
        unpacked = tpk.unpack_nodes(nodes)
        for t in range(len(depths)):
            want = tpk.walk_tree_plain(inp.bins_T, unpacked[t], words,
                                       int(depths[t]))
            assert torch.equal(out[:, c + t * k].long(), want)
    assert (out >= 0).all()
    with pytest.raises(LightGBMError, match="no kernel"):
        tpk.predict_leaf(inp.bins_T.to("meta"), *inp.classes[0], out)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("name", ("binary_nan", "categorical",
                                  "multiclass"))
def test_sparse_predict_equals_dense(models, monkeypatch, fmt, name):
    """Every output of a SciPy matrix equals its dense rows', through the
    device paths and the host walks (the categorical model's contributions
    take the host walk)."""
    bst, _, Xt = models[name]
    Xd = np.nan_to_num(Xt)               # sparse: implicit zeros, no NaN
    Xd[np.abs(Xd) < 0.5] = 0.0
    Xs = getattr(sp, f"{fmt}_matrix")(Xd)
    for rows in (100, 10 ** 9):
        monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", rows)
        for kw in ({"raw_score": True}, {"pred_leaf": True},
                   {"pred_contrib": True}, {}):
            got = bst.predict(Xs, validate_features=True, **kw)
            want = bst.predict(Xd, **kw)
            assert got.shape == want.shape
            assert got.tobytes() == want.tobytes(), kw


def test_sparse_predict_in_slabs(models, monkeypatch):
    """Rows that take the host walk (a batch under the device path's
    minimum, or ``pred_contrib``) are made dense a slab at a time
    (``_SPARSE_SLAB_VALUES`` // F rows), predicted slab by slab and
    concatenated."""
    bst, _, Xt = models["binary_nan"]
    Xd = np.nan_to_num(Xt)
    monkeypatch.setattr(tbasic, "_SPARSE_SLAB_VALUES", 64)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", len(Xd) + 1)
    calls = []
    real = TBooster.predict

    def count(self, data, *args, **kwargs):
        calls.append(data.shape[0])
        return real(self, data, *args, **kwargs)

    monkeypatch.setattr(TBooster, "predict", count)
    for kw in ({"pred_leaf": True}, {"raw_score": True},
               {"pred_contrib": True}):
        calls.clear()
        got = bst.predict(sp.csr_matrix(Xd), **kw)
        assert calls[0] == len(Xd) and set(calls[1:-1]) == {64 // 6}
        np.testing.assert_array_equal(got, real(bst, Xd, **kw))


def test_sparse_predict_through_bin_csr(models, monkeypatch):
    """From the device path's minimum up, a SciPy batch is binned whole on
    the device (``kernels/bin_csr.py``'s predict form, its plain version
    here) and walked by K1: one call, no slab, no host walk; the same bytes
    as the dense rows."""
    binned, calls = [], []
    real_binner, real = tbasic.bin_csr_matrix, TBooster.predict
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 5)
    monkeypatch.setattr(tbasic, "bin_csr_matrix", lambda *a, **k: (
        binned.append(a[0].shape), real_binner(*a, **k))[1])
    monkeypatch.setattr(tbasic, "_host_predict", None)
    monkeypatch.setattr(TBooster, "predict", lambda self, data, *a, **k: (
        calls.append(data.shape[0]), real(self, data, *a, **k))[1])
    for name in ("binary_nan", "categorical", "multiclass", "wide_bins"):
        bst, _, Xt = models[name]
        Xd = np.nan_to_num(Xt)
        for kw in ({"pred_leaf": True}, {"raw_score": True}):
            binned.clear()
            calls.clear()
            got = bst.predict(sp.csr_matrix(Xd), **kw)
            assert calls == [len(Xd)] and binned == [Xd.shape], name
            want = real(bst, Xd, **kw)
            assert got.tobytes() == want.tobytes(), name


def test_sparse_dataset_raises():
    """A SciPy sparse Dataset no longer raises: its mappers, groups and
    bins are the JAX package's (tests/test_torch_sparse.py holds them on
    adversarial matrices).  A text data file still raises: loading one is
    not ported."""
    X = sp.random(50, 4, density=0.3, format="csr", random_state=0)
    y = (np.arange(50) % 2).astype(float)
    t = lt.Dataset(X, label=y, params=CPU).construct()
    j = lgb.Dataset(X, label=y).construct()
    assert t.binned.group_features == j.binned.group_features
    assert t.binned.bins.tobytes() == np.asarray(j.binned.bins).tobytes()
    with pytest.raises(LightGBMError, match="not yet ported"):
        lt.Dataset("train.csv", label=y, params=CPU)
