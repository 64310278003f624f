"""Linear trees (``linear_tree``) of the port against the JAX package, on
the CPU: the per-leaf ridge fit on the host, the training and validation
scores it feeds, the model text and its guards.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port with ``device_type="cpu"``.

Tolerances and why:

- Dyadic training: the trees are the JAX package's bit for bit, and the
  fit is the same NumPy float64 operations in the same order on the same
  leaf ids, gradients and raw rows, so the model text (``leaf_const``,
  ``leaf_features``, ``leaf_coeff`` included) is byte-identical, and the
  float32 training and validation scores are bit-equal.
- Prediction after a save and load: the same host walk on the same
  numbers, equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt

from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
_BASE = {"objective": "none", "num_leaves": 15, "max_splits_per_round": 8,
         "hist_precision": "single", "min_data_in_leaf": 20, "max_bin": 63,
         "verbosity": -1, "linear_tree": True}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _linear_data(n=1000, seed=4, nan=True):
    """A piecewise-linear target; feature 0 with NaN (5 %), feature 4
    zero-heavy."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    y = np.where(X[:, 0] > 0, 3.0 * X[:, 1] + 1.0, -2.0 * X[:, 1]) \
        + 0.05 * rs.randn(n)
    if nan:
        X[rs.rand(n) < 0.05, 0] = np.nan
    X[rs.rand(n) < 0.3, 4] = 0.0
    return X, y


def _train(pkg, params, iters=3, data=None, fobj=_dyadic_fobj, valid=None):
    X, y = data if data is not None else _linear_data()
    kw = CPU if pkg is lt else {}
    ds = pkg.Dataset(X, label=y, params={"max_bin": params["max_bin"], **kw})
    bst = pkg.Booster({**params, **kw}, ds)
    if valid is not None:
        bst.add_valid(pkg.Dataset(valid[0], label=valid[1], reference=ds,
                                  params=kw), "valid")
    for _ in range(iters):
        bst.update(fobj=fobj)
    return bst


def _text(bst):
    return _trees_text(bst.model_to_string())


def _same_as_jax(params, **kw):
    tb = _train(lt, params, **kw)
    jb = _train(lgb, params, **kw)
    text = _text(tb)
    assert text == _text(jb)
    return tb, jb, text


# -------------------------------------------------------------- training

@pytest.mark.parametrize("backend,lam", [("stream", 0.0), ("stream", 0.5),
                                         ("scatter", 0.0), ("pallas", 2.0)])
def test_dyadic_training_byte_identical_to_jax(backend, lam):
    """Three linear trees (NaN rows dropped from each leaf's fit, the
    first tree constant): the JAX package's model text byte for byte,
    ``leaf_const`` / ``leaf_features`` / ``leaf_coeff`` included, and the
    training score bit-equal."""
    params = {**_BASE, "linear_lambda": lam, "hist_backend": backend}
    tb, jb, text = _same_as_jax(params)
    assert "is_linear=1" in text and "leaf_coeff=" in text
    trees = tb.engine.models
    assert all(t.is_linear for t in trees)
    assert not any(any(c) for c in trees[0].leaf_coeff)
    assert all(any(len(c) > 0 for c in t.leaf_coeff) for t in trees[1:])
    n = len(_linear_data()[1])
    np.testing.assert_array_equal(tb.engine.score[:n].numpy(),
                                  np.asarray(jb.engine.score)[:n])


def test_lambda_moves_the_coefficients():
    """``linear_lambda`` enters the ridge: other coefficients, the same
    tree structure."""
    a = _train(lt, {**_BASE, "hist_backend": "stream"}).engine.models[1]
    b = _train(lt, {**_BASE, "linear_lambda": 50.0,
                    "hist_backend": "stream"}).engine.models[1]
    assert list(a.split_feature) == list(b.split_feature)
    assert a.leaf_coeff != b.leaf_coeff


def test_validation_scores_equal_jax():
    """A validation set's score takes each linear tree's host walk of its
    raw rows: bit-equal to the JAX package's, and its metric too."""
    X, y = _linear_data(1500, 9)
    params = {**_BASE, "hist_backend": "stream", "metric": "l2",
              "learning_rate": 0.5}
    data, valid = (X[:1000], y[:1000]), (X[1000:], y[1000:])
    tb, jb, _ = _same_as_jax(params, data=data, valid=valid)
    np.testing.assert_array_equal(tb.engine.valid_scores[0][:500].numpy(),
                                  np.asarray(jb.engine._valid_scores[0])[:500])
    (_, name, tv, _), = tb.eval_valid()
    (_, _, jv, _), = jb.eval_valid()
    assert name == "l2" and tv == pytest.approx(jv, rel=1e-6)
    raw = tb.predict(valid[0], raw_score=True)
    np.testing.assert_allclose(tb.engine.valid_scores[0][:500].numpy(), raw,
                               rtol=1e-6, atol=1e-6)


def test_nan_rows_fall_back_to_the_constant():
    """A row with NaN in a leaf's linear feature predicts the leaf's
    constant output: finite predictions, equal to the JAX package's (NaN
    on feature 0, which had NaN in training: the two packages' walks part
    on a NaN at a node of missing type none, ROADMAP §3)."""
    params = {**_BASE, "hist_backend": "stream"}
    tb, jb, _ = _same_as_jax(params)
    X, _ = _linear_data(200, 8, nan=False)
    X[:50, 0] = np.nan
    p = tb.predict(X, raw_score=True)
    assert np.isfinite(p).all()
    np.testing.assert_array_equal(p, jb.predict(X, raw_score=True))
    fell_back = 0
    for t in tb.engine.models:
        leaf = t.predict_leaf_raw(X[:50])
        uses = np.array([0 in t.leaf_features[ln] for ln in leaf])
        out = t.predict_raw(X[:50])
        np.testing.assert_array_equal(out[uses], t.leaf_value[leaf[uses]])
        fell_back += uses.sum()
    assert fell_back > 0


def test_save_load_round_trip(tmp_path):
    """The saved text holds the linear fields, a Booster loaded from it
    predicts as the trained one, and the JAX package loads it to the same
    predictions."""
    bst = _train(lt, {**_BASE, "hist_backend": "stream"})
    X, _ = _linear_data(300, 6)
    p1 = bst.predict(X)
    path = str(tmp_path / "linear.txt")
    bst.save_model(path)
    txt = open(path).read()
    assert "is_linear=1" in txt
    assert "leaf_const=" in txt and "leaf_coeff=" in txt
    np.testing.assert_allclose(lt.Booster(model_file=path).predict(X), p1,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lgb.Booster(model_file=path).predict(X), p1,
                               rtol=1e-12, atol=1e-12)


def test_multiclass_one_class_at_a_time():
    """K = 3 linear class trees, one at a time (no lockstep): the JAX
    package's text byte for byte."""
    params = {**_BASE, "objective": "multiclass", "num_class": 3,
              "learning_rate": 0.5, "min_data_in_leaf": 10,
              "hist_backend": "stream"}
    tb, _, _ = _same_as_jax(params, data=_mc_data(1000, 1),
                            fobj=_dyadic_mc_fobj)
    assert not tb.engine._use_batched_multiclass()


def test_bagging_replayed_rows_byte_identical():
    """Linear trees under bagging at a budget of 64 on 127 leaves: the
    tree grows on compacted rows with K3's replay (growth stays plain),
    and the fit reads every row's replayed leaf."""
    params = {**_BASE, "num_leaves": 127, "max_splits_per_round": 64,
              "min_data_in_leaf": 5, "bagging_fraction": 0.5,
              "bagging_freq": 1, "hist_backend": "stream"}
    tb, _, _ = _same_as_jax(params, data=_linear_data(1500, 3))
    e = tb.engine
    assert e.last_compact_rows > 0 and e.route_only_passes_per_tree() == 1


def test_fused_on_runs_eager():
    """``fused_iter="on"`` with linear trees trains eager without an error
    (reference: gbdt.py:1603-1605)."""
    X, y = _linear_data(1000, 2)
    p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
         "linear_tree": True, **CPU}
    texts = []
    for fused in ("off", "on"):
        b = lt.train({**p, "fused_iter": fused},
                     lt.Dataset(X, label=y, params=CPU), 3)
        assert not b.engine._fused
        texts.append(_text(b))
    assert texts[0] == texts[1]


# ---------------------------------------------------------------- guards

@pytest.mark.parametrize("case,match", [
    ("dart", "not supported with boosting=dart"),
    ("rf", "not supported with boosting=rf"),
    ("freed", "needs the raw feature matrix"),
    ("sparse", "needs the raw feature matrix"),
    ("valid_freed", "validation needs the raw feature matrix")])
def test_guards_raise_as_jax(case, match):
    """The JAX package's errors under the same conditions: dart and rf,
    a Dataset whose raw rows were freed or that holds SciPy sparse rows,
    a validation set without raw rows."""
    import scipy.sparse as sp
    X, y = _linear_data(600, 9, nan=False)
    for pkg in (lt, lgb):
        kw = CPU if pkg is lt else {}
        p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
             "linear_tree": True, **kw}
        data, ds_kw = X, {}
        if case == "dart":
            p["boosting"] = "dart"
        elif case == "rf":
            p.update(boosting="rf", bagging_fraction=0.5, bagging_freq=1)
        elif case == "freed":
            ds_kw["free_raw_data"] = True
        elif case == "sparse":
            data = sp.csr_matrix(X)
        with pytest.raises(pkg.LightGBMError, match=match):
            ds = pkg.Dataset(data, label=y, params=kw, **ds_kw)
            valid = []
            if case == "valid_freed":
                valid = [pkg.Dataset(X[:100], label=y[:100], reference=ds,
                                     params=kw, free_raw_data=True)]
            pkg.train(p, ds, 2, valid_sets=valid)


# ------------------------------------------- the JAX package's own claims

def test_linear_tree_beats_constant_leaves():
    X, y = _linear_data(2000, 4, nan=False)
    p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 20, "learning_rate": 0.2, **CPU}
    const = lt.train(p, lt.Dataset(X, label=y, params=CPU), 10)
    lin = lt.train({**p, "linear_tree": True},
                   lt.Dataset(X, label=y, params=CPU), 10)
    mse_c = float(np.mean((const.predict(X) - y) ** 2))
    mse_l = float(np.mean((lin.predict(X) - y) ** 2))
    assert mse_l < mse_c * 0.7, (mse_l, mse_c)
    trees = lin.engine.models
    assert trees[0].is_linear
    assert any(any(len(c) > 0 for c in t.leaf_coeff) for t in trees[1:])


def test_reset_to_linear_tree():
    """``reset_parameter({"linear_tree": True})`` after two constant
    trees: the next trees are linear in both packages (the JAX package
    reads the flag at each iteration), byte for byte."""
    params = {k: v for k, v in _BASE.items() if k != "linear_tree"}
    params["hist_backend"] = "stream"
    texts = []
    for pkg in (lt, lgb):
        bst = _train(pkg, params, iters=2)
        bst.reset_parameter({"linear_tree": True})
        for _ in range(2):
            bst.update(fobj=_dyadic_fobj)
        texts.append(_text(bst))
    assert texts[0] == texts[1]
    trees = bst.engine.models
    assert not any(t.is_linear for t in trees[:2])
    assert all(t.is_linear for t in trees[2:])
