"""pandas DataFrames with category columns in the port, against the JAX
package, on the CPU.

A ``category`` column is a categorical feature: both packages code it
(``cat.codes``, missing -> NaN), record its category lists as the model's
``pandas_categorical`` line, and recode a validation or predict frame
through those lists, so that codes agree whatever the frame's category
order; a category training did not see becomes NaN.  The same frames go
through the JAX package and through the port with ``device_type="cpu"``.

Tolerances: model text on dyadic custom gradients (``hist_precision``
single) byte-identical, the ``pandas_categorical`` line included;
validation metrics and predictions equal (the same float64 host walk on
both sides below the device path's row gate; the device path's K1 plain
version adds float32 leaf values, within rtol 1e-4 / atol 1e-5).
"""
import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb

import lightgbm_torch as lt
from lightgbm_torch import basic as tbasic

from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
BASE = {"objective": "none", "hist_precision": "single", "num_leaves": 7,
        "max_splits_per_round": 1, "min_data_in_leaf": 5,
        "min_data_per_group": 5, "verbosity": -1}


def _frame(n, seed, kind="int", order=None):
    """Two category columns (12 integer or string categories, Zipf-ish;
    4 lower-case letters) and two float columns; ``order`` lists the first
    column's categories in another order."""
    rs = np.random.RandomState(seed)
    a = rs.choice(12, n, p=np.arange(12, 0, -1) / 78.0)
    vals = a if kind == "int" else np.array([f"c{i:02d}" for i in a])
    cats = order if order is not None else (
        list(range(12)) if kind == "int" else [f"c{i:02d}" for i in range(12)])
    df = pd.DataFrame({
        "a": pd.Categorical(vals, categories=cats),
        "x": rs.randn(n),
        "b": pd.Categorical(rs.choice(list("pqrs"), n)),
        "z": rs.rand(n)})
    y = (a % 3 == 0) * 1.0 + 0.5 * df["x"].to_numpy() \
        + (df["b"] == "q") * 0.7
    return df, np.asarray(y, np.float64)


def _pandas_line(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("pandas_categorical:")]


def _train_both(df, y, iters=3, extra=None):
    p = {**BASE, **(extra or {})}
    jb = lgb.Booster(p, lgb.Dataset(df, label=y))
    tb = lt.Booster({**p, **CPU}, lt.Dataset(df, label=y, params=CPU))
    for _ in range(iters):
        jb.update(fobj=_dyadic_fobj)
        tb.update(fobj=_dyadic_fobj)
    return jb, tb


@pytest.mark.parametrize("kind", ["int", "str"])
def test_category_columns_train_as_in_jax(kind):
    """Category columns become categorical features: the same trees (with
    categorical nodes), feature names and pandas_categorical line."""
    df, y = _frame(3000, 0, kind)
    jb, tb = _train_both(df, y)
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert _trees_text(tt) == _trees_text(jt)
    assert _pandas_line(tt) == _pandas_line(jt)
    assert _pandas_line(tt)[0] != "pandas_categorical:null"
    assert "feature_names=a x b z" in tt
    assert tb.train_set._resolve_categorical() == [0, 2]
    dts = [int(v) for t in tb.engine.models
           for v in t.decision_type[:t.num_leaves - 1]]
    assert any(d & 1 for d in dts)
    np.testing.assert_array_equal(tb.predict(df), jb.predict(df))


def test_reordered_and_unseen_categories_align_to_training():
    """A validation frame and a predict frame whose category lists are in
    another order, with categories training never saw: codes align to the
    training lists (unseen -> NaN), so validation metrics and predictions
    equal the JAX package's, and the reordered frame predicts as the
    training-ordered one does."""
    df, y = _frame(3000, 1)
    jb, tb = _train_both(df, y, extra={"metric": "l2"})
    order = [11, 3, 0, 7, 1, 5, 2, 9, 4, 8, 6, 10, 12, 13]
    vdf, vy = _frame(1500, 2, order=order)
    # categories 12 and 13 exist in the frame's list but not in training's
    vdf.loc[vdf.index[:40], "a"] = 12
    vdf.loc[vdf.index[40:60], "a"] = 13
    tv = lt.Dataset(vdf, label=vy, reference=tb.train_set, params=CPU)
    jv = lgb.Dataset(vdf, label=vy, reference=jb.train_set)
    tb.add_valid(tv, "v")
    jb.add_valid(jv, "v")
    assert tb.eval_valid() == [(n, m, v, h) for n, m, v, h in jb.eval_valid()]
    assert np.isnan(tv.raw_data[:60, 0]).all()
    same = vdf.copy()
    same["a"] = same["a"].cat.set_categories(list(range(12)))
    np.testing.assert_array_equal(tb.predict(vdf), jb.predict(vdf))
    np.testing.assert_array_equal(tb.predict(vdf), tb.predict(same))


def test_save_load_round_trip_keeps_the_category_lists(tmp_path):
    """A model saved and loaded keeps its pandas_categorical line, and the
    loaded Booster aligns a reordered string frame as the trained one does;
    the JAX package reads the port's file to the same predictions."""
    order = [f"c{i:02d}" for i in (4, 0, 11, 1, 10, 2, 9, 3, 8, 5, 7, 6)]
    df, y = _frame(3000, 3, "str")
    _, tb = _train_both(df, y)
    path = tmp_path / "m.txt"
    tb.save_model(path)
    loaded = lt.Booster(model_file=path)
    assert _pandas_line(loaded.model_to_string()) == \
        _pandas_line(tb.model_to_string())
    pdf, _ = _frame(2000, 4, "str", order=order)
    want = tb.predict(pdf)
    np.testing.assert_array_equal(loaded.predict(pdf), want)
    np.testing.assert_array_equal(
        lgb.Booster(model_file=str(path)).predict(pdf), want)


def test_device_predict_path_aligns_frames(monkeypatch):
    """Through the device path (K1's and bin_rows' plain versions), a
    reordered frame predicts within rtol 1e-4 / atol 1e-5 of the JAX
    package."""
    monkeypatch.setattr(tbasic.Booster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    df, y = _frame(3000, 5)
    jb, tb = _train_both(df, y)
    pdf, _ = _frame(2000, 6, order=list(range(11, -1, -1)))
    use, k, _, _ = tb._resolve_tree_slice(0, None)
    X = tbasic._to_2d_float(pdf, tb._pandas_categorical())[0]
    assert tb._device_predict_inputs(X, use, k) is not None
    np.testing.assert_allclose(tb.predict(pdf), jb.predict(pdf), rtol=1e-4,
                               atol=1e-5)


def test_frames_that_do_not_match_raise():
    df, y = _frame(500, 7)
    ds = lt.Dataset(df, label=y, params=CPU).construct()
    bad = df.copy()
    bad["b"] = bad["b"].astype(str).astype(object)
    with pytest.raises(lt.LightGBMError, match="object dtype"):
        lt.Dataset(bad, label=y, params=CPU)
    with pytest.raises(lt.LightGBMError, match="categorical columns must "
                                              "match training"):
        lt.Dataset(df.drop(columns=["b"]).assign(b=0.0), label=y,
                   reference=ds, params=CPU)
