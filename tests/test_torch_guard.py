"""The port's ``nan_guard`` against the JAX package's, on the CPU.

The same numpy inputs go through the JAX package (its stream kernel in
Pallas interpret mode) and through the port with ``device_type="cpu"``:
2 000 rows x 5 features, binary, ``hist_backend="stream"``, 7 leaves.
What is compared is integer: tree counts, leaf counts and the values
``update`` returns.  Where the port is compared with itself (a NaN init
score against a zero one) the model text must be byte-identical.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.robustness.guards import (NanGuard, check_finite_init,
                                              resolve_mode)

CPU = {"device_type": "cpu"}
PARAMS = {"objective": "binary", "num_leaves": 7, "hist_backend": "stream",
          "hist_precision": "single", "max_splits_per_round": 64,
          "verbosity": -1}
BAD_ROWS = [3, 50, 700]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _data(n=2000, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    y = (X[:, 0] + 0.5 * rs.randn(n) > 0).astype(float)
    return X, y


def _trees_text(bst):
    return bst.model_to_string().split("\nparameters:")[0]


def _nan_fobj(bad_call):
    """Logistic gradients with a constant hessian; the ``bad_call``-th call
    puts NaN in three rows' gradients."""
    calls = [0]

    def fobj(score, ds):
        calls[0] += 1
        g = (1 / (1 + np.exp(-score)) - ds.get_label()).astype(np.float32)
        h = np.full(len(g), 0.25, np.float32)
        if calls[0] == bad_call:
            g[BAD_ROWS] = np.nan
        return g, h
    return fobj


def test_nan_init_scores_train_as_the_jax_package():
    """Three NaN init scores: both packages zero them and train all 5
    trees (the unguarded port stopped after one single-leaf tree); the
    port's model is the one trained from zeros in their place."""
    X, y = _data()
    init = np.zeros(len(y))
    init[BAD_ROWS] = np.nan
    jb = lgb.train(PARAMS, lgb.Dataset(X, label=y, init_score=init), 5)
    tb = lt.train({**PARAMS, **CPU},
                  lt.Dataset(X, label=y, init_score=init, params=CPU), 5)
    assert jb.num_trees() == tb.num_trees() == 5
    assert [t.num_leaves for t in tb.engine.models] == \
        [t.num_leaves for t in jb.engine.models]
    clean = np.nan_to_num(init)
    ref = lt.train({**PARAMS, **CPU},
                   lt.Dataset(X, label=y, init_score=clean, params=CPU), 5)
    assert _trees_text(tb) == _trees_text(ref)
    assert np.isfinite(tb.predict(X)).all()


@pytest.mark.parametrize("mode,returns,leaves,hits", [
    ("warn", [False] * 4, [7, 1, 7, 7], 1),
    ("skip", [False] * 4, [7, 1, 7, 7], 1),
    ("none", [False, True, False, False], [7, 7, 7], 0),
])
def test_nan_gradients_at_the_second_update(mode, returns, leaves, hits):
    """NaN gradients at the 2nd of 4 ``update(fobj=...)`` calls.  Guarded,
    the iteration grows a no-op tree, ``update`` returns False and all 4
    trees are kept, as in the JAX package; unguarded both packages report
    the poisoned iteration as the end of training and drop its tree."""
    X, y = _data()
    got = {}
    for pkg, kw in ((lgb, {}), (lt, CPU)):
        bst = pkg.Booster({**PARAMS, "nan_guard": mode, **kw},
                          pkg.Dataset(X, label=y, params=kw or None))
        fobj = _nan_fobj(2)
        rets = [bst.update(fobj=fobj) for _ in range(4)]
        got[pkg.__name__] = (rets, [t.num_leaves for t in bst.engine.models])
    assert got["lightgbm_tpu"] == got["lightgbm_torch"] == (returns, leaves)
    assert bst.engine._nan_guard.hits == hits


def test_warn_logs_the_skipped_iteration(caplog):
    X, y = _data()
    bst = lt.Booster({**PARAMS, "verbosity": 0, **CPU},
                     lt.Dataset(X, label=y, params=CPU))
    fobj = _nan_fobj(1)
    with caplog.at_level(logging.WARNING, logger="lightgbm_torch"):
        assert bst.update(fobj=fobj) is False
    assert "non-finite gradients/hessians at iteration 1" in caplog.text


def test_raise_mode_raises():
    """``nan_guard="raise"``: a NaN init score and a NaN gradient are each
    a LightGBMError, as in the JAX package."""
    X, y = _data()
    init = np.zeros(len(y))
    init[BAD_ROWS] = np.nan
    params = {**PARAMS, "nan_guard": "raise", **CPU}
    with pytest.raises(lt.LightGBMError, match="nan_guard=raise"):
        lt.train(params, lt.Dataset(X, label=y, init_score=init, params=CPU),
                 2)
    with pytest.raises(lgb.LightGBMError, match="nan_guard=raise"):
        lgb.train({**PARAMS, "nan_guard": "raise"},
                  lgb.Dataset(X, label=y, init_score=init), 2)
    bst = lt.Booster(params, lt.Dataset(X, label=y, params=CPU))
    fobj = _nan_fobj(2)
    assert bst.update(fobj=fobj) is False
    with pytest.raises(lt.LightGBMError, match="nan_guard=raise"):
        bst.update(fobj=fobj)


def test_invalid_mode_is_a_value_error():
    with pytest.raises(ValueError, match="nan_guard='sometimes'"):
        TConfig.from_params({"nan_guard": "sometimes"})
    X, y = _data(200)
    with pytest.raises(ValueError, match="nan_guard"):
        lt.train({**PARAMS, "nan_policy": "loud", **CPU},
                 lt.Dataset(X, label=y, params=CPU), 1)
    assert TConfig.from_params({"nan_policy": "RAISE"}).nan_guard == "RAISE"
    assert resolve_mode("RAISE") == "raise"
    with pytest.raises(lt.LightGBMError, match="not one of"):
        NanGuard("loud")


def test_non_finite_init_model_is_refused():
    """A model with a NaN leaf value does not seed continued training.
    Guard off, it does: the NaN reaches the score and the next gradients,
    whose iteration then ends training without a tree."""
    X, y = _data(500)
    src = lt.train({**PARAMS, **CPU}, lt.Dataset(X, label=y, params=CPU), 2)
    text = src.model_to_string()
    tree = src.engine.models[1]
    bad = text.replace("leaf_value=" + " ".join(
        repr(float(v)) for v in tree.leaf_value), "leaf_value=nan " + " ".join(
        repr(float(v)) for v in tree.leaf_value[1:]), 1)
    poisoned = lt.Booster(model_str=bad)
    assert not np.isfinite(poisoned._loaded_trees.trees[1].leaf_value).all()
    with pytest.raises(lt.LightGBMError, match="non-finite leaf values"):
        lt.train({**PARAMS, **CPU}, lt.Dataset(X, label=y, params=CPU), 1,
                 init_model=poisoned)
    bst = lt.train({**PARAMS, "nan_guard": "none", **CPU},
                   lt.Dataset(X, label=y, params=CPU), 1, init_model=poisoned)
    assert bst.num_trees() == 2


def test_check_finite_init_modes():
    a = np.array([0.5, np.nan, np.inf, -1.0])
    np.testing.assert_array_equal(check_finite_init(a, "x", "skip"),
                                  [0.5, 0.0, 0.0, -1.0])
    assert check_finite_init(a, "x", "none") is a
    clean = np.array([1.0, 2.0])
    assert check_finite_init(clean, "x", "warn") is clean
    with pytest.raises(lt.LightGBMError, match="2 non-finite"):
        check_finite_init(a, "x", "raise")
