"""Evaluation of the port against the JAX package, on the CPU: metrics,
validation sets, callbacks and early stopping.

Tolerances and why:

- Metrics are the same float64 numpy arithmetic in both packages: on the
  same scores and the same converted predictions they agree to rtol 1e-12
  (exactly, in practice).
- Validation scores of a run on dyadic custom gradients: the trees are
  byte-identical (tests/test_torch_sample.py) and the walk adds the same
  float32 leaf values in the same order, so the recorded metric values,
  the best iteration and the saved model are identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu import metrics as jm
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import metrics as tm
from lightgbm_torch.config import Config as TConfig

from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", ["l1", "l2", "rmse", "binary_logloss",
                                    "binary_error", "auc"])
def test_metric_values_match_jax(metric, weighted):
    rs = np.random.RandomState(3)
    n = 5000
    y = (rs.rand(n) < 0.4).astype(np.float64)
    w = rs.rand(n) + 0.5 if weighted else None
    # scores on a coarse grid, so AUC meets tied groups
    score = (np.round(rs.randn(n) * 8) / 8).astype(np.float32)
    conv = _sigmoid if metric.startswith("binary") else (lambda s: s)
    params = {"metric": metric}
    (j,) = jm.create_metrics(JConfig.from_params(params), "binary")
    (t,) = tm.create_metrics(TConfig.from_params(params), "binary")
    j.init(y, w, None)
    t.init(y, w)
    (jn, jv, jh), = j.evaluate(score, conv)
    (tn, tv, th), = t.evaluate(score, conv)
    assert (tn, th) == (jn, jh)
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)


@pytest.mark.parametrize("objective,metric,want", [
    ("binary", "", ["binary_logloss"]),
    ("regression", "", ["l2"]),
    ("none", "", ["l2"]),
    ("binary", "auc,binary_error", ["auc", "binary_error"]),
    ("regression", ["mae", "root_mean_squared_error"], ["l1", "rmse"]),
    ("binary", "None", []),
])
def test_create_metrics_names(objective, metric, want):
    cfg = TConfig.from_params({"metric": metric})
    got = [m.name for m in tm.create_metrics(cfg, objective)]
    ref = [m.name for m in jm.create_metrics(
        JConfig.from_params({"metric": metric}), objective)]
    assert got == ref == want


def test_unported_metric_raises():
    """quantile, which once raised "not yet ported" here, evaluates as the
    JAX package's; an unknown name raises as there."""
    rs = np.random.RandomState(5)
    y, score = rs.randn(300), rs.randn(300).astype(np.float32)
    params = {"metric": "quantile", "alpha": 0.3}
    (t,) = tm.create_metrics(TConfig.from_params(params), "binary")
    (j,) = jm.create_metrics(JConfig.from_params(params), "binary")
    t.init(y, None)
    j.init(y, None)
    assert t.evaluate(score, lambda s: s) == j.evaluate(score, lambda s: s)
    with pytest.raises(ValueError, match="Unknown metric"):
        tm.create_metrics(TConfig.from_params({"metric": "bogus"}),
                          "binary")


def _data(n=2400, seed=12):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 0.8 * rs.randn(n)
         > 0).astype(float)
    return X, y


def _dyadic_updates(monkeypatch):
    """Both packages' ``train`` loops call ``Booster.update()``; drive them
    with dyadic custom gradients so that the two packages' trees are exact
    and identical."""
    for mod in (lgb, lt):
        orig = mod.Booster.update
        monkeypatch.setattr(
            mod.Booster, "update",
            lambda self, train_set=None, fobj=None, _o=orig:
            _o(self, fobj=_dyadic_fobj))


_ES = {"objective": "none", "num_leaves": 63, "max_splits_per_round": 64,
       "hist_precision": "single", "min_data_in_leaf": 3,
       "learning_rate": 0.5, "verbosity": -1}


@pytest.mark.parametrize("extra", [
    {}, {"data_sample_strategy": "goss", "top_rate": 0.5,
         "other_rate": 0.25}], ids=["plain", "goss"])
def test_early_stopping_matches_jax(extra, monkeypatch, tmp_path):
    """Early stopping on a held-out set: best_iteration, best_score and the
    record_evaluation history equal the JAX package's, training stops at
    the same iteration, and save_model writes the best iteration's trees,
    byte for byte the JAX package's."""
    _dyadic_updates(monkeypatch)
    X, y = _data()
    Xt, yt, Xv, yv = X[:1600], y[:1600], X[1600:], y[1600:]
    params = {**_ES, **extra, "early_stopping_round": 3}
    out = {}
    for name, mod, p in (("jax", lgb, {**params, "hist_backend": "stream"}),
                         ("port", lt, {**params, **CPU})):
        kw = {"params": CPU} if mod is lt else {}
        train = mod.Dataset(Xt, label=yt, **kw)
        valid = mod.Dataset(Xv, label=yv, reference=train)
        rec = {}
        bst = mod.train(p, train, 40, valid_sets=[valid, train],
                        callbacks=[mod.record_evaluation(rec)])
        path = tmp_path / f"{name}.txt"
        bst.save_model(str(path))
        out[name] = (bst, rec, path.read_text())
    (jb, jrec, jtext), (tb, trec, ttext) = out["jax"], out["port"]
    assert 1 < tb.best_iteration == jb.best_iteration < 40
    assert tb.current_iteration() == jb.current_iteration() \
        == tb.best_iteration + 3
    assert trec == jrec and set(trec) == {"valid_0", "training"}
    assert len(trec["valid_0"]["l2"]) == tb.current_iteration()
    assert tb.best_score == jb.best_score
    assert _trees_text(ttext) == _trees_text(jtext)
    assert ttext.count("Tree=") == tb.best_iteration
    np.testing.assert_array_equal(tb.predict(Xv, raw_score=True),
                                  lt.Booster(model_file=str(
                                      tmp_path / "port.txt")).predict(
                                      Xv, raw_score=True))


def test_callbacks_feval_and_eval_lists(monkeypatch):
    """log_evaluation, record_evaluation and feval through train, the
    callback early_stopping, and Booster.eval_train / eval_valid on the
    same dyadic run as the JAX package."""
    _dyadic_updates(monkeypatch)
    X, y = _data(1800, 4)

    def feval(score, ds):
        return ("max_abs", float(np.abs(score).max()), False)

    res = {}
    for name, mod, p in (("jax", lgb, {**_ES, "hist_backend": "stream",
                                       "metric": "l2,l1"}),
                         ("port", lt, {**_ES, **CPU, "metric": "l2,l1"})):
        kw = {"params": CPU} if mod is lt else {}
        train = mod.Dataset(X[:1200], label=y[:1200], **kw)
        valid = mod.Dataset(X[1200:], label=y[1200:], reference=train)
        rec = {}
        bst = mod.train(p, train, 6, valid_sets=[valid],
                        valid_names=["hold"], feval=feval,
                        callbacks=[mod.log_evaluation(2),
                                   mod.record_evaluation(rec),
                                   mod.early_stopping(10, verbose=False)])
        res[name] = (rec, bst.eval_valid(feval), bst.eval_train(),
                     bst.best_iteration, bst.best_score)
    assert res["port"] == res["jax"]
    rec = res["port"][0]
    assert list(rec["hold"]) == ["l2", "l1", "max_abs"]
    assert len(rec["hold"]["l2"]) == 6


def test_valid_set_added_after_training_catches_up():
    """A validation set added to a trained Booster starts from the trees
    grown so far: its score equals predict's raw score on the same rows."""
    X, y = _data(1500, 7)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1, **CPU,
         "metric": "auc"}
    train = lt.Dataset(X[:1000], label=y[:1000], params=CPU)
    bst = lt.train(p, train, 4)
    bst.add_valid(lt.Dataset(X[1000:], label=y[1000:]), "late")
    eng = bst.engine
    score = eng.score_to_host(eng.valid_scores[0], 500)
    np.testing.assert_allclose(score, bst.predict(X[1000:], raw_score=True),
                               rtol=0, atol=2e-6)
    bst.update()
    (name, metric, value, hb), = bst.eval_valid()
    assert (name, metric, hb) == ("late", "auc", True) and value > 0.7


def test_valid_set_binned_with_training_mappers():
    X, y = _data(1200, 8)
    train = lt.Dataset(X[:800], label=y[:800], params=CPU).construct()
    valid = lt.Dataset(X[800:] * 3.0, label=y[800:], reference=train)
    valid.construct()
    assert valid.binned.bin_mappers is train.binned.bin_mappers
    assert valid.device == train.device
    bst = lt.Booster({"objective": "binary", "verbosity": -1, **CPU}, train)
    other = lt.Dataset(X[800:], label=y[800:], params=CPU).construct()
    with pytest.raises(lt.LightGBMError, match="different bin mappers"):
        bst.add_valid(other, "other")
    with pytest.raises(lt.LightGBMError, match="number of features"):
        lt.Dataset(X[800:, :3], label=y[800:], reference=train).construct()


def test_unported_callbacks_raise():
    """log_telemetry is not ported and raises; reset_parameter is ported
    (tests/test_torch_cv.py): a callback that runs before each iteration,
    order 10, as the JAX package's."""
    with pytest.raises(lt.LightGBMError, match="not yet ported"):
        lt.callback.log_telemetry(5)
    cb = lt.callback.reset_parameter(learning_rate=[0.1])
    want = lgb.callback.reset_parameter(learning_rate=[0.1])
    assert (cb.before_iteration, cb.order) == (want.before_iteration,
                                               want.order) == (True, 10)
