"""The regression family, cross-entropy and their metrics in the port
against the JAX package, on the CPU (the leaf renewal and the renewing
objectives' training: ``tests/test_torch_renew.py``).

The same numpy inputs go through ``lightgbm_tpu`` and ``lightgbm_torch``
(``device_type="cpu"``: the kernels' plain versions; the JAX stream and
pallas kernels in Pallas interpret mode).

Tolerances and why:

- Gradients and hessians of regression_l1, huber, quantile, mape (sign,
  clip, select) and fair (float32 divisions): bit-equal.  The others go
  through float32 ``exp``, ``sigmoid`` or ``log1p``, which torch and XLA
  may round apart: held to |a - b| <= 1e-6 * max(1, max |b|) (``_close``;
  measured at most 2.4e-7, cross_entropy_lambda's hessians).
- ``boost_from_score``: the percentile objectives run the same host numpy,
  so they are equal; the others take the label mean in float64 rounded to
  float32 where XLA sums in float32, and then a log or a logit: within
  1e-6 * max(1, |b|) (measured 2.4e-7, weighted cross_entropy's logit).
- ``convert_output``: float32 exp, sigmoid and log1p: within 4 ulp of the
  JAX package's (measured 3, log1p(exp)).
- The smooth objectives on real gradients, several splits a round,
  against the JAX package's segsum: every tree identical in structure,
  raw scores within atol 1e-4 (float32 exp against XLA's, leaf sums in
  another order; measured 5.2e-5, fair).
- The eight stock LightGBM fixtures: relative RMS < 0.01, as
  ``tests/test_golden.py::test_consistency_objectives`` asks of the JAX
  package; the same bound against the JAX package's CPU defaults, whose
  first tree the port's equals.
- Metrics: the same float64 numpy arithmetic, rtol 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import metrics as jm
from lightgbm_tpu import objectives as jo
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import metrics as tm
from lightgbm_torch import objectives as to
from lightgbm_torch.config import Config as TConfig

from test_golden import FIX, _COMMON, _load_X, _load_train
from test_torch_train import _structure, _trees_text

CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _close(got, want, rtol=1e-6):
    """Within ``rtol`` of the reference's scale (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"max abs difference {err} > {tol}"


def _labels(kind, rs, n):
    if kind == "real":
        return rs.randn(n) * 3
    if kind == "positive":
        return np.abs(rs.randn(n) * 3) + 0.05
    if kind == "count":
        return rs.poisson(2.0, n).astype(np.float64)
    return rs.rand(n)      # a probability


# objective: (label kind, parameters); the first five are bit-equal
_OBJECTIVES = {
    "regression_l1": ("real", {}),
    "huber": ("real", {"alpha": 1.3}),
    "quantile": ("real", {"alpha": 0.3}),
    "mape": ("real", {}),
    "fair": ("real", {"fair_c": 0.7}),
    "poisson": ("count", {"poisson_max_delta_step": 0.5}),
    "gamma": ("positive", {}),
    "tweedie": ("count", {"tweedie_variance_power": 1.3}),
    "cross_entropy": ("prob", {}),
    "cross_entropy_lambda": ("prob", {}),
}
_PERCENTILE = ("regression_l1", "quantile", "mape")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(_OBJECTIVES))
def test_gradients_boost_and_output_match_jax(name, weighted):
    kind, extra = _OBJECTIVES[name]
    rs = np.random.RandomState(len(name) + weighted)
    n = 3000
    y = _labels(kind, rs, n)
    w = rs.rand(n) + 0.5 if weighted else None
    params = {"objective": name, **extra}
    j = jo.create_objective(JConfig.from_params(params))
    t = to.create_objective(TConfig.from_params(params))
    j.init(y, w, n=n)
    t.init(y, w, n=n)
    assert t.need_renew_leaf == j.need_renew_leaf == (name in _PERCENTILE)
    score = (rs.randn(n) * (2.0 if kind == "real" else 0.7)).astype(
        np.float32)
    jg, jh = (np.asarray(a) for a in j.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in t.get_gradients(torch.as_tensor(score)))
    assert tg.dtype == th.dtype == np.float32
    if name in ("regression_l1", "huber", "quantile", "mape", "fair"):
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(th, jh)
    else:
        _close(tg, jg)
        _close(th, jh)
    jb, tb = j.boost_from_score(), t.boost_from_score()
    if name in _PERCENTILE:
        assert tb == jb
    else:
        _close(tb, jb)
    jc = np.asarray(j.convert_output(jnp.asarray(score)), np.float64)
    tc = np.asarray(t.convert_output(score), np.float64)
    ulp = np.spacing(np.abs(jc).astype(np.float32)).astype(np.float64)
    assert (np.abs(tc - jc) <= 4 * ulp).all()


@pytest.mark.parametrize("name,label,match", [
    ("poisson", [1.0, -1.0, 2.0], "non-negative"),
    ("cross_entropy", [0.5, 1.5, 0.0], r"\[0, 1\]")])
def test_label_checks_run_at_init(name, label, match):
    """The label checks run at ``init`` with the JAX package's messages,
    never inside a gradient call (which may run in a CUDA graph)."""
    y = np.asarray(label)
    for pkg, cfg in ((to, TConfig), (jo, JConfig)):
        obj = pkg.create_objective(cfg.from_params({"objective": name}))
        with pytest.raises(Exception, match=match) as err:
            obj.init(y, None, n=3)
        if pkg is to:
            port = str(err.value)
    assert port == str(err.value)


# ---------------------------------------------------------------- training

def _renew_data(n=1200, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 3] = 0.0
    y = np.nan_to_num(X[:, 0]) + 2 * X[:, 1] + 0.5 * rs.laplace(size=n)
    return X, y


@pytest.mark.parametrize("name", ["poisson", "tweedie",
                                  "cross_entropy_lambda"])
def test_fused_equals_eager(name):
    """A fused objective's text equals its eager text (the device-state
    grower without graphs on the CPU); a renewing objective stays eager
    under ``fused_iter=on``, as the reference's gate keeps it."""
    X, y = _renew_data(1500, 4)
    kind = _OBJECTIVES[name][0]
    y = (np.abs(np.round(y)) if kind == "count"
         else 1.0 / (1.0 + np.exp(-y)))
    params = {"objective": name, "num_leaves": 31, "verbosity": -1, **CPU}
    texts = []
    for fused in ("on", "off"):
        p = {**params, "fused_iter": fused}
        bst = lt.train(p, lt.Dataset(X, label=y, params=p), 4)
        assert bst.engine._fused == (fused == "on")
        texts.append(_trees_text(bst.model_to_string()))
    assert texts[0] == texts[1]
    p = {**params, "objective": "quantile", "fused_iter": "on"}
    bst = lt.train(p, lt.Dataset(X, label=y, params=p), 1)
    assert bst.engine._fused is False


_STOCK = {"huber": {}, "fair": {}, "regression_l1": {},
          "quantile": {"alpha": 0.7}, "poisson": {}, "gamma": {},
          "tweedie": {}, "mape": {}}


@pytest.mark.parametrize("name", list(_STOCK))
def test_stock_objective_oracles(name):
    """Stock LightGBM's fixtures through the port on the CPU: relative RMS
    < 0.01 (``test_consistency_objectives``'s bound for the JAX package).
    Against the JAX package on the same parameters (its CPU defaults:
    segsum, double histograms, one split a round): the first tree
    identical in structure, the raw scores within the same relative RMS,
    and the same ``objective=`` header line.  (The port scans float32
    prefix sums where the JAX package scans float64 ones; on fair's
    outliers, hessians near 0.014, a later near-tie can fall the other
    way.)"""
    data = "reg" if name in ("huber", "fair", "regression_l1",
                             "quantile") else "pos"
    X, y = _load_train(data)
    params = {**_COMMON, "objective": name, **_STOCK[name]}
    tb = lt.train({**params, **CPU}, lt.Dataset(X, label=y, params=CPU), 10)
    jb = lgb.train(params, lgb.Dataset(X, label=y), 10)
    Xg = _load_X()
    ours = tb.predict(Xg, raw_score=True)
    for want in (np.loadtxt(FIX / f"stock_pred_obj_{name}.txt"),
                 jb.predict(Xg, raw_score=True)):
        err = float(np.sqrt(np.mean((ours - want) ** 2))) / max(
            float(np.std(want)), 1e-6)
        assert err < 0.01, f"relative RMS diff {err:.4f}"
    assert _structure(tb.engine.models[0]) == \
        _structure(jb.engine.models[0])
    header = [ln for ln in tb.model_to_string().splitlines()
              if ln.startswith("objective=")]
    assert header == [ln for ln in jb.model_to_string().splitlines()
                      if ln.startswith("objective=")]


@pytest.mark.parametrize("name", ["huber", "fair", "poisson", "gamma",
                                  "tweedie"])
def test_smooth_objectives_close_to_jax(name):
    """Real gradients of the smooth regression objectives, several splits a
    round: every tree identical in structure to the JAX package's segsum
    (float32 sums), raw scores within atol 1e-4."""
    X, y = _renew_data(1000, 5)
    kind = _OBJECTIVES[name][0]
    if kind == "count":
        y = np.abs(np.round(y))
    elif kind == "positive":
        y = np.abs(y) + 0.1
    params = {"objective": name, "num_leaves": 15, "max_splits_per_round": 4,
              "hist_precision": "single", "min_data_in_leaf": 5,
              "verbosity": -1, **_OBJECTIVES[name][1]}
    jb = lgb.train({**params, "hist_backend": "segsum"},
                   lgb.Dataset(X, label=y), 3)
    tb = lt.train({**params, **CPU}, lt.Dataset(X, label=y, params=CPU), 3)
    assert [_structure(t) for t in tb.engine.models] == \
        [_structure(t) for t in jb.engine.models]
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["cross_entropy", "cross_entropy_lambda"])
def test_cross_entropy_close_to_jax(name):
    """Real cross-entropy gradients: the same trees as the JAX package's
    CPU defaults, raw scores within atol 1e-4, weighted too."""
    X, y = _load_train("binary")
    y = np.clip(0.2 + 0.6 * y + 0.1 * np.sin(X[:, 0]), 0.0, 1.0)
    w = np.loadtxt(FIX / "golden_weights.csv")
    params = {**_COMMON, "objective": name}
    for weight in (None, w):
        tb = lt.train({**params, **CPU},
                      lt.Dataset(X, label=y, weight=weight, params=CPU), 10)
        jb = lgb.train(params, lgb.Dataset(X, label=y, weight=weight), 10)
        assert [_structure(t) for t in tb.engine.models] == \
            [_structure(t) for t in jb.engine.models]
        Xg = _load_X()
        np.testing.assert_allclose(tb.predict(Xg, raw_score=True),
                                   jb.predict(Xg, raw_score=True),
                                   rtol=0, atol=1e-4)
        # the converted output: sigmoid, or log1p(exp)
        np.testing.assert_allclose(tb.predict(Xg), jb.predict(Xg),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(_STOCK))
def test_stock_models_load_and_predict(name):
    """Stock's ``stock_obj_*.model`` loads in the port and predicts as in
    the JAX package: raw scores and converted outputs (exp on the log-link
    objectives) within rtol 1e-4 / atol 1e-5 (float32 sums against the
    float64 host walk), and stock's own raw scores too."""
    path = str(FIX / f"stock_obj_{name}.model")
    Xg = _load_X()
    tb, jb = lt.Booster(model_file=path), lgb.Booster(model_file=path)
    raw = tb.predict(Xg, raw_score=True)
    np.testing.assert_allclose(raw, jb.predict(Xg, raw_score=True),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(raw, np.loadtxt(
        FIX / f"stock_pred_obj_{name}.txt"), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.predict(Xg), jb.predict(Xg), rtol=RTOL,
                               atol=ATOL)


def test_every_objective_fits_through_the_regressor():
    """``LGBMRegressor(objective=...)`` takes each new objective unchanged;
    its default metric is the JAX package's."""
    rs = np.random.RandomState(2)
    X = rs.randn(400, 4)
    for name, (kind, extra) in _OBJECTIVES.items():
        y = _labels(kind, rs, 400) + (X[:, 0] > 0) * (kind != "prob")
        est = lt.LGBMRegressor(objective=name, n_estimators=2, num_leaves=7,
                               **extra, **CPU).fit(X, y)
        assert est.booster_.num_trees() == 2
        pred = est.predict(X)
        assert pred.shape == (400,) and np.isfinite(pred).all()
        if kind in ("positive", "count"):
            assert (pred > 0).all()
        (m,) = tm.create_metrics(TConfig.from_params({}), name)
        assert m.name == jm.default_metric_for_objective(name) \
            == tm.default_metric_for_objective(name)


# ----------------------------------------------------------------- metrics

_METRICS = {
    "r2": ("real", {}), "quantile": ("real", {"alpha": 0.3}),
    "huber": ("real", {"alpha": 0.8}), "fair": ("real", {"fair_c": 0.6}),
    "poisson": ("count", {}), "mape": ("real", {}),
    "gamma": ("positive", {}), "gamma_deviance": ("positive", {}),
    "tweedie": ("count", {"tweedie_variance_power": 1.4}),
    "average_precision": ("binary", {}), "auc_mu": ("class", {}),
    "cross_entropy": ("prob", {}), "cross_entropy_lambda": ("prob", {}),
    "kldiv": ("prob", {}),
}


@pytest.mark.parametrize("name", list(_METRICS))
def test_metrics_match_jax(name):
    kind, extra = _METRICS[name]
    rs = np.random.RandomState(len(name))
    n = 500
    if kind == "binary":
        y = (rs.rand(n) < 0.3).astype(np.float64)
    elif kind == "class":
        y = rs.randint(0, 3, n).astype(np.float64)
    else:
        y = _labels(kind, rs, n)
    score = rs.randn(*((n, 3) if kind == "class" else (n,))).astype(
        np.float32)
    # ties, which the ranking metrics break by order
    score[: n // 5] = np.round(score[: n // 5])
    conv = {"count": np.exp, "positive": np.exp,
            "prob": lambda s: 1.0 / (1.0 + np.exp(-s))}.get(kind)
    if name == "cross_entropy_lambda":
        conv = lambda s: np.log1p(np.exp(s))    # noqa: E731
    conv = conv or (lambda s: s)
    params = {"metric": name, **extra}
    for w in (None, rs.rand(n) + 0.5):
        (t,) = tm.create_metrics(TConfig.from_params(params), "regression")
        (j,) = jm.create_metrics(JConfig.from_params(params), "regression")
        t.init(y, w)
        j.init(y, w)
        (tn, tv, th), = t.evaluate(score, conv)
        (jn, jv, jh), = j.evaluate(score, conv)
        assert (tn, th) == (jn, jh) == (name, j.higher_better)
        assert np.isfinite(tv)
        np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)


def test_early_stopping_on_r2_matches_jax():
    """Early stopping on ``r2`` (higher is better) with regression_l1,
    byte-identical training: the same best iteration, best score and
    history as the JAX package, and the saved model text."""
    X, y = _renew_data(900, 8)
    y = y + 2.0 * np.random.RandomState(0).randn(len(y))
    Xt, yt, Xv, yv = X[:600], y[:600], X[600:], y[600:]
    params = {"objective": "regression_l1", "metric": "r2",
              "num_leaves": 31, "learning_rate": 0.8,
              "max_splits_per_round": 8, "hist_precision": "single",
              "min_data_in_leaf": 3, "verbosity": -1,
              "early_stopping_round": 3}
    out = {}
    for mod, p in ((lgb, {**params, "hist_backend": "stream"}),
                   (lt, {**params, **CPU})):
        kw = {"params": CPU} if mod is lt else {}
        train = mod.Dataset(Xt, label=yt, **kw)
        valid = mod.Dataset(Xv, label=yv, reference=train)
        rec = {}
        bst = mod.train(p, train, 20, valid_sets=[valid],
                        callbacks=[mod.record_evaluation(rec)])
        out[mod] = (bst, rec)
    (jb, jrec), (tb, trec) = out[lgb], out[lt]
    assert 1 <= tb.best_iteration == jb.best_iteration < 17
    assert tb.current_iteration() == jb.current_iteration() \
        == tb.best_iteration + 3
    assert trec == jrec and list(trec["valid_0"]) == ["r2"]
    assert tb.best_score == jb.best_score
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
