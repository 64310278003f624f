"""DART and RF boosting (models/gbdt.py ``DART``, ``RF``) of the port
against the JAX package, on the CPU.

The same numpy inputs go through the JAX package (its stream and pallas
kernels in Pallas interpret mode) and through the port with
``device_type="cpu"``.

Tolerances and why:

- Training: both ``train`` loops run on dyadic gradients, either custom
  (``Booster.update`` patched) or the objective's own patched onto the
  dyadic grid (so that RF takes them at its constant init score, and DART
  may fuse).  Every histogram sum is then exact; DART's drops, rescales
  and walks and RF's averaging are the same float32 (score) and float64
  (host tree) operations in the same order, so the model text before the
  parameter block is byte-identical under ``stream``, ``scatter`` and
  ``pallas``.
- ``eval_valid`` / ``eval_train``: the validation scores are the same
  float32 values bit for bit, and AUC (a rank statistic of them) is equal;
  ``binary_logloss`` reads the objective's sigmoid, torch's against XLA's
  float32, so it is held to rtol 1e-6 (measured 5e-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.models.gbdt import DART, RF
from lightgbm_torch.utils.log import LightGBMError

from test_torch_checkpoint import _dyadic_l2_objective, _dyadic_updates
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
_BASE = {"num_leaves": 15, "max_splits_per_round": 4,
         "hist_precision": "single", "min_data_in_leaf": 5,
         "learning_rate": 0.5, "verbosity": -1}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _drive(monkeypatch, fobj):
    """Dyadic gradients in both packages: custom ones through
    ``Booster.update``, or (``fobj`` None) regression's own, patched onto
    the 1/64 grid, so that the objective runs where the engine calls it."""
    if fobj is None:
        _dyadic_l2_objective(monkeypatch)
    else:
        _dyadic_updates(monkeypatch, fobj)


def _pair(params, backend, data, iters, valid=None):
    """The JAX package's and the port's ``train`` on the same rows, with
    a recorded validation set when ``valid`` rows are given: ((JAX booster,
    record), (port booster, record))."""
    X, y = data
    out = []
    for mod, kw in ((lgb, {}), (lt, CPU)):
        p = {**params, "hist_backend": backend, **kw}
        if mod is lgb:
            p.pop("fused_iter", None)
        ds = mod.Dataset(X, label=y, params=kw)
        rec, vs = {}, None
        if valid is not None:
            vs = [mod.Dataset(valid[0], label=valid[1], reference=ds)]
        bst = mod.train(p, ds, iters, valid_sets=vs,
                        callbacks=[mod.record_evaluation(rec)])
        out.append((bst, rec))
    return out


_DART = {"boosting": "dart", "drop_rate": 0.4, "skip_drop": 0.2}
_CASES = {
    "dart_stream": (_DART, "stream", _dyadic_fobj, 1),
    "dart_uniform_scatter": ({**_DART, "uniform_drop": True}, "scatter",
                             _dyadic_fobj, 1),
    "dart_xgboost_max_drop_pallas": ({**_DART, "xgboost_dart_mode": True,
                                      "max_drop": 1}, "pallas",
                                     _dyadic_fobj, 1),
    "dart_no_skip_k3_stream": ({**_DART, "skip_drop": 0.0,
                                "drop_rate": 0.6}, "stream",
                               _dyadic_mc_fobj, 3),
    "dart_fused_objective": ({**_DART, "objective": "regression",
                              "fused_iter": "on"}, "stream", None, 1),
    "rf_objective_stream": ({"boosting": "rf", "objective": "regression",
                             "bagging_fraction": 0.6, "bagging_freq": 1},
                            "stream", None, 1),
    "rf_objective_scatter": ({"boosting": "rf", "objective": "regression",
                              "bagging_fraction": 0.6, "bagging_freq": 1},
                             "scatter", None, 1),
    "rf_pallas": ({"boosting": "random_forest", "feature_fraction": 0.7},
                  "pallas", _dyadic_fobj, 1),
    "rf_k3_stream": ({"boosting": "rf", "bagging_fraction": 0.7,
                      "bagging_freq": 1}, "stream", _dyadic_mc_fobj, 3),
    "rf_k3_scatter": ({"boosting": "rf", "bagging_fraction": 0.7,
                       "bagging_freq": 1}, "scatter", _dyadic_mc_fobj, 3),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_training_byte_identical_to_jax(case, monkeypatch):
    """Six iterations (five of K = 3 DART on 600 rows: the JAX package
    walks each dropped tree in a program of its own): model text
    byte-identical to the JAX package's same backend, the engine the class
    asked for, DART's drops seen and its new trees rescaled, RF's trees
    unshrunk with the init bias in every tree and ``average_output`` in
    the text."""
    extra, backend, fobj, k = _CASES[case]
    _drive(monkeypatch, fobj)
    params = {**_BASE, "objective": "binary", **extra}
    iters = 6
    if k > 1:
        params.update(objective="multiclass", num_class=k)
        iters = 5 if case.startswith("dart") else 6
    data = (_mc_data(600 if case.startswith("dart") else 1200, 3, k=k)
            if k > 1 else _sampled_data(1200, 5))
    (jb, _), (tb, _) = _pair(params, backend, data, iters)
    text = tb.model_to_string()
    assert _trees_text(text) == _trees_text(jb.model_to_string())
    eng = tb.engine
    assert eng.grow_params.hist_backend == backend
    assert tb.num_trees() == iters * k
    if case.startswith("dart"):
        assert isinstance(eng, DART)
        assert eng._fused is (extra.get("fused_iter") == "on")
        assert any(t.shrinkage not in (0.5, 1.0) for t in eng.models)
    else:
        assert isinstance(eng, RF) and not eng._fused
        assert "average_output" in text
        assert all(t.shrinkage == 1.0 for t in eng.models)
        np.testing.assert_array_equal(
            tb.predict(data[0], raw_score=True),
            jb.predict(data[0], raw_score=True))


@pytest.mark.parametrize("boosting", ["dart", "rf"])
def test_eval_valid_and_train_equal_jax(boosting, monkeypatch):
    """The recorded validation metric, and ``eval_train``, equal the JAX
    package's: under DART the validation score keeps each new tree at the
    learning rate and the dropped trees unscaled (the JAX package's
    behaviour; stock dart.hpp rescales them, ROADMAP §3); under RF both
    scores are averaged."""
    _drive(monkeypatch, _dyadic_fobj)
    extra = (_DART if boosting == "dart"
             else {"boosting": "rf", "bagging_fraction": 0.6,
                   "bagging_freq": 1})
    # no init score: on these rows the port's label mean rounds one ulp
    # from the JAX package's ``jnp.mean`` (ROADMAP §3), which every leaf
    # value carries in the first tree; the averaging and the validation
    # walks are what this holds
    params = {**_BASE, "objective": "binary", "boost_from_average": False,
              "metric": ["binary_logloss", "auc"], **extra}
    X, y = _sampled_data(1600, 5)
    (jb, jrec), (tb, trec) = _pair(params, "stream", (X[:1200], y[:1200]), 5,
                                   valid=(X[1200:], y[1200:]))
    assert _trees_text(tb.model_to_string()) == _trees_text(
        jb.model_to_string())
    np.testing.assert_array_equal(tb.engine.valid_scores[0].numpy(),
                                  np.asarray(jb.engine._valid_scores[0]))
    assert trec["valid_0"]["auc"] == jrec["valid_0"]["auc"]
    assert len(trec["valid_0"]["auc"]) == 5
    np.testing.assert_allclose(trec["valid_0"]["binary_logloss"],
                               jrec["valid_0"]["binary_logloss"], rtol=1e-6)
    for (tn, tm, tv, th), (jn, jm, jv, jh) in zip(tb.eval_train(),
                                                  jb.eval_train()):
        assert (tn, tm, th) == (jn, jm, jh)
        np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_rf_refuses_init_model_and_resume(tmp_path):
    """RF's averaged bookkeeping cannot be rebuilt from a saved model:
    ``init_model`` and ``resume_from`` raise the JAX package's message."""
    X, y = _sampled_data(600, 5)
    p = {**_BASE, "objective": "binary", "boosting": "rf", **CPU,
         "snapshot_freq": 2, "output_model": str(tmp_path / "m.txt")}
    bst = lt.train(p, lt.Dataset(X, label=y, params=CPU), 2)
    msg = "continued training \\(init_model\\) is not supported with " \
          "boosting=rf"
    with pytest.raises(LightGBMError, match=msg):
        lt.train(p, lt.Dataset(X, label=y, params=CPU), 4, init_model=bst)
    with pytest.raises(LightGBMError, match=msg):
        lt.train(p, lt.Dataset(X, label=y, params=CPU), 4,
                 resume_from=str(tmp_path / "m.txt.snapshot_iter_2"))


@pytest.mark.parametrize("params", [
    {"boosting": "rf"},
    {"boosting": "rf", "bagging_fraction": 0.5},
    {"boosting": "rf", "bagging_freq": 3},
    {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 2},
    {"boosting": "random_forest"},
])
def test_rf_bagging_fix_up_equals_jax(params):
    """RF needs bagging: the config turns it on as the JAX package's does
    (bagging_freq at least 1, bagging_fraction 0.9 unless in (0, 1))."""
    t, j = TConfig.from_params(params), JConfig.from_params(params)
    assert (t.bagging_freq, t.bagging_fraction) == (j.bagging_freq,
                                                    j.bagging_fraction)


def test_dart_and_rf_reject_linear_trees():
    X, y = _sampled_data(300, 5)
    for boosting in ("dart", "rf"):
        with pytest.raises(LightGBMError, match="linear_tree is not "
                                                f"supported with boosting="
                                                f"{boosting}"):
            lt.train({"objective": "binary", "boosting": boosting,
                      "linear_tree": True, "verbosity": -1, **CPU},
                     lt.Dataset(X, label=y, params={**CPU,
                                                    "linear_tree": True},
                                free_raw_data=False), 1)


def test_dart_drop_draws_follow_the_reference_order():
    """The drop choice is the reference's: one ``rand()`` an iteration,
    then ``rand(n)`` under uniform_drop or ``choice`` of round(rate * n),
    at most max_drop; recorded in ``last_drop``."""
    X, y = _sampled_data(600, 5)
    p = {**_BASE, "objective": "regression", **_DART, "drop_seed": 11,
         "max_drop": 2, **CPU}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=CPU))
    rs = np.random.RandomState(11)
    for it in range(8):
        bst.update()
        want = []
        if it > 0 and rs.rand() >= 0.2:
            want = list(rs.choice(it, size=min(max(1, int(round(0.4 * it))),
                                               it), replace=False))[:2]
        assert bst.engine.last_drop == want


@pytest.mark.parametrize("boosting_type", ["dart", "rf"])
def test_estimator_boosting_type_passes_through(boosting_type):
    """The estimators' ``boosting_type`` reaches the engine, whose trees
    equal ``train``'s on the same parameters."""
    X, y = _sampled_data(800, 5)
    extra = ({"subsample": 0.7, "subsample_freq": 1}
             if boosting_type == "rf" else {})
    clf = lt.LGBMClassifier(boosting_type=boosting_type, n_estimators=4,
                            num_leaves=7, device_type="cpu", verbose=-1,
                            **extra)
    clf.fit(X, y)
    eng = clf.booster_.engine
    assert isinstance(eng, DART if boosting_type == "dart" else RF)
    bst = lt.train(clf.booster_.params, lt.Dataset(X, label=y, params=CPU),
                   4)
    assert _trees_text(bst.model_to_string()) == _trees_text(
        clf.booster_.model_to_string())
