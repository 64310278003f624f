"""The port's scikit-learn estimators, on the CPU.

- Each estimator trains the model ``lightgbm_torch.train`` trains on the
  same parameters: the model text up to its parameter block byte-identical.
- Against the JAX package's estimators on the same inputs, both growing
  leaf-wise (``max_splits_per_round=1``) and the JAX package on ``segsum``
  histograms in single precision, as tests/test_torch_train.py's golden
  comparison runs them: every tree identical in structure and raw
  predictions within atol 2e-4, the binary slice's bound (measured: at
  most 7.3e-7, lambdarank's real lambdas included).
- Class weights, label encoding and the parameter plumbing are host numpy
  and Python: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb

import lightgbm_torch as lt

from test_torch_ranking import _ragged
from test_torch_train import _structure

CPU = {"device_type": "cpu"}
JAX = {"hist_backend": "segsum", "hist_precision": "single",
       "max_splits_per_round": 1}
SMALL = dict(n_estimators=4, num_leaves=7, min_child_samples=5,
             verbosity=-1)


def _trees(text):
    return text.split("\nparameters:")[0]


def _data(n=600, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.2 * rs.randn(n)
    return X, y


@pytest.mark.parametrize("kind", ["regressor", "classifier",
                                  "multiclass_strings", "ranker"])
def test_estimator_text_equals_train(kind):
    X, y = _data()
    group = None
    params = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1,
              **CPU}
    if kind == "regressor":
        est, label = lt.LGBMRegressor(**SMALL, **CPU), y
        params["objective"] = "regression"
        fit_label = y
    elif kind == "classifier":
        est, label = lt.LGBMClassifier(**SMALL, **CPU), (y > 0.3) * 1.0
        params["objective"] = "binary"
        fit_label = label
    elif kind == "multiclass_strings":
        fit_label = np.array(["lo", "mid", "hi"])[np.digitize(y, [0, 1])]
        est = lt.LGBMClassifier(**SMALL, **CPU)
        # classes sort as strings: "hi" < "lo" < "mid"
        label = np.unique(fit_label, return_inverse=True)[1] * 1.0
        params.update(objective="multiclass", num_class=3)
    else:
        X, label, group = _ragged(seed=2, nq=30)
        fit_label = label
        est = lt.LGBMRanker(**SMALL, **CPU)
        params.update(objective="lambdarank", eval_at=[1, 2, 3, 4, 5])
    est.fit(X, fit_label, group=group) if group is not None \
        else est.fit(X, fit_label)
    bst = lt.train(params, lt.Dataset(X, label=label, group=group,
                                      params=params), 4)
    assert _trees(est.booster_.model_to_string()) == \
        _trees(bst.model_to_string())
    raw = est.predict(X, raw_score=True)
    np.testing.assert_array_equal(raw, bst.predict(X, raw_score=True))
    if kind == "multiclass_strings":
        assert list(est.classes_) == ["hi", "lo", "mid"]
        assert set(est.predict(X)) <= set(est.classes_)
        np.testing.assert_array_equal(
            est.predict(X), est.classes_[np.argmax(bst.predict(X), axis=1)])
        assert est.score(X, fit_label) > 0.6
    assert est.n_features_in_ == X.shape[1]
    assert est.n_estimators_ == 4


@pytest.mark.parametrize("kind", ["regressor", "classifier", "ranker"])
def test_predictions_match_jax_estimators(kind):
    X, y = _data()
    fit = {}
    if kind == "regressor":
        cls_t, cls_j, label = lt.LGBMRegressor, lgb.LGBMRegressor, y
    elif kind == "classifier":
        cls_t, cls_j = lt.LGBMClassifier, lgb.LGBMClassifier
        label = np.where(y > 0.3, "yes", "no")
    else:
        cls_t, cls_j = lt.LGBMRanker, lgb.LGBMRanker
        X, label, group = _ragged(seed=2, nq=30)
        fit = {"group": group}
    t = cls_t(**SMALL, **CPU, max_splits_per_round=1).fit(X, label, **fit)
    j = cls_j(**SMALL, **JAX).fit(X, label, **fit)
    assert [_structure(a) for a in t.booster_.engine.models] == \
        [_structure(b) for b in j.booster_.engine.models]
    np.testing.assert_allclose(t.predict(X, raw_score=True),
                               j.predict(X, raw_score=True), rtol=0,
                               atol=2e-4)
    if kind == "classifier":
        np.testing.assert_array_equal(t.predict(X), j.predict(X))
        np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                                   rtol=0, atol=1e-4)
        assert list(t.classes_) == list(j.classes_) == ["no", "yes"]


def test_class_weight_balanced_matches_jax():
    X, y = _data()
    label = np.array(["a", "b", "c"])[np.digitize(y, [0.0, 1.5])]
    sw = np.random.RandomState(1).rand(len(y)) + 0.5
    for weight in (None, sw):
        want = lgb.LGBMClassifier(class_weight="balanced") \
            ._sample_weight_from_class_weight(label, weight)
        got = lt.LGBMClassifier(class_weight="balanced") \
            ._sample_weight_from_class_weight(label, weight)
        np.testing.assert_array_equal(got, want)
    est = lt.LGBMClassifier(class_weight="balanced", **SMALL, **CPU)
    est.fit(X, label, sample_weight=sw)
    np.testing.assert_array_equal(
        est.booster_.train_set.get_weight(),
        lt.LGBMClassifier(class_weight="balanced")
        ._sample_weight_from_class_weight(label, sw))
    d = {"a": 2.0, "c": 0.5}
    got = lt.LGBMClassifier(class_weight=d)._sample_weight_from_class_weight(
        label, None)
    np.testing.assert_array_equal(got, [d.get(v, 1.0) for v in label])


def test_ranker_eval_set_and_early_stopping():
    X, y, group = _ragged(seed=2, nq=60)
    Xv, yv, gv = _ragged(seed=5, nq=30)
    est = lt.LGBMRanker(n_estimators=40, num_leaves=31, min_child_samples=2,
                        learning_rate=0.5, verbosity=-1, **CPU)
    est.fit(X, y, group=group, eval_set=[(Xv, yv), (X, y)],
            eval_group=[gv, group], eval_names=["valid", "train"],
            eval_at=[3], callbacks=[lt.early_stopping(3, verbose=False)])
    res = est.evals_result_
    # the training data as an evaluation set takes the name "training"
    assert set(res) == {"valid", "training"}
    assert list(res["valid"]) == ["ndcg@3"]
    curve = res["valid"]["ndcg@3"]
    assert len(curve) < 40   # stopped early
    assert est.best_iteration_ == int(np.argmax(curve)) + 1
    assert len(curve) == est.best_iteration_ + 3
    assert est.best_score_["valid"]["ndcg@3"] == max(curve)
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(**CPU).fit(X, y)
    with pytest.raises(ValueError, match="Eval_group"):
        lt.LGBMRanker(**CPU).fit(X, y, group=group, eval_set=[(Xv, yv)])


def test_params_and_clone():
    from sklearn.base import clone

    est = lt.LGBMRanker(num_leaves=9, learning_rate=0.05, **CPU,
                        lambdarank_truncation_level=10)
    p = est.get_params()
    assert p["num_leaves"] == 9 and p["device_type"] == "cpu"
    assert p["lambdarank_truncation_level"] == 10
    assert est.set_params(num_leaves=5, max_bin=31) is est
    assert est.num_leaves == 5 and est.get_params()["max_bin"] == 31
    c = clone(est)
    assert c is not est and c.get_params() == est.get_params()
    X, y, group = _ragged(seed=2, nq=20)
    c.set_params(n_estimators=2).fit(X, y, group=group)
    assert c.booster_.num_trees() == 2
    with pytest.raises(lt.LightGBMError, match="No booster"):
        est.booster_
    assert clone(c).get_params() == c.get_params()


def test_unported_objective_raises():
    """huber, which once raised "not yet ported" here, fits through
    ``LGBMRegressor(objective=...)`` and writes the JAX package's model
    header; an unknown objective raises as there."""
    X, y = _data(200)
    est = lt.LGBMRegressor(objective="huber", alpha=0.5, n_estimators=3,
                           **CPU).fit(X, y)
    assert est.booster_.num_trees() == 3
    assert "objective=huber alpha:0.5\n" in est.booster_.model_to_string()
    assert np.isfinite(est.predict(X)).all()
    with pytest.raises(ValueError, match="Unknown objective"):
        lt.LGBMRegressor(objective="bogus", **CPU).fit(X, y)


def test_custom_objective_trains_through_update():
    X, y = _data()

    def l2(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_true)

    est = lt.LGBMRegressor(objective=l2, **SMALL, **CPU).fit(X, y)
    ref = lt.LGBMRegressor(objective="regression", **SMALL, **CPU,
                           boost_from_average=False).fit(X, y)
    np.testing.assert_allclose(est.predict(X), ref.predict(X), rtol=0,
                               atol=1e-6)
