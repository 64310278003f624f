"""cv and reset_parameter of the port against the JAX package, on the CPU.

Both packages' ``Booster.update`` are patched to take dyadic custom
gradients (as tests/test_torch_eval.py does), so the trees of either are
exact and the same: the folds, the per-iteration means and spreads (a
metric on probabilities within 1e-9: each package applies its own
sigmoid to the same float32 scores), the best iteration and the CVBooster
files are equal, and a parameter schedule (a list or a callable) grows the
same trees.  After a tree-shape reset the
fused iteration (``fused_iter="on"``: the device-state grower without
graphs on the CPU) grows the eager iteration's trees, byte for byte.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu import engine as jeng
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import engine as teng

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _dyadic_fobj(score, ds):
    g = np.clip(np.round(64 * (score - ds.get_label())) / 64, -127 / 64,
                127 / 64)
    return g.astype(np.float32), np.ones_like(g, dtype=np.float32)


def _dyadic_updates(monkeypatch):
    for mod in (lgb, lt):
        orig = mod.Booster.update
        monkeypatch.setattr(
            mod.Booster, "update",
            lambda self, train_set=None, fobj=None, _o=orig:
            _o(self, fobj=_dyadic_fobj))


def _data(n=900, seed=0, group=False):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.1, 0] = np.nan
    y = (X[:, 1] + 0.5 * np.nan_to_num(X[:, 0]) + 0.4 * rs.randn(n)
         > 0).astype(float)
    g = np.array([150] * (n // 150)) if group else None
    return X, y, g


def _pair(X, y, group=None):
    return (lgb.Dataset(X, label=y, group=group),
            lt.Dataset(X, label=y, group=group, params=CPU))


class _Splitter:
    def __init__(self, n):
        self.n = n

    def split(self, X=None, y=None, groups=None):
        idx = np.arange(self.n)
        for k in range(3):
            test = idx[k::3]
            yield np.setdiff1d(idx, test), test


@pytest.mark.parametrize("case", ["stratified", "shuffled", "in_order",
                                  "groups", "user_pairs", "user_split"])
def test_folds_equal_jax(case):
    X, y, g = _data(group=case == "groups")
    jd, td = _pair(X, y, g)
    kw = {"stratified": case == "stratified",
          "shuffle": case != "in_order"}
    folds = None
    if case == "user_pairs":
        folds = [(np.arange(300, 900), np.arange(300)),
                 (np.arange(600), np.arange(600, 900))]
    elif case == "user_split":
        folds = _Splitter(len(X))
    want = jeng._make_n_folds(jd, folds, 4, {}, 7, kw["stratified"],
                              kw["shuffle"])
    got = teng._make_n_folds(td, folds, 4, {}, 7, kw["stratified"],
                             kw["shuffle"])
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


_CV = {"objective": "binary", "num_leaves": 7, "max_splits_per_round": 4,
       "hist_precision": "single", "min_data_in_leaf": 5,
       "learning_rate": 0.5, "verbosity": -1}


def _cv_both(monkeypatch, X, y, g=None, **kw):
    _dyadic_updates(monkeypatch)
    params = dict(_CV, **kw.pop("params", {}))
    jd, td = _pair(X, y, g)
    want = lgb.cv({**params, "hist_backend": "stream"}, jd, **kw)
    got = lt.cv({**params, **CPU}, td, **kw)
    return got, want


@pytest.mark.parametrize("case", ["plain", "early_stopping", "train_metric",
                                  "groups"])
def test_cv_results_equal_jax(case, monkeypatch):
    X, y, g = _data(group=case == "groups")
    kw = {"num_boost_round": 4, "nfold": 3, "seed": 3}
    if case == "early_stopping":
        kw.update(num_boost_round=8, params={"early_stopping_round": 2,
                                             "metric": "auc"})
    elif case == "train_metric":
        kw.update(eval_train_metric=True)
    elif case == "groups":
        kw.update(params={"objective": "lambdarank", "metric": "ndcg",
                          "eval_at": [3]})
    got, want = _cv_both(monkeypatch, X, y, g, **kw)
    assert list(got) == list(want)
    for key in want:
        # the same trees and float32 validation scores; a metric on
        # probabilities goes through each package's own sigmoid of them,
        # which differ in the last bits of the float64 logloss (means and
        # spreads within 2e-10 here)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-9)
    if case == "early_stopping":
        assert len(got["valid auc-mean"]) < 8


def test_cvbooster_files_equal_jax(monkeypatch, tmp_path):
    """return_cvbooster and fpreproc: each fold's model text equals the JAX
    package's; CVBooster.save_model writes the JAX package's JSON, which
    either package loads and predicts the same from."""
    X, y, _ = _data()
    seen = []

    def fpreproc(tr, te, params):
        seen.append((tr.num_data(), te.num_data()))
        return tr, te, {**params, "lambda_l2": 1.0}

    got, want = _cv_both(monkeypatch, X, y, num_boost_round=3, nfold=3,
                         return_cvbooster=True, fpreproc=fpreproc)
    assert seen[:3] == seen[3:] and len(seen) == 6
    tb, jb = got.pop("cvbooster"), want.pop("cvbooster")
    for a, b in zip(tb.boosters, jb.boosters, strict=True):
        assert a.model_to_string().split("\nparameters:")[0] == \
            b.model_to_string().split("\nparameters:")[0]
    tb.save_model(str(tmp_path / "t.json"))
    jb.save_model(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text().replace("cpu", "") \
        .split("parameters:")[0] == (tmp_path / "j.json").read_text() \
        .split("parameters:")[0]
    for path in ("t.json", "j.json"):
        tl = teng.CVBooster(str(tmp_path / path))
        jl = jeng.CVBooster(str(tmp_path / path))
        assert tl.best_iteration == jl.best_iteration == -1
        for a, b in zip(tl.predict(X[:50], raw_score=True),
                        jl.predict(X[:50], raw_score=True)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert [b.num_trees() for b in tb.boosters] == tb.num_trees()


_RESET = {"objective": "binary", "num_leaves": 31, "max_splits_per_round": 8,
          "hist_precision": "single", "min_data_in_leaf": 5,
          "verbosity": -1}


@pytest.mark.parametrize("kind", ["list", "callable"])
def test_reset_parameter_equals_jax(kind, monkeypatch):
    _dyadic_updates(monkeypatch)
    X, y, _ = _data(1200)
    if kind == "list":
        sched = {"learning_rate": [0.5, 0.25, 0.5, 0.125],
                 "num_leaves": [7, 7, 15, 31]}
    else:
        sched = {"learning_rate": lambda i: 0.5 / (1 + i),
                 "lambda_l2": lambda i: float(i),
                 "min_data_in_leaf": lambda i: 5 + 20 * (i % 2)}
    texts = []
    for mod, extra in ((lgb, {"hist_backend": "stream"}), (lt, CPU)):
        ds = (lgb.Dataset(X, label=y) if mod is lgb
              else lt.Dataset(X, label=y, params=CPU))
        bst = mod.train({**_RESET, **extra}, ds, 4,
                        callbacks=[mod.callback.reset_parameter(**sched)])
        texts.append(bst.model_to_string().split("\nparameters:")[0])
    assert texts[0] == texts[1]
    with pytest.raises(ValueError, match="num_boost_round"):
        lt.train({**_RESET, **CPU}, lt.Dataset(X, label=y, params=CPU), 3,
                 callbacks=[lt.reset_parameter(learning_rate=[0.1])])


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_fused_equals_eager_after_a_reset(objective):
    """A schedule that changes the learning rate every iteration and the
    tree shape (num_leaves, lambda_l2, min_data_in_leaf, the split budget)
    at iteration 3: the fused iteration grows the eager one's trees; the
    rate alone keeps the engine's device-state growers, a shape change
    makes new ones."""
    X, y, _ = _data(1500, seed=2)
    sched = [lt.reset_parameter(
        learning_rate=[0.3, 0.2, 0.1, 0.3, 0.2, 0.1],
        num_leaves=lambda i: 7 if i < 3 else 31,
        lambda_l2=lambda i: 0.0 if i < 3 else 3.0,
        min_data_in_leaf=lambda i: 5 if i < 3 else 30,
        max_splits_per_round=lambda i: 4 if i < 3 else 16)]
    texts, growers = {}, {}
    for fused in ("on", "off"):
        seen = []

        def record(env):
            seen.append(tuple(id(g) for g in
                              env.model.engine._fused_growers.values()))

        bst = lt.train({**_RESET, "objective": objective, "fused_iter": fused,
                        **CPU}, lt.Dataset(X, label=y, params=CPU), 6,
                       callbacks=sched + [record])
        assert bst.engine._fused == (fused == "on")
        texts[fused] = bst.model_to_string().split("\nparameters:")[0]
        growers[fused] = seen
    assert texts["on"] == texts["off"]
    g = growers["on"]
    assert g[0] == g[1] == g[2] and g[3] == g[4] == g[5] and g[2] != g[3]
    assert [t.num_leaves for t in bst.engine.models][3:] != [7, 7, 7]


def test_reset_to_an_unported_parameter_raises():
    X, y, _ = _data(300)
    bst = lt.train({**_RESET, **CPU}, lt.Dataset(X, label=y, params=CPU), 1)
    with pytest.raises(lt.LightGBMError, match="not yet ported"):
        bst.reset_parameter({"tree_learner": "data"})
    with pytest.raises(lt.LightGBMError, match="not yet ported"):
        bst.reset_parameter({"hist_backend": "segsum"})
