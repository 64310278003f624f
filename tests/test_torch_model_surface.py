"""The Booster's model methods of the port against the JAX package.

``dump_model``, ``trees_to_dataframe``, ``model_from_string``, get / set
leaf output, ``lower_bound`` / ``upper_bound``, ``shuffle_models``,
``eval``, ``set_train_data_name``, ``free_dataset`` and
``rollback_one_iter`` (eager and fused), each held against the JAX
package's on the same model text or the same training run.  Model edits
and dumps are exact; training after a rollback agrees with the JAX
package's within 2e-4, the binary slice's bound (float32 gradients summed in
other orders; tests/test_torch_fused.py's parameters, which grow the same
trees).
"""
import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.basic import Booster as TBooster

CPU = {"device_type": "cpu"}


def _data(rs, n, f=6):
    X = rs.randn(n, f)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[:, 4] = rs.randint(0, 5, n)
    return X


@pytest.fixture(scope="module")
def models():
    """name -> (the port's trained Booster, its model text, rows)."""
    out = {}
    rs = np.random.RandomState(70)
    for name, obj, ds_kw in (
            ("binary", {"objective": "binary"}, {}),
            ("multiclass", {"objective": "multiclass", "num_class": 3}, {}),
            ("categorical", {"objective": "binary", "max_cat_to_onehot": 1},
             {"categorical_feature": [4]})):
        X = _data(rs, 1500)
        s = X[:, 1] + np.nan_to_num(X[:, 0]) + np.isin(X[:, 4], [1, 3])
        y = (np.digitize(s, [0.3, 1.2]) if obj["objective"] == "multiclass"
             else (s > 0.7)).astype(float)
        params = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
                  **obj, **CPU}
        bst = lt.train(params, lt.Dataset(X, label=y, params=dict(params),
                                          **ds_kw), 6)
        out[name] = (bst, bst.model_to_string(), X[:300])
    return out


NAMES = ("binary", "multiclass", "categorical")


@pytest.mark.parametrize("name", NAMES)
def test_dump_model_equals_jax(models, name):
    """On the model text, loaded alone and served by an engine (whose
    objective string and feature names come from its config and Dataset)."""
    bst, text, _ = models[name]
    want = lgb.Booster(model_str=text).dump_model()
    loaded = lt.Booster(model_str=text, params=CPU)
    assert loaded.dump_model() == want
    served = lt.train({**bst.params, "num_iterations": 0},
                      bst.engine.train_data, 0, init_model=loaded)
    assert served._engine is not None
    assert served.dump_model() == want
    assert served.dump_model(num_iteration=2, start_iteration=1) == \
        lgb.Booster(model_str=text).dump_model(num_iteration=2,
                                               start_iteration=1)


@pytest.mark.parametrize("name", NAMES)
def test_trees_to_dataframe_equals_jax(models, name):
    bst, text, _ = models[name]
    want = lgb.Booster(model_str=text).trees_to_dataframe()
    pd.testing.assert_frame_equal(
        lt.Booster(model_str=text, params=CPU).trees_to_dataframe(), want,
        check_exact=True)
    # the trained Booster's unrounded values against the text's
    pd.testing.assert_frame_equal(bst.trees_to_dataframe(), want,
                                  rtol=1e-5)


def test_model_from_string_in_place(models):
    bst, _, X = models["binary"]
    _, other, _ = models["categorical"]
    b = lt.Booster(model_str=bst.model_to_string(), params=CPU)
    b.best_iteration = 3
    assert b.model_from_string(other) is b
    assert b.best_iteration == -1 and b._engine is None
    j = lgb.Booster(model_str=bst.model_to_string()).model_from_string(other)
    assert b.predict(X, raw_score=True).tobytes() == \
        j.predict(X, raw_score=True).tobytes()
    assert b.dump_model() == lt.Booster(model_str=other,
                                        params=CPU).dump_model()


@pytest.mark.parametrize("name", ("binary", "multiclass"))
def test_leaf_output_edit(models, monkeypatch, name):
    """get / set leaf output equal the JAX package's; after the edit the
    rows in that leaf move by the edit and no other row moves, on the host
    walk (byte-identical to the JAX package's) and on the K1 path, whose
    tables are built from the trees at every predict."""
    bst, text, X = models[name]
    bst = lt.train({"verbosity": -1, **CPU, **(
        {"objective": "multiclass", "num_class": 3} if name == "multiclass"
        else {"objective": "binary"}), "num_leaves": 15},
        bst.engine.train_data, 0, init_model=bst)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    loaded = lt.Booster(model_str=text, params=CPU)
    jb = lgb.Booster(model_str=text)
    tree, leaf = 4, 2
    assert bst.get_leaf_output(tree, leaf) == jb.get_leaf_output(tree, leaf)
    v = jb.get_leaf_output(tree, leaf) + 0.25
    k = bst.num_model_per_iteration()
    before = bst.predict(X, raw_score=True).reshape(len(X), k)
    for b in (bst, loaded, jb):
        assert b.set_leaf_output(tree, leaf, v) is b
    assert bst.get_leaf_output(tree, leaf) == v
    after = bst.predict(X, raw_score=True).reshape(len(X), k)
    hit = bst.predict(X, pred_leaf=True)[:, tree] == leaf
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.delete(after, tree % k, 1)[hit],
                                  np.delete(before, tree % k, 1)[hit])
    np.testing.assert_array_equal(after[~hit], before[~hit])
    np.testing.assert_allclose(after[hit, tree % k] - before[hit, tree % k],
                               0.25, rtol=0, atol=1e-5)
    assert loaded.predict(X, raw_score=True).tobytes() == \
        jb.predict(X, raw_score=True).tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_bounds_equal_jax(models, name):
    bst, text, _ = models[name]
    jb = lgb.Booster(model_str=text)
    assert bst.lower_bound() == jb.lower_bound()
    assert bst.upper_bound() == jb.upper_bound()
    assert bst.lower_bound() < bst.upper_bound()


@pytest.mark.parametrize("window", [(0, -1), (1, 5), (2, 6)])
@pytest.mark.parametrize("name", ("binary", "multiclass"))
def test_shuffle_models_order_equals_jax(models, name, window):
    bst, text, X = models[name]
    lb = lt.Booster(model_str=text, params=CPU).shuffle_models(*window)
    jb = lgb.Booster(model_str=text).shuffle_models(*window)
    got = [t.leaf_value.tobytes() for t in lb._all_trees()]
    assert got == [t.leaf_value.tobytes() for t in jb._all_trees()]
    if window == (0, -1):
        assert got != [t.leaf_value.tobytes()
                       for t in lt.Booster(model_str=text,
                                           params=CPU)._all_trees()]
    assert lb.predict(X, pred_leaf=True).tobytes() == \
        jb.predict(X, pred_leaf=True).tobytes()


@pytest.fixture(scope="module")
def evaluated(models, tmp_path_factory):
    """The binary model served by both packages with a validation set."""
    _, text, _ = models["binary"]
    path = tmp_path_factory.mktemp("eval") / "m.txt"
    path.write_text(text)
    rs = np.random.RandomState(71)
    X, Xv = _data(rs, 1500), _data(rs, 400)
    y, yv = ((X[:, 1] > 0).astype(float), (Xv[:, 1] > 0).astype(float))
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "metric": ["binary_logloss", "auc"]}
    out = []
    for pkg, kw in ((lt, CPU), (lgb, {})):
        ds = pkg.Dataset(X, label=y, params=dict(kw))
        dv = pkg.Dataset(Xv, label=yv, reference=ds)
        b = pkg.train({**params, **kw}, ds, 0, init_model=str(path),
                      valid_sets=[dv], valid_names=["v"])
        out.append((b, dv))
    return out


def test_eval_equals_jax(evaluated):
    (tb, tdv), (jb, jdv) = evaluated
    got, want = tb.eval(tdv, "held"), jb.eval(jdv, "held")
    assert [g[:2] + g[3:] for g in got] == [w[:2] + w[3:] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-6)
    assert [g[1:] for g in got] == [g[1:] for g in tb.eval_valid()]
    with pytest.raises(lt.LightGBMError, match="add_valid"):
        tb.eval(lt.Dataset(tdv.raw_data, params=CPU), "x")


def test_set_train_data_name(evaluated):
    (tb, _), (jb, _) = evaluated
    feval = [lambda s, d: ("mean_score", float(np.mean(s)), False)]
    want = jb.eval_train(feval)
    got = tb.eval_train(feval)
    assert [g[0] for g in got] == [w[0] for w in want] == \
        ["training"] * len(got)
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-6)
    assert tb.set_train_data_name("mine") is tb
    assert jb.set_train_data_name("mine") is jb
    assert [g[0] for g in tb.eval_train(feval)] == ["mine"] * len(got)
    assert [g[1:] for g in tb.eval_train(feval)] == [g[1:] for g in got]
    assert tb.free_dataset() is tb and jb.free_dataset() is jb


ROLLBACK = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
            "min_data_in_leaf": 5, "max_splits_per_round": 64}


@pytest.fixture(scope="module")
def rollback_data():
    rs = np.random.RandomState(11)
    X = rs.randn(2000, 8)
    y = (X[:, 0] - X[:, 1] + 0.3 * rs.randn(2000) > 0).astype(float)
    Xv = rs.randn(500, 8)
    yv = (Xv[:, 0] - Xv[:, 1] > 0).astype(float)
    return X, y, Xv, yv


def _rollback_run(pkg, params, data):
    """4 iterations, one rolled back, 3 more: the model's raw scores, the
    training score and the validation metrics; and the training score
    before the 4th iteration against after its rollback."""
    X, y, Xv, yv = data
    ds = pkg.Dataset(X, label=y, params=dict(params))
    bst = pkg.Booster({**params, "metric": "binary_logloss"}, ds)
    bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
    for _ in range(3):
        bst.update()
    eng = bst.engine
    score3 = np.asarray(eng.score[:len(X)]).copy() if pkg is lt else \
        np.asarray(eng._unpad_score()).copy()
    bst.update()
    assert bst.current_iteration() == 4
    assert bst.rollback_one_iter() is bst
    assert bst.current_iteration() == 3 and bst.num_trees() == 3
    rolled = np.asarray(eng.score[:len(X)]) if pkg is lt else \
        np.asarray(eng._unpad_score())
    np.testing.assert_allclose(rolled, score3, rtol=0, atol=1e-5)
    for _ in range(3):
        bst.update()
    score = np.asarray(eng.score[:len(X)]) if pkg is lt else \
        np.asarray(eng._unpad_score())
    return (bst, bst.predict(X, raw_score=True), score,
            [v for *_, v, _ in bst.eval_valid()])


@pytest.fixture(scope="module")
def jax_rollback(rollback_data):
    jsk._INTERPRET = True
    return _rollback_run(lgb, {**ROLLBACK, "hist_backend": "segsum",
                               "hist_precision": "single"}, rollback_data)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_rollback_then_train_equals_jax(rollback_data, jax_rollback, fused):
    """The port rolls back, eager and under the fused iteration (the next
    fused iteration reads the rolled-back score), and trains on as the JAX
    package does."""
    jb, jraw, jscore, jvalid = jax_rollback
    tb, traw, tscore, tvalid = _rollback_run(
        lt, {**ROLLBACK, **CPU, "fused_iter": fused}, rollback_data)
    assert tb.engine._fused == (fused == "on")
    assert tb.num_trees() == jb.num_trees() == 6
    for t, j in zip(tb.engine.models, jb.engine.models):
        assert (t.num_leaves, list(t.split_feature)) == \
            (j.num_leaves, list(j.split_feature))
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tscore, jscore, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tvalid, jvalid, rtol=0, atol=2e-4)


def test_rollback_fused_equals_eager(rollback_data):
    """Fused and eager give the same model text after a rollback."""
    texts = []
    for fused in ("off", "on"):
        bst = _rollback_run(lt, {**ROLLBACK, **CPU, "fused_iter": fused},
                            rollback_data)[0]
        texts.append("\n".join(ln for ln in bst.model_to_string()
                               .splitlines()
                               if not ln.startswith("[fused_iter:")))
    assert texts[0] == texts[1]
