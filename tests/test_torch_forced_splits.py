"""Forced splits (``forcedsplits_filename``) of the port against the JAX
package, on the CPU: the JSON parse into static levels, the forced rounds
before the gain-driven ones, and the fused iteration's captured forced
rounds.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port with ``device_type="cpu"``.

Tolerances and why:

- The parse: the same levels, tuple for tuple, and the same errors.
- Dyadic training: a forced split's left sums come from the leaf's
  histogram of exact dyadic sums, so the model text is byte-identical to
  the jitted JAX package's same backend; under ``pallas`` to its
  ``scatter`` (its ``pallas`` is wrong at a split budget of one, ROADMAP
  §3, and a forced level of one split is such a round).
- Fused against eager: the same operations on the same device, byte for
  byte on real gradients.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax

import lightgbm_tpu as lgb
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.ops import grow as tgrow

from test_torch_categorical import CAT, _cat_data
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
_BASE = {"objective": "none", "num_leaves": 31, "max_splits_per_round": 8,
         "hist_precision": "single", "min_data_in_leaf": 5, "max_bin": 63,
         "verbosity": -1}

# feature 0 carries NaN (10 %), feature 1 is zero-heavy
ONE = {"feature": 2, "threshold": 0.25}
TWO = {"feature": 0, "threshold": 0.0,
       "left": {"feature": 1, "threshold": 0.3},
       "right": {"feature": 2, "threshold": -0.2, "default_left": True}}
THREE = {"feature": 0, "threshold": 0.0, "default_left": True,
         "left": {"feature": 1, "threshold": 0.3,
                  "left": {"feature": 3, "threshold": -0.5},
                  "right": {"feature": 0, "threshold": 0.7}},
         "right": {"feature": 2, "threshold": -0.2,
                   "right": {"feature": 4, "threshold": 1.0,
                             "default_left": True}}}
SPECS = {"one": ONE, "two": TWO, "three": THREE}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _spec_file(tmp_path, spec, name="forced.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


def _train(pkg, params, iters=2, data=None, fobj=_dyadic_fobj, cat=None):
    X, y = data if data is not None else _sampled_data(1000, 5)
    kw = CPU if pkg is lt else {}
    ds_kw = {} if cat is None else {"categorical_feature": cat}
    bst = pkg.Booster({**params, **kw}, pkg.Dataset(
        X, label=y, params={"max_bin": params["max_bin"], **kw}, **ds_kw))
    for _ in range(iters):
        bst.update(fobj=fobj)
    return bst


def _text(bst):
    return _trees_text(bst.model_to_string())


def _top_nodes(tree, spec):
    """Walk the forced spec down a host tree: each forced node's feature and
    the bin-space threshold's real value there."""
    out = []
    frontier = [(spec, 0)]
    while frontier:
        nxt = []
        for node, i in frontier:
            out.append((int(tree.split_feature[i]), node["feature"]))
            for side, child in (("left", tree.left_child[i]),
                                ("right", tree.right_child[i])):
                if node.get(side):
                    assert child >= 0
                    nxt.append((node[side], int(child)))
        frontier = nxt
    return out


# ----------------------------------------------------------------- parse

def test_parse_levels_equal_jax(tmp_path):
    """``_parse_forced_splits``: the JAX package's levels tuple for tuple
    (leaves, features, ``searchsorted`` threshold bins, default lefts),
    and none without a file or for an empty spec."""
    fn = _spec_file(tmp_path, THREE)
    tb = _train(lt, {**_BASE, "forcedsplits_filename": fn}, iters=1)
    jb = _train(lgb, {**_BASE, "forcedsplits_filename": fn}, iters=1)
    levels = tb.engine._parse_forced_splits()
    assert levels == jb.engine._parse_forced_splits()
    assert [lv[0] for lv in levels] == [(0,), (0, 1), (0, 2, 3)]
    assert levels[0][3] == (True,) and levels[2][3] == (False, False, True)
    assert tb.engine.grow_params.forced == levels
    empty = _spec_file(tmp_path, {}, "empty.json")
    for fname in ("", empty):
        b = _train(lt, {**_BASE, "forcedsplits_filename": fname}, iters=1)
        assert b.engine._parse_forced_splits() == ()


@pytest.mark.parametrize("case,match", [
    ("categorical", "categorical forced splits"),
    ("out_of_range", "out of range"),
    ("too_deep", "forced splits need"),
    ("missing", "not found"),
    ("bad_json", "not valid JSON")])
def test_parse_errors_as_jax(tmp_path, case, match):
    """The JAX package's errors, raised by both packages under the same
    condition: a categorical feature, a feature out of range, a spec that
    needs more than ``num_leaves`` leaves, a missing file, bad JSON."""
    X, y = _cat_data(600, 1)
    params = {**_BASE, "num_leaves": 31}
    if case == "categorical":
        fn = _spec_file(tmp_path, {"feature": CAT[0], "threshold": 1.0})
    elif case == "out_of_range":
        fn = _spec_file(tmp_path, {"feature": 8, "threshold": 0.0})
    elif case == "too_deep":
        node = root = {"feature": 0, "threshold": 0.0}
        for _ in range(4):
            node["right"] = {"feature": 1, "threshold": 0.0}
            node["left"] = node = {"feature": 0, "threshold": 0.0}
        fn = _spec_file(tmp_path, root)
        params["num_leaves"] = 4
    elif case == "missing":
        fn = str(tmp_path / "nothing.json")
    else:
        fn = str(tmp_path / "bad.json")
        (tmp_path / "bad.json").write_text("{feature: 0")
    for pkg in (lt, lgb):
        with pytest.raises(pkg.LightGBMError, match=match):
            _train(pkg, {**params, "forcedsplits_filename": fn}, iters=1,
                   data=(X, y), cat=CAT)


# -------------------------------------------------------------- training

@pytest.mark.parametrize("spec,backend", [
    ("one", "stream"), ("two", "stream"), ("three", "stream"),
    ("two", "scatter"), ("three", "scatter")])
def test_dyadic_training_byte_identical_to_jax(tmp_path, spec, backend):
    """One, two and three forced levels (NaN on feature 0, both default
    sides): the JAX package's model text byte for byte; every tree's top
    nodes are the forced ones; other trees than without the file."""
    fn = _spec_file(tmp_path, SPECS[spec])
    params = {**_BASE, "forcedsplits_filename": fn, "hist_backend": backend}
    tb = _train(lt, params)
    text = _text(tb)
    assert text == _text(_train(lgb, params))
    assert text != _text(_train(lt, {**_BASE, "hist_backend": backend}))
    for tree in tb.engine.models:
        for got, want in _top_nodes(tree, SPECS[spec]):
            assert got == want


@pytest.mark.parametrize("spec", ["two", "three"])
def test_pallas_byte_identical_to_jax_scatter(tmp_path, spec):
    """Under ``pallas`` (K6): the JAX package's ``scatter`` text byte for
    byte, as the port's ``pallas`` equals its ``scatter``."""
    fn = _spec_file(tmp_path, SPECS[spec])
    params = {**_BASE, "forcedsplits_filename": fn}
    text = _text(_train(lt, {**params, "hist_backend": "pallas"}))
    assert text == _text(_train(lgb, {**params, "hist_backend": "scatter"}))
    assert text == _text(_train(lt, {**params, "hist_backend": "scatter"}))


def test_no_sprint_under_forced_splits(tmp_path, monkeypatch):
    """A budget of 64 on 127 leaves: the forced rounds, then full rounds
    with histograms to the end, no route-only sprint (reference: :1543);
    the JAX package's text byte for byte."""
    fn = _spec_file(tmp_path, TWO)
    params = {**_BASE, "forcedsplits_filename": fn, "num_leaves": 127,
              "max_splits_per_round": 64, "min_data_in_leaf": 2,
              "hist_backend": "stream"}
    calls = []
    k2 = tgrow.route_and_hist

    def spy(*a):
        calls.append((a[7], a[10]))
        return k2(*a)

    monkeypatch.setattr(tgrow, "route_and_hist", spy)
    tb = _train(lt, params, iters=1)
    assert _text(tb) == _text(_train(lgb, params, iters=1))
    # root (1 slot), the two forced levels (1 and 2 slots), then full rounds
    assert [c[0] for c in calls[:3]] == [1, 1, 2]
    assert all(with_hist for _, with_hist in calls)
    assert tb.engine.models[0].num_leaves > 64


def test_prefix_schedule_with_bagging(tmp_path):
    """A budget of 100 on 200 leaves under bagging: the forced levels, the
    budget-64 prefix and the full rounds on compacted rows (no replay:
    route fusion is off under forced splits), the JAX text byte for
    byte."""
    fn = _spec_file(tmp_path, THREE)
    params = {**_BASE, "forcedsplits_filename": fn, "num_leaves": 200,
              "max_splits_per_round": 100, "min_data_in_leaf": 2,
              "bagging_fraction": 0.5, "bagging_freq": 1,
              "hist_backend": "stream"}
    data = _sampled_data(1500, 5)
    tb = _train(lt, params, data=data)
    assert _text(tb) == _text(_train(lgb, params, data=data))
    assert tb.engine.last_compact_rows > 0
    assert not tgrow.fusion_applies(tb.engine.grow_params,
                                    tb.engine.last_compact_rows)


def test_quantized_and_cegb_byte_identical(tmp_path):
    """Forced splits with quantized gradients (K2's int form) and with
    CEGB, whose state the forced rounds update too."""
    from test_torch_cegb import ALL
    from test_torch_quantized import _pow2_fobj
    fn = _spec_file(tmp_path, TWO)
    for extra, fobj in (({"use_quantized_grad": True,
                          "learning_rate": 0.5}, _pow2_fobj),
                        (ALL, _dyadic_fobj)):
        params = {**_BASE, **extra, "forcedsplits_filename": fn,
                  "hist_backend": "stream"}
        assert _text(_train(lt, params, fobj=fobj)) == \
            _text(_train(lgb, params, fobj=fobj))


@pytest.mark.parametrize("backend", ["stream", "scatter"])
def test_multiclass_one_class_at_a_time(tmp_path, backend):
    """K = 3 forced class trees grow one at a time (no lockstep), each
    with the forced top: the JAX package's text byte for byte."""
    fn = _spec_file(tmp_path, TWO)
    params = {**_BASE, "forcedsplits_filename": fn, "objective": "multiclass",
              "num_class": 3, "learning_rate": 0.5, "hist_backend": backend}
    data = _mc_data(1000, 1)
    tb = _train(lt, params, data=data, fobj=_dyadic_mc_fobj)
    assert _text(tb) == _text(_train(lgb, params, data=data,
                                     fobj=_dyadic_mc_fobj))
    assert not tb.engine._use_batched_multiclass()
    for tree in tb.engine.models:
        assert [g for g, _ in _top_nodes(tree, TWO)] == [0, 1, 2]


@pytest.mark.parametrize("extra", [
    {}, {"data_sample_strategy": "goss", "num_leaves": 127,
         "max_splits_per_round": 64, "learning_rate": 0.5},
    {"num_leaves": 200, "max_splits_per_round": 100}],
    ids=["plain", "goss", "prefix"])
def test_fused_equals_eager(tmp_path, extra):
    """A forced single class tree fuses (each forced level a round of the
    device-state grower, its tensors made at allocation) with the eager
    text, on real gradients; the forced rounds run under their own keys."""
    fn = _spec_file(tmp_path, THREE)
    X, y = _sampled_data(2000, 7)
    p = {"objective": "binary", "num_leaves": 31, "max_splits_per_round": 8,
         "max_bin": 63, "min_data_in_leaf": 5, "verbosity": -1,
         "forcedsplits_filename": fn, **extra, **CPU}
    texts = []
    for fused in ("off", "on"):
        b = lt.train({**p, "fused_iter": fused},
                     lt.Dataset(X, label=y, params=p), 4)
        texts.append(_text(b))
        assert b.engine._fused == (fused == "on")
    assert texts[0] == texts[1]
    gr = next(iter(b.engine._fused_growers.values()))
    assert len(gr.forced) == 3 and not gr.fuse


def test_loop_plan_counts_the_forced_leaves():
    """``loop_plan`` starts from the leaves the forced levels make and
    plans no sprint under them."""
    gp = tgrow.GrowParams(num_leaves=31, max_depth=-1,
                          max_splits_per_round=64, lambda_l1=0.0,
                          lambda_l2=0.0, min_data_in_leaf=1,
                          min_sum_hessian_in_leaf=0.0,
                          min_gain_to_split=0.0, max_delta_step=0.0)
    forced = gp._replace(forced=(((0,), (1,), (3,), (False,)),
                                 ((0, 1), (2, 2), (4, 5), (False, True))))
    assert tgrow.loop_plan(gp) == 5
    assert tgrow.loop_plan(forced) == 3


# ------------------------------------------- the JAX package's own claims

def _reg_data(n=2000, seed=12):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    y = X[:, 0] + 2 * X[:, 1] + 0.1 * rs.randn(n)
    return X, y


def test_forced_splits_applied(tmp_path):
    X, y = _reg_data()
    fn = _spec_file(tmp_path, {"feature": 3, "threshold": 0.0,
                               "left": {"feature": 4, "threshold": 0.5}})
    bst = lt.train({"objective": "regression", "num_leaves": 15,
                    "verbosity": -1, "min_data_in_leaf": 5,
                    "forcedsplits_filename": fn, **CPU},
                   lt.Dataset(X, label=y, params=CPU), num_boost_round=3)
    for t in bst.engine.models:
        assert int(t.split_feature[0]) == 3
        assert abs(float(t.threshold[0])) < 0.2
        lc = int(t.left_child[0])
        assert lc >= 0 and int(t.split_feature[lc]) == 4
        assert abs(float(t.threshold[lc]) - 0.5) < 0.25
    assert np.corrcoef(bst.predict(X), y)[0, 1] > 0.9


def test_forced_split_leaf_counts_are_exact(tmp_path):
    """The forced round estimates the left count from the hessians, and
    the children then take the routed rows' exact counts (reference:
    serial_tree_learner.cpp:798): the root's children's counts sum to the
    rows and split them at the threshold."""
    X, y = _reg_data(1000)
    fn = _spec_file(tmp_path, {"feature": 1, "threshold": 0.0})
    bst = lt.train({"objective": "regression", "num_leaves": 2,
                    "verbosity": -1, "min_data_in_leaf": 1,
                    "forcedsplits_filename": fn, **CPU},
                   lt.Dataset(X, label=y, params=CPU), num_boost_round=1)
    t = bst.engine.models[0]
    assert t.num_leaves == 2 and int(t.split_feature[0]) == 1
    left = int((X[:, 1] <= t.threshold[0]).sum())
    assert list(t.leaf_count) == [left, len(y) - left]


def test_reset_to_forced_splits_retrains(tmp_path):
    """``reset_parameter`` to a forced tree after two trees: the next trees
    take it, as the JAX package's do once its grower is given the levels
    by hand (its ``reset_parameter`` rebuilds the grower without them,
    ROADMAP §3); the port's fused path drops its graphs and growers."""
    import functools
    from lightgbm_tpu.ops.grow import grow_tree as jgrow
    fn = _spec_file(tmp_path, TWO)
    data = _sampled_data(1000, 5)
    texts = []
    for pkg in (lt, lgb):
        bst = _train(pkg, {**_BASE, "hist_backend": "stream"}, data=data)
        bst.reset_parameter({"forcedsplits_filename": fn})
        if pkg is lgb:
            e = bst.engine
            e._grow_fn = jax.jit(functools.partial(
                jgrow, layout=e.dd.layout, routing=e.dd.routing,
                params=e._grow_params, forced=e._parse_forced_splits()),
                static_argnames=("compact_rows",))
        for _ in range(2):
            bst.update(fobj=_dyadic_fobj)
        texts.append(_text(bst))
        if pkg is lt:
            for tree in bst.engine.models[2:]:
                assert [g for g, _ in _top_nodes(tree, TWO)] == [0, 1, 2]
    assert texts[0] == texts[1]
