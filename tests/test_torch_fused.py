"""The fused iteration of the port (``fused_iter``), on the CPU.

``fused_iter="on"`` on the CPU runs the device-state grower of the fused
path (models/gbdt.py ``_iter_fused``, ops/grow.py ``_DeviceGrower``) with
its steps called directly; on a CUDA device the same steps are captured as
CUDA graphs and replayed.

Tolerances and why:

- ``fused_iter`` on against off in the port: the same torch ops on the same
  inputs (histograms exact fixed point whatever their slot count), so the
  model text is byte-identical, the ``fused_iter`` parameter line aside.
- The port's fused path against the JAX package's ``fused_iter="on"`` on
  real binary gradients: the same tree structures, and predictions within
  rtol 1e-4 / atol 1e-5, the tolerance of the reference's own
  ``test_fused_iteration_matches_unfused`` (float sums in other orders).
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
from lightgbm_torch.models import gbdt as tgbdt
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.utils import timer as ttimer

from test_torch_train import _mixed, _structure

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _text(bst):
    """The model text without the parameter line that differs."""
    return "\n".join(line for line in bst.model_to_string().splitlines()
                     if not line.startswith("[fused_iter:"))


def _wide(n, seed):
    """A continuous column at max_bin 400 (a group past 256 bins: 16-bit
    bins) beside _mixed's columns."""
    X, y = _mixed(n, seed)
    return np.column_stack([X, np.random.RandomState(seed + 1).rand(n)]), y


def _step(n, seed):
    """A label one split fits exactly."""
    X, _ = _mixed(n, seed)
    return X, (X[:, 2] > 0).astype(float)


_BASE = {"objective": "binary", "num_leaves": 127, "max_bin": 15,
         "min_data_in_leaf": 5, "verbosity": -1}

# each case: (data, its categorical columns, parameters)
_CASES = {
    "binary": (_mixed, None, {}),
    "l2": (_mixed, None, {"objective": "regression"}),
    "multiclass_lockstep": (_mixed, None, {"objective": "multiclass",
                                           "num_class": 3,
                                           "num_leaves": 31}),
    "goss_fused_k3": (_mixed, None, {"data_sample_strategy": "goss",
                                     "learning_rate": 0.5}),
    "bagging_fused_k3": (_mixed, None, {"bagging_fraction": 0.5,
                                        "bagging_freq": 2}),
    "quantized": (_mixed, None, {"use_quantized_grad": True}),
    "categorical": (lambda n, s: _mixed(n, s, cat=True), [5],
                    {"num_leaves": 31}),
    "wide_bins": (_wide, None, {"max_bin": 400, "num_leaves": 31}),
    "nan_zero_as_missing": (_mixed, None, {"zero_as_missing": True,
                                           "num_leaves": 31}),
    "max_depth": (_mixed, None, {"max_depth": 3}),
    "prefix_budget_64": (_mixed, None, {"num_leaves": 160,
                                        "max_splits_per_round": 100}),
    "stops_early": (_step, None, {"objective": "regression",
                                  "learning_rate": 1.0,
                                  "min_gain_to_split": 1e-3}),
    "feature_fraction": (_mixed, None, {"feature_fraction": 0.6,
                                        "num_leaves": 31}),
}


def _train(make, cat, params, fused, iters=4, n=2000, seed=3):
    X, y = make(n, seed)
    if params.get("objective") == "multiclass":
        y = (np.nan_to_num(X[:, 2]) > 0.5).astype(float) + (X[:, 1] > 0)
    p = {**_BASE, **params, **CPU, "fused_iter": fused}
    kw = {"categorical_feature": cat} if cat else {}
    return lt.train(p, lt.Dataset(X, label=y, params=p, **kw), iters)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_on_off_byte_identical(case):
    """Model text byte for byte the same with the fused iteration on and
    off (the fused run through the device-state grower: no host read in a
    round)."""
    make, cat, params = _CASES[case]
    on = _train(make, cat, params, "on")
    off = _train(make, cat, params, "off")
    assert on.engine._fused and not off.engine._fused
    assert on.engine._train_state is not None
    assert _text(on) == _text(off)
    if case in ("goss_fused_k3", "bagging_fused_k3"):
        # compacted, and the rows' leaves through K3's replay
        assert on.engine.last_compact_rows > 0
        assert on.engine.route_only_passes_per_tree() == 1
    if case == "stops_early":
        assert on.num_trees() == off.num_trees() < 4
    if case == "wide_bins":
        assert on.engine.dd.bins.dtype == torch.int16


def test_fused_matches_jax_fused():
    """The reference's test_fused_iteration_matches_unfused data: the port's
    fused path against the JAX package's fused_iter=on (segsum, float32
    sums, the port's split budget), same structures, predictions within
    rtol 1e-4 / atol 1e-5."""
    rs = np.random.RandomState(11)
    X = rs.randn(2000, 8)
    y = (X[:, 0] - X[:, 1] + 0.3 * rs.randn(2000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 5, "max_splits_per_round": 64,
         "fused_iter": "on"}
    jb = lgb.train({**p, "hist_backend": "segsum",
                    "hist_precision": "single"}, lgb.Dataset(X, label=y),
                   num_boost_round=8)
    assert jb.engine._iter_fn is not None
    tb = lt.train({**p, **CPU}, lt.Dataset(X, label=y, params=CPU),
                  num_boost_round=8)
    assert tb.engine._fused
    j_trees, t_trees = jb.engine.models, tb.engine.models
    assert len(j_trees) == len(t_trees) == 8
    assert [_structure(t) for t in t_trees] == \
        [_structure(t) for t in j_trees]
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_no_trailing_trivial_trees_at_poll_cadence():
    """The port's counterpart of test_engine.py::test_no_trailing_trivial_
    trees: fused, the finished flag read every eval_fetch_freq = 8
    iterations, the splitless trees grown between polls dropped."""
    rs = np.random.RandomState(3)
    X = rs.randn(200, 3)
    y = (X[:, 0] > 0).astype(np.float64)
    p = {"objective": "regression", "num_leaves": 4, "learning_rate": 1.0,
         "verbosity": -1, "min_gain_to_split": 1e-3, "min_data_in_leaf": 1,
         "fused_iter": "on", "eval_fetch_freq": 8, **CPU}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    finished_at = None
    for i in range(30):
        if bst.update():
            finished_at = i
            break
    assert bst.engine._finished_check_every == 8
    assert finished_at is not None and (finished_at + 1) % 8 == 0
    trees = bst.engine.models
    assert bst.num_trees() < finished_at + 1
    assert trees[-1].num_leaves > 1
    assert bst.engine.iter_ == bst.num_trees()


def test_poll_cadence_defaults():
    """eval_fetch_freq 0: 16 when fused, 1 when eager."""
    X, y = _mixed(500, 1)
    got = {}
    for fused in ("on", "off"):
        p = {**_BASE, **CPU, "num_leaves": 7, "fused_iter": fused}
        bst = lt.train(p, lt.Dataset(X, label=y, params=p), 1)
        got[fused] = bst.engine._finished_check_every
    assert got == {"on": 16, "off": 1}


def test_goss_overflow_warns_and_turns_compaction_off(caplog):
    """GOSS's analytic capacity against an in-bag count past it: every
    |grad * hess| tied (no split can pass min_gain_to_split), so every row
    is a top row.  The poll counts the overflow, warns once, and the next
    iterations do not compact."""
    rs = np.random.RandomState(0)
    X = rs.randn(4096, 4)
    y = (rs.rand(4096) < 0.1).astype(float)
    p = {"objective": "regression", "data_sample_strategy": "goss",
         "learning_rate": 1.0, "min_gain_to_split": 1e9, "num_leaves": 7,
         "max_bin": 15, "verbosity": 0, "fused_iter": "on",
         "eval_fetch_freq": 1, **CPU}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    eng = bst.engine
    with caplog.at_level(logging.WARNING):
        bst.update()                       # warmup: no sampling
        assert eng.last_compact_rows == 0
        bst.update()                       # sampled: compacted, overflows
        cap = eng.last_compact_rows
        assert 0 < cap < 4096
        assert eng._compact_overflow and eng._overflow_seen == 1
        assert eng.last_sampled_rows == 4096
        bst.update()
        assert eng.last_compact_rows == 0
    warned = [r for r in caplog.records
              if "analytic compaction capacity" in r.getMessage()]
    assert len(warned) == 1


def _snapshot(gr):
    """Every per-leaf tensor of the trees (the spare leaf past them takes a
    dead pair's writes), the leaf ids and the schedule's counts."""
    KL = gr.KL
    return {name: t.clone() for name, t in
            [("hist", gr.hist_f[:KL]), ("bits", gr.cat_bitset_f[:KL]),
             ("words", gr.cat_words_f[:KL]), ("leaf_id", gr.leaf_id),
             ("cur", gr.cur), ("rounds", gr.rounds), ("npos", gr.npos),
             ("progressed", gr.progressed)]
            + [(f"fl.{k}", v[:KL]) for k, v in gr.fl.items()]}


@pytest.mark.parametrize("freeze", [None, 126])
def test_no_op_round_changes_nothing(freeze):
    """A round that no class needs (the tree at its leaf budget) leaves
    every tree field, leaf id, histogram, cached split and count as it
    was."""
    X, y = _mixed(2000, 5)
    p = {**_BASE, **CPU, "fused_iter": "on"}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    bst.update()
    gr = bst.engine._fused_growers[0]
    assert int(gr.cur[0]) == 127
    before = _snapshot(gr)
    gr.round_dev(9, 64, True, freeze, True)
    after = _snapshot(gr)
    assert before.keys() == after.keys()
    for name in before:
        assert torch.equal(before[name], after[name]), name


def _refuse_host_reads(monkeypatch, eng):
    """Make every tensor-to-host conversion raise inside a fused step."""

    def refuse(*a, **kw):
        raise AssertionError("host read inside a fused step")

    real_run = eng._graphs.run

    def guarded(key, fn):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__bool__", "__int__",
                         "__float__", "numpy"):
                m.setattr(torch.Tensor, name, refuse)
            real_run(key, fn)

    eng._graphs.run = guarded


@pytest.mark.parametrize("extra", [
    {"data_sample_strategy": "goss", "learning_rate": 0.5,
     "use_quantized_grad": True},
    {"bagging_fraction": 0.5, "bagging_freq": 1, "feature_fraction": 0.5},
    {"objective": "multiclass", "num_class": 3, "num_leaves": 31},
], ids=["goss_quantized", "bagging_features", "multiclass"])
def test_fused_steps_read_nothing_on_the_host(monkeypatch, extra):
    """No host read inside the head, a round or the tail: the fused steps
    run with every tensor-to-host conversion made to raise."""
    X, y = _mixed(2000, 7)
    if extra.get("objective") == "multiclass":
        y = (X[:, 1] > 0) + (X[:, 2] > 0.5).astype(float)
    p = {**_BASE, **CPU, "fused_iter": "on", **extra}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    _refuse_host_reads(monkeypatch, bst.engine)
    for _ in range(4):
        bst.update()
    assert bst.engine._graphs.eager_runs > 0


def test_one_host_read_per_tree():
    """One (K,) read per tree once the plan covers the tree (its first tree
    plans from loop_plan, then from recent trees), and the poll's every
    eval_fetch_freq iterations."""
    X, y = _mixed(2000, 7)
    p = {**_BASE, **CPU, "fused_iter": "on", "eval_fetch_freq": 4}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    reads = []
    for _ in range(8):
        r0 = ttimer.host_reads()
        bst.update()
        reads.append(ttimer.host_reads() - r0)
    # trees of 9, 10, 9, 9, 8, 8, 8, 8 loop rounds: the first plans 6 and
    # reads after each of its last 3, the second plans 9
    assert bst.engine._loop_rounds == [9, 10, 9, 9, 8, 8, 8, 8]
    assert reads == [4, 2, 1, 2, 1, 1, 1, 2], reads


@pytest.mark.parametrize("backend", ["scatter", "pallas"])
def test_fused_on_with_other_backends_raises(backend):
    X, y = _mixed(500, 1)
    p = {**_BASE, **CPU, "fused_iter": "on", "hist_backend": backend}
    with pytest.raises(lt.LightGBMError, match="not yet ported"):
        lt.train(p, lt.Dataset(X, label=y, params=p), 1)
    # auto keeps the eager path there
    bst = lt.train({**p, "fused_iter": "auto"},
                   lt.Dataset(X, label=y, params=p), 1)
    assert bst.engine._fused is False


def test_custom_gradients_and_auto_on_cpu_run_eager():
    """Custom gradients run the eager iteration even under fused_iter=on,
    and auto does not fuse on the CPU."""
    X, y = _mixed(500, 2)
    p = {**_BASE, **CPU, "num_leaves": 7, "fused_iter": "on"}
    bst = lt.Booster(p, lt.Dataset(X, label=y, params=p))

    def fobj(score, ds):
        g = (score - ds.get_label()).astype(np.float32)
        return g, np.ones_like(g)

    bst.update(fobj=fobj)
    assert bst.engine._fused and bst.engine._train_state is None
    bst.update()
    assert bst.engine._train_state is not None
    auto = lt.train({**p, "fused_iter": "auto"},
                    lt.Dataset(X, label=y, params=p), 1)
    assert auto.engine._fused is False and auto.engine._train_state is None


@pytest.mark.parametrize("params,match", [
    ({"fused_iter": "maybe"}, "fused_iter"),
    ({"eval_fetch_freq": -1}, "eval_fetch_freq"),
])
def test_fused_config_rejected(params, match):
    with pytest.raises(lt.LightGBMError, match=match):
        TConfig.from_params(params)


def test_fused_config_aliases():
    c = TConfig.from_params({"fused_iteration": "off", "flag_poll_freq": 3})
    assert (c.fused_iter, c.eval_fetch_freq, c._unknown) == ("off", 3, {})


def test_loop_plan():
    """The first tree's plan: full rounds to grow every leaf's split."""
    P = tgrow.GrowParams
    base = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=1,
                min_sum_hessian_in_leaf=0.0, min_gain_to_split=0.0,
                max_delta_step=0.0)
    # 255 leaves, budget 64: 1 -> 128 leaves in 7 rounds, then the sprint
    assert tgrow.loop_plan(P(255, 0, 64, **base)) == 7
    # 127 leaves: 64 leaves, then a sprint of 63
    assert tgrow.loop_plan(P(127, 0, 64, **base)) == 6
    # 15 leaves, plain rounds of 14: 1, 2, 4, 8, 15
    assert tgrow.loop_plan(P(15, 0, 64, **base)) == 4
    # budget 100 over 255 leaves: the 7-round prefix reaches 128
    assert tgrow.loop_plan(P(255, 0, 100, **base)) == 0
