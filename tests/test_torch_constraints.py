"""Growth constraints of the port against the JAX package, on the CPU:
basic monotone constraints with ``monotone_penalty``, interaction
constraints and ``path_smooth``.

The same numpy inputs go through the JAX package and through the port with
``device_type="cpu"``; the JAX package's Pallas kernels run in interpret
mode.

Tolerances and why:

- The copied helpers, the parameter parsing and the split scan on dyadic
  histograms: the same float32 operations in the same order as the JAX
  package's run op by op, so bit-equal.
- Dyadic training against the JAX package run op by op
  (``jax.disable_jit``): byte-identical model text
  (tests/test_torch_constraints_eager.py).
- Dyadic training against the jitted JAX package: XLA fuses the
  output-based gain (``leaf_gain_given_output`` of the constrained
  outputs) and rounds it differently from op-by-op evaluation, as under
  ``max_delta_step`` (ROADMAP §3).  Every tree, threshold, leaf value and
  count is identical; ``split_gain`` within 2e-5 of the tree's largest
  gain (measured: 1.6e-5 of a gain near 1, 7e-7 of the root gain).
- Real gradients: the model holds its constraints, tested as such.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.models import gbdt as tgbdt
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops import split as tsplit

from test_torch_categorical import _scan_case
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}
GAIN_RTOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------- helpers

def _f32(rs, *shape, lo=-4.0, hi=4.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def test_smooth_output_and_child_outputs_bit_equal():
    """``smooth_output`` and ``constrained_child_outputs`` (ridge output,
    max_delta_step clamp, smoothing, bound clip) bit-equal to the JAX
    package's on random float32 inputs, with and without each step."""
    rs = np.random.RandomState(0)
    n = 4096
    lg, rg = _f32(rs, n), _f32(rs, n)
    lh, rh = _f32(rs, n, lo=0.01), _f32(rs, n, lo=0.01)
    lc, rc = np.floor(_f32(rs, n, lo=1, hi=500)), np.floor(_f32(rs, n, lo=1,
                                                                hi=500))
    lo, hi = _f32(rs, n, hi=0.0), _f32(rs, n, lo=0.0)
    po = _f32(rs, n, lo=-1, hi=1)
    t, j = torch.as_tensor, jnp.asarray
    np.testing.assert_array_equal(
        _bits(tsplit.smooth_output(t(lg), t(lc), t(po), 3.0).numpy()),
        _bits(jsplit.smooth_output(j(lg), j(lc), j(po), 3.0)))
    for l1, l2, ps, mds in ((0.0, 0.0, 0.0, 0.0), (0.5, 1.0, 2.0, 0.0),
                            (0.0, 0.1, 0.0, 0.7), (1.5, 0.0, 10.0, 1.25)):
        got = tsplit.constrained_child_outputs(
            t(lg), t(lh), t(lc), t(rg), t(rh), t(rc), l1, l2, t(lo), t(hi),
            ps, t(po), mds)
        want = jsplit.constrained_child_outputs(
            j(lg), j(lh), j(lc), j(rg), j(rh), j(rc), l1, l2, j(lo), j(hi),
            ps, j(po), mds)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("penalty", [0.0, 0.5, 1.0, 2.5, 7.0])
def test_monotone_penalty_factor_bit_equal(penalty):
    """ComputeMonotoneSplitGainPenalty of depths 0..300, both branches and
    the cut-off where the penalty reaches the depth; the grower's table
    (``penalty_table``, computed on the CPU for every device) read at a
    depth clamped to its last entry gives the same factors."""
    d = np.arange(301, dtype=np.int32)
    got = tsplit.monotone_penalty_factor(torch.as_tensor(d), penalty)
    want = jsplit.monotone_penalty_factor(jnp.asarray(d), penalty)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    table = tsplit.penalty_table(penalty, torch.device("cpu"))
    at = table[torch.clamp(torch.as_tensor(d), max=len(table) - 1)]
    np.testing.assert_array_equal(_bits(at.numpy()), _bits(want))


def _parse(module, F, **params):
    """One package's parsing of the constraint parameters, through the
    engine's own methods."""
    cfg = (JConfig if module is jgbdt else TConfig).from_params(params)
    ns = types.SimpleNamespace(config=cfg,
                               dd=types.SimpleNamespace(num_features=F),
                               device=torch.device("cpu"))
    mono = module.GBDT._monotone_array(ns)
    groups = module.GBDT._interaction_group_masks(ns)
    return (None if mono is None else np.asarray(mono),
            None if groups is None else np.asarray(groups))


@pytest.mark.parametrize("params", [
    {"monotone_constraints": [1, 0, -1, 0]},
    {"monotone_constraints": "1,0,-1,0"},
    {"monotone_constraints": [0, 0, 0, 0]},
    {"mc": [-1, -1, 1, 0], "monotone_constraints_method": "bogus"},
    {"interaction_constraints": [[0, 1], [1, 2, 3]]},
    {"interaction_constraints": "[0,1],[2,3]"},
    {"interaction_constraints": [2, 3]},
    {"interaction_constraints": "[[0],[1,2]]", "monotone_constraints":
     [0, 1, 0, 0]},
])
def test_parameter_parsing_matches_jax(params):
    """``_monotone_array`` and ``_interaction_group_masks`` give the JAX
    package's signs and groups, from lists and strings alike; all-zero
    signs are no constraint."""
    t_mono, t_groups = _parse(tgbdt, 4, **params)
    j_mono, j_groups = _parse(jgbdt, 4, **params)
    for a, b in ((t_mono, j_mono), (t_groups, j_groups)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("params,match", [
    ({"monotone_constraints": [1, 0, 0]}, "has 3 entries but the dataset "
     "has 4 features"),
    ({"interaction_constraints": [[0, 4]]}, "feature index 4 out of range"),
])
def test_parameter_errors_word_for_word(params, match):
    for module in (tgbdt, jgbdt):
        with pytest.raises(Exception, match=match):
            _parse(module, 4, **params)


# ------------------------------------------------------------ split scan

@functools.lru_cache(maxsize=None)
def _case():
    return _scan_case()


@pytest.mark.parametrize("smooth", [0.0, 2.0])
@pytest.mark.parametrize("penalty", [0.0, 1.5])
@pytest.mark.parametrize("mds", [0.0, 0.25])
def test_find_best_splits_constrained_bit_equal(smooth, penalty, mds):
    """Each slot's best split under monotone signs (one on a categorical
    feature, which stays unconstrained), per-slot output bounds, own
    outputs and depths, ``monotone_penalty`` and ``path_smooth``: every
    field bit-equal to the JAX package's scan run op by op, on dyadic
    histograms over numeric, bundled and categorical features."""
    jds, tds, hist, pg, ph, pc = _case()
    S = hist.shape[0]
    F = tds.device_data().num_features
    rs = np.random.RandomState(3)
    mono = np.zeros(F, np.int32)
    mono[[0, 2, 6]] = [1, -1, 1]
    lo = np.where(rs.rand(S) < 0.5, -1e30, -rs.rand(S) / 8).astype(
        np.float32)
    hi = np.where(rs.rand(S) < 0.5, 1e30, rs.rand(S) / 8).astype(np.float32)
    po = (rs.randn(S) / 16).astype(np.float32)
    depth = rs.randint(0, 5, S).astype(np.int32)
    cat = tsplit.CatParams(min_data_per_group=5, cat_smooth=1.0)
    base = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=5,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    j = jsplit.find_best_splits(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jds.device_data().layout, **base, max_delta_step=mds,
        monotone=jnp.asarray(mono), out_lo=jnp.asarray(lo),
        out_hi=jnp.asarray(hi), slot_depth=jnp.asarray(depth),
        monotone_penalty=penalty, path_smooth=smooth,
        parent_out=jnp.asarray(po), **cat._asdict())
    t = torch.as_tensor
    pen = (tsplit.penalty_table(penalty, torch.device("cpu"))[depth]
           if penalty > 0 else None)
    got = tsplit.find_best_splits(
        t(hist), t(pg), t(ph), t(pc), tds.device_data().layout, **base,
        max_delta_step=mds, cat=cat, monotone=t(mono.astype(np.int64)),
        out_lo=t(lo), out_hi=t(hi), slot_penalty=pen, path_smooth=smooth,
        parent_out=t(po))
    assert got.feat_ok is None and j.feat_ok is None
    for name in tsplit.SplitResult._fields[:-1]:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (got.gain.numpy() > 0).sum() >= S // 2


# -------------------------------------------------------------- training

_MONO = [1, 0, -1, 0, 0, 1]
_GROUPS = [[0, 1, 2], [2, 3, 4, 5]]
_CONSTRAINTS = {
    "monotone": {"monotone_constraints": _MONO},
    "monotone_penalty": {"monotone_constraints": _MONO,
                         "monotone_penalty": 1.5},
    "interaction": {"interaction_constraints": _GROUPS},
    "path_smooth": {"path_smooth": 2.0},
    "all": {"monotone_constraints": _MONO, "monotone_penalty": 0.5,
            "interaction_constraints": _GROUPS, "path_smooth": 1.0},
}
_BASE = {"objective": "none", "num_leaves": 31, "max_splits_per_round": 8,
         "hist_precision": "single", "min_data_in_leaf": 5, "max_bin": 63,
         "verbosity": -1}


def _train(pkg, params, iters=2, n=1000, fobj=_dyadic_fobj, data=None,
           op_by_op=False):
    """A booster after ``iters`` updates; ``op_by_op``: the updates with
    JAX's jit off."""
    X, y = data if data is not None else _sampled_data(n, 5)
    kw = CPU if pkg is lt else {}
    bst = pkg.Booster({**params, **kw}, pkg.Dataset(
        X, label=y, params={"max_bin": params["max_bin"], **kw}))
    for _ in range(iters):
        if op_by_op:
            with jax.disable_jit():
                bst.update(fobj=fobj)
        else:
            bst.update(fobj=fobj)
    return bst


def _split_gains(text):
    return [np.array(line.split("=")[1].split(), np.float64)
            for line in text.splitlines() if line.startswith("split_gain=")]


def _assert_same_trees(text, want):
    """Identical model text but for ``split_gain`` (and the tree sizes it
    moves), which stays within GAIN_RTOL of each tree's largest gain."""
    def rest(t):
        return [line for line in t.splitlines()
                if not line.startswith(("split_gain=", "tree_sizes="))]

    assert rest(text) == rest(want)
    for a, b in zip(_split_gains(text), _split_gains(want)):
        assert np.abs(a - b).max() <= GAIN_RTOL * np.abs(b).max()


@functools.lru_cache(maxsize=None)
def _jax_text(case, backend):
    return _trees_text(_train(lgb, {**_BASE, **_CONSTRAINTS[case],
                                    "hist_backend": backend})
                       .model_to_string())


@functools.lru_cache(maxsize=None)
def _port_stream_text(case):
    return _trees_text(_train(lt, {**_BASE, **_CONSTRAINTS[case],
                                   "hist_backend": "stream"})
                       .model_to_string())


@pytest.mark.parametrize("backend", ["stream", "scatter", "pallas"])
@pytest.mark.parametrize("case", sorted(_CONSTRAINTS))
def test_dyadic_training_matches_jax(case, backend):
    """Two trees on dyadic custom gradients under each constraint and all
    together: the JAX package's trees under the same backend (split gains
    within the jit's rounding bound; interaction constraints alone gain as
    plain trees do, byte for byte), and the port's three backends
    byte-identical to each other."""
    params = {**_BASE, **_CONSTRAINTS[case], "hist_backend": backend}
    tb = _train(lt, params)
    text = _trees_text(tb.model_to_string())
    want = _jax_text(case, backend)
    if case == "interaction":
        assert text == want
    else:
        _assert_same_trees(text, want)
    assert text == _port_stream_text(case)
    assert min(t.num_leaves for t in tb.engine.models) > 8


def test_sampled_sprint_schedule_matches_jax():
    """Every constraint under bagging at split budget 64 (the stream
    schedule's full rounds on compacted rows with route-only passes over
    all rows, and the sprint): the JAX package's trees."""
    params = {**_BASE, **_CONSTRAINTS["all"], "num_leaves": 127,
              "max_splits_per_round": 64, "min_data_in_leaf": 2,
              "hist_backend": "stream", "bagging_fraction": 0.5,
              "bagging_freq": 1}
    tb = _train(lt, params, n=1500)
    jb = _train(lgb, params, n=1500)
    _assert_same_trees(_trees_text(tb.model_to_string()),
                       _trees_text(jb.model_to_string()))
    assert tb.engine.last_compact_rows > 0
    assert min(t.num_leaves for t in tb.engine.models) > 64


@pytest.mark.parametrize("extra", [
    {}, {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"data_sample_strategy": "goss", "learning_rate": 0.5}],
    ids=["plain", "bagging", "goss"])
def test_fused_equals_eager_and_no_route_fusion(extra, monkeypatch):
    """Constrained binary trees fuse (``fused_iter`` on: the device-state
    grower) with the eager text; a sampled constrained tree compacts but
    takes the route-only passes, never K3 (``plain_growth`` gate)."""
    replays = []
    monkeypatch.setattr(tgrow, "route_replay",
                        lambda *a: replays.append(1) / 0)
    X, y = _sampled_data(2000, 7)
    p = {"objective": "binary", "num_leaves": 63, "max_splits_per_round": 64,
         "max_bin": 63, "min_data_in_leaf": 5, "verbosity": -1,
         **_CONSTRAINTS["all"], **extra, **CPU}
    texts = []
    for fused in ("off", "on"):
        b = lt.train({**p, "fused_iter": fused},
                     lt.Dataset(X, label=y, params=p), 4)
        texts.append(_trees_text(b.model_to_string()))
        assert b.engine._fused == (fused == "on")
    assert texts[0] == texts[1] and not replays
    if extra:
        assert b.engine.last_compact_rows > 0
        assert not tgrow.fusion_applies(b.engine.grow_params,
                                        b.engine.last_compact_rows)


# --------------------------------------------------------- real gradients

def _tree_paths(tree):
    """Each leaf's root-to-leaf split features."""
    out = []

    def walk(node, feats):
        if node < 0:
            out.append(feats)
            return
        f = feats | {int(tree.split_feature[node])}
        walk(tree.left_child[node], f)
        walk(tree.right_child[node], f)

    if tree.num_leaves > 1:
        walk(0, set())
    return out


def test_real_gradients_hold_the_constraints():
    """Binary logloss on real gradients, 15 trees of 31 leaves under every
    constraint: predictions are non-decreasing (non-increasing) along a
    64-point sweep of each +1 (-1) feature on 300 rows, and every leaf's
    path features lie in one interaction group."""
    rs = np.random.RandomState(8)
    n = 4000
    X = rs.randn(n, 6)
    logit = (1.5 * X[:, 0] - X[:, 2] + np.sin(2 * X[:, 1]) * X[:, 3]
             + 0.5 * X[:, 5] * X[:, 4])
    y = (logit + 0.5 * rs.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 10, "verbosity": -1, **_CONSTRAINTS["all"],
         **CPU}
    b = lt.train(p, lt.Dataset(X, label=y, params=p), 15)
    groups = [set(g) for g in _GROUPS]
    for tree in b.engine.models:
        for path in _tree_paths(tree):
            assert any(path <= g for g in groups), path
    sweep = np.linspace(-3, 3, 64)
    rows = X[:300]
    moved = 0
    for f, sign in enumerate(_MONO):
        if sign == 0:
            continue
        Xs = np.repeat(rows, 64, axis=0)
        Xs[:, f] = np.tile(sweep, 300)
        pred = b.predict(Xs, raw_score=True).reshape(300, 64)
        steps = np.diff(pred, axis=1) * sign
        assert steps.min() >= -1e-12, (f, steps.min())
        moved += steps.max() > 0
    assert moved >= 2
    unconstrained = lt.train({**p, "monotone_constraints": None,
                              "interaction_constraints": None},
                             lt.Dataset(X, label=y, params=p), 15)
    assert not all(any(path <= g for g in groups)
                   for t in unconstrained.engine.models
                   for path in _tree_paths(t))
