"""Cost-effective gradient boosting (CEGB) of the port against the JAX
package, on the CPU: ``cegb_penalty_split``, ``cegb_penalty_feature_coupled``
and ``cegb_penalty_feature_lazy`` under ``cegb_tradeoff``.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port with ``device_type="cpu"``.

Tolerances and why:

- The split scan with a cost on dyadic histograms: one float32 subtraction
  after the same pick, so bit-equal.
- Dyadic training: the costs are dyadic (powers of two times small
  integers) and the counts integers, so every cost is exact and the model
  text is byte-identical to the jitted JAX package's under every backend,
  one class and K classes.
- The JAX package's own claims (tests/test_cegb.py): feature importances
  and leaf counts, compared as they are there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.ops import split as tsplit

from test_torch_categorical import CAT, _cat_data, _scan_case
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_quantized import _pow2_fobj
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text

CPU = {"device_type": "cpu"}

# one cost of each kind, sized to move a 31-leaf tree on 1024 rows without
# stopping it: a split costs 1/64 a row of its leaf, feature 5 costs 4
# while unused, and a row first read on features 0 and 2 costs 1/64 and
# 1/128
SPLIT = {"cegb_penalty_split": 0.015625}
COUPLED = {"cegb_penalty_feature_coupled": [0.0, 0.0, 2.0, 0.0, 1.0, 4.0]}
LAZY = {"cegb_penalty_feature_lazy": [0.015625, 0.0, 0.0078125, 0.0, 0.0,
                                      0.0]}
ALL = {**SPLIT, **COUPLED, **LAZY, "cegb_tradeoff": 0.5}
_BASE = {"objective": "none", "num_leaves": 31, "max_splits_per_round": 8,
         "hist_precision": "single", "min_data_in_leaf": 5, "max_bin": 63,
         "verbosity": -1}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _train(pkg, params, iters=2, data=None, fobj=_dyadic_fobj, cat=None):
    """A booster after ``iters`` updates on 1000 rows (1024 padded: the
    JAX package's lazy bitset needs its stream pad to equal its row pad,
    ROADMAP §3)."""
    X, y = data if data is not None else _sampled_data(1000, 5)
    kw = CPU if pkg is lt else {}
    ds_kw = {} if cat is None else {"categorical_feature": cat}
    bst = pkg.Booster({**params, **kw}, pkg.Dataset(
        X, label=y, params={"max_bin": params["max_bin"], **kw}, **ds_kw))
    for _ in range(iters):
        bst.update(fobj=fobj)
    return bst


def _same_as_jax(params, **kw):
    """The port's and the JAX package's model text, equal byte for byte;
    the port's booster."""
    tb = _train(lt, params, **kw)
    text = _trees_text(tb.model_to_string())
    assert text == _trees_text(_train(lgb, params, **kw).model_to_string())
    return tb, text


# ------------------------------------------------------------ split scan

@pytest.mark.parametrize("with_cat,adv", [(False, False), (True, False),
                                          (True, True)])
def test_find_best_splits_cegb_bit_equal(with_cat, adv):
    """A (S, F) cost taken off each feature's best gain after the numeric
    or categorical pick and before the feature mask: every field bit-equal
    to the JAX package's scan on dyadic histograms and another winner than
    without it; under the advanced method's slabs, ``feat_ok`` is set
    before the cost."""
    jds, tds, hist, pg, ph, pc = _scan_case()
    S, _, Bmax, _ = hist.shape
    F = tds.device_data().num_features
    rs = np.random.RandomState(7)
    pen = (rs.randint(0, 64, (S, F)) / 4).astype(np.float32)
    pen[:, 2] += 64.0    # the free scan's winner in every slot
    mask = rs.rand(F) < 0.8
    cat = tsplit.CatParams(min_data_per_group=5, cat_smooth=1.0)
    base = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=5,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    t = torch.as_tensor
    jkw = cat._asdict() if with_cat else {"enable_categorical": False}
    tkw = {"cat": cat if with_cat else None}
    if adv:
        mono = np.zeros(F, np.int32)
        mono[[0, 2, 6]] = [1, -1, 1]
        vmin = np.full((S, F, Bmax), -1e30, np.float32)
        vmax = np.full((S, F, Bmax), 1e30, np.float32)
        po = (rs.randn(S) / 16).astype(np.float32)
        jkw.update(monotone=jnp.asarray(mono), parent_out=jnp.asarray(po),
                   adv_bounds=(jnp.asarray(vmin), jnp.asarray(vmax)))
        tkw.update(monotone=t(mono.astype(np.int64)), parent_out=t(po),
                   adv_bounds=(t(vmin), t(vmax)))

    def jscan(p):
        return jsplit.find_best_splits(
            jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph),
            jnp.asarray(pc), jds.device_data().layout, **base, **jkw,
            col_mask=jnp.asarray(mask), cegb_penalty=p)

    def tscan(p):
        return tsplit.find_best_splits(
            t(hist), t(pg), t(ph), t(pc), tds.device_data().layout, **base,
            col_mask=t(mask), cegb_penalty=p, **tkw)

    got, j = tscan(t(pen)), jscan(jnp.asarray(pen))
    for name in tsplit.SplitResult._fields:
        if getattr(j, name) is None:
            assert getattr(got, name) is None and not adv
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    free = tscan(None)
    assert not torch.equal(free.feature, got.feature)
    if adv:
        assert torch.equal(free.feat_ok, got.feat_ok)


# -------------------------------------------------------------- training

@pytest.mark.parametrize("mode,backend", [
    ("split", "stream"), ("coupled", "stream"), ("lazy", "stream"),
    ("all", "stream"), ("all", "scatter"), ("all", "pallas")])
def test_dyadic_training_byte_identical_to_jax(mode, backend):
    """Each cost alone and all three together (tradeoff 1/2): the JAX
    package's model text byte for byte, other trees than without the
    costs, trees that still split, and eager growth (CEGB never fuses, is
    not plain growth)."""
    extra = {"split": SPLIT, "coupled": COUPLED, "lazy": LAZY,
             "all": ALL}[mode]
    params = {**_BASE, **extra, "hist_backend": backend}
    tb, text = _same_as_jax(params)
    plain = _train(lt, {**_BASE, "hist_backend": backend})
    assert text != _trees_text(plain.model_to_string())
    assert min(t.num_leaves for t in tb.engine.models) > 4
    gp = tb.engine.grow_params
    assert gp.has_cegb and not gp.plain_growth
    assert not tb.engine._fused


def test_quantized_int_form_byte_identical():
    """All three costs with quantized gradients, every K2 pass in its int
    form, on power-of-two dyadic gradients."""
    params = {**_BASE, **ALL, "use_quantized_grad": True,
              "learning_rate": 0.5, "hist_backend": "stream"}
    tb, _ = _same_as_jax(params, iters=3, fobj=_pow2_fobj)
    assert tb.engine.grow_params.int_hist


def test_bagging_compacted_lazy_counts_read_every_row():
    """Under bagging on compacted rows, the lazy counts read every row's
    leaf: out-of-bag and pad rows are charged too, as in the JAX package
    (its ``segment_sum`` over all N), and the text is its byte for byte."""
    params = {**_BASE, **ALL, "bagging_fraction": 0.5, "bagging_freq": 1,
              "hist_backend": "stream"}
    tb, _ = _same_as_jax(params)
    e = tb.engine
    assert e.last_compact_rows > 0
    lazy = e._cegb.lazy
    assert lazy.shape == (e._score_shape[0], 6)
    # pad rows sit in some leaf; the root split charges every row
    assert lazy[1000:].any() and bool(lazy[:, e.models[0].split_feature[0]]
                                      .all())


def test_goss_byte_identical():
    """All three costs under GOSS past its warm-up (learning rate 1/2)."""
    params = {**_BASE, **ALL, "data_sample_strategy": "goss",
              "top_rate": 0.5, "other_rate": 0.25, "learning_rate": 0.5,
              "hist_backend": "stream"}
    _same_as_jax(params, iters=3)


def test_sprint_schedule_byte_identical():
    """A budget of 64 on 127 leaves: the route-only sprint round charges
    its split leaves' rows too."""
    params = {**_BASE, **ALL, "num_leaves": 127, "max_splits_per_round": 64,
              "min_data_in_leaf": 2, "hist_backend": "stream"}
    _same_as_jax(params)


@pytest.mark.parametrize("backend", ["stream", "scatter"])
def test_categorical_byte_identical(backend):
    """The cost taken off a categorical feature's best split as off a
    numeric one's."""
    params = {**_BASE, "min_data_per_group": 5, "cat_smooth": 1.0,
              "cegb_penalty_split": 0.015625, "cegb_tradeoff": 0.5,
              "cegb_penalty_feature_coupled": [0, 0, 0, 0, 0, 2.0, 4.0, 8.0],
              "cegb_penalty_feature_lazy": [0.0078125] + [0.0] * 7,
              "hist_backend": backend}
    X, y = _cat_data(1000, 3)
    _same_as_jax(params, data=(X, y), cat=CAT)


def test_interaction_constraints_byte_identical():
    """CEGB beside interaction constraints: the cost on the features each
    leaf may still take."""
    params = {**_BASE, **ALL, "hist_backend": "stream",
              "interaction_constraints": [[0, 1, 2], [2, 3, 4, 5]]}
    _same_as_jax(params)


@pytest.mark.parametrize("backend", ["stream", "scatter"])
def test_multiclass_one_class_at_a_time(backend, monkeypatch):
    """K = 3 class trees grown one at a time, each after the previous
    class's updates to the used features and the charged rows: the JAX
    package's text byte for byte; the port never runs K classes in
    lockstep, and class k's tree sees the state class k - 1 left."""
    from lightgbm_torch.models import gbdt as tgbdt
    params = {**_BASE, **ALL, "objective": "multiclass", "num_class": 3,
              "learning_rate": 0.5, "hist_backend": backend}
    seen = []
    grow = tgbdt.grow_tree

    def spy(*a, **k):
        seen.append((k["cegb"].used.clone(), k["cegb"].lazy.sum().item()))
        return grow(*a, **k)

    monkeypatch.setattr(tgbdt, "grow_tree", spy)
    tb, _ = _same_as_jax(params, data=_mc_data(1000, 1),
                         fobj=_dyadic_mc_fobj)
    assert not tb.engine._use_batched_multiclass()
    assert len(seen) == 6
    # the used features and the charged rows only grow, class to class
    for (u0, l0), (u1, l1) in zip(seen, seen[1:]):
        assert bool((u1 | ~u0).all()) and l1 >= l0
    assert seen[1][1] > seen[0][1]


def test_fused_on_runs_eager():
    """``fused_iter="on"`` with CEGB trains eager, without an error, the
    text of ``off`` (reference: gbdt.py:1603-1605)."""
    X, y = _sampled_data(1000, 7)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 5, "verbosity": -1, **ALL, **CPU}
    texts = []
    for fused in ("off", "on"):
        b = lt.train({**p, "fused_iter": fused},
                     lt.Dataset(X, label=y, params=p), 3)
        assert not b.engine._fused
        texts.append(_trees_text(b.model_to_string()))
    assert texts[0] == texts[1]


def test_reset_to_cegb_retrains():
    """``reset_parameter`` to the three costs after two trees: the next
    trees pay them, as the JAX package's do once its grower and state are
    set again by hand (its ``reset_parameter`` rebuilds the grower without
    the cost vectors and keeps the state of construction, ROADMAP §3)."""
    import functools
    from lightgbm_tpu.ops.grow import grow_tree as jgrow
    data = _sampled_data(1000, 5)
    texts = []
    for pkg, reset in ((lt, True), (lgb, True), (lt, False)):
        bst = _train(lt if pkg is lt else lgb, {**_BASE}, data=data)
        if reset:
            bst.reset_parameter(ALL)
            if pkg is lgb:
                e = bst.engine
                e._cegb_used = jnp.zeros(6, bool)
                e._cegb_lazy = jnp.zeros((e.dd.bins.shape[0], 6), bool)
                e._grow_fn = jax.jit(functools.partial(
                    jgrow, layout=e.dd.layout, routing=e.dd.routing,
                    params=e._grow_params,
                    cegb_coupled=e._cegb_coupled_array(),
                    cegb_lazy_pen=e._cegb_lazy_pen_array()),
                    static_argnames=("compact_rows",))
        for _ in range(2):
            bst.update(fobj=_dyadic_fobj)
        texts.append(_trees_text(bst.model_to_string()))
    assert texts[0] == texts[1] != texts[2]


# ------------------------------------------- the JAX package's own claims

def _reg_data(seed, n=1500):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 10)
    # features 5-9 carry real signal so the unpenalized model uses them
    y = X[:, 0] * 2 + X[:, 1] + X[:, 5] + 0.5 * X[:, 6] + 0.1 * rs.randn(n)
    return X, y


_REG = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
        "min_data_in_leaf": 5, **CPU}


def _fit(params, X, y, rounds):
    return lt.train({**_REG, **params}, lt.Dataset(X, label=y, params=CPU),
                    num_boost_round=rounds)


def test_coupled_feature_penalty_suppresses_costly_features():
    X, y = _reg_data(3)
    imp0 = _fit({}, X, y, 5).feature_importance()
    imp1 = _fit({"cegb_tradeoff": 1.0, "cegb_penalty_feature_coupled":
                 [0.0] * 5 + [1e6] * 5}, X, y, 5).feature_importance()
    assert imp0[5:].sum() > 0
    assert imp1[5:].sum() < imp0[5:].sum()


def test_split_penalty_shrinks_trees():
    X, y = _reg_data(5)
    l0 = sum(t.num_leaves for t in _fit({}, X, y, 4).engine.models)
    l1 = sum(t.num_leaves for t in _fit({"cegb_penalty_split": 2.0}, X, y,
                                        4).engine.models)
    assert l1 < l0


def test_lazy_penalty_suppresses_costly_features():
    X, y = _reg_data(6)
    imp0 = _fit({}, X, y, 5).feature_importance()
    imp1 = _fit({"cegb_tradeoff": 1.0, "cegb_penalty_feature_lazy":
                 [0.0] * 5 + [1e5] * 5}, X, y, 5).feature_importance()
    assert imp0[5:].sum() > 0
    assert imp1[5:].sum() < imp0[5:].sum()
    assert imp1[:5].sum() > 0


def test_lazy_penalty_charges_rows_once():
    """With a moderate per-row cost the model still fits: a row pays a
    feature once, and the bitset persists across trees."""
    X, y = _reg_data(7)
    b = _fit({"cegb_penalty_feature_lazy": [0.05] * 10}, X, y, 6)
    pred = np.asarray(b.predict(X))
    assert np.corrcoef(pred, y)[0, 1] > 0.8
    assert bool(b.engine._cegb.lazy[:len(y)].any())


@pytest.mark.parametrize("key", ["cegb_penalty_feature_lazy",
                                 "cegb_penalty_feature_coupled"])
def test_wrong_length_raises(key):
    """A cost vector of another length than the feature count raises the
    JAX package's error in both packages."""
    X, y = _reg_data(6, 300)
    for pkg, kw in ((lt, CPU), (lgb, {})):
        p = {k: v for k, v in _REG.items() if k != "device_type"}
        with pytest.raises(pkg.LightGBMError, match="same size as the "
                           "feature count"):
            pkg.train({**p, **kw, key: [1.0]},
                      pkg.Dataset(X, label=y, params=kw), 2)


def test_vectors_parse_from_strings():
    """Comma-separated cost vectors (a conf file's syntax) parse to the
    lists both packages take, and the text of the list's model."""
    from lightgbm_torch.config import Config as TConfig
    from lightgbm_tpu.config import Config as JConfig
    s = {"cegb_penalty_feature_lazy": "0.015625,0,0.0078125,0,0,0",
         "cegb_penalty_feature_coupled": "0,0,2,0,1,4"}
    for cfg in (TConfig.from_params(s), JConfig.from_params(s)):
        assert cfg.cegb_penalty_feature_lazy == LAZY[
            "cegb_penalty_feature_lazy"]
        assert cfg.cegb_penalty_feature_coupled == COUPLED[
            "cegb_penalty_feature_coupled"]
    assert TConfig().cegb_tradeoff == JConfig().cegb_tradeoff == 1.0
    a = _train(lt, {**_BASE, **s, "hist_backend": "stream"})
    b = _train(lt, {**_BASE, **LAZY, **COUPLED, "hist_backend": "stream"})
    assert _trees_text(a.model_to_string()) == \
        _trees_text(b.model_to_string())
