"""The intermediate and advanced monotone methods of the port against the
JAX package, on the CPU.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode) and through the port with ``device_type="cpu"``.

Tolerances and why:

- ``intermediate_monotone_bounds``, ``advanced_constraint_slabs`` and
  ``adv_child_bounds``: maxima, minima and selections only, so bit-equal.
- The split scan under ``adv_bounds`` and ``splittable`` on dyadic
  histograms: the same float32 operations in the same order as the JAX
  package's, so every field and ``feat_ok`` are bit-equal.
- Dyadic training against the jitted JAX package: XLA fuses the
  output-based gain and rounds it apart from op-by-op evaluation
  (tests/test_torch_constraints.py), so every tree, threshold, leaf value
  and count is identical and ``split_gain`` lies within 2e-5 of the tree's
  largest gain.  Against the JAX package run op by op the text is
  byte-identical (tests/test_torch_monotone_methods_eager.py).
- The JAX package's ``pallas`` backend is wrong at one split a round, the
  only budget of these methods (ROADMAP §3), so the port's ``pallas`` is
  held to the JAX package's ``scatter``.
- Real gradients: the model holds its constraints, tested as such.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops import split as tsplit

from test_torch_constraints import (_BASE, _GROUPS, _MONO, _assert_same_trees,
                                    _case, _train)
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _trees_text

CPU = {"device_type": "cpu"}
BIG = 1e30


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------------ ancestries

def random_ancestry(seed, L, F, bmax):
    """A random tree of L leaves grown as the grower grows one: each split
    takes a random leaf (it keeps its id, the left child; the next id is the
    right child), a random feature and threshold inside the leaf's bin
    rectangle, a random monotone sign and, one split in five, a categorical
    split, which leaves the rectangles as they are.  Returns the (L, L)
    ancestries, the per-node arrays, the (L, F) rectangles and random
    float32 leaf outputs with ties, as numpy arrays."""
    rs = np.random.RandomState(seed)
    anc_l = np.zeros((L, L), bool)
    anc_r = np.zeros((L, L), bool)
    node_mono = np.zeros(L, np.int32)
    node_depth = np.zeros(L, np.int32)
    node_feat = np.zeros(L, np.int32)
    node_thr = np.zeros(L, np.int32)
    node_num = np.ones(L, bool)
    rect_lo = np.zeros((L, F), np.int32)
    rect_hi = np.full((L, F), 2 ** 30, np.int32)
    depth = np.zeros(L, np.int32)
    for nd in range(L - 1):
        o, nw = rs.randint(nd + 1), nd + 1
        f = rs.randint(F)
        lo, hi = rect_lo[o, f], min(rect_hi[o, f], bmax)
        num = rs.rand() >= 0.2 and hi - lo >= 2
        t = rs.randint(lo, hi - 1) if num else rs.randint(bmax)
        node_feat[nd], node_thr[nd], node_num[nd] = f, t, num
        node_mono[nd] = rs.choice([-1, 0, 1]) if num else 0
        node_depth[nd] = depth[o]
        anc_l[nw], anc_r[nw] = anc_l[o], anc_r[o]
        anc_l[o, nd] = anc_r[nw, nd] = True
        rect_lo[nw], rect_hi[nw] = rect_lo[o], rect_hi[o]
        if num:
            rect_hi[o, f] = min(rect_hi[o, f], t + 1)
            rect_lo[nw, f] = max(rect_lo[o, f], t + 1)
        depth[o] = depth[nw] = depth[o] + 1
    leaf_out = (rs.randint(-8, 9, L) / 16).astype(np.float32)
    return (anc_l, anc_r, node_mono, node_depth, node_feat, node_thr,
            node_num, rect_lo, rect_hi, leaf_out)


@pytest.mark.parametrize("seed,L", [(0, 9), (1, 31), (2, 64)])
def test_intermediate_monotone_bounds_bit_equal(seed, L):
    anc_l, anc_r, mono, *_, out = random_ancestry(seed, L, 5, 12)
    want = jgrow.intermediate_monotone_bounds(
        jnp.asarray(anc_l), jnp.asarray(anc_r), jnp.asarray(mono),
        jnp.asarray(out), jnp.asarray(BIG, jnp.float32))
    got = tgrow.intermediate_monotone_bounds(
        torch.as_tensor(anc_l), torch.as_tensor(anc_r),
        torch.as_tensor(mono.astype(np.int64)), torch.as_tensor(out))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    assert (got[0].numpy() > -BIG).any() and (got[1].numpy() < BIG).any()


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
@pytest.mark.parametrize("sign", [1, -1])
def test_grower_state_meets_the_dense_bounds(monkeypatch, method, sign):
    """On one feature every two leaves are comparable, so a monotone tree
    keeps each leaf's output inside ``intermediate_monotone_bounds`` of the
    whole tree: the dense form, fed the ancestry and node state the
    grower's walk reads (``anc_l``, ``anc_r``, ``node_mono``) and the leaf
    outputs after each eager tree, holds the walk's bookkeeping."""
    rs = np.random.RandomState(11)
    X = rs.rand(3000, 1)
    y = sign * X[:, 0] + 0.3 * np.sin(12 * X[:, 0]) + 0.1 * rs.randn(3000)
    checked = []

    def grow(gr, params):
        res = tgrow._GROW(gr, params)
        out = gr.fl["leaf_out"]
        lo, hi = tgrow.intermediate_monotone_bounds(gr.anc_l, gr.anc_r,
                                                    gr.node_mono, out)
        assert bool((lo <= out).all()) and bool((out <= hi).all())
        # every leaf lies below a monotone node, so every leaf is bounded
        checked.append((int(((lo > -BIG) | (hi < BIG)).sum()),
                        res.arrays.num_leaves))
        return res

    monkeypatch.setattr(tgrow, "_GROW", tgrow._grow, raising=False)
    monkeypatch.setattr(tgrow, "_grow", grow)
    p = {"objective": "regression", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 10, "verbosity": -1, "fused_iter": "off",
         "monotone_constraints": [sign],
         "monotone_constraints_method": method, **CPU}
    lt.train(p, lt.Dataset(X, label=y, params=p), 3)
    assert len(checked) == 3
    assert all(n == leaves > 8 for n, leaves in checked), checked


@pytest.mark.parametrize("seed,L,F,bmax,chunk", [
    (0, 9, 3, 8, None), (3, 31, 5, 16, None), (4, 40, 6, 20, 4000),
    (5, 64, 4, 12, 1)])
def test_advanced_constraint_slabs_bit_equal(seed, L, F, bmax, chunk,
                                             monkeypatch):
    """Both slabs of every leaf bit-equal to the JAX package's, whole and
    in chunks of P down to one leaf a chunk, and for a subset of leaves."""
    if chunk is not None:
        monkeypatch.setattr(tgrow, "_SLAB_CHUNK_ELEMS", chunk)
    a = random_ancestry(seed, L, F, bmax)
    want = jgrow.advanced_constraint_slabs(
        *(jnp.asarray(x) for x in a), bmax, jnp.asarray(BIG, jnp.float32))
    t = [torch.as_tensor(x.astype(np.int64) if x.dtype == np.int32 else x)
         for x in a]
    got = tgrow.advanced_constraint_slabs(*t, bmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    assert (got[0].numpy() > -BIG).any() and (got[1].numpy() < BIG).any()
    rows = torch.as_tensor([L - 1, 0, L // 2])
    sub = tgrow.advanced_constraint_slabs(*t, bmax, rows=rows)
    for g, w in zip(sub, want):
        np.testing.assert_array_equal(_bits(g.numpy()),
                                      _bits(np.asarray(w)[rows.numpy()]))


def test_adv_child_bounds_bit_equal():
    rs = np.random.RandomState(0)
    vmin = np.where(rs.rand(6, 5, 17) < 0.5, -BIG,
                    rs.randn(6, 5, 17)).astype(np.float32)
    vmax = np.where(rs.rand(6, 5, 17) < 0.5, BIG,
                    rs.randn(6, 5, 17)).astype(np.float32)
    got = tsplit.adv_child_bounds(torch.as_tensor(vmin),
                                  torch.as_tensor(vmax))
    want = jsplit.adv_child_bounds(jnp.asarray(vmin), jnp.asarray(vmax),
                                   -jsplit.NEG_INF)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


# ------------------------------------------------------------ split scan

def _slabs(rs, S, F, B):
    """Random per-threshold slabs: unbounded, or dyadic bounds around 0."""
    vmin = np.where(rs.rand(S, F, B) < 0.6, -BIG,
                    -rs.randint(0, 5, (S, F, B)) / 64).astype(np.float32)
    vmax = np.where(rs.rand(S, F, B) < 0.6, BIG,
                    rs.randint(0, 5, (S, F, B)) / 64).astype(np.float32)
    return vmin, vmax


@pytest.mark.parametrize("smooth,extra", [(0.0, False), (2.0, False),
                                          (0.0, True), (1.0, True)])
def test_find_best_splits_advanced_bit_equal(smooth, extra):
    """Each slot's best split under the advanced method's slabs, a sticky
    ``splittable`` mask and, with extra trees, one random threshold a
    (slot, feature): every field and ``feat_ok`` bit-equal to the JAX
    package's scan on dyadic histograms over numeric, bundled and
    categorical features."""
    jds, tds, hist, pg, ph, pc = _case()
    S, _, Bmax, _ = hist.shape
    F = tds.device_data().num_features
    rs = np.random.RandomState(7)
    mono = np.zeros(F, np.int32)
    mono[[0, 2, 6]] = [1, -1, 1]
    vmin, vmax = _slabs(rs, S, F, Bmax)
    ok = rs.rand(S, F) < 0.8
    po = (rs.randn(S) / 16).astype(np.float32)
    cat = tsplit.CatParams(min_data_per_group=5, cat_smooth=1.0)
    base = dict(lambda_l1=0.0, lambda_l2=1.0, min_data_in_leaf=5,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    j = jsplit.find_best_splits(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jds.device_data().layout, **base, monotone=jnp.asarray(mono),
        out_lo=jnp.full(S, -BIG, jnp.float32),
        out_hi=jnp.full(S, BIG, jnp.float32), path_smooth=smooth,
        parent_out=jnp.asarray(po), **cat._asdict(),
        adv_bounds=(jnp.asarray(vmin), jnp.asarray(vmax)),
        splittable=jnp.asarray(ok),
        extra_key=jax.random.PRNGKey(9) if extra else None)
    t = torch.as_tensor
    kw = dict(extra_key=(0, 9), draw_rows=torch.arange(S)) if extra else {}
    got = tsplit.find_best_splits(
        t(hist), t(pg), t(ph), t(pc), tds.device_data().layout, **base,
        cat=cat, monotone=t(mono.astype(np.int64)),
        out_lo=torch.full((S,), -BIG), out_hi=torch.full((S,), BIG),
        path_smooth=smooth, parent_out=t(po),
        adv_bounds=(t(vmin), t(vmax)), splittable=t(ok), **kw)
    for name in tsplit.SplitResult._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (got.gain.numpy() > 0).sum() >= S // 2
    assert not got.feat_ok.numpy().all()


# -------------------------------------------------------------- training

_METHODS = {
    "intermediate": {"monotone_constraints": _MONO,
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": _MONO,
                 "monotone_constraints_method": "advanced"},
    "advanced_all": {"monotone_constraints": _MONO,
                     "monotone_constraints_method": "advanced",
                     "monotone_penalty": 0.5,
                     "interaction_constraints": _GROUPS,
                     "path_smooth": 1.0, "feature_fraction_bynode": 0.5,
                     "extra_trees": True},
}


@functools.lru_cache(maxsize=None)
def _jax_text(case, backend, num_leaves):
    params = {**_BASE, **_METHODS[case], "hist_backend": backend,
              "num_leaves": num_leaves}
    return _trees_text(_train(lgb, params).model_to_string())


@pytest.mark.parametrize("backend", ["stream", "scatter", "pallas"])
@pytest.mark.parametrize("case", ["intermediate", "advanced"])
def test_dyadic_training_matches_jax(case, backend):
    """Two trees of 31 leaves on dyadic custom gradients, one split a round:
    the JAX package's trees (split gains within the jit's rounding bound;
    ``pallas`` against the JAX package's ``scatter``), and the leaves
    whose bounds a split tightened rescanned (some tree differs from the
    basic method's)."""
    params = {**_BASE, **_METHODS[case], "hist_backend": backend}
    tb = _train(lt, params)
    assert tb.engine.grow_params.max_splits_per_round == 1
    text = _trees_text(tb.model_to_string())
    _assert_same_trees(text, _jax_text(
        case, "scatter" if backend == "pallas" else backend, 31))
    basic = _train(lt, {**params, "monotone_constraints_method": "basic"})
    assert text != _trees_text(basic.model_to_string())
    assert min(t.num_leaves for t in tb.engine.models) > 16


def test_all_growth_modes_together_match_jax():
    """The advanced method with ``monotone_penalty``, interaction
    constraints, path smoothing, by-node sampling and extra trees."""
    params = {**_BASE, **_METHODS["advanced_all"], "hist_backend": "stream"}
    tb = _train(lt, params, iters=3)
    jb = _train(lgb, params, iters=3)
    _assert_same_trees(_trees_text(tb.model_to_string()),
                       _trees_text(jb.model_to_string()))
    assert max(t.num_leaves for t in tb.engine.models) > 4


def test_multiclass_grows_one_class_at_a_time():
    """K = 3 under the advanced method: the JAX package's trees, no
    lockstep in either package, and the grower refuses K classes."""
    params = {**_BASE, **_METHODS["advanced"], "objective": "multiclass",
              "num_class": 3, "hist_backend": "scatter",
              "learning_rate": 0.5, "num_leaves": 15}
    data = _mc_data(600, 1)
    tb = _train(lt, params, iters=1, data=data, fobj=_dyadic_mc_fobj)
    jb = _train(lgb, params, iters=1, data=data, fobj=_dyadic_mc_fobj)
    _assert_same_trees(_trees_text(tb.model_to_string()),
                       _trees_text(jb.model_to_string()))
    assert not jb.engine._mc_batched_last
    assert not tb.engine._use_batched_multiclass()
    assert tb.num_trees() == 3
    eng = tb.engine
    with pytest.raises(ValueError, match="one class tree at a time"):
        tgrow._DeviceGrower(eng._bins_T, 3, eng.dd.layout, eng.dd.routing,
                            eng.grow_params._replace(hist_backend="stream"),
                            eng.dd.max_bins, monotone=eng._monotone)


@pytest.mark.parametrize("method,extra", [
    ("intermediate", {}),
    ("advanced", {"bagging_fraction": 0.5, "bagging_freq": 1}),
    ("advanced", {"data_sample_strategy": "goss", "learning_rate": 0.5})],
    ids=["intermediate", "advanced-bagging", "advanced-goss"])
def test_fused_equals_eager(method, extra):
    """One class tree under each method fuses (``fused_iter`` on: the
    device-state grower, a static pair slot a round, every leaf's slabs)
    with the eager text."""
    X, y = _sampled_data(2000, 7)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 5, "verbosity": -1, **_METHODS[method],
         **extra, **CPU}
    texts = []
    for fused in ("off", "on"):
        b = lt.train({**p, "fused_iter": fused},
                     lt.Dataset(X, label=y, params=p), 3)
        texts.append(_trees_text(b.model_to_string()))
        assert b.engine._fused == (fused == "on")
    assert texts[0] == texts[1]
    assert min(t.num_leaves for t in b.engine.models) > 16


@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_real_gradients_hold_the_constraints(method):
    """Binary logloss on real gradients, 10 trees of 31 leaves: predictions
    are non-decreasing (non-increasing) along a 64-point sweep of each +1
    (-1) feature on 200 rows."""
    rs = np.random.RandomState(8)
    n = 3000
    X = rs.randn(n, 6)
    logit = (1.5 * X[:, 0] - X[:, 2] + np.sin(2 * X[:, 1]) * X[:, 3]
             + 0.5 * X[:, 5] * X[:, 4] - 0.8 * X[:, 0] * X[:, 5])
    y = (logit + 0.5 * rs.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "min_data_in_leaf": 10, "verbosity": -1, **_METHODS[method], **CPU}
    b = lt.train(p, lt.Dataset(X, label=y, params=p), 10)
    sweep = np.linspace(-3, 3, 64)
    rows = X[:200]
    moved = 0
    for f, sign in enumerate(_MONO):
        if sign == 0:
            continue
        Xs = np.repeat(rows, 64, axis=0)
        Xs[:, f] = np.tile(sweep, 200)
        pred = b.predict(Xs, raw_score=True).reshape(200, 64)
        steps = np.diff(pred, axis=1) * sign
        assert steps.min() >= -1e-12, (f, steps.min())
        moved += steps.max() > 0
    assert moved >= 2
