"""Leaf refit in the port against the JAX package, on the CPU:
``Booster.refit`` (model_io.refit_model, the host walk) and
``refit.refit_leaf_values`` (K3's route replay, here its plain version).

The same numpy inputs and the same model text go through the JAX package
(its stream kernel's ``route_replay`` in Pallas interpret mode, as
tests/test_pipeline.py runs it) and through the port with
``device_type="cpu"``.

Tolerances and why:

- Regression (L2) models: the gradients are ``score - label`` in float32
  in both packages, bit-equal; the leaves are the same rows (bin-space
  replay and host walk agree row for row); the sums are float64 in row
  order (``np.bincount`` in the port, the JAX package's float64
  ``segment_sum``, which equals it); so every refitted leaf value is
  bit-equal, and so is the model text.
- The stock binary fixture: refitted predictions within the JAX test's
  0.05 relative RMS of stock LightGBM's ``task=refit`` output
  (tests/test_golden.py:257-269); against the JAX package's refit of the
  same model, 1e-6 relative (torch's float32 sigmoid against XLA's).
- ``_replay_schedule``: host integer bookkeeping, equal tree for tree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu import refit as jrefit
from lightgbm_tpu.model_io import refit_model as j_refit_model
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import refit as trefit
from lightgbm_torch.kernels import route_replay as rr
from lightgbm_torch.model_io import refit_model as t_refit_model

from test_golden import FIX, _load_X, _load_train

CPU = {"device_type": "cpu"}
_P = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 5,
      "verbosity": -1, "learning_rate": 0.2}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _data(n, seed, cat=False):
    """NaN (0), zero-heavy (1) and dense columns, a categorical column (5)
    of 12 categories when ``cat``; a continuous label."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    if cat:
        X[:, 5] = rs.randint(0, 12, n)
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0])
         + (np.isin(X[:, 5], [1, 4, 7]) * 1.5 if cat else X[:, 5])
         + 0.3 * rs.randn(n))
    return X, y


def _leaves(trees):
    return [np.asarray(t.leaf_value, np.float64) for t in trees]


def _model(n=1500, seed=3, iters=6, params=None, cat=False, nan_at=None,
           ds_kw=None):
    """A port-trained model's text, its training rows and fresh rows."""
    X, y = _data(2 * n, seed, cat)
    X1, y1, X2, y2 = X[:n], y[:n], X[n:], y[n:]
    kw = {"categorical_feature": [5]} if cat else {}
    p = {**_P, **(params or {}), **CPU}
    ds = lt.Dataset(X1, label=y1, params={**CPU, **(ds_kw or {})}, **kw)
    bst = lt.Booster(p, ds)
    for i in range(iters):
        if i == nan_at:
            # a NaN gradient: the guard grows a single-leaf no-op tree
            bst.update(fobj=lambda s, d: (np.full(len(s), np.nan,
                                                  np.float32),
                                          np.ones(len(s), np.float32)))
        else:
            bst.update()
    return bst.model_to_string(), (X1, y1), (X2, y2), kw


def _refit_both(text, train, fresh, kw, ds_kw=None, weight=None,
                decay=0.9):
    """refit_leaf_values in both packages on the fresh rows (binned with
    the training rows' mappers): (port booster, port report, JAX booster,
    JAX report)."""
    out = []
    for mod, p in ((lt, {**CPU, **(ds_kw or {})}), (lgb, dict(ds_kw or {}))):
        ref = mod.Dataset(train[0], label=train[1], params=p, **kw)
        ds2 = mod.Dataset(fresh[0], label=fresh[1], weight=weight,
                          reference=ref, params=p, **kw)
        bst = mod.Booster(model_str=text)
        mod_refit = trefit if mod is lt else jrefit
        out += [bst, mod_refit.refit_leaf_values(bst, ds2,
                                                 decay_rate=decay)]
    return out


@pytest.mark.parametrize("case", ["numeric", "categorical", "wide_bins",
                                  "trivial_tree", "weighted"])
def test_refit_leaf_values_bit_equal_to_jax_and_host(case):
    """Every refitted leaf value bit-equal to the JAX package's
    ``refit_leaf_values`` (but over 16-bit bins, which it misroutes) and to
    both packages' host ``refit_model``; the
    report's counters: K3 a numeric tree, the walk a categorical one,
    nothing a single-leaf one."""
    kw = {}
    if case == "categorical":
        kw = {"cat": True}
    elif case == "wide_bins":
        kw = {"ds_kw": {"max_bin": 600}}
    elif case == "trivial_tree":
        kw = {"nan_at": 2}
    text, train, fresh, dkw = _model(**kw)
    weight = (np.random.RandomState(4).uniform(0.5, 2.0, len(fresh[1]))
              if case == "weighted" else None)
    tb, trep, jb, jrep = _refit_both(text, train, fresh, dkw,
                                     ds_kw=kw.get("ds_kw"), weight=weight,
                                     decay=0.7)
    assert trep == jrep
    trees = tb._all_trees()
    # the JAX package's device refit misroutes 16-bit bins (its stream
    # replay packs bins as bytes; ROADMAP §3): there both packages' host
    # refits are the oracle
    jax_device_ok = case != "wide_bins"
    n_trivial = sum(t.num_leaves < 2 for t in trees)
    n_cat = sum(t.num_leaves >= 2 and t.num_cat > 0 for t in trees)
    assert trep["trivial"] == n_trivial == (1 if case == "trivial_tree"
                                            else 0)
    assert trep["walk_fallback_passes"] == n_cat
    assert (n_cat > 0) == (case == "categorical")
    assert trep["route_replay_passes"] == len(trees) - n_trivial - n_cat > 0
    if jax_device_ok:
        for a, b in zip(_leaves(trees), _leaves(jb._all_trees())):
            np.testing.assert_array_equal(a, b)
        assert tb.model_to_string() == jb.model_to_string()
    if case == "wide_bins":
        ds = lt.Dataset(fresh[0], label=fresh[1], params={**CPU,
                                                          "max_bin": 600})
        assert ds.construct().binned.bins.dtype == np.uint16
    if weight is None:
        host = t_refit_model(lt.Booster(model_str=text), fresh[0], fresh[1],
                             decay_rate=0.7)
        jhost = j_refit_model(lgb.Booster(model_str=text), fresh[0],
                              fresh[1], decay_rate=0.7)
        for a, b, c in zip(_leaves(trees), _leaves(host._all_trees()),
                           _leaves(jhost._all_trees())):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)


def test_refit_leaf_values_launches_k3_once_a_numeric_tree(monkeypatch):
    """One route_replay call a numeric tree, on records padded to a
    multiple of 8 leaves, every row inside them; the result does not
    depend on how the schedule's rounds are padded."""
    calls = []
    real = rr.route_replay_plain

    def counted(bins_T, tabs):
        out = real(bins_T, tabs)
        calls.append((tuple(tabs.shape), int(out.min())))
        return out

    monkeypatch.setattr(trefit, "route_replay", counted)
    text, train, fresh, kw = _model(iters=4)
    tb, rep, _, _ = _refit_both(text, train, fresh, kw)
    assert len(calls) == rep["route_replay_passes"] == 4
    L = max(t.num_leaves for t in tb._all_trees())
    for (R, L_pad, F), lo in calls:
        assert L_pad == max(8, -(-L // 8) * 8) and F == 16 and lo >= 0


def test_replay_schedule_equals_jax():
    """The replay rounds and the leaf permutation of every tree equal the
    JAX package's, numeric trees and (None) categorical ones."""
    for cat in (False, True):
        text, train, _, kw = _model(cat=cat, iters=4)
        ds = lt.Dataset(train[0], label=train[1], params=CPU, **kw)
        mappers = ds.construct().bin_mappers()
        trees = lt.Booster(model_str=text)._all_trees()
        jtrees = lgb.Booster(model_str=text)._all_trees()
        for t, jt in zip(trees, jtrees):
            got = trefit._replay_schedule(t, mappers)
            want = jrefit._replay_schedule(jt, mappers)
            assert (got is None) == (want is None)
            assert trefit._tree_depth(t) == jrefit._tree_depth(jt)
            if got is not None:
                assert got[0] == want[0]
                np.testing.assert_array_equal(got[1], want[1])


def test_booster_refit_bit_equal_to_jax():
    """``Booster.refit`` on a regression model: a new Booster whose leaves
    equal the JAX package's ``Booster.refit`` bit for bit; the source
    Booster is unchanged; decay 1 keeps every leaf."""
    text, train, fresh, _ = _model()
    tb = lt.Booster(model_str=text)
    jb = lgb.Booster(model_str=text)
    tr = tb.refit(fresh[0], fresh[1], decay_rate=0.8)
    jr = jb.refit(fresh[0], fresh[1], decay_rate=0.8)
    assert tr.model_to_string() == jr.model_to_string()
    before = _leaves(lt.Booster(model_str=text)._all_trees())
    for a, b in zip(_leaves(tb._all_trees()), before):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b)
               for a, b in zip(_leaves(tr._all_trees()), before))
    same = tb.refit(fresh[0], fresh[1], decay_rate=1.0)
    for a, b in zip(_leaves(same._all_trees()), _leaves(tb._all_trees())):
        np.testing.assert_array_equal(a, b)


def test_booster_refit_matches_stock_semantics():
    """The JAX package's stock test, through the port: the stock binary
    model refitted on the perturbed labels tracks stock LightGBM's
    ``task=refit`` predictions within 0.05 relative RMS, and the JAX
    package's refit within 1e-6 relative."""
    Xr, yr = _load_train("refit")
    X = _load_X()
    tb = lt.Booster(model_file=str(FIX / "stock_binary.model"),
                    params={"objective": "binary", "verbosity": -1})
    ours = np.asarray(tb.refit(Xr, yr, decay_rate=0.9).predict(
        X, raw_score=True))
    stock = np.loadtxt(FIX / "stock_pred_binary_refit.txt")
    scale = max(float(np.std(stock)), 1e-6)
    err = float(np.sqrt(np.mean((ours - stock) ** 2))) / scale
    assert err < 0.05, f"relative RMS diff vs stock refit {err:.4f}"
    jb = lgb.Booster(model_file=str(FIX / "stock_binary.model"),
                     params={"objective": "binary", "verbosity": -1})
    jpred = np.asarray(jb.refit(Xr, yr, decay_rate=0.9).predict(
        X, raw_score=True))
    np.testing.assert_allclose(ours, jpred, rtol=1e-6, atol=1e-6)


def test_refit_of_a_training_booster_weighted_analytic():
    """A Booster still holding its engine refits in place with its own
    ``lambda_l2``, as the JAX package's does: a one-tree L2 model on
    weighted fresh rows has the closed form new = sum(w (y - 0)) / (sum(w)
    + l2) * shrinkage, blended by the decay, computed with ``np.bincount``
    alone (reference: tests/test_pipeline.py:78-111).  Unlabelled data is
    refused."""
    X, y = _data(1600, 5)
    X1, y1, X2, y2 = X[:800], y[:800], X[800:], y[800:]
    w2 = np.random.RandomState(3).uniform(0.5, 2.0, size=len(y2))
    p = {**_P, "boost_from_average": False, "lambda_l2": 0.7, **CPU}
    ds = lt.Dataset(X1, label=y1, params=CPU)
    bst = lt.train(p, ds, 1)
    (tree,) = bst._all_trees()
    old = np.asarray(tree.leaf_value, np.float64).copy()
    leaf = tree.predict_leaf_raw(np.asarray(X2, np.float64))
    y32, w32 = np.float32(y2), np.float32(w2)
    g = (np.float32(0.0) - y32) * w32
    h = np.ones_like(y32) * w32
    sum_g = np.bincount(leaf, weights=np.float64(g), minlength=tree.num_leaves)
    sum_h = np.bincount(leaf, weights=np.float64(h), minlength=tree.num_leaves)
    new = -sum_g / (sum_h + 0.7 + 1e-15) * tree.shrinkage
    has = np.bincount(leaf, minlength=tree.num_leaves) > 0
    want = np.where(has, 0.6 * old + 0.4 * new, old)
    ds2 = lt.Dataset(X2, label=y2, weight=w2, reference=ds, params=CPU)
    rep = trefit.refit_leaf_values(bst, ds2, decay_rate=0.6)
    assert rep["route_replay_passes"] == 1
    np.testing.assert_array_equal(bst._all_trees()[0].leaf_value, want)
    with pytest.raises(lt.LightGBMError, match="labeled"):
        trefit.refit_leaf_values(
            bst, lt.Dataset(X2, reference=ds, params=CPU))
