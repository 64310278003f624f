"""Quantized-gradient training of the port against the JAX package, on the
CPU.

The same numpy inputs go through the JAX package (Pallas kernels in
interpret mode) and through the port with ``device_type="cpu"``, where K2's
int form (``route_and_hist_int``) runs its plain version
(``ops/histogram.build_histograms_int``).

Tolerances and why:

- The random draws (``split``, ``uniform`` over (N,) and (N, K)) and the
  quantizer are the same float32 operations on the same bits: bit-equal.
- K2's int form sums integers: its leaf ids, counts and int32 histograms
  equal the JAX kernel's ``int_weights=True`` branch bit for bit, on any
  integer weights, compacted rows included.
- Training on dyadic custom gradients whose largest |g| and h make each
  quantization scale a power of two: every grid value and every sum is
  exact in float32, so the model text is byte-identical to the JAX
  package's under stream (the int path), scatter and pallas, with GOSS,
  bagging and renewed leaves.
- Real binary gradients: the int histograms are the same; the root totals
  are float32 sums of non-dyadic grid values, added by XLA in its order and
  by the port in float64, so they may differ in the last place.  Held to
  the same first tree and raw scores within atol 1e-4.
- Renewed leaves on real gradients: the reference adds raw gradients in
  float32 ``segment_sum``, the port exactly: raw scores within atol 1e-4.
- An odd level count runs the float path in both packages; the JAX stream
  kernel rounds its weights to bf16 (``hist_precision="single"``), so the
  port is held to the JAX ``scatter`` backend (float32 sums of the grid
  values) within atol 1e-4, and its own stream and scatter backends to each
  other byte for byte (both exact fixed point).
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.models.gbdt import quantize_gh as j_quantize_gh
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import kernels as tk
from lightgbm_torch.kernels import route_hist as trh
from lightgbm_torch.models.gbdt import quantize_gh as t_quantize_gh
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops.compact import plan_sample_rows
from lightgbm_torch.utils import random as trand

from test_torch_multiclass import K, _k2k_case
from test_torch_train import _k2_case, _k2_inputs

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _key_words(key):
    return tuple(int(x) for x in np.asarray(key))


# ------------------------------------------------------------ random draws

@pytest.mark.parametrize("seed", [0, 1, 7, 12 * 131071 + 3, 65537,
                                  123456789, 2 ** 31 - 1, 4000000007])
def test_split_and_uniform_equal_jax_random(seed):
    """``split`` equals ``jax.random.split`` under the partitionable
    Threefry, and ``uniform`` over (N,) and (N, K) equals
    ``jax.random.uniform`` under each new key."""
    assert jax.config.jax_threefry_partitionable
    jseed = seed if seed < 2 ** 31 else seed - 2 ** 32
    jkeys = jax.random.split(jax.random.PRNGKey(jseed))
    tkeys = trand.split(trand.prng_key(seed))
    assert [_key_words(k) for k in jkeys] == tkeys
    for jk, tkey in zip(jkeys, tkeys):
        for shape in ((1003,), (517, 3)):
            want = np.asarray(jax.random.uniform(jk, shape))
            got = trand.uniform(tkey, shape).numpy()
            assert got.shape == shape
            np.testing.assert_array_equal(got, want)
    assert len(trand.split(trand.prng_key(seed), 5)) == 5
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(jax.random.PRNGKey(jseed), 5)),
        np.asarray(trand.split(trand.prng_key(seed), 5), np.uint32))


# ---------------------------------------------------------------- quantizer

@pytest.mark.parametrize("shape", [(3000,), (1200, 3)])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bins", [4, 16, 5, 254])
def test_quantize_gh_equals_jax(shape, stochastic, bins):
    """Grid values and scales bit-equal to the JAX package's quantize_gh,
    real gradients, a zero row and a zero class column included."""
    rs = np.random.RandomState(bins + len(shape))
    g = (rs.randn(*shape) * 3).astype(np.float32)
    h = np.abs(rs.randn(*shape)).astype(np.float32)
    g[5] = h[5] = 0.0
    if len(shape) == 2:
        g[:, 1] *= 1e-3
        h[:, 2] = 0.0
    seed = 12 * 131071 + 4
    jq = j_quantize_gh(jnp.asarray(g), jnp.asarray(h),
                       jax.random.PRNGKey(seed), bins, stochastic)
    tq = t_quantize_gh(torch.as_tensor(g), torch.as_tensor(h),
                       trand.prng_key(seed), bins, stochastic)
    for want, got in zip(jq, tq):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq[2].shape == ((2,) if len(shape) == 1 else (2, shape[1]))


@pytest.mark.parametrize("bins", [2, 4, 16, 64, 254])
def test_integer_grid_values_round_trip(bins):
    """The grower hands K2's int form ``round(q * scale * (1 / scale))``:
    that is q for every reachable level q at any scale."""
    half = bins / 2
    rs = np.random.RandomState(bins)
    q = torch.arange(-half, half + 1, dtype=torch.float32)
    for m in np.concatenate([rs.rand(200) * 10 ** rs.uniform(-6, 6, 200),
                             [1e-10, 1.0, 3.0, 1e30]]).astype(np.float32):
        scale = torch.clamp(torch.tensor(m), min=1e-10) / half
        inv = 1.0 / torch.clamp(scale, min=1e-30)
        back = torch.round((q * scale) * inv).to(torch.int8)
        assert torch.equal(back, q.to(torch.int8)), (bins, m)


# ------------------------------------------------------------ K2's int form

def _int_weights(rs, K, N, cnt, half=8):
    qg = rs.randint(-half, half + 1, (K, N)).astype(np.float32)
    qh = rs.randint(0, half + 1, (K, N)).astype(np.float32)
    return qg * cnt, qh * cnt


def _jax_int_k2(jdd_bins, c, qg, qh, K_, with_hist=True):
    """The JAX stream kernel's int_weights branch over (N, G) bins."""
    L, S, N, Bmax = c["L"], c["S"], jdd_bins.shape[0], c["Bmax"]
    slay = jsk.pack_bins_T(jdd_bins)
    n_pad = slay.n_pad
    w_T = jnp.zeros((8, n_pad), jnp.float32)
    for k in range(K_):
        w_T = w_T.at[2 * k, :N].set(qg[k]).at[2 * k + 1, :N].set(qh[k])
    w_T = w_T.at[2 * K_, :N].set(c["cnt_h"])
    i32 = jnp.int32
    flat = {key: jnp.asarray(np.asarray(c[key]).reshape(-1))
            for key in ("chosen", "feat", "thr", "dirf", "new", "sl", "sr")}
    tabs = jsk.build_route_tables(
        flat["chosen"], flat["feat"], flat["thr"], flat["dirf"],
        flat["new"], (flat["sl"] + 1).astype(i32),
        (flat["sr"] + 1).astype(i32), jnp.zeros(K_ * L, i32), c["routing"],
        K_ * L)
    Bpad = -(-Bmax // 8) * 8
    bits_T = jnp.pad(jnp.asarray(np.asarray(c["bits"]).reshape(K_ * L, Bmax))
                     .astype(jnp.bfloat16), ((0, 0), (0, Bpad - Bmax))).T
    leaf = jnp.pad(jnp.asarray(c["leaf_h"].reshape(K_, N)),
                   ((0, 0), (0, n_pad - N)))
    new_leaf, hist, cnt = jsk.route_and_hist(
        slay.bins_T, leaf, w_T, tabs, bits_T, S, Bmax, c["G"], L,
        has_cat=True, two_pass=False, int_weights=True, with_hist=with_hist,
        num_class=K_)
    hist = np.asarray(hist)
    cnt = np.asarray(cnt)
    if K_ == 1:
        hist, cnt = hist[None], cnt[None]
    return np.asarray(new_leaf[:, :N]), hist, cnt


def _k2_int_case(K_, compact):
    """One round's tables over K_ classes (test_torch_train's and
    test_torch_multiclass's cases), integer weights, and optionally the
    compacted view of the in-bag rows (a third of the rows out of bag)."""
    if K_ == 1:
        _, jds, tds = _k2_case()
        c = _k2_inputs(jds, tds, np.random.RandomState(3), dyadic=True)
        t_tabs, t_words = c["t_tabs"][None], c["t_words"][None]
        c["leaf_id"] = c["leaf_id"][None]
    else:
        jds, tds, c = _k2k_case(dyadic=True)
        t_tabs, t_words = c["t_tabs"], c["t_words"]
    N = c["N"]
    rs = np.random.RandomState(10 + K_)
    cnt = (rs.rand(N) > (0.33 if compact else 0.1)).astype(np.float32)
    qg, qh = _int_weights(rs, K_, N, cnt)
    bins = np.asarray(jds.device_data().bins[:N])
    t_bins_T = tds.device_data().bins[:N].t().contiguous()
    rows = np.arange(N)
    if compact:
        cap = int(cnt.sum()) + 37
        rows = plan_sample_rows(torch.as_tensor(cnt), cap).perm.numpy()
    c.update(routing=jds.device_data().routing, cnt_h=cnt[rows],
             leaf_h=c["leaf_id"][:, rows])
    return (c, bins[rows], t_bins_T[:, rows].contiguous(), t_tabs, t_words,
            qg[:, rows], qh[:, rows])


@pytest.mark.parametrize("K_,compact", [(1, False), (1, True), (K, False)])
@pytest.mark.parametrize("with_hist", [True, False])
def test_k2_int_form_plain_equals_jax_int_branch(K_, compact, with_hist):
    """Leaf ids, counts and int32 histograms of the plain int form equal
    the JAX stream kernel's ``int_weights=True`` branch bit for bit, at
    K = 1 and K = 3 and over compacted rows; the route-only form takes no
    weights and returns the float form's leaf ids and counts."""
    c, bins, t_bins_T, t_tabs, t_words, qg, qh = _k2_int_case(K_, compact)
    j_leaf, j_hist, j_cnt = _jax_int_k2(bins, c, qg, qh, K_, with_hist)
    t = torch.as_tensor
    args = (t_bins_T, t(c["leaf_h"]), t_tabs, t_words)
    if with_hist:
        w = (t(qg).to(torch.int8), t(qh).to(torch.int8))
    else:
        w = (None, None)
    leaf, hist, cnt = trh.route_and_hist_int(*args, *w, t(c["cnt_h"]),
                                             c["S"], c["Bmax"], with_hist)
    np.testing.assert_array_equal(leaf.numpy(), j_leaf)
    np.testing.assert_array_equal(cnt.numpy(), j_cnt)
    assert (leaf.numpy() != c["leaf_h"]).any()
    if with_hist:
        assert hist.dtype == torch.int32
        assert hist.shape == (K_, c["S"], c["G"], c["Bmax"], 2)
        np.testing.assert_array_equal(hist.numpy(), j_hist)
        assert (hist.numpy() < 0).any() and hist.numpy()[..., 1].min() >= 0
    else:
        assert hist is None
        f_leaf, _, f_cnt = trh.route_and_hist(
            *args, t(qg), t(qh), t(c["cnt_h"]), c["S"], c["Bmax"],
            (0,) * K_, False)
        assert torch.equal(leaf, f_leaf) and torch.equal(cnt, f_cnt)


def test_k2_int_wrapper_refuses_cpu_tensors_and_other_devices():
    c, _, t_bins_T, t_tabs, t_words, qg, qh = _k2_int_case(1, False)
    t = torch.as_tensor
    with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
        trh.route_and_hist_int_cuda(
            t_bins_T, t(c["leaf_h"]), t_tabs, t_words,
            t(qg).to(torch.int8), t(qh).to(torch.int8), t(c["cnt_h"]),
            c["S"], c["Bmax"])
    meta = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        trh.route_and_hist_int(meta, None, None, None, None, None, None, 1,
                               4)
    assert tk.WRAPPERS["route_and_hist_int"] is trh.route_and_hist_int_cuda


# ---------------------------------------------------------------- training

def _data(n, seed=1):
    """NaN (0), zero-heavy (1), dense columns; a binary label."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 0.3 * rs.randn(n)
         > 0).astype(float)
    return X, y


def _mc_data(n, seed=1):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    logits = np.stack([X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]), 2 * X[:, 1],
                       X[:, 5] - X[:, 2]], axis=1)
    y = np.argmax(logits + 0.5 * rs.randn(n, K), axis=1).astype(float)
    return X, y


def _pow2_grid(r):
    """Dyadic gradients whose quantization scales are powers of two: every
    4th row carries |g| = 1 and h = 1 (the largest of each), the others
    |g| <= 1/2 on a 1/64 grid and h = 1/2.  GOSS at top 0.5 / other 0.25
    (sampling from the third iteration at learning rate 0.5) keeps every
    large row and amplifies only small ones, by 2, to at most the same
    largest values."""
    big = (np.arange(len(r)) % 4 == 0).reshape((-1,) + (1,) * (r.ndim - 1))
    g = np.where(big, np.where(r >= 0, 1.0, -1.0),
                 np.clip(np.round(32 * r) / 64, -0.5, 0.5))
    h = np.where(big, 1.0, 0.5) * np.ones_like(r)
    return g.astype(np.float32), h.astype(np.float32)


def _pow2_fobj(score, ds):
    return _pow2_grid(score - ds.get_label())


def _pow2_mc_fobj(score, ds):
    oh = np.eye(score.shape[1])[ds.get_label().astype(np.int64)]
    return _pow2_grid(score - oh)


_GOSS = {"data_sample_strategy": "goss", "top_rate": 0.5, "other_rate": 0.25}
# (classes, rows, leaves, split budget, extra params)
_CASES = {
    "stream": (1, 2000, 31, 8, {}),
    "stream_16_nearest": (1, 2000, 31, 8, {"num_grad_quant_bins": 16,
                                           "stochastic_rounding": False}),
    "scatter": (1, 2000, 31, 8, {"hist_backend": "scatter"}),
    "pallas": (1, 2000, 31, 8, {"hist_backend": "pallas"}),
    "goss": (1, 2000, 31, 8, _GOSS),
    # S = 64: compacted, fused (K3) and the route-only sprint round
    "goss_sprint": (1, 2000, 127, 64, {**_GOSS, "min_data_in_leaf": 2}),
    "bagging": (1, 2000, 31, 8, {"bagging_fraction": 0.5,
                                 "bagging_freq": 1}),
    "renew": (1, 2000, 31, 8, {"quant_train_renew_leaf": True}),
    "mc_stream": (K, 2000, 31, 8, {}),
    "mc_scatter": (K, 2000, 31, 8, {"hist_backend": "scatter"}),
    "mc_renew": (K, 2000, 31, 8, {"quant_train_renew_leaf": True}),
}


def _case_params(case):
    k, _, leaves, splits, extra = _CASES[case]
    p = {"objective": "none" if k == 1 else "multiclass", "num_leaves": leaves,
         "max_splits_per_round": splits, "hist_precision": "single",
         "hist_backend": "stream", "min_data_in_leaf": 5, "max_bin": 63,
         # an exact shrinkage: the reference's jitted multiclass score add
         # may fuse the product into the add, which only an exact product
         # leaves unchanged
         "learning_rate": 0.5, "verbosity": -1, "use_quantized_grad": True,
         **extra}
    if k > 1:
        p["num_class"] = k
    return p


def _trees_text(bst):
    return bst.model_to_string().split("\nparameters:")[0]


def _train_case(pkg, case, iters=3, **extra):
    k, n = _CASES[case][:2]
    X, y = _data(n) if k == 1 else _mc_data(n)
    params = {**_case_params(case), **extra}
    kw = CPU if pkg is lt else {}
    bst = pkg.Booster({**params, **kw}, pkg.Dataset(
        X, label=y, params={"max_bin": 63, **kw}))
    fobj = _pow2_fobj if k == 1 else _pow2_mc_fobj
    for _ in range(iters):
        bst.update(fobj=fobj)
    return bst


@functools.lru_cache(maxsize=None)
def _jax_text(case):
    return _trees_text(_train_case(lgb, case))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_dyadic_quantized_training_byte_identical_to_jax(case, monkeypatch):
    """Model text of 3 iterations on power-of-two-scaled dyadic gradients
    byte-identical to the JAX package's; under stream every K2 launch takes
    the int form, elsewhere none does."""
    calls = {"int": 0, "float": 0}
    orig_int, orig_float = tgrow.route_and_hist_int, tgrow.route_and_hist

    def k2_int(*a):
        calls["int"] += 1
        return orig_int(*a)

    def k2_float(*a):
        calls["float"] += 1
        return orig_float(*a)

    monkeypatch.setattr(tgrow, "route_and_hist_int", k2_int)
    monkeypatch.setattr(tgrow, "route_and_hist", k2_float)
    tb = _train_case(lt, case)
    assert _trees_text(tb) == _jax_text(case)
    stream = tb.engine.grow_params.hist_backend == "stream"
    assert tb.engine.grow_params.int_hist == stream
    assert calls["float"] == 0 and (calls["int"] > 0) == stream
    leaves = [t.num_leaves for t in tb.engine.models]
    assert len(leaves) == 3 * _CASES[case][0] and min(leaves) > 4


def test_lockstep_equals_per_class_under_the_int_path():
    """K class trees in lockstep (one int-form K2 over all classes per
    round) equal one tree per class, on power-of-two dyadic gradients."""
    lock = _train_case(lt, "mc_stream")
    per = _train_case(lt, "mc_stream", multiclass_batched=False)
    assert _trees_text(lock) == _trees_text(per)


def test_hist_packed_width_is_a_no_op_on_one_device():
    """Every packed width trains the same single-device model; the
    reference's checks on the width hold."""
    texts = {_trees_text(_train_case(lt, "stream", iters=2,
                                     hist_packed_width=w))
             for w in (32, 16, 8)}
    assert len(texts) == 1
    X, y = _data(300)
    for extra, msg in (({"hist_packed_width": 16}, "use_quantized_grad"),
                       ({"hist_packed_width": 12}, "not one of 32, 16, 8"),
                       ({"hist_packed_width": 8, "use_quantized_grad": True,
                         "linear_tree": True}, "linear_tree")):
        with pytest.raises(lt.LightGBMError, match=msg):
            lt.train({"objective": "binary", "verbosity": -1, **extra, **CPU},
                     lt.Dataset(X, label=y, params=CPU), 1)


def _real_pair(extra, rounds=8):
    X, y = _data(3000, seed=3)
    p = {"objective": "binary", "num_leaves": 15, "max_splits_per_round": 4,
         "hist_precision": "single", "hist_backend": "stream",
         "min_data_in_leaf": 5, "verbosity": -1, "use_quantized_grad": True,
         **extra}
    jb = lgb.train(p, lgb.Dataset(X, label=y), rounds)
    tb = lt.train({**p, **CPU}, lt.Dataset(X, label=y, params=CPU), rounds)
    return X, jb, tb


def _structure(t):
    return (t.num_leaves, list(t.split_feature), list(t.threshold),
            list(t.decision_type), list(t.left_child), list(t.right_child))


@pytest.mark.parametrize("extra", [{}, {"quant_train_renew_leaf": True}])
def test_real_gradients_close_to_jax(extra):
    """The binary objective's gradients through ``train``: the same first
    tree and raw scores within atol 1e-4 (see the module docstring)."""
    X, jb, tb = _real_pair(extra)
    j_trees, t_trees = jb.engine.models, tb.engine.models
    assert len(j_trees) == len(t_trees) == 8
    assert _structure(t_trees[0]) == _structure(j_trees[0])
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


def test_odd_level_count_runs_the_float_path(monkeypatch):
    """5 levels clip to a non-integer +half grid value: the gate sends
    stream to K2's float form (no int launch); its trees equal the port's
    scatter trees byte for byte and the JAX scatter backend's scores within
    atol 1e-4."""
    calls = []
    monkeypatch.setattr(tgrow, "route_and_hist_int",
                        lambda *a: calls.append(a))
    X, y = _data(2000, seed=4)
    p = {"objective": "binary", "num_leaves": 31, "max_splits_per_round": 8,
         "min_data_in_leaf": 5, "verbosity": -1, "use_quantized_grad": True,
         "num_grad_quant_bins": 5}
    out = {}
    for hb in ("stream", "scatter"):
        out[hb] = lt.train({**p, "hist_backend": hb, **CPU},
                           lt.Dataset(X, label=y, params=CPU), 5)
        assert not out[hb].engine.grow_params.int_hist
    assert not calls
    assert _trees_text(out["stream"]) == _trees_text(out["scatter"])
    jb = lgb.train({**p, "hist_backend": "scatter"}, lgb.Dataset(X, label=y),
                   5)
    np.testing.assert_allclose(out["stream"].predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("bins,backend,rows,want", [
    (4, "stream", 2000, True), (254, "stream", 2000, True),
    (5, "stream", 2000, False), (256, "stream", 2000, False),
    (4, "scatter", 2000, False), (4, "stream", 2 ** 29, True),
    (254, "stream", 2 ** 25, False)])
def test_int_hist_gate(bins, backend, rows, want):
    """The reference's gate (gbdt.py:950-955) over the padded row count:
    stream, at most 254 levels, an even count, and half * N < 2**31."""
    X, y = _data(300)
    bst = lt.Booster({"objective": "binary", "use_quantized_grad": True,
                      "num_grad_quant_bins": bins, "hist_backend": backend,
                      "verbosity": -1, **CPU},
                     lt.Dataset(X, label=y, params=CPU))
    eng = bst.engine
    eng.dd = SimpleNamespace(bins=torch.empty((rows, 0)))
    assert eng._make_grow_params().int_hist is want
