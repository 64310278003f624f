"""Multiclass training under bagging and GOSS: the port against the JAX
package, on the CPU.

The same numpy inputs go through the JAX package and through the port with
``device_type="cpu"``, where the port's kernel wrappers run their plain
PyTorch versions (K2's class-axis form over the compacted rows and over all
rows, K8); the JAX package's Pallas kernels run in interpret mode.

Tolerances and why:

- Masks, scaled (N, K) gradients, the row partition and leaf ids are
  integer, copy or same-order float32 operations: bit-equal.
- Histograms over the compacted rows: exact fixed point in the port; on
  dyadic weights every formulation is exact, so bit-equal to the JAX
  stream kernel.
- Training on dyadic custom gradients (GOSS at top 0.25 / other 0.25,
  whose amplification 3 keeps them on the grid): every sum is exact, so the
  model text is byte-identical to the JAX package's same backend, and the
  port's compaction modes, lockstep and per-class paths and fused and eager
  iterations to each other.
- Real softmax gradients against the JAX package's ``segsum`` (float sums
  in another order): the first iteration's trees identical in structure,
  raw scores within atol 2e-4, test_torch_multiclass.py's tolerance.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models import sample_strategy as jss
from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.kernels.route_hist import route_and_hist
from lightgbm_torch.models import sample_strategy as tss
from lightgbm_torch.ops import compact as tcompact
from lightgbm_torch.ops import grow as tgrow

from test_torch_multiclass import (_MC, _dyadic_mc_fobj, _jax_k2k,
                                   _k2k_case, _mc_data, _shifts)
from test_torch_quantized import _mc_data as _q_mc_data
from test_torch_quantized import _pow2_mc_fobj
from test_torch_train import _structure, _trees_text

CPU = {"device_type": "cpu"}
K = 3


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------------- (N, K) sampling

@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"bagging_fraction": 0.3, "bagging_freq": 3, "bagging_seed": 11},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.2,
     "bagging_freq": 2},
    {"data_sample_strategy": "goss", "learning_rate": 0.5},
    {"data_sample_strategy": "goss", "learning_rate": 0.25,
     "top_rate": 0.25, "other_rate": 0.25, "bagging_seed": 9},
], ids=["fraction", "freq3", "posneg", "goss", "goss_dyadic"])
def test_class_masks_and_scales_match_jax(params):
    """The (N,) mask and the (N, K) scaled gradients of every iteration
    bit-equal to the reference's: bagging broadcasts its mask over the
    classes, GOSS ranks rows by the sum over the classes of |g_k * h_k|
    and scales every class of a kept row alike."""
    rs = np.random.RandomState(4)
    n = 4096
    label = (rs.rand(n) < 0.3).astype(np.float64)
    jcfg, tcfg = JConfig.from_params(params), TConfig.from_params(params)
    j = jss.create_sample_strategy(jcfg, n, None, label)
    t = tss.create_sample_strategy(tcfg, n, label)
    sampled = 0
    for it in range(6):
        g = rs.randn(n, K).astype(np.float32)
        h = (rs.rand(n, K) + 0.1).astype(np.float32)
        g[:40] = 2.0                 # tied magnitudes at the top
        h[:40] = 1.0
        jm, jg, jh = j.sample(it, jnp.asarray(g), jnp.asarray(h))
        tm, tg, th = t.sample(it, torch.as_tensor(g), torch.as_tensor(h))
        assert tm.shape == (n,) and tg.shape == th.shape == (n, K)
        for a, b in ((tm, jm), (tg, jg), (th, jh)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        m, got = tm.numpy(), tg.numpy()
        if m.sum() < n:
            sampled += 1
            # each row's classes scaled by one factor: 1, GOSS's
            # amplification, or 0 out of bag
            amp = np.float32((1.0 - tcfg.top_rate) / tcfg.other_rate)
            one, amped, zero = ((got == g * f).all(axis=1)
                                for f in (1.0, amp, 0.0))
            assert (one | amped | zero).all() and zero[m == 0].all()
    assert sampled >= 2


def test_keyed_goss_draw_is_the_eager_draw():
    """``sample_keyed`` under the key words the fused head reads draws the
    eager iteration's (N, K) sample."""
    params = {"data_sample_strategy": "goss", "learning_rate": 0.5}
    t = tss.create_sample_strategy(TConfig.from_params(params), 2048)
    rs = np.random.RandomState(5)
    g = torch.as_tensor(rs.randn(2048, K).astype(np.float32))
    h = torch.as_tensor((rs.rand(2048, K) + 0.1).astype(np.float32))
    seed = t.key_seed(4)
    words = (torch.tensor(0), torch.tensor(seed & 0xFFFFFFFF))
    for a, b in zip(t.sample(4, g, h), t.sample_keyed(words, g, h)):
        assert torch.equal(a, b)


# ------------------------------------------- K2 over the compacted rows

@pytest.mark.parametrize("with_hist", [True, False])
def test_k2_class_axis_over_compacted_rows_matches_jax(with_hist):
    """One round of K = 3 class trees over the rows of a stable partition
    (the in-bag rows first, a capacity past their count): the port's
    partition equals the JAX package's, its compacted (K, capacity) weights
    are one gather of every class, and the plain K2 class axis over them
    equals the JAX stream kernel with ``num_class=3`` over the same rows,
    histograms bit for bit on dyadic weights; each compacted row's new leaf
    is its leaf in the full pass."""
    jds, tds, c = _k2k_case(dyadic=True, seed=7)
    N = c["N"]
    cnt = c["cnt"]
    cap = int((cnt > 0).sum()) + 37
    plan = tcompact.plan_sample_rows(torch.as_tensor(cnt), cap)
    jplan = jcompact.plan_sample_rows(jnp.asarray(cnt), cap)
    np.testing.assert_array_equal(plan.perm.numpy(), np.asarray(jplan.perm))
    perm = plan.perm.numpy()
    bins_T = tds.device_data().bins[:N].t().contiguous()
    t = torch.as_tensor
    bins_h, g_h, h_h, cnt_h = tcompact.compact_transposed_view(
        bins_T, plan.perm, t(c["grad"]), t(c["hess"]), t(cnt))
    assert g_h.shape == (K, cap)
    np.testing.assert_array_equal(g_h.numpy(), c["grad"][:, perm])
    np.testing.assert_array_equal(h_h.numpy(), c["hess"][:, perm])
    np.testing.assert_array_equal(bins_h.numpy(), bins_T.numpy()[:, perm])
    # the JAX kernel over the same rows, in their compacted order
    jc = dict(c, N=cap, grad=c["grad"][:, perm], hess=c["hess"][:, perm],
              cnt=cnt[perm], leaf_id=c["leaf_id"][:, perm])

    class _Rows:
        def device_data(self):
            dd = jds.device_data()
            return dd._replace(bins=dd.bins[perm])

    j_leaf, j_hist, j_cnt = _jax_k2k(_Rows(), jc, with_hist)
    shifts = _shifts(c["grad"], c["hess"], N)
    leaf, hist, counts = route_and_hist(
        bins_h, t(jc["leaf_id"]), c["t_tabs"], c["t_words"], g_h, h_h,
        cnt_h, c["S"], c["Bmax"], shifts, with_hist)
    np.testing.assert_array_equal(leaf.numpy(), j_leaf)
    np.testing.assert_array_equal(counts.numpy(), j_cnt)
    if with_hist:
        np.testing.assert_array_equal(hist.numpy(), j_hist)
        assert hist.numpy().any(axis=(1, 2, 3, 4)).all()
    full, _, full_cnt = route_and_hist(
        bins_T, t(c["leaf_id"]), c["t_tabs"], c["t_words"], t(c["grad"]),
        t(c["hess"]), t(cnt), c["S"], c["Bmax"], shifts, False)
    np.testing.assert_array_equal(leaf.numpy(), full.numpy()[:, perm])
    np.testing.assert_array_equal(counts.numpy(), full_cnt.numpy())


# ---------------------------------------------------- dyadic training

_BAG = {"bagging_fraction": 0.5, "bagging_freq": 1}
_GOSS = {"data_sample_strategy": "goss", "top_rate": 0.25,
         "other_rate": 0.25}
# (backend, objective, leaves, split budget, extra, rows); the learning
# rate 1.0 leaves GOSS one warmup iteration
_CASES = {
    "bag_stream": ("stream", "multiclass", 31, 8, _BAG, 1000),
    "goss_stream": ("stream", "multiclass", 31, 8, _GOSS, 1000),
    "bag_scatter": ("scatter", "multiclass", 31, 8, _BAG, 1000),
    "goss_scatter": ("scatter", "multiclass", 31, 8, _GOSS, 1000),
    "bag_pallas": ("pallas", "multiclass", 31, 8, _BAG, 1000),
    "goss_pallas": ("pallas", "multiclass", 31, 8, _GOSS, 1000),
    # S = 64: the budget-64 rounds, the frozen sprint over compacted rows
    "goss_sprint": ("stream", "multiclass", 127, 64,
                    {**_GOSS, "min_data_in_leaf": 2}, 1500),
    "bag_ova": ("stream", "multiclassova", 31, 8,
                {**_BAG, "feature_fraction": 0.75}, 1000),
}


def _params(case, **extra):
    hb, obj, nl, sp, ex, _ = _CASES[case]
    return {**_MC, "objective": obj, "hist_backend": hb, "max_bin": 63,
            "num_leaves": nl, "max_splits_per_round": sp,
            "learning_rate": 1.0, **ex, **extra}


def _train(pkg, case, iters=3, **extra):
    params = _params(case, **extra)
    X, y = _mc_data(_CASES[case][-1], 2)
    kw = CPU if pkg is lt else {}
    bst = pkg.Booster({**params, **kw}, pkg.Dataset(
        X, label=y, params={"max_bin": 63, **kw}))
    for _ in range(iters):
        bst.update(fobj=_dyadic_mc_fobj)
    return bst


@functools.lru_cache(maxsize=None)
def _jax_text(case):
    jb = _train(lgb, case)
    assert jb.engine._mc_batched_last
    return (_trees_text(jb.model_to_string()), jb.engine._last_compact_rows)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sampled_dyadic_training_byte_identical_to_jax(case):
    """Three iterations (3K trees, two of them sampled) on dyadic custom
    gradients: model text byte-identical to the JAX package's lockstep
    ``grow_tree_k`` under the same backend; the port compacts under
    ``stream`` and ``scatter`` and not under ``pallas`` (the reference's
    compaction quantum is its kernel block, so at ~1 000 rows it may stay
    dense where the port compacts; its pallas never compacts)."""
    tb = _train(lt, case)
    want, j_cap = _jax_text(case)
    assert _trees_text(tb.model_to_string()) == want
    compacts = _CASES[case][0] != "pallas"
    assert (tb.engine.last_compact_rows > 0) == compacts
    assert compacts or j_cap == 0
    nl = [t.num_leaves for t in tb.engine.models]
    assert len(nl) == 3 * K and min(nl) > 4


@pytest.mark.parametrize("case", ["bag_stream", "goss_scatter",
                                  "goss_sprint"])
def test_compaction_lockstep_and_fusion_modes_byte_identical(case):
    """In the port, compaction auto / pad / off, the lockstep and the
    per-class paths and, under stream, the fused iteration (``fused_iter``
    on: the device-state grower) grow byte-identical text."""
    ref = _trees_text(_train(lt, case).model_to_string())
    variants = [dict(row_compaction="pad"), dict(row_compaction="off"),
                dict(multiclass_batched=False)]
    if _CASES[case][0] == "stream":
        variants += [dict(fused_iter="on"),
                     dict(fused_iter="on", row_compaction="off")]
    for extra in variants:
        tb = _train(lt, case, **extra)
        assert _trees_text(tb.model_to_string()) == ref, extra
        if extra.get("fused_iter") == "on":
            assert tb.engine._fused
            assert (tb.engine.last_compact_rows > 0) == (
                "row_compaction" not in extra)


def test_fused_iteration_grows_every_class_on_the_compacted_rows(monkeypatch):
    """A fused sampled K = 3 iteration: every K2 launch with histograms
    reads the (K, capacity) compacted rows and each round adds one
    class-axis route-only pass over all rows; no K3 replay."""
    seen = {"compact": 0, "full_route": 0, "replay": 0}
    orig = tgrow.route_and_hist

    def k2(bins_T, leaf_id, tabs, words, grad, hess, cnt, slots, bmax,
           shifts, with_hist=True, scales=None):
        assert leaf_id.shape[0] == K
        if bins_T.shape[1] < 1536 - 256:
            seen["compact"] += 1
        elif not with_hist:
            # (the warmup iteration's passes read all rows too)
            seen["full_route"] += 1
        return orig(bins_T, leaf_id, tabs, words, grad, hess, cnt, slots,
                    bmax, shifts, with_hist, scales)

    def replay(*a):
        seen["replay"] += 1
        raise AssertionError("no replay for K class trees")

    monkeypatch.setattr(tgrow, "route_and_hist", k2)
    monkeypatch.setattr(tgrow, "route_replay", replay)
    tb = _train(lt, "goss_sprint", fused_iter="on")
    assert tb.engine._fused and tb.engine.last_compact_rows > 0
    assert seen["compact"] > 0 and seen["full_route"] > 0
    assert tb.engine.route_only_passes_per_tree() > 1


# --------------------------------------------------------- quantized

def _q_train(pkg, **extra):
    params = {"objective": "multiclass", "num_class": K, "num_leaves": 31,
              "max_splits_per_round": 8, "hist_precision": "single",
              "hist_backend": "stream", "min_data_in_leaf": 5,
              "max_bin": 63, "learning_rate": 0.5, "verbosity": -1,
              "use_quantized_grad": True, **_BAG, **extra}
    X, y = _q_mc_data(1200)
    kw = CPU if pkg is lt else {}
    bst = pkg.Booster({**params, **kw}, pkg.Dataset(
        X, label=y, params={"max_bin": 63, **kw}))
    for _ in range(3):
        bst.update(fobj=_pow2_mc_fobj)
    return bst


@pytest.mark.parametrize("backend", ["stream", "scatter"])
def test_quantized_bagged_training_byte_identical_to_jax(backend,
                                                         monkeypatch):
    """Quantized K = 3 bagged training on power-of-two-scaled dyadic
    gradients: byte-identical to the JAX package; under stream every K2
    launch (compacted and route-only) takes the int form's class axis."""
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
    tb = _q_train(lt, hist_backend=backend)
    jb = _q_train(lgb, hist_backend=backend)
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    assert tb.engine.last_compact_rows > 0
    assert calls["float"] == 0
    assert (calls["int"] > 0) == (backend == "stream")


# ---------------------------------------------------- real gradients

def test_real_gradients_close_to_jax_segsum():
    """Real softmax gradients under bagging and GOSS: the first
    iteration's K trees equal the JAX package's (segsum, float32) in
    structure and raw scores agree within atol 2e-4."""
    X, y = _mc_data(3000, 6)
    for extra in (_BAG, {**_GOSS, "learning_rate": 0.5}):
        # the device defaults pinned: the JAX package's CPU defaults differ
        p = {**_MC, "num_leaves": 15, "max_bin": 63,
             "max_splits_per_round": 8, **extra}
        jb = lgb.train({**p, "hist_backend": "segsum"},
                       lgb.Dataset(X, label=y, params={"max_bin": 63}), 3)
        tb = lt.train({**p, **CPU}, lt.Dataset(
            X, label=y, params={"max_bin": 63, **CPU}), 3)
        assert [_structure(t) for t in tb.engine.models[:K]] == \
            [_structure(t) for t in jb.engine.models[:K]]
        np.testing.assert_allclose(tb.predict(X, raw_score=True),
                                   jb.predict(X, raw_score=True),
                                   rtol=0, atol=2e-4)
        assert tb.engine.last_compact_rows > 0
