"""Sampled training of the port against the JAX package, on the CPU.

The same numpy inputs go through the JAX package and through the port with
``device_type="cpu"``, where the port's kernel wrappers run their plain
PyTorch versions; the JAX stream kernels run in Pallas interpret mode, as
tests/test_torch_train.py runs them.

Tolerances and why:

- Uniform draws, bagging and GOSS masks, the scaled gradients, feature
  masks, the row partition and route replays are integer, copy or
  same-order float32 operations: bit-equal.
- Training on dyadic custom gradients (GOSS at rates whose amplification
  2 keeps them dyadic): every sum is exact, so model text is byte-identical
  to the JAX package's ``hist_backend="stream"``, with route fusion on and
  off; in the port row compaction auto, pad and off are byte-identical to
  each other, since its histograms are exact fixed point.
- Real binary gradients (float sums in other orders, an ulp apart in the
  sigmoid): the first tree identical in structure and raw scores within
  atol 2e-4, the tolerance of test_torch_train.py's golden test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models import sample_strategy as jss
from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.kernels import layout as tl
from lightgbm_torch.kernels.route_hist import route_and_hist_plain
from lightgbm_torch.kernels.route_replay import (route_replay,
                                                 route_replay_plain)
from lightgbm_torch.models import sample_strategy as tss
from lightgbm_torch.ops import compact as tcompact
from lightgbm_torch.ops.grow import GrowParams, grow_tree
from lightgbm_torch.utils import random as trandom

from test_golden import _COMMON, _load_X, _load_train
from test_torch_train import _datasets, _dyadic_fobj, _mixed, _structure, \
    _trees_text

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ----------------------------------------------------------- uniform draws

_SEEDS = [0, 3 * 131071, 3 * 131071 + 7, 3 * 524287 + 12, 2 ** 31 + 5]


@pytest.mark.parametrize("n", [1, 255, 256, 4097, 200_000])
@pytest.mark.parametrize("seed", _SEEDS)
def test_uniform_matches_jax(seed, n):
    """utils.random.uniform equals jax.random.uniform bit for bit, under
    the bagging key (seed * 131071 + epoch) and the GOSS key (seed * 524287
    + iteration) among others."""
    want = jax.random.uniform(jax.random.PRNGKey(seed), (n,))
    got = trandom.uniform(trandom.prng_key(seed), n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# -------------------------------------------------------- strategy outputs

def _strategies(params, n, label=None):
    jcfg, tcfg = JConfig.from_params(params), TConfig.from_params(params)
    j = jss.create_sample_strategy(jcfg, n, None, label)
    t = tss.create_sample_strategy(tcfg, n, label)
    return j, t


def _gradients(rs, n):
    g = rs.randn(n).astype(np.float32)
    h = (rs.rand(n) + 0.1).astype(np.float32)
    # a run of tied magnitudes at the top, as dyadic gradients give
    g[:50] = 3.0
    h[:50] = 1.0
    return g, h


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"bagging_fraction": 0.3, "bagging_freq": 3, "bagging_seed": 11},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.2,
     "bagging_freq": 2},
], ids=["fraction", "freq3", "posneg"])
def test_bagging_masks_match_jax(params):
    """Masks and masked gradients of every iteration bit-equal to the
    reference's, the epoch cache and mask_key included."""
    rs = np.random.RandomState(1)
    n = 4096
    label = (rs.rand(n) < 0.3).astype(np.float64)
    j, t = _strategies(params, n, label)
    assert t.is_active() and j.is_active()
    for it in range(7):
        g, h = _gradients(rs, n)
        jm, jg, jh = j.sample(it, jnp.asarray(g), jnp.asarray(h))
        tm, tg, th = t.sample(it, torch.as_tensor(g), torch.as_tensor(h))
        assert t.mask_key(it) == j.mask_key(it)
        for a, b in ((tm, jm), (tg, jg), (th, jh)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        assert 0 < float(tm.sum()) < n


@pytest.mark.parametrize("params", [
    {"learning_rate": 0.5},
    {"learning_rate": 0.1, "top_rate": 0.5, "other_rate": 0.25},
    {"learning_rate": 0.25, "top_rate": 0.05, "other_rate": 0.3,
     "bagging_seed": 9},
], ids=["default_rates", "dyadic_rates", "small_top"])
def test_goss_matches_jax(params):
    """GOSS mask and amplified gradients bit-equal to the reference's,
    through the warmup (1 / learning_rate iterations) and after it."""
    params = {"data_sample_strategy": "goss", **params}
    rs = np.random.RandomState(2)
    n = 4096
    j, t = _strategies(params, n)
    warmup = int(np.ceil(1.0 / params["learning_rate"]))
    for it in range(warmup + 3):
        g, h = _gradients(rs, n)
        jm, jg, jh = j.sample(it, jnp.asarray(g), jnp.asarray(h))
        tm, tg, th = t.sample(it, torch.as_tensor(g), torch.as_tensor(h))
        assert t.mask_key(it) == j.mask_key(it)
        for a, b in ((tm, jm), (tg, jg), (th, jh)):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        if it < warmup:
            assert float(tm.sum()) == n
        else:
            assert float(tm.sum()) < n and not torch.equal(tg, torch.as_tensor(g))


def test_feature_mask_sequence_matches_jax():
    X, y = _mixed(600, 3)
    params = {"objective": "regression", "feature_fraction": 0.6,
              "feature_fraction_seed": 7, "verbosity": -1}
    jb = lgb.Booster(params, lgb.Dataset(X, label=y))
    tb = lt.Booster({**params, **CPU}, lt.Dataset(X, label=y, params=CPU))
    for _ in range(6):
        want = np.asarray(jb.engine._feature_mask())
        got = tb.engine._feature_mask().numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(got)


# --------------------------------------------------------------- partition

@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_plan_sample_rows_matches_jax(frac):
    rs = np.random.RandomState(4)
    n = 3000
    mask = (rs.rand(n) < frac).astype(np.float32) * rs.randint(1, 3, n)
    nc = int((mask > 0).sum())
    for cap in sorted({max(nc, 1), 1536, n}):
        if cap < nc:
            continue
        jp = jcompact.plan_sample_rows(jnp.asarray(mask), cap)
        tp = tcompact.plan_sample_rows(torch.as_tensor(mask), cap)
        np.testing.assert_array_equal(tp.perm.numpy(), np.asarray(jp.perm))
        assert int(tp.nc) == int(jp.nc) == nc
    bins_T = torch.as_tensor(rs.randint(0, 60, (4, n)).astype(np.uint8))
    w = torch.as_tensor(rs.randn(n).astype(np.float32))
    perm = tcompact.plan_sample_rows(torch.as_tensor(mask), n).perm
    b_h, w_h = tcompact.compact_transposed_view(bins_T, perm, w)
    assert b_h.is_contiguous()
    np.testing.assert_array_equal(b_h.numpy(), bins_T.numpy()[:, perm])
    np.testing.assert_array_equal(w_h.numpy(), w.numpy()[perm])


# ------------------------------------------------------------- K3 (replay)

def _grown_rounds(tds, rs, rounds, L):
    """R rounds of splits as a grower makes them (each splits some of the
    current leaves into new ids), as per-leaf arrays for both packages'
    tables; numeric features, random thresholds and default directions."""
    F = tds.num_feature()
    nbins = np.asarray([m.num_bins for m in tds.bin_mappers()])
    cur, out = 1, []
    for _ in range(rounds):
        chosen = np.zeros(L, np.int32)
        split = [leaf for leaf in range(cur) if rs.rand() < 0.7][:L - cur]
        chosen[split] = 1
        new = np.zeros(L, np.int32)
        new[split] = cur + np.arange(len(split))
        cur += len(split)
        feat = rs.randint(0, F, L).astype(np.int32)
        thr = (rs.rand(L) * (nbins[feat] - 1)).astype(np.int32)
        dirf = rs.randint(0, 2, L).astype(np.int32)
        out.append((chosen, feat, thr, dirf, new))
    return out, cur


@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_k3_plain_matches_jax_route_replay(zero_as_missing):
    """K3's plain version equals the JAX package's route_replay on the same
    rounds (tables built from the same per-leaf arrays), and the chain of
    route-only K2 passes the unfused path runs; NaN, zero-as-missing and
    EFB-bundled splits included."""
    X, y = _mixed(2500, 17)
    jds, tds = _datasets(X, y, {"max_bin": 31, "verbosity": -1,
                                "zero_as_missing": zero_as_missing})
    assert any(len(g) > 1 for g in tds.binned.group_features)
    rs = np.random.RandomState(5)
    L, R = 64, 6
    rounds, n_leaves = _grown_rounds(tds, rs, R, L)
    assert n_leaves > 20
    jdd, tdd = jds.device_data(), tds.device_data()
    N = X.shape[0]
    slay = jsk.pack_bins_T(jdd.bins)
    z = jnp.zeros(L, jnp.int32)
    j_bufs, t_tabs = [], []
    for chosen, feat, thr, dirf, new in rounds:
        j_bufs.append(jsk.build_route_tables(
            jnp.asarray(chosen), jnp.asarray(feat), jnp.asarray(thr),
            jnp.asarray(dirf), jnp.asarray(new), z, z, z, jdd.routing, L))
        t = torch.as_tensor
        keep = torch.full((L,), -1, dtype=torch.int32)
        t_tabs.append(tl.build_route_tables(
            t(chosen), t(new), t(feat), t(thr), t(dirf), keep, keep, keep,
            tdd.routing))
    R_buf = R + 3          # unused buffer rounds are never executed
    buf = jnp.concatenate(j_bufs + [jnp.zeros((3 * jsk.NUM_TAB, L),
                                              jnp.float32)])
    want = np.asarray(jsk.route_replay(slay.bins_T, buf,
                                       jnp.asarray(R, jnp.int32), L,
                                       rounds_buf=R_buf))[:N]
    bins_T = tdd.bins[:N].t().contiguous()
    tabs = torch.stack(t_tabs)
    got = route_replay(bins_T, tabs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(route_replay_plain(bins_T, tabs).numpy(),
                                  want)
    lid = torch.zeros((1, N), dtype=torch.int32)
    zeros = torch.zeros((1, N))
    words = torch.zeros((1, L, 1), dtype=torch.int32)
    for r in range(R):
        lid, _, _ = route_and_hist_plain(bins_T, lid, tabs[r][None], words,
                                         zeros, zeros, zeros[0], L, 32, (0,),
                                         False)
    np.testing.assert_array_equal(got.numpy(), lid[0].numpy())
    assert len(np.unique(want)) > 15


def test_route_replay_refuses_other_devices():
    meta = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        route_replay(meta, None)


# ------------------------------------------------- the compacted grower

@pytest.mark.parametrize("fusion", [True, False])
def test_compacted_grower_leaf_ids_equal_full_rows(fusion, monkeypatch):
    """A sampled tree grown on the compacted view (fused: one replay;
    unfused: a route-only pass per round) equals the tree grown on all
    rows with the mask alone, arrays and every row's leaf; the in-bag rows'
    leaves are those of the compacted K2 passes (full[perm[:nc]] ==
    compacted[:nc])."""
    from lightgbm_torch.ops import grow as tgrow
    compacted = []

    def k2(bins_T, *args):
        out = route_and_hist_plain(bins_T, *args)
        compacted.append((bins_T.shape[1], out[0][0]))
        return out

    monkeypatch.setattr(tgrow, "route_and_hist", k2)
    X, y = _mixed(3000, 8)
    ds = lt.Dataset(X, label=y, params={"max_bin": 31, **CPU}).construct()
    dd = ds.device_data()
    rs = np.random.RandomState(6)
    n = dd.bins.shape[0]
    mask = torch.as_tensor((rs.rand(n) < 0.4) & (np.arange(n) < 3000),
                           dtype=torch.float32)
    grad = torch.as_tensor(rs.randn(n).astype(np.float32)) * mask
    hess = torch.ones(n) * mask
    params = GrowParams(num_leaves=127, max_depth=-1, max_splits_per_round=64,
                        lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=3,
                        min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                        max_delta_step=0.0, route_fusion=fusion)
    bins_T = dd.bins.t().contiguous()
    args = (bins_T, grad, hess, mask, dd.layout, dd.routing, params,
            dd.max_bins)
    full = grow_tree(*args)
    nc = int(mask.sum())
    cap = -(-nc // 256) * 256
    packed = grow_tree(*args, compact_rows=cap)
    assert packed.arrays.num_leaves == full.arrays.num_leaves > 60
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "leaf_value", "leaf_count"):
        assert torch.equal(getattr(packed.arrays, name),
                           getattr(full.arrays, name)), name
    assert torch.equal(packed.leaf_id, full.leaf_id)
    perm = tcompact.plan_sample_rows(mask, cap).perm
    last_compacted = [lid for rows, lid in compacted if rows == cap][-1]
    assert torch.equal(full.leaf_id[perm[:nc]], last_compacted[:nc])
    assert packed.rounds == full.rounds >= 5


# ----------------------------------------- whole sampled training vs JAX

_SAMPLED = {
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.5,
             "top_rate": 0.5, "other_rate": 0.25},
    "bagging": {"bagging_fraction": 0.5, "bagging_freq": 1},
    "posneg": {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.3,
               "bagging_freq": 2},
    "feature_fraction": {"feature_fraction": 0.6, "bagging_fraction": 0.7,
                         "bagging_freq": 1},
}


def _sampled_data(n=3000, seed=5):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 0.3 * rs.randn(n)
         > 0).astype(float)
    return X, y


_DYADIC_BASE = {"objective": "none", "num_leaves": 127,
                "max_splits_per_round": 64, "hist_precision": "single",
                "min_data_in_leaf": 5, "verbosity": -1}


@pytest.mark.parametrize("fusion", ["on", "off"])
@pytest.mark.parametrize("kind", sorted(_SAMPLED))
def test_sampled_dyadic_training_byte_identical_to_jax_stream(kind, fusion):
    """Three iterations on dyadic custom gradients: model text byte for
    byte the JAX package's stream backend's, compaction engaged in both
    (GOSS: two warmup iterations, then a sampled one)."""
    X, y = _sampled_data()
    p = {**_DYADIC_BASE, **_SAMPLED[kind], "route_fusion": fusion}
    jb = lgb.Booster({**p, "hist_backend": "stream"}, lgb.Dataset(X, label=y))
    tb = lt.Booster({**p, **CPU}, lt.Dataset(X, label=y, params=CPU))
    for _ in range(3):
        jb.update(fobj=_dyadic_fobj)
        tb.update(fobj=_dyadic_fobj)
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    if kind != "feature_fraction":
        # (the reference's compaction quantum is its kernel block, so at
        # 70 % in-bag rows it stays dense where the port compacts)
        assert tb.engine.last_compact_rows > 0 and \
            jb.engine._last_compact_rows > 0
        assert tb.engine.route_only_passes_per_tree() == \
            jb.engine._route_only_passes_per_tree() == \
            (1 if fusion == "on" else -(-126 // 64) + 1)


@pytest.mark.parametrize("kind", ["goss", "bagging"])
def test_compaction_and_fusion_modes_byte_identical(kind):
    """In the port row_compaction auto, pad and off and route_fusion on and
    off grow byte-identical trees: its histograms are exact fixed point."""
    X, y = _sampled_data(2500, 9)
    texts, caps = [], []
    for compaction in ("auto", "pad", "off"):
        for fusion in ("on", "off"):
            p = {**_DYADIC_BASE, **_SAMPLED[kind], **CPU,
                 "row_compaction": compaction, "route_fusion": fusion}
            tb = lt.Booster(p, lt.Dataset(X, label=y, params=CPU))
            for _ in range(4):
                tb.update(fobj=_dyadic_fobj)
            texts.append(_trees_text(tb.model_to_string()))
            caps.append(tb.engine.last_compact_rows)
    assert all(t == texts[0] for t in texts)
    assert caps[0] > 0 and caps[2] == 2560 and caps[4] == 0


@pytest.mark.parametrize("kind", ["goss", "bagging"])
def test_sampled_binary_training_close_to_jax(kind):
    """Real binary gradients on the golden fixture: the first tree
    identical, raw scores within atol 2e-4 of the JAX package (segsum,
    float32 sums)."""
    X, y = _load_train("binary")
    # GOSS at LightGBM's default rates after a 4-iteration warmup
    extra = ({"data_sample_strategy": "goss", "learning_rate": 0.25}
             if kind == "goss"
             else {"bagging_fraction": 0.6, "bagging_freq": 1})
    params = {**_COMMON, "objective": "binary", **extra}
    jb = lgb.train({**params, "hist_backend": "segsum",
                    "hist_precision": "single"}, lgb.Dataset(X, label=y),
                   num_boost_round=10)
    tb = lt.train({**params, **CPU}, lt.Dataset(X, label=y, params=CPU),
                  num_boost_round=10)
    j_trees, t_trees = jb.engine.models, tb.engine.models
    assert len(j_trees) == len(t_trees) == 10
    assert _structure(t_trees[0]) == _structure(j_trees[0])
    for data in (X, _load_X()):
        np.testing.assert_allclose(tb.predict(data, raw_score=True),
                                   jb.predict(data, raw_score=True),
                                   rtol=0, atol=2e-4)


# ----------------------------------------------------------------- config

@pytest.mark.parametrize("params,match", [
    ({"data_sample_strategy": "goss", "top_rate": 0.9, "other_rate": 0.2},
     r"top_rate \+ other_rate"),
    ({"boosting": "goss", "top_rate": -0.1}, "non-negative"),
    ({"data_sample_strategy": "goss", "bagging_freq": 1,
      "bagging_fraction": 0.5}, "bagging"),
    ({"data_sample_strategy": "goss", "bagging_freq": 1,
      "pos_bagging_fraction": 0.5}, "bagging"),
    ({"row_compaction": "sometimes"}, "row_compaction"),
])
def test_sampling_config_conflicts_rejected(params, match):
    """The reference's GOSS conflict rules and row_compaction values
    (tests/test_sample_compact.py), in both packages' Config."""
    with pytest.raises(Exception, match=match):
        JConfig.from_params(params)
    with pytest.raises(lt.LightGBMError, match=match):
        TConfig.from_params(params)


def test_route_fusion_value_rejected():
    with pytest.raises(lt.LightGBMError, match="route_fusion"):
        TConfig.from_params({"route_fusion": "maybe"})


def test_goss_with_inactive_bagging_accepted():
    p = {"data_sample_strategy": "GOSS", "bagging_freq": 0,
         "bagging_fraction": 0.5, "top_rate": 0.3}
    cfg = TConfig.from_params(p)
    assert cfg.top_rate == 0.3
    assert isinstance(tss.create_sample_strategy(cfg, 100),
                      tss.GOSSStrategy)
    assert tss.GOSSStrategy(TConfig.from_params(
        {"learning_rate": 0.1}), 100).mask_key(9) == -1
