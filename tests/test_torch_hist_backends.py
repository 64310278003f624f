"""The port's non-stream growth path (``hist_backend="scatter"`` and
``"pallas"``) against the JAX package, on the CPU.

The same numpy inputs go through the JAX package and through the port with
``device_type="cpu"``, where the port's kernel wrappers run their plain
PyTorch versions: K5 (kernels/scatter_hist.py) and K6/K7
(kernels/hist_sorted.py).  The JAX package's ``pallas`` kernels run in
Pallas interpret mode, as tests/test_pallas_hist.py runs them; its
``scatter`` kernel runs in interpret mode off the TPU by itself, and at
Bmax > 128 its VMEM gate sends ``scatter`` to the one-hot contraction.

Tolerances and why:

- Block plans, leaf ids and counts are integer operations: bit-equal.
- Histograms: the port sums exact fixed-point integers; the JAX scatter
  kernel adds float32, its pallas kernels round weights to a bf16 hi+lo
  pair.  On dyadic weights (few significant bits) every formulation is
  exact, so they are bit-equal; on random weights the port is held to the
  JAX package's segsum float32 sums at rtol 1e-5 / atol 1e-6, the bound
  tests/test_torch_train.py holds K2 to.
- Whole training on dyadic custom gradients: every sum is exact, so the
  model text is byte-identical to the JAX package's same backend.
- Whole training on real binary gradients: the first tree identical in
  structure and raw scores within atol 2e-4 of JAX ``scatter``, the bound
  tests/test_torch_train.py states for K2 against segsum.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.ops.histogram import _hist_segsum
from lightgbm_tpu.ops.histogram import build_histograms as j_build_histograms
from lightgbm_tpu.pallas import hist_kernel as jhk

import lightgbm_torch as lt
from lightgbm_torch.kernels import hist_sorted as khs
from lightgbm_torch.kernels import scatter_hist as ksh
from lightgbm_torch.models import gbdt as tgbdt
from lightgbm_torch.ops import compact as tcompact
from lightgbm_torch.ops import grow as tgrow
from lightgbm_torch.ops.histogram import build_histograms, hist_shift

from test_golden import _COMMON, _load_X, _load_train
from test_torch_train import _dyadic_fobj, _structure, _trees_text

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jhk, "_INTERPRET", True)


# ------------------------------------------------------------ block plans

def _slots(rs, n, S, empty=()):
    slot = rs.randint(-1, S, n).astype(np.int32)
    for s in empty:
        slot[slot == s] = -1
    return slot


@pytest.mark.parametrize("n,S,T,empty", [
    # an empty slot inside the range, and the last slot empty: the pad
    # blocks keep slot 5
    (5000, 7, 256, (2, 6)),
    (700, 3, 128, (0, 1, 2)),    # no row in any slot
])
def test_plan_blocks_matches_jax(n, S, T, empty):
    """Gather indices, (slot, first, last) scalars and counts equal the JAX
    package's element for element, trailing pad blocks included."""
    slot = _slots(np.random.RandomState(n), n, S, empty)
    j = jcompact.plan_blocks(jnp.asarray(slot), S, T)
    t = tcompact.plan_blocks(torch.as_tensor(slot), S, T)
    assert t.gather_idx.dtype == t.scalars.dtype == torch.int32
    for name in tcompact.BlockPlan._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert len(t.scalars) == tcompact.num_blocks(n, S, T) == \
        jcompact.num_blocks(n, S, T)


@pytest.mark.parametrize("n,T", [(5000, 1024), (77, 32)])
def test_plan_single_slot_matches_jax(n, T):
    j = jcompact.plan_single_slot(n, T)
    t = tcompact.plan_single_slot(n, T)
    for name in tcompact.BlockPlan._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_compact_row_views_and_pallas_refusal():
    """compact_row_views gathers the in-bag rows first (the JAX package's
    compact_row_views, rows last); pallas refuses compaction."""
    rs = np.random.RandomState(3)
    n, G = 1000, 4
    bins = rs.randint(0, 30, (n, G)).astype(np.uint8)
    cnt = (rs.rand(n) < 0.4).astype(np.float32)
    g, h = rs.randn(n).astype(np.float32) * cnt, rs.rand(n).astype(
        np.float32) * cnt
    j = jcompact.compact_row_views(jnp.asarray(bins), jnp.asarray(g),
                                   jnp.asarray(h), jnp.asarray(cnt), 512)
    t = tcompact.compact_row_views(torch.as_tensor(bins.T.copy()),
                                   torch.as_tensor(g), torch.as_tensor(h),
                                   torch.as_tensor(cnt), 512)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]).T)
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="stream/segsum/onehot"):
        tcompact.check_compact_supported("pallas")
    tcompact.check_compact_supported("scatter")


# --------------------------------------------------- K5, K6 and K7 plain

def _hist_case(Bmax, dyadic, seed, n=3000, G=5, S=6):
    rs = np.random.RandomState(seed)
    bins = rs.randint(0, Bmax, (n, G)).astype(np.uint8)
    if dyadic:
        # a group of few bins: many rows per cell, exact on dyadic weights
        bins[:, 0] = np.minimum(bins[:, 0], 3)
    slot = _slots(rs, n, S, empty=(4,))
    if dyadic:
        grad = (np.round(64 * rs.randn(n)) / 64).astype(np.float32)
        hess = (np.round(16 * rs.rand(n)) / 16 + 0.5).astype(np.float32)
    else:
        grad = rs.randn(n).astype(np.float32)
        hess = (rs.rand(n) + 0.1).astype(np.float32)
    cnt = (rs.rand(n) > 0.2).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    shift = hist_shift(float(max(np.abs(grad).max(), hess.max())), n)
    return bins, slot, grad, hess, cnt, S, shift


def _port_hist(backend, bins, slot, grad, hess, cnt, S, Bmax, shift):
    t = torch.as_tensor
    b = t(bins.T.copy()) if backend == "scatter" else t(bins)
    return build_histograms(b, t(slot), t(grad), t(hess), t(cnt), S, Bmax,
                            shift, backend).numpy()


@pytest.mark.parametrize("Bmax", [64, 256])
@pytest.mark.parametrize("backend", ["scatter", "pallas"])
def test_plain_hist_matches_jax_backend_on_dyadic_weights(backend, Bmax):
    """The plain K5 and K6/K7 contracts bit-equal to the JAX package's
    build_histograms of the same backend (at Bmax 256 JAX scatter is its
    one-hot fallback), with an empty slot and negative slots; the two
    port backends equal each other."""
    bins, slot, grad, hess, cnt, S, shift = _hist_case(Bmax, True, Bmax)
    want = np.asarray(j_build_histograms(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(cnt), S, Bmax, backend=backend))
    got = _port_hist(backend, bins, slot, grad, hess, cnt, S, Bmax, shift)
    assert got.shape == (S, bins.shape[1], Bmax, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[4].any() and got[:, 0, :, 2].sum() == cnt[slot >= 0].sum()
    other = "pallas" if backend == "scatter" else "scatter"
    np.testing.assert_array_equal(
        _port_hist(other, bins, slot, grad, hess, cnt, S, Bmax, shift), got)


@pytest.mark.parametrize("Bmax", [64, 256])
@pytest.mark.parametrize("backend", ["scatter", "pallas"])
def test_plain_hist_matches_segsum_on_random_weights(backend, Bmax):
    """On float weights the fixed-point histograms are within float32
    rounding of the JAX package's float32 sums (segsum, and scatter; not
    its pallas, whose bf16 hi+lo weights keep ~16 bits), counts exact."""
    bins, slot, grad, hess, cnt, S, shift = _hist_case(Bmax, False,
                                                       7 + Bmax, n=2000)
    args = (jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(grad),
            jnp.asarray(hess), jnp.asarray(cnt), S, Bmax)
    got = _port_hist(backend, bins, slot, grad, hess, cnt, S, Bmax, shift)
    for ref in (_hist_segsum(*args),
                j_build_histograms(*args, backend="scatter")):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=1e-5,
                                   atol=1e-6)


def test_sorted_root_plan_counts_every_row():
    """slot=None (the root) plans every row into slot 0 without a sort."""
    bins, slot, grad, hess, cnt, _, shift = _hist_case(64, True, 5)
    zeros = np.zeros_like(slot)
    t = torch.as_tensor
    root = build_histograms(t(bins), None, t(grad), t(hess), t(cnt), 1, 64,
                            shift, "pallas").numpy()
    np.testing.assert_array_equal(
        root, _port_hist("scatter", bins, zeros, grad, hess, cnt, 1, 64,
                         shift))


def test_wrappers_refuse_cpu_tensors_and_other_devices():
    bins, slot, grad, hess, cnt, S, shift = _hist_case(64, True, 1, n=300)
    t = torch.as_tensor
    plan = tcompact.plan_blocks(t(slot), S, 64)
    with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
        ksh.scatter_hist_cuda(t(bins.T.copy()), t(slot), t(grad), t(hess),
                              t(cnt), S, 64, shift)
    for fn, bmax in ((khs.hist_direct_cuda, 64), (khs.hist_nibble_cuda, 200)):
        with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
            fn(t(bins), plan.gather_idx, plan.scalars, t(grad), t(hess),
               t(cnt), S, bmax, shift, 64)
    with pytest.raises(lt.LightGBMError, match="Bmax"):
        khs.hist_direct_cuda(t(bins), plan.gather_idx, plan.scalars, t(grad),
                             t(hess), t(cnt), S, 200, shift, 64)
    meta = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        ksh.scatter_hist(meta, None, None, None, None, 1, 4, 0)
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        khs.hist_sorted(meta, None, None, None, None, None, 1, 4, 0, 64)
    with pytest.raises(ValueError, match="unknown hist backend"):
        build_histograms(t(bins), None, t(grad), t(hess), t(cnt), 1, 64,
                         shift, "segsum")


# -------------------------------------------------------- whole training

def _data(n, seed, efb):
    """NaN (0), zero-heavy (1), dense columns and, with ``efb``, a mutually
    exclusive sparse pair that EFB bundles (3, 4)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 8)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    if efb:
        a = rs.rand(n)
        X[:, 3] = np.where(a < 0.1, rs.rand(n) + 0.5, 0.0)
        X[:, 4] = np.where(a > 0.9, rs.rand(n) + 0.5, 0.0)
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + X[:, 3]
         + 0.3 * rs.randn(n) > 0).astype(float)
    return X, y


def _pair(backend, X, y, params, iters=2):
    """The JAX package's and the port's boosters, same backend, trained
    ``iters`` iterations on dyadic custom gradients."""
    ds_params = {"max_bin": params.get("max_bin", 255)}
    jb = lgb.Booster({**params, "hist_backend": backend},
                     lgb.Dataset(X, label=y, params=ds_params))
    tb = lt.Booster({**params, "hist_backend": backend, **CPU},
                    lt.Dataset(X, label=y, params={**ds_params, **CPU}))
    for _ in range(iters):
        jb.update(fobj=_dyadic_fobj)
        tb.update(fobj=_dyadic_fobj)
    return jb, tb


_BASE = {"objective": "none", "hist_precision": "single",
         "min_data_in_leaf": 5, "verbosity": -1}


@pytest.mark.parametrize("max_bin", [63, 255])
@pytest.mark.parametrize("backend", ["scatter", "pallas"])
@pytest.mark.parametrize("shape", ["140_leaves_budget_64", "depth_limited"])
def test_dyadic_training_byte_identical_to_jax(backend, max_bin, shape):
    """Model text byte-identical to the JAX package's same backend: one
    tree of 140 leaves at split budget 64, and two of 31 leaves at budget 8
    under max_depth 4 (at max_bin 63 with an EFB-bundled pair, which at 255
    bins would need uint16 bins)."""
    if shape == "depth_limited":
        X, y = _data(2000, 5, efb=max_bin == 63)
        params = {**_BASE, "num_leaves": 31, "max_splits_per_round": 8,
                  "max_depth": 4, "max_bin": max_bin}
        iters = 2
    else:
        X, y = _data(4000, 6, efb=max_bin == 63)
        params = {**_BASE, "num_leaves": 140, "max_splits_per_round": 64,
                  "max_bin": max_bin}
        iters = 1
    jb, tb = _pair(backend, X, y, params, iters)
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    assert tb.engine.grow_params.hist_backend == backend
    assert (tb.engine.dd.max_bins > 128) == (max_bin == 255)
    if max_bin == 63:
        assert any(len(g) > 1 for g in tb.engine.train_data.binned
                   .group_features)
    nl = [t.num_leaves for t in tb.engine.models]
    assert (8 < min(nl) and max(nl) <= 16 if shape == "depth_limited"
            else nl == [140])


def test_schedule_differs_from_stream_where_a_child_outranks():
    """12 000 rows, 255 leaves, budget 64: the stream schedule's last round
    splits up to 2S current leaves at once, while the non-stream rounds
    re-scan the new children in between, and a new child outranks a
    remaining candidate, so the JAX package's stream and scatter trees
    differ.  The port's scatter equals JAX scatter, and its stream JAX
    stream."""
    X, y = _data(12000, 12000, efb=False)
    params = {**_BASE, "num_leaves": 255, "max_splits_per_round": 64,
              "max_bin": 63}
    texts = {}
    for backend in ("stream", "scatter"):
        jb, tb = _pair(backend, X, y, params, iters=1)
        texts[backend] = _trees_text(jb.model_to_string())
        assert _trees_text(tb.model_to_string()) == texts[backend], backend
    assert texts["stream"] != texts["scatter"]


@pytest.mark.parametrize("backend", ["scatter", "pallas"])
def test_every_non_stream_round_builds_histograms(backend, monkeypatch):
    """Histogram builds per tree = its rounds + the root, and no K2 pass,
    at a shape where the stream schedule ends in a route-only sprint."""
    builds, k2_hist, rounds = [], [], []
    orig_build, orig_k2 = tgrow.build_histograms, tgrow.route_and_hist
    orig_grow = tgbdt.grow_tree

    def counted_build(bins, slot, *args):
        builds.append(None if slot is None else int((slot >= 0).sum()))
        return orig_build(bins, slot, *args)

    def counted_k2(*args):
        k2_hist.append(args[10])          # with_hist
        return orig_k2(*args)

    def grow(*args, **kw):
        res = orig_grow(*args, **kw)
        rounds.append(res.rounds)
        return res

    monkeypatch.setattr(tgrow, "build_histograms", counted_build)
    monkeypatch.setattr(tgrow, "route_and_hist", counted_k2)
    monkeypatch.setattr(tgbdt, "grow_tree", grow)
    X, y = _data(6000, 6, efb=True)
    p = {**_BASE, "num_leaves": 127, "max_splits_per_round": 64,
         "max_bin": 63, **CPU}
    tb = lt.Booster({**p, "hist_backend": backend},
                    lt.Dataset(X, label=y, params=p))
    for _ in range(2):
        tb.update(fobj=_dyadic_fobj)
    assert not k2_hist and len(rounds) == 2
    assert len(builds) == sum(r + 1 for r in rounds)
    # each tree's root (every row in slot 0), then one build per round
    assert [i for i, c in enumerate(builds) if c is None] == \
        [0, rounds[0] + 1]
    assert all(c is None or c > 0 for c in builds)
    assert [t.num_leaves for t in tb.engine.models] == [127, 127]
    # the stream schedule of the same tree ends in a route-only K2 pass
    stream = lt.Booster({**p, "hist_backend": "stream"},
                        lt.Dataset(X, label=y, params=p))
    stream.update(fobj=_dyadic_fobj)
    assert k2_hist[-1] is False and k2_hist.count(True) == rounds[-1]


def test_pallas_at_split_budget_one_equals_scatter():
    """At max_splits_per_round 1 the port's pallas trees equal JAX scatter's
    (and the port's scatter).  The JAX package's pallas backend plans every
    row into slot 0 whenever a round has one slot (hist_kernel.py:373-374),
    so its trees differ there (ROADMAP.md section 3)."""
    X, y = _data(1000, 1, efb=True)
    params = {**_BASE, "num_leaves": 7, "max_splits_per_round": 1,
              "max_bin": 63}
    jb, tb = _pair("scatter", X, y, params, iters=1)
    jp, tp = _pair("pallas", X, y, params, iters=1)
    want = _trees_text(jb.model_to_string())
    assert _trees_text(tb.model_to_string()) == want
    assert _trees_text(tp.model_to_string()) == want
    assert _trees_text(jp.model_to_string()) != want


_SAMPLED = {
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.5,
             "top_rate": 0.5, "other_rate": 0.25},
    "bagging": {"bagging_fraction": 0.5, "bagging_freq": 1},
}


@pytest.mark.parametrize("kind", sorted(_SAMPLED))
def test_sampled_scatter_byte_identical_to_jax_and_across_compaction(kind):
    """GOSS and bagging under scatter on dyadic gradients: compaction auto,
    pad and off grow the same text, equal to JAX scatter's (compacted in
    both packages)."""
    X, y = _data(2000, 8, efb=True)
    params = {**_BASE, **_SAMPLED[kind], "num_leaves": 31,
              "max_splits_per_round": 8, "max_bin": 63}
    jb, tb = _pair("scatter", X, y, params, iters=3)
    want = _trees_text(jb.model_to_string())
    assert _trees_text(tb.model_to_string()) == want
    assert tb.engine.last_compact_rows > 0 and jb.engine._last_compact_rows > 0
    assert tb.engine.route_only_passes_per_tree() == 0
    caps = []
    for mode in ("pad", "off"):
        p = {**params, "hist_backend": "scatter", "row_compaction": mode,
             **CPU}
        b = lt.Booster(p, lt.Dataset(X, label=y, params=p))
        for _ in range(3):
            b.update(fobj=_dyadic_fobj)
        assert _trees_text(b.model_to_string()) == want, mode
        caps.append(b.engine.last_compact_rows)
    assert caps == [2048, 0]


def test_goss_under_pallas_runs_uncompacted():
    """A GOSS tree under pallas grows on masked weights over all rows, and
    equals JAX pallas and the port's scatter."""
    X, y = _data(2000, 8, efb=True)
    params = {**_BASE, **_SAMPLED["goss"], "num_leaves": 31,
              "max_splits_per_round": 8, "max_bin": 63}
    jb, tb = _pair("pallas", X, y, params, iters=3)
    want = _trees_text(jb.model_to_string())
    assert _trees_text(tb.model_to_string()) == want
    assert tb.engine.last_compact_rows == 0
    assert tb.engine.last_sampled_rows is None      # no count was read
    p = {**params, "hist_backend": "scatter", **CPU}
    b = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    for _ in range(3):
        b.update(fobj=_dyadic_fobj)
    assert _trees_text(b.model_to_string()) == want
    assert b.engine.last_compact_rows > 0


_GOLDEN = {**_COMMON, "objective": "binary", "hist_precision": "single"}


@functools.lru_cache(maxsize=1)
def _golden_jax_scatter():
    X, y = _load_train("binary")
    return lgb.train({**_GOLDEN, "hist_backend": "scatter"},
                     lgb.Dataset(X, label=y), num_boost_round=10)


@pytest.mark.parametrize("backend", ["scatter", "pallas"])
def test_golden_binary_close_to_jax_scatter(backend):
    """Real binary gradients on the golden fixture: the first tree equal in
    structure to JAX scatter's, raw scores within atol 2e-4."""
    X, y = _load_train("binary")
    params = _GOLDEN
    jb = _golden_jax_scatter()
    tb = lt.train({**params, "hist_backend": backend, **CPU},
                  lt.Dataset(X, label=y, params=CPU), num_boost_round=10)
    j_trees, t_trees = jb.engine.models, tb.engine.models
    assert len(j_trees) == len(t_trees) == 10
    assert _structure(t_trees[0]) == _structure(j_trees[0])
    for data in (X, _load_X()):
        np.testing.assert_allclose(tb.predict(data, raw_score=True),
                                   jb.predict(data, raw_score=True),
                                   rtol=0, atol=2e-4)


# ----------------------------------------------------------------- config

def _reg(n=300):
    rs = np.random.RandomState(0)
    X = rs.randn(n, 4)
    return X, X[:, 0] + 0.1 * rs.randn(n)


@pytest.mark.parametrize("extra,match,same_as_jax", [
    ({"hist_backend": "bogus"}, r"unknown hist_backend='bogus'; one of",
     True),
    ({"hist_backend": "scatter", "hist_precision": "double"},
     r"requires hist_backend=segsum or onehot \(the TPU", True),
    ({"hist_backend": "pallas", "hist_precision": "double"},
     "hist_precision=double requires", True),
    ({"hist_precision": "triple"}, "is not one of", True),
    ({"hist_backend": "scatter", "tree_learner": "feature"},
     "not supported with tree_learner=feature", False),
    ({"hist_backend": "onehot"}, "not yet ported", False),
])
def test_hist_backend_validation_messages(extra, match, same_as_jax):
    """The JAX package's own messages (gbdt.py:1150-1159, :801-805), word
    for word where both packages run the check on one device; segsum and
    onehot are not ported."""
    X, y = _reg()
    params = {"objective": "regression", "verbosity": -1, **extra}
    with pytest.raises(lt.LightGBMError, match=match) as port:
        lt.train({**params, **CPU}, lt.Dataset(X, label=y, params=CPU), 1)
    if same_as_jax:
        with pytest.raises(Exception, match=match) as ref:
            lgb.train(params, lgb.Dataset(X, label=y), 1)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("backend", ["auto", "stream", "scatter", "pallas"])
def test_hist_backend_resolution(backend):
    """auto resolves to stream on the port's device (the JAX package picks
    pallas only where its stream kernel outgrows the TPU's VMEM)."""
    X, y = _reg()
    b = lt.train({"objective": "regression", "verbosity": -1,
                  "hist_backend": backend, **CPU},
                 lt.Dataset(X, label=y, params=CPU), 1)
    assert b.engine.grow_params.hist_backend == \
        ("stream" if backend == "auto" else backend)
