"""Training of the port against the JAX package, on the CPU.

The same numpy inputs go through the JAX package and through the port with
``device_type="cpu"``, where the port's kernel wrappers run their plain
PyTorch versions.  The JAX stream kernel runs in Pallas interpret mode, as
tests/test_stream_kernel.py runs it.

Tolerances and why:

- Routing, leaf ids, counts, route tables, layouts and the K4 gather are
  integer or copy operations: bit-equal.
- Histograms: the port sums exact fixed-point integers, the JAX stream kernel
  rounds weights to bf16 (single) and segsum adds float32 in its own order.
  On dyadic weights (multiples of 1/64 with few significant bits) every
  formulation is exact, so they are bit-equal; on random weights the port
  is held to segsum's float32 sums at rtol 1e-5 / atol 1e-6.
- Whole training on dyadic custom gradients: every sum is exact, so the
  model text is byte-identical to the JAX package's (parameter lines aside).
- Whole training on real gradients (float sums in different orders, f32
  sigmoid): the first tree identical in structure and raw scores within
  atol 2e-4, about three times the gap between the JAX package's own two
  formulations on the same fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objectives import create_objective as j_create_objective
from lightgbm_tpu.ops.histogram import _hist_segsum
from lightgbm_tpu.ops.split import find_best_splits as j_find_best_splits
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.convert import tree_arrays_from_numpy
from lightgbm_torch.device_data import LAYOUT_FIELDS, build_layout_np
from lightgbm_torch.kernels import layout as tl
from lightgbm_torch.kernels.leaf_gather import leaf_gather, leaf_gather_plain
from lightgbm_torch.kernels.route_hist import route_and_hist
from lightgbm_torch.objectives import create_objective as t_create_objective
from lightgbm_torch.ops.histogram import hist_shift
from lightgbm_torch.ops.split import find_best_splits as t_find_best_splits
from lightgbm_torch.tree import TreeArrays

from test_golden import FIX, _COMMON, _load_X, _load_train

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _mixed(n, seed, cat=False):
    """NaN (0), zero-heavy (1), dense (2), a mutually exclusive sparse pair
    that EFB bundles (3, 4), optionally a categorical column (5)."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6 if cat else 5)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    a = rs.rand(n)
    X[:, 3] = np.where(a < 0.1, rs.rand(n) + 0.5, 0.0)
    X[:, 4] = np.where(a > 0.9, rs.rand(n) + 0.5, 0.0)
    if cat:
        X[:, 5] = rs.randint(0, 7, n)
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 2 * X[:, 3]
         + 0.3 * rs.randn(n) > 0).astype(float)
    return X, y


def _datasets(X, y, params, cat=None):
    kw = {"categorical_feature": cat} if cat else {}
    jds = lgb.Dataset(X, label=y, params=dict(params), **kw).construct()
    tds = lt.Dataset(X, label=y, params={**params, **CPU}, **kw).construct()
    assert jds.binned.group_features == tds.binned.group_features
    return jds, tds


def _dyadic(rs, n):
    return (np.clip(np.round(64 * rs.randn(n)) / 64, -127 / 64, 127 / 64)
            .astype(np.float32))


# ---------------------------------------------------------------- K2 and K4

def _k2_case(with_cat=True, n=2000, seed=11):
    X, y = _mixed(n, seed, cat=with_cat)
    jds, tds = _datasets(X, y, {"max_bin": 31, "verbosity": -1},
                         cat=[5] if with_cat else None)
    assert any(len(g) > 1 for g in jds.binned.group_features)
    return X, jds, tds


def _k2_inputs(jds, tds, rs, dyadic):
    """One round's splits over four leaves, the port's and the JAX
    package's tables for them, and weights."""
    jdd, tdd = jds.device_data(), tds.device_data()
    N, G = jdd.bins.shape
    Bmax = jdd.max_bins
    L, S = 10, 4
    bundled = int(np.flatnonzero(np.asarray(jdd.routing.bundled))[0])
    # leaf 0: dense numeric; 1: categorical; 2: NaN feature, missing left;
    # 3: an EFB-bundled feature; 4: not split.  New leaves 5-8.
    pad = [0] * 6
    chosen = np.array([1, 1, 1, 1] + pad, np.int32)
    feat = np.array([2, 5, 0, bundled] + pad, np.int32)
    thr = np.array([9, 2, 6, 3] + pad, np.int32)
    dirf = np.array([0, 2, 1, 0] + pad, np.int32)
    new = np.array([5, 6, 7, 8] + pad, np.int32)
    bits = np.zeros((L, Bmax), bool)
    bits[1, [1, 2, 4]] = True
    # smaller child of split i fills slot i: right for 0 and 2, left for 1, 3
    sl = np.array([-1, 1, -1, 3] + [-1] * 6, np.int32)
    sr = np.array([0, -1, 2, -1] + [-1] * 6, np.int32)
    if np.asarray(jdd.routing.bundled).size < 6:
        # no categorical column: leaf 1 splits the zero-heavy feature
        feat[1], dirf[1] = 1, 0
        bits[:] = False
    leaf_id = rs.randint(0, 5, N).astype(np.int32)
    if dyadic:
        grad = _dyadic(rs, N)
        hess = (np.round(64 * rs.rand(N)) / 64 + 0.25).astype(np.float32)
    else:
        grad = rs.randn(N).astype(np.float32)
        hess = (np.abs(grad) + rs.rand(N)).astype(np.float32)
    cnt = (rs.rand(N) > 0.2).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    case = dict(N=N, G=G, Bmax=Bmax, L=L, S=S, chosen=chosen, feat=feat,
                thr=thr, dirf=dirf, new=new, bits=bits, sl=sl, sr=sr,
                leaf_id=leaf_id, grad=grad, hess=hess, cnt=cnt)
    t = torch.as_tensor
    case["t_tabs"] = tl.build_route_tables(
        t(chosen), t(new), t(feat), t(thr), t(dirf), t(sl), t(sr),
        t(np.full(L, -1, np.int32)), tdd.routing)
    case["t_words"] = tl.cat_words_from_bits(t(bits))
    return case


def _jax_k2(jds, c, with_hist=True, two_pass=False, tabs=None, leaf=None,
            S=None):
    jdd = jds.device_data()
    L = c["L"]
    S = c["S"] if S is None else S
    slay = jsk.pack_bins_T(jdd.bins)
    n_pad, N = slay.n_pad, c["N"]
    w_T = jnp.zeros((8, n_pad), jnp.float32)
    w_T = (w_T.at[0, :N].set(c["grad"]).at[1, :N].set(c["hess"])
           .at[2, :N].set(c["cnt"]))
    if tabs is None:
        i32 = jnp.int32
        tabs = jsk.build_route_tables(
            jnp.asarray(c["chosen"]), jnp.asarray(c["feat"]),
            jnp.asarray(c["thr"]), jnp.asarray(c["dirf"]),
            jnp.asarray(c["new"]), jnp.asarray(c["sl"] + 1, i32),
            jnp.asarray(c["sr"] + 1, i32), jnp.zeros(L, i32), jdd.routing, L)
    Bpad = -(-c["Bmax"] // 8) * 8
    bits_T = jnp.pad(jnp.asarray(c["bits"]).astype(jnp.bfloat16),
                     ((0, 0), (0, Bpad - c["Bmax"]))).T
    lid = c["leaf_id"] if leaf is None else leaf
    leaf_row = jnp.pad(jnp.asarray(lid), (0, n_pad - N)).reshape(1, -1)
    new_leaf, hist, cnt = jsk.route_and_hist(
        slay.bins_T, leaf_row, w_T, tabs, bits_T, S, c["Bmax"], c["G"], L,
        has_cat=True, two_pass=two_pass, with_hist=with_hist)
    return (np.asarray(new_leaf[0, :N]), np.asarray(hist), np.asarray(cnt))


def _port_k2(tds, c, with_hist=True, tabs=None, leaf=None, S=None):
    tdd = tds.device_data()
    N = c["N"]
    bins_T = tdd.bins[:N].t().contiguous()
    m = float(max(np.abs(c["grad"]).max(), np.abs(c["hess"]).max()))
    lid = c["leaf_id"] if leaf is None else leaf
    # one class: K2's operands with a class axis of 1
    new_leaf, hist, cnt = route_and_hist(
        bins_T, torch.as_tensor(lid)[None],
        (c["t_tabs"] if tabs is None else tabs)[None], c["t_words"][None],
        torch.as_tensor(c["grad"])[None], torch.as_tensor(c["hess"])[None],
        torch.as_tensor(c["cnt"]), c["S"] if S is None else S, c["Bmax"],
        (hist_shift(m, N),), with_hist)
    return (new_leaf[0].numpy(), None if hist is None else hist[0].numpy(),
            cnt[0].numpy())


def test_k2_plain_matches_jax_kernel_on_dyadic_weights():
    """Leaf ids, counts and histograms bit-equal to the JAX stream kernel
    (NaN default-left, a categorical bitset, an EFB-bundled split)."""
    _, jds, tds = _k2_case()
    c = _k2_inputs(jds, tds, np.random.RandomState(3), dyadic=True)
    j_leaf, j_hist, j_cnt = _jax_k2(jds, c)
    t_leaf, t_hist, t_cnt = _port_k2(tds, c)
    np.testing.assert_array_equal(t_leaf, j_leaf)
    np.testing.assert_array_equal(t_cnt, j_cnt)
    np.testing.assert_array_equal(t_hist, j_hist)
    assert (t_leaf != c["leaf_id"]).any() and t_hist.any()


def test_k2_plain_matches_segsum_on_random_weights():
    """On float weights the fixed-point histogram is within float32 rounding
    of the JAX package's segsum float32 sums over the same slots."""
    _, jds, tds = _k2_case()
    c = _k2_inputs(jds, tds, np.random.RandomState(5), dyadic=False)
    j_leaf, _, j_cnt = _jax_k2(jds, c, two_pass=True)
    t_leaf, t_hist, t_cnt = _port_k2(tds, c)
    np.testing.assert_array_equal(t_leaf, j_leaf)
    np.testing.assert_array_equal(t_cnt, j_cnt)
    slot_map = np.full(c["L"], -1, np.int32)
    for i in range(4):
        slot_map[c["new"][i] if c["sr"][i] == i else i] = i
    slot = jnp.asarray(slot_map[j_leaf])
    jdd = jds.device_data()
    ref = np.asarray(_hist_segsum(jdd.bins[:c["N"]], slot,
                                  jnp.asarray(c["grad"]),
                                  jnp.asarray(c["hess"]),
                                  jnp.asarray(c["cnt"]), c["S"],
                                  c["Bmax"]))[..., :2]
    np.testing.assert_allclose(t_hist, ref, rtol=1e-5, atol=1e-6)


def test_k2_root_pass_and_route_only_variant():
    """The root pass (every row kept in slot 0) and the route-only variant
    (leaf ids and counts, no histogram) against the JAX kernel."""
    _, jds, tds = _k2_case(with_cat=False, n=1500, seed=4)
    c = _k2_inputs(jds, tds, np.random.RandomState(8), dyadic=True)
    jdd, tdd = jds.device_data(), tds.device_data()
    L, N = c["L"], c["N"]
    z = jnp.zeros(L, jnp.int32)
    j_tabs0 = jsk.build_route_tables(z, z, z, z, z, z, z, z.at[0].set(1),
                                     jdd.routing, L)
    zt = torch.zeros(L, dtype=torch.int64)
    keep = torch.full((L,), -1, dtype=torch.int64)
    keep[0] = 0
    t_tabs0 = tl.build_route_tables(zt, zt, zt, zt, zt, keep, keep, keep,
                                    tdd.routing)
    zeros = np.zeros(N, np.int32)
    _, j_hist, j_cnt = _jax_k2(jds, c, tabs=j_tabs0, leaf=zeros, S=1)
    t_leaf, t_hist, t_cnt = _port_k2(tds, c, tabs=t_tabs0, leaf=zeros, S=1)
    np.testing.assert_array_equal(t_leaf, zeros)
    np.testing.assert_array_equal(t_cnt, j_cnt)
    np.testing.assert_array_equal(t_hist, j_hist)
    assert t_cnt[0] == c["cnt"].sum()
    j_leaf, _, j_cnt = _jax_k2(jds, c, with_hist=False)
    t_leaf, t_hist, t_cnt = _port_k2(tds, c, with_hist=False)
    assert t_hist is None
    np.testing.assert_array_equal(t_leaf, j_leaf)
    np.testing.assert_array_equal(t_cnt, j_cnt)


def test_k4_plain_matches_jax_leaf_gather():
    rs = np.random.RandomState(2)
    lid = rs.randint(0, 37, 5000).astype(np.int32)
    vals = rs.randn(37).astype(np.float32)
    want = np.asarray(jsk.leaf_gather(jnp.asarray(lid), jnp.asarray(vals)))
    got = leaf_gather(torch.as_tensor(lid), torch.as_tensor(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        leaf_gather_plain(torch.as_tensor(lid), torch.as_tensor(vals)).numpy(),
        vals[lid])


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        route_and_hist(meta, None, None, None, None, None, None, 1, 4, 0)
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        leaf_gather(torch.zeros(3, dtype=torch.int32, device="meta"), None)


# ------------------------------------------------------ tables and layouts

@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_feature_layout_matches_reference(zero_as_missing):
    from lightgbm_tpu import device_data as jdd_mod
    X, y = _mixed(1500, 6, cat=True)
    jds, tds = _datasets(X, y, {"max_bin": 31, "verbosity": -1,
                                "zero_as_missing": zero_as_missing}, cat=[5])
    j_layout, _, _ = jdd_mod.build_layouts(jds.binned)
    t_layout = build_layout_np(tds.binned)
    t_dev = tds.device_data().layout
    for name in LAYOUT_FIELDS:
        want = np.asarray(getattr(j_layout, name))
        np.testing.assert_array_equal(t_layout[name], want, err_msg=name)
        np.testing.assert_array_equal(getattr(t_dev, name).numpy(), want,
                                      err_msg=name)


def _decode_jax_tables(tabs):
    """The JAX package's (NUM_TAB, L) float rows, digits recombined, as the
    port's ROUTE_FIELDS columns."""
    v = np.asarray(tabs).astype(np.int64)
    word = v[jsk.T_WORD_LO] + (v[jsk.T_WORD_HI] << 7)
    return {
        tl.R_CHOSEN: v[jsk.T_CHOSEN],
        tl.R_NEWID: v[jsk.T_NEWID_LO] + (v[jsk.T_NEWID_HI] << 7),
        tl.R_GROUP: word * 4 + (v[jsk.T_SHIFT] >> 3),
        tl.R_SPAN: v[jsk.T_SPAN], tl.R_DEFBIN: v[jsk.T_DEFBIN],
        tl.R_BUNDLED: v[jsk.T_BUNDLED],
        tl.R_NANBIN: np.where(v[jsk.T_HASNAN] > 0, v[jsk.T_NANBIN], -1),
        tl.R_MZBIN: np.where(v[jsk.T_HASMZ] > 0, v[jsk.T_MZBIN], -1),
        tl.R_NBINS: v[jsk.T_NBINS], tl.R_THR: v[jsk.T_THR],
        tl.R_DEFLEFT: v[jsk.T_DEFLEFT], tl.R_ISCAT: v[jsk.T_ISCAT],
        tl.R_SLOT_L: v[jsk.T_SLOT_L] - 1, tl.R_SLOT_R: v[jsk.T_SLOT_R] - 1,
        tl.R_SLOT_KEEP: v[jsk.T_SLOT_KEEP] - 1}


@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_route_tables_match_reference(zero_as_missing):
    """Every field of the port's int32 records equals the reference's float
    rows with their 7-bit digits recombined (L = 300 so that leaf ids need
    the high digit)."""
    X, y = _mixed(1500, 9, cat=True)
    jds, tds = _datasets(X, y, {"max_bin": 31, "verbosity": -1,
                                "zero_as_missing": zero_as_missing}, cat=[5])
    rs = np.random.RandomState(1)
    L, F = 300, X.shape[1]
    chosen = (rs.rand(L) < 0.5).astype(np.int32)
    feat = rs.randint(0, F, L).astype(np.int32)
    thr = rs.randint(0, 30, L).astype(np.int32)
    dirf = rs.randint(0, 4, L).astype(np.int32)
    new = rs.randint(0, L, L).astype(np.int32)
    sl = rs.randint(-1, 64, L).astype(np.int32)
    sr = rs.randint(-1, 64, L).astype(np.int32)
    keep = rs.randint(-1, 2, L).astype(np.int32)
    j = jsk.build_route_tables(*(jnp.asarray(a) for a in (
        chosen, feat, thr, dirf, new, sl + 1, sr + 1, keep + 1)),
        jds.device_data().routing, L)
    t = torch.as_tensor
    port = tl.build_route_tables(t(chosen), t(new), t(feat), t(thr), t(dirf),
                                 t(sl), t(sr), t(keep),
                                 tds.device_data().routing).numpy()
    for col, want in _decode_jax_tables(j).items():
        np.testing.assert_array_equal(port[:, col], want,
                                      err_msg=tl.ROUTE_FIELDS[col])


def test_cat_words_pack_bits():
    rs = np.random.RandomState(0)
    bits = rs.rand(5, 70) < 0.5
    words = tl.cat_words_from_bits(torch.as_tensor(bits)).numpy()
    assert words.shape == (5, 3) and words.dtype == np.int32
    unpacked = (words.view(np.uint32)[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(unpacked.reshape(5, 96)[:, :70], bits)
    assert not unpacked.reshape(5, 96)[:, 70:].any()


# -------------------------------------------------------------- split scan

def _hist_case(rs, dyadic, zero_as_missing):
    X, y = _mixed(3000, int(rs.randint(100)))
    jds, tds = _datasets(X, y, {"max_bin": 31, "verbosity": -1,
                                "zero_as_missing": zero_as_missing})
    jdd = jds.device_data()
    N = X.shape[0]
    S = 6
    slot = rs.randint(-1, S, jdd.bins.shape[0]).astype(np.int32)
    n_pad = jdd.bins.shape[0]
    grad = _dyadic(rs, n_pad) if dyadic else rs.randn(n_pad).astype(
        np.float32)
    hess = (np.round(16 * rs.rand(n_pad)) / 16 + 0.5).astype(np.float32) \
        if dyadic else (rs.rand(n_pad) + 0.1).astype(np.float32)
    cnt = (np.arange(n_pad) < N).astype(np.float32)
    grad, hess = grad * cnt, hess * cnt
    h3 = np.asarray(_hist_segsum(jdd.bins, jnp.asarray(slot),
                                 jnp.asarray(grad), jnp.asarray(hess),
                                 jnp.asarray(cnt), S, jdd.max_bins))
    valid = slot >= 0
    pg = np.array([grad[valid & (slot == s)].sum(dtype=np.float64)
                   for s in range(S)], np.float32)
    ph = np.array([hess[valid & (slot == s)].sum(dtype=np.float64)
                   for s in range(S)], np.float32)
    pc = h3[:, 0, :, 2].sum(axis=-1).astype(np.float32)
    return jds, tds, h3[..., :2].copy(), pg, ph, pc


_SPLIT_PARAMS = [
    dict(l1=0.0, l2=0.0, mdl=5, msh=1e-3, mgs=0.0, mds=0.0),
    dict(l1=0.5, l2=2.0, mdl=20, msh=1.0, mgs=0.1, mds=0.0),
    dict(l1=0.0, l2=1.0, mdl=1, msh=1e-3, mgs=0.0, mds=0.3),
]


def _both_scans(jds, tds, hist, pg, ph, pc, sp):
    j = j_find_best_splits(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jds.device_data().layout, sp["l1"], sp["l2"], sp["mdl"], sp["msh"],
        sp["mgs"], enable_categorical=False, max_delta_step=sp["mds"])
    t = t_find_best_splits(
        torch.as_tensor(hist), torch.as_tensor(pg), torch.as_tensor(ph),
        torch.as_tensor(pc), tds.device_data().layout, sp["l1"], sp["l2"],
        sp["mdl"], sp["msh"], sp["mgs"], sp["mds"])
    return j, t


@pytest.mark.parametrize("zero_as_missing", [False, True])
@pytest.mark.parametrize("sp", _SPLIT_PARAMS)
def test_find_best_splits_bit_equal_on_dyadic_histograms(sp, zero_as_missing):
    rs = np.random.RandomState(7)
    jds, tds, hist, pg, ph, pc = _hist_case(rs, True, zero_as_missing)
    j, t = _both_scans(jds, tds, hist, pg, ph, pc, sp)
    for name in ("gain", "feature", "threshold", "dir_flags", "left_sum_g",
                 "left_sum_h", "left_count"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            err_msg=name)
    assert (t.gain.numpy() > 0).any()


@pytest.mark.parametrize("sp", _SPLIT_PARAMS)
def test_find_best_splits_close_on_random_histograms(sp):
    rs = np.random.RandomState(13)
    jds, tds, hist, pg, ph, pc = _hist_case(rs, False, False)
    j, t = _both_scans(jds, tds, hist, pg, ph, pc, sp)
    for name in ("feature", "threshold", "dir_flags"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            err_msg=name)
    np.testing.assert_allclose(t.gain.numpy(), np.asarray(j.gain), rtol=1e-5)


# -------------------------------------------------------- whole training

def _dyadic_fobj(score, ds):
    g = np.clip(np.round(64 * (score - ds.get_label())) / 64, -127 / 64,
                127 / 64)
    return g.astype(np.float32), np.ones_like(g, dtype=np.float32)


def _trees_text(text):
    return text.split("\nparameters:")[0]


@pytest.mark.parametrize("n,f,leaves,splits,extra", [
    (2000, 5, 15, 4, {}),
    (6000, 8, 140, 64, {}),
    (2000, 5, 31, 8, {"max_depth": 4, "lambda_l2": 1.0, "lambda_l1": 0.25,
                      "min_gain_to_split": 0.5, "max_delta_step": 1.5}),
])
def test_dyadic_training_byte_identical_to_jax_stream(n, f, leaves, splits,
                                                       extra):
    """Trees grown from dyadic custom gradients equal the JAX package's
    ``hist_backend="stream"`` trees: the grown arrays field by field and the
    model text byte for byte.  At S = 64 and 140 leaves the last round is
    the route-only sprint; the third case limits the depth and regularizes
    the gains and outputs."""
    rs = np.random.RandomState(n)
    X = rs.randn(n, f)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 0.3 * rs.randn(n)
         > 0).astype(float)
    params = {"objective": "none", "num_leaves": leaves,
              "max_splits_per_round": splits, "hist_precision": "single",
              "min_data_in_leaf": 5, "verbosity": -1, **extra}
    jb = lgb.Booster({**params, "hist_backend": "stream"},
                     lgb.Dataset(X, label=y))
    tb = lt.Booster({**params, **CPU}, lt.Dataset(X, label=y, params=CPU))
    for _ in range(2):
        jb.update(fobj=_dyadic_fobj)
        tb.update(fobj=_dyadic_fobj)
        ja = jb.engine._lazy_trees[-1]["arrays"]
        ta = tb.engine._lazy_trees[-1]["arrays"]
        want = tree_arrays_from_numpy(
            {k: np.asarray(getattr(ja, k)) for k in TreeArrays._fields})
        assert ta.num_leaves == want.num_leaves
        assert ta.num_leaves == leaves or extra
        for name in TreeArrays._fields[:-2] + ("leaf_depth",):
            a, b = getattr(ta, name), getattr(want, name)
            if extra and a.dtype == torch.float32:
                # regularized gains and outputs divide by non-dyadic
                # denominators, which XLA and torch may round apart by an
                # ulp; a gain is a difference of such terms (rtol 1e-5)
                torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
            else:
                assert torch.equal(a, b), name
    if not extra:
        assert _trees_text(tb.model_to_string()) == \
            _trees_text(jb.model_to_string())


def _golden_pair(kind, weighted=False, rounds=10):
    X, y = _load_train(kind)
    w = np.loadtxt(FIX / "golden_weights.csv") if weighted else None
    obj = "binary" if kind == "binary" else "regression"
    params = {**_COMMON, "objective": obj}
    jb = lgb.train({**params, "hist_backend": "segsum",
                    "hist_precision": "single"},
                   lgb.Dataset(X, label=y, weight=w), num_boost_round=rounds)
    tb = lt.train({**params, **CPU},
                  lt.Dataset(X, label=y, weight=w, params=CPU),
                  num_boost_round=rounds)
    return X, jb, tb


def _structure(t):
    return (t.num_leaves, list(t.split_feature), list(t.threshold),
            list(t.decision_type), list(t.left_child), list(t.right_child))


@pytest.mark.parametrize("kind,weighted", [("binary", False),
                                           ("binary", True), ("reg", False)])
def test_golden_training_matches_jax_segsum(kind, weighted, record_property):
    X, jb, tb = _golden_pair(kind, weighted)
    j_trees, t_trees = jb.engine.models, tb.engine.models
    assert len(j_trees) == len(t_trees) == 10
    assert _structure(t_trees[0]) == _structure(j_trees[0])
    differ = sum(_structure(a) != _structure(b)
                 for a, b in zip(j_trees, t_trees))
    record_property("trees_differing_in_structure", differ)
    Xg = _load_X()
    for data in (X, Xg):
        np.testing.assert_allclose(tb.predict(data, raw_score=True),
                                   jb.predict(data, raw_score=True),
                                   rtol=0, atol=2e-4)
    if weighted:
        stock = np.loadtxt(FIX / "stock_pred_binary_weighted.txt")
        ours = tb.predict(Xg, raw_score=True)
        err = np.sqrt(np.mean((ours - stock) ** 2)) / max(np.std(stock), 1e-6)
        assert err < 0.01


# --------------------------------------------------------------- gradients

@pytest.mark.parametrize("obj,extra", [
    ("regression", {}), ("binary", {}), ("binary", {"is_unbalance": True}),
    ("binary", {"scale_pos_weight": 3.0}), ("binary", {"sigmoid": 0.7})])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match_jax(obj, extra, weighted):
    """L2 gradients bit-equal; binary ones within 2 ulp (the two
    frameworks' float32 sigmoids may round differently).  The init score
    equals the reference's for 0/1 labels and is within an ulp of float32
    for real labels."""
    rs = np.random.RandomState(4)
    n = 3000
    y = ((rs.rand(n) < 0.3).astype(np.float64) if obj == "binary"
         else rs.randn(n) * 3)
    w = rs.rand(n) + 0.5 if weighted else None
    params = {"objective": obj, **extra}
    jo = j_create_objective(JConfig.from_params(params))
    to = t_create_objective(TConfig.from_params(params))
    jo.init(y, w, n=n)
    to.init(y, w, n=n)
    score = (rs.randn(n) * 2).astype(np.float32)
    jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    tg, th = (a.numpy() for a in to.get_gradients(torch.as_tensor(score)))
    if obj == "regression":
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(th, jh)
    else:
        # 2 ulp of the sigmoid p, carried through grad = sig (p - y) w and
        # hess = sig^2 p (1 - p) w (p - y cancels, so the bound is on p's
        # ulp, not the gradient's), plus the result's own rounding
        sig = params.get("sigmoid", 1.0)
        p = 1.0 / (1.0 + np.exp(-sig * score.astype(np.float64)))
        wn, wp = jo._label_weights
        lw = np.where(y > 0, wp, wn) * (1.0 if w is None else w)
        ulp_p = np.spacing(p.astype(np.float32)).astype(np.float64)
        for t, j in ((tg, jg), (th, jh)):
            tol = 2 * ulp_p * sig * lw + np.spacing(np.abs(j))
            assert (np.abs(t.astype(np.float64) - j) <= tol).all()
    jb, tbs = jo.boost_from_score(), to.boost_from_score()
    if obj == "binary" and not weighted:
        assert tbs == jb
    else:
        assert abs(tbs - jb) <= 4 * np.spacing(np.float32(abs(jb) + 1e-30))


# ----------------------------------------------------- model and continued

def _reg_data(n=1500, seed=21):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 5)
    X[rs.rand(n) < 0.05, 1] = np.nan
    y = 3 * X[:, 0] + np.where(X[:, 2] > 0.5, 2.0, -1.0) + 0.1 * rs.randn(n)
    return X, y


_REG = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 10,
        "max_bin": 63, "verbosity": -1, **CPU}


def test_port_model_loads_in_jax_package_and_predicts_the_same():
    X, y = _reg_data()
    tb = lt.train(_REG, lt.Dataset(X, label=y, params=CPU), 6)
    text = tb.model_to_string()
    jb = lgb.Booster(model_str=text)
    np.testing.assert_allclose(jb.predict(X, raw_score=True),
                               tb.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    assert tb.num_trees() == 6 and tb.current_iteration() == 6


def test_continued_training_matches_straight_run(tmp_path):
    """init_model + 3 rounds grows the same trees as 5 straight rounds."""
    X, y = _reg_data()
    straight = lt.train(_REG, lt.Dataset(X, label=y, params=CPU), 5)
    first = lt.train(_REG, lt.Dataset(X, label=y, params=CPU), 2)
    path = tmp_path / "m.txt"
    first.save_model(str(path))
    cont = lt.train(_REG, lt.Dataset(X, label=y, params=CPU), 3,
                    init_model=str(path))
    assert cont.num_trees() == 5
    assert [_structure(t) for t in cont.engine.models] == \
        [_structure(t) for t in straight.engine.models]
    np.testing.assert_allclose(cont.predict(X, raw_score=True),
                               straight.predict(X, raw_score=True),
                               rtol=0, atol=1e-5)


def test_training_stops_and_trims_when_no_split_remains():
    """A constant label grows no split: training stops after one iteration
    and keeps no trailing no-op tree beyond the one that folds the init
    score, as the reference does."""
    X, _ = _reg_data(400)
    y = np.full(400, 2.5)
    jb = lgb.train({**_REG, "device_type": "cpu"}, lgb.Dataset(X, label=y),
                   5)
    tb = lt.train(_REG, lt.Dataset(X, label=y, params=CPU), 5)
    assert tb.num_trees() == jb.num_trees()
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), atol=1e-6)


# ----------------------------------------------------------------- refusals

def test_train_without_device_type_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _reg_data(200)
    with pytest.raises(lt.LightGBMError, match="CUDA GPU"):
        lt.train({"objective": "regression"}, lt.Dataset(X, label=y), 5)


@pytest.mark.parametrize("extra", [
    {"hist_backend": "onehot"},
    {"tree_learner": "data"},
    {"hist_backend": "segsum"},
    {"tree_learner": "voting"},
    {"objective": "multiclass", "num_class": 3, "metric": "auc_mu",
     "auc_mu_weights": [0, 1, 2, 1, 0, 1, 2, 1, 0]},
    {"objective": "multiclass", "num_class": 3, "metric": "auc_mu",
     "auc_mu_weights": "0,1,2,1,0,1,2,1,0"},
])
def test_unported_training_params_raise(extra):
    X, y = _reg_data(300)
    y = (y > 0).astype(float) if extra.get("num_class") else y
    with pytest.raises(lt.LightGBMError, match="not yet ported"):
        lt.train({**_REG, **extra}, lt.Dataset(X, label=y, params=CPU), 2)


@pytest.mark.parametrize("weights", [None, [], ""])
def test_unset_auc_mu_weights_train(weights):
    """auc_mu_weights left unset or empty, as a stock model's parameter
    block writes it, trains: only class-pair weights are refused."""
    X, y = _reg_data(300)
    bst = lt.train({**_REG, "auc_mu_weights": weights},
                   lt.Dataset(X, label=y, params=CPU), 2)
    assert bst.num_trees() == 2


def test_unported_inputs_raise():
    X, y = _reg_data(300)
    ds = lt.Dataset(X, label=y, params=CPU)
    # cv is ported (tests/test_torch_cv.py): two rounds of five folds
    res = lt.cv(_REG, ds, 2)
    assert len(res["valid l2-mean"]) == len(res["valid l2-stdv"]) == 2
    with pytest.raises(lt.LightGBMError, match="hist_precision=double"):
        lt.train({**_REG, "hist_precision": "double"}, ds, 2)
