"""K1 ``predict_stream``'s packed node records and launch plan, on the CPU.

The CUDA kernel (``csrc/predict_stream.cu``) walks tiles of rows through
stages of trees copied into shared memory under the launch plan
``predict_plan``; a step reads an 8-byte pair of walk words from the
packed word planes (``kernels/predict.py::pack_nodes``), the rarer node
kinds their other words.  It runs only on the card (``chip_smoke.py`` holds it bit
for bit against its plain version there); these tests hold what surrounds
it:

- ``pack_nodes`` keeps every field of the 16-field host records of the
  fixtures of tests/test_torch_predict.py (NaN, EFB, categorical, early
  stop, single-leaf trees, multiclass), and refuses fields it cannot hold;
- a numpy emulation of the kernel's walk over the packed word planes,
  tile by tile, stage by stage, all rows of a tile taking each tree
  together (one row a thread), equals
  ``predict_stream_plain`` bit for bit (both add the same float32 leaf
  values in tree order: no tolerance), under the default plan and plans
  with trees and bins in global memory, one tree a stage and few threads;
  and it matches the JAX package's ``predict_stream`` (Pallas in interpret
  mode, as tests/test_torch_predict.py runs it) within rtol 1e-4 / atol
  1e-5, the tolerance of the TPU kernel's bf16 hi/lo leaf values;
- every row and tree lies in one tile and stage, every plan within the
  sm_90 limits the C side checks, the main path's plan pinned, and the
  field orders equal the C enums.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st

import lightgbm_tpu as lgb
from lightgbm_tpu.basic import Booster as JBooster
from lightgbm_tpu.pallas import predict_kernel as jpk

import lightgbm_torch as lt
from lightgbm_torch.basic import Booster as TBooster
from lightgbm_torch.device_data import build_routing_np
from lightgbm_torch.kernels import hist_wide as khw
from lightgbm_torch.kernels import predict as tpk

from test_torch_predict import ES, MAKERS

CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-4, 1e-5
SRC = Path(tpk.__file__).parent / "csrc" / "predict_stream.cu"


@pytest.fixture(autouse=True)
def _small_device_batches(monkeypatch):
    monkeypatch.setattr(jpk, "_INTERPRET", True)
    monkeypatch.setattr(JBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)


def _efb(rs):
    """A mutually exclusive sparse pair that EFB bundles, NaNs, a
    zero-heavy column; max_bin 63 keeps the bundle in uint8 bins."""
    n = 1500
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    a = rs.rand(n)
    X[:, 2] = np.where(a < 0.15, rs.rand(n) + 0.5, 0.0)
    X[:, 3] = np.where(a > 0.85, rs.rand(n) + 0.5, 0.0)
    y = (X[:, 2] - X[:, 3] + 0.5 * np.nan_to_num(X[:, 0]) + 0.2 * X[:, 4]
         + 0.1 * rs.randn(n) > 0).astype(float)
    return X, y, X[:600].copy(), {"objective": "binary", "max_bin": 63}, 8, {}


def _single_leaf(rs):
    """Binary trees, two of which the fixture replaces by single-leaf
    trees (see _with_single_leaf_trees)."""
    X = rs.randn(1200, 5)
    y = (X[:, 0] - X[:, 1] > 0).astype(float)
    return X, y, rs.randn(600, 5), {"objective": "binary"}, 6, {}


CASE_MAKERS = {**MAKERS, "efb": _efb, "single_leaf": _single_leaf}
SINGLE_LEAF = {1: 0.0625, 4: -0.03125}


def _with_single_leaf_trees(path):
    """Rewrite the model text so that trees 1 and 4 are single leaves."""
    text = Path(path).read_text()
    head, rest = text.split("\nTree=", 1)
    body, tail = rest.split("\nend of trees", 1)
    blocks = ("Tree=" + body).split("\n\nTree=")
    blocks = [b if b.startswith("Tree=") else "Tree=" + b for b in blocks]
    for i, v in SINGLE_LEAF.items():
        blocks[i] = "\n".join([
            f"Tree={i}", "num_leaves=1", "num_cat=0", "split_feature=",
            "split_gain=", "threshold=", "decision_type=", "left_child=",
            "right_child=", f"leaf_value={v}", "leaf_weight=0",
            "leaf_count=0", "internal_value=", "internal_weight=",
            "internal_count=", "is_linear=0", "shrinkage=1", ""])
    head = re.sub(r"\ntree_sizes=[^\n]*", "", head)
    Path(path).write_text(head + "\n" + "\n\n".join(b.rstrip("\n") + "\n"
                                                    for b in blocks)
                          + "\nend of trees" + tail)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> (JAX booster, port booster, test rows, predict kwargs), both
    boosters serving one model text."""
    out = {}
    for i, (name, make) in enumerate(sorted(CASE_MAKERS.items())):
        X, y, Xt, obj, rounds, ds_kw = make(np.random.RandomState(60 + i))
        params = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
                  **obj}
        trained = lgb.train(params, lgb.Dataset(X, label=y, **ds_kw),
                            num_boost_round=rounds)
        path = str(tmp_path_factory.mktemp(name) / "model.txt")
        trained.save_model(path)
        if name == "single_leaf":
            _with_single_leaf_trees(path)
        jax0 = lgb.train(params, lgb.Dataset(X, label=y, **ds_kw), 0,
                         init_model=path)
        ds_params = {**CPU, **{k: v for k, v in obj.items()
                               if k == "max_bin"}}
        port0 = lt.train(params, lt.Dataset(X, label=y, params=ds_params,
                                            **ds_kw), 0, init_model=path)
        out[name] = (jax0, port0, Xt,
                     ES if name == "binary_early_stop" else {})
    return out


def _inputs(port0, Xt, kw):
    use, k, _, _ = port0._resolve_tree_slice(0, None)
    es = (kw["pred_early_stop_freq"], kw["pred_early_stop_margin"]) \
        if kw else None
    inp = port0._device_predict_inputs(Xt, use, k, es)
    assert inp is not None, "the device path must take the fixture"
    return use, k, inp


def _host_tables(port0, use, k):
    tb = port0.engine.train_data.binned
    routing_np, _ = build_routing_np(tb)
    L = max(max(t.num_leaves for t in use), 2)
    return [tpk.build_predict_tables(use[c::k], routing_np, L,
                                     tb.bin_mappers) for c in range(k)]


# ------------------------------------------------------------ pack_nodes

@pytest.mark.parametrize("name", sorted(CASE_MAKERS))
def test_pack_nodes_round_trips_every_field(cases, name):
    jax0, port0, Xt, kw = cases[name]
    use, k, inp = _inputs(port0, Xt, kw)
    tables = _host_tables(port0, use, k)
    kinds = set()
    for t, (nodes, _, _, _) in zip(tables, inp.classes):
        packed = tpk.pack_nodes(t.nodes)
        T, L = t.leaf_value.shape
        assert packed.shape == (len(tpk.PACKED_WORDS), T, L)
        assert packed.dtype == np.int32
        assert packed.flags.c_contiguous
        # the device tables are the packed records
        np.testing.assert_array_equal(nodes.numpy(), packed)
        back = tpk.unpack_nodes(torch.as_tensor(packed)).numpy()
        np.testing.assert_array_equal(back, t.nodes)
        rec = t.nodes
        if (rec[..., tpk.F_BUNDLED] > 0).any():
            kinds.add("efb")
        if (rec[..., tpk.F_ISCAT] > 0).any():
            kinds.add("categorical")
        if (rec[..., tpk.F_HASNAN] > 0).any():
            kinds.add("nan")
        if any(u.num_leaves == 1 for u in use):
            kinds.add("single_leaf")
    want = {"efb": {"efb"}, "categorical": {"categorical"},
            "binary_nan": {"nan"}, "single_leaf": {"single_leaf"}}
    assert want.get(name, set()) <= kinds
    if name == "multiclass":
        assert len(inp.classes) == 3


@pytest.mark.parametrize("L", [5, tpk.CHILD16_MAX_L + 7])
def test_pack_nodes_holds_wide_fields_and_refuses_the_rest(L):
    """Groups up to 65535, thresholds up to 32767, bins up to 510 and
    bitset bases past 2**24 round-trip, and children past 16 bits where L
    needs them (every node then special: its step reads 32-bit children);
    a threshold past 32767 or a missing bin past 510 (16-bit bins)
    round-trips through its own planes at a special node; what does not
    fit raises."""
    rs = np.random.RandomState(L)
    shape = (3, L)
    rec = np.zeros(shape + (len(tpk.NODE_FIELDS),), np.int32)
    rec[..., tpk.F_GROUP] = rs.randint(0, 1 << 16, shape)
    rec[..., tpk.F_THR] = rs.randint(0, 1 << tpk.THR_BITS, shape)
    rec[0, 0, tpk.F_THR] = (1 << tpk.THR_BITS) - 1
    for has, b in ((tpk.F_HASNAN, tpk.F_NANBIN), (tpk.F_HASMZ, tpk.F_MZBIN)):
        rec[..., has] = rs.rand(*shape) < 0.5
        rec[..., b] = np.where(rec[..., has] > 0,
                               rs.randint(0, tpk.NO_BIN, shape), 0)
    for f in (tpk.F_BUNDLED, tpk.F_DEFLEFT, tpk.F_ISCAT):
        rec[..., f] = rs.rand(*shape) < 0.5
    for f in (tpk.F_LEFT, tpk.F_RIGHT):
        rec[..., f] = rs.randint(0, 2 * L, shape)
    for f in (tpk.F_CATBASE, tpk.F_SPAN, tpk.F_DEFBIN, tpk.F_NBINS):
        rec[..., f] = rs.randint(0, 1 << 30, shape)
    packed = tpk.pack_nodes(rec)
    np.testing.assert_array_equal(
        tpk.unpack_nodes(torch.as_tensor(packed)).numpy(), rec)
    gt = packed[tpk.PACKED_WORDS.index("group_thr")].view(np.uint32)
    special = (gt >> tpk.SPECIAL_BIT) > 0
    plain = ((rec[..., tpk.F_HASNAN] | rec[..., tpk.F_HASMZ]
              | rec[..., tpk.F_BUNDLED] | rec[..., tpk.F_ISCAT]) == 0)
    if L > tpk.CHILD16_MAX_L:
        assert special.all()
    else:
        np.testing.assert_array_equal(special, ~plain)
        c16 = packed[tpk.PACKED_WORDS.index("children16")].view(np.uint32)
        np.testing.assert_array_equal(c16 & 0xFFFF, rec[..., tpk.F_LEFT])
        np.testing.assert_array_equal(c16 >> 16, rec[..., tpk.F_RIGHT])
    wide = rec.copy()
    wide[1, 2, tpk.F_THR] = 1 << tpk.THR_BITS
    wide[2, 3, tpk.F_HASNAN], wide[2, 3, tpk.F_NANBIN] = 1, tpk.NO_BIN
    packed = tpk.pack_nodes(wide)
    np.testing.assert_array_equal(
        tpk.unpack_nodes(torch.as_tensor(packed)).numpy(), wide)
    gt = packed[tpk.PACKED_WORDS.index("group_thr")].view(np.uint32)
    assert (gt[1, 2] >> tpk.SPECIAL_BIT) == (gt[2, 3] >> tpk.SPECIAL_BIT) == 1
    for f, v in ((tpk.F_GROUP, 1 << 16), (tpk.F_THR, -(1 << tpk.THR_BITS)),
                 (tpk.F_THR, -1), (tpk.F_NANBIN, tpk.NO_BIN16),
                 (tpk.F_DEFLEFT, 2), (tpk.F_UNUSED, 1)):
        bad = rec.copy()
        bad[1, 2, f] = v
        bad[1, 2, tpk.F_HASNAN] = 1
        with pytest.raises(lt.LightGBMError, match="outside the packed"):
            tpk.pack_nodes(bad)
    bad = rec.copy()
    bad[0, 1, tpk.F_HASMZ] = 0
    bad[0, 1, tpk.F_MZBIN] = 7                     # a bin without its flag
    with pytest.raises(lt.LightGBMError, match="mz_bin"):
        tpk.pack_nodes(bad)


# ------------------------------------------------- the kernel's walk

def emulate(plan, bins_T, packed, leaf_value, cat_words, max_depth,
            es_freq=0, es_margin=0.0):
    """(N,) float32 scores as csrc/predict_stream.cu computes them under
    ``plan``: for each tile, its rows (one a thread) walk each stage's
    trees together; a step of a row reads its
    node's two walk words (16-bit children; group, threshold bin and the
    special-node bit) and its bin of the group, and at a special node the
    flags, children and side words; after a leaf, or max_depth steps (leaf
    0), the row adds the leaf value in float32; every es_freq trees a row
    whose 2|score| passes the margin stops; a tile whose rows have all
    stopped skips its other stages."""
    G, n = bins_T.shape
    _, T, L = packed.shape
    W = packed.view(np.uint32).astype(np.int64)
    words = cat_words.view(np.uint32).astype(np.int64)
    lv = leaf_value.astype(np.float32)
    margin = np.float32(es_margin)
    ts = plan.trees_per_stage or T
    stages = [(t0, min(t0 + ts, T)) for t0 in range(0, T, ts)]
    out = np.full(n, np.nan, np.float32)
    seen = np.zeros(n, np.int64)
    R = plan.rows_per_tile
    for b in range(plan.tiles):
        lr = np.arange(plan.threads)
        rows = b * R + lr[lr < min(R, n - b * R)]
        seen[rows] += 1
        score = np.zeros(len(rows), np.float32)
        live = np.ones(len(rows), bool)
        for t0, t1 in stages:
            for t in range(t0, t1):
                nd = np.where(live, 0, L)
                for _ in range(max_depth):
                    act = nd < L
                    if not act.any():
                        break
                    at = np.where(act, nd, 0)
                    c, gt = W[0, t, at], W[1, t, at]
                    gb = bins_T[gt & 0xFFFF, rows].astype(np.int64)
                    thr = (gt >> 16) & ((1 << tpk.THR_BITS) - 1)
                    nx = np.where(gb <= thr, c & 0xFFFF, c >> 16)
                    special = (gt >> tpk.SPECIAL_BIT) & 1 > 0
                    if special.any():
                        nx = np.where(special, _route_special(
                            W, words, t, at, gb, thr), nx)
                    nd = np.where(act, nx, nd)
                leaf = np.where(nd >= L, nd - L, 0)
                score = np.where(live, score + lv[t, leaf], score)
                if es_freq > 0 and (t + 1) % es_freq == 0:
                    live &= ~(np.float32(2.0) * np.abs(score) > margin)
            if not live.any():
                break
        out[rows] = score
    assert (seen == 1).all(), "every row lies in exactly one tile"
    return out


def _route_special(W, words, t, at, gb, thr):
    """The next node at special nodes: the flags, children and side words
    (kernels/predict.PACKED_WORDS), as route_special reads them."""
    f, left, right, span, defbin, nbins, catbase = (
        W[tpk.PACKED_WORDS.index(k), t, at]
        for k in ("flags", "left", "right", "span_start", "default_bin",
                  "num_bins", "cat_base"))
    left = np.where(left >= 1 << 31, left - (1 << 32), left)
    right = np.where(right >= 1 << 31, right - (1 << 32), right)
    ls = gb - span
    fb = np.where((f >> tpk.BUNDLED_BIT) & 1 > 0,
                  np.where((ls >= 0) & (ls < nbins - 1), ls + (ls >= defbin),
                           defbin), gb)
    is_cat = (f >> tpk.ISCAT_BIT) & 1 > 0
    cbit = np.zeros(len(at), bool)
    if is_cat.any():
        wi = np.where(is_cat, catbase + (fb >> 5), 0)
        cbit = (words[wi] >> (fb & 31)) & 1 > 0
    missing = ((fb == (f >> tpk.NAN_SHIFT) & tpk.NO_BIN)
               | (fb == (f >> tpk.MZ_SHIFT) & tpk.NO_BIN))
    go_left = np.where(missing, (f >> tpk.DEFLEFT_BIT) & 1 > 0, fb <= thr)
    go_left = np.where(is_cat, cbit, go_left)
    return np.where(go_left, left, right)


def _plans(n, G, L, T):
    """The default plan, and small-budget plans that put one tree in a
    stage beside staged bins, the bins in global memory beside staged
    trees, and both in global memory."""
    tree = tpk.stage_bytes(1, L)
    small = tpk._predict_plan(n, G, L, T, khw.SMEM_BLOCK, 32)
    bins = G * small.bins_stride
    plans = {
        "default": tpk.predict_plan(n, G, L, T),
        "one_tree_a_stage": tpk._predict_plan(n, G, L, T,
                                              bins + 2 * tree + 8, 32),
        "bins_global": tpk._predict_plan(n, G, L, T, 2 * tree + 64, 512),
        "all_global": tpk._predict_plan(n, G, L, T, 2 * tree - 16, 512),
        "threads_64": tpk._predict_plan(n, G, L, T, 40_000, 64),
    }
    p = plans["one_tree_a_stage"]
    assert p.trees_per_stage == min(1, T) and p.bins_stride > 0
    p = plans["bins_global"]
    assert p.trees_per_stage >= 1 and p.bins_stride == 0
    p = plans["all_global"]
    assert p.trees_per_stage == 0 and p.bins_stride == 0
    return plans


@pytest.mark.parametrize("name", sorted(CASE_MAKERS))
def test_emulated_walk_equals_plain_and_jax(cases, name):
    jax0, port0, Xt, kw = cases[name]
    use, k, inp = _inputs(port0, Xt, kw)
    bins_T = inp.bins_T
    G, n = bins_T.shape
    got = []
    for nodes, lv, words, depths in inp.classes:
        T, L = lv.shape
        want = tpk.predict_stream_plain(bins_T, nodes, lv, words, depths,
                                        inp.es_freq, inp.es_margin).numpy()
        for label, plan in _plans(n, G, L, T).items():
            _check_limits(plan, n, G, L, T)
            em = emulate(plan, bins_T.numpy(), nodes.numpy(), lv.numpy(),
                         words.numpy(), int(max(depths)), inp.es_freq,
                         inp.es_margin)
            np.testing.assert_array_equal(em, want, err_msg=label)
        got.append(want)
    port = got[0] if k == 1 else np.stack(got, axis=1)
    jax = jax0.predict(Xt, raw_score=True, **kw)
    np.testing.assert_allclose(port, jax, rtol=RTOL, atol=ATOL)


def test_emulated_deep_chain_and_early_stop():
    """A chain 30 deep (each node sends low bins left to a leaf), a tree
    whose depth bound cuts its walk (leaf 0), and early stop at every
    tree: emulation == plain, bit for bit."""
    rs = np.random.RandomState(5)
    G, n, L, T = 3, 700, 32, 5
    bins_T = rs.randint(0, 64, size=(G, n)).astype(np.uint8)
    rec = np.zeros((T, L, len(tpk.NODE_FIELDS)), np.int32)
    for i in range(L - 1):
        rec[:, i, tpk.F_GROUP] = i % G
        rec[:, i, tpk.F_THR] = i % 7
        rec[:, i, tpk.F_LEFT] = L + i            # leaf i
        rec[:, i, tpk.F_RIGHT] = i + 1 if i + 1 < L - 1 else L + L - 1
    lv = rs.uniform(-1, 1, size=(T, L)).astype(np.float32)
    nodes = torch.as_tensor(tpk.pack_nodes(rec))
    words = torch.zeros(1, dtype=torch.int32)
    for es_freq, margin, max_depth in ((0, 0.0, L - 1), (1, 0.5, L - 1),
                                       (2, 1.0, 9)):
        want = tpk.predict_stream_plain(torch.as_tensor(bins_T), nodes,
                                        torch.as_tensor(lv), words,
                                        [max_depth] * T, es_freq,
                                        margin).numpy()
        for plan in _plans(n, G, L, T).values():
            got = emulate(plan, bins_T, nodes.numpy(), lv, words.numpy(),
                          max_depth, es_freq, margin)
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the plan

def _check_limits(plan, n, G, L, T):
    """The limits plan_ok in csrc/predict_stream.cu checks."""
    assert 32 <= plan.threads <= tpk.MAX_THREADS and plan.threads % 32 == 0
    R = plan.rows_per_tile
    assert R >= 16 and R % 16 == 0 and R <= plan.threads
    assert 1 <= plan.tiles <= 2 ** 31 - 1
    assert plan.tiles * R >= n and (plan.tiles - 1) * R < max(n, 1)
    assert 0 <= plan.trees_per_stage <= T
    assert plan.bins_stride == 0 or (plan.bins_stride >= R
                                     and plan.bins_stride % 16 == 0)
    stages = (2 * tpk.stage_bytes(plan.trees_per_stage, L)
              if plan.trees_per_stage else 0)
    assert plan.smem == G * plan.bins_stride + stages
    assert plan.smem <= khw.SMEM_BLOCK


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 3 * 10 ** 6), G=st.integers(1, 3000),
       L=st.integers(2, 131072), T=st.integers(1, 5000))
def test_plan_covers_rows_and_trees_within_limits(n, G, L, T):
    plan = tpk.predict_plan(n, G, L, T)
    _check_limits(plan, n, G, L, T)
    # every tree in exactly one stage
    ts = plan.trees_per_stage or T
    stages = [range(t0, min(t0 + ts, T)) for t0 in range(0, T, ts)]
    assert sorted(t for s in stages for t in s) == list(range(T))
    # a tree of L nodes goes to shared memory wherever two stages of one
    # tree fit beside the bins
    fits = G * plan.bins_stride + 2 * tpk.stage_bytes(1, L) <= khw.SMEM_BLOCK
    assert (plan.trees_per_stage > 0) == fits


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 10 ** 5), G=st.integers(1, 300),
       L=st.integers(2, 3000), T=st.integers(1, 300),
       budget=st.integers(64, khw.SMEM_BLOCK),
       threads=st.sampled_from([32, 64, 256, 512]),
       stage_trees=st.integers(1, 16))
def test_small_budget_plans_within_limits(n, G, L, T, budget, threads,
                                          stage_trees):
    plan = tpk._predict_plan(n, G, L, T, budget, threads, stage_trees)
    _check_limits(plan, n, G, L, T)
    assert plan.smem <= budget and plan.trees_per_stage <= stage_trees


def test_main_path_plan_pinned():
    """Phase full: 1M rows, 28 groups, 255 leaves, 500 trees.  Tiles of 512
    rows, one a thread, make 4.9 waves of three 512-thread blocks an SM
    (1954 tiles), eight trees a stage (3 KB a tree), the bins staged:
    63 744 bytes a block."""
    assert tpk.predict_plan(1_000_000, 28, 255, 500) == tpk.PredictPlan(
        rows_per_tile=512, threads=512, tiles=1954,
        trees_per_stage=8, bins_stride=528, smem=63744)
    # an 8191-leaf tree takes a stage of its own; a 16383-leaf tree does
    # not fit one: its walk words are read from global memory
    assert tpk.predict_plan(50_000, 28, 8191, 3).trees_per_stage == 1
    assert tpk.predict_plan(50_000, 28, 16383, 3).trees_per_stage == 0


def _c_enum(first):
    src = SRC.read_text()
    for body in re.findall(r"enum \{([^}]*)\}", src):
        names = [w.split("=")[0].strip() for w in body.split(",")
                 if w.strip()]
        if names and names[0] == first:
            return body, names
    raise AssertionError(f"no enum starting with {first} in {SRC}")


def _camel(field):
    return "k" + "".join(w.title() for w in field.split("_"))


def test_field_orders_follow_the_c_enums():
    _, plan = _c_enum("kRowsPerTile")
    assert plan == [_camel(f) for f in tpk.PREDICT_PLAN_FIELDS]
    _, words = _c_enum("kChildren16")
    assert words == [_camel(f) for f in tpk.PACKED_WORDS] + ["kPlanes"]
    body, bits = _c_enum("kNanShift")
    values = dict(re.findall(r"(k\w+)\s*=\s*(\d+)", body))
    assert bits == [_camel(f) for f, _ in tpk.FLAG_BITS]
    assert [int(values[_camel(f)]) for f, _ in tpk.FLAG_BITS] == \
        [b for _, b in tpk.FLAG_BITS]
    assert f"kBinMask = 0x{tpk.NO_BIN:x}" in SRC.read_text()
    # the threshold bin below the special-node bit, the sign bit
    assert f"kThrMask = 0x{(1 << tpk.THR_BITS) - 1:x}" in SRC.read_text()
    assert tpk.SPECIAL_BIT == 31 == 16 + tpk.THR_BITS
    assert f"kStageNodeBytes = {tpk.STAGE_NODE_BYTES}" in SRC.read_text()
    assert f"kMaxThreads = {tpk.MAX_THREADS}" in SRC.read_text()
