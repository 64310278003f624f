"""Batch prediction of the port against the JAX package.

Small models are trained with the JAX package, saved as model text, and
served by both packages through ``train(params, Dataset, 0, init_model=...)``.
The JAX device path runs its Pallas kernel in interpret mode, as
tests/test_predict_kernel.py runs it; the port's device path runs the plain
PyTorch version of its CUDA kernel, because its tensors lie on the CPU.

Tolerances: the TPU kernel sums bf16 hi/lo leaf-value pairs and the port
sums exact float32 leaf values, so raw scores agree to rtol 1e-4 / atol 1e-5
(the JAX suite's own tolerance for the bf16 encoding), not bit for bit.
Probabilities are float32 transforms on both sides: atol 1e-6.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.basic import Booster as JBooster
from lightgbm_tpu.pallas import predict_kernel as jpk

import lightgbm_torch as lt
from lightgbm_torch.basic import Booster as TBooster
from lightgbm_torch.convert import booster_from_arrays
from lightgbm_torch.device_data import build_routing_np
from lightgbm_torch.kernels import build as tbuild
from lightgbm_torch.kernels import predict as tpk

CPU = {"device_type": "cpu"}
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _small_device_batches(monkeypatch):
    monkeypatch.setattr(jpk, "_INTERPRET", True)
    monkeypatch.setattr(JBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)
    monkeypatch.setattr(TBooster, "_DEVICE_PREDICT_MIN_ROWS", 100)


def _binary_nan(rs):
    X = rs.randn(1500, 8)
    X[rs.rand(1500) < 0.1, 0] = np.nan
    y = (2 * X[:, 1] + np.nan_to_num(X[:, 0]) + 0.3 * rs.randn(1500)
         > 0).astype(float)
    Xt = rs.randn(600, 8)
    Xt[rs.rand(600) < 0.1, 0] = np.nan
    return X, y, Xt, {"objective": "binary"}, 8, {}


def _multiclass(rs):
    X = rs.randn(1500, 6)
    y = ((X[:, 0] + X[:, 1] > 0).astype(int)
         + (X[:, 2] > 0.5).astype(int)).astype(float)
    return (X, y, rs.randn(600, 6),
            {"objective": "multiclass", "num_class": 3}, 5, {})


def _categorical(rs):
    n = 1200
    X = 0.3 * rs.randn(n, 5)
    X[:, 3] = rs.randint(0, 6, n)
    X[rs.rand(n) < 0.05, 3] = np.nan
    y = (3.0 * np.isin(X[:, 3], [1, 4]) + X[:, 0]
         + 0.1 * rs.randn(n) > 1.0).astype(float)
    Xt = X[:600].copy()
    # adversarial category values on top of the seen 0..5
    Xt[rs.rand(600) < 0.1, 3] = np.nan
    Xt[rs.rand(600) < 0.05, 3] = 77.0        # unseen
    Xt[rs.rand(600) < 0.05, 3] = -3.0        # negative -> missing
    Xt[rs.rand(600) < 0.05, 3] = 2.7         # truncates to category 2
    Xt[rs.rand(600) < 0.02, 3] = 1e12        # far past any bitset span
    return (X, y, Xt, {"objective": "binary", "max_cat_to_onehot": 1}, 6,
            {"categorical_feature": [3]})


def _binary_early_stop(rs):
    X = rs.randn(1200, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    return X, y, X[:600].copy(), {"objective": "binary"}, 20, {}


MAKERS = {"binary_nan": _binary_nan, "multiclass": _multiclass,
          "categorical": _categorical, "binary_early_stop": _binary_early_stop}
ES = dict(pred_early_stop=True, pred_early_stop_freq=4,
          pred_early_stop_margin=2.0)


@dataclasses.dataclass
class Case:
    name: str
    X: np.ndarray
    Xt: np.ndarray
    params: dict
    ds_kw: dict
    path: str
    jax0: object          # JAX zero-round booster on the model text
    port0: object         # the port's zero-round booster on the model text
    predict_kw: dict


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = {}
    for i, (name, make) in enumerate(sorted(MAKERS.items())):
        X, y, Xt, obj, rounds, ds_kw = make(np.random.RandomState(30 + i))
        params = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
                  **obj}
        trained = lgb.train(params, lgb.Dataset(X, label=y, **ds_kw),
                            num_boost_round=rounds)
        path = str(tmp_path_factory.mktemp(name) / "model.txt")
        trained.save_model(path)
        jax0 = lgb.train(params, lgb.Dataset(X, label=y, **ds_kw), 0,
                         init_model=path)
        port0 = lt.train(params, lt.Dataset(X, label=y, params=CPU, **ds_kw),
                         0, init_model=path)
        out[name] = Case(name, X, Xt, params, ds_kw, path, jax0, port0,
                         ES if name == "binary_early_stop" else {})
    return out


def _host(booster, X, **kw):
    """Prediction through the host float64 walk."""
    cls = type(booster)
    old = cls._DEVICE_PREDICT_MIN_ROWS
    cls._DEVICE_PREDICT_MIN_ROWS = 10 ** 9
    try:
        return booster.predict(X, **kw)
    finally:
        cls._DEVICE_PREDICT_MIN_ROWS = old


def _port_device_path_taken(case):
    bst = case.port0
    use, k, _, _ = bst._resolve_tree_slice(0, None)
    es = (4, 2.0) if case.predict_kw else None
    return bst._device_predict_inputs(case.Xt, use, k, es) is not None


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_raw_scores_match_jax_device_and_host(cases, name):
    c = cases[name]
    assert _port_device_path_taken(c)
    kw = dict(raw_score=True, **c.predict_kw)
    p_port = c.port0.predict(c.Xt, **kw)
    p_jax_dev = c.jax0.predict(c.Xt, **kw)
    p_jax_host = _host(c.jax0, c.Xt, **kw)
    np.testing.assert_allclose(p_port, p_jax_dev, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_port, p_jax_host, rtol=RTOL, atol=ATOL)
    # the port's own host walk is the reference's host walk, exactly
    np.testing.assert_array_equal(_host(c.port0, c.Xt, **kw), p_jax_host)
    if c.predict_kw:
        full = c.port0.predict(c.Xt, raw_score=True)
        assert np.abs(full - p_port).max() > 1e-6, "early stop must bite"


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_probabilities_match_jax(cases, name):
    c = cases[name]
    p_port = c.port0.predict(c.Xt, **c.predict_kw)
    p_jax = c.jax0.predict(c.Xt, **c.predict_kw)
    assert p_port.shape == p_jax.shape
    np.testing.assert_allclose(p_port, p_jax, rtol=0, atol=1e-6)


def _jax_tables_decoded(c, cls):
    """The JAX tables of one class, with every 7-bit digit pair and the
    bf16 hi/lo leaf pair decoded, and the categorical words per node."""
    eng = c.jax0.engine
    use = c.jax0._all_trees()
    k = c.jax0.num_model_per_iteration()
    trees = use[cls::k]
    routing_np = {n: np.asarray(getattr(eng.dd.routing, n))
                  for n in ("feat_group", "span_start", "default_bin",
                            "bundled", "nan_bin", "num_bins", "mzero_bin")}
    L = max(max(t.num_leaves for t in use), 2)
    tabs, cat_tab = jpk.build_predict_tables(
        trees, routing_np, L, bin_mappers=eng.train_data.binned.bin_mappers)
    ftabs = tabs.reshape(len(trees), jpk.ROWS_PER_TREE, L)
    tabs = ftabs.astype(np.int64)

    def two(lo, hi):
        return tabs[:, lo] + 128 * tabs[:, hi]

    fields = {
        "group": 4 * two(jpk.P_WORD_LO, jpk.P_WORD_HI)
        + tabs[:, jpk.P_SHIFT] // 8,
        "span_start": tabs[:, jpk.P_SPAN], "default_bin": tabs[:, jpk.P_DEFBIN],
        "bundled": tabs[:, jpk.P_BUNDLED], "has_nan": tabs[:, jpk.P_HASNAN],
        "nan_bin": tabs[:, jpk.P_NANBIN], "has_mz": tabs[:, jpk.P_HASMZ],
        "mz_bin": tabs[:, jpk.P_MZBIN], "num_bins": tabs[:, jpk.P_NBINS],
        "threshold_bin": tabs[:, jpk.P_THR],
        "default_left": tabs[:, jpk.P_DEFLEFT], "is_cat": tabs[:, jpk.P_ISCAT],
        "left": two(jpk.P_LEFT_LO, jpk.P_LEFT_HI),
        "right": two(jpk.P_RIGHT_LO, jpk.P_RIGHT_HI),
    }
    leaf =ftabs[:, jpk.P_LEAF_HI] + ftabs[:, jpk.P_LEAF_LO]
    D = jpk.CAT_DIGITS
    digits = cat_tab.reshape(-1, D, cat_tab.shape[1]).astype(np.int64)
    words = sum(digits[:, d] << (7 * d) for d in range(D)).astype(np.uint32)
    catb = two(jpk.P_CATB_LO, jpk.P_CATB_HI)
    return trees, L, fields, leaf, words, catb


@pytest.mark.parametrize("name", ["binary_nan", "categorical", "multiclass"])
def test_tables_match_jax_field_by_field(cases, name):
    c = cases[name]
    k = c.jax0.num_model_per_iteration()
    tb = c.port0.engine.train_data.binned
    routing_np, _ = build_routing_np(tb)
    for cls in range(k):
        trees, L, jf, jleaf, jwords, jcatb = _jax_tables_decoded(c, cls)
        t = tpk.build_predict_tables(trees, routing_np, L, tb.bin_mappers)
        for fname, jv in jf.items():
            np.testing.assert_array_equal(
                t.nodes[..., tpk.NODE_FIELDS.index(fname)], jv, err_msg=fname)
        # exact float32 leaf values; the JAX pair is the bf16 split of them
        exact = np.zeros_like(t.leaf_value)
        for i, tr in enumerate(trees):
            exact[i, :tr.num_leaves] = tr.leaf_value[:tr.num_leaves]
        np.testing.assert_array_equal(t.leaf_value, exact)
        np.testing.assert_allclose(jleaf, t.leaf_value, rtol=2 ** -16,
                                   atol=1e-30)
        # categorical words: the same bin-domain bitset behind every node
        is_cat = t.nodes[..., tpk.F_ISCAT] > 0
        assert is_cat.any() == (name == "categorical")
        for ti, ni in zip(*np.nonzero(is_cat)):
            nb = int(t.nodes[ti, ni, tpk.F_NBINS])
            nw = (nb + 1 + 31) // 32
            pb = int(t.nodes[ti, ni, tpk.F_CATBASE])
            jb = int(jcatb[ti, ni])
            np.testing.assert_array_equal(t.cat_words[pb:pb + nw],
                                          jwords[ti, jb:jb + nw])
        assert list(t.depths) == [jpk.tree_max_depth(tr) for tr in trees]


def test_plain_walk_sums_tables_in_tree_order(cases):
    """predict_stream on CPU tensors is the plain version, and it adds the
    exact float32 leaf values in tree order: bit-equal to a float32 sum of
    the host walk's per-tree outputs."""
    c = cases["binary_nan"]
    bst = c.port0
    use, k, _, _ = bst._resolve_tree_slice(0, None)
    inp = bst._device_predict_inputs(c.Xt, use, k)
    nodes, lv, words, depths = inp.classes[0]
    got = tpk.predict_stream(inp.bins_T, nodes, lv, words, depths)
    assert got.dtype == torch.float32 and got.shape == (len(c.Xt),)
    want = np.zeros(len(c.Xt), np.float32)
    for t in use:
        want += t.predict_raw(c.Xt).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_predict_stream_refuses_other_devices(cases):
    c = cases["binary_nan"]
    bst = c.port0
    use, k, _, _ = bst._resolve_tree_slice(0, None)
    inp = bst._device_predict_inputs(c.Xt, use, k)
    nodes, lv, words, depths = inp.classes[0]
    meta = inp.bins_T.to("meta")
    with pytest.raises(lt.LightGBMError, match="no kernel for device"):
        tpk.predict_stream(meta, nodes, lv, words, depths)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent switch to the plain
    version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tbuild.os.path, "isfile", lambda p: False)
    with pytest.raises(lt.LightGBMError, match="nvcc not found"):
        tbuild.nvcc()


_CTYPE_OF = {"const uint8_t*": "c_void_p", "const void*": "c_void_p",
             "const int32_t*": "c_void_p",
             "const int8_t*": "c_void_p",
             "const float*": "c_void_p", "float*": "c_void_p",
             "const double*": "c_void_p", "double*": "c_void_p",
             "void*": "c_void_p",
             "int32_t*": "c_void_p", "int64_t*": "c_void_p",
             "const int64_t*": "c_void_p",
             "cudaStream_t": "c_void_p", "int64_t": "c_int64",
             "int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("name", sorted(tbuild.SIGNATURES))
def test_c_signature_matches_argtypes(name):
    """The ctypes argtypes kept in kernels/build.py follow the extern "C"
    entry point of the kernel's source, argument by argument."""
    import ctypes
    import re
    symbol, argtypes = tbuild.SIGNATURES[name]
    src = (Path(tbuild.__file__).parent / tbuild.SOURCES[name]).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"no extern \"C\" {symbol} in {tbuild.SOURCES[name]}"
    params = [p.split() for p in m.group(1).split(",")]
    params = [" ".join(p[:-1]) for p in params]     # the type, less the name
    assert [getattr(ctypes, _CTYPE_OF[p]) for p in params] == argtypes


def test_leaf_path_sums_follow_each_leafs_ancestors(cases):
    """Per-leaf path sums (tree depths, and the node weights chip_smoke.py
    counts work with) equal a walk up the parent links of every leaf."""
    bst = cases["categorical"].port0
    rs = np.random.RandomState(5)
    for t in bst._all_trees():
        ni = t.num_leaves - 1
        w = rs.randint(1, 9, max(ni, 1)).astype(np.float64)
        parent = {}
        for n in range(ni):
            for c in (int(t.left_child[n]), int(t.right_child[n])):
                parent[c] = n
        want = np.zeros(max(t.num_leaves, 1))
        depth = np.zeros(max(t.num_leaves, 1))
        for leaf in range(t.num_leaves if ni else 0):
            n = parent[~leaf]
            while True:
                want[leaf] += w[n]
                depth[leaf] += 1
                if n == 0:
                    break
                n = parent[n]
        np.testing.assert_array_equal(tpk.leaf_path_sums(t, w), want)
        np.testing.assert_array_equal(tpk.leaf_path_sums(t), depth)
        assert tpk.tree_max_depth(t) == max(1, int(depth.max()))


def test_device_inputs_report_stage_times(cases):
    c = cases["binary_nan"]
    use, k, _, _ = c.port0._resolve_tree_slice(0, None)
    times = {}
    assert c.port0._device_predict_inputs(c.Xt, use, k, times=times)
    assert sorted(times) == ["binning", "tables", "upload"]
    assert all(v >= 0.0 for v in times.values())


def test_device_path_gates(cases):
    """Kept gates: small batches, early stop with k > 1, no engine."""
    mc = cases["multiclass"].port0
    use, k, _, _ = mc._resolve_tree_slice(0, None)
    Xt = cases["multiclass"].Xt
    assert mc._device_predict_inputs(Xt, use, k, es=(4, 2.0)) is None
    assert mc._device_predict_inputs(Xt[:50], use, k) is None
    loaded = lt.Booster(model_file=cases["binary_nan"].path)
    use1, k1, _, _ = loaded._resolve_tree_slice(0, None)
    assert loaded._device_predict_inputs(cases["binary_nan"].Xt, use1,
                                         k1) is None


def test_slice_end_to_end_public_entry_points(tmp_path):
    """Dataset -> train(0, init_model) -> predict -> save_model ->
    Booster(model_file) -> predict, each output held against the JAX
    package's."""
    rs = np.random.RandomState(77)
    X = rs.randn(1500, 7)
    X[rs.rand(1500) < 0.1, 2] = np.nan
    X[:, 4] = rs.randint(0, 5, 1500)
    y = (X[:, 0] - np.nan_to_num(X[:, 2]) + np.isin(X[:, 4], [0, 3])
         + 0.2 * rs.randn(1500) > 0.5).astype(float)
    Xt = rs.randn(700, 7)
    Xt[:, 4] = rs.randint(-1, 7, 700)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "max_cat_to_onehot": 1}
    src = str(tmp_path / "src.txt")
    lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[4]),
              num_boost_round=6).save_model(src)

    j = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[4]),
                  0, init_model=src)
    t = lt.train(params, lt.Dataset(X, label=y, categorical_feature=[4],
                                    params=CPU), 0, init_model=src)
    np.testing.assert_allclose(t.predict(Xt, raw_score=True),
                               j.predict(Xt, raw_score=True),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.predict(Xt), j.predict(Xt), rtol=0,
                               atol=1e-6)
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    j.save_model(jpath)
    t.save_model(tpath)
    jl, tl = lgb.Booster(model_file=jpath), lt.Booster(model_file=tpath)
    assert tl.model_to_string() == jl.model_to_string()
    np.testing.assert_array_equal(tl.predict(Xt, raw_score=True),
                                  jl.predict(Xt, raw_score=True))
    np.testing.assert_allclose(tl.predict(Xt), jl.predict(Xt), rtol=0,
                               atol=1e-6)


def test_booster_from_arrays_matches_model_text(cases):
    """The JAX booster's trees carried across as arrays, with no model file
    between, predict as the model-text route does."""
    c = cases["categorical"]
    dicts = [dataclasses.asdict(t) for t in c.jax0._all_trees()]
    ds = lt.Dataset(c.X, label=c.port0.train_set.get_label(), params=CPU,
                    **c.ds_kw)
    bst = booster_from_arrays(dicts, ds, c.params)
    np.testing.assert_array_equal(bst.predict(c.Xt, raw_score=True),
                                  c.port0.predict(c.Xt, raw_score=True))
    assert bst.model_to_string() == c.port0.model_to_string()
