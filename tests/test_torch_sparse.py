"""SciPy sparse input of the port against the JAX package, on the CPU.

A CSR or CSC matrix is a Dataset as it is: the mappers and EFB groups come
from its sampled stored values on the host (the port's copy of the JAX
package's sparse functions), the bins from ``kernels/bin_csr.py`` (its
plain version on the CPU).  Bins are integers and the mappers float64
NumPy in both packages: every comparison is exact.  Training on dyadic
custom gradients is exact in float32, so the model text is byte for byte
the JAX stream backend's.  The adversarial matrices store explicit zeros
(and -0.0), rows in unsorted order and duplicate (row, column) entries
(``chip_smoke.csr_entries``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu import binning as jbin
from lightgbm_tpu.pallas import stream_kernel as jsk

import chip_smoke
import lightgbm_torch as lt
from lightgbm_torch import basic as tbasic
from lightgbm_torch import binning as tbin
from lightgbm_torch.kernels import bin_csr as kbc
from lightgbm_torch.kernels import bin_rows as kbr
from lightgbm_torch.kernels import build
from lightgbm_torch.kernels.layout import bins_to_numpy

CPU = {"device_type": "cpu"}
SRC = Path(kbc.__file__).resolve().parent / "csrc" / "bin_csr.cu"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _dense(n, seed):
    """Numeric columns with NaN, +-inf, -0.0, +-5e-324 and half their rows
    zero; a categorical column (categories 0-11, 0 implicit, NaN and
    negative values); a one-hot block of 12 columns that EFB bundles; an
    empty column; a label."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n, 18))
    num = rs.randn(n, 4)
    num[rs.rand(n, 4) < 0.5] = 0.0
    num[rs.rand(n, 4) < 0.05] = np.nan
    num[rs.rand(n, 4) < 0.01] = np.inf
    num[rs.rand(n, 4) < 0.01] = -np.inf
    num[rs.rand(n, 4) < 0.01] = 5e-324
    num[rs.rand(n, 4) < 0.01] = -5e-324
    X[:, :4] = num
    cat = rs.randint(0, 12, n).astype(float)
    cat[rs.rand(n) < 0.05] = np.nan
    cat[rs.rand(n) < 0.03] = -1.0
    X[:, 4] = cat
    hot = rs.randint(0, 12, n)
    on = rs.rand(n) < 0.8
    X[np.arange(n)[on], 5 + hot[on]] = 1.0
    y = ((np.nan_to_num(np.clip(X[:, 0], -3, 3)) + (hot % 3 == 0)
          + np.isin(cat, [1, 2]) + 0.5 * rs.randn(n)) > 0.8).astype(float)
    return X, y


def _csr(X, seed, dups):
    return chip_smoke.csr_entries(X, np.random.RandomState(seed + 1),
                                  explicit_zeros=0.05,
                                  dups=0.05 if dups else 0.0, shuffled=0.1)


def _mappers_equal(a, b):
    for ma, mb in zip(a, b, strict=True):
        for f in ("bin_type", "missing_type", "num_bins", "default_bin",
                  "most_freq_bin", "min_val", "max_val"):
            assert getattr(ma, f) == getattr(mb, f), f
        assert np.asarray(ma.upper_bounds).tobytes() == \
            np.asarray(mb.upper_bounds).tobytes()
        assert np.array_equal(ma.categories, mb.categories)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("extra", [{}, {"zero_as_missing": True,
                                        "bin_construct_sample_cnt": 700}],
                         ids=["default", "zero_as_missing_sampled"])
def test_sparse_dataset_equals_jax(fmt, extra):
    """Mappers, groups and bins of a CSR / CSC Dataset, duplicates
    included, byte-equal to the JAX package's.  The sampled case stores no
    duplicates: a sampled column can then hold more entries than sampled
    rows, where the JAX package's zero count goes negative and raises."""
    X, y = _dense(2000, 1)
    data = _csr(X, 1, dups=not extra)
    data = data if fmt == "csr" else data.tocsc()
    kw = {"categorical_feature": [4]}
    params = {"verbosity": -1, **extra}
    j = lgb.Dataset(data, label=y, params=dict(params), **kw).construct()
    t = lt.Dataset(data, label=y, params={**params, **CPU}, **kw).construct()
    _mappers_equal(t.binned.bin_mappers, j.binned.bin_mappers)
    assert t.binned.group_features == j.binned.group_features
    assert any(len(g) > 1 for g in t.binned.group_features)
    assert t.binned.bins.dtype == np.asarray(j.binned.bins).dtype
    assert t.binned.bins.tobytes() == np.asarray(j.binned.bins).tobytes()


def test_sparse_mappers_count_implicit_zeros():
    """find_bin_mappers_sparse counts a numeric column's implicit zeros
    instead of making them, except next to +-5e-324: equal to the JAX
    package's on columns that hold those values, NaN and -0.0."""
    rs = np.random.RandomState(4)
    n = 3000
    X = np.zeros((n, 6))
    for f, extra in enumerate([[], [5e-324], [-5e-324], [np.nan, -0.0],
                               [5e-324, -5e-324, 1e-300], []]):
        pick = rs.rand(n) < 0.3
        X[pick, f] = np.round(rs.randn(int(pick.sum())), 2)
        for i, v in enumerate(extra):
            X[i::17, f] = v
    data = _csr(X, 4, dups=False)
    for kw in ({}, {"zero_as_missing": True}, {"use_missing": False}):
        want = jbin.find_bin_mappers_sparse(data, 255, 3, sample_cnt=2000,
                                            **kw)
        got = tbin.find_bin_mappers_sparse(data, 255, 3, sample_cnt=2000,
                                           **kw)
        _mappers_equal(got, want)


@pytest.fixture(scope="module")
def cases():
    return list(chip_smoke.csr_adversarial_cases(0, scale=0.02))


def _jax_mappers(ms):
    return [jbin.BinMapper(**{k: getattr(m, k) for k in (
        "upper_bounds", "bin_type", "missing_type", "categories",
        "num_bins", "default_bin", "most_freq_bin", "min_val", "max_val")})
        for m in ms]


@pytest.mark.parametrize("label", [c[0] for c in chip_smoke.CSR_ADVERSARIAL])
def test_bin_csr_plain_equals_host(label, cases):
    """The plain bin_csr, in one upload and in small chunks (launches at
    row0 > 0), byte-equal to the port's and the JAX package's
    ``construct_binned_sparse`` (Dataset form) or, in the predict form, to
    ``bin_rows_plain`` of the dense rows."""
    _, csr, X, ms, gs, sentinel, transpose, _ = next(
        c for c in cases if c[0] == label)
    gs = tbin.device_group_order(gs, ms)
    tables = kbr.bin_tables(ms, gs, torch.device("cpu"), sentinel=sentinel)
    outs = [bins_to_numpy(kbc.bin_csr_matrix(csr, tables, transpose=transpose,
                                             chunk_bytes=chunk))
            for chunk in (kbc.CHUNK_BYTES, 12 * 300)]
    assert outs[0].tobytes() == outs[1].tobytes()
    got = outs[0].T if transpose else outs[0]
    if sentinel:
        want = bins_to_numpy(kbr.bin_matrix(X, tables, transpose=True)).T
    else:
        want = tbin.construct_binned_sparse(csr, ms, gs).bins
        jwant = jbin.construct_binned_sparse(csr, _jax_mappers(ms), gs).bins
        assert np.asarray(jwant).tobytes() == want.tobytes()
        if X is not None:
            assert tbin.construct_binned(X, ms, gs).bins.tobytes() == \
                want.tobytes()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_bin_csr_zero_bins():
    """Every cell starts at its group's bin of 0.0: a lone numeric
    feature's, a lone categorical feature's (category 0 present or not,
    the predict form's sentinel), a bundle's 0."""
    X = np.array([[-1.0, 0.0, 3.0, 1.0, 0.0],
                  [2.0, 1.0, 0.0, 0.0, 1.0],
                  [0.5, 2.0, 5.0, 1.0, 0.0]])
    ms = [tbin.BinMapper.find_numerical(X[:, 0], 15, 1, True, False),
          tbin.BinMapper.find_categorical(X[:, 1], 15, 1, True),
          tbin.BinMapper.find_categorical(X[:, 2], 15, 1, True),
          tbin.BinMapper.find_numerical(X[:, 3], 15, 1, True, False),
          tbin.BinMapper.find_numerical(X[:, 4], 15, 1, True, False)]
    gs = [[0], [1], [2], [3, 4]]
    for sentinel in ([], [1, 2]):
        tables = kbr.bin_tables(ms, gs, torch.device("cpu"),
                                sentinel=sentinel)
        empty = sp.csr_matrix((4, 5))
        got = bins_to_numpy(kbc.bin_csr_matrix(empty, tables))
        want = kbr.bin_rows_plain(
            torch.zeros((4, 5), dtype=torch.float64), tables,
            torch.zeros((4, 4), dtype=kbr.storage_dtype(tables.out_bytes)))
        assert got.tobytes() == bins_to_numpy(want).tobytes()
        assert list(kbc.zero_bins(tables)) == list(got[0])


def _jax_text(data, y, params, iters):
    jb = lgb.Booster({**params, "hist_backend": "stream"},
                     lgb.Dataset(data, label=y, params=dict(params),
                                 categorical_feature=[4]))
    for _ in range(iters):
        jb.update(fobj=_dyadic_fobj)
    return jb.model_to_string().split("\nparameters:")[0]


def _port_text(data, y, params, iters):
    tb = lt.Booster({**params, **CPU},
                    lt.Dataset(data, label=y, params={**params, **CPU},
                               categorical_feature=[4]))
    for _ in range(iters):
        tb.update(fobj=_dyadic_fobj)
    return tb.model_to_string().split("\nparameters:")[0]


def _dyadic_fobj(score, ds):
    g = np.clip(np.round(64 * (score - ds.get_label())) / 64, -127 / 64,
                127 / 64)
    return g.astype(np.float32), np.ones_like(g, dtype=np.float32)


@pytest.mark.parametrize("zam", [False, True])
def test_dyadic_training_from_csr_matches_jax_and_dense(zam):
    """Dyadic training from a CSR Dataset: the model text equals the JAX
    stream backend's from the same matrix and the port's from the dense
    rows, byte for byte."""
    X, y = _dense(1500, 2)
    data = _csr(X, 2, dups=False)
    params = {"objective": "none", "num_leaves": 15,
              "max_splits_per_round": 8, "hist_precision": "single",
              "min_data_in_leaf": 5, "zero_as_missing": zam,
              "verbosity": -1}
    text = _port_text(data, y, params, 2)
    assert text == _port_text(X, y, params, 2)
    assert text == _jax_text(data, y, params, 2)


@pytest.fixture(scope="module")
def model():
    X, y = _dense(3000, 3)
    ds = lt.Dataset(_csr(X, 3, dups=False), label=y, params=CPU,
                    categorical_feature=[4])
    bst = lt.train({"objective": "binary", "num_leaves": 15, "verbosity": -1,
                    "max_cat_to_onehot": 1, **CPU}, ds, 4)
    return bst, _dense(1200, 4)[0]


@pytest.mark.parametrize("device_rows", [100, 10 ** 9],
                         ids=["device_path", "host_walk"])
@pytest.mark.parametrize("kw", [{"raw_score": True}, {"pred_leaf": True},
                                {"pred_contrib": True}, {}],
                         ids=["raw", "leaf", "contrib", "converted"])
def test_sparse_predict_equals_dense(device_rows, kw, model, monkeypatch):
    """``predict`` of CSR rows equals that of the dense rows, byte for
    byte, below and above the device path's minimum; above it (raw scores
    and leaves) the whole batch is binned by bin_csr and walked by K1, the
    host walk never called; ``pred_contrib`` keeps the dense slabs."""
    bst, Xt = model
    monkeypatch.setattr(tbasic.Booster, "_DEVICE_PREDICT_MIN_ROWS",
                        device_rows)
    binned, walks = [], []
    real_binner, real_walk = tbasic.bin_csr_matrix, tbasic._host_predict
    monkeypatch.setattr(tbasic, "bin_csr_matrix", lambda *a, **k: (
        binned.append(a[0].shape[0]), real_binner(*a, **k))[1])
    monkeypatch.setattr(tbasic, "_host_predict", lambda *a, **k: (
        walks.append(a[0].shape[0]), real_walk(*a, **k))[1])
    csr = _csr(Xt, 5, dups=False)
    got = bst.predict(csr, **kw)
    device = device_rows == 100 and "pred_contrib" not in kw
    assert binned == ([len(Xt)] if device else [])
    assert (not walks) if device else "pred_leaf" in kw or \
        "pred_contrib" in kw or walks == [len(Xt)]
    want = bst.predict(Xt, **kw)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_estimators_accept_sparse_x():
    """LGBMClassifier fits and predicts SciPy rows as it does the dense
    rows."""
    X, y = _dense(1500, 6)
    csr = _csr(X, 6, dups=False)
    kw = {"n_estimators": 3, "num_leaves": 7, "verbosity": -1, **CPU}
    a = lt.LGBMClassifier(**kw).fit(csr, y)
    b = lt.LGBMClassifier(**kw).fit(X, y)
    assert a.booster_.model_to_string() == b.booster_.model_to_string()
    assert a.predict_proba(csr).tobytes() == b.predict_proba(X).tobytes()
    r = lt.LGBMRegressor(**kw).fit(csr.tocsc(), y)
    assert r.predict(csr).tobytes() == \
        lt.LGBMRegressor(**kw).fit(X, y).predict(X).tobytes()


def test_bin_csr_wrapper_refuses_cpu_tensors_and_bad_shapes():
    X, _ = _dense(50, 7)
    csr = _csr(X, 7, dups=False)
    ms = tbin.find_bin_mappers(X, 15, 1)
    gs = [[f] for f in range(X.shape[1])]
    tables = kbr.bin_tables(ms, gs, torch.device("cpu"))
    ptr = torch.from_numpy(csr.indptr.astype(np.int64))
    ind = torch.from_numpy(csr.indices.astype(np.int32))
    val = torch.from_numpy(csr.data.astype(np.float64))
    zeros = torch.from_numpy(kbc.zero_bins(tables))
    out = torch.empty((50, len(gs)), dtype=torch.uint8)
    with pytest.raises(lt.LightGBMError, match="CUDA tensors"):
        kbc.bin_csr_cuda(ptr, ind, val, tables, zeros, out)
    with pytest.raises(lt.LightGBMError, match="shapes do not agree"):
        kbc.bin_csr_plain(ptr, ind, val, tables, zeros, out[:10])
    with pytest.raises(lt.LightGBMError, match="columns"):
        kbc.bin_csr_matrix(csr[:, :5], tables)


def _c_enum(first):
    src = SRC.read_text() + SRC.with_name("bin_value.cuh").read_text()
    body = [b for b in re.findall(r"enum \{([^}]*)\}", src) if first in b][0]
    return [w.strip() for w in body.split(",") if w.strip()]


def test_bin_csr_fields_follow_the_c_enums():
    """bin_csr.cu reads bin_rows' tables through csrc/bin_value.cuh: the
    record fields and flags there are those of kernels/bin_rows.py, and
    the entry point takes the arguments build.SIGNATURES gives it."""
    camel = ["k" + "".join(w.title() for w in f.split("_"))
             for f in kbr.FEAT_FIELDS]
    assert _c_enum("kColumn") == camel + ["kFeatFields"]
    src = SRC.read_text()
    assert '#include "bin_value.cuh"' in src
    flags = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                            SRC.with_name("bin_value.cuh").read_text()))
    assert (int(flags["kCategorical"]), int(flags["kMissingNan"]),
            int(flags["kSentinel"]), int(flags["kBundled"])) == (
        kbr.CATEGORICAL, kbr.MISSING_NAN_FLAG, kbr.SENTINEL, kbr.BUNDLED)
    sig = re.search(r'extern "C" int lgbt_bin_csr\(([^)]*)\)', src).group(1)
    assert sig.count(",") + 1 == len(build.SIGNATURES["bin_csr"][1])
    assert build.SOURCES["bin_csr"] == "csrc/bin_csr.cu"


def test_chunk_rows_cover_every_row_once():
    indptr = np.concatenate([[0], np.cumsum([0, 5, 400, 1, 0, 30, 2])])
    for chunk in (12, 12 * 5, 12 * 31, 12 * 10 ** 6):
        spans = kbc.chunk_rows(indptr, chunk)
        assert spans[0][0] == 0 and spans[-1][1] == len(indptr) - 1
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in
                   zip(spans, spans[1:]))
        for r0, r1 in spans:
            assert (indptr[r1] - indptr[r0]) * 12 <= chunk or r1 == r0 + 1
