"""The Dataset surface of the port against the JAX package, on the CPU.

Each method of ``lightgbm_torch.Dataset`` beside the JAX package's on the
same numpy inputs: the raw data and its freeing, the reference chain and
``set_reference`` (a DataFrame's category codes made again through the
reference's lists), the categorical spec, the per-row fields, validation
sets, ``subset`` (dense and CSR; query sizes kept for query-aligned
indices), binary files (either package writes, the other loads and trains
to the same model text) and ``add_features_from``.  Bins are integers:
every comparison is exact; training runs on dyadic custom gradients.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.pallas import stream_kernel as jsk

import chip_smoke
import lightgbm_torch as lt

CPU = {"device_type": "cpu"}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)


def _data(n=1200, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.5, 1] = 0.0
    X[:, 5] = rs.randint(0, 5, n)
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + (X[:, 5] == 2)
         + 0.3 * rs.randn(n) > 0.5).astype(float)
    return X, y


def _pair(data, **kw):
    params = kw.pop("params", {})
    j = lgb.Dataset(data, params=dict(params), **kw)
    t = lt.Dataset(data, params={**params, **CPU}, **kw)
    return j, t


def _bins_equal(j, t):
    j.construct()
    t.construct()
    assert j.binned.group_features == t.binned.group_features
    assert np.asarray(j.binned.bins).tobytes() == t.binned.bins.tobytes()


def _dyadic_fobj(score, ds):
    g = np.clip(np.round(64 * (score - ds.get_label())) / 64, -127 / 64,
                127 / 64)
    return g.astype(np.float32), np.ones_like(g, dtype=np.float32)


_PARAMS = {"objective": "none", "num_leaves": 7, "max_splits_per_round": 4,
           "hist_precision": "single", "min_data_in_leaf": 5,
           "verbosity": -1}


def _text(mod, ds, iters=2):
    params = {**_PARAMS, **(CPU if mod is lt else {"hist_backend": "stream"})}
    bst = mod.Booster(params, ds)
    for _ in range(iters):
        bst.update(fobj=_dyadic_fobj)
    return bst.model_to_string().split("\nparameters:")[0]


@pytest.mark.parametrize("kind", ["dense", "frame", "csr"])
def test_get_data_and_free_raw_data(kind):
    """get_data returns what the Dataset was made from (the user's frame);
    with free_raw_data=True it raises once constructed, and so does
    subset."""
    X, y = _data()
    if kind == "frame":
        pd = pytest.importorskip("pandas")
        data = pd.DataFrame(X, columns=[f"f{i}" for i in range(6)])
    else:
        data = sp.csr_matrix(X) if kind == "csr" else X
    for free in (None, False, True):
        j, t = _pair(data, label=y, free_raw_data=free)
        assert type(j.get_data()) is type(t.get_data())
        assert t.get_data() is data or kind == "dense" or kind == "csr"
        j.construct()
        t.construct()
        if free:
            for ds in (j, t):
                with pytest.raises(Exception, match="raw data"):
                    ds.get_data()
                with pytest.raises(Exception, match="raw data was freed"):
                    ds.subset([0, 1, 2])
        else:
            got, want = t.get_data(), j.get_data()
            if kind == "csr":
                got, want = got.toarray(), want.toarray()
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_reference_chain_and_set_reference():
    X, y = _data()
    jt, tt = _pair(X, label=y, feature_name=[f"c{i}" for i in range(6)])
    jv, tv = _pair(X[:300] * 1.5, label=y[:300])
    jv.set_reference(jt)
    tv.set_reference(tt)
    assert tv.get_ref_chain() == {tv, tt}
    assert len(jv.get_ref_chain()) == 2
    _bins_equal(jv, tv)
    assert tv.feature_name() == jv.feature_name() == tt.feature_name()
    for ds, other in ((jv, lgb.Dataset(X[:50])),
                      (tv, lt.Dataset(X[:50], params=CPU))):
        with pytest.raises(Exception, match="constructed"):
            ds.set_reference(other)


def test_set_reference_realigns_dataframe_categories():
    """A frame's category codes are made again through the reference's
    lists when the reference is set after __init__ (the JAX package's
    tests/test_api_parity_extras.py:111 case)."""
    pd = pytest.importorskip("pandas")
    rs = np.random.RandomState(1)
    n = 600
    colors = rs.choice(["a", "b", "c"], n)
    x = rs.randn(n)
    y = (colors == "a").astype(np.float64)
    train_df = pd.DataFrame({
        "c": pd.Categorical(colors, categories=["a", "b", "c"]), "x": x})
    val_df = pd.DataFrame({
        "c": pd.Categorical(colors[:200], categories=["c", "b", "a"]),
        "x": x[:200]})
    jt, tt = _pair(train_df, label=y, categorical_feature=["c"])
    jv, tv = _pair(val_df, label=y[:200])
    jv.set_reference(jt)
    tv.set_reference(tt)
    _bins_equal(jv, tv)
    want = lt.Dataset(val_df, label=y[:200], reference=tt).construct()
    assert want.binned.bins.tobytes() == tv.binned.bins.tobytes()
    assert tv.feature_name() == tt.feature_name()


def test_set_categorical_feature():
    X, y = _data()
    j, t = _pair(X, label=y)
    for ds in (j, t):
        ds.set_categorical_feature([5])
    _bins_equal(j, t)
    assert t.binned.bin_mappers[5].bin_type == 1
    for ds in (j, t):
        ds.set_categorical_feature([5])      # unchanged: allowed
        with pytest.raises(Exception, match="categorical_feature"):
            ds.set_categorical_feature([4])


def test_fields():
    X, y = _data()
    j, t = _pair(X)
    rs = np.random.RandomState(2)
    w, s = rs.rand(len(X)), rs.randn(len(X))
    for ds in (j, t):
        assert ds.get_label() is None and ds.get_init_score() is None
        ds.set_label(y).set_weight(w).set_init_score(s)
        ds.set_field("position", np.arange(len(X)) % 3)
        ds.set_field("group", [600, 600])
    for f in ("label", "weight", "init_score", "position", "group"):
        np.testing.assert_array_equal(t.get_field(f), j.get_field(f))
        assert t.get_field(f).dtype == j.get_field(f).dtype
    np.testing.assert_array_equal(t.get_init_score(), j.get_init_score())
    np.testing.assert_array_equal(t.get_label_padded(1300),
                                  j.get_label_padded(1300))
    for ds in (j, t):
        with pytest.raises(Exception, match="Unknown field"):
            ds.get_field("nope")
        with pytest.raises(Exception, match="Unknown field"):
            ds.set_field("nope", y)
        ds.set_weight(None)
        assert ds.get_weight() is None


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_create_valid_and_subset(kind):
    X, y = _data()
    data = sp.csr_matrix(X) if kind == "csr" else X
    j, t = _pair(data, label=y, categorical_feature=[5])
    jv = j.create_valid(data[:300], label=y[:300])
    tv = t.create_valid(data[:300], label=y[:300])
    assert tv.reference is t and tv.params == t.params
    _bins_equal(jv, tv)
    idx = np.sort(np.random.RandomState(3).choice(len(X), 500,
                                                  replace=False))
    for parent_built in (False, True):
        if parent_built:
            j.construct()
            t.construct()
        js, ts = j.subset(idx), t.subset(idx)
        _bins_equal(js, ts)
        np.testing.assert_array_equal(ts.get_label(), y[idx])
        assert ts.reference is (t if parent_built else t)
    assert ts.binned.bins.tobytes() == t.binned.bins[idx].tobytes()


def test_subset_keeps_query_sizes():
    """Indices that take whole queries in increasing order keep their
    sizes; other indices drop the groups, as in the JAX package."""
    X, y = _data(600)
    group = np.array([100, 50, 150, 200, 100])
    j, t = _pair(X, label=y, group=group)
    qb = np.concatenate([[0], np.cumsum(group)])
    whole = np.concatenate([np.arange(qb[1], qb[2]), np.arange(qb[3],
                                                              qb[5])])
    part = np.arange(10, 220)
    for idx in (whole, part, whole[::-1]):
        jg, tg = j.subset(idx).get_group(), t.subset(idx).get_group()
        assert (jg is None) == (tg is None)
        if tg is not None:
            np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(t.subset(whole).get_group(), [50, 200, 100])


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_binary_files_across_packages(kind, tmp_path):
    """save_binary in either package; the file loads in both, with the same
    bins, mappers, fields and names, and trains to the same model text."""
    X, y = _data()
    data = (chip_smoke.csr_entries(X, np.random.RandomState(4),
                                   explicit_zeros=0.05)
            if kind == "csr" else X)
    w = np.random.RandomState(5).rand(len(X))
    j, t = _pair(data, label=y, weight=w, categorical_feature=[5],
                 feature_name=[f"v{i}" for i in range(6)])
    want = _text(lt, t)
    paths = {"jax": str(tmp_path / "j.bin"), "torch": str(tmp_path / "t.bin")}
    j.save_binary(paths["jax"])
    t.save_binary(paths["torch"])
    for writer, path in paths.items():
        jl = lgb.Dataset(path)
        tl = lt.Dataset(path, params=CPU)
        assert tl.binned.bins.tobytes() == t.binned.bins.tobytes()
        assert tl.feature_name() == t.feature_name() == jl.feature_name()
        np.testing.assert_array_equal(tl.get_weight(), w)
        assert tl.num_data() == len(X) and tl.num_feature() == 6
        for a, b in zip(tl.binned.bin_mappers, t.binned.bin_mappers):
            assert np.asarray(a.upper_bounds).tobytes() == \
                np.asarray(b.upper_bounds).tobytes()
        assert _text(lt, tl) == want, writer
        assert _text(lgb, jl) == want, writer
        with pytest.raises(Exception, match="raw data"):
            tl.get_data()
    # explicit arguments override the stored fields
    tl = lt.Dataset(paths["jax"], label=1 - y, params=CPU)
    np.testing.assert_array_equal(tl.get_label(), 1 - y)


def test_binary_file_errors(tmp_path):
    X, y = _data(200)
    t = lt.Dataset(X, label=y, params=CPU)
    good = tmp_path / "d.bin"
    t.save_binary(str(good))
    with pytest.raises(lt.LightGBMError, match="reference"):
        lt.Dataset(str(good), reference=t, params=CPU)
    v1 = tmp_path / "v1.bin"
    v1.write_bytes(b"LGBTPU.BIN.v1\n" + b"\0" * 32)
    with pytest.raises(lt.LightGBMError, match="v1 pickle"):
        lt.Dataset(str(v1), params=CPU)
    cut = tmp_path / "cut.bin"
    cut.write_bytes(good.read_bytes()[:60])
    with pytest.raises(lt.LightGBMError, match="binary dataset"):
        lt.Dataset(str(cut), params=CPU)
    csv = tmp_path / "d.csv"
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",")
    with pytest.raises(lt.LightGBMError, match="not yet ported"):
        lt.Dataset(str(csv), params=CPU)


def test_add_features_from():
    X, y = _data()
    rs = np.random.RandomState(6)
    extra = rs.randn(len(X), 3)
    j, t = _pair(X, label=y)
    j.construct()
    t.construct()
    j.add_features_from(lgb.Dataset(extra))
    t.add_features_from(lt.Dataset(extra, params=CPU))
    assert t.num_feature() == 9 and t.binned is None
    _bins_equal(j, t)
    assert t.feature_name() == j.feature_name()
    assert _text(lt, t) == _text(lgb, j)
    with pytest.raises(lt.LightGBMError, match="raw data"):
        t.add_features_from(lt.Dataset(sp.csr_matrix(extra), params=CPU))
