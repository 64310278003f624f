"""The port's host side against the JAX package: binning, routing layout,
model text, the host walk, the bin-space tree walk and the device rule.

The same inputs, made with numpy from a seed, go through both packages;
everything here is exact, so it is compared bit for bit."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu import device_data as jdd
from lightgbm_tpu.models.gbdt import _tree_to_device as j_tree_to_device
from lightgbm_tpu.ops.predict import _walk_one_tree as j_walk_one_tree
from lightgbm_tpu.pallas import predict_kernel as j_predict_kernel

import lightgbm_torch as lt
from lightgbm_torch.device_data import ROUTING_FIELDS
from lightgbm_torch.kernels.predict import tree_max_depth
from lightgbm_torch.models.gbdt import _tree_to_device as t_tree_to_device
from lightgbm_torch.ops.predict import _walk_one_tree as t_walk_one_tree

FIX = Path(__file__).parent / "fixtures"
CPU = {"device_type": "cpu"}


def make_mixed(n=3000, seed=0):
    """NaNs, a zero-heavy feature, a categorical feature with NaN, and a
    mutually exclusive sparse pair that EFB bundles."""
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 7)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    X[:, 2] = rs.randint(0, 6, n)
    X[rs.rand(n) < 0.05, 2] = np.nan
    a = rs.rand(n)
    X[:, 3] = np.where(a < 0.1, rs.rand(n) + 0.5, 0.0)
    X[:, 4] = np.where(a > 0.9, rs.rand(n) + 0.5, 0.0)
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] + np.isin(X[:, 2], [1, 4])
         + X[:, 3] - X[:, 4] + 0.3 * rs.randn(n))
    return X, y


BINNING_CASES = {
    "nan_cat_efb": {},
    "zero_as_missing": {"zero_as_missing": True},
    "max_bin_63": {"max_bin": 63},
}


@pytest.mark.parametrize("case", sorted(BINNING_CASES))
def test_binning_and_routing_match_reference(case):
    X, y = make_mixed()
    params = {"verbosity": -1, **BINNING_CASES[case]}
    jd = lgb.Dataset(X, label=y, categorical_feature=[2],
                     params=dict(params)).construct()
    td = lt.Dataset(X, label=y, categorical_feature=[2],
                    params={**params, **CPU}).construct()
    jb, tb = jd.binned, td.binned
    assert tb.bins.dtype == jb.bins.dtype
    np.testing.assert_array_equal(tb.bins, jb.bins)
    assert tb.group_features == jb.group_features
    if case == "nan_cat_efb":
        assert any(len(g) > 1 for g in tb.group_features), "EFB must bundle"
    for mj, mt in zip(jb.bin_mappers, tb.bin_mappers):
        assert mt.upper_bounds.tobytes() == mj.upper_bounds.tobytes()
        assert (mt.bin_type, mt.missing_type, mt.num_bins, mt.default_bin,
                mt.most_freq_bin) == (mj.bin_type, mj.missing_type,
                                      mj.num_bins, mj.default_bin,
                                      mj.most_freq_bin)
        np.testing.assert_array_equal(mt.categories, mj.categories)
    _, j_routing, j_bmax = jdd.build_layouts(jb)
    t_dd = td.device_data()
    assert t_dd.max_bins == j_bmax
    for name in ROUTING_FIELDS:
        np.testing.assert_array_equal(
            getattr(t_dd.routing, name).numpy(),
            np.asarray(getattr(j_routing, name)), err_msg=name)
    n_pad = -(-X.shape[0] // 256) * 256
    assert tuple(t_dd.bins.shape) == (n_pad, jb.num_groups)
    np.testing.assert_array_equal(t_dd.bins.numpy()[:X.shape[0]], jb.bins)


STOCK_MODELS = sorted(p.name for p in FIX.glob("stock_*.model"))


@pytest.mark.parametrize("name", STOCK_MODELS)
def test_model_text_round_trip_matches_reference(name):
    path = FIX / name
    assert (lt.Booster(model_file=path).model_to_string()
            == lgb.Booster(model_file=str(path)).model_to_string())


def _load_golden_X():
    rows = [[np.nan if v == "" else float(v) for v in line.split(",")]
            for line in (FIX / "golden_X.csv").read_text().splitlines()]
    return np.asarray(rows)


@pytest.mark.parametrize("name,cols", [("binary", 1), ("regression_cat", 1),
                                       ("multiclass", 3)])
def test_host_walk_reproduces_stock_predictions(name, cols):
    """The host float64 walk holds the stock fixtures to rtol 1e-9, as
    tests/test_golden.py holds the reference."""
    X = _load_golden_X()
    pred = lt.Booster(model_file=FIX / f"stock_{name}.model").predict(
        X, raw_score=True)
    expect = np.loadtxt(FIX / f"stock_pred_{name}.txt",
                        delimiter="\t" if cols > 1 else None)
    if cols > 1 and expect.ndim == 1:
        expect = expect.reshape(-1, cols)
    np.testing.assert_allclose(pred, expect, rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def mixed_models(tmp_path_factory):
    """A JAX-trained regression model over the mixed data, its file, and a
    zero-round booster of each package on the same training data."""
    X, y = make_mixed(n=1500, seed=4)
    params = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, "max_cat_to_onehot": 1}
    trained = lgb.train(params, lgb.Dataset(X, label=y,
                                            categorical_feature=[2]),
                        num_boost_round=6)
    path = str(tmp_path_factory.mktemp("mixed") / "model.txt")
    trained.save_model(path)
    j0 = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=[2]),
                   0, init_model=path)
    t0 = lt.train(params, lt.Dataset(X, label=y, categorical_feature=[2],
                                     params=CPU), 0, init_model=path)
    return j0, t0


def test_walk_one_tree_leaf_ids_match_reference(mixed_models):
    j0, t0 = mixed_models
    jdd_, tdd = j0.engine.dd, t0.engine.dd
    L = 15
    trees = t0._all_trees()
    assert any((np.asarray(t.decision_type) & 1).any() for t in trees)
    for jt, tt in zip(j0._all_trees(), trees):
        ja = j_tree_to_device(jt, L, jdd_.max_bins, j0.engine.train_data)
        jfields = (ja.split_feature, ja.threshold_bin, ja.dir_flags,
                   ja.left_child, ja.right_child, ja.cat_bitset)
        j_leaf = np.asarray(j_walk_one_tree(jfields, jdd_.bins, jdd_.routing,
                                            L))
        tfields, _ = t_tree_to_device(tt, L, tdd.max_bins,
                                      t0.engine.train_data, tdd.device)
        t_leaf = t_walk_one_tree(tfields, tdd.bins, tdd.routing,
                                 tree_max_depth(tt))
        np.testing.assert_array_equal(t_leaf.numpy(), j_leaf)


def test_load_init_model_score_matches_reference(mixed_models):
    """The training score rebuilt from the init model: the same float32
    leaf values added in the same order, so equal bit for bit."""
    j0, t0 = mixed_models
    np.testing.assert_array_equal(t0.engine.score.numpy(),
                                  np.asarray(j0.engine.score))
    assert t0.engine.iter_ == j0.engine.iter_ == 6


def test_default_device_without_gpu_raises(monkeypatch):
    """With no device_type and no CUDA device, every entry point that
    touches the device raises; nothing quietly runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = make_mixed(n=200)
    with pytest.raises(lt.LightGBMError, match="CUDA GPU"):
        lt.Dataset(X, label=y).construct()
    with pytest.raises(lt.LightGBMError, match="CUDA GPU"):
        lt.train({"objective": "regression"}, lt.Dataset(X, label=y), 0,
                 init_model=FIX / "stock_binary.model")
    with pytest.raises(lt.LightGBMError, match="CUDA GPU"):
        lt.Dataset(X, label=y, params={"device": "cuda"}).construct()


def test_training_rounds_raise_not_ported():
    """Training rounds run with a categorical feature, which once raised
    "not yet ported": five rounds on the 200 rows, one tree with a
    categorical node.  Six categories over 200 rows leave none with the
    default 100 rows of min_data_per_group, so it is 5 here."""
    X, y = make_mixed(n=200)
    bst = lt.train({"objective": "regression", "min_data_per_group": 5,
                    **CPU},
                   lt.Dataset(X, label=y, categorical_feature=[2]),
                   num_boost_round=5)
    assert bst.current_iteration() == 5
    assert any(t.num_cat > 0 for t in bst.engine.models)


def test_unported_objective_raises():
    """huber, which once raised "not yet ported" here, trains since every
    objective of the reference is ported; an unknown name raises as in the
    JAX package."""
    X, y = make_mixed(n=200)
    bst = lt.train({"objective": "huber", **CPU},
                   lt.Dataset(X, label=y, params=CPU), 2)
    assert bst.current_iteration() == 2
    assert "objective=huber alpha:0.9\n" in bst.model_to_string()
    with pytest.raises(ValueError, match="Unknown objective"):
        lt.train({"objective": "bogus", **CPU}, lt.Dataset(X, label=y), 0)
