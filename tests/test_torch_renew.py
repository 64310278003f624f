"""Leaf renewal in the port against the JAX package, on the CPU:
``_leaf_percentile`` and the renewing objectives' training (regression_l1,
quantile, mape).

The same numpy inputs go through ``lightgbm_tpu`` and ``lightgbm_torch``
(``device_type="cpu"``: the kernels' plain versions; the JAX stream and
pallas kernels in Pallas interpret mode).

Tolerances and why:

- ``_leaf_percentile``: bit-equal unweighted and on dyadic weights, where
  every cumulative sum is exact; on other weights the port sums the
  weights in exact fixed point where XLA accumulates in float32, so values
  are within 1e-4 of the residuals' scale (measured 6.2e-6: the
  interpolation divides a difference of cumulative sums by one row's
  weight).
- Training of regression_l1, quantile (dyadic alpha) and mape (labels with
  1/max(1, |y|) a power of two): the gradients are dyadic, the histograms
  exact and the renewal picks order statistics, so the model text is
  byte-identical to the JAX package's same backend.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import jax.numpy as jnp

import lightgbm_tpu as lgb
from lightgbm_tpu import objectives as jo
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt
from lightgbm_torch import objectives as to
from lightgbm_torch.ops import grow as tgrow

from test_torch_objectives import CPU, _close, _renew_data
from test_torch_train import _trees_text


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _renewal_case(kind, seed):
    """(resid, leaf_id, num_leaves, mask) with ragged leaves, an empty
    leaf, a one-row leaf, a leaf whose rows are all out of bag, and ties."""
    rs = np.random.RandomState(seed)
    sizes = [1, 0, 2, 7, 30, 61, 5, 0, 13, 9]
    leaf = np.repeat(np.arange(len(sizes)), sizes)
    rs.shuffle(leaf)
    n = len(leaf)
    resid = (rs.randn(n) * 2).astype(np.float32)
    if kind == "ties":
        resid = np.round(resid * 2) / 2
    mask = None
    if kind == "masked":
        mask = (rs.rand(n) < 0.6).astype(np.float32)
        mask[leaf == 8] = 0.0
    # two leaves past the used ones stay empty
    return resid.astype(np.float32), leaf.astype(np.int32), len(sizes) + 2, \
        mask


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("kind", ["ragged", "ties", "masked"])
def test_leaf_percentile_matches_jax(kind, alpha):
    resid, leaf, L, mask = _renewal_case(kind, int(alpha * 8) + len(kind))
    rs = np.random.RandomState(7)
    n = len(resid)
    weights = {"none": None,
               "dyadic": (2.0 ** rs.randint(-2, 3, n)).astype(np.float32),
               "real": (rs.rand(n) * 1.5 + 0.2).astype(np.float32)}
    for wname, w in weights.items():
        want = np.asarray(jo._leaf_percentile(
            jnp.asarray(resid), jnp.asarray(leaf), L, alpha,
            None if w is None else jnp.asarray(w),
            None if mask is None else jnp.asarray(mask)))
        got = to._leaf_percentile(
            torch.as_tensor(resid), torch.as_tensor(leaf), L, alpha,
            None if w is None else torch.as_tensor(w),
            None if mask is None else torch.as_tensor(mask)).numpy()
        assert got.dtype == np.float32 and got.shape == (L,)
        if wname == "real":
            _close(got, want, rtol=1e-4)
        else:
            np.testing.assert_array_equal(got, want, err_msg=wname)
        # empty leaves (and a leaf with no in-bag row) renew to 0
        assert (got[[1, 7, L - 2, L - 1]] == 0).all()
        if mask is not None:
            assert got[8] == 0



# mape's labels: |y| a power of two (or below 1), so 1/max(1, |y|) is one
_RENEW = {"regression_l1": {}, "quantile": {"alpha": 0.25},
          "mape": {"_pow2_labels": True}}
_ARMS = {
    "stream": {"hist_backend": "stream"},
    "scatter": {"hist_backend": "scatter"},
    "pallas": {"hist_backend": "pallas"},
    # 70 leaves at a split budget of 64: the sprint round, so a compacted
    # tree's rows are routed by one replay (K3's plain version)
    "bagging_weighted": {"hist_backend": "stream", "bagging_fraction": 0.5,
                         "bagging_freq": 1, "_dyadic_weights": True,
                         "num_leaves": 70, "max_splits_per_round": 64},
    "quant_renew": {"hist_backend": "stream", "use_quantized_grad": True,
                    "quant_train_renew_leaf": True},
}


@pytest.mark.parametrize("arm", list(_ARMS))
@pytest.mark.parametrize("name", list(_RENEW))
def test_renewing_objectives_byte_identical_to_jax(name, arm,
                                                     monkeypatch):
    """regression_l1, quantile at alpha 0.25 and mape train byte-identical
    to the JAX package's same backend: the gradients are dyadic, so the
    histograms are exact, and the renewal picks order statistics (on dyadic
    weights, an exact weighted CDF).  Bagging compacts the sampled tree
    (K3's plain version), here with dyadic row weights (WeightedPercentileFun);
    quantized gradients renew twice, exactly from the raw gradients and
    then to the percentile."""
    X, y = _renew_data()
    extra = {**_RENEW[name], **_ARMS[arm]}
    if extra.pop("_pow2_labels", False):
        y = np.sign(y) * 2.0 ** np.round(np.log2(np.abs(y) + 1e-3))
    w = None
    if extra.pop("_dyadic_weights", False):
        w = 2.0 ** np.random.RandomState(1).randint(-2, 2, len(y))
    params = {"objective": name, "num_leaves": 15, "max_splits_per_round": 4,
              "hist_precision": "single", "min_data_in_leaf": 5,
              "verbosity": -1, **extra}
    calls = []
    if arm == "bagging_weighted":
        orig = tgrow.route_replay
        monkeypatch.setattr(tgrow, "route_replay",
                            lambda *a: calls.append(1) or orig(*a))
    jb = lgb.train(params, lgb.Dataset(X, label=y, weight=w), 3)
    tb = lt.train({**params, **CPU},
                  lt.Dataset(X, label=y, weight=w, params=CPU), 3)
    assert not tb.engine._fused
    assert tb.num_trees() == 3
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    if arm == "bagging_weighted":
        assert tb.engine.last_compact_rows > 0 and len(calls) == 3
    # renewal changed the leaves from the histogram outputs
    assert any(len(set(t.leaf_value)) > 2 for t in tb.engine.models)
