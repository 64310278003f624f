"""The fused iteration on the card: CUDA graphs captured and replayed.

Marked ``cuda``: each test skips without a CUDA device.  Run on the card
with ``python -m pytest tests/test_torch_fused_card.py``.  This file
imports no JAX.

- ``fused_iter`` on against off on the card: byte-identical model text
  (the ``fused_iter`` parameter line aside), the fused run through graph
  replays, its kernels' launches credited per replay.
- L2 regression fused on the card against eager on the CPU: byte-identical
  (its gradients and every sum are the same float32 operations on both).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_torch as lt
from lightgbm_torch import kernels
from lightgbm_torch.utils import timer as ttimer

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from lightgbm_torch.kernels import build
    build.build()


def _data(n, seed, cat=False, wide=False):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 6)
    X[rs.rand(n) < 0.1, 0] = np.nan
    X[rs.rand(n) < 0.3, 1] = 0.0
    a = rs.rand(n)
    X[:, 3] = np.where(a < 0.1, rs.rand(n) + 0.5, 0.0)
    X[:, 4] = np.where(a > 0.9, rs.rand(n) + 0.5, 0.0)
    if cat:
        X[:, 5] = rs.randint(0, 40, n)
    y = (X[:, 2] + 0.5 * np.nan_to_num(X[:, 0]) + 2 * X[:, 3]
         + 0.3 * rs.randn(n) > 0).astype(float)
    return X, y


_BASE = {"objective": "binary", "num_leaves": 127, "min_data_in_leaf": 5,
         "max_bin": 63, "verbosity": -1}

CASES = {
    "binary": {},
    "l2": {"objective": "regression"},
    "multiclass_lockstep": {"objective": "multiclass", "num_class": 3},
    "goss_fused_k3": {"data_sample_strategy": "goss", "learning_rate": 0.5},
    "bagging_fused_k3": {"bagging_fraction": 0.5, "bagging_freq": 2},
    "quantized": {"use_quantized_grad": True},
    "categorical": {"cat": True},
    "wide_bins": {"max_bin": 400, "num_leaves": 31},
    "max_depth": {"max_depth": 4},
    "prefix_budget_64": {"num_leaves": 255, "max_splits_per_round": 100},
    "feature_fraction": {"feature_fraction": 0.6},
}


def _train(case, fused, device="cuda", iters=6, n=20_000):
    p = dict(CASES[case])
    cat = p.pop("cat", False)
    X, y = _data(n, 3, cat=cat)
    if p.get("objective") == "multiclass":
        y = (X[:, 1] > 0) + (np.nan_to_num(X[:, 2]) > 0.5).astype(float)
    p = {**_BASE, **p, "fused_iter": fused, "device_type": device}
    kw = {"categorical_feature": [5]} if cat else {}
    return lt.train(p, lt.Dataset(X, label=y, params=p, **kw), iters)


def _text(bst):
    return "\n".join(line for line in bst.model_to_string().splitlines()
                     if not line.startswith("[fused_iter:")
                     and not line.startswith("[device_type:"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_on_card_byte_identical_to_eager(case):
    kernels.reset_launch_counts()
    r0 = ttimer.host_reads()
    on = _train(case, "auto")
    reads = ttimer.host_reads() - r0
    launches = kernels.launch_counts()
    off = _train(case, "off")
    eng = on.engine
    assert eng._fused and eng._graphs.replays > 0 and eng._graphs.captures > 0
    assert _text(on) == _text(off)
    assert launches["route_and_hist"] + launches["route_and_hist_int"] > 0
    assert launches["leaf_gather"] == 6
    if case in ("goss_fused_k3", "bagging_fused_k3"):
        assert launches["route_replay"] > 0
    print(case, "reads", reads, "replays", eng._graphs.replays,
          "captures", eng._graphs.captures, "launches", launches)


@pytest.mark.parametrize("case", ["l2"])
def test_fused_on_card_byte_identical_to_cpu_eager(case):
    on = _train(case, "on")
    cpu = _train(case, "off", device="cpu")
    assert _text(on) == _text(cpu)
