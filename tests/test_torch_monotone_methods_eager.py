"""The intermediate and advanced monotone methods of the port against the
JAX package run op by op (``jax.disable_jit``), on the CPU.

Run op by op, the JAX package does the port's float32 operations in the
port's order (the jit fuses the output-based gain and rounds it apart,
tests/test_torch_monotone_methods.py), so the model text is byte-identical.
The JAX package's ``pallas`` is wrong at one split a round (ROADMAP §3):
the port's ``pallas`` is held to its ``scatter``.  Op-by-op dispatch is
slow: one small tree a case, in its own file.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb
from lightgbm_tpu.pallas import hist_kernel as jhk
from lightgbm_tpu.pallas import stream_kernel as jsk

import lightgbm_torch as lt

from test_torch_constraints import _BASE, _GROUPS, _MONO, _train
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    monkeypatch.setattr(jhk, "_INTERPRET", True)


def _check(params, data, fobj=_dyadic_fobj):
    tb = _train(lt, params, iters=1, data=data, fobj=fobj)
    jparams = {**params, "hist_backend": (
        "scatter" if params["hist_backend"] == "pallas"
        else params["hist_backend"])}
    jb = _train(lgb, jparams, iters=1, data=data, fobj=fobj, op_by_op=True)
    text = _trees_text(tb.model_to_string())
    assert text == _trees_text(jb.model_to_string())
    return tb


@pytest.mark.parametrize("backend", ["stream", "scatter", "pallas"])
@pytest.mark.parametrize("method", ["intermediate", "advanced"])
def test_dyadic_training_byte_identical_op_by_op(method, backend):
    """One tree of 7 leaves under each method and backend."""
    params = {**_BASE, "monotone_constraints": _MONO,
              "monotone_constraints_method": method,
              "hist_backend": backend, "num_leaves": 7}
    tb = _check(params, _sampled_data(600, 5))
    assert tb.engine.models[0].num_leaves == 7


def test_goss_and_every_growth_mode_op_by_op():
    """The advanced method under GOSS with ``monotone_penalty``,
    interaction constraints, path smoothing, by-node sampling and extra
    trees."""
    params = {**_BASE, "monotone_constraints": _MONO,
              "monotone_constraints_method": "advanced",
              "monotone_penalty": 0.5, "interaction_constraints": _GROUPS,
              "path_smooth": 1.0, "feature_fraction_bynode": 0.5,
              "extra_trees": True, "hist_backend": "stream",
              "data_sample_strategy": "goss", "num_leaves": 7}
    tb = _check(params, _sampled_data(600, 5))
    assert tb.engine.models[0].num_leaves > 3


def test_multiclass_op_by_op():
    """K = 3 class trees under the intermediate method, one class at a
    time in both packages."""
    params = {**_BASE, "objective": "multiclass", "num_class": 3,
              "monotone_constraints": _MONO,
              "monotone_constraints_method": "intermediate",
              "hist_backend": "stream", "learning_rate": 0.5,
              "num_leaves": 5}
    tb = _check(params, _mc_data(600, 1), _dyadic_mc_fobj)
    assert tb.num_trees() == 3
