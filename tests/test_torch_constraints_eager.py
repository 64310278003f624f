"""Constrained training of the port against the JAX package run op by op
(``jax.disable_jit``), on the CPU.

The jitted JAX package fuses the output-based gain of constrained splits
and rounds it apart from op-by-op evaluation (tests/test_torch_constraints.py
holds the port to it within a bound); run op by op it does the port's
float32 operations in the port's order, so the model text is byte-identical.
Op-by-op dispatch is slow: one small tree a case, in its own file.
"""
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

import lightgbm_tpu as lgb

import lightgbm_torch as lt
from lightgbm_torch.ops import grow as tgrow

from test_torch_constraints import _BASE, _CONSTRAINTS, _MONO, _train
from test_torch_multiclass import _dyadic_mc_fobj, _mc_data
from test_torch_sample import _sampled_data
from test_torch_train import _dyadic_fobj, _trees_text


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_dyadic_training_byte_identical_to_jax_op_by_op(kind):
    """With the constraints on, the port's model text is the JAX package's
    byte for byte when JAX runs op by op (no jit): one tree under every
    constraint; K = 3 class trees under monotone constraints and path
    smoothing, grown one class at a time in both packages (no lockstep,
    which needs plain growth).  (Against the jitted JAX package a K = 3
    case here parts at a last-round split whose reverse and forward scans
    differ by the jit's rounding, ROADMAP §3.)"""
    if kind == "binary":
        params = {**_BASE, **_CONSTRAINTS["all"], "hist_backend": "scatter"}
        data, fobj = _sampled_data(600, 5), _dyadic_fobj
    else:
        # an exact shrinkage: the reference's jitted multiclass score add
        # may fuse the product into the add
        params = {**_BASE, "objective": "multiclass", "num_class": 3,
                  "monotone_constraints": _MONO, "path_smooth": 1.0,
                  "hist_backend": "scatter", "learning_rate": 0.5}
        data, fobj = _mc_data(600, 1), _dyadic_mc_fobj
    # 15 leaves: two rounds, which op-by-op dispatch keeps affordable
    params["num_leaves"] = 15
    tb = _train(lt, params, iters=1, data=data, fobj=fobj)
    jb = _train(lgb, params, iters=1, data=data, fobj=fobj, op_by_op=True)
    assert _trees_text(tb.model_to_string()) == \
        _trees_text(jb.model_to_string())
    if kind == "multiclass":
        assert not jb.engine._mc_batched_last
        assert not tb.engine._use_batched_multiclass()
        assert tb.num_trees() == 3
        with pytest.raises(ValueError, match="plain feature set"):
            tgrow.grow_tree_k(tb.engine._bins_T, None, None, None,
                              tb.engine.dd.layout, tb.engine.dd.routing,
                              tb.engine.grow_params, 63)
