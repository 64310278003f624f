"""train(): the boosting loop, with evaluation and early stopping.

The port's counterpart of ``lightgbm_tpu/engine.py:21-207`` (reference:
python-package/lightgbm/engine.py train :109).  ``train`` builds a Booster
on the training Dataset, seeds it with ``init_model`` when one is given
(continued training; with ``num_boost_round=0`` this is the way to serve a
saved model on the device, which needs the training Dataset's bin mappers),
adds the validation sets, and runs ``num_boost_round`` boosting iterations.
After each iteration the validation sets are evaluated (their metrics and
``feval``) and the callbacks run; early stopping (``early_stopping_round``
or the ``early_stopping`` callback) ends the loop and sets
``best_iteration`` and ``best_score``.  A loop that runs to its end drops
trailing no-op trees, as the reference does.  Checkpoint resume
(``resume_from``) and ``cv`` are not ported yet and raise.
"""
from __future__ import annotations

import collections
import copy
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import resolve_aliases
from .utils.log import LightGBMError, log_info


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None, feval=None,
          init_model: Optional[Union[str, Path, Booster]] = None,
          keep_training_booster: bool = False, callbacks=None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster (reference: engine.py:109)."""
    params = resolve_aliases(dict(params or {}))
    if resume_from or params.pop("resume_from", None):
        raise LightGBMError("resume_from is not yet ported to lightgbm_torch "
                            "(checkpoints come later)")
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if params.get("objective") is None:
        params.setdefault("objective", "regression")
    first_metric_only = bool(params.get("first_metric_only", False))
    if isinstance(init_model, (str, Path)):
        init_model = Booster(model_file=init_model)
    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        # trees are deep-copied so the new booster never mutates the caller's
        if init_model._engine is not None:
            trees = copy.deepcopy(list(init_model.engine.models))
        else:
            trees = copy.deepcopy(list(init_model._loaded_trees.trees))
        booster.engine.load_init_model(trees,
                                       init_model.num_model_per_iteration())
    if valid_sets:
        if valid_names is not None and len(valid_names) != len(valid_sets):
            raise LightGBMError(
                f"Length of valid_names ({len(valid_names)}) does not match "
                f"valid_sets ({len(valid_sets)})")
        names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, names):
            # the training data as its own valid set takes the reference's
            # name
            booster.add_valid(vs, "training" if vs is train_set else name)

    callbacks = list(callbacks or [])
    es_rounds = params.get("early_stopping_round", 0)
    if es_rounds and int(es_rounds) > 0 and valid_sets:
        callbacks.append(callback_mod.early_stopping(
            int(es_rounds), first_metric_only,
            verbose=int(params.get("verbosity", 1)) >= 1,
            min_delta=params.get("early_stopping_min_delta", 0.0)))
    callbacks_before = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in callbacks
         if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    evaluation_result_list: List = []
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(CallbackEnv(model=booster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=[]))
        finished = booster.update()
        evaluation_result_list = []
        if booster.engine.valid_sets:
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(model=booster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=evaluation_result_list))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            evaluation_result_list = e.best_score or []
            break
        if finished:
            log_info("Stopped training because there are no more leaves "
                     "that meet the split requirements")
            break
    else:
        booster.engine._trim_trailing_trivial()
    booster.engine.flush_nan_guard()

    if evaluation_result_list:
        best: Dict[str, Dict[str, float]] = collections.defaultdict(dict)
        for name, metric, value, _ in evaluation_result_list:
            best[name][metric] = value
        booster.best_score = dict(best)
    return booster


def cv(*args, **kwargs):
    """Cross-validation (reference: engine.py:626): not ported yet."""
    raise LightGBMError("cv is not yet ported to lightgbm_torch")
