"""train() and cv(): the boosting loop, with evaluation and early stopping.

The port's counterpart of ``lightgbm_tpu/engine.py:21-374`` (reference:
python-package/lightgbm/engine.py train :109, cv :626).  ``train`` builds a
Booster on the training Dataset, seeds it with ``init_model`` when one is given
(continued training; with ``num_boost_round=0`` this is the way to serve a
saved model on the device, which needs the training Dataset's bin mappers),
adds the validation sets, and runs ``num_boost_round`` boosting iterations.
After each iteration the validation sets are evaluated (their metrics and
``feval``) and the callbacks run; early stopping (``early_stopping_round``
or the ``early_stopping`` callback) ends the loop and sets
``best_iteration`` and ``best_score``.  A loop that runs to its end drops
trailing no-op trees, as the reference does.  With ``snapshot_freq`` a
checkpoint (robustness/checkpoint.py) is written beside ``output_model``
every that many iterations, and ``resume_from`` continues a run from one,
byte-identically to a run that was never interrupted.  ``cv`` trains a
Booster a fold on ``Dataset.subset`` of the rows (``CVBooster``).
"""
from __future__ import annotations

import collections
import copy
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import resolve_aliases
from .robustness.checkpoint import atomic_write_text
from .utils.log import LightGBMError, log_info, log_warning


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None, feval=None,
          init_model: Optional[Union[str, Path, Booster]] = None,
          keep_training_booster: bool = False, callbacks=None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster (reference: engine.py:109; lightgbm_tpu/engine.py:
    28-160).

    ``resume_from`` (or the param ``resume_from`` / ``resume``) names a
    checkpoint written under ``snapshot_freq``: its manifest is validated
    (checksums, the params' identity, the process count), its trees become
    the init model without the score walk, the engine state (score, RNG
    streams, objective state) is restored, and the loop continues from the
    snapshot's iteration.  Callback state is not checkpointed: an early
    stopping window restarts at the resume point."""
    params = resolve_aliases(dict(params or {}))
    # popped so the resumed booster's params (and its saved parameter
    # block) equal the uninterrupted run's
    resume_from = resume_from or params.pop("resume_from", None) or None
    params.pop("resume_from", None)
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if params.get("objective") is None:
        params.setdefault("objective", "regression")
    first_metric_only = bool(params.get("first_metric_only", False))
    if isinstance(init_model, (str, Path)):
        init_model = Booster(model_file=init_model)

    start_iteration = 0
    resume_state = None
    if resume_from:
        if init_model is not None:
            raise LightGBMError(
                "pass either init_model or resume_from, not both (a "
                "checkpoint already carries its model)")
        from .robustness.checkpoint import load_checkpoint
        model_str, manifest, resume_state = load_checkpoint(
            str(resume_from), params=params)
        init_model = Booster(model_str=model_str)
        start_iteration = int(manifest["iteration"])
        if start_iteration >= num_boost_round:
            log_warning(
                f"resume_from checkpoint is at iteration {start_iteration} "
                f">= num_boost_round={num_boost_round}; nothing to train")
        log_info(f"resuming from {resume_from} at iteration "
                 f"{start_iteration}/{num_boost_round}")

    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        # trees are deep-copied so the new booster (DART's rescaling too)
        # never mutates the caller's
        if init_model._engine is not None:
            trees = copy.deepcopy(list(init_model.engine.models))
        else:
            trees = copy.deepcopy(list(init_model._loaded_trees.trees))
        booster.engine.load_init_model(
            trees, init_model.num_model_per_iteration(),
            skip_score_rebuild=resume_state is not None)
    if resume_state is not None:
        from .robustness.checkpoint import restore_state
        restore_state(booster, resume_state)
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

    snapshot_freq = int(params.get("snapshot_freq", -1) or -1)
    snapshot_keep = int(params.get("snapshot_keep", -1) or -1)
    output_model = str(params.get("output_model", "LightGBM_model.txt"))

    evaluation_result_list: List = []
    for i in range(start_iteration, num_boost_round):
        for cb in callbacks_before:
            cb(CallbackEnv(model=booster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=[]))
        finished = booster.update()
        if snapshot_freq > 0 and (i + 1) % snapshot_freq == 0:
            # a crash-consistent checkpoint, resumable through resume_from
            # (reference: gbdt.cpp:259-263 Train snapshots)
            booster.checkpoint(output_model, i + 1, keep=snapshot_keep)
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


class CVBooster:
    """The boosters of a cross-validation, one a fold (reference:
    engine.py:356; lightgbm_tpu/engine.py:210-240).  A method called on it
    is called on every booster, and returns their results as a list.
    ``save_model`` writes the JAX package's JSON (``best_iteration`` and
    each booster's model text), which either package loads."""

    def __init__(self, model_file: Optional[str] = None):
        self.boosters: List[Booster] = []
        self.best_iteration = -1
        if model_file is not None:
            blob = json.loads(Path(model_file).read_text())
            self.best_iteration = blob["best_iteration"]
            self.boosters = [Booster(model_str=s) for s in blob["boosters"]]

    def _append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name: str):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function

    def save_model(self, filename) -> "CVBooster":
        blob = {"best_iteration": self.best_iteration,
                "boosters": [b.model_to_string() for b in self.boosters]}
        atomic_write_text(str(filename), json.dumps(blob))
        return self


def _make_n_folds(full_data: Dataset, folds, nfold: int, params: Dict,
                  seed: int, stratified: bool, shuffle: bool):
    """[(train indices, test indices)] of each fold (lightgbm_tpu/engine.py
    :243-290): the user's ``folds`` (pairs, or an object with ``split``),
    else whole queries when the data has them, else stratified by label
    order, else shuffled and split in ``nfold``."""
    num_data = full_data.num_data()
    group = full_data.get_group()
    label = full_data.get_label()
    if folds is not None:
        if not hasattr(folds, "__iter__") and not hasattr(folds, "split"):
            raise AttributeError("folds should be a generator/iterator of "
                                 "(train_idx, test_idx) or have a split "
                                 "method")
        if hasattr(folds, "split"):
            gr = (np.repeat(np.arange(len(group)), group)
                  if group is not None else None)
            folds = folds.split(X=np.empty(num_data), y=label, groups=gr)
        return list(folds)
    rng = np.random.RandomState(seed)
    if group is not None:
        nq = len(group)
        qidx = np.arange(nq)
        if shuffle:
            rng.shuffle(qidx)
        q_folds = np.array_split(qidx, nfold)
        qb = np.concatenate([[0], np.cumsum(group)])
        out = []
        for i in range(nfold):
            test_q = np.sort(q_folds[i])
            test_idx = (np.concatenate([np.arange(qb[q], qb[q + 1])
                                        for q in test_q])
                        if len(test_q) else np.array([], np.int64))
            train_idx = np.setdiff1d(np.arange(num_data), test_idx)
            out.append((train_idx, test_idx))
        return out
    if stratified and label is not None:
        order = np.argsort(label, kind="stable")
        folds_idx = [order[i::nfold] for i in range(nfold)]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        folds_idx = np.array_split(idx, nfold)
    out = []
    for i in range(nfold):
        test_idx = np.sort(folds_idx[i])
        train_idx = np.setdiff1d(np.arange(num_data), test_idx)
        out.append((train_idx, test_idx))
    return out


def _agg_cv_result(raw_results: List[List]):
    """[("cv_agg", "<set> <metric>", mean, higher is better, std)] over
    the folds' evaluations."""
    cvmap: Dict = collections.OrderedDict()
    metric_type: Dict = {}
    for one_result in raw_results:
        for item in one_result:
            key = f"{item[0]} {item[1]}"
            metric_type[key] = item[3]
            cvmap.setdefault(key, []).append(item[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k], float(np.std(v)))
            for k, v in cvmap.items()]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics: Optional[Union[str, List[str]]] = None,
       feval: Optional[Union[Callable, List[Callable]]] = None,
       init_model=None, fpreproc: Optional[Callable] = None, seed: int = 0,
       callbacks: Optional[List[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """Cross-validation (reference: engine.py:626; lightgbm_tpu/engine.py
    :305-374): a Booster a fold on ``train_set.subset`` of its rows, each
    evaluated on its held-out subset every iteration; returns the folds'
    mean and spread of each metric an iteration (``"valid <metric>-mean"``,
    ``"-stdv"``), cut at the best iteration when early stopping (on the
    fold mean) ends the loop, and with ``return_cvbooster`` the
    ``CVBooster``.  ``init_model`` is taken and, as in the JAX package,
    not read."""
    params = resolve_aliases(dict(params or {}))
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    if metrics is not None:
        params["metric"] = metrics
    obj = params.get("objective", "regression")
    if str(obj).startswith(("lambdarank", "rank_")) \
            or train_set.get_group() is not None or not isinstance(obj, str):
        stratified = False

    train_set.construct()
    fold_indices = _make_n_folds(train_set, folds, nfold, params, seed,
                                 stratified, shuffle)
    cvbooster = CVBooster()
    for tr_idx, te_idx in fold_indices:
        tr = train_set.subset(tr_idx)
        te = train_set.subset(te_idx)
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, copy.deepcopy(params))
        else:
            fold_params = params
        bst = Booster(params=dict(fold_params), train_set=tr)
        bst.add_valid(te, "valid")
        if eval_train_metric:
            bst.engine.add_valid(tr, "train", bst.engine.train_metrics)
        cvbooster._append(bst)

    callbacks = list(callbacks or [])
    es_rounds = params.get("early_stopping_round", 0)
    if es_rounds and int(es_rounds) > 0:
        callbacks.append(callback_mod.early_stopping(
            int(es_rounds), bool(params.get("first_metric_only", False)),
            verbose=int(params.get("verbosity", 1)) >= 1))
    callbacks_before = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in callbacks
         if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    results: Dict[str, List[float]] = collections.defaultdict(list)
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                           begin_iteration=0, end_iteration=num_boost_round,
                           evaluation_result_list=[]))
        for bst in cvbooster.boosters:
            bst.update()
        merged = _agg_cv_result([bst.eval_valid(feval)
                                 for bst in cvbooster.boosters])
        for _, key, mean, _, std in merged:
            results[f"{key}-mean"].append(mean)
            results[f"{key}-stdv"].append(std)
        try:
            for cb in callbacks_after:
                cb(CallbackEnv(model=cvbooster, params=params, iteration=i,
                               begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=merged))
        except EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for k in list(results.keys()):
                results[k] = results[k][:cvbooster.best_iteration]
            break

    for bst in cvbooster.boosters:
        bst.engine.flush_nan_guard()
    if return_cvbooster:
        results["cvbooster"] = cvbooster  # type: ignore
    return dict(results)
