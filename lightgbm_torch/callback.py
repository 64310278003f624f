"""Training callbacks.

The port's counterpart of ``lightgbm_tpu/callback.py:17-75, :133-220``
(reference: python-package/lightgbm/callback.py, CallbackEnv :65,
log_evaluation :109, record_evaluation :183, early_stopping :278/:462,
reset_parameter; lightgbm_tpu/callback.py:111-131).  ``log_telemetry``
is not ported and raises.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Tuple, Union

from .utils.log import LightGBMError, log_info, log_warning


@dataclass
class CallbackEnv:
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: List[Tuple[str, str, float, bool]]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            parts = [f"{name}'s {metric}: {value:g}"
                     for name, metric, value, _ in env.evaluation_result_list]
            log_info(f"[{env.iteration + 1}]\t" + "\t".join(parts))
    _callback.order = 10  # type: ignore
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], OrderedDict()).setdefault(
                item[1], [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, OrderedDict()).setdefault(
                metric, []).append(value)
    _callback.order = 20  # type: ignore
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters before each iteration (reference: callback.py
    reset_parameter; lightgbm_tpu/callback.py:111-131): a value is a list
    of one value an iteration (the length of ``num_boost_round``) or a
    function of the iteration."""
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} must match "
                                     "num_boost_round")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("reset_parameter values must be list or "
                                 "callable")
        if new_params:
            env.model.reset_parameter(new_params)
            env.params.update(new_params)
    _callback.before_iteration = True  # type: ignore
    _callback.order = 10  # type: ignore
    return _callback


def log_telemetry(period: int = 10) -> Callable:
    raise LightGBMError("log_telemetry is not yet ported to lightgbm_torch")


class _EarlyStoppingCallback:
    """reference: callback.py:278 _EarlyStoppingCallback."""

    def __init__(self, stopping_rounds: int, first_metric_only: bool = False,
                 verbose: bool = True,
                 min_delta: Union[float, List[float]] = 0.0):
        if stopping_rounds <= 0:
            raise ValueError("stopping_rounds should be greater than zero.")
        self.order = 30
        self.before_iteration = False
        self.stopping_rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.min_delta = min_delta
        self.enabled = True
        self.best_score: List[float] = []
        self.best_iter: List[int] = []
        self.best_score_list: List[List] = []
        self.cmp_op: List[Callable] = []
        self.first_metric = ""
        self._inited = False

    def _init(self, env: CallbackEnv) -> None:
        self._inited = True
        if not env.evaluation_result_list:
            self.enabled = False
            log_warning("Early stopping is not available without a "
                        "validation set")
            return
        n_metrics = len(set(m[1] for m in env.evaluation_result_list))
        n_datasets = len(env.evaluation_result_list) // max(n_metrics, 1)
        if isinstance(self.min_delta, list):
            deltas = self.min_delta * n_datasets
        else:
            deltas = [self.min_delta] * n_datasets * n_metrics
        self.first_metric = env.evaluation_result_list[0][1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            self.best_iter.append(0)
            self.best_score_list.append(None)
            if eval_ret[3]:  # higher is better
                self.best_score.append(float("-inf"))
                self.cmp_op.append(partial(self._gt_delta, delta=delta))
            else:
                self.best_score.append(float("inf"))
                self.cmp_op.append(partial(self._lt_delta, delta=delta))

    @staticmethod
    def _gt_delta(curr, best, delta):
        return curr > best + delta

    @staticmethod
    def _lt_delta(curr, best, delta):
        return curr < best - delta

    def __call__(self, env: CallbackEnv) -> None:
        if not self._inited:
            self._init(env)
        if not self.enabled:
            return
        # cv's aggregated entries carry a fifth item, the spread
        for i, item in enumerate(env.evaluation_result_list):
            name, metric, score = item[0], item[1], item[2]
            if (self.best_score_list[i] is None
                    or self.cmp_op[i](score, self.best_score[i])):
                self.best_score[i] = score
                self.best_iter[i] = env.iteration
                self.best_score_list[i] = env.evaluation_result_list
            if name == "training":
                continue  # a training metric never stops training
            if self.first_metric_only and metric != self.first_metric:
                continue
            if env.iteration - self.best_iter[i] >= self.stopping_rounds:
                if self.verbose:
                    log_info(f"Early stopping, best iteration is:\n"
                             f"[{self.best_iter[i] + 1}]")
                raise EarlyStopException(self.best_iter[i],
                                         self.best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if self.verbose:
                    log_info("Did not meet early stopping. Best iteration "
                             f"is:\n[{self.best_iter[i] + 1}]")
                raise EarlyStopException(self.best_iter[i],
                                         self.best_score_list[i])


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True,
                   min_delta: Union[float, List[float]] = 0.0) -> Callable:
    return _EarlyStoppingCallback(stopping_rounds, first_metric_only,
                                  verbose, min_delta)
