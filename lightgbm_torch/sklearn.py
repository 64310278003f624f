"""scikit-learn estimator API of the port.

The port's counterpart of ``lightgbm_tpu/sklearn.py`` (reference:
python-package/lightgbm/sklearn.py: LGBMModel :535, LGBMRegressor :1409,
LGBMClassifier :1524, LGBMRanker :1832).  The estimators follow
scikit-learn's conventions (``get_params`` / ``set_params``, constructor
arguments stored as given, so ``sklearn.base.clone`` copies them) without
importing scikit-learn.  ``fit`` builds a ``Dataset`` (validation sets
binned with the training set's mappers) and calls ``train``; a callable
objective trains through ``Booster.update(fobj=...)``.  Estimator
arguments are LightGBM parameter aliases (``n_estimators`` aside), and any
other keyword argument is passed through as a parameter, ``device_type``
included: like every entry point of the port, the estimators train on the
GPU unless ``device_type="cpu"`` is given.  ``X`` may be a numpy array, a
pandas DataFrame or a SciPy sparse matrix (a sparse ``Dataset``; sparse
rows to ``predict`` are binned on the device).  An objective the port does
not train raises "not yet ported" at ``fit``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, Dataset
from .callback import record_evaluation
from .engine import train as _train
from .utils.log import LightGBMError

__all__ = ["LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker"]


def _objective_fn_wrapper(func):
    """A scikit-learn style ``func(y_true, y_pred) -> (grad, hess)`` as the
    engine's ``fobj(preds, dataset)``."""
    def inner(preds, dataset):
        res = func(dataset.get_label(), preds)
        if len(res) != 2:
            raise ValueError("custom objective must return (grad, hess)")
        grad, hess = res
        return np.asarray(grad), np.asarray(hess)
    return inner


def _eval_fn_wrapper(func):
    def inner(preds, dataset):
        return func(dataset.get_label(), preds)
    return inner


class LGBMModel:
    """Base estimator (reference: sklearn.py:535)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None, n_jobs: int = -1,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_score: Dict = {}
        self._best_iteration = -1
        self._n_features = -1
        self._classes = None
        self._n_classes = -1

    # -- scikit-learn plumbing ---------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key) and not key.startswith("_"):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _process_params(self) -> Dict[str, Any]:
        """The estimator's arguments as training parameters."""
        params = self.get_params()
        for key in ("importance_type", "n_estimators", "class_weight",
                    "random_state", "n_jobs"):
            params.pop(key, None)
        obj = params.pop("objective", None)
        if callable(obj):
            params["objective"] = "none"
        elif obj is not None:
            params["objective"] = obj
        else:
            params["objective"] = self._default_objective()
        if self.random_state is not None:
            params["seed"] = (self.random_state
                              if isinstance(self.random_state, int) else 0)
        return params

    def _sample_weight_from_class_weight(self, y, sample_weight):
        if self.class_weight is None:
            return sample_weight
        classes, counts = np.unique(y, return_counts=True)
        if self.class_weight == "balanced":
            wmap = {c: len(y) / (len(classes) * cnt)
                    for c, cnt in zip(classes, counts)}
        elif isinstance(self.class_weight, dict):
            wmap = self.class_weight
        else:
            raise ValueError("class_weight must be 'balanced' or a dict")
        cw = np.asarray([wmap.get(v, 1.0) for v in y], np.float64)
        if sample_weight is None:
            return cw
        return cw * np.asarray(sample_weight, np.float64)

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None,
            feature_name="auto", categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMModel":
        params = self._process_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        fobj = (_objective_fn_wrapper(self.objective)
                if callable(self.objective) else None)
        feval = _eval_fn_wrapper(eval_metric) if callable(eval_metric) \
            else None

        y_arr = np.asarray(y).reshape(-1)
        sample_weight = self._sample_weight_from_class_weight(y_arr,
                                                              sample_weight)
        train_set = Dataset(X, label=y_arr, weight=sample_weight, group=group,
                            init_score=init_score, feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                valid_sets.append(Dataset(
                    vx, label=np.asarray(vy).reshape(-1),
                    weight=(eval_sample_weight[i] if eval_sample_weight
                            else None),
                    group=eval_group[i] if eval_group else None,
                    init_score=(eval_init_score[i] if eval_init_score
                                else None),
                    reference=train_set))

        self._evals_result = {}
        callbacks = list(callbacks or [])
        if valid_sets:
            callbacks.append(record_evaluation(self._evals_result))
        if fobj is not None:
            booster = Booster(params=params, train_set=train_set)
            for vi, vs in enumerate(valid_sets):
                booster.add_valid(vs, eval_names[vi] if eval_names
                                  else f"valid_{vi}")
            for _ in range(self.n_estimators):
                booster.update(fobj=fobj)
            self._Booster = booster
        else:
            self._Booster = _train(
                params, train_set, num_boost_round=self.n_estimators,
                valid_sets=valid_sets or None, valid_names=eval_names,
                feval=feval,
                init_model=(init_model.booster_
                            if isinstance(init_model, LGBMModel)
                            else init_model),
                callbacks=callbacks)
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._n_features = train_set.num_feature()
        return self

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        return self.booster_.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib, **kwargs)

    # -- fitted attributes -------------------------------------------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise LightGBMError("No booster found. Need to call fit "
                                "beforehand.")
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self) -> Dict:
        return self._best_score

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        return self.booster_.feature_name()

    @property
    def feature_names_in_(self) -> np.ndarray:
        return np.asarray(self.booster_.feature_name())

    @property
    def n_estimators_(self) -> int:
        return self.booster_.current_iteration()

    @property
    def n_iter_(self) -> int:
        return self.booster_.current_iteration()

    @property
    def objective_(self):
        return self.objective or self._default_objective()


class LGBMRegressor(LGBMModel):
    """reference: sklearn.py:1409."""

    def score(self, X, y, sample_weight=None) -> float:
        """R^2 of the predictions."""
        pred = self.predict(X)
        y = np.asarray(y, np.float64).reshape(-1)
        w = (np.ones_like(y) if sample_weight is None
             else np.asarray(sample_weight))
        ybar = np.average(y, weights=w)
        ss_res = np.sum(w * (y - pred) ** 2)
        ss_tot = np.sum(w * (y - ybar) ** 2)
        return float(1.0 - ss_res / max(ss_tot, 1e-300))


class LGBMClassifier(LGBMModel):
    """reference: sklearn.py:1524.  Labels of any type are encoded as
    0 .. K-1 in sorted order; ``predict`` maps back to them."""

    def _default_objective(self) -> str:
        return ("binary" if self._n_classes is None or self._n_classes <= 2
                else "multiclass")

    def fit(self, X, y, **kwargs):
        y_arr = np.asarray(y).reshape(-1)
        self._classes, y_enc = np.unique(y_arr, return_inverse=True)
        self._n_classes = len(self._classes)
        user_obj = self.objective
        if user_obj is None:
            if self._n_classes > 2:
                self._other_params["num_class"] = self._n_classes
                self.objective = "multiclass"
            else:
                self.objective = "binary"
        elif isinstance(user_obj, str) and user_obj.startswith("multiclass"):
            self._other_params["num_class"] = self._n_classes
        try:
            return super().fit(X, y_enc.astype(np.float64), **kwargs)
        finally:
            self.objective = user_obj

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None, **kwargs
                      ) -> np.ndarray:
        res = super().predict(X, raw_score=raw_score,
                              start_iteration=start_iteration,
                              num_iteration=num_iteration, **kwargs)
        if raw_score or res.ndim != 1:
            return res
        return np.column_stack([1.0 - res, res])

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        if raw_score or pred_leaf or pred_contrib:
            return super().predict(X, raw_score=raw_score,
                                   start_iteration=start_iteration,
                                   num_iteration=num_iteration,
                                   pred_leaf=pred_leaf,
                                   pred_contrib=pred_contrib, **kwargs)
        proba = self.predict_proba(X, start_iteration=start_iteration,
                                   num_iteration=num_iteration, **kwargs)
        return self._classes[np.argmax(proba, axis=1)]

    def score(self, X, y, sample_weight=None) -> float:
        """Accuracy of the predicted labels."""
        pred = self.predict(X)
        return float(np.average(pred == np.asarray(y).reshape(-1),
                                weights=sample_weight))

    @property
    def classes_(self) -> np.ndarray:
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    """reference: sklearn.py:1832; ``group`` (and ``eval_group`` for each
    evaluation set) gives the query sizes in row order."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, eval_set=None, eval_group=None,
            eval_at=(1, 2, 3, 4, 5), **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        if eval_set is not None and eval_group is None:
            raise ValueError("Eval_group cannot be None when eval_set is "
                             "not None")
        self._other_params["eval_at"] = list(eval_at)
        return super().fit(X, y, group=group, eval_set=eval_set,
                           eval_group=eval_group, **kwargs)
