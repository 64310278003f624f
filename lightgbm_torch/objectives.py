"""Objective functions: label checks and output transforms.

The port's counterpart of ``lightgbm_tpu/objectives.py`` (reference:
include/LightGBM/objective_function.h:38-120).  Batch prediction needs only
``init`` (the label checks a zero-round ``train`` runs) and
``convert_output``; gradients come with training.  Binary logloss, L2
regression and multiclass softmax are here (a multiclass model predicts
through ``train(..., init_model=...)`` as well); any other objective raises.
``convert_output`` works in float32 torch, as the reference's jnp transform
works in float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import Config, canonical_objective
from .utils.log import LightGBMError


class ObjectiveFunction:
    """Base class (reference: objective_function.h:38)."""

    name = "none"
    num_model_per_iteration = 1

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             n: int = 0) -> None:
        self.num_data = n
        self.label = np.asarray(label, np.float32)
        self.weight = None if weight is None else np.asarray(weight, np.float32)

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:94"""
    name = "regression"

    def init(self, label, weight, **kw):
        if self.config.reg_sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        super().init(label, weight, **kw)

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
            return (torch.sign(r) * r * r).numpy()
        return raw


class BinaryLogloss(ObjectiveFunction):
    """reference: binary_objective.hpp:22"""
    name = "binary"

    def init(self, label, weight, **kw):
        u = np.unique(label[~np.isnan(label)])
        if not np.all(np.isin(u, [0.0, 1.0])):
            raise LightGBMError("binary objective requires 0/1 labels")
        super().init(label, weight, **kw)

    def convert_output(self, raw):
        # scaled in float64 like the reference's NumPy operand, then float32
        r = torch.as_tensor(self.config.sigmoid * np.asarray(raw),
                            dtype=torch.float32)
        return torch.sigmoid(r).numpy()


class MulticlassSoftmax(ObjectiveFunction):
    """reference: multiclass_objective.hpp:25 — one tree per class per
    iteration."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class

    def init(self, label, weight, **kw):
        k = self.config.num_class
        il = label.astype(np.int64)
        if np.any((il < 0) | (il >= k)):
            raise LightGBMError(f"multiclass labels must be in [0, {k})")
        super().init(label, weight, **kw)

    def convert_output(self, raw):
        r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
        return torch.softmax(r, dim=-1).numpy()


_OBJECTIVE_CLASSES = {
    "regression": RegressionL2,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    objective_function.cpp:72)."""
    name = canonical_objective(str(config.objective))
    if name == "none":
        return None
    cls = _OBJECTIVE_CLASSES.get(name)
    if cls is None:
        raise LightGBMError(f"objective {name!r} is not yet ported to "
                            "lightgbm_torch")
    return cls(config)
