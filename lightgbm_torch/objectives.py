"""Objective functions: label checks, gradients and output transforms.

The port's counterpart of ``lightgbm_tpu/objectives.py`` (reference:
include/LightGBM/objective_function.h:38-120).  Binary logloss, L2
regression, multiclass softmax and one-vs-all multiclass train
(``get_gradients``, ``boost_from_score``), and the ranking objectives
``lambdarank`` and ``rank_xendcg`` (ranking.py); any other objective raises.
Gradients and ``convert_output`` work in float32 torch, with the
reference's operations in the reference's order, so L2 gradients are
bit-equal to the JAX package's and the others differ only where torch's and
JAX's float32 ``exp`` and ``sigmoid`` round differently.  A multiclass
objective takes the (N, K) score and returns (N, K) gradients.

``boost_from_score`` takes its label means on the host in float64 and
rounds them to float32 as the reference's float32 ``jnp.mean`` result is
rounded; for 0/1 labels the sum is exact either way, so the two agree.
The multiclass objectives boost from 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config, canonical_objective
from .utils.log import LightGBMError


class ObjectiveFunction:
    """Base class (reference: objective_function.h:38)."""

    name = "none"
    num_model_per_iteration = 1
    is_ranking = False
    # False when get_gradients does host work each iteration (rank_xendcg's
    # draw), so the fused iteration cannot capture it
    jit_safe_gradients = True

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self._on_device = {}

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             query_boundaries: Optional[np.ndarray] = None,
             position: Optional[np.ndarray] = None, n: int = 0) -> None:
        self.num_data = n
        self.label = np.asarray(label, np.float32)
        self.weight = None if weight is None else np.asarray(weight, np.float32)
        self._on_device = {}

    def _tensor(self, name: str, device: torch.device) -> Optional[torch.Tensor]:
        """The float32 array ``name`` on ``device``, copied there once."""
        key = (name, str(device))
        if key not in self._on_device:
            a = getattr(self, name)
            self._on_device[key] = (None if a is None
                                    else torch.as_tensor(a).to(device))
        return self._on_device[key]

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise LightGBMError(f"objective {self.name!r} does not train in "
                            "lightgbm_torch yet")

    def boost_from_score(self) -> float:
        return 0.0

    def _apply_weight(self, grad, hess):
        w = self._tensor("weight", grad.device)
        if w is not None:
            if grad.dim() == 2:
                w = w[:, None]
            grad = grad * w
            hess = hess * w
        return grad, hess

    def _weighted_label_mean(self) -> float:
        """The label mean (weighted when weights exist) as the float32 the
        reference's ``jnp.mean`` / weighted ratio returns."""
        y = self.label.astype(np.float64)
        if self.weight is not None:
            w = self.weight.astype(np.float64)
            return float(np.float32(np.sum(y * w) / np.sum(w)))
        return float(np.float32(np.sum(y) / len(y)))

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        return raw


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:94"""
    name = "regression"

    def init(self, label, weight, **kw):
        if self.config.reg_sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        super().init(label, weight, **kw)

    def get_gradients(self, score):
        grad = score - self._tensor("label", score.device)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        return self._weighted_label_mean()

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
        n_pos = float(np.sum(label > 0))
        n_neg = float(len(label) - n_pos)
        self._label_weights = (1.0, 1.0)
        if self.config.is_unbalance and n_pos > 0 and n_neg > 0:
            if n_pos > n_neg:
                self._label_weights = (1.0, n_pos / n_neg)
            else:
                self._label_weights = (n_neg / n_pos, 1.0)
        elif self.config.scale_pos_weight != 1.0:
            self._label_weights = (1.0, self.config.scale_pos_weight)

    def get_gradients(self, score):
        sig = self.config.sigmoid
        y = self._tensor("label", score.device)
        p = torch.sigmoid(sig * score)
        wn, wp = self._label_weights
        lw = torch.where(y > 0, wp, wn).to(torch.float32)
        grad = sig * (p - y) * lw
        hess = sig * sig * p * (1.0 - p) * lw
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return 0.0
        pavg = min(max(self._weighted_label_mean(), 1e-9), 1.0 - 1e-9)
        return float(np.log(pavg / (1.0 - pavg)) / self.config.sigmoid)

    def convert_output(self, raw):
        # scaled in float64 like the reference's NumPy operand, then float32
        r = torch.as_tensor(self.config.sigmoid * np.asarray(raw),
                            dtype=torch.float32)
        return torch.sigmoid(r).numpy()


class _Multiclass(ObjectiveFunction):
    """K trees per iteration over integer labels in [0, K); the one-hot
    label matrix lives on the device beside the labels."""

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_model_per_iteration = config.num_class

    def init(self, label, weight, **kw):
        k = self.config.num_class
        il = label.astype(np.int64)
        if np.any((il < 0) | (il >= k)):
            raise LightGBMError(f"multiclass labels must be in [0, {k})")
        super().init(label, weight, **kw)
        self.onehot = np.eye(k, dtype=np.float32)[il]


class MulticlassSoftmax(_Multiclass):
    """reference: multiclass_objective.hpp:25 — one tree per class per
    iteration."""
    name = "multiclass"

    def get_gradients(self, score):
        # score: (N, K); jax.nn.softmax's operations
        e = torch.exp(score - score.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        grad = p - self._tensor("onehot", score.device)
        hess = 2.0 * p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def convert_output(self, raw):
        r = torch.as_tensor(np.asarray(raw), dtype=torch.float32)
        return torch.softmax(r, dim=-1).numpy()


class MulticlassOVA(_Multiclass):
    """reference: multiclass_objective.hpp:187 — K independent binary
    problems."""
    name = "multiclassova"

    def get_gradients(self, score):
        sig = self.config.sigmoid
        p = torch.sigmoid(sig * score)
        grad = sig * (p - self._tensor("onehot", score.device))
        hess = sig * sig * p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def convert_output(self, raw):
        # scaled in float64 like the reference's NumPy operand, then float32
        r = torch.as_tensor(self.config.sigmoid * np.asarray(raw),
                            dtype=torch.float32)
        p = torch.sigmoid(r)
        return (p / p.sum(dim=-1, keepdim=True)).numpy()


_OBJECTIVE_CLASSES = {
    "regression": RegressionL2,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Factory (reference: ObjectiveFunction::CreateObjectiveFunction,
    objective_function.cpp:72)."""
    name = canonical_objective(str(config.objective))
    if name == "none":
        return None
    if name in ("lambdarank", "rank_xendcg"):
        from .ranking import LambdarankNDCG, RankXENDCG
        return (LambdarankNDCG(config) if name == "lambdarank"
                else RankXENDCG(config))
    cls = _OBJECTIVE_CLASSES.get(name)
    if cls is None:
        raise LightGBMError(f"objective {name!r} is not yet ported to "
                            "lightgbm_torch")
    return cls(config)
