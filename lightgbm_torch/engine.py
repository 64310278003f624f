"""train(): the boosting loop.

The port's counterpart of ``lightgbm_tpu/engine.py:21-207`` (reference:
python-package/lightgbm/engine.py train :109).  ``train`` builds a Booster
on the training Dataset, seeds it with ``init_model`` when one is given
(continued training; with ``num_boost_round=0`` this is the way to serve a
saved model on the device, which needs the training Dataset's bin mappers),
and runs ``num_boost_round`` boosting iterations.  A loop that runs to its
end drops trailing no-op trees, as the reference does.  Evaluation
(``valid_sets``, ``feval``, ``callbacks``) and checkpoint resume are not
ported yet and raise.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional, Union

from .basic import Booster, Dataset
from .config import resolve_aliases
from .utils.log import LightGBMError


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          feval=None,
          init_model: Optional[Union[str, Path, Booster]] = None,
          keep_training_booster: bool = False, callbacks=None,
          resume_from: Optional[str] = None) -> Booster:
    """Train a booster (reference: engine.py:109)."""
    params = resolve_aliases(dict(params or {}))
    resume_from = resume_from or params.pop("resume_from", None)
    for name, value in (("valid_sets", valid_sets), ("feval", feval),
                        ("callbacks", callbacks),
                        ("resume_from", resume_from)):
        if value:
            raise LightGBMError(f"{name} is not yet ported to lightgbm_torch "
                                "(evaluation and checkpoints come later)")
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if params.get("objective") is None:
        params.setdefault("objective", "regression")
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
    for _ in range(num_boost_round):
        if booster.update():
            break
    else:
        booster.engine._trim_trailing_trivial()
    return booster
