"""train() — zero rounds on an existing model.

The port's counterpart of ``lightgbm_tpu/engine.py:21-130`` (reference:
python-package/lightgbm/engine.py train :109).  Until training is ported,
``train`` builds a Booster on the training Dataset and seeds it with
``init_model``: ``num_boost_round=0`` is the public way to serve a saved
model on the device (the device path needs the training Dataset's bin
mappers).  ``num_boost_round > 0`` raises.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Optional, Union

from .basic import Booster, Dataset
from .config import resolve_aliases
from .utils.log import LightGBMError


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          init_model: Optional[Union[str, Path, Booster]] = None) -> Booster:
    """Build a Booster on ``train_set`` holding ``init_model``'s trees
    (reference: engine.py:109)."""
    params = resolve_aliases(dict(params or {}))
    if "num_iterations" in params:
        num_boost_round = int(params["num_iterations"])
    params["num_iterations"] = num_boost_round
    if params.get("objective") is None:
        params.setdefault("objective", "regression")
    if num_boost_round > 0:
        raise LightGBMError(
            "training is not yet ported to lightgbm_torch; pass "
            "num_boost_round=0 with init_model= to serve an existing model")
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
    # the reference's loop, run to its end, drops trailing no-op trees
    booster.engine._trim_trailing_trivial()
    return booster
