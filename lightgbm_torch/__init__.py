"""lightgbm_torch — the PyTorch/CUDA port of lightgbm_tpu.

Training (gbdt on numeric and categorical features, binary, L2,
multiclass, the other regression objectives and learning to rank
(lambdarank, rank_xendcg, NDCG / MAP), with
bagging (also by query), GOSS and feature sampling, quantized gradients,
validation sets and early stopping) and batch prediction run on an NVIDIA
Hopper GPU through hand-written CUDA kernels (``kernels/``):

    import lightgbm_torch as lgb
    train = lgb.Dataset(X, label=y)
    valid = lgb.Dataset(Xv, label=yv, reference=train)
    bst = lgb.train(params, train, 100, valid_sets=[valid],
                    callbacks=[lgb.early_stopping(10)])
    bst.predict(X_new)

A SciPy sparse matrix is a Dataset as it is (its bins are filled on the
device from its stored entries) and is predicted on the device from 20 000
rows up; ``lgb.cv`` cross-validates on ``Dataset.subset`` folds, and
``lgb.reset_parameter`` changes parameters between iterations.

Ranking takes the query sizes in row order (``lgb.Dataset(X, label=y,
group=sizes)``, or ``lgb.LGBMRanker().fit(X, y, group=sizes)``).

A saved model is served with zero boosting rounds on its training data:
``lgb.train(params, lgb.Dataset(X, label=y), 0, init_model="model.txt")``.
Entry points run on ``device_type="cuda"`` unless the caller passes
``device_type="cpu"``.  Importing the package builds no kernel.
"""
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .engine import CVBooster, cv, train
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Dataset", "Booster", "train", "cv", "CVBooster",
           "early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "EarlyStopException",
           "LightGBMError", "LGBMModel", "LGBMRegressor", "LGBMClassifier",
           "LGBMRanker"]
