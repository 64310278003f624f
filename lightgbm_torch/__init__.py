"""lightgbm_torch — the PyTorch/CUDA port of lightgbm_tpu.

Batch prediction runs on an NVIDIA Hopper GPU through hand-written CUDA
kernels (``kernels/``); training is not ported yet.  Serve a saved model
with zero boosting rounds on its training data:

    import lightgbm_torch as lgb
    bst = lgb.train(params, lgb.Dataset(X_train, label=y),
                    num_boost_round=0, init_model="model.txt")
    bst.predict(X)

Entry points run on ``device_type="cuda"`` unless the caller passes
``device_type="cpu"``.  Importing the package builds no kernel.
"""
from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Dataset", "Booster", "train", "LightGBMError"]
