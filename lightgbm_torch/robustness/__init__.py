"""Robustness guards of training (the port's copy of what it uses of
``lightgbm_tpu/robustness/``)."""
