"""Leveled logging with a redirectable callback.

Reference: include/LightGBM/utils/log.h:79-181 (Log class with Fatal/Warning/Info/Debug and a
resettable callback) and python-package/lightgbm/basic.py:215 (register_logger).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Optional

_logger: Any = logging.getLogger("lightgbm_torch")
# guard against duplicate handlers on re-import/reload, and respect a logger
# the user configured before importing this package: only attach our default
# StreamHandler when none exists, and only set a level when none was chosen
if not _logger.handlers:
    _logger.addHandler(logging.StreamHandler())
if _logger.level == logging.NOTSET:
    _logger.setLevel(logging.INFO)

_info_method_name = "info"
_warning_method_name = "warning"

# verbosity: <0 fatal only, 0 warning+, 1 info+, >=2 debug+
_verbosity = 1


def register_logger(logger: Any, info_method_name: str = "info",
                    warning_method_name: str = "warning") -> None:
    """Redirect framework logging to a custom logger (parity: lightgbm.register_logger)."""
    global _logger, _info_method_name, _warning_method_name
    if not (hasattr(logger, info_method_name) and hasattr(logger, warning_method_name)):
        raise TypeError("logger must provide the given info/warning methods")
    _logger = logger
    _info_method_name = info_method_name
    _warning_method_name = warning_method_name


def set_verbosity(v: int) -> None:
    global _verbosity
    _verbosity = int(v)


def get_verbosity() -> int:
    return _verbosity


def log_debug(msg: str) -> None:
    if _verbosity >= 2:
        getattr(_logger, _info_method_name)(f"[LightGBM-Torch] [Debug] {msg}")


def log_info(msg: str) -> None:
    if _verbosity >= 1:
        getattr(_logger, _info_method_name)(f"[LightGBM-Torch] [Info] {msg}")


def log_warning(msg: str) -> None:
    if _verbosity >= 0:
        getattr(_logger, _warning_method_name)(f"[LightGBM-Torch] [Warning] {msg}")


class LightGBMError(Exception):
    """Error raised by the framework (parity: lightgbm.basic.LightGBMError)."""


def log_fatal(msg: str) -> None:
    raise LightGBMError(msg)
