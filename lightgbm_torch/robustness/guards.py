"""Non-finite guards (param ``nan_guard``).

The port's copy of ``lightgbm_tpu/robustness/guards.py`` (:20-121), trimmed
to what the port reads.  A single NaN gradient poisons every later tree:
the leaf sums go NaN, the split scan picks garbage, and the score never
recovers.  Each iteration computes one all-finite flag over the gradients
and hessians on the device and, when it trips, zeroes them: an all-zero
gradient grows an exact single-leaf no-op tree, so the poisoned iteration
is skipped without moving any later iteration's random streams.  The same
policy covers the init scores of a training Dataset and the trees of a
model that seeds continued training.

Modes: ``warn`` (default: log, skip, count), ``skip`` (skip silently),
``raise`` (abort with :class:`LightGBMError`), ``none`` (guard off).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.log import LightGBMError, log_warning

VALID_MODES = ("warn", "skip", "raise", "none")


def resolve_mode(mode: str) -> str:
    m = str(mode or "warn").strip().lower()
    if m not in VALID_MODES:
        raise LightGBMError(
            f"nan_guard={mode!r} is not one of {', '.join(VALID_MODES)}")
    return m


class NanGuard:
    """Per-engine guard state: counts the poisoned iterations (``hits``)
    and applies the configured policy to each one the engine reports."""

    def __init__(self, mode: str, objective_name: str = ""):
        self.mode = resolve_mode(mode)
        self.enabled = self.mode != "none"
        self.objective_name = objective_name or "none"
        self.hits = 0

    def record(self, iteration: int) -> None:
        """Iteration ``iteration`` (0-based) had non-finite gradients."""
        self.hits += 1
        msg = (f"non-finite gradients/hessians at iteration {iteration + 1} "
               f"(objective={self.objective_name})")
        if self.mode == "raise":
            raise LightGBMError(f"nan_guard=raise: {msg}")
        if self.mode == "warn":
            log_warning(f"nan_guard: {msg}; skipping the poisoned iteration")


def check_finite_init(arr: np.ndarray, what: str,
                      mode: str) -> Optional[np.ndarray]:
    """Guard an init-score array: non-finite entries are zeroed
    (``warn``/``skip``) or fatal (``raise``); ``none`` passes through."""
    mode = resolve_mode(mode)
    if mode == "none" or arr is None:
        return arr
    a = np.asarray(arr)
    bad = ~np.isfinite(a)
    nbad = int(bad.sum())
    if nbad == 0:
        return arr
    if mode == "raise":
        raise LightGBMError(
            f"nan_guard=raise: {what} contains {nbad} non-finite value(s)")
    if mode == "warn":
        log_warning(f"nan_guard: {what} contains {nbad} non-finite value(s); "
                    "replacing with 0")
    out = a.copy()
    out[bad] = 0.0
    return out


def check_model_trees(trees, what: str = "model") -> None:
    """Reject a model with poisoned trees before it seeds continued
    training: NaN or infinite leaf values or NaN split gains mean the source
    run was already corrupt and every further tree would inherit it.
    (Thresholds may be +-inf: last-bin boundaries.)"""
    for i, t in enumerate(trees):
        lv = np.asarray(t.leaf_value, np.float64)
        if not np.all(np.isfinite(lv)):
            raise LightGBMError(
                f"non-finite leaf values in {what} (tree {i}); refusing to "
                "continue training from a poisoned model")
        sg = np.asarray(t.split_gain, np.float64)
        if sg.size and np.any(np.isnan(sg)):
            raise LightGBMError(
                f"non-finite split gains in {what} (tree {i}); refusing to "
                "continue training from a poisoned model")
