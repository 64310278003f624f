"""Per-phase wall time of the training loop, for measurement runs.

A ``PhaseTimer`` handed to the engine times each named phase on the host
clock, synchronising the device at both ends so a phase owns the device
work it enqueued, and counts the host reads the loop makes.  Without a
timer the loop runs unsynchronised.  ``host_reads()`` counts every read
``host_int`` and ``host_list`` made in the process, timer or not.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = defaultdict(float)
        self.host_reads = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0


def phase(timer, name: str):
    """``timer(name)``, or a no-op context when there is no timer."""
    return contextlib.nullcontext() if timer is None else timer(name)


_READS = [0]


def host_reads() -> int:
    """Host reads made through ``host_int`` and ``host_list`` so far."""
    return _READS[0]


def host_int(t: torch.Tensor, timer=None) -> int:
    """Read a device scalar on the host (one device sync), counted."""
    _READS[0] += 1
    if timer is not None:
        timer.host_reads += 1
    return int(t.item())


def host_list(t: torch.Tensor, timer=None) -> list:
    """Read a small device tensor on the host as a list (one device sync),
    counted."""
    _READS[0] += 1
    if timer is not None:
        timer.host_reads += 1
    return t.tolist()
