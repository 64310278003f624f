"""CUDA graphs of the fused iteration: each static shape captured once, then
replayed.

The fused iteration (models/gbdt.py ``_iter_fused``) runs in three kinds of
step: the head (gradients through the root pass), the rounds of a tree, and
the tail (the sprint, K3's replay, K4's score add).  ``GraphRunner.run(key,
fn)`` runs one step.  On the CPU it calls ``fn``.  On a CUDA device the first
run of a key calls ``fn`` eagerly, which also warms every lazy load on its
path (a kernel library, a device copy of the labels); the second captures
``fn`` into a CUDA graph and replays it; every later run replays the graph.
All graphs of a device, those of every engine in the process, share one
memory pool: every tensor that outlives a step is allocated before any
capture and written in place, and the steps run one at a time on the
current stream, so the pool holds only the temporaries of the step that
runs.  Engines trained side by side (``cv``'s folds, a reset's new
runner) thus share the largest step's temporaries instead of holding
one pool each.  A failed capture or replay raises: nothing falls back to
the eager path.

The kernel wrappers count a launch where their Python code launches the
kernel, which a capture runs once and a replay not at all.  So a capture's
counts are taken back (it launched nothing), and each replay credits the
wrappers with its graph's launches: ``kernels.launch_counts`` stays the
number of kernels the card ran.

``uncaptured()`` makes every step run ``fn`` while it is active, so that
a caller can watch the kernels' Python wrappers (chip_smoke.py's launch
capture) on the same code and shapes the graphs hold.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable

import torch

_UNCAPTURED = [0]
# device -> the graph memory pool every runner on it captures into
_POOLS: Dict[torch.device, tuple] = {}


@contextlib.contextmanager
def uncaptured():
    """Run every step of every ``GraphRunner`` without a graph while
    active."""
    _UNCAPTURED[0] += 1
    try:
        yield
    finally:
        _UNCAPTURED[0] -= 1


def _counts():
    from .. import kernels
    return kernels.launch_counts(), kernels.wide_launch_counts()


def _add_counts(launches: Dict[str, int], wide: Dict[str, int],
                sign: int = 1) -> None:
    from .. import kernels
    for name, n in launches.items():
        kernels.WRAPPERS[name].launches += sign * n
    for name, n in wide.items():
        kernels.WRAPPERS[name].wide_launches += sign * n


class GraphRunner:
    """The captured steps of one engine, by key.  ``replays``, ``captures``
    and ``eager_runs`` count what ``run`` did."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: Dict[Hashable, tuple] = {}
        self.seen = set()
        self.pool = None
        self.replays = self.captures = self.eager_runs = 0

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        if self.device.type != "cuda" or _UNCAPTURED[0]:
            fn()
            self.eager_runs += 1
            return
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self.seen:
                self.seen.add(key)
                fn()
                self.eager_runs += 1
                return
            entry = self.graphs[key] = self._capture(fn)
        graph, launches, wide = entry
        graph.replay()
        _add_counts(launches, wide)
        self.replays += 1

    def _capture(self, fn):
        if self.pool is None:
            self.pool = _POOLS.get(self.device)
            if self.pool is None:
                self.pool = _POOLS[self.device] = \
                    torch.cuda.graph_pool_handle()
        before, wide_before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            fn()
        after, wide_after = _counts()
        launches = {k: after[k] - before[k] for k in after}
        wide = {k: wide_after[k] - wide_before[k] for k in wide_after}
        # the capture enqueued the launches and ran none of them
        _add_counts(launches, wide, -1)
        self.captures += 1
        return graph, launches, wide
