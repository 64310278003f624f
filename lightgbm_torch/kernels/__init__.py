"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper launches its kernel for CUDA tensors and the plain
version runs only for CPU tensors.  Importing this package builds nothing:
``build.py`` compiles a kernel at its first launch.

- ``predict_stream`` (K1, predict.py): batch prediction, every row through
  every tree.
- ``predict_leaf`` (K1's leaf form, predict.py): every row's leaf in
  every tree (``pred_leaf``).
- ``route_and_hist`` (K2, route_hist.py): one growth round of training,
  rows routed through the round's splits and the histograms of their new
  slots built.
- ``route_and_hist_int`` (K2's int form, route_hist.py): the same round of
  quantized-gradient training, exact int32 histograms of int8 grid values.
- ``route_replay`` (K3, route_replay.py): a sampled tree's rounds replayed
  over all rows in one pass, every row's leaf.
- ``leaf_gather`` (K4, leaf_gather.py): the score update's
  ``values[leaf_id]``.
- ``scatter_hist`` (K5, scatter_hist.py): slot histograms of rows in their
  natural order (``hist_backend="scatter"``).
- ``hist_direct`` and ``hist_nibble`` (K6 for Bmax <= 128, K7 above;
  hist_sorted.py): slot histograms over slot-sorted row blocks
  (``hist_backend="pallas"``).
- ``hist_wide`` (K8, hist_wide.py): the K class trees' slot histograms of
  batched multiclass in one pass over the rows (``scatter`` and
  ``pallas``); K2 has a class axis of its own for ``stream``.
- ``bin_rows`` (bin_rows.py, no TPU kernel: the counterpart of the JAX
  package's native host binner): raw float64 rows to group bins, for
  ``Dataset.construct`` and ``Booster.predict`` on the card.
- ``bin_csr`` (bin_csr.py, no TPU kernel: the counterpart of the JAX
  package's host ``construct_binned_sparse``): SciPy CSR rows to group
  bins, for a sparse ``Dataset`` and ``Booster.predict`` on SciPy rows.
- ``tree_shap`` (tree_shap.py, no TPU kernel: the JAX package's device
  TreeSHAP is a jitted ``lax.scan``): float64 TreeSHAP contributions of
  every row (``pred_contrib``).

Each CUDA wrapper counts its launches in a plain integer attribute
``launches``; ``launch_counts`` reads them and ``reset_launch_counts`` sets
them to zero, so a run can show that its path went through the kernels.
The wrappers whose kernels read or write bins also count the launches over
16-bit bins (groups wider than 256 bins) in ``wide_launches``
(``wide_launch_counts``).
"""
from __future__ import annotations

from typing import Dict

from . import (bin_csr, bin_rows, hist_sorted, hist_wide, leaf_gather, predict,
               route_hist, route_replay, scatter_hist, tree_shap)

# kernel name -> its CUDA wrapper
WRAPPERS = {
    "predict_stream": predict.predict_stream_cuda,
    "route_and_hist": route_hist.route_and_hist_cuda,
    "route_and_hist_int": route_hist.route_and_hist_int_cuda,
    "route_replay": route_replay.route_replay_cuda,
    "leaf_gather": leaf_gather.leaf_gather_cuda,
    "scatter_hist": scatter_hist.scatter_hist_cuda,
    "hist_direct": hist_sorted.hist_direct_cuda,
    "hist_nibble": hist_sorted.hist_nibble_cuda,
    "hist_wide": hist_wide.hist_wide_cuda,
    "bin_rows": bin_rows.bin_rows_cuda,
    "predict_leaf": predict.predict_leaf_cuda,
    "tree_shap": tree_shap.tree_shap_cuda,
    "bin_csr": bin_csr.bin_csr_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def wide_launch_counts() -> Dict[str, int]:
    """Launches over 16-bit bins, of each wrapper that has that form."""
    return {name: fn.wide_launches for name, fn in WRAPPERS.items()
            if hasattr(fn, "wide_launches")}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "wide_launches"):
            fn.wide_launches = 0
