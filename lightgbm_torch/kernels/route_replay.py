"""Route replay: every row's leaf after a tree's growth rounds, in one pass.
The CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/stream_kernel.py:636-711``
(``route_replay``).  A sampled tree grows on the compacted in-bag rows
(ops/compact.py); the rows outside the view still need their leaf for the
score update.  Instead of one route-only K2 pass over all N rows per
round, the grower keeps each round's (L, 16) int32 route records
(kernels/layout.py) and this kernel applies rounds 0..R-1 in order to every
row, starting from leaf 0, with the numeric decision of K2's route step
(EFB unbundling, NaN and zero-as-missing default directions, the
threshold).  The grower sends no categorical tree here, as in the
reference.  The result equals the chain of route-only K2 passes row for
row.  ``route_replay`` launches the kernel for tensors on a CUDA device and
runs ``route_replay_plain`` only for tensors on the CPU; a kernel that fails
to build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError
from . import build
from .layout import R_CHOSEN, R_NEWID, ROUTE_FIELDS
from .route_hist import numeric_go_left


def route_replay(bins_T: torch.Tensor, tabs: torch.Tensor) -> torch.Tensor:
    """(N,) int32 leaf of every row after the (R, L, 16) int32 route
    records ``tabs``, applied in order from leaf 0; bins_T: (G, N) uint8."""
    if bins_T.device.type == "cuda":
        return route_replay_cuda(bins_T, tabs)
    if bins_T.device.type == "cpu":
        return route_replay_plain(bins_T, tabs)
    raise LightGBMError(f"route_replay has no kernel for device "
                        f"{bins_T.device}")


def route_replay_plain(bins_T: torch.Tensor,
                       tabs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: K2's numeric route step, round by round."""
    n = bins_T.shape[1]
    rows = torch.arange(n, device=bins_T.device)
    lid = torch.zeros(n, dtype=torch.int32, device=bins_T.device)
    for r in range(tabs.shape[0]):
        rec = tabs[r][lid.to(torch.int64)]
        go_left, _ = numeric_go_left(bins_T, rows, rec)
        lid = torch.where((rec[:, R_CHOSEN] > 0) & ~go_left, rec[:, R_NEWID],
                          lid)
    return lid


def route_replay_cuda(bins_T: torch.Tensor,
                      tabs: torch.Tensor) -> torch.Tensor:
    """Launch csrc/route_replay.cu on the current stream."""
    dev = bins_T.device
    for name, x, dtype in (("bins_T", bins_T, torch.uint8),
                           ("tabs", tabs, torch.int32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise LightGBMError(
                f"route_replay: {name} must be a contiguous {dtype} tensor "
                f"on {dev}, got {x.dtype} on {x.device}")
    if (bins_T.dim() != 2 or tabs.dim() != 3
            or tabs.shape[2] != len(ROUTE_FIELDS)):
        raise LightGBMError("route_replay: shapes do not agree")
    n = bins_T.shape[1]
    R, L = tabs.shape[0], tabs.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    fn = build.load("route_replay").lgbt_route_replay
    rc = fn(bins_T.data_ptr(), n, tabs.data_ptr(), R, L, out.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"route_replay kernel launch failed "
                            f"(cudaError {rc})")
    route_replay_cuda.launches += 1
    return out


route_replay_cuda.launches = 0
