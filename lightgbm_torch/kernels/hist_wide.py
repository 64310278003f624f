"""K-class slot histograms of rows in their natural order (batched
multiclass).  The CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/hist_kernel.py:305-354``
(``build_histograms_wide``, the ``_hist_wide`` kernel) and of the K-class
form of ``lightgbm_tpu/pallas/scatter_hist_kernel.py``
(``build_histograms_scatter_k``), which compute the same function.  Given
the (G, N) uint8 bins, each class's (K, N) int32 histogram slot of every row
(negative: the row adds nothing to that class), the (K, N) float32 grad and
hess, the (N,) count weights shared by the classes and one fixed-point shift
per class, it returns the (K, S, G, Bmax, 3) float32 (grad, hess, count)
histograms: class k's grad and hess exact fixed point at its shift, counts
exact (ops/histogram.py).  The TPU kernel's VMEM gate (``wide_hist_fits``:
Bmax <= 128 and a 12 MB block) and its per-class fallback are not copied:
the kernel takes any Bmax <= 256 and any K * S.  ``hist_wide`` launches the
kernel for tensors on a CUDA device and runs ``hist_wide_plain`` only for
tensors on the CPU; a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import hist3_plain, scale_table
from ..utils.log import LightGBMError
from . import build
from .scatter_hist import check_operands


def hist_wide(bins_T, slot, grad, hess, cnt, num_slots: int, max_bins: int,
              shifts, scales=None) -> torch.Tensor:
    """(K, S, G, Bmax, 3) float32 histograms of each class's slots;
    ``scales`` is the (2, K) device table of ``shifts``
    (ops/histogram.scale_table), or None to build it here."""
    if bins_T.device.type == "cuda":
        return hist_wide_cuda(bins_T, slot, grad, hess, cnt, num_slots,
                              max_bins, shifts, scales)
    if bins_T.device.type == "cpu":
        return hist_wide_plain(bins_T, slot, grad, hess, cnt, num_slots,
                               max_bins, shifts, scales)
    raise LightGBMError(f"hist_wide has no kernel for device "
                        f"{bins_T.device}")


def hist_wide_plain(bins_T, slot, grad, hess, cnt, num_slots: int,
                    max_bins: int, shifts, scales=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract: ``hist3_plain`` once
    per class (``scales`` is the kernel's copy of ``shifts`` and is not
    read)."""
    return torch.stack([hist3_plain(bins_T, slot[k], grad[k], hess[k], cnt,
                                    num_slots, max_bins, shifts[k])
                        for k in range(slot.shape[0])])


def hist_wide_cuda(bins_T, slot, grad, hess, cnt, num_slots: int,
                   max_bins: int, shifts, scales=None) -> torch.Tensor:
    """Launch csrc/hist_wide.cu on the current stream."""
    dev = bins_T.device
    if scales is None:
        scales = scale_table(shifts, dev)
    check_operands("hist_wide", dev, (
        ("bins_T", bins_T, torch.uint8), ("slot", slot, torch.int32),
        ("grad", grad, torch.float32), ("hess", hess, torch.float32),
        ("cnt", cnt, torch.float32), ("scales", scales, torch.float32)))
    G, n = bins_T.shape
    K = slot.shape[0] if slot.dim() == 2 else 0
    if (K < 1 or any(tuple(x.shape) != (K, n) for x in (slot, grad, hess))
            or tuple(cnt.shape) != (n,) or len(shifts) != K
            or tuple(scales.shape) != (2, K)
            or num_slots < 1 or not 0 < max_bins <= 256 or G < 1):
        raise LightGBMError("hist_wide: shapes do not agree")
    hist = torch.empty((K, num_slots, G, max_bins, 3), dtype=torch.float32,
                       device=dev)
    acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    fn = build.load("hist_wide").lgbt_hist_wide
    rc = fn(bins_T.data_ptr(), n, G, K, slot.data_ptr(), grad.data_ptr(),
            hess.data_ptr(), cnt.data_ptr(), num_slots, max_bins,
            scales.data_ptr(), acc.data_ptr(), hist.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"hist_wide kernel launch failed "
                            f"(cudaError {rc})")
    hist_wide_cuda.launches += 1
    return hist


hist_wide_cuda.launches = 0
