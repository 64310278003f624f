"""Slot histograms of rows in their natural order.  The CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/scatter_hist_kernel.py:122-132``
(``build_histograms_scatter``, the ``_hist_scatter`` kernel, single class).
Given the (G, N) bins (uint8, or the int16 storage of 16-bit bins,
kernels/layout.py), each row's (N,) int32 histogram slot (negative:
the row adds nothing) and the (N,) float32 grad, hess and count weights, it
returns the (S, G, Bmax, 3) float32 (grad, hess, count) histograms: grad and
hess exact fixed point at ``shift``, counts exact (ops/histogram.py).  The
TPU kernel's VMEM gate (Bmax <= 128, G <= 64) and one-hot fallback are not
copied: the kernel takes any Bmax (up to 65 536 over 16-bit bins) and any
G.  It is K8's kernel
(``csrc/hist_rows.cu``) at K = 1 with the scale passed by value, under
K8's launch plan (``hist_wide.hist_plan``).  ``scatter_hist`` launches
the kernel for tensors on a CUDA device and runs ``scatter_hist_plain``
only for tensors on the CPU; a kernel that fails to build or launch
raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import hist3_plain
from ..utils.log import LightGBMError
from . import build
from .hist_wide import hist_plan, plan_arg
from .layout import bin_bytes


def scatter_hist(bins_T, slot, grad, hess, cnt, num_slots: int,
                 max_bins: int, shift: int) -> torch.Tensor:
    """(S, G, Bmax, 3) float32 histograms of the rows' slots."""
    if bins_T.device.type == "cuda":
        return scatter_hist_cuda(bins_T, slot, grad, hess, cnt, num_slots,
                                 max_bins, shift)
    if bins_T.device.type == "cpu":
        return scatter_hist_plain(bins_T, slot, grad, hess, cnt, num_slots,
                                  max_bins, shift)
    raise LightGBMError(f"scatter_hist has no kernel for device "
                        f"{bins_T.device}")


def scatter_hist_plain(bins_T, slot, grad, hess, cnt, num_slots: int,
                       max_bins: int, shift: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's contract."""
    return hist3_plain(bins_T, slot, grad, hess, cnt, num_slots, max_bins,
                       shift)


def scatter_hist_cuda(bins_T, slot, grad, hess, cnt, num_slots: int,
                      max_bins: int, shift: int) -> torch.Tensor:
    """Launch csrc/hist_rows.cu (``lgbt_scatter_hist``, K8's kernel at
    K = 1) on the current stream, under ``hist_wide.hist_plan`` of the
    shapes."""
    dev = bins_T.device
    width = bin_bytes(bins_T)
    build.check_operands("scatter_hist", dev, (
        ("bins_T", bins_T, bins_T.dtype), ("slot", slot, torch.int32),
        ("grad", grad, torch.float32), ("hess", hess, torch.float32),
        ("cnt", cnt, torch.float32)))
    G, n = bins_T.shape
    if (any(tuple(x.shape) != (n,) for x in (slot, grad, hess, cnt))
            or num_slots < 1 or not 0 < max_bins <= 256 ** width or G < 1):
        raise LightGBMError("scatter_hist: shapes do not agree")
    plan = hist_plan(n, G, 1, num_slots, max_bins)
    hist = torch.empty((num_slots, G, max_bins, 3), dtype=torch.float32,
                       device=dev)
    acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    fn = build.load("scatter_hist").lgbt_scatter_hist
    rc = fn(bins_T.data_ptr(), width, n, G, slot.data_ptr(), grad.data_ptr(),
            hess.data_ptr(), cnt.data_ptr(), num_slots, max_bins,
            float(2.0 ** shift), float(2.0 ** -shift), acc.data_ptr(),
            hist.data_ptr(), plan_arg(plan),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"scatter_hist kernel launch failed "
                            f"(cudaError {rc}, plan {tuple(plan)})")
    build.count_launch(scatter_hist_cuda, width)
    return hist


build.init_counts(scatter_hist_cuda)
