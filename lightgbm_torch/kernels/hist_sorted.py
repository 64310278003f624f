"""Slot histograms over slot-sorted row blocks.  The CUDA kernels' wrappers
and their plain PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/hist_kernel.py:357-393``
(``build_histograms_sorted``: the ``_hist_direct`` kernel for Bmax <= 128,
``_hist_nibble`` above).  Given the row-major (N, G) uint8 bins, a block
plan (ops/compact.py: the (NB*T,) int32 gather index of every block
position, the pad row N where a position is past its slot's run, and the
(NB, 3) int32 (slot, first, last) of every block) and the (N,) float32
grad, hess and count weights, it returns the (S, G, Bmax, 3) float32
(grad, hess, count) histograms of the plan's slots: grad and hess exact
fixed point at ``shift``, counts exact (ops/histogram.py), slots with no
rows zero.  The TPU's one-hot contraction, its 16-bin hi/lo split, its
bf16 hi/lo weights and its four-bins-per-int32 packing are not copied.
``hist_sorted`` launches K6 (``hist_direct_cuda``) or K7
(``hist_nibble_cuda``) for tensors on a CUDA device and runs
``hist_sorted_plain`` only for tensors on the CPU; a kernel that fails to
build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import hist3_plain
from ..utils.log import LightGBMError
from . import build

# the largest Bmax K6 takes; K7 takes the rest up to 256
DIRECT_MAX_BINS = 128


def hist_sorted(bins, gather_idx, scalars, grad, hess, cnt, num_slots: int,
                max_bins: int, shift: int, block_rows: int) -> torch.Tensor:
    """(S, G, Bmax, 3) float32 histograms of the plan's slots."""
    if bins.device.type == "cuda":
        kernel = (hist_direct_cuda if max_bins <= DIRECT_MAX_BINS
                  else hist_nibble_cuda)
        return kernel(bins, gather_idx, scalars, grad, hess, cnt, num_slots,
                      max_bins, shift, block_rows)
    if bins.device.type == "cpu":
        return hist_sorted_plain(bins, gather_idx, scalars, grad, hess, cnt,
                                 num_slots, max_bins, shift, block_rows)
    raise LightGBMError(f"hist_sorted has no kernel for device "
                        f"{bins.device}")


def hist_sorted_plain(bins, gather_idx, scalars, grad, hess, cnt,
                      num_slots: int, max_bins: int, shift: int,
                      block_rows: int) -> torch.Tensor:
    """Plain PyTorch version: every plan position that holds a row, with its
    block's slot, through the 3-channel contract."""
    idx = gather_idx.to(torch.int64)
    slot = scalars[:, 0].repeat_interleave(block_rows)
    keep = (idx < bins.shape[0]) & (slot >= 0) & (slot < num_slots)
    rows = idx[keep]
    return hist3_plain(bins[rows].t(), slot[keep], grad[rows], hess[rows],
                       cnt[rows], num_slots, max_bins, shift)


def _launch(kernel: str, bins, gather_idx, scalars, grad, hess, cnt,
            num_slots: int, max_bins: int, shift: int,
            block_rows: int) -> torch.Tensor:
    dev = bins.device
    build.check_operands(kernel, dev, (
        ("bins", bins, torch.uint8), ("gather_idx", gather_idx, torch.int32),
        ("scalars", scalars, torch.int32), ("grad", grad, torch.float32),
        ("hess", hess, torch.float32), ("cnt", cnt, torch.float32)))
    n, G = bins.shape
    nb = scalars.shape[0]
    if (any(tuple(x.shape) != (n,) for x in (grad, hess, cnt))
            or tuple(scalars.shape) != (nb, 3)
            or tuple(gather_idx.shape) != (nb * block_rows,)
            or num_slots < 1 or G < 1 or block_rows < 1):
        raise LightGBMError(f"{kernel}: shapes do not agree")
    hist = torch.empty((num_slots, G, max_bins, 3), dtype=torch.float32,
                       device=dev)
    acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    fn = getattr(build.load(kernel), build.SIGNATURES[kernel][0])
    rc = fn(bins.data_ptr(), n, G, gather_idx.data_ptr(), scalars.data_ptr(),
            nb, block_rows, grad.data_ptr(), hess.data_ptr(), cnt.data_ptr(),
            num_slots, max_bins, float(2.0 ** shift), float(2.0 ** -shift),
            acc.data_ptr(), hist.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"{kernel} kernel launch failed (cudaError {rc})")
    return hist


def hist_direct_cuda(bins, gather_idx, scalars, grad, hess, cnt,
                     num_slots: int, max_bins: int, shift: int,
                     block_rows: int) -> torch.Tensor:
    """Launch K6 (csrc/hist_sorted.cu, Bmax <= 128) on the current stream."""
    if not 0 < max_bins <= DIRECT_MAX_BINS:
        raise LightGBMError(f"hist_direct takes Bmax <= {DIRECT_MAX_BINS}, "
                            f"got {max_bins}")
    hist = _launch("hist_direct", bins, gather_idx, scalars, grad, hess, cnt,
                   num_slots, max_bins, shift, block_rows)
    hist_direct_cuda.launches += 1
    return hist


def hist_nibble_cuda(bins, gather_idx, scalars, grad, hess, cnt,
                     num_slots: int, max_bins: int, shift: int,
                     block_rows: int) -> torch.Tensor:
    """Launch K7 (csrc/hist_sorted.cu, 128 < Bmax <= 256) on the current
    stream."""
    if not DIRECT_MAX_BINS < max_bins <= 256:
        raise LightGBMError(f"hist_nibble takes {DIRECT_MAX_BINS} < Bmax <= "
                            f"256, got {max_bins}")
    hist = _launch("hist_nibble", bins, gather_idx, scalars, grad, hess, cnt,
                   num_slots, max_bins, shift, block_rows)
    hist_nibble_cuda.launches += 1
    return hist


hist_direct_cuda.launches = 0
hist_nibble_cuda.launches = 0
