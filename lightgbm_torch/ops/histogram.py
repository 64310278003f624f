"""Histogram construction, the hot op of training: the plain contract.

The port's counterpart of ``lightgbm_tpu/ops/histogram.py`` (``_hist_segsum``
:84 and ``hist_subtract`` :261).  For S histogram slots, G groups and Bmax
bins, ``hist[s, g, b] = (sum of grad, sum of hess)`` over the rows n with
``slot[n] == s`` and ``bins_T[g, n] == b``; rows whose slot is negative add
nothing.  Counts are exact per-slot sums of the 0/1 count weights.

Sums are exact fixed-point: every weight is rounded once to an integer
multiple of 2**-shift (``quantize``) and the integers are added in int64, so
the order of the adds cannot change a bit and the CUDA kernel
(kernels/csrc/route_and_hist.cu) equals this plain version on any inputs.
``hist_shift`` picks the largest shift at which no int64 sum can overflow.
Each cell is then one correctly rounded float32 of an exact sum: within
half an ulp of the true sum of the quantized weights, which is closer to the
exact float sum than a float32 running sum gets.  Weights that are dyadic
(multiples of 2**-shift) are not changed by the rounding, so on such inputs
the histogram equals every exact formulation bit for bit.
"""
from __future__ import annotations

import math

import torch

# |shift| stays inside float32's normal exponent range, so 2**shift and
# 2**-shift are exact float32 scales
MAX_SHIFT = 126


def hist_shift(max_abs: float, n_rows: int) -> int:
    """The power-of-two scale exponent for weights with ``max |w| <=
    max_abs`` summed over at most ``n_rows`` rows: each quantized weight is
    below 2**(62 - bits(n_rows)) in magnitude, so any sum of them stays
    below 2**62."""
    if not (max_abs > 0.0 and math.isfinite(max_abs)):
        return 0
    _, k = math.frexp(max_abs)               # max_abs < 2**k
    e = 62 - max(int(n_rows), 1).bit_length() - k
    return max(-MAX_SHIFT, min(MAX_SHIFT, e))


def quantize(w: torch.Tensor, shift: int) -> torch.Tensor:
    """int64 round-half-even(w * 2**shift), the float32 product exact."""
    return torch.round(w * (2.0 ** shift)).to(torch.int64)


def dequantize(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """float32 of an int64 sum (one rounding), times the exact 2**-shift."""
    return acc.to(torch.float32) * (2.0 ** -shift)


def build_histograms(bins_T: torch.Tensor, slot: torch.Tensor,
                     grad: torch.Tensor, hess: torch.Tensor,
                     cnt: torch.Tensor, num_slots: int, max_bins: int,
                     shift: int):
    """(S, G, Bmax, 2) float32 grad/hess histograms and (S,) float32 exact
    counts of the rows' slots.  bins_T: (G, N) uint8; slot: (N,) int32;
    grad, hess, cnt: (N,) float32."""
    G = bins_T.shape[0]
    dev = bins_T.device
    keep = torch.nonzero(slot >= 0).flatten()
    s = slot[keep].to(torch.int64)
    qg = quantize(grad[keep], shift)
    qh = quantize(hess[keep], shift)
    acc = torch.zeros(num_slots * G * max_bins * 2, dtype=torch.int64,
                      device=dev)
    for g in range(G):
        cell = ((s * G + g) * max_bins + bins_T[g, keep].to(torch.int64)) * 2
        acc.index_add_(0, cell, qg)
        acc.index_add_(0, cell + 1, qh)
    hist = dequantize(acc, shift).reshape(num_slots, G, max_bins, 2)
    return hist, slot_counts(slot, cnt, num_slots)


def slot_counts(slot: torch.Tensor, cnt: torch.Tensor,
                num_slots: int) -> torch.Tensor:
    """(S,) float32 exact sums of the 0/1 count weights of each slot's rows
    (int64 sums, one conversion)."""
    keep = torch.nonzero(slot >= 0).flatten()
    counts = torch.zeros(num_slots, dtype=torch.int64, device=slot.device)
    counts.index_add_(0, slot[keep].to(torch.int64),
                      torch.round(cnt[keep]).to(torch.int64))
    return counts.to(torch.float32)


def hist_subtract(parent: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """The larger sibling's histogram (reference: serial_tree_learner.cpp:481
    use_subtract)."""
    return parent - child
