"""Histogram construction, the hot op of training: the plain contracts and
the backend dispatch.

The port's counterpart of ``lightgbm_tpu/ops/histogram.py``
(``build_histograms`` :35-81, ``_hist_segsum`` :84 and ``hist_subtract``
:261).  For S histogram slots, G groups and Bmax bins, ``hist[s, g, b]`` is
the sum of each channel over the rows n with ``slot[n] == s`` and
``bins_T[g, n] == b``; rows whose slot is negative add nothing.  Two plain
versions:

- ``build_histograms_gh``: (S, G, Bmax, 2) grad/hess histograms and (S,)
  exact counts, the contract of K2 (kernels/route_hist.py);
- ``hist3_plain``: (S, G, Bmax, 3) histograms whose third channel is the
  exact count, the contract of K5, K6 and K7 (kernels/scatter_hist.py,
  kernels/hist_sorted.py), which ``build_histograms`` dispatches to for the
  ``scatter`` and ``pallas`` backends;
- per class, ``hist3_plain`` is the contract of K8 (kernels/hist_wide.py),
  which ``build_histograms_k`` dispatches to for K class trees grown
  together: (K, S, G, Bmax, 3) histograms, one shift per class;
- ``build_histograms_int``: (K, S, G, Bmax, 2) int32 sums of quantized
  gradients' integer grid values, the contract of K2's int form
  (kernels/route_hist.py ``route_and_hist_int``).

Sums are exact fixed-point: every weight is rounded once to an integer
multiple of 2**-shift (``quantize``) and the integers are added in int64, so
the order of the adds cannot change a bit and the CUDA kernels equal these
plain versions on any inputs.  Count weights are rounded to integers and
summed exactly.  ``hist_shift`` picks the largest shift at which no int64
sum can overflow.  Each cell is then one correctly rounded float32 of an
exact sum: within half an ulp of the true sum of the quantized weights,
which is closer to the exact float sum than a float32 running sum gets.
Weights that are dyadic (multiples of 2**-shift) are not changed by the
rounding, so on such inputs the histogram equals every exact formulation
bit for bit.  Bins are uint8, or the int16 storage of 16-bit bins, read as
unsigned (``kernels.layout.bin_values``).
"""
from __future__ import annotations

import math

import torch

from ..kernels.layout import bin_values

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


def hist_shifts(max_abs: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``hist_shift`` of each value of a float32 tensor, on its device with
    no host read: (K,) int64."""
    _, k = torch.frexp(max_abs)
    e = 62 - max(int(n_rows), 1).bit_length() - k.to(torch.int64)
    e = torch.clamp(e, -MAX_SHIFT, MAX_SHIFT)
    return torch.where((max_abs > 0) & torch.isfinite(max_abs), e, 0)


def pow2(shift):
    """2.0 ** shift, exact: a Python float for an int, else a float32
    tensor built from its exponent bits (|shift| <= MAX_SHIFT)."""
    if not isinstance(shift, torch.Tensor):
        return 2.0 ** shift
    return ((shift.to(torch.int32) + 127) << 23).view(torch.float32)


def scale_table_dev(shifts: torch.Tensor) -> torch.Tensor:
    """``scale_table`` of a (K,) int64 device tensor of shifts, computed on
    its device."""
    return torch.stack([pow2(shifts), pow2(-shifts)])


def scale_table(shifts, device: torch.device) -> torch.Tensor:
    """(2, K) float32 on ``device``: row 0 each class's 2**shift, row 1 its
    2**-shift, the scales K2 and K8 read (exact in float32 for |shift| <=
    MAX_SHIFT).  Copied asynchronously from pinned memory."""
    host = torch.tensor([[2.0 ** s for s in shifts],
                         [2.0 ** -s for s in shifts]], dtype=torch.float32)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def quantize(w: torch.Tensor, shift: int) -> torch.Tensor:
    """int64 round-half-even(w * 2**shift), the float32 product exact;
    ``shift`` an int or a 0-d tensor."""
    return torch.round(w * pow2(shift)).to(torch.int64)


def dequantize(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """float32 of an int64 sum (one rounding), times the exact 2**-shift."""
    return acc.to(torch.float32) * pow2(-shift)


def build_histograms_gh(bins_T: torch.Tensor, slot: torch.Tensor,
                        grad: torch.Tensor, hess: torch.Tensor,
                        cnt: torch.Tensor, num_slots: int, max_bins: int,
                        shift: int):
    """(S, G, Bmax, 2) float32 grad/hess histograms and (S,) float32 exact
    counts of the rows' slots.  bins_T: (G, N) bins; slot: (N,) int32;
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
        cell = ((s * G + g) * max_bins
                + bin_values(bins_T[g, keep]).to(torch.int64)) * 2
        acc.index_add_(0, cell, qg)
        acc.index_add_(0, cell + 1, qh)
    hist = dequantize(acc, shift).reshape(num_slots, G, max_bins, 2)
    return hist, slot_counts(slot, cnt, num_slots)


def build_histograms_int(bins_T: torch.Tensor, slot: torch.Tensor,
                         qgrad: torch.Tensor, qhess: torch.Tensor,
                         num_slots: int, max_bins: int) -> torch.Tensor:
    """(K, S, G, Bmax, 2) int32 (grad, hess) histograms of each class's
    rows' slots: exact integer sums of the int8 grid values (reference:
    stream_kernel.py ``int_weights`` branch :342-386).  bins_T: (G, N)
    bins; slot: (K, N) int32; qgrad, qhess: (K, N) int8.  The caller keeps
    every sum inside int32 (the ``int_hist`` gate: half * N < 2**31)."""
    G = bins_T.shape[0]
    K = slot.shape[0]
    kk, rows = torch.nonzero(slot >= 0, as_tuple=True)
    s = kk * num_slots + slot[kk, rows].to(torch.int64)
    q = torch.stack([qgrad[kk, rows], qhess[kk, rows]], dim=1).to(torch.int32)
    acc = torch.zeros((K * num_slots * G * max_bins, 2), dtype=torch.int32,
                      device=bins_T.device)
    for g in range(G):
        acc.index_add_(0, (s * G + g) * max_bins
                       + bin_values(bins_T[g, rows]).to(torch.int64), q)
    return acc.reshape(K, num_slots, G, max_bins, 2)


def hist3_plain(bins_T: torch.Tensor, slot: torch.Tensor,
                grad: torch.Tensor, hess: torch.Tensor, cnt: torch.Tensor,
                num_slots: int, max_bins: int, shift: int) -> torch.Tensor:
    """(S, G, Bmax, 3) float32 (grad, hess, count) histograms of the rows'
    slots.  bins_T: (G, N) bins (any strides); slot: (N,) int32; grad,
    hess, cnt: (N,) float32."""
    G = bins_T.shape[0]
    dev = bins_T.device
    keep = torch.nonzero(slot >= 0).flatten()
    s = slot[keep].to(torch.int64)
    q = torch.stack([quantize(grad[keep], shift), quantize(hess[keep], shift),
                     torch.round(cnt[keep]).to(torch.int64)], dim=1)
    acc = torch.zeros((num_slots * G * max_bins, 3), dtype=torch.int64,
                      device=dev)
    for g in range(G):
        acc.index_add_(0, (s * G + g) * max_bins
                       + bin_values(bins_T[g, keep]).to(torch.int64), q)
    hist = acc.to(torch.float32)
    hist[:, :2] *= 2.0 ** -shift
    return hist.reshape(num_slots, G, max_bins, 3)


# rows per block of the pallas backend's slot-sorted plan (the JAX
# package's build_histograms_sorted default)
SORTED_BLOCK_ROWS = 1024


def build_histograms(bins: torch.Tensor, slot, grad: torch.Tensor,
                     hess: torch.Tensor, cnt: torch.Tensor, num_slots: int,
                     max_bins: int, shift: int, backend: str,
                     block_rows: int = SORTED_BLOCK_ROWS) -> torch.Tensor:
    """(S, G, Bmax, 3) float32 histograms through a backend's kernel.
    ``scatter``: K5 over (G, N) bins in the rows' natural order.
    ``pallas``: the slot-sorted block plan (ops/compact.py), then K6
    (Bmax <= 128) or K7 over (N, G) row-major bins, uint8 or the int16
    storage of 16-bit bins (K7 only).  ``slot=None`` puts every
    row in slot 0 (the root; ``pallas`` then plans without a sort)."""
    if backend == "scatter":
        from ..kernels import scatter_hist as ksh
        if slot is None:
            slot = torch.zeros(bins.shape[1], dtype=torch.int32,
                               device=bins.device)
        return ksh.scatter_hist(bins, slot, grad, hess, cnt, num_slots,
                                max_bins, shift)
    if backend == "pallas":
        from ..kernels import hist_sorted as khs
        from .compact import plan_blocks, plan_single_slot
        plan = (plan_single_slot(bins.shape[0], block_rows, bins.device)
                if slot is None else plan_blocks(slot, num_slots, block_rows))
        return khs.hist_sorted(bins, plan.gather_idx, plan.scalars, grad,
                               hess, cnt, num_slots, max_bins, shift,
                               block_rows)
    raise ValueError(f"unknown hist backend {backend!r}")


def build_histograms_k(bins_T: torch.Tensor, slot: torch.Tensor,
                       grad: torch.Tensor, hess: torch.Tensor,
                       cnt: torch.Tensor, num_class: int, num_slots: int,
                       max_bins: int, shifts, backend: str,
                       scales=None) -> torch.Tensor:
    """(K, S, G, Bmax, 3) float32 histograms of K class trees (reference:
    ops/histogram.py ``build_histograms_k``).  bins_T: (G, N) bins; slot,
    grad, hess: (K, N), class k's slot and weights of every row; cnt: (N,)
    shared; shifts: K ints, class k's fixed-point shift; scales: their
    ``scale_table``, or None.  ``scatter`` and
    ``pallas`` both run K8 over the rows in their natural order: their TPU
    kernels compute this same function, and the VMEM gates that send the
    reference to per-class kernels do not exist on the card."""
    if backend not in ("scatter", "pallas"):
        raise ValueError(f"unknown hist backend {backend!r}")
    if slot.shape[0] != num_class or len(shifts) != num_class:
        raise ValueError("build_histograms_k: one slot row and one shift "
                         "per class")
    from ..kernels import hist_wide as khw
    return khw.hist_wide(bins_T, slot, grad, hess, cnt, num_slots, max_bins,
                         shifts, scales)


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
