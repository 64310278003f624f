"""One growth round: route rows through the round's splits and build the
histograms of their new slots.  The CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/stream_kernel.py:520-633``
(``route_and_hist``; routing math ``_route_step`` :93-151 and the
categorical overlay :228-242).  Given the (G, N) uint8 bins, each row's
current leaf, the (N,) float32 grad / hess / count weights (zero on pad
rows), the round's (L, 16) int32 route records and (L, W) int32 categorical
bitsets (kernels/layout.py), it returns every row's new leaf id, the
(S, G, Bmax, 2) float32 (grad, hess) histograms of the S slots and the (S,)
float32 exact counts.  ``with_hist=False`` (a tree's last, route-only round)
returns the leaf ids and counts alone.

The histogram sums are exact fixed point at ``shift`` (ops/histogram.py), so
the kernel and the plain version agree bit for bit, on every run.
``route_and_hist`` launches the kernel for tensors on a CUDA device and runs
``route_and_hist_plain`` only for tensors on the CPU; a kernel that fails to
build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import build_histograms_gh, slot_counts
from ..utils.log import LightGBMError
from . import build
from .layout import (R_BUNDLED, R_CHOSEN, R_DEFBIN, R_DEFLEFT, R_GROUP,
                     R_ISCAT, R_MZBIN, R_NANBIN, R_NBINS, R_NEWID, R_SLOT_KEEP,
                     R_SLOT_L, R_SLOT_R, R_SPAN, R_THR, ROUTE_FIELDS)


def route_and_hist(bins_T, leaf_id, tabs, cat_words, grad, hess, cnt,
                   num_slots: int, max_bins: int, shift: int,
                   with_hist: bool = True):
    """(new_leaf (N,) int32, hist (S, G, Bmax, 2) float32 or None, counts
    (S,) float32) of one round."""
    if bins_T.device.type == "cuda":
        return route_and_hist_cuda(bins_T, leaf_id, tabs, cat_words, grad,
                                   hess, cnt, num_slots, max_bins, shift,
                                   with_hist)
    if bins_T.device.type == "cpu":
        return route_and_hist_plain(bins_T, leaf_id, tabs, cat_words, grad,
                                    hess, cnt, num_slots, max_bins, shift,
                                    with_hist)
    raise LightGBMError(f"route_and_hist has no kernel for device "
                        f"{bins_T.device}")


def numeric_go_left(bins_T, rows, rec):
    """(go_left (N,) bool, feature-local bin (N,) int32) of each row under
    its (N, 16) route record, numeric decision: the split group's bin,
    unbundled when the feature shares an EFB group; a NaN or zero-as-missing
    bin (-1 = none) goes the default way, any other bin left when it is at
    most the threshold."""
    gb = bins_T[rec[:, R_GROUP].to(torch.int64), rows].to(torch.int32)
    ls = gb - rec[:, R_SPAN]
    defbin = rec[:, R_DEFBIN]
    in_span = (ls >= 0) & (ls < rec[:, R_NBINS] - 1)
    fb_b = torch.where(in_span, ls + (ls >= defbin).to(torch.int32), defbin)
    fb = torch.where(rec[:, R_BUNDLED] > 0, fb_b, gb)
    missing = (fb == rec[:, R_NANBIN]) | (fb == rec[:, R_MZBIN])
    go_left = torch.where(missing, rec[:, R_DEFLEFT] > 0, fb <= rec[:, R_THR])
    return go_left, fb


def route_plain(bins_T, leaf_id, tabs, cat_words):
    """(new leaf (N,) int32, slot (N,) int32) of every row: the kernel's
    route step written with tensor ops over all rows at once."""
    n = bins_T.shape[1]
    rows = torch.arange(n, device=bins_T.device)
    lid = leaf_id.to(torch.int64)
    rec = tabs[lid]                                           # (N, 16)
    go_left, fb = numeric_go_left(bins_T, rows, rec)
    # (rows of unsplit leaves read group 0 and are not routed; clamp their
    # word index into the table)
    wi = torch.clamp(fb >> 5, max=cat_words.shape[1] - 1).to(torch.int64)
    word = cat_words[lid, wi]
    go_left_cat = ((word >> (fb & 31)) & 1) > 0
    go_left = torch.where(rec[:, R_ISCAT] > 0, go_left_cat, go_left)
    chosen = rec[:, R_CHOSEN] > 0
    new_leaf = torch.where(chosen & ~go_left, rec[:, R_NEWID], leaf_id)
    slot = torch.where(chosen,
                       torch.where(go_left, rec[:, R_SLOT_L], rec[:, R_SLOT_R]),
                       rec[:, R_SLOT_KEEP])
    return new_leaf.to(torch.int32), slot.to(torch.int32)


def route_and_hist_plain(bins_T, leaf_id, tabs, cat_words, grad, hess, cnt,
                         num_slots: int, max_bins: int, shift: int,
                         with_hist: bool = True):
    """Plain PyTorch version of the kernel's contract."""
    new_leaf, slot = route_plain(bins_T, leaf_id, tabs, cat_words)
    if with_hist:
        hist, counts = build_histograms_gh(bins_T, slot, grad, hess, cnt,
                                           num_slots, max_bins, shift)
        return new_leaf, hist, counts
    return new_leaf, None, slot_counts(slot, cnt, num_slots)


def route_and_hist_cuda(bins_T, leaf_id, tabs, cat_words, grad, hess, cnt,
                        num_slots: int, max_bins: int, shift: int,
                        with_hist: bool = True):
    """Launch csrc/route_and_hist.cu on the current stream."""
    dev = bins_T.device
    G, n = bins_T.shape
    L = tabs.shape[0]
    for name, x, dtype in (("bins_T", bins_T, torch.uint8),
                           ("leaf_id", leaf_id, torch.int32),
                           ("tabs", tabs, torch.int32),
                           ("cat_words", cat_words, torch.int32),
                           ("grad", grad, torch.float32),
                           ("hess", hess, torch.float32),
                           ("cnt", cnt, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise LightGBMError(
                f"route_and_hist: {name} must be a contiguous {dtype} tensor "
                f"on {dev}, got {x.dtype} on {x.device}")
    if (tuple(tabs.shape) != (L, len(ROUTE_FIELDS)) or cat_words.dim() != 2
            or cat_words.shape[0] != L or cat_words.shape[1] * 32 < max_bins
            or any(tuple(x.shape) != (n,) for x in (leaf_id, grad, hess, cnt))
            or num_slots < 1 or not 0 < max_bins <= 256):
        raise LightGBMError("route_and_hist: shapes do not agree")
    new_leaf = torch.empty(n, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(num_slots, dtype=torch.float32, device=dev)
    cnt_acc = torch.empty(num_slots, dtype=torch.int64, device=dev)
    if with_hist:
        hist = torch.empty((num_slots, G, max_bins, 2), dtype=torch.float32,
                           device=dev)
        hist_acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    else:
        hist = hist_acc = counts          # never written
    fn = build.load("route_and_hist").lgbt_route_and_hist
    rc = fn(bins_T.data_ptr(), n, G, leaf_id.data_ptr(), tabs.data_ptr(), L,
            cat_words.data_ptr(), cat_words.shape[1], grad.data_ptr(),
            hess.data_ptr(), cnt.data_ptr(), num_slots, max_bins,
            int(with_hist), float(2.0 ** shift), float(2.0 ** -shift),
            new_leaf.data_ptr(), slot.data_ptr(), hist_acc.data_ptr(),
            cnt_acc.data_ptr(), hist.data_ptr(), counts.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"route_and_hist kernel launch failed "
                            f"(cudaError {rc})")
    route_and_hist_cuda.launches += 1
    return new_leaf, (hist if with_hist else None), counts


route_and_hist_cuda.launches = 0
