"""One growth round: route rows through the round's splits and build the
histograms of their new slots.  The CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``lightgbm_tpu/pallas/stream_kernel.py:520-633``
(``route_and_hist``; routing math ``_route_step`` :93-151, the categorical
overlay :228-242, and the reference's ``num_class = K`` branches :174-205,
:263-279, :349-396).  One launch routes K class trees (K = 1: one tree).
Given the (G, N) bins (uint8, or the int16 storage of 16-bit bins where a
group is wider than 256 bins: the reference's ``pack_bins_T`` spills such
bins into the next group's byte and is not followed; kernels/layout.py),
each class's (K, N) current leaf ids, (K, N)
float32 grad and hess weights and the (N,) float32 count weights shared by
the classes (zero on pad rows), the round's (K, L, 16) int32 route records
and (K, L, W) int32 categorical bitsets (kernels/layout.py) and one
fixed-point shift per class, it returns every row's new leaf ids (K, N), the
(K, S, G, Bmax, 2) float32 (grad, hess) histograms of each class's S slots
and the (K, S) float32 exact counts.  Each class's leaf ids and new ids stay
within its own [0, L).  ``with_hist=False`` (a tree's last, route-only
round) returns the leaf ids and counts alone.  The plain version is one
single-class pass per class.

The histogram sums are exact fixed point at each class's shift
(ops/histogram.py), so
the kernel and the plain version agree bit for bit, on every run.
``route_and_hist`` launches the kernel for tensors on a CUDA device and runs
``route_and_hist_plain`` only for tensors on the CPU; a kernel that fails to
build or launch raises.

``route_and_hist_int`` is the reference's ``int_weights=True`` form
(stream_kernel.py:342-386), which quantized-gradient training takes: the
same routing, with (K, N) int8 grid values of the quantized grad and hess in
place of the float weights, and (K, S, G, Bmax, 2) int32 histograms that sum
them exactly (``ops/histogram.build_histograms_int``); the caller unscales
them.  Its own CUDA entry point (``lgbt_route_and_hist_int``, the same
source) and launch count.

The kernel's histogram pass is the tile pass of K5 and K8
(``csrc/hist_tile.cuh``) over the slots routing wrote, under
``hist_wide.hist_plan`` of the launch's shapes with this module's cell
sizes: 16 bytes (two int64 sums as 32-bit word pairs) for the float form,
8 (two int32 sums) for the int form.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.histogram import (build_histograms_gh, build_histograms_int,
                             scale_table, slot_counts)
from ..utils.log import LightGBMError
from . import build
from .hist_wide import hist_plan, plan_arg
from .layout import (R_BUNDLED, R_CHOSEN, R_DEFBIN, R_DEFLEFT, R_GROUP,
                     R_ISCAT, R_MZBIN, R_NANBIN, R_NBINS, R_NEWID, R_SLOT_KEEP,
                     R_SLOT_L, R_SLOT_R, R_SPAN, R_THR, ROUTE_FIELDS,
                     bin_bytes, bin_values)

# bytes of one (pair, group, bin) cell of the histogram pass's tile
CELL_BYTES = 16          # float form: grad and hess, two 32-bit words each
INT_CELL_BYTES = 8       # int form: grad and hess, one int32 word each


def route_and_hist(bins_T, leaf_id, tabs, cat_words, grad, hess, cnt,
                   num_slots: int, max_bins: int, shifts,
                   with_hist: bool = True, scales=None):
    """(new_leaf (K, N) int32, hist (K, S, G, Bmax, 2) float32 or None,
    counts (K, S) float32) of one round; ``shifts`` holds K ints, and
    ``scales`` their (2, K) device table (ops/histogram.scale_table), which
    a caller that launches many rounds builds once (None: built here)."""
    if bins_T.device.type == "cuda":
        return route_and_hist_cuda(bins_T, leaf_id, tabs, cat_words, grad,
                                   hess, cnt, num_slots, max_bins, shifts,
                                   with_hist, scales)
    if bins_T.device.type == "cpu":
        return route_and_hist_plain(bins_T, leaf_id, tabs, cat_words, grad,
                                    hess, cnt, num_slots, max_bins, shifts,
                                    with_hist, scales)
    raise LightGBMError(f"route_and_hist has no kernel for device "
                        f"{bins_T.device}")


def numeric_go_left(bins_T, rows, rec):
    """(go_left (N,) bool, feature-local bin (N,) int32) of each row under
    its (N, 16) route record, numeric decision: the split group's bin,
    unbundled when the feature shares an EFB group; a NaN or zero-as-missing
    bin (-1 = none) goes the default way, any other bin left when it is at
    most the threshold."""
    gb = bin_values(bins_T[rec[:, R_GROUP].to(torch.int64), rows])
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
                         num_slots: int, max_bins: int, shifts,
                         with_hist: bool = True, scales=None):
    """Plain PyTorch version of the kernel's contract, one class at a time
    (``scales`` is the kernel's copy of ``shifts`` and is not read)."""
    outs = []
    for k in range(leaf_id.shape[0]):
        new_leaf, slot = route_plain(bins_T, leaf_id[k], tabs[k],
                                     cat_words[k])
        if with_hist:
            hist, counts = build_histograms_gh(bins_T, slot, grad[k],
                                               hess[k], cnt, num_slots,
                                               max_bins, shifts[k])
        else:
            hist, counts = None, slot_counts(slot, cnt, num_slots)
        outs.append((new_leaf, hist, counts))
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]) if with_hist else None,
            torch.stack([o[2] for o in outs]))


def _check_operands(what, dev, operands, shapes_ok):
    """Raise unless ``dev`` is a CUDA device, every (name, tensor, dtype)
    operand is a contiguous tensor of its dtype on it and the shapes
    agree."""
    if dev.type != "cuda":
        raise LightGBMError(f"{what}: the CUDA kernel takes CUDA tensors, "
                            f"got {dev}")
    for name, x, dtype in operands:
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise LightGBMError(
                f"{what}: {name} must be a contiguous {dtype} tensor "
                f"on {dev}, got {x.dtype} on {x.device}")
    if not shapes_ok:
        raise LightGBMError(f"{what}: shapes do not agree")


def _route_shapes_ok(bins_T, leaf_id, tabs, cat_words, cnt, num_slots,
                     max_bins):
    """The shapes agree.  The bitsets need words only for the categorical
    features' bins (ops/grow.py sizes them so), which EFB never bundles,
    so any W >= 1 is taken."""
    G, n = bins_T.shape
    K, L = tabs.shape[0], tabs.shape[1]
    return (tuple(tabs.shape) == (K, L, len(ROUTE_FIELDS))
            and cat_words.dim() == 3 and tuple(cat_words.shape[:2]) == (K, L)
            and cat_words.shape[2] >= 1
            and tuple(leaf_id.shape) == (K, n) and tuple(cnt.shape) == (n,)
            and num_slots >= 1
            and 0 < max_bins <= 256 ** bin_bytes(bins_T))


def route_and_hist_cuda(bins_T, leaf_id, tabs, cat_words, grad, hess, cnt,
                        num_slots: int, max_bins: int, shifts,
                        with_hist: bool = True, scales=None):
    """Launch csrc/route_and_hist.cu on the current stream."""
    dev = bins_T.device
    if scales is None:
        scales = scale_table(shifts, dev)
    G, n = bins_T.shape
    K, L = tabs.shape[0], tabs.shape[1]
    width = bin_bytes(bins_T)
    _check_operands(
        "route_and_hist", dev,
        (("bins_T", bins_T, bins_T.dtype), ("leaf_id", leaf_id, torch.int32),
         ("tabs", tabs, torch.int32), ("cat_words", cat_words, torch.int32),
         ("grad", grad, torch.float32), ("hess", hess, torch.float32),
         ("cnt", cnt, torch.float32), ("scales", scales, torch.float32)),
        _route_shapes_ok(bins_T, leaf_id, tabs, cat_words, cnt, num_slots,
                         max_bins)
        and tuple(grad.shape) == (K, n) and tuple(hess.shape) == (K, n)
        and len(shifts) == K and tuple(scales.shape) == (2, K))
    new_leaf = torch.empty((K, n), dtype=torch.int32, device=dev)
    slot = torch.empty((K, n), dtype=torch.int32, device=dev)
    counts = torch.empty((K, num_slots), dtype=torch.float32, device=dev)
    cnt_acc = torch.empty((K, num_slots), dtype=torch.int64, device=dev)
    if with_hist:
        hist = torch.empty((K, num_slots, G, max_bins, 2),
                           dtype=torch.float32, device=dev)
        hist_acc = torch.empty(hist.shape, dtype=torch.int64, device=dev)
    else:
        hist = hist_acc = counts          # never written
    plan = (hist_plan(n, G, K, num_slots, max_bins, CELL_BYTES)
            if with_hist else None)
    fn = build.load("route_and_hist").lgbt_route_and_hist
    rc = fn(bins_T.data_ptr(), width, n, G, K, leaf_id.data_ptr(),
            tabs.data_ptr(), L, cat_words.data_ptr(), cat_words.shape[2],
            grad.data_ptr(), hess.data_ptr(), cnt.data_ptr(), num_slots,
            max_bins, int(with_hist), scales.data_ptr(), new_leaf.data_ptr(),
            slot.data_ptr(), hist_acc.data_ptr(), cnt_acc.data_ptr(),
            hist.data_ptr(), counts.data_ptr(),
            plan_arg(plan) if with_hist else None,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"route_and_hist kernel launch failed "
                            f"(cudaError {rc}, plan {plan})")
    build.count_launch(route_and_hist_cuda, width)
    return new_leaf, hist if with_hist else None, counts


build.init_counts(route_and_hist_cuda)


def route_and_hist_int(bins_T, leaf_id, tabs, cat_words, qgrad, qhess, cnt,
                       num_slots: int, max_bins: int, with_hist: bool = True):
    """(new_leaf (K, N) int32, hist (K, S, G, Bmax, 2) int32 or None,
    counts (K, S) float32) of one round of quantized-gradient training:
    ``qgrad``, ``qhess`` are (K, N) int8 grid values (|q| <= 127; None
    when ``with_hist`` is False, which reads no weights)."""
    if bins_T.device.type == "cuda":
        return route_and_hist_int_cuda(bins_T, leaf_id, tabs, cat_words,
                                       qgrad, qhess, cnt, num_slots, max_bins,
                                       with_hist)
    if bins_T.device.type == "cpu":
        return route_and_hist_int_plain(bins_T, leaf_id, tabs, cat_words,
                                        qgrad, qhess, cnt, num_slots,
                                        max_bins, with_hist)
    raise LightGBMError(f"route_and_hist_int has no kernel for device "
                        f"{bins_T.device}")


def route_and_hist_int_plain(bins_T, leaf_id, tabs, cat_words, qgrad, qhess,
                             cnt, num_slots: int, max_bins: int,
                             with_hist: bool = True):
    """Plain PyTorch version of the int form's contract."""
    routed = [route_plain(bins_T, leaf_id[k], tabs[k], cat_words[k])
              for k in range(leaf_id.shape[0])]
    new_leaf = torch.stack([r[0] for r in routed])
    slot = torch.stack([r[1] for r in routed])
    counts = torch.stack([slot_counts(s, cnt, num_slots) for s in slot])
    hist = (build_histograms_int(bins_T, slot, qgrad, qhess, num_slots,
                                 max_bins) if with_hist else None)
    return new_leaf, hist, counts


def route_and_hist_int_cuda(bins_T, leaf_id, tabs, cat_words, qgrad, qhess,
                            cnt, num_slots: int, max_bins: int,
                            with_hist: bool = True):
    """Launch the int form of csrc/route_and_hist.cu on the current
    stream."""
    dev = bins_T.device
    G, n = bins_T.shape
    K, L = tabs.shape[0], tabs.shape[1]
    width = bin_bytes(bins_T)
    operands = [("bins_T", bins_T, bins_T.dtype),
                ("leaf_id", leaf_id, torch.int32),
                ("tabs", tabs, torch.int32),
                ("cat_words", cat_words, torch.int32),
                ("cnt", cnt, torch.float32)]
    shapes_ok = _route_shapes_ok(bins_T, leaf_id, tabs, cat_words, cnt,
                                 num_slots, max_bins)
    if with_hist:
        operands += [("qgrad", qgrad, torch.int8), ("qhess", qhess, torch.int8)]
        shapes_ok = (shapes_ok and tuple(qgrad.shape) == (K, n)
                     and tuple(qhess.shape) == (K, n))
    _check_operands("route_and_hist_int", dev, operands, shapes_ok)
    new_leaf = torch.empty((K, n), dtype=torch.int32, device=dev)
    slot = torch.empty((K, n), dtype=torch.int32, device=dev)
    counts = torch.empty((K, num_slots), dtype=torch.float32, device=dev)
    cnt_acc = torch.empty((K, num_slots), dtype=torch.int64, device=dev)
    hist = (torch.empty((K, num_slots, G, max_bins, 2), dtype=torch.int32,
                        device=dev) if with_hist else None)
    plan = (hist_plan(n, G, K, num_slots, max_bins, INT_CELL_BYTES)
            if with_hist else None)
    fn = build.load("route_and_hist_int").lgbt_route_and_hist_int
    rc = fn(bins_T.data_ptr(), width, n, G, K, leaf_id.data_ptr(),
            tabs.data_ptr(), L, cat_words.data_ptr(), cat_words.shape[2],
            qgrad.data_ptr() if with_hist else None,
            qhess.data_ptr() if with_hist else None, cnt.data_ptr(),
            num_slots, max_bins, int(with_hist), new_leaf.data_ptr(),
            slot.data_ptr(), cnt_acc.data_ptr(),
            hist.data_ptr() if with_hist else None, counts.data_ptr(),
            plan_arg(plan) if with_hist else None,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise LightGBMError(f"route_and_hist_int kernel launch failed "
                            f"(cudaError {rc}, plan {plan})")
    build.count_launch(route_and_hist_int_cuda, width)
    return new_leaf, hist, counts


build.init_counts(route_and_hist_int_cuda)
