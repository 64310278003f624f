"""Host BinnedData -> device tensors + the routing layout.

The port's counterpart of ``lightgbm_tpu/device_data.py:30-183``: the binned
matrix lives in device memory; the per-feature routing layout maps a stored
group bin back to the feature-local bin a split compares against; and the
split-finding ``FeatureLayout`` gathers each feature's bins out of the
(G, Bmax) group histograms.  Both layouts are built from the same loop as
the reference's ``build_layouts`` and are equal to it field by field.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .binning import BIN_CATEGORICAL, MISSING_NAN, MISSING_ZERO, BinnedData
from .kernels.layout import bins_to_torch
from .utils.log import LightGBMError

ROUTING_FIELDS = ("feat_group", "span_start", "default_bin", "bundled",
                  "nan_bin", "num_bins", "mzero_bin")


class RoutingLayout(NamedTuple):
    """Per-feature routing, indexed by original feature id (reference:
    ops/grow.py RoutingLayout)."""
    feat_group: torch.Tensor     # (F,) i32 group column holding the feature
    span_start: torch.Tensor     # (F,) i32 first stored bin of a bundled span
    default_bin: torch.Tensor    # (F,) i32
    bundled: torch.Tensor        # (F,) bool
    nan_bin: torch.Tensor        # (F,) i32 NaN bin, -1 = none
    num_bins: torch.Tensor       # (F,) i32
    mzero_bin: torch.Tensor      # (F,) i32 zero-as-missing bin, -1 = none


LAYOUT_FIELDS = ("gather_idx", "valid_mask", "residual_pos", "nan_bin",
                 "is_cat", "num_bins", "mzero_bin")


class FeatureLayout(NamedTuple):
    """Per-feature gather layout into the (G, Bmax) group histograms
    (reference: ops/split.py FeatureLayout)."""
    gather_idx: torch.Tensor     # (F, Bmax) i64 into the flat (G * Bmax)
    valid_mask: torch.Tensor     # (F, Bmax) bool, bin b exists for f
    residual_pos: torch.Tensor   # (F,) i64 EFB default bin to fill, -1 none
    nan_bin: torch.Tensor        # (F,) i64 NaN bin, -1 none
    is_cat: torch.Tensor         # (F,) bool
    num_bins: torch.Tensor       # (F,) i64
    mzero_bin: torch.Tensor      # (F,) i64 zero-as-missing bin, -1 none
    # derived: the features with a residual bin, listed on the host once so
    # that a split scan needs no device-to-host read to find them
    residual_features: torch.Tensor  # (R,) i64


class DeviceData(NamedTuple):
    bins: torch.Tensor           # (N_pad, G) uint8, or int16 storage of
                                 # 16-bit bins, on ``device``
    routing: RoutingLayout
    layout: FeatureLayout
    num_data: int
    num_features: int
    num_groups: int
    max_bins: int                # Bmax
    device: torch.device


def resolve_device(device_type: str) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default) needs a
    GPU and never falls back to the CPU; ``cpu`` must be asked for."""
    kind = str(device_type).strip().lower()
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise LightGBMError(
            f"device_type={device_type!r} needs a CUDA GPU, and torch finds "
            "none; pass device_type='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def max_bins(binned: BinnedData) -> int:
    """Bmax: the widest group or feature."""
    F, G = binned.num_features, binned.num_groups
    return int(max(int(binned.group_bin_counts.max()) if G else 1,
                   int(binned.feature_num_bins.max()) if F else 1))


def build_routing_np(binned: BinnedData):
    """Routing arrays (numpy) + Bmax (reference: device_data.build_layouts,
    routing half)."""
    F = binned.num_features
    Bmax = max_bins(binned)
    r = {
        "feat_group": np.zeros(F, np.int32),
        "span_start": np.zeros(F, np.int32),
        "default_bin": np.zeros(F, np.int32),
        "bundled": np.zeros(F, bool),
        "nan_bin": np.full(F, -1, np.int32),
        "num_bins": np.asarray(binned.feature_num_bins, np.int32).copy(),
        "mzero_bin": np.full(F, -1, np.int32),
    }
    for gi, feats in enumerate(binned.group_features):
        bundled = len(feats) > 1
        in_group = 1
        for f in feats:
            m = binned.bin_mappers[f]
            r["feat_group"][f] = gi
            r["default_bin"][f] = m.default_bin
            if bundled:
                r["span_start"][f] = in_group
                r["bundled"][f] = True
                in_group += m.num_bins - 1
            if m.bin_type == BIN_CATEGORICAL:
                continue
            if m.missing_type == MISSING_NAN:
                r["nan_bin"][f] = m.num_bins - 1
            elif m.missing_type == MISSING_ZERO:
                # zeros are the missing value (zero_as_missing): they live
                # in the default bin and follow the split's default
                # direction (reference: MissingType::Zero, bin.h:28)
                r["mzero_bin"][f] = m.default_bin
    return r, Bmax


def build_layout_np(binned: BinnedData):
    """Split-finding layout arrays (numpy), keyed by LAYOUT_FIELDS
    (reference: device_data.build_layouts, split half).  A single-feature
    group maps bin b to group bin b; in an EFB bundle the feature's
    non-default bins sit at span_start + (b < default ? b : b - 1) and its
    default bin is filled by residual (parent total less the rest)."""
    F = binned.num_features
    Bmax = max_bins(binned)
    out = {"gather_idx": np.zeros((F, Bmax), np.int64),
           "valid_mask": np.zeros((F, Bmax), bool),
           "residual_pos": np.full(F, -1, np.int64),
           "nan_bin": np.full(F, -1, np.int64),
           "is_cat": np.zeros(F, bool),
           "num_bins": np.asarray(binned.feature_num_bins, np.int64).copy(),
           "mzero_bin": np.full(F, -1, np.int64)}
    for gi, feats in enumerate(binned.group_features):
        base = gi * Bmax
        bundled = len(feats) > 1
        in_group = 1
        for f in feats:
            m = binned.bin_mappers[f]
            nb, d = m.num_bins, m.default_bin
            if bundled:
                for b in range(nb):
                    if b != d:
                        out["gather_idx"][f, b] = (base + in_group
                                                   + (b if b < d else b - 1))
                        out["valid_mask"][f, b] = True
                out["residual_pos"][f] = d
                in_group += nb - 1
            else:
                out["gather_idx"][f, :nb] = base + np.arange(nb)
                out["valid_mask"][f, :nb] = True
            if m.bin_type == BIN_CATEGORICAL:
                out["is_cat"][f] = True
            elif m.missing_type == MISSING_NAN:
                out["nan_bin"][f] = nb - 1
            elif m.missing_type == MISSING_ZERO:
                out["mzero_bin"][f] = d
    return out


def build_layouts(binned: BinnedData, device: torch.device):
    """RoutingLayout (int32/bool) and FeatureLayout (int64/bool) tensors on
    ``device`` + Bmax."""
    r, Bmax = build_routing_np(binned)
    routing = RoutingLayout(**{k: torch.as_tensor(v, device=device)
                               for k, v in r.items()})
    lay = build_layout_np(binned)
    lay["residual_features"] = np.flatnonzero(lay["residual_pos"] >= 0)
    layout = FeatureLayout(**{k: torch.as_tensor(v, device=device)
                              for k, v in lay.items()})
    return routing, layout, Bmax


def to_device(binned: BinnedData, device: torch.device,
              pad_rows_to: int = 256,
              bins: Optional[torch.Tensor] = None) -> DeviceData:
    """(N_pad, G) bins on ``device``, rows padded with zeros to a multiple
    of ``pad_rows_to`` as in the reference.  ``bins``: the same (N, G) bins
    already on ``device`` in card storage (binned there by
    kernels/bin_rows.py), which are padded there instead of uploaded."""
    routing, layout, Bmax = build_layouts(binned, device)
    n = binned.bins.shape[0]
    n_pad = -(-n // pad_rows_to) * pad_rows_to
    if bins is not None:
        if bins.device != device or tuple(bins.shape) != binned.bins.shape:
            raise ValueError("the card's bins do not match the host bins")
        if n_pad != n:
            bins = torch.cat([bins, bins.new_zeros((n_pad - n,
                                                    bins.shape[1]))])
    else:
        host = np.ascontiguousarray(binned.bins)
        if n_pad != n:
            host = np.pad(host, ((0, n_pad - n), (0, 0)))
        # 16-bit bins keep their bytes in int16 storage (kernels/layout.py)
        bins = bins_to_torch(host).to(device)
    return DeviceData(bins=bins,
                      routing=routing, layout=layout, num_data=n,
                      num_features=binned.num_features,
                      num_groups=binned.num_groups, max_bins=Bmax,
                      device=device)
