"""Best-split search over histograms, numeric features.

The port's counterpart of ``lightgbm_tpu/ops/split.py:59-650`` (reference:
src/treelearner/feature_histogram.hpp:166 FindBestThreshold).  Every (slot,
feature, threshold) candidate is evaluated at once: prefix sums along the bin
axis, a gain tensor for the reverse (missing-left) and forward
(missing-right) scans, then argmax reductions with the reference's
tie-breaks.  Only the numeric path is ported: L1/L2, ``min_data_in_leaf``,
``min_sum_hessian_in_leaf``, ``min_gain_to_split``, ``max_delta_step``, NaN
and zero-as-missing bins and the EFB residual fill.  Categorical,
monotone, path-smoothing, extra-trees and CEGB branches are not ported
(models/gbdt.py refuses the parameters that need them).

Arithmetic is float32 in the reference's operation order, with one
deliberate difference: the prefix sums along the bin axis are taken in
float64 and rounded to float32 once, so the CPU and CUDA paths of the port
agree whatever order their cumsums add in.  On histograms whose sums are
exact in float32 (dyadic gradients) this changes nothing and the result is
bit-equal to the reference; elsewhere gains agree within float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device_data import FeatureLayout

NEG_INF = -1e30
EPS_HESS = 1e-15

# dir_flags bits (reference: ops/split.py DIR_*)
DIR_DEFAULT_LEFT = 1   # missing values go left
DIR_CATEGORICAL = 2    # categorical split


class SplitResult(NamedTuple):
    gain: torch.Tensor         # (S,) f32, gain over the parent; NEG_INF none
    feature: torch.Tensor      # (S,) i64
    threshold: torch.Tensor    # (S,) i64 bin t, left = bin <= t
    dir_flags: torch.Tensor    # (S,) i64 DIR_* bits
    left_sum_g: torch.Tensor   # (S,) f32
    left_sum_h: torch.Tensor
    left_count: torch.Tensor


def _threshold_l1(s, l1):
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def leaf_term(sum_g, sum_h, l1, l2):
    """GetLeafGain (reference: feature_histogram.hpp)."""
    t = _threshold_l1(sum_g, l1)
    return t * t / (sum_h + l2 + EPS_HESS)


def leaf_output(sum_g, sum_h, l1, l2, max_delta_step=0.0):
    """CalculateSplittedLeafOutput: the ridge output, clipped to
    +-max_delta_step when that is positive."""
    out = -_threshold_l1(sum_g, l1) / (sum_h + l2 + EPS_HESS)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def leaf_gain_given_output(sum_g, sum_h, l1, l2, output):
    """GetLeafGainGivenOutput: the gain of a leaf held at ``output``."""
    t = _threshold_l1(sum_g, l1)
    return -(2.0 * t * output + (sum_h + l2) * output * output)


def round_int(x):
    """Common::RoundInt (common.h:911): per-bin counts are estimated from
    hessians as RoundInt(hess * cnt_factor)."""
    return torch.floor(x + 0.5)


def _cumsum(x):
    """Prefix sums along the last axis: float64, rounded to float32 once."""
    return torch.cumsum(x.double(), dim=-1).to(x.dtype)


def gather_feature_histograms(hist: torch.Tensor, layout: FeatureLayout,
                              parent_g: torch.Tensor,
                              parent_h: torch.Tensor) -> torch.Tensor:
    """(S, G, Bmax, 2) group histograms -> (S, F, Bmax, 2) per-feature
    histograms.  An EFB-bundled feature's default bin is not stored: it is
    the parent total less the feature's other bins (reference:
    gather_feature_histograms; the sum is taken in float64 and rounded once,
    as the prefix sums are)."""
    S, G, Bmax, C = hist.shape
    flat = hist.reshape(S, G * Bmax, C)
    hf = flat[:, layout.gather_idx, :] * layout.valid_mask[None, :, :, None]
    resid_f = layout.residual_features
    if resid_f.numel():
        parent = torch.stack([parent_g, parent_h], dim=-1)         # (S, C)
        sub = hf[:, resid_f]                                       # (S, R, B, C)
        resid = (parent.double()[:, None, :]
                 - sub.double().sum(dim=2)).to(hf.dtype)           # (S, R, C)
        pos = layout.residual_pos[resid_f]
        hf[:, resid_f, pos, :] = resid
    return hf


def find_best_splits(hist: torch.Tensor, parent_g: torch.Tensor,
                     parent_h: torch.Tensor, parent_c: torch.Tensor,
                     layout: FeatureLayout, lambda_l1: float,
                     lambda_l2: float, min_data_in_leaf: int,
                     min_sum_hessian_in_leaf: float,
                     min_gain_to_split: float,
                     max_delta_step: float = 0.0,
                     col_mask: Optional[torch.Tensor] = None) -> SplitResult:
    """Best numeric split of each of the S histogram slots (reference:
    find_best_splits, numeric-only path).  ``col_mask`` (F,) bool is the
    tree's feature sample: a feature outside it never wins."""
    S = hist.shape[0]
    Bmax = hist.shape[2]
    dev = hist.device
    hf = gather_feature_histograms(hist, layout, parent_g, parent_h)
    hg, hh = hf[..., 0], hf[..., 1]                        # (S, F, Bmax)
    cnt_factor = parent_c / torch.clamp(parent_h, min=EPS_HESS)
    hc = round_int(hh * cnt_factor[:, None, None])

    pg = parent_g[:, None, None]
    ph = parent_h[:, None, None]
    pc = parent_c[:, None, None]
    cg, ch, cc = _cumsum(hg), _cumsum(hh), _cumsum(hc)

    nbins = layout.num_bins[None, :, None]
    bin_iota = torch.arange(Bmax, device=dev)[None, None, :]

    def at_bin(a, idx):
        """a[s, f, idx[f]] for every slot, as (S, F, 1)."""
        return torch.gather(a, 2, idx[None, :, None].expand(S, -1, 1))

    has_nan = (layout.nan_bin >= 0)[None, :, None]
    nan_idx = torch.clamp(layout.nan_bin, min=0)
    has_mz = (layout.mzero_bin >= 0)[None, :, None]
    mzb = layout.mzero_bin[None, :, None]
    mz_idx = torch.clamp(layout.mzero_bin, min=0)
    zero = torch.zeros((), dtype=hg.dtype, device=dev)
    miss = []
    for a in (hg, hh, hc):
        nan_a = torch.where(has_nan, at_bin(a, nan_idx), zero)
        z_a = torch.where(has_mz, at_bin(a, mz_idx), zero)
        miss.append((nan_a + z_a, z_a))
    (miss_g, z_g), (miss_h, z_h), (_, z_c) = miss
    has_miss = has_nan | has_mz

    def split_gain(lg, lh, lc, rc):
        rg, rh = pg - lg, ph - lh
        if max_delta_step > 0.0:
            ol = leaf_output(lg, lh, lambda_l1, lambda_l2, max_delta_step)
            orr = leaf_output(rg, rh, lambda_l1, lambda_l2, max_delta_step)
            gain = (leaf_gain_given_output(lg, lh, lambda_l1, lambda_l2, ol)
                    + leaf_gain_given_output(rg, rh, lambda_l1, lambda_l2,
                                             orr))
        else:
            gain = (leaf_term(lg, lh, lambda_l1, lambda_l2)
                    + leaf_term(rg, rh, lambda_l1, lambda_l2))
        ok = ((lc >= min_data_in_leaf) & (rc >= min_data_in_leaf)
              & (lh >= min_sum_hessian_in_leaf)
              & (rh >= min_sum_hessian_in_leaf))
        return torch.where(ok, gain, NEG_INF)

    # the reverse scan (missing left) is the only scan of a feature without
    # missing values; the forward scan (missing right) also runs for missing
    # types.  Zero-as-missing takes the default bin out of both sides.
    data_bins = torch.where(layout.nan_bin[None, :, None] >= 0, nbins - 1,
                            nbins)
    past_z = has_mz & (bin_iota >= mzb)
    cg_eff = cg - torch.where(past_z, z_g, zero)
    ch_eff = ch - torch.where(past_z, z_h, zero)
    cc_eff = cc - torch.where(past_z, z_c, zero)
    ccDB = torch.gather(cc_eff, 2, torch.clamp(data_bins - 1, min=0)
                        .expand(S, -1, 1))
    rc_rev = ccDB - cc_eff
    lc_rev = pc - rc_rev
    lc_fwd = cc_eff
    rc_fwd = pc - cc_eff
    lg_rev, lh_rev = cg_eff + miss_g, ch_eff + miss_h
    gain_rev = split_gain(lg_rev, lh_rev, lc_rev, rc_rev)
    gain_fwd = torch.where(has_miss,
                           split_gain(cg_eff, ch_eff, lc_fwd, rc_fwd),
                           NEG_INF)
    rev_skip = has_mz & (bin_iota == mzb - 1)
    fwd_skip = has_mz & (bin_iota == mzb)
    fwd_hi = torch.where(has_mz, data_bins - 1, data_bins)
    gain_rev = torch.where((bin_iota < data_bins - 1) & ~rev_skip, gain_rev,
                           NEG_INF)
    gain_fwd = torch.where((bin_iota < fwd_hi) & ~fwd_skip, gain_fwd, NEG_INF)

    if max_delta_step > 0.0:
        p_out = leaf_output(parent_g, parent_h, lambda_l1, lambda_l2,
                            max_delta_step)
        parent_term = leaf_gain_given_output(parent_g, parent_h, lambda_l1,
                                             lambda_l2, p_out)
    else:
        parent_term = leaf_term(parent_g, parent_h, lambda_l1, lambda_l2)

    def rel(gain):
        r = gain - parent_term[:, None, None]
        return torch.where(gain <= NEG_INF / 2, NEG_INF, r)

    rel_rev, rel_fwd = rel(gain_rev), rel(gain_fwd)
    # reverse keeps the highest of tied thresholds, forward the lowest, and
    # reverse wins a tie between the scans
    t_rev = (Bmax - 1) - torch.argmax(torch.flip(rel_rev, [-1]), dim=-1)
    g_rev = torch.gather(rel_rev, 2, t_rev[..., None])[..., 0]
    t_fwd = torch.argmax(rel_fwd, dim=-1)
    g_fwd = torch.gather(rel_fwd, 2, t_fwd[..., None])[..., 0]
    use_rev = g_rev >= g_fwd
    best_t = torch.where(use_rev, t_rev, t_fwd)                # (S, F)
    best_gain_f = torch.where(use_rev, g_rev, g_fwd)
    if col_mask is not None:
        best_gain_f = torch.where(col_mask[None, :], best_gain_f, NEG_INF)

    best_f = torch.argmax(best_gain_f, dim=-1)                 # (S,)
    ar = torch.arange(S, device=dev)
    gain = best_gain_f[ar, best_f]
    t = best_t[ar, best_f]
    dflt_l = use_rev[ar, best_f]
    lg = cg_eff[ar, best_f, t] + torch.where(dflt_l, miss_g[ar, best_f, 0],
                                             zero)
    lh = ch_eff[ar, best_f, t] + torch.where(dflt_l, miss_h[ar, best_f, 0],
                                             zero)
    lc = torch.where(dflt_l, lc_rev[ar, best_f, t], lc_fwd[ar, best_f, t])
    gain = torch.where(gain > min_gain_to_split, gain, NEG_INF)
    dir_flags = torch.where(dflt_l, DIR_DEFAULT_LEFT, 0)
    return SplitResult(gain=gain, feature=best_f, threshold=t,
                       dir_flags=dir_flags, left_sum_g=lg, left_sum_h=lh,
                       left_count=lc)
