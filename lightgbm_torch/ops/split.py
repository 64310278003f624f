"""Best-split search over histograms, numeric and categorical features.

The port's counterpart of ``lightgbm_tpu/ops/split.py:59-677`` (reference:
src/treelearner/feature_histogram.hpp:166 FindBestThreshold and :232 the
categorical one-hot and sorted-subset splits).  Every (slot, feature,
threshold) candidate is evaluated at once: prefix sums along the bin axis,
a gain tensor for the reverse (missing-left) and forward (missing-right)
scans, then argmax reductions with the reference's tie-breaks.  Ported: L1/L2,
``min_data_in_leaf``, ``min_sum_hessian_in_leaf``, ``min_gain_to_split``,
``max_delta_step``, NaN and zero-as-missing bins, the EFB residual fill, and
categorical features: one category against the rest, or a prefix of the
categories sorted by g / (h + ``cat_smooth``) taken from either end, with
``cat_l2``, ``max_cat_threshold``, ``max_cat_to_onehot`` and
``min_data_per_group``; and, on numeric features only, monotone
constraints with ``monotone_penalty`` and path smoothing (``path_smooth``):
candidate outputs smoothed toward the leaf's own output and clipped to its
[out_lo, out_hi] bounds, gains at those outputs, a split that breaks its
feature's order rejected, and a constrained feature's gain scaled down at
shallow depths (reference: :82-117, :280-354, :435-440).  Under the
advanced method the bounds are per threshold and side instead, from the
leaf's constraint slabs (``adv_bounds``, :256-297), a feature whose last
scan found nothing stays out (``splittable``) and the scan reports which
features found a candidate (``feat_ok``, :450-469).  Extra trees keep one
random threshold of each (slot, numeric feature) (:442-447).  The CEGB
branch is not ported (models/gbdt.py refuses the parameters that need it).

Arithmetic is float32 in the reference's operation order, with one
deliberate difference: the prefix sums along the bin axis (of the bins and
of the sorted categories) and the totals of the eligible categories are
taken in float64 and rounded to float32 once, so the CPU and CUDA paths of
the port agree whatever order their sums add in.  On histograms whose sums
are exact in float32 (dyadic gradients) this changes nothing and the result
is bit-equal to the reference; elsewhere gains agree within float32
rounding.  Sorts are stable, as ``jnp.argsort`` is: ties between categories
decide which go left.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..device_data import FeatureLayout
from ..utils.random import randint_rows

NEG_INF = -1e30
EPS_HESS = 1e-15

# dir_flags bits (reference: ops/split.py DIR_*)
DIR_DEFAULT_LEFT = 1   # missing values go left
DIR_CATEGORICAL = 2    # categorical split (threshold: prefix length k)
DIR_CAT_ONEHOT = 4     # one category left (threshold: its bin)
DIR_CAT_REVERSED = 8   # the prefix taken from the high end of the order


class SplitResult(NamedTuple):
    gain: torch.Tensor         # (S,) f32, gain over the parent; NEG_INF none
    feature: torch.Tensor      # (S,) i64
    threshold: torch.Tensor    # (S,) i64 numeric: bin t, left = bin <= t;
                               # categorical: prefix length k or one bin
    dir_flags: torch.Tensor    # (S,) i64 DIR_* bits
    left_sum_g: torch.Tensor   # (S,) f32
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    feat_ok: Optional[torch.Tensor] = None  # (S, F) bool; advanced only


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


def smooth_output(raw, count, parent_output, path_smooth):
    """Path smoothing (reference: feature_histogram.hpp path_smooth):
    raw * n / (n + a) + parent * a / (n + a)."""
    return (raw * count / (count + path_smooth)
            + parent_output * path_smooth / (count + path_smooth))


def monotone_penalty_factor(depth, penalty):
    """ComputeMonotoneSplitGainPenalty (reference: monotone_constraints.hpp)
    of each (S,) slot depth, float32."""
    eps = 1e-10
    d = depth.to(torch.float32)
    f_small = 1.0 - penalty / torch.exp2(d) + eps
    f_big = 1.0 - torch.exp2(penalty - 1.0 - d) + eps
    out = f_small if penalty <= 1.0 else f_big
    return torch.where(penalty >= d + 1.0, eps, out)


def penalty_table(penalty: float, device: torch.device) -> torch.Tensor:
    """``monotone_penalty_factor`` of the depths 0 .. ceil(penalty) + 40,
    computed on the CPU and copied to ``device``: the card's exp2 rounds
    apart from the CPU's, and the CPU's is the reference's.  Past the last
    depth the factor is 1.0 in float32, the table's last entry."""
    depth = torch.arange(int(math.ceil(penalty)) + 41)
    return monotone_penalty_factor(depth, penalty).to(device)


def child_output(g, h, c, l1, l2, lo, hi, path_smooth=0.0, parent_out=None,
                 max_delta_step=0.0):
    """One child's output under the bounds [lo, hi] and optional path
    smoothing, in CalculateSplittedLeafOutput's order (feature_histogram.hpp):
    ridge output, max_delta_step clamp, smoothing, then the monotone clip."""
    o = -_threshold_l1(g, l1) / (h + l2 + EPS_HESS)
    if max_delta_step > 0.0:
        o = torch.clamp(o, -max_delta_step, max_delta_step)
    if path_smooth > 0.0 and parent_out is not None:
        o = smooth_output(o, c, parent_out, path_smooth)
    return torch.minimum(torch.maximum(o, lo), hi)


def constrained_child_outputs(lg, lh, lc, rg, rh, rc, l1, l2, lo, hi,
                              path_smooth=0.0, parent_out=None,
                              max_delta_step=0.0):
    """Both children's outputs (``child_output``) under the same bounds."""
    return (child_output(lg, lh, lc, l1, l2, lo, hi, path_smooth, parent_out,
                         max_delta_step),
            child_output(rg, rh, rc, l1, l2, lo, hi, path_smooth, parent_out,
                         max_delta_step))


def adv_child_bounds(v_min, v_max, big: float = -NEG_INF):
    """Per-threshold child bounds from constraint slabs (..., Bmax): the
    left child at threshold t spans bins [.., t], so its bounds are the
    running extrema up to t; the right child's are the suffix extrema from
    t + 1, the last threshold's unbounded (reference: adv_child_bounds,
    ops/split.py:256-270).  Returns (lo_l, hi_l, lo_r, hi_r)."""
    lo_l = torch.cummax(v_min, dim=-1).values
    hi_l = torch.cummin(v_max, dim=-1).values
    sfx_max = torch.flip(torch.cummax(torch.flip(v_min, [-1]), dim=-1).values,
                         [-1])
    sfx_min = torch.flip(torch.cummin(torch.flip(v_max, [-1]), dim=-1).values,
                         [-1])
    edge = v_min[..., :1]
    lo_r = torch.cat([sfx_max[..., 1:], torch.full_like(edge, -big)], dim=-1)
    hi_r = torch.cat([sfx_min[..., 1:], torch.full_like(edge, big)], dim=-1)
    return lo_l, hi_l, lo_r, hi_r


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


class CatParams(NamedTuple):
    """The categorical split parameters, the reference's defaults."""
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100


class _Scan(NamedTuple):
    """The regularization and gates every candidate of a scan shares."""
    l1: float
    l2: float
    max_delta_step: float
    min_data: int
    min_hess: float


class _Constraints(NamedTuple):
    """A numeric scan's output constraints: each child's output bounds,
    (S, 1, 1) a slot's (the basic and intermediate methods) or (S, F, B)
    per threshold (the advanced method's slabs), each slot's own output
    (the smoothing's parent output) as (S, 1, 1) and, with monotone
    constraints, the (1, F, 1) feature signs."""
    lo_l: torch.Tensor
    hi_l: torch.Tensor
    lo_r: torch.Tensor
    hi_r: torch.Tensor
    parent_out: torch.Tensor
    path_smooth: float
    mono: Optional[torch.Tensor]


def _constrained_gain(sc: _Scan, out: _Constraints, lg, lh, lc, rg, rh, rc):
    """The output-based gain of a candidate (reference: split_gain under
    use_output_gain), NEG_INF where its outputs break the feature's order."""
    ol = child_output(lg, lh, lc, sc.l1, sc.l2, out.lo_l, out.hi_l,
                      out.path_smooth, out.parent_out, sc.max_delta_step)
    orr = child_output(rg, rh, rc, sc.l1, sc.l2, out.lo_r, out.hi_r,
                       out.path_smooth, out.parent_out, sc.max_delta_step)
    gain = (leaf_gain_given_output(lg, lh, sc.l1, sc.l2, ol)
            + leaf_gain_given_output(rg, rh, sc.l1, sc.l2, orr))
    if out.mono is not None:
        viol = ((out.mono > 0) & (ol > orr)) | ((out.mono < 0) & (ol < orr))
        gain = torch.where((out.mono != 0) & viol, NEG_INF, gain)
    return gain


def _pair_gain(sc: _Scan, lg, lh, lc, rg, rh, rc,
               out: Optional[_Constraints] = None):
    """Gain of the two children of a candidate, NEG_INF where a child has
    too few rows or too little hessian; ``out``: the numeric scan's output
    constraints, or None."""
    if out is not None:
        gain = _constrained_gain(sc, out, lg, lh, lc, rg, rh, rc)
    elif sc.max_delta_step > 0.0:
        ol = leaf_output(lg, lh, sc.l1, sc.l2, sc.max_delta_step)
        orr = leaf_output(rg, rh, sc.l1, sc.l2, sc.max_delta_step)
        gain = (leaf_gain_given_output(lg, lh, sc.l1, sc.l2, ol)
                + leaf_gain_given_output(rg, rh, sc.l1, sc.l2, orr))
    else:
        gain = (leaf_term(lg, lh, sc.l1, sc.l2)
                + leaf_term(rg, rh, sc.l1, sc.l2))
    ok = ((lc >= sc.min_data) & (rc >= sc.min_data)
          & (lh >= sc.min_hess) & (rh >= sc.min_hess))
    return torch.where(ok, gain, NEG_INF)


def _parent_term(sc: _Scan, parent_g, parent_h):
    """The parent's own gain, which a candidate must beat; under
    max_delta_step at its clamped output."""
    if sc.max_delta_step > 0.0:
        out = leaf_output(parent_g, parent_h, sc.l1, sc.l2, sc.max_delta_step)
        return leaf_gain_given_output(parent_g, parent_h, sc.l1, sc.l2, out)
    return leaf_term(parent_g, parent_h, sc.l1, sc.l2)


def _relative(gain, parent_term):
    """Gain over the parent's, NEG_INF kept."""
    r = gain - parent_term[:, None, None]
    return torch.where(gain <= NEG_INF / 2, NEG_INF, r)


def _category_order(hg, hh, hc, valid, cat_smooth, min_data_per_group):
    """(eligible, order): the categories with min_data_per_group rows, and
    the bins in the stable ascending sort of g / (h + cat_smooth), the
    ineligible bins sorted to the end."""
    eligible = valid & (hc >= min_data_per_group)
    ratio = torch.where(eligible, hg / (hh + cat_smooth), 1e10)
    return eligible, torch.argsort(ratio, dim=-1, stable=True)


class _CatBest(NamedTuple):
    """Each (slot, feature)'s best categorical split."""
    gain: torch.Tensor         # (S, F) over the cat-regularized parent
    threshold: torch.Tensor    # (S, F) prefix length k, or the one-hot bin
    dir_flags: torch.Tensor    # (S, F) DIR_CATEGORICAL | ONEHOT / REVERSED
    left_g: torch.Tensor       # (S, F)
    left_h: torch.Tensor
    left_c: torch.Tensor


def _categorical_scan(hg, hh, hc, parent_g, parent_h, parent_c,
                      layout: FeatureLayout, sc: _Scan,
                      cat: CatParams) -> _CatBest:
    """The categorical branch (reference: find_best_splits :518-590): one
    category against the rest, and the prefixes of the sorted eligible
    categories, forward and reversed, of at most max_cat_threshold
    categories; features of at most max_cat_to_onehot bins take one-hot
    only.  Gains use lambda_l2 + cat_l2, the parent's term too."""
    S, F, Bmax = hg.shape
    dev = hg.device
    sc = sc._replace(l2=sc.l2 + cat.cat_l2)
    pg = parent_g[:, None, None]
    ph = parent_h[:, None, None]
    pc = parent_c[:, None, None]

    def gain_of(lg, lh, lc):
        return _pair_gain(sc, lg, lh, lc, pg - lg, ph - lh, pc - lc)

    valid = layout.valid_mask[None]
    is_cat = layout.is_cat[None, :, None]
    oh_gain = torch.where(valid & (hc >= cat.min_data_per_group) & is_cat,
                          gain_of(hg, hh, hc), NEG_INF)
    eligible, order = _category_order(hg, hh, hc, valid, cat.cat_smooth,
                                      cat.min_data_per_group)
    csg, csh, csc = (_cumsum(torch.gather(a, 2, order))
                     for a in (hg, hh, hc))
    n_elig = eligible.sum(dim=-1, keepdim=True)             # (S, F, 1)
    k_iota = 1 + torch.arange(Bmax, device=dev)[None, None, :]
    k_ok = k_iota <= torch.clamp(n_elig - 1, max=cat.max_cat_threshold)
    fwd_gain = torch.where(k_ok, gain_of(csg, csh, csc), NEG_INF)
    # the reversed prefix is the suffix of the ascending eligible order
    eg, eh, ec = (torch.where(eligible, a, 0.0).double().sum(
        dim=-1, keepdim=True).to(a.dtype) for a in (hg, hh, hc))
    rev_lg, rev_lh, rev_lc = eg - csg, eh - csh, ec - csc
    rev_k = n_elig - k_iota
    rev_ok = (rev_k >= 1) & (rev_k <= cat.max_cat_threshold)
    rev_gain = torch.where(rev_ok, gain_of(rev_lg, rev_lh, rev_lc), NEG_INF)

    use_onehot = layout.num_bins[None, :, None] <= cat.max_cat_to_onehot
    sorted_gain = torch.maximum(fwd_gain, rev_gain)
    sorted_rev = rev_gain > fwd_gain
    cat_gain = torch.where(use_onehot, oh_gain,
                           torch.maximum(oh_gain, sorted_gain))
    use_oh = use_onehot | (oh_gain >= sorted_gain)
    cat_gain = torch.where(is_cat, cat_gain, NEG_INF)
    cat_rel = _relative(cat_gain, _parent_term(sc, parent_g, parent_h))

    t = torch.argmax(cat_rel, dim=-1)                        # (S, F)
    ti = t[..., None]

    def at_t(a):
        return torch.gather(a, 2, ti)[..., 0]

    oh, rev = at_t(use_oh), at_t(sorted_rev)
    left = [torch.where(oh, at_t(x), torch.where(rev, e[..., 0] - at_t(c),
                                                 at_t(c)))
            for x, c, e in ((hg, csg, eg), (hh, csh, eh), (hc, csc, ec))]
    flags = (DIR_CATEGORICAL + torch.where(oh, DIR_CAT_ONEHOT, 0)
             + torch.where(~oh & rev, DIR_CAT_REVERSED, 0))
    return _CatBest(gain=at_t(cat_rel), threshold=torch.where(oh, t, t + 1),
                    dir_flags=flags, left_g=left[0], left_h=left[1],
                    left_c=left[2])


def find_best_splits(hist: torch.Tensor, parent_g: torch.Tensor,
                     parent_h: torch.Tensor, parent_c: torch.Tensor,
                     layout: FeatureLayout, lambda_l1: float,
                     lambda_l2: float, min_data_in_leaf: int,
                     min_sum_hessian_in_leaf: float,
                     min_gain_to_split: float,
                     max_delta_step: float = 0.0,
                     col_mask: Optional[torch.Tensor] = None,
                     cat: Optional[CatParams] = None,
                     monotone: Optional[torch.Tensor] = None,
                     out_lo: Optional[torch.Tensor] = None,
                     out_hi: Optional[torch.Tensor] = None,
                     slot_penalty: Optional[torch.Tensor] = None,
                     path_smooth: float = 0.0,
                     parent_out: Optional[torch.Tensor] = None,
                     adv_bounds=None,
                     splittable: Optional[torch.Tensor] = None,
                     extra_key=None,
                     draw_rows: Optional[torch.Tensor] = None,
                     cegb_penalty: Optional[torch.Tensor] = None):
    """Best split of each of the S histogram slots (reference:
    find_best_splits).  ``col_mask`` (F,) or, per slot, (S, F) bool: a
    feature outside it never wins.  ``cat``: the categorical parameters,
    under which a categorical feature (``layout.is_cat``) takes its
    categorical split, never its numeric scan; None (a layout without
    categorical features) runs the numeric scan alone, as the reference's
    ``enable_categorical=False``.  ``monotone`` (F,) int signs, ``out_lo``,
    ``out_hi`` and ``parent_out`` (S,) each slot's output bounds and own
    output: the basic method's constraints and ``path_smooth`` on the
    numeric scan, which then gains at the constrained outputs (categorical
    splits stay unconstrained); ``slot_penalty`` (S,) the monotone penalty
    factor of each slot's depth (``penalty_table``), or None.

    The advanced monotone method: ``adv_bounds`` (v_min, v_max), each slot's
    (S, F, Bmax) constraint slabs, bound the children per threshold in
    place of ``out_lo`` / ``out_hi``: the reverse scan by the running and
    suffix extrema, the forward scan by bin 0's values on the left and the
    whole slab's on the right (the reference's cumulative constraint, whose
    forward indices never move); ``splittable`` (S, F) bool keeps the
    features whose last scan of the slot found a candidate; the result's
    ``feat_ok`` (S, F) bool holds the features with a numeric candidate
    above ``min_gain_to_split`` (every categorical feature), else None.
    ``extra_key`` (a ``utils.random`` key): extra trees, each (slot,
    feature) keeps the one threshold ``randint(key, (R, F), 0, 2**30) %
    max(bins - 1, 1)`` of row ``draw_rows[slot]`` of the reference's (R,
    F) draw, on both scans; categorical features keep theirs.
    ``cegb_penalty`` (S, F) float32: CEGB's cost of each (slot, feature),
    taken off the feature's best gain after its numeric or categorical
    pick and before the feature mask (reference: ops/split.py:486-491,
    :591-593); ``feat_ok`` is set before it."""
    S = hist.shape[0]
    Bmax = hist.shape[2]
    dev = hist.device
    sc = _Scan(lambda_l1, lambda_l2, max_delta_step, min_data_in_leaf,
               min_sum_hessian_in_leaf)
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

    out_rev = out_fwd = None
    if monotone is not None or path_smooth > 0.0 or adv_bounds is not None:
        mono = None if monotone is None else monotone[None, :, None]
        po = parent_out[:, None, None]
        if adv_bounds is not None:
            v_min, v_max = adv_bounds
            out_rev = _Constraints(*adv_child_bounds(v_min, v_max), po,
                                   path_smooth, mono)
            out_fwd = _Constraints(v_min[..., :1], v_max[..., :1],
                                   v_min.amax(dim=-1, keepdim=True),
                                   v_max.amin(dim=-1, keepdim=True), po,
                                   path_smooth, mono)
        else:
            lo, hi = out_lo[:, None, None], out_hi[:, None, None]
            out_rev = out_fwd = _Constraints(lo, hi, lo, hi, po,
                                             path_smooth, mono)

    def split_gain(lg, lh, lc, rc, out):
        return _pair_gain(sc, lg, lh, lc, pg - lg, ph - lh, rc, out)

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
    gain_rev = split_gain(lg_rev, lh_rev, lc_rev, rc_rev, out_rev)
    gain_fwd = torch.where(has_miss,
                           split_gain(cg_eff, ch_eff, lc_fwd, rc_fwd,
                                      out_fwd),
                           NEG_INF)
    rev_skip = has_mz & (bin_iota == mzb - 1)
    fwd_skip = has_mz & (bin_iota == mzb)
    fwd_hi = torch.where(has_mz, data_bins - 1, data_bins)
    gain_rev = torch.where((bin_iota < data_bins - 1) & ~rev_skip, gain_rev,
                           NEG_INF)
    gain_fwd = torch.where((bin_iota < fwd_hi) & ~fwd_skip, gain_fwd, NEG_INF)

    parent_term = _parent_term(sc, parent_g, parent_h)
    rel_rev = _relative(gain_rev, parent_term)
    rel_fwd = _relative(gain_fwd, parent_term)
    if monotone is not None and slot_penalty is not None:
        # a constrained feature's gain scaled down by its slot's depth
        pen = slot_penalty[:, None, None]
        m = monotone[None, :, None] != 0
        rel_rev, rel_fwd = (torch.where(m & (r > 0), r * pen, r)
                            for r in (rel_rev, rel_fwd))
    if extra_key is not None:
        # one random threshold of each (slot, feature)
        rand_t = randint_rows(extra_key, draw_rows, layout.num_bins.shape[0],
                              0, 1 << 30) % torch.clamp(
                                  layout.num_bins - 1, min=1)[None, :]
        keep = bin_iota == rand_t[..., None]
        rel_rev, rel_fwd = (torch.where(keep, r, NEG_INF)
                            for r in (rel_rev, rel_fwd))
    if splittable is not None:
        # features whose last scan of the slot found nothing stay out
        rel_rev, rel_fwd = (torch.where(splittable[..., None], r, NEG_INF)
                            for r in (rel_rev, rel_fwd))
    feat_ok = None
    if adv_bounds is not None:
        feat_ok = ((rel_rev > min_gain_to_split).any(dim=-1)
                   | (rel_fwd > min_gain_to_split).any(dim=-1)
                   | layout.is_cat[None, :])
    # reverse keeps the highest of tied thresholds, forward the lowest, and
    # reverse wins a tie between the scans
    t_rev = (Bmax - 1) - torch.argmax(torch.flip(rel_rev, [-1]), dim=-1)
    g_rev = torch.gather(rel_rev, 2, t_rev[..., None])[..., 0]
    t_fwd = torch.argmax(rel_fwd, dim=-1)
    g_fwd = torch.gather(rel_fwd, 2, t_fwd[..., None])[..., 0]
    use_rev = g_rev >= g_fwd
    best_t = torch.where(use_rev, t_rev, t_fwd)                # (S, F)
    best_gain_f = torch.where(use_rev, g_rev, g_fwd)
    if cat is not None:
        cb = _categorical_scan(hg, hh, hc, parent_g, parent_h, parent_c,
                               layout, sc, cat)
        best_gain_f = torch.where(layout.is_cat[None, :], cb.gain,
                                  best_gain_f)
    if cegb_penalty is not None:
        best_gain_f = torch.where(best_gain_f > NEG_INF / 2,
                                  best_gain_f - cegb_penalty, NEG_INF)
    if col_mask is not None:
        cm = col_mask if col_mask.dim() == 2 else col_mask[None, :]
        best_gain_f = torch.where(cm, best_gain_f, NEG_INF)

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
    if cat is not None:
        # the winner's categorical split where its feature is categorical
        f_cat = layout.is_cat[best_f]

        def pick(num, c):
            return torch.where(f_cat, c[ar, best_f], num)

        t, dir_flags = pick(t, cb.threshold), pick(dir_flags, cb.dir_flags)
        lg, lh, lc = (pick(lg, cb.left_g), pick(lh, cb.left_h),
                      pick(lc, cb.left_c))
    return SplitResult(gain=gain, feature=best_f, threshold=t,
                       dir_flags=dir_flags, left_sum_g=lg, left_sum_h=lh,
                       left_count=lc, feat_ok=feat_ok)


def categorical_left_bitset(hist_f: torch.Tensor, threshold: torch.Tensor,
                            dir_flags: torch.Tensor, valid_mask: torch.Tensor,
                            cat_smooth: float, min_data_per_group: int,
                            cnt_factor: torch.Tensor) -> torch.Tensor:
    """(S, Bmax) bool: the bins that go left under each slot's chosen
    categorical split, from the split feature's (S, Bmax, 2) histogram
    (reference: categorical_left_bitset).  One-hot: the threshold's bin;
    a sorted subset: the first (or, reversed, the last) k eligible bins of
    the order ``find_best_splits`` sorted, k the threshold.  cnt_factor
    (S,) estimates the bins' counts from their hessians, as the scan
    does."""
    hg, hh = hist_f[..., 0], hist_f[..., 1]
    hc = round_int(hh * cnt_factor[..., None])
    Bmax = hg.shape[-1]
    eligible, order = _category_order(hg, hh, hc, valid_mask, cat_smooth,
                                      min_data_per_group)
    rank = torch.argsort(order, dim=-1)
    n_elig = eligible.sum(dim=-1, keepdim=True)
    k = threshold[..., None]
    rev = ((dir_flags & DIR_CAT_REVERSED) != 0)[..., None]
    in_set = torch.where(rev, (rank >= k) & (rank < n_elig), rank < k)
    onehot = ((dir_flags & DIR_CAT_ONEHOT) != 0)[..., None]
    bin_iota = torch.arange(Bmax, device=hg.device)
    return torch.where(onehot, bin_iota == k, in_set & eligible)
