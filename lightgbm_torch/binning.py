"""Feature binning + exclusive feature bundling (host side).

The port's own copy of ``lightgbm_tpu/binning.py``, trimmed to in-memory
dense and SciPy sparse input (reference: include/LightGBM/bin.h:86
BinMapper::FindBin, src/io/bin.cpp GreedyFindBin; EFB:
src/io/dataset.cpp:65-369 GetConflictCount/FindGroups/FastFeatureBundling).  Everything stays in
float64 NumPy, so the mappers' ``upper_bounds`` are bit-equal to the
reference's: split thresholds are requantized against them with
``np.searchsorted(upper_bounds, thr, side="left")``.

The binned dataset is a single dense uint8/uint16 matrix ``bins[N, G]`` of
per-group local bin indices; an EFB bundle stores, in one group column, the
non-default bins of each of its features after a shared default bin 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .utils.log import log_info, log_warning

# Missing type (reference: bin.h:28 MissingType)
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1

_ZERO_LB = -1e-35  # reference: kZeroThreshold semantics — |v| <= ~0 treated as zero bin
_ZERO_UB = 1e-35


@dataclass
class BinMapper:
    """Per-feature value -> bin mapping (reference: bin.h:86)."""

    upper_bounds: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    bin_type: int = BIN_NUMERICAL
    missing_type: int = MISSING_NONE
    categories: np.ndarray = field(default_factory=lambda: np.array([], dtype=np.int64))
    num_bins: int = 1
    default_bin: int = 0          # bin that value 0.0 maps to (sparse default)
    most_freq_bin: int = 0
    min_val: float = 0.0          # sampled value range (feature_infos)
    max_val: float = 0.0

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    def bin_to_threshold(self, bin_idx: int) -> float:
        """Real threshold of a ``value <= threshold`` split at bin
        ``bin_idx``: the bin's upper bound."""
        return float(self.upper_bounds[min(bin_idx, len(self.upper_bounds) - 1)])

    # ------------------------------------------------------------------
    @staticmethod
    def find_numerical(sample: np.ndarray, max_bin: int, min_data_in_bin: int,
                       use_missing: bool, zero_as_missing: bool,
                       total_sample_cnt: Optional[int] = None,
                       forced_bounds: Optional[Sequence[float]] = None
                       ) -> "BinMapper":
        """Find bin boundaries from sampled values — an exact port of the
        reference's BinMapper::FindBin numerical path (src/io/bin.cpp:316:
        NaN filtering and missing-type choice, zero-count restoration, and
        FindBinWithZeroAsOneBin / GreedyFindBin boundary selection), so
        thresholds in saved models match stock LightGBM digit-for-digit.

        total_sample_cnt: total rows the sample stands for; rows beyond
        len(sample) are implicit zeros (sparse ingestion)."""
        sample = np.asarray(sample, dtype=np.float64)
        vals = sample[~np.isnan(sample)]
        # summarize and delegate: the missing-type decision, zero-count
        # restoration, ulp-merge, boundary finders, and most_freq_bin
        # selection live ONLY in find_numerical_counts, so the sample
        # and sketch paths cannot drift (the stream-vs-inmem identity
        # guarantee, docs/INGEST.md)
        distinct, counts = np.unique(vals, return_counts=True)
        # normalize -0.0 -> +0.0 (the raw sort's ulp-run keeps the last,
        # i.e. +0.0, of a -0.0/+0.0 pair; the sketch normalizes too)
        distinct = np.where(distinct == 0.0, 0.0, distinct)
        return BinMapper.find_numerical_counts(
            distinct, counts.astype(np.int64), len(sample) - len(vals),
            max_bin, min_data_in_bin, use_missing, zero_as_missing,
            total_sample_cnt=total_sample_cnt,
            forced_bounds=forced_bounds)

    @staticmethod
    def find_numerical_counts(distinct: np.ndarray, counts: np.ndarray,
                              na_cnt: int, max_bin: int, min_data_in_bin: int,
                              use_missing: bool, zero_as_missing: bool,
                              total_sample_cnt: Optional[int] = None,
                              forced_bounds: Optional[Sequence[float]] = None
                              ) -> "BinMapper":
        """find_numerical fed by a (sorted distinct values, counts, NaN
        count) summary instead of the raw sample — the entry point for the
        streaming ingest sketch (ingest.FeatureSketch).  When the summary
        is exact (every value/count preserved), the result is IDENTICAL to
        ``find_numerical`` on the equivalent sample: both funnel through
        the same ulp-merge / zero-insertion and the same boundary finders
        (tested in tests/test_ingest.py).

        distinct: strictly increasing non-NaN values; counts: per-value
        occurrence counts; na_cnt: NaN occurrences in the summarized
        sample; total_sample_cnt: total rows the summary stands for (rows
        beyond the summarized count are implicit zeros, sparse ingestion)."""
        distinct = np.asarray(distinct, np.float64)
        counts = np.asarray(counts, np.int64)
        n_nonnan = int(counts.sum())
        sample_len = n_nonnan + int(na_cnt)
        n_total = int(total_sample_cnt if total_sample_cnt is not None
                      else sample_len)
        if not use_missing:
            missing_type = MISSING_NONE
            na_cnt = 0
        elif zero_as_missing:
            missing_type = MISSING_ZERO
            na_cnt = 0
        elif na_cnt == 0:
            missing_type = MISSING_NONE
        else:
            missing_type = MISSING_NAN
        zero_cnt = n_total - n_nonnan - int(na_cnt)

        distinct, counts = _distinct_counts_with_zero(distinct, counts,
                                                      zero_cnt)
        if len(distinct) == 0:
            return BinMapper(missing_type=missing_type,
                             num_bins=2 if missing_type == MISSING_NAN else 1)
        min_val, max_val = float(distinct[0]), float(distinct[-1])

        def _find(mb, tc):
            if forced_bounds:
                return _find_bin_predefined(distinct, counts, mb, tc,
                                            min_data_in_bin, forced_bounds)
            return _find_bin_zero_as_one_bin(distinct, counts, mb, tc,
                                             min_data_in_bin)

        if missing_type == MISSING_NAN:
            bounds = _find(max_bin - 1, n_total - na_cnt)
            num_bins = len(bounds) + 1
        else:
            bounds = _find(max_bin, n_total)
            if missing_type == MISSING_ZERO and len(bounds) == 2:
                missing_type = MISSING_NONE
            num_bins = len(bounds)

        m = BinMapper(upper_bounds=np.asarray(bounds, np.float64),
                      missing_type=missing_type, num_bins=int(num_bins),
                      bin_type=BIN_NUMERICAL)
        m.min_val, m.max_val = min_val, max_val
        if num_bins <= 1:
            return m
        cnt_in_bin = np.zeros(num_bins, np.int64)
        idx = np.searchsorted(m.upper_bounds, distinct, side="left")
        np.add.at(cnt_in_bin, np.minimum(idx, len(bounds) - 1), counts)
        if missing_type == MISSING_NAN:
            cnt_in_bin[num_bins - 1] = na_cnt
        m.default_bin = int(np.searchsorted(m.upper_bounds, 0.0, side="left"))
        most_freq = int(np.argmax(cnt_in_bin))
        if most_freq != m.default_bin and \
                cnt_in_bin[most_freq] / max(n_total, 1) < 0.7:  # kSparseThreshold
            most_freq = m.default_bin
        m.most_freq_bin = most_freq
        return m

    @staticmethod
    def find_categorical(sample: np.ndarray, max_bin: int, min_data_in_bin: int,
                         use_missing: bool) -> "BinMapper":
        """Categorical binning: categories sorted by count desc get bins 0..K-1.

        Unseen / negative categories map to bin 0 at transform time (reference:
        CategoricalBin semantics, bin.cpp)."""
        sample = np.asarray(sample, dtype=np.float64)
        vals = sample[~np.isnan(sample)]
        ivals = vals.astype(np.int64)
        neg = ivals < 0
        if neg.any():
            log_warning("negative categorical values found; treated as missing/zero category")
            ivals = ivals[~neg]
        if ivals.size == 0:
            return BinMapper(bin_type=BIN_CATEGORICAL)
        uniq, counts = np.unique(ivals, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        uniq, counts = uniq[order], counts[order]
        # drop categories with very low count when over budget
        keep = min(len(uniq), max_bin)
        # reference behavior: cut at 99% of data or max_bin
        cum = np.cumsum(counts)
        total = cum[-1]
        cut = int(np.searchsorted(cum, 0.99 * total) + 1)
        keep = max(1, min(keep, cut)) if len(uniq) > max_bin else keep
        cats = uniq[:keep]
        m = BinMapper(bin_type=BIN_CATEGORICAL, categories=cats, num_bins=int(keep),
                      upper_bounds=np.array([np.inf]))
        m.missing_type = MISSING_NAN if use_missing else MISSING_NONE
        return m

    # ------------------------------------------------------------------
    def transform(self, values: np.ndarray) -> np.ndarray:
        """Map raw values to bin indices (vectorised)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            iv = np.where(np.isnan(values), -1, values).astype(np.int64)
            # map category -> bin; unseen -> 0
            lut: Dict[int, int] = {int(c): i for i, c in enumerate(self.categories)}
            out = np.zeros(values.shape, dtype=np.int32)
            if len(lut) < 4096:
                for c, b in lut.items():
                    out[iv == c] = b
            else:  # large-cardinality path
                sorter = np.argsort(self.categories)
                pos = np.searchsorted(self.categories, iv, sorter=sorter)
                pos = np.clip(pos, 0, len(self.categories) - 1)
                hit = self.categories[sorter[pos]] == iv
                out = np.where(hit, sorter[pos], 0).astype(np.int32)
            return out
        # reference ValueToBin (bin.h:613): NaN -> last bin when
        # MissingType::NaN, else NaN binned as 0.0 (zero lives in its own
        # [-kZeroThreshold, kZeroThreshold] window bin)
        nan_mask = np.isnan(values)
        out = np.searchsorted(self.upper_bounds,
                              np.where(nan_mask, 0.0, values),
                              side="left").astype(np.int32)
        out = np.clip(out, 0, len(self.upper_bounds) - 1)
        if self.missing_type == MISSING_NAN:
            out[nan_mask] = self.num_bins - 1
        return out


def _distinct_counts_with_zero(distinct: np.ndarray, counts: np.ndarray,
                               zero_cnt: int):
    """_distinct_with_zero for inputs already summarized as (strictly
    increasing distinct values, counts) — the ulp-run merge and the zero
    insertion are byte-for-byte the same rules, applied to the summary
    instead of the raw sample (sketch ingestion, docs/INGEST.md)."""
    n = len(distinct)
    if n == 0:
        if zero_cnt > 0:
            return np.array([0.0]), np.array([zero_cnt], np.int64)
        return np.array([]), np.array([], np.int64)
    # runs where each value <= nextafter(previous) collapse to their LAST
    # value (CheckDoubleEqualOrdered) — counts sum over the run
    new_grp = np.empty(n, bool)
    new_grp[0] = True
    new_grp[1:] = distinct[1:] > np.nextafter(distinct[:-1], np.inf)
    starts = np.flatnonzero(new_grp)
    run_last = np.flatnonzero(np.append(new_grp[1:], True))
    distinct = distinct[run_last]
    counts = np.add.reduceat(np.asarray(counts, np.int64), starts)
    k = len(distinct)

    neg = distinct < 0.0
    pos = distinct > 0.0
    has_zero_val = np.any(~neg & ~pos)
    if has_zero_val:
        zi = int(np.flatnonzero(~neg & ~pos)[0])
        counts = counts.copy()
        counts[zi] += zero_cnt
        return distinct, counts
    insert_at = int(np.sum(neg))
    if (insert_at == 0 and zero_cnt > 0) or \
            (0 < insert_at < k) or \
            (insert_at == k and zero_cnt > 0):
        distinct = np.insert(distinct, insert_at, 0.0)
        counts = np.insert(counts, insert_at, zero_cnt)
    return distinct, counts


def _greedy_find_bin(distinct: np.ndarray, counts: np.ndarray, max_bin: int,
                     total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Exact port of GreedyFindBin (bin.cpp:81): per-value bins when the
    budget allows (with min_data_in_bin coalescing), else heavy-hitter
    values get dedicated bins and the rest greedily fill to a re-estimated
    mean bin size; boundaries are nextafter'd midpoints."""
    nd = len(distinct)
    bounds: List[float] = []
    if max_bin <= 0:
        return bounds
    if nd <= max_bin:
        cur = 0
        for i in range(nd - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = np.nextafter((distinct[i] + distinct[i + 1]) / 2.0,
                                   np.inf)
                if not bounds or val > np.nextafter(bounds[-1], np.inf):
                    bounds.append(float(val))
                    cur = 0
        bounds.append(np.inf)
        return bounds
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(np.sum(is_big))
    rest_sample_cnt = int(total_cnt - counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    uppers: List[float] = []
    lowers: List[float] = [float(distinct[0])]
    cur = 0
    for i in range(nd - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if is_big[i] or cur >= mean_bin_size or \
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5)):
            uppers.append(float(distinct[i]))
            lowers.append(float(distinct[i + 1]))
            if len(uppers) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    for i in range(len(uppers)):
        val = np.nextafter((uppers[i] + lowers[i + 1]) / 2.0, np.inf)
        if not bounds or val > np.nextafter(bounds[-1], np.inf):
            bounds.append(float(val))
    bounds.append(np.inf)
    return bounds


_K_ZERO = 1e-35  # kZeroThreshold (meta.h:57): |v| <= ~0 shares the zero bin


def _find_bin_predefined(distinct: np.ndarray, counts: np.ndarray,
                         max_bin: int, total_cnt: int, min_data_in_bin: int,
                         forced: Sequence[float]) -> List[float]:
    """Exact port of FindBinWithPredefinedBin (bin.cpp:162): zero bounds +
    user-forced bounds first, then remaining budget split across the forced
    intervals proportionally to their sample counts via GreedyFindBin."""
    nd = len(distinct)
    gt = np.flatnonzero(distinct > -_K_ZERO)
    left_cnt = int(gt[0]) if len(gt) else nd
    rs = np.flatnonzero(distinct[left_cnt:] > _K_ZERO)
    right_start = left_cnt + int(rs[0]) if len(rs) else -1

    bounds: List[float] = []
    if max_bin == 2:
        bounds.append(_K_ZERO if left_cnt == 0 else -_K_ZERO)
    elif max_bin >= 3:
        if left_cnt > 0:
            bounds.append(-_K_ZERO)
        if right_start >= 0:
            bounds.append(_K_ZERO)
    bounds.append(np.inf)

    max_to_insert = max_bin - len(bounds)
    num_inserted = 0
    for fb in forced:
        if num_inserted >= max_to_insert:
            break
        if abs(float(fb)) > _K_ZERO:
            bounds.append(float(fb))
            num_inserted += 1
    bounds.sort()

    free_bins = max_bin - len(bounds)
    bounds_to_add: List[float] = []
    value_ind = 0
    nb = len(bounds)
    for i in range(nb):
        cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < nd and distinct[value_ind] < bounds[i]:
            cnt_in_bin += int(counts[value_ind])
            value_ind += 1
        distinct_cnt = value_ind - bin_start
        bins_remaining = max_bin - nb - len(bounds_to_add)
        # std::lround = round-half-away-from-zero (operand is non-negative)
        num_sub_bins = int(math.floor(cnt_in_bin * free_bins / total_cnt + 0.5))
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == nb - 1:
            num_sub_bins = bins_remaining + 1
        new_ub = _greedy_find_bin(distinct[bin_start:value_ind],
                                  counts[bin_start:value_ind],
                                  num_sub_bins, cnt_in_bin, min_data_in_bin)
        bounds_to_add.extend(new_ub[:-1])      # last bound is infinity
    bounds.extend(bounds_to_add)
    bounds.sort()
    return bounds


def load_forced_bins(path: str, num_features: int,
                     categorical_features: Sequence[int] = ()
                     ) -> Optional[List[List[float]]]:
    """Read a forcedbins_filename JSON (reference:
    DatasetLoader::GetForcedBins, dataset_loader.cpp:1511): a list of
    {"feature": i, "bin_upper_bound": [..]} entries; categorical features are
    ignored with a warning, duplicate consecutive bounds dropped."""
    if not path:
        return None
    import json as _json
    import os as _os
    if not _os.path.exists(path):
        log_warning(f"Could not open {path}. Will ignore.")
        return None
    with open(path) as fh:
        arr = _json.load(fh)
    cats = set(int(c) for c in categorical_features)
    forced: List[List[float]] = [[] for _ in range(num_features)]
    for item in arr:
        f = int(item["feature"])
        if not 0 <= f < num_features:
            raise ValueError(f"forced bins feature index {f} out of range")
        if f in cats:
            log_warning(f"Feature {f} is categorical. Will ignore forced "
                        "bins for this feature.")
            continue
        bb = [float(v) for v in item.get("bin_upper_bound", [])]
        forced[f] = [b for i, b in enumerate(bb) if i == 0 or b != bb[i - 1]]
    return forced


def _find_bin_zero_as_one_bin(distinct: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_cnt: int,
                              min_data_in_bin: int) -> List[float]:
    """Exact port of FindBinWithZeroAsOneBin (bin.cpp:247): negatives and
    positives are binned separately with count-proportional budgets and the
    zero window [-kZeroThreshold, kZeroThreshold] is its own bin."""
    left_cnt_data = int(counts[distinct <= -_K_ZERO].sum())
    cnt_zero = int(counts[(distinct > -_K_ZERO) & (distinct <= _K_ZERO)].sum())
    right_cnt_data = int(counts[distinct > _K_ZERO].sum())

    gt = np.flatnonzero(distinct > -_K_ZERO)
    left_cnt = int(gt[0]) if len(gt) else len(distinct)

    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = max(total_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = _greedy_find_bin(distinct[:left_cnt], counts[:left_cnt],
                                  left_max_bin, left_cnt_data,
                                  min_data_in_bin)
        if bounds:
            bounds[-1] = -_K_ZERO

    rs = np.flatnonzero(distinct[left_cnt:] > _K_ZERO)
    right_start = left_cnt + int(rs[0]) if len(rs) else -1

    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        right = _greedy_find_bin(distinct[right_start:], counts[right_start:],
                                 right_max_bin, right_cnt_data,
                                 min_data_in_bin)
        bounds.append(_K_ZERO)
        bounds.extend(right)
    else:
        bounds.append(np.inf)
    return bounds


# ---------------------------------------------------------------------------
# Exclusive Feature Bundling (reference: dataset.cpp:65-369)
# ---------------------------------------------------------------------------

def find_feature_groups(sample_bins: Optional[List[np.ndarray]],
                        bin_mappers: List[BinMapper],
                        enable_bundle: bool, max_conflict_rate: float = 0.0,
                        sparse_threshold: float = 0.8,
                        nz_masks: Optional[List[np.ndarray]] = None,
                        max_group_bins: Optional[int] = None) -> List[List[int]]:
    """Greedy bundling of mutually (near-)exclusive sparse features.

    ``sample_bins[f]`` are the sampled bin values of feature f; a row "uses" the feature
    when its bin differs from the feature's default bin. Features whose nonzero sets
    conflict in at most ``max_conflict_rate * n`` rows share a bundle.
    ``nz_masks`` (sparse ingest) supplies the usage masks directly.
    ``max_group_bins`` bounds a bundle's total bin count: the engine's dense
    layouts pad every group to the LARGEST group's bin count (uint8 bins,
    (F, Bmax) routing tables, (S, G, Bmax) histograms), so one oversized
    bundle would inflate every per-group buffer (reference analog: EFB
    bundles are capped by the bin dtype, dataset.cpp FindGroups). The
    default bounds the padded-layout product F * Bmax instead of a fixed
    size, so narrow datasets bundle freely while wide sparse ones stay
    within device memory."""
    num_features = len(bin_mappers)
    if max_group_bins is None:
        max_group_bins = max(255, 2_000_000 // max(num_features, 1))
    if not enable_bundle or num_features <= 1:
        return [[f] for f in range(num_features)]
    n = (len(nz_masks[0]) if nz_masks is not None
         else len(sample_bins[0])) if num_features else 0
    if n == 0:
        return [[f] for f in range(num_features)]

    if nz_masks is None:
        nz_masks = []
        for f in range(num_features):
            nz_masks.append(sample_bins[f] != bin_mappers[f].default_bin)
    nz_counts = np.array([int(m.sum()) for m in nz_masks])
    sparse = nz_counts < sparse_threshold * n
    order = np.argsort(-nz_counts, kind="stable")

    max_conflict = int(max_conflict_rate * n)
    groups: List[List[int]] = []
    group_masks: List[np.ndarray] = []
    group_conflicts: List[int] = []
    group_bins: List[int] = []          # 1 shared default + per-feature extras
    for f in order:
        f = int(f)
        nb = int(bin_mappers[f].num_bins)
        if not sparse[f] or bin_mappers[f].bin_type == BIN_CATEGORICAL:
            groups.append([f])
            group_masks.append(None)  # never bundled into
            group_conflicts.append(0)
            group_bins.append(nb)
            continue
        placed = False
        tried = 0
        for gi in range(len(groups) - 1, -1, -1):
            # newest-first, bounded search (the reference's FindGroups also
            # caps its search to keep EFB O(#feature), dataset.cpp:112)
            if group_masks[gi] is None:
                continue
            if group_bins[gi] + nb - 1 > max_group_bins:
                continue
            tried += 1
            if tried > 64:
                break
            conflict = int((group_masks[gi] & nz_masks[f]).sum())
            if group_conflicts[gi] + conflict <= max_conflict:
                groups[gi].append(f)
                group_masks[gi] = group_masks[gi] | nz_masks[f]
                group_conflicts[gi] += conflict
                group_bins[gi] += nb - 1
                placed = True
                break
        if not placed:
            groups.append([f])
            group_masks.append(nz_masks[f].copy())
            group_conflicts.append(0)
            group_bins.append(1 + nb - 1)
    # restore deterministic ordering: sort groups by first feature index
    for g in groups:
        g.sort()
    groups.sort(key=lambda g: g[0])
    return groups


# ---------------------------------------------------------------------------
# Binned dataset container
# ---------------------------------------------------------------------------

@dataclass
class BinnedData:
    """Dense binned matrix + static layout metadata.

    bins[N, G] holds per-group local bins. Feature f occupies the half-open global-bin
    span [feature_offsets[f], feature_offsets[f] + feature_num_bins[f]) where
    global_bin = group_offsets[g] + local_bin."""

    bins: np.ndarray                      # (N, G) uint8/uint16
    group_features: List[List[int]]       # features in each group
    group_offsets: np.ndarray             # (G+1,) int32 — global bin offset of each group
    group_bin_counts: np.ndarray          # (G,) int32
    feature_offsets: np.ndarray           # (F,) int32 — global bin offset of each feature
    feature_num_bins: np.ndarray          # (F,) int32
    bin_mappers: List[BinMapper] = field(default_factory=list)
    num_data: int = 0
    num_features: int = 0

    @property
    def num_groups(self) -> int:
        return len(self.group_features)


def _group_nbins(g: List[int], bin_mappers: List[BinMapper]) -> int:
    if len(g) == 1:
        return int(bin_mappers[g[0]].num_bins)
    return 1 + sum(int(bin_mappers[f].num_bins) - 1 for f in g)


def bin_bucket_size(nbins: int, bpad: Optional[int] = None) -> int:
    """Power-of-two bin bucket (min 8) for the bucketed one-hot M-axis —
    the ONE definition shared by the group sort (device_group_order) and
    the kernel run computation (gbdt._resolved_bin_buckets): the two must
    agree or same-bucket groups fragment into extra runs."""
    b = 8
    while b < nbins:
        b *= 2
    return min(b, bpad) if bpad is not None else b


def device_group_order(groups: List[List[int]],
                       bin_mappers: List[BinMapper]) -> List[List[int]]:
    """Stable-sort groups by DESCENDING power-of-two bin bucket (min 8).

    The streaming histogram kernel's one-hot rows are allocated per bucket
    run (M = sum of each group's rounded bin count instead of
    G x max_bins), so same-bucket groups must be contiguous. Datasets whose
    groups all share one bucket — e.g. every feature at max_bin — keep
    their original order (stable sort), and reordering never changes
    results: split scans are per-feature through the layout's
    gather/permutation."""
    return sorted(groups,
                  key=lambda g: bin_bucket_size(_group_nbins(g, bin_mappers)),
                  reverse=True)


def _group_layout(groups: List[List[int]], bin_mappers: List[BinMapper],
                  num_features: int):
    """Shared bin-layout bookkeeping for dense and sparse construction.

    Per-feature in-group offsets; bundled features share a group column.
    In a bundle, local bin 0 means "all features at default"; feature f's
    non-default bins occupy [in_group_offset[f], in_group_offset[f] +
    nbins_f - 1) shifted by 1."""
    group_bin_counts = []
    feature_offsets = np.zeros(num_features, dtype=np.int64)
    feature_num_bins = np.array([m.num_bins for m in bin_mappers], dtype=np.int64)
    group_offsets = [0]
    for g in groups:
        if len(g) == 1:
            group_bin_counts.append(int(bin_mappers[g[0]].num_bins))
            feature_offsets[g[0]] = group_offsets[-1]
        else:
            # bundle: 1 shared default bin + each feature's non-default bins
            cnt = 1
            for f in g:
                feature_offsets[f] = group_offsets[-1] + cnt - 1
                cnt += int(bin_mappers[f].num_bins) - 1
            group_bin_counts.append(cnt)
        group_offsets.append(group_offsets[-1] + group_bin_counts[-1])
    group_offsets = np.asarray(group_offsets, dtype=np.int64)
    max_group_bins = max(group_bin_counts) if group_bin_counts else 1
    dtype = np.uint8 if max_group_bins <= 256 else np.uint16
    return group_bin_counts, group_offsets, feature_offsets, feature_num_bins, dtype


def construct_binned(data: np.ndarray, bin_mappers: List[BinMapper],
                     groups: Optional[List[List[int]]] = None,
                     bins: Optional[np.ndarray] = None) -> BinnedData:
    """Bin a raw (N, F) float matrix into the dense group-bin layout.
    ``bins``: the (N, G) bins of these rows made elsewhere (the card's
    kernels/bin_rows.py), kept as they are; the rows then only give their
    shape."""
    n, num_features = data.shape
    if len(bin_mappers) != num_features:
        raise ValueError(f"{len(bin_mappers)} bin mappers for "
                         f"{num_features} features")
    if groups is None:
        groups = [[f] for f in range(num_features)]
    groups = device_group_order(groups, bin_mappers)

    (group_bin_counts, group_offsets, feature_offsets, feature_num_bins,
     dtype) = _group_layout(groups, bin_mappers, num_features)
    if bins is not None:
        if bins.shape != (n, len(groups)) or bins.dtype != dtype:
            raise ValueError(f"bins {bins.shape} {bins.dtype} for {n} rows "
                             f"of {len(groups)} groups of {dtype.__name__}")
    else:
        bins = np.zeros((n, len(groups)), dtype=dtype)
        for gi, g in enumerate(groups):
            if len(g) == 1:
                f = g[0]
                bins[:, gi] = bin_mappers[f].transform(data[:, f]).astype(dtype)
                continue
            # one int64 accumulator per group, cast to the storage dtype once
            in_group = 1
            col = np.zeros(n, dtype=np.int64)
            for f in g:
                m = bin_mappers[f]
                b = m.transform(data[:, f]).astype(np.int64)
                nondef = b != m.default_bin
                # shift: feature-local non-default bins map to
                # [in_group, in_group + num_bins - 1); default stays 0 in
                # the bundle
                local = np.where(b > m.default_bin, b - 1, b)
                col = np.where(nondef, in_group + local, col)
                in_group += m.num_bins - 1
            bins[:, gi] = col.astype(dtype)

    return BinnedData(
        bins=bins,
        group_features=groups,
        group_offsets=group_offsets.astype(np.int32),
        group_bin_counts=np.asarray(group_bin_counts, dtype=np.int32),
        feature_offsets=feature_offsets.astype(np.int32),
        feature_num_bins=feature_num_bins.astype(np.int32),
        bin_mappers=bin_mappers,
        num_data=n,
        num_features=num_features,
    )


def find_bin_mappers(data: np.ndarray, max_bin: int, min_data_in_bin: int,
                     categorical_features: Sequence[int] = (),
                     use_missing: bool = True, zero_as_missing: bool = False,
                     sample_cnt: int = 200000, seed: int = 1,
                     max_bin_by_feature: Optional[Sequence[int]] = None,
                     forced_bins: Optional[List[List[float]]] = None
                     ) -> List[BinMapper]:
    """Sample rows then find per-feature bin mappers (reference: two-round sampling,
    dataset_loader.cpp:258,601)."""
    n, num_features = data.shape
    rng = np.random.RandomState(seed)
    if n > sample_cnt:
        idx = rng.choice(n, size=sample_cnt, replace=False)
        sample = data[np.sort(idx)]
    else:
        sample = data
    cat = set(int(c) for c in categorical_features)
    mappers = []
    for f in range(num_features):
        mb = max_bin if max_bin_by_feature is None else int(max_bin_by_feature[f])
        col = np.asarray(sample[:, f], dtype=np.float64)
        if f in cat:
            mappers.append(BinMapper.find_categorical(col, mb, min_data_in_bin, use_missing))
        else:
            mappers.append(BinMapper.find_numerical(
                col, mb, min_data_in_bin, use_missing, zero_as_missing,
                forced_bounds=forced_bins[f] if forced_bins else None))
    return mappers


# ---------------------------------------------------------------------------
# SciPy sparse (CSR / CSC) input: mappers and EFB groups from the sampled
# non-zeros and implicit-zero counts, never the dense matrix (reference:
# lightgbm_tpu/binning.py:931-1046; src/io/sparse_bin.hpp, dataset_loader.cpp
# sampling of non-zero values).  The card fills the bins
# (kernels/bin_csr.py); construct_binned_sparse is its host oracle.
# ---------------------------------------------------------------------------

# the least positive float64: a stored value this close to 0.0 merges with
# the implicit zeros' 0.0 in the mapper's ulp-run rule
_TINY = 5e-324


def sample_sparse_csc(X, sample_cnt: int, seed: int):
    """Row-sample a scipy sparse matrix and return the sample in CSC form
    with its row count (the rows find_bin_mappers draws)."""
    n = X.shape[0]
    rng = np.random.RandomState(seed)
    Xr = X.tocsr()
    if n > sample_cnt:
        idx = np.sort(rng.choice(n, size=sample_cnt, replace=False))
        Xr = Xr[idx]
    return Xr.tocsc(), Xr.shape[0]


def find_bin_mappers_sparse(X, max_bin: int, min_data_in_bin: int,
                            categorical_features: Sequence[int] = (),
                            use_missing: bool = True,
                            zero_as_missing: bool = False,
                            sample_cnt: int = 200000, seed: int = 1,
                            max_bin_by_feature: Optional[Sequence[int]] = None,
                            forced_bins: Optional[List[List[float]]] = None,
                            sample=None) -> List[BinMapper]:
    """Per-feature bin mappers of a scipy sparse matrix, one column of
    sampled stored values at a time, equal to ``find_bin_mappers`` on the
    dense rows.  A numeric column's implicit zeros are counted
    (``total_sample_cnt``), not made, unless a stored value lies within one
    ulp of 0.0, where the ulp-run merge sees them as values; a categorical
    column gets its zeros back.  ``sample``: ``sample_sparse_csc``'s
    result, when the caller has it."""
    n, num_features = X.shape
    Xc, n_sample = (sample if sample is not None
                    else sample_sparse_csc(X, sample_cnt, seed))
    cat = set(int(c) for c in categorical_features)
    mappers = []
    for f in range(num_features):
        mb = max_bin if max_bin_by_feature is None else int(max_bin_by_feature[f])
        vals = np.asarray(Xc.data[Xc.indptr[f]:Xc.indptr[f + 1]], np.float64)
        # duplicate entries can outnumber the sampled rows: no zeros then
        zeros = np.zeros(max(n_sample - len(vals), 0))
        if f in cat:
            mappers.append(BinMapper.find_categorical(
                np.concatenate([vals, zeros]), mb, min_data_in_bin,
                use_missing))
            continue
        total = max(n_sample, len(vals))
        if np.any((vals != 0.0) & (np.abs(vals) <= _TINY)):
            vals = np.concatenate([vals, zeros])
            total = None
        mappers.append(BinMapper.find_numerical(
            vals, mb, min_data_in_bin, use_missing, zero_as_missing,
            total_sample_cnt=total,
            forced_bounds=forced_bins[f] if forced_bins else None))
    return mappers


def sparse_nz_masks(Xc, n_sample: int, bin_mappers: List[BinMapper]
                    ) -> List[np.ndarray]:
    """Per-feature "row uses this feature" masks for EFB conflict counting,
    straight from the CSC structure (no densify)."""
    masks = []
    for f, m in enumerate(bin_mappers):
        lo, hi = Xc.indptr[f], Xc.indptr[f + 1]
        vals = np.asarray(Xc.data[lo:hi], np.float64)
        rows = np.asarray(Xc.indices[lo:hi])
        b = m.transform(vals)
        mask = np.zeros(n_sample, bool)
        mask[rows[b != m.default_bin]] = True
        masks.append(mask)
    return masks


def construct_binned_sparse(X, bin_mappers: List[BinMapper],
                            groups: Optional[List[List[int]]] = None,
                            bins: Optional[np.ndarray] = None) -> BinnedData:
    """Bin a scipy sparse matrix into the dense (N, G) group layout in
    O(nnz): a column starts at the bin of an implicit 0.0 and its stored
    entries are scattered in (a feature alone in its group: its last
    stored entry; a bundle: its last non-default entry, in the group's
    feature order and then the stored order).  Equal to
    ``construct_binned`` of the dense rows where no (row, column) is stored
    twice.  ``bins``: the (N, G) bins made elsewhere (the card's
    kernels/bin_csr.py), kept as they are."""
    n, num_features = X.shape
    if len(bin_mappers) != num_features:
        raise ValueError(f"{len(bin_mappers)} bin mappers for "
                         f"{num_features} features")
    if groups is None:
        groups = [[f] for f in range(num_features)]
    groups = device_group_order(groups, bin_mappers)
    (group_bin_counts, group_offsets, feature_offsets, feature_num_bins,
     dtype) = _group_layout(groups, bin_mappers, num_features)
    if bins is not None:
        if bins.shape != (n, len(groups)) or bins.dtype != dtype:
            raise ValueError(f"bins {bins.shape} {bins.dtype} for {n} rows "
                             f"of {len(groups)} groups of {dtype.__name__}")
    else:
        Xc = X.tocsc()
        bins = np.zeros((n, len(groups)), dtype=dtype)

        def col_nonzeros(f):
            lo, hi = Xc.indptr[f], Xc.indptr[f + 1]
            return (np.asarray(Xc.indices[lo:hi]),
                    np.asarray(Xc.data[lo:hi], np.float64))

        for gi, g in enumerate(groups):
            if len(g) == 1:
                m = bin_mappers[g[0]]
                default = int(m.transform(np.zeros(1))[0])
                if default:
                    bins[:, gi] = default
                rows, vals = col_nonzeros(g[0])
                bins[rows, gi] = m.transform(vals).astype(dtype)
                continue
            # bundle: implicit zeros are the shared default bin 0; stored
            # non-default entries scatter in feature order
            in_group = 1
            for f in g:
                m = bin_mappers[f]
                rows, vals = col_nonzeros(f)
                b = m.transform(vals).astype(np.int64)
                nondef = b != m.default_bin
                local = np.where(b > m.default_bin, b - 1, b)
                bins[rows[nondef], gi] = (in_group
                                          + local[nondef]).astype(dtype)
                in_group += m.num_bins - 1
    return BinnedData(
        bins=bins,
        group_features=groups,
        group_offsets=group_offsets.astype(np.int32),
        group_bin_counts=np.asarray(group_bin_counts, dtype=np.int32),
        feature_offsets=feature_offsets.astype(np.int32),
        feature_num_bins=feature_num_bins.astype(np.int32),
        bin_mappers=bin_mappers,
        num_data=n,
        num_features=num_features,
    )
