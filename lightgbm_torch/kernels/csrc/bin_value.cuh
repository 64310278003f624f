// Binning one raw value by a feature record of
// kernels/bin_rows.py::bin_tables, as BinMapper.transform does on the host:
// the record fields and flags, the tables, and feature_bin, shared by
// csrc/bin_rows.cu (dense rows) and csrc/bin_csr.cu (CSR rows).
#pragma once
#include <climits>
#include <cstdint>

namespace {

// feature record fields, in the order of kernels/bin_rows.py::FEAT_FIELDS
enum {
  kColumn, kFlags, kNumBins, kDefaultBin, kBoundsStart, kBoundsLen,
  kCatsStart, kCatsLen, kInGroup, kGroup, kPosition, kFeatFields
};
// flags
constexpr int kCategorical = 1;
constexpr int kMissingNan = 2;
constexpr int kSentinel = 4;
constexpr int kBundled = 8;

struct Tables {
  const int32_t* feats;     // (entries, kFeatFields) in group order
  const int32_t* col_entry; // (F,) each column's entry, -1 for none
  const double* bounds;     // every numeric feature's upper bounds
  const long long* cats;    // every categorical feature's sorted categories
  const int32_t* cat_bins;  // the bin of each sorted category
};

// NumPy's float64 -> int64 cast on x86-64 (cvttsd2si): truncation, and
// INT64_MIN where the value is out of range or infinite
__device__ __forceinline__ long long numpy_int64(double v) {
  if (!(v >= -9223372036854775808.0 && v < 9223372036854775808.0))
    return LLONG_MIN;
  return __double2ll_rz(v);
}

// the first index in [0, len] whose element is >= v (len >= 1), without a
// branch on the data: halve the range, keep the upper half where its
// first element is still below v
template <class V>
__device__ __forceinline__ int lower_bound(const V* b, int len, V v) {
  int base = 0;
  for (int n = len; n > 1;) {
    const int half = n >> 1;
    base = b[base + half] < v ? base + half : base;
    n -= half;
  }
  return base + (b[base] < v ? 1 : 0);
}

// index of iv among the sorted categories [0, len), or -1
__device__ __forceinline__ int find_cat(const long long* c, int len,
                                        long long iv) {
  if (len == 0) return -1;
  const int k = lower_bound(c, len, iv);
  return k < len && c[k] == iv ? k : -1;
}

__device__ __forceinline__ int feature_bin(const Tables& t, const int32_t* f,
                                           double v) {
  const int flags = f[kFlags];
  if (flags & kCategorical) {
    const long long* c = t.cats + f[kCatsStart];
    const int len = f[kCatsLen];
    const int k = find_cat(c, len, isnan(v) ? -1LL : numpy_int64(v));
    int bin = k >= 0 ? t.cat_bins[f[kCatsStart] + k] : 0;
    if (flags & kSentinel) {
      const double cl = isnan(v) ? -1.0 : fmin(fmax(v, -1.0),
                                               4611686018427387904.0);
      const long long ic = __double2ll_rz(cl);
      if (!(ic >= 0 && find_cat(c, len, ic) >= 0)) bin = f[kNumBins];
    }
    return bin;
  }
  if (isnan(v)) {
    if (flags & kMissingNan) return f[kNumBins] - 1;
    v = 0.0;
  }
  const int len = f[kBoundsLen];
  return min(lower_bound(t.bounds + f[kBoundsStart], len, v), len - 1);
}

}  // namespace
