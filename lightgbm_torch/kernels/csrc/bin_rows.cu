// Raw rows to group bins: every (row, group) of a float64 (n, F) matrix
// binned by the training bin mappers and assembled into the group layout
// of lightgbm_torch/binning.py::construct_binned.
//
// Replaces no TPU kernel.  It is the card's counterpart of the JAX
// package's native host binner, lightgbm_tpu/native/binner.cpp
// `lgbt_value_to_bin` (called from lightgbm_tpu/binning.py), which bins
// on the host because the TPU program there reads bins the host has
// packed.  The port's consumers of bins (K1 to K8) all read them on the
// card, and the raw rows have to reach the card anyway, so the rows are
// uploaded once and binned here.
//
// Per value, as BinMapper.transform on the host (bit for bit):
//   * numeric: NaN to num_bins - 1 under MISSING_NAN, else binned as 0.0;
//     then the first index whose upper bound is >= v (NumPy's searchsorted
//     "left"), in float64, clipped to the last bound;
//   * categorical: NaN to -1, then NumPy's float64 -> int64 cast as on
//     x86-64 (truncation; |v| >= 2**63 and +-inf give INT64_MIN), then the
//     bin of that category (binary search of the sorted categories), bin 0
//     for none;
//   * the predict form (flag kSentinel, Booster.predict's categorical
//     features that trees split on): a value that is NaN, negative or not
//     a category, after clipping to [-1, 2**62], goes to the sentinel bin
//     num_bins, whose bitset bit K1 never finds set.
// A group of one feature takes that feature's bin; an EFB bundle starts at
// its shared default bin 0 and each feature, in the group's order, whose
// bin is not its default bin writes in_group + (its bin less one past the
// default): the last such feature wins, as on the host.
//
// Design (sm_90a): a block stages a tile of its rows' raw values in shared
// memory with coalesced 8-byte loads (rows of a chunk are contiguous), then
// its threads take (row, group) pairs, rows fastest for the transposed
// (G, n) output that K1 reads and groups fastest for the (n, G) rows that
// training keeps, so that neighbouring threads write neighbouring bytes.
// Where a row is wider than a block's shared memory the threads read the
// row from global memory instead.  The feature records, bounds and
// categories are read through the read-only cache (a few KB to a few
// hundred KB; every block reads the same ones).
//
// What bounds it on an H100: the bytes, 8 B a raw value in and 1 or 2 B a
// group out (1M x 28 rows: 224 MB + 28 MB, ~75 us at 3.35 TB/s); the binary
// searches are ~6 compares a value.  The upload of the rows from the host
// (PCIe) costs far more than the kernel.
//
// Plain PyTorch version: lightgbm_torch/kernels/bin_rows.py::bin_rows_plain.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

// feature record fields, in the order of kernels/bin_rows.py::FEAT_FIELDS
enum {
  kColumn, kFlags, kNumBins, kDefaultBin, kBoundsStart, kBoundsLen,
  kCatsStart, kCatsLen, kInGroup, kFeatFields
};
// flags
constexpr int kCategorical = 1;
constexpr int kMissingNan = 2;
constexpr int kSentinel = 4;
constexpr int kBundled = 8;

// plan fields, in the order of kernels/bin_rows.py::BIN_PLAN_FIELDS
enum { kRowsPerBlock, kBlocks, kPlanThreads, kStaged, kPlanSmem };

struct Args {
  const double* x;          // (n, F) row-major, this chunk's rows
  const int32_t* feats;     // (entries, kFeatFields) in group order
  const int32_t* group_start;  // (G + 1,) first entry of each group
  const double* bounds;     // every numeric feature's upper bounds
  const long long* cats;    // every categorical feature's sorted categories
  const int32_t* cat_bins;  // the bin of each sorted category
  void* out;                // (n_out, G) or (G, n_out) uint8 / uint16
  int64_t n, row0, n_out;
  int F, G;
  int rows_per_block, staged;
  int transpose;
};

// NumPy's float64 -> int64 cast on x86-64 (cvttsd2si): truncation, and
// INT64_MIN where the value is out of range or infinite
__device__ __forceinline__ long long numpy_int64(double v) {
  if (!(v >= -9223372036854775808.0 && v < 9223372036854775808.0))
    return LLONG_MIN;
  return __double2ll_rz(v);
}

// index of iv among the sorted categories [0, len), or -1
__device__ __forceinline__ int find_cat(const long long* c, int len,
                                        long long iv) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(c + mid) < iv) lo = mid + 1; else hi = mid;
  }
  return lo < len && __ldg(c + lo) == iv ? lo : -1;
}

__device__ int feature_bin(const Args& a, const int32_t* f, double v) {
  const int flags = __ldg(f + kFlags);
  if (flags & kCategorical) {
    const long long* c = a.cats + __ldg(f + kCatsStart);
    const int len = __ldg(f + kCatsLen);
    const int k = find_cat(c, len, isnan(v) ? -1LL : numpy_int64(v));
    int bin = k >= 0 ? __ldg(a.cat_bins + __ldg(f + kCatsStart) + k) : 0;
    if (flags & kSentinel) {
      const double cl = isnan(v) ? -1.0 : fmin(fmax(v, -1.0),
                                               4611686018427387904.0);
      const long long ic = __double2ll_rz(cl);
      if (!(ic >= 0 && find_cat(c, len, ic) >= 0))
        bin = __ldg(f + kNumBins);
    }
    return bin;
  }
  if (isnan(v)) {
    if (flags & kMissingNan) return __ldg(f + kNumBins) - 1;
    v = 0.0;
  }
  const double* b = a.bounds + __ldg(f + kBoundsStart);
  const int len = __ldg(f + kBoundsLen);
  int lo = 0, hi = len;  // the first bound >= v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(b + mid) < v) lo = mid + 1; else hi = mid;
  }
  return min(lo, len - 1);
}

template <class T>
__global__ void __launch_bounds__(kThreads) bin_rows_kernel(const Args a) {
  extern __shared__ __align__(16) double tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.rows_per_block;
  const int64_t left = a.n - r0;
  if (left <= 0) return;
  const int rows = left < a.rows_per_block ? static_cast<int>(left)
                                           : a.rows_per_block;
  const double* src = a.x + r0 * a.F;
  if (a.staged) {
    const int total = rows * a.F;
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      tile[i] = __ldg(src + i);
    __syncthreads();
    src = tile;
  }
  T* out = static_cast<T*>(a.out);
  const int pairs = rows * a.G;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int r = a.transpose ? p % rows : p / a.G;
    const int g = a.transpose ? p / rows : p % a.G;
    const double* row = src + static_cast<int64_t>(r) * a.F;
    const int e0 = __ldg(a.group_start + g);
    const int e1 = __ldg(a.group_start + g + 1);
    int bin = 0;
    for (int e = e0; e < e1; ++e) {
      const int32_t* f = a.feats + static_cast<int64_t>(e) * kFeatFields;
      const int b = feature_bin(a, f, row[__ldg(f + kColumn)]);
      if (!(__ldg(f + kFlags) & kBundled)) {
        bin = b;
      } else {
        const int d = __ldg(f + kDefaultBin);
        if (b != d) bin = __ldg(f + kInGroup) + (b > d ? b - 1 : b);
      }
    }
    const int64_t row_out = a.row0 + r0 + r;
    const int64_t i = a.transpose ? static_cast<int64_t>(g) * a.n_out + row_out
                                  : row_out * a.G + g;
    out[i] = static_cast<T>(bin);
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  x is the
// chunk's (n, F) float64 rows; they go to rows [row0, row0 + n) of out,
// (n_out, G) or, with transpose, (G, n_out), of out_bytes (1: uint8, 2:
// uint16) a bin; feats, group_start, bounds, cats and cat_bins are the
// tables of kernels/bin_rows.py::bin_tables; plan is the host array of
// kernels/bin_rows.py::bin_plan.
extern "C" int lgbt_bin_rows(
    const double* x, int64_t n, int F, const int32_t* feats,
    const int32_t* group_start, int G, const double* bounds,
    const int64_t* cats, const int32_t* cat_bins, void* out, int out_bytes,
    int64_t n_out, int64_t row0, int transpose, const int64_t* plan,
    cudaStream_t stream) {
  if (n < 0 || F < 1 || G < 1 || row0 < 0 || row0 + n > n_out ||
      (out_bytes != 1 && out_bytes != 2) || plan == nullptr ||
      plan[kPlanThreads] != kThreads || plan[kRowsPerBlock] < 1 ||
      plan[kBlocks] < 0 || plan[kBlocks] > INT_MAX ||
      plan[kBlocks] * plan[kRowsPerBlock] < n ||
      (plan[kStaged] != 0 && plan[kStaged] != 1) ||
      plan[kPlanSmem] != (plan[kStaged] ? plan[kRowsPerBlock] * F * 8 : 0) ||
      plan[kPlanSmem] > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.x = x;
  a.feats = feats;
  a.group_start = group_start;
  a.bounds = bounds;
  a.cats = reinterpret_cast<const long long*>(cats);
  a.cat_bins = cat_bins;
  a.out = out;
  a.n = n;
  a.row0 = row0;
  a.n_out = n_out;
  a.F = F;
  a.G = G;
  a.rows_per_block = static_cast<int>(plan[kRowsPerBlock]);
  a.staged = static_cast<int>(plan[kStaged]);
  a.transpose = transpose;
  const int smem = static_cast<int>(plan[kPlanSmem]);
  const dim3 grid(static_cast<unsigned>(plan[kBlocks]));
  cudaError_t err;
  if (out_bytes == 2) {
    err = cudaFuncSetAttribute(bin_rows_kernel<uint16_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bin_rows_kernel<uint16_t><<<grid, kThreads, smem, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(bin_rows_kernel<uint8_t>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bin_rows_kernel<uint8_t><<<grid, kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
