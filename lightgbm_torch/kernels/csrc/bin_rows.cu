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
// What bounds it on an H100: the bytes, 8 B a raw value in and 1 or 2 B a
// group out (1M x 28 rows: 224 MB + 28 MB, ~75 us at 3.35 TB/s); the
// searches are a few compares a value.  The upload of the rows from the
// host (PCIe) costs far more than the kernel.
//
// Design (sm_90a), staged (kernels/bin_rows.py::bin_plan):
//   * Persistent blocks, four an SM, each looping over tiles of rows (a
//     tile is contiguous in x).  The next tile comes into the other half
//     of a double-buffered ring in shared memory by cp.async while the
//     current tile is binned, so loading and binning overlap.
//   * One thread a value at a time: neighbouring threads take
//     neighbouring raw values (features) of the staged tile, and a thread
//     takes two values a pass (v and v + 256) so that two numeric
//     searches run in lockstep.  A value's feature record
//     (found through col_entry) gives its group; a group of one feature
//     stores its bin in a shared (row, group) word, a bundle's non-default
//     feature an atomicMax of (its position in the group << 16 | its bin
//     in the group): integer max does not depend on the threads' order and
//     the last non-default feature has the largest position, so the bytes
//     are the host's.  An unset word stays 0, the bundle's default bin.
//   * The tile's words are then written out coalesced, in (n, G) or, for
//     K1, (G, n), at 1 or 2 bytes, and set back to 0.
//   * The feature records, col_entry, bounds and categories are copied to
//     shared memory once a block where they fit (the plan's table_bytes),
//     else read from global memory; the searches are branchless.
// Unstaged, for rows wider than a block's shared memory: one thread a
// (row, group) pair, the rows read from global memory.
//
// Plain PyTorch version: lightgbm_torch/kernels/bin_rows.py::bin_rows_plain.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bin_value.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

// plan fields, in the order of kernels/bin_rows.py::BIN_PLAN_FIELDS
enum {
  kTileRows, kTiles, kBlocks, kPlanThreads, kStaged, kStageBytes,
  kWordBytes, kTableBytes, kPlanSmem
};

struct Args {
  const double* x;          // (n, F) row-major, this chunk's rows
  const int32_t* group_start;  // (G + 1,) first entry of each group
  Tables tab;               // in global memory
  void* out;                // (n_out, G) or (G, n_out) uint8 / uint16
  int64_t n, row0, n_out;
  int F, G, entries, n_bounds, n_cats;
  int tile_rows, tiles, stage_bytes, word_bytes, table_bytes;
  int transpose;
};

// lower_bound of two (bounds, len, value) triples in lockstep, so that
// the two chains of dependent reads overlap; a range already down to one
// element probes its own base and keeps it
__device__ __forceinline__ void lower_bound2(const double* b0, int n0,
                                             double v0, int& r0,
                                             const double* b1, int n1,
                                             double v1, int& r1) {
  int base0 = 0, base1 = 0;
  while (n0 > 1 || n1 > 1) {
    const int h0 = n0 >> 1, h1 = n1 >> 1;
    const double p0 = b0[base0 + h0], p1 = b1[base1 + h1];
    base0 = h0 > 0 && p0 < v0 ? base0 + h0 : base0;
    base1 = h1 > 0 && p1 < v1 ? base1 + h1 : base1;
    n0 -= h0;
    n1 -= h1;
  }
  r0 = base0 + (b0[base0] < v0 ? 1 : 0);
  r1 = base1 + (b1[base1] < v1 ? 1 : 0);
}

// the bins of two values of numeric features f0 and f1, as feature_bin
__device__ __forceinline__ void numeric_bins2(const Tables& t,
                                              const int32_t* f0, double v0,
                                              int& b0, const int32_t* f1,
                                              double v1, int& b1) {
  const int len0 = f0[kBoundsLen], len1 = f1[kBoundsLen];
  int r0, r1;
  lower_bound2(t.bounds + f0[kBoundsStart], len0, isnan(v0) ? 0.0 : v0, r0,
               t.bounds + f1[kBoundsStart], len1, isnan(v1) ? 0.0 : v1, r1);
  b0 = isnan(v0) && (f0[kFlags] & kMissingNan) ? f0[kNumBins] - 1
                                               : min(r0, len0 - 1);
  b1 = isnan(v1) && (f1[kFlags] & kMissingNan) ? f1[kNumBins] - 1
                                               : min(r1, len1 - 1);
}

// a value's bin into its (row, group) word: stored for a group of one
// feature; for a bundle's non-default bin, the max with (its position <<
// 16 | its bin in the group)
__device__ __forceinline__ void assemble(uint32_t* w, const int32_t* f,
                                         int b) {
  if (!(f[kFlags] & kBundled)) {
    *w = static_cast<uint32_t>(b);
    return;
  }
  const int d = f[kDefaultBin];
  if (b != d)
    atomicMax(w, (static_cast<uint32_t>(f[kPosition]) << 16) |
                     static_cast<uint32_t>(f[kInGroup] + (b > d ? b - 1 : b)));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows of tile `tile`
__device__ __forceinline__ int tile_rows(const Args& a, int tile) {
  const int64_t left = a.n - static_cast<int64_t>(tile) * a.tile_rows;
  return left < a.tile_rows ? static_cast<int>(left) : a.tile_rows;
}

// start copying tile `tile`'s raw values into `dst`
__device__ __forceinline__ void load_tile(const Args& a, double* dst,
                                          int tile) {
  const double* src = a.x + static_cast<int64_t>(tile) * a.tile_rows * a.F;
  const int count = tile_rows(a, tile) * a.F;
  for (int i = threadIdx.x; i < count; i += kThreads)
    cp_async8(dst + i, src + i);
}

// a copy of `count` elements of `src` at `dst`, returned as its new home
template <class V>
__device__ __forceinline__ const V* stage_table(unsigned char*& dst,
                                                const V* src, int count) {
  V* to = reinterpret_cast<V*>(dst);
  for (int i = threadIdx.x; i < count; i += kThreads) to[i] = src[i];
  dst += sizeof(V) * count;
  return to;
}

template <class T>
__global__ void __launch_bounds__(kThreads, 4)
bin_tiles_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + 2 * a.stage_bytes);
  const int stride = a.G | 1;   // an odd word stride: no bank conflicts
  const int values = a.tile_rows * a.F;
  Tables t = a.tab;
  if (a.table_bytes) {
    // doubles and int64 first, so that each table keeps its alignment
    unsigned char* p = smem + 2 * a.stage_bytes + a.word_bytes;
    t.bounds = stage_table(p, a.tab.bounds, a.n_bounds);
    t.cats = stage_table(p, a.tab.cats, a.n_cats);
    t.feats = stage_table(p, a.tab.feats, a.entries * kFeatFields);
    t.col_entry = stage_table(p, a.tab.col_entry, a.F);
    t.cat_bins = stage_table(p, a.tab.cat_bins, a.n_cats);
  }
  for (int i = threadIdx.x; i < a.tile_rows * stride; i += kThreads)
    words[i] = 0u;
  // each pass of the value loop takes values v and v + kThreads
  const int step_r = 2 * kThreads / a.F;
  const int step_c = 2 * kThreads - step_r * a.F;
  int tile = blockIdx.x;
  if (tile < a.tiles) load_tile(a, ring, tile);
  cp_async_commit();
  T* out = static_cast<T*>(a.out);
  for (int it = 0; tile < a.tiles; ++it, tile += gridDim.x) {
    const double* cur = ring + (it & 1) * values;
    const int next = tile + gridDim.x;
    // the other half was binned before the last barrier of the last tile
    if (next < a.tiles) load_tile(a, ring + ((it + 1) & 1) * values, next);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();   // this tile in place; the last tile's words out
    const int rows = tile_rows(a, tile);
    const int count = rows * a.F;
    // value v = r0 F + c0 (and v + kThreads = r1 F + c1), stepped by
    // 2 kThreads = step_r F + step_c
    int r0 = threadIdx.x / a.F, c0 = threadIdx.x - r0 * a.F;
    int r1 = (threadIdx.x + kThreads) / a.F;
    int c1 = threadIdx.x + kThreads - r1 * a.F;
    for (int v = threadIdx.x; v < count; v += 2 * kThreads, r0 += step_r,
             c0 += step_c, r1 += step_r, c1 += step_c) {
      if (c0 >= a.F) {
        c0 -= a.F;
        ++r0;
      }
      if (c1 >= a.F) {
        c1 -= a.F;
        ++r1;
      }
      const bool has1 = v + kThreads < count;
      const double x0 = cur[v];
      const double x1 = has1 ? cur[v + kThreads] : 0.0;
      const int e0 = t.col_entry[c0];
      const int e1 = has1 ? t.col_entry[c1] : -1;
      const int32_t* f0 = t.feats + max(e0, 0) * kFeatFields;
      const int32_t* f1 = t.feats + max(e1, 0) * kFeatFields;
      int b0 = 0, b1 = 0;
      if (e0 >= 0 && e1 >= 0 && !(f0[kFlags] & kCategorical) &&
          !(f1[kFlags] & kCategorical)) {
        numeric_bins2(t, f0, x0, b0, f1, x1, b1);
      } else {
        if (e0 >= 0) b0 = feature_bin(t, f0, x0);
        if (e1 >= 0) b1 = feature_bin(t, f1, x1);
      }
      if (e0 >= 0) assemble(words + r0 * stride + f0[kGroup], f0, b0);
      if (e1 >= 0) assemble(words + r1 * stride + f1[kGroup], f1, b1);
    }
    __syncthreads();   // every word of the tile set
    const int64_t out0 = a.row0 + static_cast<int64_t>(tile) * a.tile_rows;
    const int cells = rows * a.G;
    // cell i = major * minor_n + minor: (g, r) transposed, else (r, g)
    const int minor_n = a.transpose ? rows : a.G;
    const int step_major = kThreads / minor_n;
    const int step_minor = kThreads - step_major * minor_n;
    int major = threadIdx.x / minor_n, minor = threadIdx.x - major * minor_n;
    for (int i = threadIdx.x; i < cells;
         i += kThreads, major += step_major, minor += step_minor) {
      if (minor >= minor_n) {
        minor -= minor_n;
        ++major;
      }
      const int rr = a.transpose ? minor : major;
      const int g = a.transpose ? major : minor;
      const int64_t o = a.transpose ? static_cast<int64_t>(g) * a.n_out +
                                          out0 + rr
                                    : out0 * a.G + i;
      uint32_t* w = words + rr * stride + g;
      out[o] = static_cast<T>(*w & 0xffffu);
      *w = 0u;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
bin_pairs_kernel(const Args a) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.tile_rows;
  const int rows = tile_rows(a, blockIdx.x);
  const double* src = a.x + r0 * a.F;
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
      const int32_t* f = a.tab.feats + static_cast<int64_t>(e) * kFeatFields;
      const int b = feature_bin(a.tab, f, __ldg(row + f[kColumn]));
      if (!(f[kFlags] & kBundled)) {
        bin = b;
      } else {
        const int d = f[kDefaultBin];
        if (b != d) bin = f[kInGroup] + (b > d ? b - 1 : b);
      }
    }
    const int64_t row_out = a.row0 + r0 + r;
    const int64_t i = a.transpose ? static_cast<int64_t>(g) * a.n_out + row_out
                                  : row_out * a.G + g;
    out[i] = static_cast<T>(bin);
  }
}

template <class T>
cudaError_t launch(const Args& a, int staged, int blocks, int smem,
                   cudaStream_t stream) {
  if (!staged) {
    bin_pairs_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      bin_tiles_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bin_tiles_kernel<T><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int64_t align16(int64_t b) { return (b + 15) & ~int64_t{15}; }

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  x is the
// chunk's (n, F) float64 rows; they go to rows [row0, row0 + n) of out,
// (n_out, G) or, with transpose, (G, n_out), of out_bytes (1: uint8, 2:
// uint16) a bin; feats (entries records), group_start, col_entry, bounds
// (n_bounds), cats and cat_bins (n_cats each) are the tables of
// kernels/bin_rows.py::bin_tables; plan is the host array of
// kernels/bin_rows.py::bin_plan.
extern "C" int lgbt_bin_rows(
    const double* x, int64_t n, int F, const int32_t* feats, int entries,
    const int32_t* group_start, int G, const int32_t* col_entry,
    const double* bounds, int n_bounds, const int64_t* cats,
    const int32_t* cat_bins, int n_cats, void* out, int out_bytes,
    int64_t n_out, int64_t row0, int transpose, const int64_t* plan,
    cudaStream_t stream) {
  if (n < 0 || F < 1 || G < 1 || entries < 1 || n_bounds < 1 ||
      n_cats < 1 || row0 < 0 || row0 + n > n_out ||
      (out_bytes != 1 && out_bytes != 2) || plan == nullptr ||
      plan[kPlanThreads] != kThreads || plan[kTileRows] < 1 ||
      plan[kTiles] != (n + plan[kTileRows] - 1) / plan[kTileRows] ||
      plan[kTiles] > INT_MAX || (plan[kStaged] != 0 && plan[kStaged] != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t table_bytes =
      align16(8LL * (n_bounds + n_cats) +
              4LL * (static_cast<int64_t>(entries) * kFeatFields + F +
                     n_cats));
  if (plan[kStaged]) {
    if (plan[kBlocks] < (n > 0 ? 1 : 0) || plan[kBlocks] > plan[kTiles] ||
        plan[kStageBytes] != plan[kTileRows] * F * 8 ||
        plan[kWordBytes] != align16(plan[kTileRows] * (G | 1) * 4) ||
        (plan[kTableBytes] != 0 && plan[kTableBytes] != table_bytes) ||
        plan[kPlanSmem] != 2 * plan[kStageBytes] + plan[kWordBytes] +
                               plan[kTableBytes] ||
        plan[kPlanSmem] > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (plan[kBlocks] != plan[kTiles] || plan[kStageBytes] != 0 ||
             plan[kWordBytes] != 0 || plan[kTableBytes] != 0 ||
             plan[kPlanSmem] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Args a{};
  a.x = x;
  a.group_start = group_start;
  a.tab.feats = feats;
  a.tab.col_entry = col_entry;
  a.tab.bounds = bounds;
  a.tab.cats = reinterpret_cast<const long long*>(cats);
  a.tab.cat_bins = cat_bins;
  a.out = out;
  a.n = n;
  a.row0 = row0;
  a.n_out = n_out;
  a.F = F;
  a.G = G;
  a.entries = entries;
  a.n_bounds = n_bounds;
  a.n_cats = n_cats;
  a.tile_rows = static_cast<int>(plan[kTileRows]);
  a.tiles = static_cast<int>(plan[kTiles]);
  a.stage_bytes = static_cast<int>(plan[kStageBytes]);
  a.word_bytes = static_cast<int>(plan[kWordBytes]);
  a.table_bytes = static_cast<int>(plan[kTableBytes]);
  a.transpose = transpose;
  const int staged = static_cast<int>(plan[kStaged]);
  const int blocks = static_cast<int>(plan[kBlocks]);
  const int smem = static_cast<int>(plan[kPlanSmem]);
  const cudaError_t err =
      out_bytes == 2 ? launch<uint16_t>(a, staged, blocks, smem, stream)
                     : launch<uint8_t>(a, staged, blocks, smem, stream);
  return static_cast<int>(err);
}
