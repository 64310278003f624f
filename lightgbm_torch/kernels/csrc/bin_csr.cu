// SciPy CSR rows to group bins: the stored entries of a chunk of CSR rows
// binned by the training bin mappers and assembled into the group layout of
// lightgbm_torch/binning.py::construct_binned_sparse.
//
// Replaces no TPU kernel.  It is the card's counterpart of the JAX
// package's host construct_binned_sparse (lightgbm_tpu/binning.py:988),
// which fills the bins of a SciPy sparse Dataset in O(nnz) in NumPy, as
// csrc/bin_rows.cu is the counterpart of its native dense binner.
//
// Contract (kernels/bin_csr.py::bin_csr_plain is the plain version):
//   * every cell of the chunk's rows starts at its group's zero bin, the bin
//     of an implicit 0.0 (a feature alone in its group: its bin of 0.0,
//     under the predict form's sentinel rule too; a bundle: 0);
//   * a feature alone in its group takes its row's LAST stored entry (a
//     (row, column) stored twice keeps the later value, as NumPy's
//     scatter does on the host);
//   * a bundle takes its row's last non-default entry in the order of the
//     features' positions in the group, then of the stored order: an
//     entry whose bin is its feature's default bin (an explicit 0.0 or
//     -0.0, a NaN without MISSING_NAN) leaves the cell alone.
// A value is binned as BinMapper.transform does (csrc/bin_value.cuh's
// feature_bin, shared with csrc/bin_rows.cu: NumPy's searchsorted "left"
// in float64, NaN rules, the float64 -> int64 cast of categories, the
// sentinel bin of the predict form).
//
// What bounds it on an H100: the bytes, 12 B a stored entry read (int32
// column, float64 value) and 1 or 2 B a (row, group) cell written, plus
// the row pointers (the Allstate-shaped cell's 100 000-row chunk: 2.85M
// entries, 42 MB, 12.5 us at 3.35 TB/s).
//
// Design (sm_90a; the launch plan is kernels/bin_csr.py::bin_csr_plan):
//   * Tiles of consecutive rows cut by entries, not by rows: the chunk's
//     entries split evenly over a whole number of rounds of the persistent
//     blocks, each cut moved to the first row that starts at or after it,
//     a tile no longer than the rows whose keys fit a block's shared
//     memory.  The host cuts them from the row pointers it already holds
//     (the plan's `starts`).  A row is never split: a row longer than a
//     tile's share is one block's work.
//   * Persistent blocks, six an SM, loop over the tiles.  A block stages
//     its tile's row pointers in shared memory as int32 offsets from the
//     tile's first entry; its threads then stride over the tile's entries
//     in flat order, an entry a thread at a time (more in flight spilled
//     registers and measured slower), so the column and value loads are
//     coalesced.  An entry finds its row by a binary search of the
//     offsets.  The next tile's offsets and first entries are loaded
//     before this tile's write-out.
//   * Winners by keys: each (row, group) cell of the tile is one 64-bit
//     word in shared memory (rows an odd number of words apart), 0 for
//     none.  An entry that takes part offers (position in its group + 1,
//     its index in the tile, its bin in the group) by atomicMax: a lone
//     feature's entries all take part (the last stored wins, explicit
//     zeros and duplicates included), a bundle's only where their bin is
//     not their feature's default bin (the last in (position, stored
//     order) wins).  Integer max does not depend on the threads' order,
//     so the bytes are the host's.
//   * After one barrier, each cell is written once, `key ? bin : zero
//     bin`, a cell a thread along the output's minor axis ((n, G), or
//     (G, n), which K1 reads: runs of the tile's rows a group), and its
//     word is set back to 0 for the next tile.  The odd row stride keeps
//     the transposed reads of the words free of bank conflicts.
//   * Wide G (WIDE_ROWS rows over every group pass a block's shared
//     memory): the plan adds a group-range axis; a block takes (row tile,
//     group range) pairs and skips the entries of other groups.
//   * A feature's fields come from a compact per-column record (two int4
//     loads, no col_entry hop; kernels/bin_rows.py::csr_records), whose
//     numeric features of at most two bounds carry their first bound
//     (bin = bound < value: the bounds table is not read for them): the
//     tables an entry reads stay small enough for L1 beside the keys
//     (col_entry and bin_rows' feature records measured slower: PERF.md).
//
// Plain PyTorch version: lightgbm_torch/kernels/bin_csr.py::bin_csr_plain.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bin_value.cuh"

namespace {

constexpr int kThreads = 256;
// blocks an SM the registers must allow (kernels/bin_csr.py::
// BLOCKS_PER_SM: 40 registers a thread)
constexpr int kMinBlocks = 6;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90
// key fields, low to high: bin in the group, entry index in the tile,
// position in the group + 1 (0: no entry)
constexpr int kBinBits = 16;
constexpr int kIndexBits = 25;
constexpr int kPosShift = kBinBits + kIndexBits;

// plan fields, in the order of kernels/bin_csr.py::CSR_PLAN_FIELDS
enum {
  kTiles, kRanges, kRangeGroups, kMaxRows, kBlocks, kPlanThreads, kPlanSmem,
  kPlanFields
};
// compact column record, in the order of kernels/bin_rows.py::
// CSR_RECORD_FIELDS (group -1: the column has no feature)
enum {
  kRecGroup, kRecFlags, kRecPosition, kRecInGroup, kRecNumBins,
  kRecDefaultBin, kRecStart, kRecLen, kRecFields
};
// record flag (kernels/bin_rows.py::CSR_INLINE): a numeric feature of at
// most two bounds, its first bound's float64 bits in (start, len)
constexpr int kInline = 16;

struct Args {
  const long long* indptr;  // (n + 1,) this chunk's, from 0
  const int32_t* indices;   // (nnz,) column of each stored entry
  const double* data;       // (nnz,) value of each stored entry
  const int32_t* zero_bins; // (G,) each group's bin of an implicit 0.0
  const int32_t* starts;    // (tiles + 1,) first row of each tile
  const int4* records;      // (F, 2) compact column records
  Tables tab;
  void* out;                // (n_out, G) or (G, n_out) uint8 / uint16
  int64_t row0, n_out;
  int F, G, tiles, ranges, range_groups, max_rows, transpose;
};

// a (row tile, group range) pair: rows [r0, r0 + rows) over groups
// [g0, g0 + gn), entries from e0
struct Tile {
  int r0, rows, g0, gn;
  long long e0;
};

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// column c's feature as a local record in bin_value.cuh's field order (the
// fields feature_bin and the assembly read), from its compact record;
// false where c has none
__device__ __forceinline__ bool column_feature(const Args& a, int c,
                                               int32_t (&f)[kFeatFields]) {
  const int4 lo = __ldg(a.records + 2 * c);
  const int4 hi = __ldg(a.records + 2 * c + 1);
  const int32_t r[kRecFields] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
  f[kColumn] = c;
  f[kGroup] = r[kRecGroup];
  f[kFlags] = r[kRecFlags];
  f[kPosition] = r[kRecPosition];
  f[kInGroup] = r[kRecInGroup];
  f[kNumBins] = r[kRecNumBins];
  f[kDefaultBin] = r[kRecDefaultBin];
  f[kBoundsStart] = f[kCatsStart] = r[kRecStart];
  f[kBoundsLen] = f[kCatsLen] = r[kRecLen];
  return r[kRecGroup] >= 0;
}

// entry j of the tile (column c, value v) offered to its cell's key
__device__ __forceinline__ void take_entry(const Args& a,
                                           unsigned long long* keys,
                                           const int* offs, int rows, int g0,
                                           int gn, int j, int c, double v) {
  if (c < 0 || c >= a.F) return;
  int32_t f[kFeatFields];
  if (!column_feature(a, c, f)) return;
  const int g = f[kGroup] - g0;
  if (static_cast<unsigned>(g) >= static_cast<unsigned>(gn)) return;
  int b;
  if (f[kFlags] & kInline) {
    // bins 0 and 1 of at most two bounds: the last never decides
    const double first = __hiloint2double(f[kBoundsLen], f[kBoundsStart]);
    b = isnan(v) ? ((f[kFlags] & kMissingNan) ? f[kNumBins] - 1
                                              : (first < 0.0 ? 1 : 0))
                 : (first < v ? 1 : 0);
  } else {
    b = feature_bin(a.tab, f, v);
  }
  unsigned long long pos = 1ull, bin = static_cast<unsigned>(b);
  if (f[kFlags] & kBundled) {
    const int d = f[kDefaultBin];
    if (b == d) return;
    pos = static_cast<unsigned long long>(f[kPosition]) + 1ull;
    bin = static_cast<unsigned>(f[kInGroup] + (b > d ? b - 1 : b));
  }
  const unsigned long long key =
      (pos << kPosShift) |
      (static_cast<unsigned long long>(j) << kBinBits) | bin;
  // the row: the last whose offset is <= j
  const int r = lower_bound(offs, rows + 1, j + 1) - 1;
  atomicMax(keys + r * (gn | 1) + g, key);
}

// the tile's cells written once each along the output's minor axis, a
// cell a thread (neighbouring threads on neighbouring cells: coalesced
// stores, and the keys' odd row stride keeps the transposed reads free of
// bank conflicts), and their keys set back to 0
template <class T>
__device__ __forceinline__ void write_tile(const Args& a, T* out,
                                          unsigned long long* keys,
                                          const Tile& t) {
  const int ks = t.gn | 1;
  const int cells = t.rows * t.gn;
  // cell i = major * minor_n + minor: (g, r) transposed, else (r, g)
  const int minor_n = a.transpose ? t.rows : t.gn;
  const int step_major = kThreads / minor_n;
  const int step_minor = kThreads - step_major * minor_n;
  int major = threadIdx.x / minor_n, minor = threadIdx.x - major * minor_n;
  const int64_t out0 = a.row0 + t.r0;
  for (int i = threadIdx.x; i < cells;
       i += kThreads, major += step_major, minor += step_minor) {
    if (minor >= minor_n) {
      minor -= minor_n;
      ++major;
    }
    const int r = a.transpose ? minor : major;
    const int g = a.transpose ? major : minor;
    const int64_t o = a.transpose
                          ? static_cast<int64_t>(t.g0 + g) * a.n_out + out0 + r
                          : (out0 + r) * a.G + t.g0 + g;
    unsigned long long* w = keys + r * ks + g;
    const unsigned long long key = *w;
    *w = 0ull;
    out[o] = static_cast<T>(key ? static_cast<unsigned>(key & 0xffffu)
                                : static_cast<unsigned>(
                                      __ldg(a.zero_bins + t.g0 + g)));
  }
}

// pair i of the (row tile, group range) pairs
__device__ __forceinline__ Tile tile_of(const Args& a, int i) {
  Tile t;
  const int tile = i / a.ranges, range = i - tile * a.ranges;
  t.r0 = __ldg(a.starts + tile);
  t.rows = __ldg(a.starts + tile + 1) - t.r0;
  t.g0 = range * a.range_groups;
  t.gn = min(a.G - t.g0, a.range_groups);
  t.e0 = __ldg(a.indptr + t.r0);
  return t;
}

// the tile's row offsets staged, and the loads of each thread's first
// entry issued (column -1: none)
__device__ __forceinline__ void start_tile(const Args& a, int* offs,
                                          const Tile& t, int& c, double& v) {
  const int ne = static_cast<int>(__ldg(a.indptr + t.r0 + t.rows) - t.e0);
  const int j = threadIdx.x;
  c = j < ne ? __ldg(a.indices + t.e0 + j) : -1;
  v = j < ne ? __ldg(a.data + t.e0 + j) : 0.0;
  for (int i = threadIdx.x; i <= t.rows; i += kThreads)
    offs[i] = static_cast<int>(__ldg(a.indptr + t.r0 + i) - t.e0);
}

template <class T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bin_csr_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  const int words = a.max_rows * (a.range_groups | 1);
  int* offs = reinterpret_cast<int*>(smem + align16(8 * words));
  for (int i = threadIdx.x; i < words; i += kThreads) keys[i] = 0ull;
  T* out = static_cast<T*>(a.out);
  const int work = a.tiles * a.ranges;
  int p = blockIdx.x, c = -1;
  double v = 0.0;
  Tile t{};
  if (p < work) {
    t = tile_of(a, p);
    start_tile(a, offs, t, c, v);
  }
  __syncthreads();   // the first offsets in place, the keys cleared
  for (; p < work; p += gridDim.x) {
    const int ne = offs[t.rows];
    for (int j = threadIdx.x; j < ne; j += kThreads) {
      if (j != threadIdx.x) {   // the first was loaded with the offsets
        c = __ldg(a.indices + t.e0 + j);
        v = __ldg(a.data + t.e0 + j);
      }
      take_entry(a, keys, offs, t.rows, t.g0, t.gn, j, c, v);
    }
    __syncthreads();   // every key of the tile decided, the offsets free
    // the next tile's offsets and first loads go out before this tile's
    // write-out, which reads neither
    const Tile cur = t;
    if (p + static_cast<int>(gridDim.x) < work) {
      t = tile_of(a, p + gridDim.x);
      start_tile(a, offs, t, c, v);
    }
    write_tile<T>(a, out, keys, cur);
    __syncthreads();   // the keys cleared, the next offsets in place
  }
}

template <class T>
cudaError_t launch(const Args& a, int blocks, int smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bin_csr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bin_csr_kernel<T><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  indptr
// (n + 1, from 0), indices and data (indptr[n] entries) are the chunk's CSR
// rows; they go to rows [row0, row0 + n) of out, (n_out, G) or, with
// transpose, (G, n_out), of out_bytes (1: uint8, 2: uint16) a bin; feats
// (entries records), col_entry, bounds (n_bounds), cats and cat_bins
// (n_cats each) are the tables of kernels/bin_rows.py::bin_tables, records
// (F x 2 int4) their compact column records (kernels/bin_rows.py::
// csr_records: the kernel reads them in place of feats and col_entry,
// which only scripts/torch_shap_bin_bench.py's feature_records ablation
// reads), zero_bins (G) those of kernels/bin_csr.py::zero_bins;
// starts (plan[kTiles] + 1 row starts) and plan (the host array of
// kernels/bin_csr.py::bin_csr_plan) the tiles.  Every tile's entries must
// stay below 2**kIndexBits (the wrapper checks).
extern "C" int lgbt_bin_csr(
    const int64_t* indptr, const int32_t* indices, const double* data,
    int64_t n, int F, const int32_t* feats, int entries, int G,
    const int32_t* col_entry, const double* bounds, int n_bounds,
    const int64_t* cats, const int32_t* cat_bins, int n_cats,
    const int32_t* zero_bins, const int32_t* records, void* out,
    int out_bytes, int64_t n_out, int64_t row0, int transpose,
    const int32_t* starts, const int64_t* plan, cudaStream_t stream) {
  if (n < 0 || n > INT_MAX || F < 1 || G < 1 || entries < 1 ||
      n_bounds < 1 || n_cats < 1 || row0 < 0 || row0 + n > n_out ||
      (out_bytes != 1 && out_bytes != 2) || plan == nullptr ||
      plan[kPlanThreads] != kThreads || plan[kTiles] < (n > 0 ? 1 : 0) ||
      plan[kTiles] > n || plan[kRanges] < 1 || plan[kRangeGroups] < 1 ||
      plan[kRangeGroups] > G ||
      (plan[kRanges] - 1) * plan[kRangeGroups] >= G ||
      plan[kRanges] * plan[kRangeGroups] < G || plan[kMaxRows] < 0 ||
      plan[kMaxRows] > n || plan[kTiles] * plan[kRanges] > INT_MAX ||
      plan[kMaxRows] * (plan[kRangeGroups] | 1) * 8 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem =
      align16(static_cast<int>(8 * plan[kMaxRows] *
                               (plan[kRangeGroups] | 1))) +
      align16(static_cast<int>(4 * (plan[kMaxRows] + 1)));
  if (plan[kPlanSmem] != smem || smem > kMaxSmem ||
      plan[kBlocks] < (n > 0 ? 1 : 0) ||
      plan[kBlocks] > plan[kTiles] * plan[kRanges])
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.indptr = reinterpret_cast<const long long*>(indptr);
  a.indices = indices;
  a.data = data;
  a.zero_bins = zero_bins;
  a.starts = starts;
  a.records = reinterpret_cast<const int4*>(records);
  a.tab.feats = feats;
  a.tab.col_entry = col_entry;
  a.tab.bounds = bounds;
  a.tab.cats = reinterpret_cast<const long long*>(cats);
  a.tab.cat_bins = cat_bins;
  a.out = out;
  a.row0 = row0;
  a.n_out = n_out;
  a.F = F;
  a.G = G;
  a.tiles = static_cast<int>(plan[kTiles]);
  a.ranges = static_cast<int>(plan[kRanges]);
  a.range_groups = static_cast<int>(plan[kRangeGroups]);
  a.max_rows = static_cast<int>(plan[kMaxRows]);
  a.transpose = transpose;
  const int blocks = static_cast<int>(plan[kBlocks]);
  const int bytes = static_cast<int>(smem);
  const cudaError_t err =
      out_bytes == 2 ? launch<uint16_t>(a, blocks, bytes, stream)
                     : launch<uint8_t>(a, blocks, bytes, stream);
  return static_cast<int>(err);
}
