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
// the row pointers (the Allstate-shaped cell's 1M rows: 30M entries, 360
// MB, and ~40 MB of bins, ~0.12 ms at 3.35 TB/s).
//
// Design (simple first; sm_90a):
//   * A block of 256 threads takes a tile of kernels/bin_csr.py::TILE_ROWS
//     rows: its threads first write the tile's cells with the groups' zero
//     bins, coalesced along the output's minor axis ((n, G) or, for K1,
//     (G, n)), then a barrier.
//   * One warp a row: the lanes take the row's stored entries 32 at a time
//     in stored order, one entry a lane, and bin them in parallel.  Lanes
//     whose entries fall in one group find each other with
//     __match_any_sync; the winner among them is the last stored entry of
//     a lone feature, or, in a bundle, the non-default entry of the highest
//     (position, lane).  Only winners write.  Across the row's passes a
//     bundle's winner writes only where the cell does not already hold a
//     bin of a feature further on in the group: the features' bins lie in
//     consecutive ranges in position order, so the cell's value says
//     whose it is (below the end of the winner's range: its own, an
//     earlier feature's or the default 0).
// Nothing is staged in shared memory; the tables are read through L1/L2.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bin_value.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const long long* indptr;  // (n + 1,) this chunk's, from 0
  const int32_t* indices;   // (nnz,) column of each stored entry
  const double* data;       // (nnz,) value of each stored entry
  const int32_t* zero_bins; // (G,) each group's bin of an implicit 0.0
  Tables tab;
  void* out;                // (n_out, G) or (G, n_out) uint8 / uint16
  int64_t n, row0, n_out;
  int F, G, tile_rows, transpose;
};

__device__ __forceinline__ int64_t cell(const Args& a, int64_t row, int g) {
  return a.transpose ? static_cast<int64_t>(g) * a.n_out + row
                     : row * a.G + g;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
bin_csr_kernel(const Args a) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.tile_rows;
  const int64_t left = a.n - r0;
  const int rows = left < a.tile_rows ? static_cast<int>(left) : a.tile_rows;
  T* out = static_cast<T*>(a.out);
  // the tile's cells at their zero bins; cell i = major * minor_n + minor,
  // (g, r) transposed, else (r, g)
  const int minor_n = a.transpose ? rows : a.G;
  const int cells = rows * a.G;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const int major = i / minor_n, minor = i - major * minor_n;
    const int r = a.transpose ? minor : major;
    const int g = a.transpose ? major : minor;
    out[cell(a, a.row0 + r0 + r, g)] = static_cast<T>(__ldg(a.zero_bins + g));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const int64_t row = r0 + r;
    const int64_t s = __ldg(a.indptr + row), e = __ldg(a.indptr + row + 1);
    const int64_t out_row = a.row0 + row;
    for (int64_t j0 = s; j0 < e; j0 += 32) {
      const int64_t j = j0 + lane;
      int ent = -1;
      double v = 0.0;
      if (j < e) {
        const int c = __ldg(a.indices + j);
        v = __ldg(a.data + j);
        if (c >= 0 && c < a.F) ent = __ldg(a.tab.col_entry + c);
      }
      const int32_t* f = a.tab.feats + static_cast<int64_t>(max(ent, 0)) *
                                           kFeatFields;
      int g = -1 - lane, key = -1, val = 0, end = 0;
      bool bundled = false;
      if (ent >= 0) {
        const int b = feature_bin(a.tab, f, v);
        g = f[kGroup];
        bundled = (f[kFlags] & kBundled) != 0;
        if (!bundled) {
          key = lane;   // a lone feature: the last stored entry
          val = b;
        } else {
          const int d = f[kDefaultBin];
          if (b != d) {
            key = f[kPosition] * 32 + lane;
            val = f[kInGroup] + (b > d ? b - 1 : b);
          }
          end = f[kInGroup] + f[kNumBins] - 1;
        }
      }
      // the lanes of this pass whose entries fall in g; the winner holds
      // the largest key among them
      const unsigned same = __match_any_sync(0xffffffffu, g);
      int top = key;
      for (int src = 0; src < 32; ++src) {
        const int k = __shfl_sync(0xffffffffu, key, src);
        if ((same >> src) & 1u) top = max(top, k);
      }
      if (key >= 0 && key == top) {
        T* w = out + cell(a, out_row, g);
        if (!bundled || static_cast<int>(*w) < end) *w = static_cast<T>(val);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  indptr
// (n + 1, from 0), indices and data (indptr[n] entries) are the chunk's CSR
// rows; they go to rows [row0, row0 + n) of out, (n_out, G) or, with
// transpose, (G, n_out), of out_bytes (1: uint8, 2: uint16) a bin; feats
// (entries records), col_entry, bounds (n_bounds), cats and cat_bins
// (n_cats each) are the tables of kernels/bin_rows.py::bin_tables, and
// zero_bins (G) those of kernels/bin_csr.py::zero_bins; tile_rows rows a
// block.
extern "C" int lgbt_bin_csr(
    const int64_t* indptr, const int32_t* indices, const double* data,
    int64_t n, int F, const int32_t* feats, int entries, int G,
    const int32_t* col_entry, const double* bounds, int n_bounds,
    const int64_t* cats, const int32_t* cat_bins, int n_cats,
    const int32_t* zero_bins, void* out, int out_bytes, int64_t n_out,
    int64_t row0, int transpose, int tile_rows, cudaStream_t stream) {
  if (n < 0 || F < 1 || G < 1 || entries < 1 || n_bounds < 1 ||
      n_cats < 1 || row0 < 0 || row0 + n > n_out ||
      (out_bytes != 1 && out_bytes != 2) || tile_rows < 1 ||
      static_cast<int64_t>(tile_rows) * G > INT_MAX ||
      (n + tile_rows - 1) / tile_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a{};
  a.indptr = reinterpret_cast<const long long*>(indptr);
  a.indices = indices;
  a.data = data;
  a.zero_bins = zero_bins;
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
  a.tile_rows = tile_rows;
  a.transpose = transpose;
  const int blocks = static_cast<int>((n + tile_rows - 1) / tile_rows);
  if (out_bytes == 2)
    bin_csr_kernel<uint16_t><<<blocks, kThreads, 0, stream>>>(a);
  else
    bin_csr_kernel<uint8_t><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
