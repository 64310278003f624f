// One growth round of training: route every row through the round's
// splits, then build the (grad, hess) histograms and exact counts of the
// rows' new histogram slots, for K class trees at once (K = 1: one tree).
//
// Replaces the TPU kernel lightgbm_tpu/pallas/stream_kernel.py
// `route_and_hist` -> `_route_hist_kernel` / `_route_step` (its num_class = K
// branches :174-205, :263-279, :349-396; reference analog:
// src/treelearner/cuda/cuda_data_partition.cu + cuda_histogram_constructor.cu,
// which also split routing and histograms into separate kernels).  The TPU
// kernel gathers the route tables with a one-hot bf16 matmul over 7-bit
// digits and contracts a bin one-hot on its matrix unit, bf16 weights (or a
// bf16 hi+lo pair) into float32; neither is copied.
//
// The function.  Routing: each (row, class) reads its leaf's 64-byte int32
// route record (lightgbm_torch/kernels/layout.py ROUTE_FIELDS), the bin of
// the split's group in the (G, N) bins (uint8, or 16-bit where a group is
// wider than 256 bins), unbundles an EFB bin, sends a
// NaN / zero-as-missing bin the default way and reads a categorical split's
// bitset; it writes the row's new leaf and histogram slot, and adds the
// row's count weight to its slot's exact count.  Histograms: cell (k, s, g,
// b) sums, over the rows n with slot[k, n] == s and bins_T[g, n] == b,
// grad[k, n] and hess[k, n] rounded once to int64 multiples of 2**-shift_k
// (__float2ll_rn of an exact float product), converted once to float32
// (__ll2float_rn, then the exact 2**-shift_k).  Integer sums are exact in
// any order, so the result is the same on every run and equals the plain
// version bit for bit.  The caller picks each class's shift (from its own
// largest weight, so a class's sums are those of a launch of its own) so
// that no sum can overflow.
//
// The int form (quantized-gradient training; TPU kernel: the
// `int_weights=True` branch of `_route_hist_kernel`, stream_kernel.py
// :342-386, which contracts an int8 one-hot on the int8 MXU into int32):
// the same routing, then (K, N) int8 grad and hess grid values (|q| <= 127,
// hess >= 0) summed exactly as int32; the caller's gate (half * N < 2**31)
// keeps every sum inside int32, so no fixed-point shift, no int64 scratch
// and no conversion pass.  The grower unscales the int32 sums (ops/grow.py).
//
// Design (sm_90a):
//   * Routing is one thread per (row, class), the class on gridDim.y: four
//     int4 record loads through the read-only cache, one bin (a byte, or
//     two for 16-bit bins), the bitset word for a categorical split.  Per-slot counts are shared-memory
//     atomics, flushed with one 64-bit global atomic per slot and block, and
//     converted by a small kernel.
//   * The histogram pass is csrc/hist_tile.cuh, the tile pass K5 and K8 run
//     (csrc/hist_rows.cu), over the slots routing wrote.  A block's
//     shared-memory tile holds one class's S slots (an even share of them
//     where one group's S slots do not fit) x as many groups as fit in 227
//     KB x Bmax bins, so it reads one class's slots and weights once for all
//     its groups; 1024 threads read 4 rows each at a time (int4 slots,
//     float4 grad and hess or one 32-bit word each of int8 grid values, one
//     32-bit word of 4 bin bytes per group, or one 8-byte word of 4 16-bit
//     bins, with tiles of a range of bins where one slot's cells would not
//     fit in shared memory; a scalar edge for a ragged end
//     and for unaligned operands, as in a compacted launch whose N is not a
//     multiple of 4); a row is placed with no division and one compare.
//     Float form: each int64 sum is two 32-bit words added with native
//     ATOMS.ADD, the low word first, the carry read from the old value it
//     returns (16 bytes a cell); the tile is flushed with native 64-bit
//     global adds into int64 scratch, then converted per class.  Int form:
//     two int32 words (8 bytes a cell), flushed with 32-bit global adds
//     straight into the int32 result.  kernels/hist_wide.py::hist_plan picks
//     the tile and the row ranges from the shapes and the cell size; the
//     plan is checked here and a bad one refused.
//   * Why: a tile of one group makes each of G blocks re-read a class's
//     slots and weights for a single group, and a 64-bit shared atomicAdd
//     compiles to a compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN.64);
//     with both, K = 10 launches lost to one index_add_ of the same
//     histogram (PERF.md).
//   * What bounds it: the bytes a pass must move (bins, leaf ids in and out,
//     grad and hess per class, counts, the histograms) take ~14 us at 1M
//     rows and 3.35 TB/s (~40 us at K = 10); the adds are far fewer
//     operations than the card's rate covers.  What holds it above that is
//     each group tile's pass over its class's rows and, at the root, where
//     every row lands in one slot, the shared-memory adds and the route
//     kernel's 64-bit count add (still a compare-and-swap loop; PERF.md).
//
// Plain PyTorch version of the same contract (K > 1: K single-class calls):
// lightgbm_torch/kernels/route_hist.py::route_and_hist_plain, and for the
// int form route_and_hist_int_plain.
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"

namespace {

constexpr int kThreads = 256;          // routing and conversion blocks
constexpr int kCellBytes = 16;         // float form: four 32-bit words a cell
constexpr int kIntCellBytes = 8;       // int form: two int32 words a cell

// route record fields (kernels/layout.py ROUTE_FIELDS), as four int4:
//   q0 = (chosen, new_id, group, span_start)
//   q1 = (default_bin, bundled, nan_bin, mz_bin)
//   q2 = (num_bins, threshold, default_left, is_cat)
//   q3 = (slot_left, slot_right, slot_keep, unused)
template <class T>
__global__ void __launch_bounds__(kThreads)
route_kernel(const T* __restrict__ bins_T, int64_t n_rows,
             const int32_t* __restrict__ leaf_id,
             const int4* __restrict__ tabs, int L,
             const uint32_t* __restrict__ cat_words, int W,
             const float* __restrict__ cnt, int S,
             int32_t* __restrict__ new_leaf, int32_t* __restrict__ slot_out,
             unsigned long long* __restrict__ cnt_acc) {
  extern __shared__ unsigned long long s_cnt[];  // S counters
  for (int s = threadIdx.x; s < S; s += blockDim.x) s_cnt[s] = 0ull;
  __syncthreads();
  // this block's class: its leaf ids, records, bitsets, outputs, counts
  const int k = blockIdx.y;
  leaf_id += static_cast<int64_t>(k) * n_rows;
  new_leaf += static_cast<int64_t>(k) * n_rows;
  slot_out += static_cast<int64_t>(k) * n_rows;
  tabs += static_cast<int64_t>(k) * L * 4;
  cat_words += static_cast<int64_t>(k) * L * W;
  cnt_acc += static_cast<int64_t>(k) * S;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row < n_rows) {
    const int lid = leaf_id[row];
    int out_lid = lid;
    int slot = -1;
    if (lid >= 0 && lid < L) {
      const int4* rec = tabs + static_cast<int64_t>(lid) * 4;
      const int4 q0 = __ldg(rec);
      const int4 q3 = __ldg(rec + 3);
      if (q0.x) {
        const int4 q1 = __ldg(rec + 1);
        const int4 q2 = __ldg(rec + 2);
        const int gb = bins_T[static_cast<int64_t>(q0.z) * n_rows + row];
        // (a 16-bit bin reads as 0 .. 65535)
        int fb = gb;
        if (q1.y) {
          // EFB bundle: the span holds the feature's non-default bins
          const int ls = gb - q0.w;
          fb = (ls >= 0 && ls < q2.x - 1) ? ls + (ls >= q1.x ? 1 : 0) : q1.x;
        }
        bool go_left;
        if (q2.w) {
          const uint32_t w = __ldg(cat_words +
                                   static_cast<int64_t>(lid) * W + (fb >> 5));
          go_left = (w >> (fb & 31)) & 1u;
        } else {
          const bool missing = fb == q1.z || fb == q1.w;
          go_left = missing ? (q2.z != 0) : (fb <= q2.y);
        }
        if (!go_left) out_lid = q0.y;
        slot = go_left ? q3.x : q3.y;
      } else {
        slot = q3.z;
      }
    }
    new_leaf[row] = out_lid;
    slot_out[row] = slot;
    if (slot >= 0 && slot < S) {
      const long long c = __float2ll_rn(cnt[row]);
      if (c != 0) atomicAdd(&s_cnt[slot], static_cast<unsigned long long>(c));
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    if (s_cnt[s] != 0ull) atomicAdd(&cnt_acc[s], s_cnt[s]);
  }
}

// grid: x = range of values, y = class; class k's per_class values times
// inv_scales[k] (null: times 1, the counts)
__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t per_class,
                                const float* __restrict__ inv_scales,
                                float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= per_class) return;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * per_class + i;
  const float v = __ll2float_rn(static_cast<long long>(acc[j]));
  out[j] = inv_scales == nullptr ? v : v * inv_scales[blockIdx.y];
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Zero the counts, route every (row, class) and convert the counts to
// float32: the part of a round both forms share.
cudaError_t launch_route(const void* bins_T, int bin_bytes, int64_t n_rows,
                         int K, const int32_t* leaf_id, const int32_t* tabs,
                         int L, const int32_t* cat_words, int W,
                         const float* cnt, int S, int32_t* new_leaf,
                         int32_t* slot, int64_t* cnt_acc, float* cnt_out,
                         cudaStream_t stream) {
  auto* c_acc = reinterpret_cast<unsigned long long*>(cnt_acc);
  cudaError_t err =
      cudaMemsetAsync(c_acc, 0, sizeof(int64_t) * K * S, stream);
  if (err != cudaSuccess) return err;
  const int64_t row_blocks = ceil_div(n_rows, kThreads);
  if (row_blocks > 0) {
    const dim3 route_grid(static_cast<unsigned>(row_blocks),
                          static_cast<unsigned>(K));
    const size_t smem = sizeof(unsigned long long) * S;
    const auto* t4 = reinterpret_cast<const int4*>(tabs);
    const auto* words = reinterpret_cast<const uint32_t*>(cat_words);
    if (bin_bytes == 2)
      route_kernel<<<route_grid, kThreads, smem, stream>>>(
          static_cast<const uint16_t*>(bins_T), n_rows, leaf_id, t4, L,
          words, W, cnt, S, new_leaf, slot, c_acc);
    else
      route_kernel<<<route_grid, kThreads, smem, stream>>>(
          static_cast<const uint8_t*>(bins_T), n_rows, leaf_id, t4, L,
          words, W, cnt, S, new_leaf, slot, c_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 cnt_grid(static_cast<unsigned>(ceil_div(S, kThreads)),
                      static_cast<unsigned>(K));
  to_float_kernel<<<cnt_grid, kThreads, 0, stream>>>(c_acc, S, nullptr,
                                                     cnt_out);
  return cudaGetLastError();
}

// The histogram operands' limits and the plan; false: refuse the launch.
bool hist_ok(int64_t n_rows, int G, int K, int S, int Bmax, int bin_bytes,
             const int64_t* plan, int cell_bytes) {
  return n_rows >= 0 && G >= 1 && K >= 1 && S >= 1 && Bmax >= 1 &&
         hist_tile::plan_ok(plan, n_rows, G, K, S, Bmax, cell_bytes,
                            bin_bytes) &&
         Bmax <= hist_tile::max_group_bins(bin_bytes);
}

hist_tile::Args tile_args(const void* bins_T, int bin_bytes, int64_t n_rows,
                          int G, int K, int S, int Bmax, const int32_t* slot,
                          const void* grad, const void* hess,
                          const float* scales, void* out, int vec) {
  hist_tile::Args a{};
  a.bins_T = bins_T; a.slot = slot; a.grad = grad; a.hess = hess;
  a.scales = scales; a.out = out; a.n = n_rows;
  a.G = G; a.K = K; a.S = S; a.Bmax = Bmax;
  a.vec = hist_tile::bins_aligned(bins_T, n_rows, bin_bytes) &&
          hist_tile::aligned(slot, 16) && vec;
  return a;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched;
// cudaErrorInvalidValue for a histogram plan outside its limits, before
// anything is launched).  bins_T is (G, N), bin_bytes 1 (uint8) or 2
// (16-bit) a bin.  Per-class arrays are class-major: leaf_id, grad,
// hess, new_leaf and slot (K, N); tabs (K, L, 16); cat_words (K, L, W);
// scales (2, K) on the device, row 0 each class's 2**shift and row 1 its
// 2**-shift.  hist_acc (K*S*G*Bmax*2) and cnt_acc (K*S) are int64 scratch
// this call zeroes; hist (K, S, G, Bmax, 2) and cnt_out (K, S) are the
// results, hist written only when with_hist != 0.  plan is the host array
// of kernels/hist_wide.py::hist_plan for 16-byte cells (read only when
// with_hist != 0).
extern "C" int lgbt_route_and_hist(
    const void* bins_T, int bin_bytes, int64_t n_rows, int G, int K,
    const int32_t* leaf_id, const int32_t* tabs, int L,
    const int32_t* cat_words, int W, const float* grad, const float* hess,
    const float* cnt, int S, int Bmax, int with_hist, const float* scales,
    int32_t* new_leaf, int32_t* slot, int64_t* hist_acc, int64_t* cnt_acc,
    float* hist, float* cnt_out, const int64_t* plan, cudaStream_t stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) ||
      (with_hist &&
       !hist_ok(n_rows, G, K, S, Bmax, bin_bytes, plan, kCellBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_route(bins_T, bin_bytes, n_rows, K, leaf_id, tabs,
                                 L, cat_words, W, cnt, S, new_leaf, slot,
                                 cnt_acc, cnt_out, stream);
  if (err != cudaSuccess || !with_hist) return static_cast<int>(err);

  auto* h_acc = reinterpret_cast<unsigned long long*>(hist_acc);
  const int64_t per_class = static_cast<int64_t>(S) * G * Bmax * 2;
  err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * per_class * K, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    err = hist_tile::launch_tiles<hist_tile::GradHess>(
        tile_args(bins_T, bin_bytes, n_rows, G, K, S, Bmax, slot, grad, hess,
                  scales, h_acc, hist_tile::aligned(grad, 16) &&
                  hist_tile::aligned(hess, 16)),
        bin_bytes, plan, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 conv_grid(static_cast<unsigned>(ceil_div(per_class, kThreads)),
                       static_cast<unsigned>(K));
  to_float_kernel<<<conv_grid, kThreads, 0, stream>>>(h_acc, per_class,
                                                      scales + K, hist);
  return static_cast<int>(cudaGetLastError());
}

// The int form, the same interface but for the weights: qgrad, qhess (K, N)
// int8 grid values (null when with_hist == 0, which reads none), and hist
// (K, S, G, Bmax, 2) int32, written only when with_hist != 0; no scales
// and no int64 histogram scratch; plan for 8-byte cells.
extern "C" int lgbt_route_and_hist_int(
    const void* bins_T, int bin_bytes, int64_t n_rows, int G, int K,
    const int32_t* leaf_id, const int32_t* tabs, int L,
    const int32_t* cat_words, int W, const int8_t* qgrad,
    const int8_t* qhess, const float* cnt, int S, int Bmax, int with_hist,
    int32_t* new_leaf, int32_t* slot, int64_t* cnt_acc, int32_t* hist,
    float* cnt_out, const int64_t* plan, cudaStream_t stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) ||
      (with_hist &&
       !hist_ok(n_rows, G, K, S, Bmax, bin_bytes, plan, kIntCellBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_route(bins_T, bin_bytes, n_rows, K, leaf_id, tabs,
                                 L, cat_words, W, cnt, S, new_leaf, slot,
                                 cnt_acc, cnt_out, stream);
  if (err != cudaSuccess || !with_hist) return static_cast<int>(err);

  const int64_t cells = static_cast<int64_t>(K) * S * G * Bmax * 2;
  err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * cells, stream);
  if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
  return static_cast<int>(hist_tile::launch_tiles<hist_tile::GradHessInt>(
      tile_args(bins_T, bin_bytes, n_rows, G, K, S, Bmax, slot, qgrad, qhess,
                nullptr, hist, hist_tile::aligned(qgrad, 4) &&
                hist_tile::aligned(qhess, 4)),
      bin_bytes, plan, stream));
}
