// One growth round of training: route every row through the round's
// splits, then build the (grad, hess) histograms and exact counts of the
// rows' new histogram slots.
//
// Replaces the TPU kernel lightgbm_tpu/pallas/stream_kernel.py
// `route_and_hist` -> `_route_hist_kernel` / `_route_step` (reference
// analog: src/treelearner/cuda/cuda_data_partition.cu +
// cuda_histogram_constructor.cu, which also split routing and histograms
// into separate kernels).
//
// Design (sm_90a):
//   * Routing is one thread per row: the row's leaf selects a 64-byte int32
//     route record (lightgbm_torch/kernels/layout.py ROUTE_FIELDS, four int4
//     loads through the read-only cache), the row's bin is read from the
//     split's group column of the (G, N) uint8 bins, EFB bundles are
//     unbundled, NaN / zero-as-missing bins follow the default direction,
//     categorical splits read a per-leaf bitset.  The TPU gathers the table
//     values with a one-hot bf16 matmul over 7-bit digits; here it is a
//     plain indexed load.  Per-slot counts are integer shared-memory
//     atomics, flushed with one 64-bit global atomic per slot and block.
//   * Histograms are exact fixed point, so the result is the same on every
//     run and equals the plain version
//     (lightgbm_torch/ops/histogram.py::build_histograms) bit for bit: each
//     weight is rounded once to an int64 multiple of 2**-shift
//     (__float2ll_rn of an exact float product), the integers are added
//     with 64-bit shared-memory atomics (integer adds commute), flushed to
//     an int64 global histogram with 64-bit atomics, and converted once to
//     float32 (__ll2float_rn, then the exact 2**-shift).  The caller picks
//     shift so that no sum can overflow.  The TPU kernel instead rounds the
//     weights to bf16 (single) or a bf16 hi+lo pair (mixed) to feed its
//     matrix unit; neither is copied.
//   * Shared memory: a block owns one group, a range of rows and a range
//     of (class, slot) pairs.  One slot of one group is Bmax x 2 int64
//     (1 KB at Bmax 64), so up to kSmemBytes / (Bmax * 16) pairs share a
//     block; more pairs split over gridDim.z.  Blocks of one row range are
//     adjacent in blockIdx.x (the group), so the slot, grad and hess reads
//     of the G blocks of a range mostly hit L2.
//   * Classes (batched multiclass, lightgbm_tpu/ops/grow.py grow_tree_k):
//     K class trees route and accumulate in one launch.  Each row has one
//     leaf id, slot, grad and hess per class, and each class its own
//     fixed-point scale (its own largest weight sets it, so a class's sums
//     are the same as in a launch of its own).  Routing runs one thread per
//     (row, class), the class on gridDim.y.  The histogram pairs are
//     class-major (pair = class * S + slot), so a block's pairs cover a run
//     of classes: it makes one pass over its rows for each of them, the
//     single-class loop with that class's slots, weights and scale, and
//     re-reads a row's bin byte from L1/L2 once per class.  One pass that
//     read it once for all classes was 4 % slower at K = 1 and 3 % faster
//     at K = 10 (PERF.md, PR 5); binary training runs K = 1.  The TPU
//     kernel stacks the classes on the channel axis of one one-hot
//     contraction instead.  K = 1 is the single-class launch.
//   * What bounds it: the bytes a pass must move (bins, leaf ids in and
//     out, grad, hess, counts: ~48 B/row at 28 groups) take ~14 us at
//     1M rows and 3.35 TB/s; the adds are far fewer operations than the
//     card's rate covers.  This first version is held back instead by
//     shared-memory atomic conflicts (all rows of a pass land in few slots,
//     and rows of a warp share bins), by each group's block re-reading the
//     row's slot and weights, and by the global flush.  Its times are in
//     PERF.md; making it fast is later work.
//
//   * The int form (quantized-gradient training; TPU kernel: the
//     `int_weights=True` branch of `_route_hist_kernel`,
//     stream_kernel.py:342-386, which contracts an int8 one-hot on the int8
//     MXU into int32): the same routing kernel, then `hist_int_kernel`,
//     which reads each row's int8 grad and hess grid values (|q| <= 127,
//     hess >= 0) and adds them with 32-bit shared-memory atomics into an
//     int32 tile per (class, slot, group), flushed with 32-bit global
//     atomics into the int32 result.  Integer adds commute, so the sums are
//     exact and the same on every run; the caller's gate (half * N < 2**31)
//     keeps every sum inside int32, so no 64-bit atomic, no fixed-point
//     shift and no conversion pass is needed.  Against the float form a row
//     moves a quarter of the weight bytes, an atomic is half as wide and a
//     block holds twice the pairs.  The grower unscales the int32 sums
//     (ops/grow.py).
//
// Plain PyTorch version of the same contract (K > 1: K single-class calls):
// lightgbm_torch/kernels/route_hist.py::route_and_hist_plain, and for the
// int form route_and_hist_int_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 96 * 1024;   // histogram tile of one block
constexpr int kTargetBlocks = 4 * 132;  // ~4 blocks per SM on an H100

// route record fields (kernels/layout.py ROUTE_FIELDS), as four int4:
//   q0 = (chosen, new_id, group, span_start)
//   q1 = (default_bin, bundled, nan_bin, mz_bin)
//   q2 = (num_bins, threshold, default_left, is_cat)
//   q3 = (slot_left, slot_right, slot_keep, unused)
__global__ void __launch_bounds__(kThreads)
route_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows,
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

// grid: x = group, y = row range, z = range of class-major (class, slot)
// pairs; scales[k] is class k's 2**shift
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows, int G,
            int Bmax, const int32_t* __restrict__ slot,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const float* __restrict__ scales, int64_t rows_per_block,
            int pairs_per_block, int S, int K,
            unsigned long long* __restrict__ hist_acc) {
  extern __shared__ unsigned long long s_hist[];  // pairs x Bmax x 2
  const int g = blockIdx.x;
  const int P = K * S;
  const int p0 = blockIdx.z * pairs_per_block;
  const int p1 = p0 + pairs_per_block < P ? p0 + pairs_per_block : P;
  const int k0 = p0 / S;
  const int k1 = (p1 - 1) / S;
  const int cells = (p1 - p0) * Bmax * 2;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_hist[i] = 0ull;
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;
  const uint8_t* col = bins_T + static_cast<int64_t>(g) * n_rows;
  // one pass over the rows for each class of the block, its slots s0..s1
  for (int k = k0; k <= k1; ++k) {
    const int s0 = p0 - k * S > 0 ? p0 - k * S : 0;
    const int s1 = p1 - k * S < S ? p1 - k * S : S;
    const int64_t off = static_cast<int64_t>(k) * n_rows;
    const int32_t* slot_k = slot + off;
    const float* grad_k = grad + off;
    const float* hess_k = hess + off;
    const float scale = scales[k];
    unsigned long long* tile = s_hist + (k * S + s0 - p0) * Bmax * 2;
    for (int64_t row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
      const int s = slot_k[row];
      if (s < s0 || s >= s1) continue;
      const int b = col[row];
      const long long qg = __float2ll_rn(grad_k[row] * scale);
      const long long qh = __float2ll_rn(hess_k[row] * scale);
      unsigned long long* cell = tile + ((s - s0) * Bmax + b) * 2;
      if (qg != 0) atomicAdd(cell, static_cast<unsigned long long>(qg));
      if (qh != 0) atomicAdd(cell + 1, static_cast<unsigned long long>(qh));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = s_hist[i];
    if (v == 0ull) continue;
    const int c = i & 1;
    const int b = (i >> 1) % Bmax;
    const int p = p0 + (i >> 1) / Bmax;
    atomicAdd(&hist_acc[((static_cast<int64_t>(p) * G + g) * Bmax + b) * 2 +
                        c],
              v);
  }
}

// The int form's histograms: grid as hist_kernel's; qgrad, qhess (K, N)
// int8 grid values; hist (K * S, G, Bmax, 2) int32, zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
hist_int_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows, int G,
                int Bmax, const int32_t* __restrict__ slot,
                const int8_t* __restrict__ qgrad,
                const int8_t* __restrict__ qhess, int64_t rows_per_block,
                int pairs_per_block, int S, int K,
                int* __restrict__ hist) {
  extern __shared__ int s_ihist[];  // pairs x Bmax x 2
  const int g = blockIdx.x;
  const int P = K * S;
  const int p0 = blockIdx.z * pairs_per_block;
  const int p1 = p0 + pairs_per_block < P ? p0 + pairs_per_block : P;
  const int k0 = p0 / S;
  const int k1 = (p1 - 1) / S;
  const int cells = (p1 - p0) * Bmax * 2;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_ihist[i] = 0;
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;
  const uint8_t* col = bins_T + static_cast<int64_t>(g) * n_rows;
  for (int k = k0; k <= k1; ++k) {
    const int s0 = p0 - k * S > 0 ? p0 - k * S : 0;
    const int s1 = p1 - k * S < S ? p1 - k * S : S;
    const int64_t off = static_cast<int64_t>(k) * n_rows;
    const int32_t* slot_k = slot + off;
    const int8_t* qgrad_k = qgrad + off;
    const int8_t* qhess_k = qhess + off;
    int* tile = s_ihist + (k * S + s0 - p0) * Bmax * 2;
    for (int64_t row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
      const int s = slot_k[row];
      if (s < s0 || s >= s1) continue;
      const int qg = qgrad_k[row];
      const int qh = qhess_k[row];
      if ((qg | qh) == 0) continue;
      int* cell = tile + ((s - s0) * Bmax + col[row]) * 2;
      if (qg != 0) atomicAdd(cell, qg);
      if (qh != 0) atomicAdd(cell + 1, qh);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = s_ihist[i];
    if (v == 0) continue;
    const int c = i & 1;
    const int b = (i >> 1) % Bmax;
    const int p = p0 + (i >> 1) / Bmax;
    atomicAdd(&hist[((static_cast<int64_t>(p) * G + g) * Bmax + b) * 2 + c],
              v);
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
cudaError_t launch_route(const uint8_t* bins_T, int64_t n_rows, int K,
                         const int32_t* leaf_id, const int32_t* tabs, int L,
                         const int32_t* cat_words, int W, const float* cnt,
                         int S, int32_t* new_leaf, int32_t* slot,
                         int64_t* cnt_acc, float* cnt_out,
                         cudaStream_t stream) {
  auto* c_acc = reinterpret_cast<unsigned long long*>(cnt_acc);
  cudaError_t err =
      cudaMemsetAsync(c_acc, 0, sizeof(int64_t) * K * S, stream);
  if (err != cudaSuccess) return err;
  const int64_t row_blocks = ceil_div(n_rows, kThreads);
  if (row_blocks > 0) {
    const dim3 route_grid(static_cast<unsigned>(row_blocks),
                          static_cast<unsigned>(K));
    route_kernel<<<route_grid, kThreads, sizeof(unsigned long long) * S,
                   stream>>>(
        bins_T, n_rows, leaf_id, reinterpret_cast<const int4*>(tabs), L,
        reinterpret_cast<const uint32_t*>(cat_words), W, cnt, S, new_leaf,
        slot, c_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 cnt_grid(static_cast<unsigned>(ceil_div(S, kThreads)),
                      static_cast<unsigned>(K));
  to_float_kernel<<<cnt_grid, kThreads, 0, stream>>>(c_acc, S, nullptr,
                                                     cnt_out);
  return cudaGetLastError();
}

// The histogram grid of a round: (group, row range, pair range), about
// kTargetBlocks blocks, pairs_per_block (class, slot) pairs of per_pair
// shared bytes each.  Returns false when one pair does not fit.
bool hist_grid(int64_t n_rows, int G, int P, int per_pair, dim3* grid,
               int64_t* rows_per_block, int* pairs_per_block) {
  int ppb = kSmemBytes / per_pair;
  if (ppb < 1) return false;
  if (ppb > P) ppb = P;
  const int pair_blocks = static_cast<int>(ceil_div(P, ppb));
  const int64_t row_blocks = ceil_div(n_rows, kThreads);
  int64_t row_ranges = kTargetBlocks / (static_cast<int64_t>(G) * pair_blocks);
  if (row_ranges > row_blocks) row_ranges = row_blocks;
  if (row_ranges > 65535) row_ranges = 65535;
  if (row_ranges < 1) row_ranges = 1;
  const int64_t rpb = ceil_div(n_rows, row_ranges);
  if (rpb > 0) row_ranges = ceil_div(n_rows, rpb);
  *grid = dim3(static_cast<unsigned>(G), static_cast<unsigned>(row_ranges),
               static_cast<unsigned>(pair_blocks));
  *rows_per_block = rpb;
  *pairs_per_block = ppb;
  return true;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  Per-class
// arrays are class-major: leaf_id, grad, hess, new_leaf and slot (K, N);
// tabs (K, L, 16); cat_words (K, L, W); scales (2, K) on the device, row 0
// each class's 2**shift and row 1 its 2**-shift.  hist_acc (K*S*G*Bmax*2)
// and cnt_acc (K*S) are int64 scratch this call zeroes; hist (K, S, G,
// Bmax, 2) and cnt_out (K, S) are the results, hist written only when
// with_hist != 0.
extern "C" int lgbt_route_and_hist(
    const uint8_t* bins_T, int64_t n_rows, int G, int K,
    const int32_t* leaf_id, const int32_t* tabs, int L,
    const int32_t* cat_words, int W, const float* grad, const float* hess,
    const float* cnt, int S, int Bmax, int with_hist, const float* scales,
    int32_t* new_leaf, int32_t* slot, int64_t* hist_acc, int64_t* cnt_acc,
    float* hist, float* cnt_out, cudaStream_t stream) {
  cudaError_t err = launch_route(bins_T, n_rows, K, leaf_id, tabs, L,
                                 cat_words, W, cnt, S, new_leaf, slot,
                                 cnt_acc, cnt_out, stream);
  if (err != cudaSuccess || !with_hist) return static_cast<int>(err);

  auto* h_acc = reinterpret_cast<unsigned long long*>(hist_acc);
  const int64_t per_class = static_cast<int64_t>(S) * G * Bmax * 2;
  err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * per_class * K, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_pair = Bmax * 2 * static_cast<int>(sizeof(int64_t));
  dim3 grid;
  int64_t rows_per_block;
  int pairs_per_block;
  if (!hist_grid(n_rows, G, K * S, per_pair, &grid, &rows_per_block,
                 &pairs_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const int smem = pairs_per_block * per_pair;
    err = cudaFuncSetAttribute(hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_kernel<<<grid, kThreads, smem, stream>>>(
        bins_T, n_rows, G, Bmax, slot, grad, hess, scales, rows_per_block,
        pairs_per_block, S, K, h_acc);
    err = cudaGetLastError();
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
// and no int64 histogram scratch.
extern "C" int lgbt_route_and_hist_int(
    const uint8_t* bins_T, int64_t n_rows, int G, int K,
    const int32_t* leaf_id, const int32_t* tabs, int L,
    const int32_t* cat_words, int W, const int8_t* qgrad,
    const int8_t* qhess, const float* cnt, int S, int Bmax, int with_hist,
    int32_t* new_leaf, int32_t* slot, int64_t* cnt_acc, int32_t* hist,
    float* cnt_out, cudaStream_t stream) {
  cudaError_t err = launch_route(bins_T, n_rows, K, leaf_id, tabs, L,
                                 cat_words, W, cnt, S, new_leaf, slot,
                                 cnt_acc, cnt_out, stream);
  if (err != cudaSuccess || !with_hist) return static_cast<int>(err);

  const int64_t cells = static_cast<int64_t>(K) * S * G * Bmax * 2;
  err = cudaMemsetAsync(hist, 0, sizeof(int32_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_pair = Bmax * 2 * static_cast<int>(sizeof(int32_t));
  dim3 grid;
  int64_t rows_per_block;
  int pairs_per_block;
  if (!hist_grid(n_rows, G, K * S, per_pair, &grid, &rows_per_block,
                 &pairs_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows > 0) {
    const int smem = pairs_per_block * per_pair;
    err = cudaFuncSetAttribute(hist_int_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    hist_int_kernel<<<grid, kThreads, smem, stream>>>(
        bins_T, n_rows, G, Bmax, slot, qgrad, qhess, rows_per_block,
        pairs_per_block, S, K, hist);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
