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
//     of slots.  One slot of one group is Bmax x 2 int64 (1 KB at Bmax 64),
//     so up to kSmemBytes / (Bmax * 16) slots share a block; more slots
//     split over gridDim.z.  Blocks of one row range are adjacent in
//     blockIdx.x (the group), so the slot, grad and hess reads of the G
//     blocks of a range mostly hit L2.
//   * What bounds it: the bytes a pass must move (bins, leaf ids in and
//     out, grad, hess, counts: ~48 B/row at 28 groups) take ~14 us at
//     1M rows and 3.35 TB/s; the adds are far fewer operations than the
//     card's rate covers.  This first version is held back instead by
//     shared-memory atomic conflicts (all rows of a pass land in few slots,
//     and rows of a warp share bins), by each group's block re-reading the
//     row's slot and weights, and by the global flush.  Its times are in
//     PERF.md; making it fast is later work.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/route_hist.py::route_and_hist_plain.
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

// grid: x = group, y = row range, z = slot range
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows, int G,
            int Bmax, const int32_t* __restrict__ slot,
            const float* __restrict__ grad, const float* __restrict__ hess,
            float scale, int64_t rows_per_block, int slots_per_block, int S,
            unsigned long long* __restrict__ hist_acc) {
  extern __shared__ unsigned long long s_hist[];  // slots x Bmax x 2
  const int g = blockIdx.x;
  const int s0 = blockIdx.z * slots_per_block;
  const int s1 = s0 + slots_per_block < S ? s0 + slots_per_block : S;
  const int cells = (s1 - s0) * Bmax * 2;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_hist[i] = 0ull;
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;
  const uint8_t* col = bins_T + static_cast<int64_t>(g) * n_rows;
  for (int64_t row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const int s = slot[row];
    if (s < s0 || s >= s1) continue;
    const int b = col[row];
    const long long qg = __float2ll_rn(grad[row] * scale);
    const long long qh = __float2ll_rn(hess[row] * scale);
    unsigned long long* cell = s_hist + ((s - s0) * Bmax + b) * 2;
    if (qg != 0) atomicAdd(cell, static_cast<unsigned long long>(qg));
    if (qh != 0) atomicAdd(cell + 1, static_cast<unsigned long long>(qh));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = s_hist[i];
    if (v == 0ull) continue;
    const int c = i & 1;
    const int b = (i >> 1) % Bmax;
    const int s = s0 + (i >> 1) / Bmax;
    atomicAdd(&hist_acc[((static_cast<int64_t>(s) * G + g) * Bmax + b) * 2 +
                        c],
              v);
  }
}

__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t n, float inv_scale,
                                float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) out[i] = __ll2float_rn(static_cast<long long>(acc[i])) *
                      inv_scale;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).
// hist_acc (S*G*Bmax*2) and cnt_acc (S) are int64 scratch this call zeroes;
// hist and slot are written only when with_hist != 0.
extern "C" int lgbt_route_and_hist(
    const uint8_t* bins_T, int64_t n_rows, int G, const int32_t* leaf_id,
    const int32_t* tabs, int L, const int32_t* cat_words, int W,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    int with_hist, float scale, float inv_scale, int32_t* new_leaf,
    int32_t* slot, int64_t* hist_acc, int64_t* cnt_acc, float* hist,
    float* cnt_out, cudaStream_t stream) {
  auto* h_acc = reinterpret_cast<unsigned long long*>(hist_acc);
  auto* c_acc = reinterpret_cast<unsigned long long*>(cnt_acc);
  cudaError_t err = cudaMemsetAsync(c_acc, 0, sizeof(int64_t) * S, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t row_blocks = ceil_div(n_rows, kThreads);
  route_kernel<<<static_cast<unsigned>(row_blocks), kThreads,
                 sizeof(unsigned long long) * S, stream>>>(
      bins_T, n_rows, leaf_id, reinterpret_cast<const int4*>(tabs), L,
      reinterpret_cast<const uint32_t*>(cat_words), W, cnt, S, new_leaf, slot,
      c_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  to_float_kernel<<<static_cast<unsigned>(ceil_div(S, kThreads)), kThreads, 0,
                    stream>>>(c_acc, S, 1.0f, cnt_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || !with_hist) return static_cast<int>(err);

  const int64_t cells = static_cast<int64_t>(S) * G * Bmax * 2;
  err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_slot = Bmax * 2 * static_cast<int>(sizeof(int64_t));
  int slots_per_block = kSmemBytes / per_slot;
  if (slots_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (slots_per_block > S) slots_per_block = S;
  const int slot_blocks = static_cast<int>(ceil_div(S, slots_per_block));
  int64_t row_ranges = kTargetBlocks / (static_cast<int64_t>(G) * slot_blocks);
  if (row_ranges < 1) row_ranges = 1;
  if (row_ranges > row_blocks) row_ranges = row_blocks;
  if (row_ranges > 65535) row_ranges = 65535;
  const int64_t rows_per_block = ceil_div(n_rows, row_ranges);
  row_ranges = ceil_div(n_rows, rows_per_block);
  const int smem = slots_per_block * per_slot;
  err = cudaFuncSetAttribute(hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(G), static_cast<unsigned>(row_ranges),
                  static_cast<unsigned>(slot_blocks));
  hist_kernel<<<grid, kThreads, smem, stream>>>(
      bins_T, n_rows, G, Bmax, slot, grad, hess, scale, rows_per_block,
      slots_per_block, S, h_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  to_float_kernel<<<static_cast<unsigned>(ceil_div(cells, kThreads)),
                    kThreads, 0, stream>>>(h_acc, cells, inv_scale, hist);
  return static_cast<int>(cudaGetLastError());
}
