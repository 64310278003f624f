// Slot histograms of rows in their natural order: (grad, hess, count) sums
// per (slot, group, bin).
//
// Replaces the TPU kernel lightgbm_tpu/pallas/scatter_hist_kernel.py
// `_hist_scatter` -> `_scatter_kernel`, single-class form (reference
// analog: src/treelearner/cuda/cuda_histogram_constructor.cu, which
// scatter-adds each row into a shared-memory histogram tile).
//
// Design (sm_90a):
//   * The TPU kernel accumulates every row block into one VMEM-resident
//     (S*G, B*Cp) float32 tile with a vectorized segment-add, and is gated
//     to Bmax <= 128 and G <= 64 by VMEM, with a one-hot fallback.  Here a
//     block owns one group, a range of rows and a range of slots, and adds
//     each of its rows into a shared-memory tile with integer atomics; any
//     Bmax <= 256 and any G run, and nothing falls back.
//   * Sums are exact: grad and hess are rounded once to int64 multiples of
//     2**-shift (__float2ll_rn of an exact float product) and added with
//     64-bit shared-memory atomics, count weights (the 0/1 in-bag mask) are
//     rounded to integers and added with 32-bit ones; each tile is flushed
//     with 64-bit global atomics into an int64 (S, G, Bmax, 3) sum and
//     converted once to float32 (__ll2float_rn, then the exact 2**-shift
//     for grad and hess).  So the result is the same on every run and
//     equals the plain version bit for bit.
//   * Shared memory: one slot of one group is Bmax x 20 bytes (two int64
//     and one int32 per bin: 1.25 KB at Bmax 64, 5 KB at 256), so up to
//     kSmemBytes / (Bmax * 20) slots share a block; more slots split over
//     gridDim.z, and each slot range re-reads its rows.  Blocks of one row
//     range are adjacent in blockIdx.x (the group), so the slot and weight
//     reads of the G blocks of a range mostly hit L2.
//   * What bounds it: the bytes a pass must move (G bin bytes, the slot and
//     three weights: ~44 B/row at 28 groups) take ~13 us at 1M rows and
//     3.35 TB/s; G adds per channel and row are far fewer operations than
//     the card's rate covers.  This first version is held back instead by
//     shared-memory atomic conflicts (rows of a warp share slots and bins),
//     by each group's block re-reading the row's slot and weights, and by
//     the global flush.  Its times are in PERF.md; making it fast is later
//     work.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/scatter_hist.py::scatter_hist_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 96 * 1024;   // histogram tile of one block
constexpr int kTargetBlocks = 4 * 132;  // ~4 blocks per SM on an H100
constexpr int kCellBytes = 20;          // int64 grad, int64 hess, int32 count

// grid: x = group, y = row range, z = slot range
__global__ void __launch_bounds__(kThreads)
scatter_hist_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows, int G,
                    int Bmax, const int32_t* __restrict__ slot,
                    const float* __restrict__ grad,
                    const float* __restrict__ hess,
                    const float* __restrict__ cnt, float scale,
                    int64_t rows_per_block, int slots_per_block, int S,
                    unsigned long long* __restrict__ acc) {
  // shared tile: slots x Bmax x (grad, hess) int64, then slots x Bmax
  // int32 counts
  extern __shared__ unsigned long long s_gh[];
  const int g = blockIdx.x;
  const int s0 = blockIdx.z * slots_per_block;
  const int s1 = s0 + slots_per_block < S ? s0 + slots_per_block : S;
  const int cells = (s1 - s0) * Bmax;
  int* s_cnt = reinterpret_cast<int*>(s_gh + 2 * cells);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    s_gh[2 * i] = 0ull;
    s_gh[2 * i + 1] = 0ull;
    s_cnt[i] = 0;
  }
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;
  const uint8_t* col = bins_T + static_cast<int64_t>(g) * n_rows;
  for (int64_t row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const int s = slot[row];
    if (s < s0 || s >= s1) continue;
    const int cell = (s - s0) * Bmax + col[row];
    const long long qg = __float2ll_rn(grad[row] * scale);
    const long long qh = __float2ll_rn(hess[row] * scale);
    const int c = __float2int_rn(cnt[row]);
    if (qg != 0) atomicAdd(&s_gh[2 * cell], static_cast<unsigned long long>(qg));
    if (qh != 0)
      atomicAdd(&s_gh[2 * cell + 1], static_cast<unsigned long long>(qh));
    if (c != 0) atomicAdd(&s_cnt[cell], c);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i % Bmax;
    const int s = s0 + i / Bmax;
    unsigned long long* out =
        acc + ((static_cast<int64_t>(s) * G + g) * Bmax + b) * 3;
    if (s_gh[2 * i] != 0ull) atomicAdd(out, s_gh[2 * i]);
    if (s_gh[2 * i + 1] != 0ull) atomicAdd(out + 1, s_gh[2 * i + 1]);
    if (s_cnt[i] != 0)
      atomicAdd(out + 2, static_cast<unsigned long long>(
                             static_cast<long long>(s_cnt[i])));
  }
}

// channels (grad, hess, count): grad and hess scaled by 2**-shift
__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t n, float inv_scale,
                                float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) {
    const float v = __ll2float_rn(static_cast<long long>(acc[i]));
    out[i] = i % 3 == 2 ? v : v * inv_scale;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  acc is
// (S*G*Bmax*3) int64 scratch this call zeroes; hist is the (S, G, Bmax, 3)
// float32 result.
extern "C" int lgbt_scatter_hist(
    const uint8_t* bins_T, int64_t n_rows, int G, const int32_t* slot,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    float scale, float inv_scale, int64_t* acc, float* hist,
    cudaStream_t stream) {
  auto* h_acc = reinterpret_cast<unsigned long long*>(acc);
  const int64_t cells = static_cast<int64_t>(S) * G * Bmax * 3;
  cudaError_t err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_slot = Bmax * kCellBytes;
  int slots_per_block = kSmemBytes / per_slot;
  if (slots_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (slots_per_block > S) slots_per_block = S;
  const int slot_blocks = static_cast<int>(ceil_div(S, slots_per_block));
  if (n_rows > 0) {
    const int64_t row_blocks = ceil_div(n_rows, kThreads);
    int64_t row_ranges =
        kTargetBlocks / (static_cast<int64_t>(G) * slot_blocks);
    if (row_ranges < 1) row_ranges = 1;
    if (row_ranges > row_blocks) row_ranges = row_blocks;
    if (row_ranges > 65535) row_ranges = 65535;
    const int64_t rows_per_block = ceil_div(n_rows, row_ranges);
    row_ranges = ceil_div(n_rows, rows_per_block);
    const int smem = slots_per_block * per_slot;
    err = cudaFuncSetAttribute(scatter_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(G),
                    static_cast<unsigned>(row_ranges),
                    static_cast<unsigned>(slot_blocks));
    scatter_hist_kernel<<<grid, kThreads, smem, stream>>>(
        bins_T, n_rows, G, Bmax, slot, grad, hess, cnt, scale,
        rows_per_block, slots_per_block, S, h_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_float_kernel<<<static_cast<unsigned>(ceil_div(cells, kThreads)),
                    kThreads, 0, stream>>>(h_acc, cells, inv_scale, hist);
  return static_cast<int>(cudaGetLastError());
}
