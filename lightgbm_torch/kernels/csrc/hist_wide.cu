// K-class slot histograms of rows in their natural order (batched
// multiclass): (grad, hess, count) sums per (class, slot, group, bin), each
// row in a different slot of each class tree.
//
// Replaces the TPU kernel lightgbm_tpu/pallas/hist_kernel.py `_hist_wide`
// -> `_wide_kernel`, and the K-class form of
// lightgbm_tpu/pallas/scatter_hist_kernel.py `_hist_scatter`, which
// computes the same function (reference analog:
// src/treelearner/cuda/cuda_histogram_constructor.cu, one histogram pass
// over all class gradients).
//
// Design (sm_90a):
//   * The TPU kernel builds the class-independent bin one-hot of a row
//     block once and contracts it on the matrix unit against a stacked
//     (3 * S * K, T) class x slot weight operand, the whole (G * B, 3SK)
//     histogram resident in VMEM; it is gated to Bmax <= 128 and a 12 MB
//     block (`wide_hist_fits`, `wide_block_rows`), with a per-class
//     fallback.  Here a block owns one group, a range of rows and a range of
//     class-major (class, slot) pairs (pair = class * S + slot), whose tiles
//     sit in shared memory; it reads a row's bin byte once and adds the
//     row's weights of each class of its range whose slot falls in the
//     block, with integer atomics.  Further pairs split over gridDim.z.  Any
//     Bmax <= 256 and any K * S run, and nothing falls back.
//   * Sums are exact: each class's grad and hess are rounded once to int64
//     multiples of 2**-shift_k (__float2ll_rn of an exact float product;
//     each class has its own shift, from its own largest weight, so its
//     sums are those of a single-class pass) and added with 64-bit
//     shared-memory atomics; count weights (the 0/1 in-bag mask, shared by
//     the classes) are rounded to integers and added with 32-bit ones.
//     Each tile is flushed with 64-bit global atomics into an int64
//     (K, S, G, Bmax, 3) sum and converted once to float32 (__ll2float_rn,
//     then the exact 2**-shift_k for grad and hess).  So the result is the
//     same on every run and equals the plain version bit for bit.
//   * Shared memory: one pair of one group is Bmax x 20 bytes (two int64
//     and one int32 per bin: 1.25 KB at Bmax 64), so up to
//     kSmemBytes / (Bmax * 20) pairs share a block.  Blocks of one row
//     range are adjacent in blockIdx.x (the group), so the slot and weight
//     reads of the G blocks of a range mostly hit L2.
//   * What bounds it: the bytes a pass must move (G bin bytes, K slots,
//     K grads and K hesses, one count: ~152 B/row at 28 groups and K = 10)
//     take ~45 us at 1M rows and 3.35 TB/s, plus the (K, S, G, Bmax, 3)
//     output; the adds (3G per row and class in a slot) are far fewer
//     operations than the card's rate covers.  This first version is held
//     back instead by shared-memory atomic conflicts, by each pair range
//     and group re-reading the rows, and by the global flush.  Its times
//     are in PERF.md; making it fast is later work.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/hist_wide.py::hist_wide_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 96 * 1024;   // histogram tile of one block
constexpr int kTargetBlocks = 4 * 132;  // ~4 blocks per SM on an H100
constexpr int kCellBytes = 20;          // int64 grad, int64 hess, int32 count

// grid: x = group, y = row range, z = range of class-major (class, slot)
// pairs; scales[k] is class k's 2**shift
__global__ void __launch_bounds__(kThreads)
hist_wide_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows, int G,
                 int Bmax, const int32_t* __restrict__ slot,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 const float* __restrict__ cnt,
                 const float* __restrict__ scales, int64_t rows_per_block,
                 int pairs_per_block, int S, int K,
                 unsigned long long* __restrict__ acc) {
  // shared tile: pairs x Bmax x (grad, hess) int64, then pairs x Bmax
  // int32 counts
  extern __shared__ unsigned long long s_gh[];
  const int g = blockIdx.x;
  const int P = K * S;
  const int p0 = blockIdx.z * pairs_per_block;
  const int p1 = p0 + pairs_per_block < P ? p0 + pairs_per_block : P;
  const int k0 = p0 / S;
  const int k1 = (p1 - 1) / S;
  const int cells = (p1 - p0) * Bmax;
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
    int b = -1;                      // the bin byte, read at most once
    int c = 0;                       // the count weight, likewise
    for (int k = k0; k <= k1; ++k) {
      const int64_t kr = static_cast<int64_t>(k) * n_rows + row;
      const int s = slot[kr];
      const int p = k * S + s;
      if (s < 0 || s >= S || p < p0 || p >= p1) continue;
      if (b < 0) {
        b = col[row];
        c = __float2int_rn(cnt[row]);
      }
      const float scale = __ldg(scales + k);
      const long long qg = __float2ll_rn(grad[kr] * scale);
      const long long qh = __float2ll_rn(hess[kr] * scale);
      const int cell = (p - p0) * Bmax + b;
      if (qg != 0)
        atomicAdd(&s_gh[2 * cell], static_cast<unsigned long long>(qg));
      if (qh != 0)
        atomicAdd(&s_gh[2 * cell + 1], static_cast<unsigned long long>(qh));
      if (c != 0) atomicAdd(&s_cnt[cell], c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i % Bmax;
    const int p = p0 + i / Bmax;
    unsigned long long* out =
        acc + ((static_cast<int64_t>(p) * G + g) * Bmax + b) * 3;
    if (s_gh[2 * i] != 0ull) atomicAdd(out, s_gh[2 * i]);
    if (s_gh[2 * i + 1] != 0ull) atomicAdd(out + 1, s_gh[2 * i + 1]);
    if (s_cnt[i] != 0)
      atomicAdd(out + 2, static_cast<unsigned long long>(
                             static_cast<long long>(s_cnt[i])));
  }
}

// channels (grad, hess, count) of n values in K equal runs of per_class:
// grad and hess of run k times inv_scales[k]
__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t n, int64_t per_class,
                                const float* __restrict__ inv_scales,
                                float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) {
    const float v = __ll2float_rn(static_cast<long long>(acc[i]));
    out[i] = i % 3 == 2 ? v : v * __ldg(inv_scales + i / per_class);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  slot, grad
// and hess are (K, N) class-major, cnt (N,); scales (2, K) on the device,
// row 0 each class's 2**shift and row 1 its 2**-shift.  acc is
// (K*S*G*Bmax*3) int64 scratch this call zeroes; hist is the
// (K, S, G, Bmax, 3) float32 result.
extern "C" int lgbt_hist_wide(
    const uint8_t* bins_T, int64_t n_rows, int G, int K, const int32_t* slot,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    const float* scales, int64_t* acc, float* hist, cudaStream_t stream) {
  auto* h_acc = reinterpret_cast<unsigned long long*>(acc);
  const int64_t per_class = static_cast<int64_t>(S) * G * Bmax * 3;
  const int64_t cells = per_class * K;
  cudaError_t err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = K * S;
  const int per_pair = Bmax * kCellBytes;
  int pairs_per_block = kSmemBytes / per_pair;
  if (pairs_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (pairs_per_block > P) pairs_per_block = P;
  const int pair_blocks = static_cast<int>(ceil_div(P, pairs_per_block));
  if (n_rows > 0) {
    const int64_t row_blocks = ceil_div(n_rows, kThreads);
    int64_t row_ranges =
        kTargetBlocks / (static_cast<int64_t>(G) * pair_blocks);
    if (row_ranges < 1) row_ranges = 1;
    if (row_ranges > row_blocks) row_ranges = row_blocks;
    if (row_ranges > 65535) row_ranges = 65535;
    const int64_t rows_per_block = ceil_div(n_rows, row_ranges);
    row_ranges = ceil_div(n_rows, rows_per_block);
    const int smem = pairs_per_block * per_pair;
    err = cudaFuncSetAttribute(hist_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(G),
                    static_cast<unsigned>(row_ranges),
                    static_cast<unsigned>(pair_blocks));
    hist_wide_kernel<<<grid, kThreads, smem, stream>>>(
        bins_T, n_rows, G, Bmax, slot, grad, hess, cnt, scales,
        rows_per_block, pairs_per_block, S, K, h_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_float_kernel<<<static_cast<unsigned>(ceil_div(cells, kThreads)),
                    kThreads, 0, stream>>>(h_acc, cells, per_class,
                                           scales + K, hist);
  return static_cast<int>(cudaGetLastError());
}
