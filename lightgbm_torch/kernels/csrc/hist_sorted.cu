// Slot histograms over slot-sorted row blocks: (grad, hess, count) sums per
// (slot, group, bin), each block of the plan belonging to one slot.
//
// Replaces the TPU kernels lightgbm_tpu/pallas/hist_kernel.py
// `_hist_direct` -> `_direct_kernel` (Bmax <= 128) and `_hist_nibble` ->
// `_nibble_kernel` (Bmax > 128), which read the block plan of
// lightgbm_tpu/ops/compact.py `plan_blocks` (reference analog:
// src/treelearner/cuda/cuda_histogram_constructor.cu over the leaf-ordered
// rows of cuda_data_partition.cu).
//
// Design (sm_90a):
//   * The TPU kernels build a (G*B, T) bf16 one-hot of each block (direct)
//     or two 16-bin digit one-hots (nibble), contract them with the weights
//     split into bf16 hi and lo parts on the matrix unit, and read bins
//     packed four to an int32; all of that exists because the TPU has no
//     fast scatter.  None of it is copied.  As in the reference CUDA
//     learner, the rows of one slot are contiguous, so a block's histogram
//     tile needs no slot axis: (G_chunk, Bmax) cells of two int64 and one
//     int32 (20 bytes) in shared memory, filled with integer atomics.
//   * One thread block walks a contiguous range of plan blocks.  Plan
//     blocks of one slot are adjacent, so the tile is flushed (64-bit
//     global atomics of its non-zero cells into an int64 (S, G, Bmax, 3)
//     sum) only when the slot changes and at the end of the range, as the
//     TPU kernel writes its accumulator back at a slot's last block.  A
//     position whose gather index is the pad row n adds nothing, so the
//     plan's pad blocks (first = last = 0) add nothing; slots with no rows
//     stay zero.
//   * Each row's bins are read from the row-major (N, G) matrix, its G
//     group bytes contiguous, through the plan's gather index; groups that
//     do not fit one tile (G * Bmax * 20 > kSmemBytes) split over gridDim.y.
//   * Sums are exact fixed point as in scatter_hist.cu, so the result is the
//     same on every run and equals the plain version bit for bit.
//   * Two instantiations of one template: `direct` for Bmax <= 128 (K6, 256
//     threads, several blocks per SM) and `nibble` for 128 < Bmax <= 256
//     (K7, 512 threads: at 28 groups and Bmax 256 the tile is 143 KB of the
//     227 KB a block may use, so one block fills an SM).
//   * What bounds it: the bytes a pass must move (the 4-byte gather index,
//     the row's G bin bytes and its three weights: ~44 B/row at 28 groups
//     beside the slot sort) take ~13 us at 1M rows and 3.35 TB/s.  This
//     first version is held back by shared-memory atomic conflicts (rows of
//     a block share their slot, and rows of a warp often share bins), by
//     gathered rows that are scattered in memory, and by the flushes.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/hist_sorted.py::hist_sorted_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSmemBytes = 200 * 1024;  // histogram tile of one block
constexpr int kTargetBlocks = 2 * 132;  // ~2 blocks per SM on an H100
constexpr int kCellBytes = 20;          // int64 grad, int64 hess, int32 count

// Adds the tile's non-zero cells into slot `s` of the global sum and
// zeroes them.  Called by every thread of the block between barriers.
__device__ void flush_tile(unsigned long long* s_gh, int* s_cnt, int cells,
                           int s, int g0, int G, int Bmax,
                           unsigned long long* __restrict__ acc) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i % Bmax;
    const int g = g0 + i / Bmax;
    unsigned long long* out =
        acc + ((static_cast<int64_t>(s) * G + g) * Bmax + b) * 3;
    const unsigned long long vg = s_gh[2 * i];
    const unsigned long long vh = s_gh[2 * i + 1];
    const int c = s_cnt[i];
    if (vg != 0ull) atomicAdd(out, vg);
    if (vh != 0ull) atomicAdd(out + 1, vh);
    if (c != 0)
      atomicAdd(out + 2,
                static_cast<unsigned long long>(static_cast<long long>(c)));
    s_gh[2 * i] = 0ull;
    s_gh[2 * i + 1] = 0ull;
    s_cnt[i] = 0;
  }
}

// grid: x = range of plan blocks, y = group chunk
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
sorted_hist_kernel(const uint8_t* __restrict__ bins, int64_t n_rows, int G,
                   int Bmax, const int32_t* __restrict__ gather_idx,
                   const int32_t* __restrict__ scalars, int NB, int T,
                   const float* __restrict__ grad,
                   const float* __restrict__ hess,
                   const float* __restrict__ cnt, float scale,
                   int blocks_per_range, int groups_per_chunk, int S,
                   unsigned long long* __restrict__ acc) {
  // shared tile: Gc x Bmax x (grad, hess) int64, then Gc x Bmax int32
  // counts
  extern __shared__ unsigned long long s_gh[];
  const int g0 = blockIdx.y * groups_per_chunk;
  const int g1 = g0 + groups_per_chunk < G ? g0 + groups_per_chunk : G;
  const int gc = g1 - g0;
  const int cells = gc * Bmax;
  int* s_cnt = reinterpret_cast<int*>(s_gh + 2 * cells);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    s_gh[2 * i] = 0ull;
    s_gh[2 * i + 1] = 0ull;
    s_cnt[i] = 0;
  }
  const int b0 = blockIdx.x * blocks_per_range;
  const int b1 = b0 + blocks_per_range < NB ? b0 + blocks_per_range : NB;
  int cur = -1;  // the slot whose rows the tile holds
  for (int blk = b0; blk < b1; ++blk) {
    const int s = scalars[3 * blk];
    if (s < 0 || s >= S) continue;
    if (s != cur) {
      __syncthreads();
      if (cur >= 0) flush_tile(s_gh, s_cnt, cells, cur, g0, G, Bmax, acc);
      __syncthreads();
      cur = s;
    }
    const int32_t* idx = gather_idx + static_cast<int64_t>(blk) * T;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int64_t row = idx[t];
      if (row < 0 || row >= n_rows) continue;   // the pad row
      const long long qg = __float2ll_rn(grad[row] * scale);
      const long long qh = __float2ll_rn(hess[row] * scale);
      const int c = __float2int_rn(cnt[row]);
      const uint8_t* rb = bins + row * G + g0;
      for (int g = 0; g < gc; ++g) {
        const int cell = g * Bmax + rb[g];
        if (qg != 0)
          atomicAdd(&s_gh[2 * cell], static_cast<unsigned long long>(qg));
        if (qh != 0)
          atomicAdd(&s_gh[2 * cell + 1], static_cast<unsigned long long>(qh));
        if (c != 0) atomicAdd(&s_cnt[cell], c);
      }
    }
  }
  __syncthreads();
  if (cur >= 0) flush_tile(s_gh, s_cnt, cells, cur, g0, G, Bmax, acc);
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

template <int kThreads>
int launch(const uint8_t* bins, int64_t n_rows, int G,
           const int32_t* gather_idx, const int32_t* scalars, int NB, int T,
           const float* grad, const float* hess, const float* cnt, int S,
           int Bmax, float scale, float inv_scale, int64_t* acc, float* hist,
           cudaStream_t stream) {
  auto* h_acc = reinterpret_cast<unsigned long long*>(acc);
  const int64_t cells = static_cast<int64_t>(S) * G * Bmax * 3;
  cudaError_t err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_group = Bmax * kCellBytes;
  int groups_per_chunk = kSmemBytes / per_group;
  if (groups_per_chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = static_cast<int>(ceil_div(G, groups_per_chunk));
  groups_per_chunk = static_cast<int>(ceil_div(G, chunks));  // balanced
  if (NB > 0) {
    int64_t ranges = kTargetBlocks / chunks;
    if (ranges < 1) ranges = 1;
    if (ranges > NB) ranges = NB;
    const int blocks_per_range = static_cast<int>(ceil_div(NB, ranges));
    ranges = ceil_div(NB, blocks_per_range);
    const int smem = groups_per_chunk * per_group;
    err = cudaFuncSetAttribute(sorted_hist_kernel<kThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(ranges),
                    static_cast<unsigned>(chunks));
    sorted_hist_kernel<kThreads><<<grid, kThreads, smem, stream>>>(
        bins, n_rows, G, Bmax, gather_idx, scalars, NB, T, grad, hess, cnt,
        scale, blocks_per_range, groups_per_chunk, S, h_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_float_kernel<<<static_cast<unsigned>(ceil_div(cells, 256)), 256, 0,
                    stream>>>(h_acc, cells, inv_scale, hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interfaces, loaded with ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  bins is
// the row-major (n_rows, G) uint8 matrix; gather_idx (NB*T) and scalars
// (NB, 3) are the block plan; acc is (S*G*Bmax*3) int64 scratch this call
// zeroes; hist is the (S, G, Bmax, 3) float32 result.
extern "C" int lgbt_hist_direct(
    const uint8_t* bins, int64_t n_rows, int G, const int32_t* gather_idx,
    const int32_t* scalars, int NB, int T, const float* grad,
    const float* hess, const float* cnt, int S, int Bmax, float scale,
    float inv_scale, int64_t* acc, float* hist, cudaStream_t stream) {
  if (Bmax > 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<256>(bins, n_rows, G, gather_idx, scalars, NB, T, grad, hess,
                     cnt, S, Bmax, scale, inv_scale, acc, hist, stream);
}

extern "C" int lgbt_hist_nibble(
    const uint8_t* bins, int64_t n_rows, int G, const int32_t* gather_idx,
    const int32_t* scalars, int NB, int T, const float* grad,
    const float* hess, const float* cnt, int S, int Bmax, float scale,
    float inv_scale, int64_t* acc, float* hist, cudaStream_t stream) {
  if (Bmax <= 128 || Bmax > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<512>(bins, n_rows, G, gather_idx, scalars, NB, T, grad, hess,
                     cnt, S, Bmax, scale, inv_scale, acc, hist, stream);
}
