// Slot histograms of rows in their natural order, for one class (K5) or K
// class trees together (K8): (grad, hess, count) sums per (class, slot,
// group, bin).
//
// Replaces the TPU kernels lightgbm_tpu/pallas/scatter_hist_kernel.py
// `_hist_scatter` (pallas_call at :103, single class and K-class forms) and
// lightgbm_tpu/pallas/hist_kernel.py `_hist_wide` (pallas_call at :305),
// which compute the same function (reference analog:
// src/treelearner/cuda/cuda_histogram_constructor.cu, a shared-memory
// scatter-add of each row).  The TPU kernels keep the whole histogram in
// VMEM and contract a bin one-hot on the matrix unit; here rows scatter into
// shared-memory tiles with integer atomics, for any Bmax <= 256, any K * S
// and any G, with nothing falling back.  Groups wider than 256 bins (EFB
// bundles, max_bin > 255) take the 16-bit form: bins read as uint16_t, 4
// rows' in one 8-byte load, and, where one pair's Bmax cells exceed a
// block's shared memory, tiles of a range of bins (csrc/hist_tile.cuh).
//
// The function: cell (k, s, g, b) sums, over the rows n with slot[k, n] ==
// s and bins_T[g, n] == b, grad[k, n] and hess[k, n] rounded once to int64
// multiples of 2**-shift_k (__float2ll_rn of an exact float product) and
// the count weight rounded to an integer.  Integer sums are exact in any
// order, so the result is the same on every run and equals the plain
// version (kernels/hist_wide.py::hist_wide_plain) bit for bit; each cell is
// converted once to float32 (__ll2float_rn, then the exact 2**-shift_k).
//
// What bounds it on an H100: the bytes a launch must move (per row G bin
// bytes and the count, per class the slot and, where the row is in a slot,
// grad and hess; the (K, S, G, Bmax, 3) float32 output) take 5-50 us at 1M
// rows and 3.35 TB/s, and the adds are far fewer operations than the
// card's rate covers.  What held the first ports (one block per group, slot
// or pair range and row range, 64-bit shared atomics) back, and what this
// design does about it (times in PERF.md, from scripts/torch_hist_bench.py):
//
//   * 64-bit shared-memory atomicAdd compiles to a compare-and-swap loop on
//     sm_90a (ATOMS.CAST.SPIN.64 in the SASS; only 32-bit ATOMS.ADD is
//     native).  The tile keeps each int64 sum as two 32-bit words and adds
//     the low word first: the old value it returns tells whether the add
//     carried, and the high word gets its high half plus the carry (native
//     32-bit adds, exact modulo 2**64, so exact for sums that fit in int64,
//     which hist_shift guarantees).  Where every row lands in one slot (the
//     root) the adds bound the kernel, at about one (row, group) add per SM
//     cycle, 2-2.7x faster than the CAS loop was in the same kernel.
//   * A tile too large for one block made each slot or pair block re-read
//     every row (K5 at Bmax 255 read its rows 4 times per group, K8 at
//     K = 10 about 9 times for ~2.5 classes each).  Here a block's tile is
//     the slots of one class (half of them for 64 slots at Bmax 255) and as
//     many groups as fit in 227 KB, so a block reads one class's slots and
//     weights, once for all its groups.  Spreading one tile over a thread
//     block cluster's distributed shared memory instead (each block reading
//     its share of the rows once and adding into the owning rank's tile)
//     measured 1.5-37x slower than re-reading the rows from L2, and was
//     taken out.
//   * Beyond the adds, time goes to each block's pass over its rows, which
//     needs many threads in flight (two 512-thread blocks an SM, each with
//     half the tile, took up to 1.7x longer than one of 1024, the most 64
//     registers a thread allow): rows are read 4 to a thread, as int4 slots,
//     float4 weights and one 32-bit word of 4 bin bytes per group (a scalar
//     edge for a ragged end or unaligned operands), with no division and
//     one compare to place a row, at 64 registers and no spills.  The grid
//     runs (pair tile, group tile, row range) with the row range slowest,
//     so the blocks of one row range share its reads in L2, and the plan
//     picks the row ranges that fill the last wave.
//   * Each block flushes its tile once, with 64-bit global atomics (native
//     REDG.E.ADD.64) into an int64 sum a memset cleared; a small kernel
//     then converts it.
//
// The launch plan (tile shape, row ranges, threads, shared memory) is
// chosen by kernels/hist_wide.py::hist_plan from (N, G, K, S, Bmax) and
// checked here; a bad plan is refused.  The tile pass itself
// (csrc/hist_tile.cuh, channel set GradHessCount) is shared with K2's
// histogram pass.
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"

namespace {

using namespace hist_tile;

constexpr int kCellBytes = 20;    // five 32-bit words per (pair, group, bin)

// channels (grad, hess, count) of n values in K equal runs of per_class:
// grad and hess of run k times inv_scales[k] (or inv0)
__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                int64_t n, int64_t per_class,
                                const float* __restrict__ inv_scales,
                                float inv0, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) {
    const float v = __ll2float_rn(static_cast<long long>(acc[i]));
    const float inv = inv_scales != nullptr
                          ? __ldg(inv_scales + i / per_class) : inv0;
    out[i] = i % 3 == 2 ? v : v * inv;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int hist_rows(const void* bins_T, int bin_bytes, int64_t n, int G, int K,
              const int32_t* slot, const float* grad, const float* hess,
              const float* cnt, int S, int Bmax, const float* scales,
              float scale0, float inv0, const int64_t* plan, int64_t* acc,
              float* hist, cudaStream_t stream) {
  if (n < 0 || G < 1 || K < 1 || S < 1 || Bmax < 1 ||
      !plan_ok(plan, n, G, K, S, Bmax, kCellBytes, bin_bytes) ||
      Bmax > max_group_bins(bin_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* h_acc = reinterpret_cast<unsigned long long*>(acc);
  const int64_t per_class = static_cast<int64_t>(S) * G * Bmax * 3;
  const int64_t cells = per_class * K;
  cudaError_t err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    Args a{};
    a.bins_T = bins_T; a.slot = slot; a.grad = grad; a.hess = hess;
    a.cnt = cnt; a.scales = scales; a.out = h_acc; a.n = n;
    a.G = G; a.K = K; a.S = S; a.Bmax = Bmax;
    a.scale0 = scale0;
    a.vec = bins_aligned(bins_T, n, bin_bytes) && aligned(slot, 16) &&
            aligned(grad, 16) && aligned(hess, 16) && aligned(cnt, 16);
    err = launch_tiles<GradHessCount>(a, bin_bytes, plan, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_float_kernel<<<static_cast<unsigned>(ceil_div(cells, 256)), 256, 0,
                    stream>>>(h_acc, cells, per_class,
                              scales != nullptr ? scales + K : nullptr, inv0,
                              hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interfaces, loaded with ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched;
// cudaErrorInvalidValue for a plan outside its limits).  bins_T is (G,
// n_rows), bin_bytes 1 (uint8) or 2 (16-bit) a bin.  acc is int64 scratch
// of the histogram's size that the call zeroes; hist is the float32
// result; plan is the host array of kernels/hist_wide.py::hist_plan.

// K5: (N,) slots and weights, one shift (scale = 2**shift, inv_scale its
// inverse); hist (S, G, Bmax, 3).
extern "C" int lgbt_scatter_hist(
    const void* bins_T, int bin_bytes, int64_t n_rows, int G,
    const int32_t* slot,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    float scale, float inv_scale, int64_t* acc, float* hist,
    const int64_t* plan, cudaStream_t stream) {
  return hist_rows(bins_T, bin_bytes, n_rows, G, 1, slot, grad, hess, cnt,
                   S, Bmax, nullptr, scale, inv_scale, plan, acc, hist,
                   stream);
}

// K8: (K, N) class-major slots, grads and hesses, (N,) counts; scales (2, K)
// on the device, row 0 each class's 2**shift and row 1 its 2**-shift;
// hist (K, S, G, Bmax, 3).
extern "C" int lgbt_hist_wide(
    const void* bins_T, int bin_bytes, int64_t n_rows, int G, int K,
    const int32_t* slot,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    const float* scales, int64_t* acc, float* hist, const int64_t* plan,
    cudaStream_t stream) {
  return hist_rows(bins_T, bin_bytes, n_rows, G, K, slot, grad, hess, cnt,
                   S, Bmax, scales, 0.0f, 0.0f, plan, acc, hist, stream);
}
