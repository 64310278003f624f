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
// and any G, with nothing falling back.
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
// checked here; a bad plan is refused.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90
constexpr int kCellBytes = 20;    // five 32-bit words per (pair, group, bin)

// plan fields, in the order of kernels/hist_wide.py::PLAN_FIELDS
enum {
  kPairsPerTile, kGroupsPerTile, kPairTiles, kGroupTiles, kRowRanges,
  kRowsPerRange, kThreads, kSmem
};

struct Args {
  const uint8_t* bins_T;   // (G, N)
  const int32_t* slot;     // (K, N)
  const float* grad;       // (K, N)
  const float* hess;       // (K, N)
  const float* cnt;        // (N,)
  const float* scales;     // (2, K) device table, or null: scale0
  unsigned long long* acc;  // (K * S * G * Bmax * 3) int64 sums
  int64_t n;
  int64_t rows_per_range;
  int G, K, S, Bmax;
  int pairs_per_tile, groups_per_tile;
  float scale0;
  int vec;                 // 16-byte row loads allowed
};

// The tile of one block: cells = pairs_per_tile x groups_per_tile x Bmax
// of five u32 arrays (grad low, grad high, hess low, hess high, count), 20
// bytes a cell.  An int64 add is two native 32-bit adds: the low word's
// old value says whether it carried into the high word.
__device__ __forceinline__ void add_cell(unsigned* w, int cells, int cell,
                                         long long qg, long long qh, int c) {
  const unsigned long long v[2] = {static_cast<unsigned long long>(qg),
                                   static_cast<unsigned long long>(qh)};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    unsigned* lo = w + 2 * j * cells + cell;
    const unsigned l = static_cast<unsigned>(v[j]);
    unsigned h = static_cast<unsigned>(v[j] >> 32);
    if (l != 0u) {
      const unsigned old = atomicAdd(lo, l);
      h += (old + l < old) ? 1u : 0u;  // the low word carried
    }
    if (h != 0u) atomicAdd(lo + cells, h);
  }
  if (c != 0) atomicAdd(w + 4 * cells + cell, static_cast<unsigned>(c));
}

__device__ __forceinline__ void load4(const int32_t* p, int nr, bool full,
                                      int out[4]) {
  if (full) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < nr ? __ldg(p + i) : -1;
  }
}

__device__ __forceinline__ void load4(const float* p, int nr, bool full,
                                      float out[4]) {
  if (full) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < nr ? __ldg(p + i) : 0.0f;
  }
}

__device__ __forceinline__ unsigned load_bins4(const uint8_t* p, int nr,
                                               bool full) {
  if (full) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned w = 0u;
  for (int i = 0; i < nr; ++i)
    w |= static_cast<unsigned>(__ldg(p + i)) << (8 * i);
  return w;
}

// rows at or past r1 load as slot -1 (no slot), weights 0, bins 0
__device__ __forceinline__ int rows_left(int64_t row, int64_t r1) {
  return r1 - row >= 4 ? 4 : (r1 > row ? static_cast<int>(r1 - row) : 0);
}

// grid: x = pair tile, y = group tile, z = row range
__global__ void __launch_bounds__(kMaxThreads)
hist_rows_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned smem[];
  const int P = a.K * a.S;
  const int c0 = static_cast<int>(blockIdx.x) * a.pairs_per_tile;
  const int c1 = min(c0 + a.pairs_per_tile, P);
  const int gpt = a.groups_per_tile;
  const int g0 = static_cast<int>(blockIdx.y) * gpt;
  const int ng = min(g0 + gpt, a.G) - g0;
  const int cells = a.pairs_per_tile * gpt * a.Bmax;
  for (int i = threadIdx.x; i < 5 * cells; i += blockDim.x) smem[i] = 0u;
  __syncthreads();

  const int64_t r0 = static_cast<int64_t>(blockIdx.z) * a.rows_per_range;
  const int64_t r1 =
      r0 + a.rows_per_range < a.n ? r0 + a.rows_per_range : a.n;
  const int k0 = c0 / a.S;
  const int k1 = (c1 - 1) / a.S;
  // each thread takes 4 rows at a time, the block's threads 4 * blockDim
  for (int64_t row = r0 + 4LL * threadIdx.x; row < r1;
       row += 4LL * blockDim.x) {
    const int nr = rows_left(row, r1);
    const bool full = a.vec && nr == 4;
    float cw[4];
    load4(a.cnt + row, nr, full, cw);
    for (int k = k0; k <= k1; ++k) {
      // class k's slots in the tile's pairs: [lo, lo + span)
      const int lo = max(c0 - k * a.S, 0);
      const int span = min(c1 - k * a.S, a.S) - lo;
      const int64_t kr = static_cast<int64_t>(k) * a.n + row;
      int s[4];
      float gw[4], hw[4];
      load4(a.slot + kr, nr, full, s);
      load4(a.grad + kr, nr, full, gw);
      load4(a.hess + kr, nr, full, hw);
      // lp: the pair within the tile (-1: not in the tile)
      int lp[4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = static_cast<unsigned>(s[i] - lo) <
                        static_cast<unsigned>(span);
        lp[i] = ok ? k * a.S + s[i] - c0 : -1;
        any |= ok;
      }
      if (!any) continue;
      const float sc = a.scales != nullptr ? __ldg(a.scales + k) : a.scale0;
      long long qg[4], qh[4];
      int qc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qg[i] = __float2ll_rn(gw[i] * sc);
        qh[i] = __float2ll_rn(hw[i] * sc);
        qc[i] = __float2int_rn(cw[i]);
      }
      const uint8_t* col = a.bins_T + static_cast<int64_t>(g0) * a.n + row;
      unsigned word = load_bins4(col, nr, full);
      for (int gl = 0; gl < ng; ++gl) {
        // the next group's bin bytes, loaded before this group's adds
        const unsigned next_word =
            gl + 1 < ng ? load_bins4(col + (gl + 1) * a.n, nr, full) : 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (lp[i] < 0) continue;
          const int b = (word >> (8 * i)) & 0xff;
          add_cell(smem, cells, (lp[i] * gpt + gl) * a.Bmax + b, qg[i],
                   qh[i], qc[i]);
        }
        word = next_word;
      }
    }
  }
  __syncthreads();

  // flush the tile once
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i % a.Bmax;
    const int t = i / a.Bmax;
    const int g = g0 + t % gpt;
    const int p = c0 + t / gpt;
    if (p >= c1 || g >= g0 + ng) continue;
    const unsigned long long vg =
        (static_cast<unsigned long long>(smem[cells + i]) << 32) | smem[i];
    const unsigned long long vh =
        (static_cast<unsigned long long>(smem[3 * cells + i]) << 32) |
        smem[2 * cells + i];
    const int vc = static_cast<int>(smem[4 * cells + i]);
    unsigned long long* out =
        a.acc + ((static_cast<int64_t>(p) * a.G + g) * a.Bmax + b) * 3;
    if (vg != 0ull) atomicAdd(out, vg);
    if (vh != 0ull) atomicAdd(out + 1, vh);
    if (vc != 0)
      atomicAdd(out + 2, static_cast<unsigned long long>(
                             static_cast<long long>(vc)));
  }
}

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

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the plan's limits; false: refuse it
bool plan_ok(const int64_t* q, int64_t n, int G, int K, int S, int Bmax) {
  const int64_t P = static_cast<int64_t>(K) * S;
  return q[kPairsPerTile] >= 1 && q[kGroupsPerTile] >= 1 &&
         q[kPairTiles] >= 1 && q[kGroupTiles] >= 1 &&
         q[kPairTiles] * q[kPairsPerTile] >= P &&
         (q[kPairTiles] - 1) * q[kPairsPerTile] < P &&
         q[kGroupTiles] * q[kGroupsPerTile] >= G &&
         (q[kGroupTiles] - 1) * q[kGroupsPerTile] < G &&
         q[kPairTiles] <= INT_MAX && q[kGroupTiles] <= 65535 &&
         q[kRowRanges] >= 1 && q[kRowRanges] <= 65535 &&
         q[kRowsPerRange] >= 4 && q[kRowsPerRange] % 4 == 0 &&
         q[kRowRanges] * q[kRowsPerRange] >= n &&
         q[kThreads] >= 32 && q[kThreads] <= kMaxThreads &&
         q[kThreads] % 32 == 0 &&
         q[kSmem] == q[kPairsPerTile] * q[kGroupsPerTile] * Bmax *
                         kCellBytes &&
         q[kSmem] <= kMaxSmem;
}

int hist_rows(const uint8_t* bins_T, int64_t n, int G, int K,
              const int32_t* slot, const float* grad, const float* hess,
              const float* cnt, int S, int Bmax, const float* scales,
              float scale0, float inv0, const int64_t* plan, int64_t* acc,
              float* hist, cudaStream_t stream) {
  if (n < 0 || G < 1 || K < 1 || S < 1 || Bmax < 1 || Bmax > 256 ||
      plan == nullptr || !plan_ok(plan, n, G, K, S, Bmax))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* h_acc = reinterpret_cast<unsigned long long*>(acc);
  const int64_t per_class = static_cast<int64_t>(S) * G * Bmax * 3;
  const int64_t cells = per_class * K;
  cudaError_t err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    Args a;
    a.bins_T = bins_T; a.slot = slot; a.grad = grad; a.hess = hess;
    a.cnt = cnt; a.scales = scales; a.acc = h_acc; a.n = n;
    a.rows_per_range = plan[kRowsPerRange];
    a.G = G; a.K = K; a.S = S; a.Bmax = Bmax;
    a.pairs_per_tile = static_cast<int>(plan[kPairsPerTile]);
    a.groups_per_tile = static_cast<int>(plan[kGroupsPerTile]);
    a.scale0 = scale0;
    a.vec = n % 4 == 0 && aligned(slot, 16) && aligned(grad, 16) &&
            aligned(hess, 16) && aligned(cnt, 16) && aligned(bins_T, 4);
    const int smem = static_cast<int>(plan[kSmem]);
    err = cudaFuncSetAttribute(
        hist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(plan[kPairTiles]),
                    static_cast<unsigned>(plan[kGroupTiles]),
                    static_cast<unsigned>(plan[kRowRanges]));
    hist_rows_kernel<<<grid, static_cast<unsigned>(plan[kThreads]), smem,
                       stream>>>(a);
    err = cudaGetLastError();
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
// cudaErrorInvalidValue for a plan outside its limits).  acc is int64
// scratch of the histogram's size that the call zeroes; hist is the float32
// result; plan is the host array of kernels/hist_wide.py::hist_plan.

// K5: (N,) slots and weights, one shift (scale = 2**shift, inv_scale its
// inverse); hist (S, G, Bmax, 3).
extern "C" int lgbt_scatter_hist(
    const uint8_t* bins_T, int64_t n_rows, int G, const int32_t* slot,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    float scale, float inv_scale, int64_t* acc, float* hist,
    const int64_t* plan, cudaStream_t stream) {
  return hist_rows(bins_T, n_rows, G, 1, slot, grad, hess, cnt, S, Bmax,
                   nullptr, scale, inv_scale, plan, acc, hist, stream);
}

// K8: (K, N) class-major slots, grads and hesses, (N,) counts; scales (2, K)
// on the device, row 0 each class's 2**shift and row 1 its 2**-shift;
// hist (K, S, G, Bmax, 3).
extern "C" int lgbt_hist_wide(
    const uint8_t* bins_T, int64_t n_rows, int G, int K, const int32_t* slot,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    const float* scales, int64_t* acc, float* hist, const int64_t* plan,
    cudaStream_t stream) {
  return hist_rows(bins_T, n_rows, G, K, slot, grad, hess, cnt, S, Bmax,
                   scales, 0.0f, 0.0f, plan, acc, hist, stream);
}
