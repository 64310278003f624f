// Slot histograms over slot-sorted row blocks: (grad, hess, count) sums per
// (slot, group, bin), each block of the plan belonging to one slot.
//
// Replaces the TPU kernels lightgbm_tpu/pallas/hist_kernel.py
// `_hist_direct` -> `_direct_kernel` (Bmax <= 128, K6) and `_hist_nibble`
// -> `_nibble_kernel` (Bmax > 128, K7; past 256 bins the contract over
// 16-bit bins, which that kernel's byte packing cannot hold), which read
// the block plan of
// lightgbm_tpu/ops/compact.py `plan_blocks` (reference analog:
// src/treelearner/cuda/cuda_histogram_constructor.cu over the leaf-ordered
// rows of cuda_data_partition.cu).
//
// The TPU kernels build a (G*B, T) bf16 one-hot of each block (direct) or
// two 16-bin digit one-hots (nibble), contract them with the weights split
// into bf16 hi and lo parts on the matrix unit, and read bins packed four
// to an int32; all of that exists because the TPU has no fast scatter, and
// the two differ only in how the one-hot is split.  None of it is copied:
// K6 and K7 are one kernel here, `direct_kernel`, and differ only in the
// Bmax range each entry point takes and in the launch plan
// kernels/hist_sorted.py::sorted_plan picks for it.  As in the reference
// CUDA learner, the rows of one slot are contiguous, so a block's
// histogram tile needs no slot axis: (groups, Bmax) cells in shared memory,
// flushed into an int64 (S, G, Bmax, 3) sum with 64-bit global atomics
// when the slot changes and at the end of a block's range, as the TPU
// kernel writes its accumulator back at a slot's last block.  A position
// whose gather index is the pad row n adds nothing, so the plan's pad
// blocks add nothing; slots with no rows stay zero.  Sums are exact fixed
// point, so the result is the same on every run and equals the plain
// version (lightgbm_torch/kernels/hist_sorted.py::hist_sorted_plain) bit
// for bit.
//
// What bounds it on an H100: the bytes a pass must move (the 4-byte gather
// index, the row's G bin bytes and its three weights: ~44 B/row at 28
// groups beside the slot sort) take ~13 us at 1M rows and 3.35 TB/s; the
// adds are far fewer operations than the card's rate covers.
//
// The kernel runs on the tile pass of the row-order kernels
// (csrc/hist_tile.cuh, channel set GradHessCount: 20-byte cells of split
// 32-bit words).  The first port (one template for both, 64-bit shared
// atomicAdds, which compile to ATOMS.CAST.SPIN.64 compare-and-swap loops on
// sm_90a; ~2 blocks of 256 threads an SM; one row a thread with scalar
// loads) was replaced for K6 first and then for K7.  Now:
//
//   * each row's (grad, hess, count) is added with GradHessCount::add
//     (native 32-bit shared atomics, the low word's carry into the high
//     word) and flushed with GradHessCount::flush, so the SASS has no
//     ATOMS.CAST.SPIN.64;
//   * a thread reads 4 plan positions at a time (an int4 of gather
//     indices), each row's three weights, and its G group bytes as whole
//     32-bit words where the row-major bins allow it, the next word of the
//     4 rows loaded before this word's adds;
//   * blocks run over ranges of plan blocks in tiles of groups sized by
//     sorted_plan (checked here), a pad block skipped on its first gather
//     index, and flush once per slot run within a block.  At Bmax > 128 a
//     tile of all 28 groups takes 143 KB, one block an SM, so K7's plan
//     chooses its tile, threads and ranges apart from K6's.
//
// Bins are uint8, or 16-bit where a group is wider than 256 bins (the `T`
// template argument; the caller's int16 storage read as uint16_t), which
// only K7 meets (16-bit storage means Bmax > 256).  The 8-bit
// instantiation is the code the kernel had before the 16-bit form; the
// 16-bit form loads a row's 4 groups as one 8-byte word where aligned
// and, only where one group's Bmax cells exceed a block's shared memory
// (Bmax > 11 622), tiles the bin axis: a tile then holds one group and
// `bins_per_tile` bins [b0, b0 + bins_per_tile), grid z picks the bin
// tile, and a row whose bin lies outside it skips, as the row-order tile
// pass does (csrc/hist_tile.cuh).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hist_tile.cuh"

namespace {

constexpr int kCellBytes = 20;  // GradHessCount: five 32-bit words a cell

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

// plan fields, in the order of kernels/hist_sorted.py::SORTED_PLAN_FIELDS
enum {
  kGroupsPerTile, kGroupTiles, kBlocksPerRange, kRanges, kPlanThreads,
  kPlanSmem, kBinsPerTile, kBinTiles
};
constexpr int kDirectMaxThreads = 1024;

struct DirectArgs {
  hist_tile::Args ch;          // the channel set's scale and int64 output
  const void* bins;            // (n, G) row-major, uint8 or uint16
  const int32_t* gather_idx;   // (NB * T) source row of every position
  const int32_t* scalars;      // (NB, 3) slot of every plan block
  const float* grad;
  const float* hess;
  const float* cnt;
  int64_t n;
  int G, Bmax, NB, T, S;
  int groups_per_tile, blocks_per_range;
  int bins_per_tile;           // the 16-bit form's bin tiles (grid z)
  int vec_idx;                 // 4 gather indices as one int4
  int vec_bins;                // a row's 4 groups' bins as one word
};

// Adds the tile's non-zero cells (bins [b0, b0 + bpt) of its groups) into
// slot s of the int64 sum and zeroes them.  Called by every thread of the
// block between barriers.
__device__ void flush_direct(const DirectArgs& a, unsigned* w, int cells,
                             int s, int g0, int ng, int b0, int bpt) {
  using Ch = hist_tile::GradHessCount;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int gl = i / bpt;
    const int b = b0 + i - gl * bpt;
    if (gl < ng && b < a.Bmax)
      Ch::flush(a.ch, w, cells, i,
                (static_cast<int64_t>(s) * a.G + g0 + gl) * a.Bmax + b);
#pragma unroll
    for (int k = 0; k < Ch::kWords; ++k) w[k * cells + i] = 0u;
  }
}

// grid: x = range of plan blocks, y = group tile, z = bin tile (16-bit
// form)
template <class T>
__global__ void __launch_bounds__(kDirectMaxThreads)
direct_kernel(const DirectArgs a) {
  using Ch = hist_tile::GradHessCount;
  using B4 = hist_tile::Bins4<T>;
  constexpr bool kBinTiles = sizeof(T) > 1;
  extern __shared__ __align__(16) unsigned tile[];
  const int gpt = a.groups_per_tile;
  const int g0 = static_cast<int>(blockIdx.y) * gpt;
  const int ng = min(g0 + gpt, a.G) - g0;
  const int bpt = kBinTiles ? a.bins_per_tile : a.Bmax;
  const int bin0 = kBinTiles ? static_cast<int>(blockIdx.z) * bpt : 0;
  const int cells = gpt * bpt;
  for (int i = threadIdx.x; i < Ch::kWords * cells; i += blockDim.x)
    tile[i] = 0u;
  const int b0 = static_cast<int>(blockIdx.x) * a.blocks_per_range;
  const int b1 = min(b0 + a.blocks_per_range, a.NB);
  int cur = -1;  // the slot whose rows the tile holds
  for (int blk = b0; blk < b1; ++blk) {
    const int s = __ldg(a.scalars + 3 * blk);
    const int32_t* idx = a.gather_idx + static_cast<int64_t>(blk) * a.T;
    // a block past every slot's run gathers only the pad row n, and a real
    // block's first position is a row of its slot
    if (s < 0 || s >= a.S || __ldg(idx) >= a.n) continue;
    if (s != cur) {
      __syncthreads();
      if (cur >= 0) flush_direct(a, tile, cells, cur, g0, ng, bin0, bpt);
      __syncthreads();
      cur = s;
    }
    for (int p = 4 * threadIdx.x; p < a.T; p += 4 * blockDim.x) {
      const int nr = min(4, a.T - p);
      int row[4];
      hist_tile::load4(idx + p, nr, a.vec_idx && nr == 4, row);
      bool ok[4];
      Ch::Row rw;
      Ch::Raw raw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ok[i] = row[i] >= 0 && row[i] < a.n;   // the pad row adds nothing
        rw.c[i] = ok[i] ? __ldg(a.cnt + row[i]) : 0.0f;
        raw.g[i] = ok[i] ? __ldg(a.grad + row[i]) : 0.0f;
        raw.h[i] = ok[i] ? __ldg(a.hess + row[i]) : 0.0f;
      }
      Ch::Val v;
      Ch::value(a.ch, 0, rw, raw, v);
      const T* rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[i] = static_cast<const T*>(a.bins) +
                static_cast<int64_t>(ok[i] ? row[i] : 0) * a.G + g0;
      if (a.vec_bins) {
        // ng is a multiple of 4: whole words of 4 groups' bins
        typename B4::Word word[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          word[i] = ok[i] ? B4::load(rb[i], 4, true) : typename B4::Word{};
        for (int gw = 0; gw < ng; gw += 4) {
          // the next word of each row, loaded before this word's adds
          typename B4::Word next[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            next[i] = ok[i] && gw + 4 < ng ? B4::load(rb[i] + gw + 4, 4, true)
                                           : typename B4::Word{};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (!ok[i]) continue;
              const int b = B4::bin(word[i], j) - bin0;
              if (kBinTiles && static_cast<unsigned>(b) >=
                                   static_cast<unsigned>(bpt))
                continue;  // outside the tile's bins
              Ch::add(tile, cells, (gw + j) * bpt + b, v, i);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) word[i] = next[i];
        }
      } else {
        for (int gl = 0; gl < ng; ++gl) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!ok[i]) continue;
            const int b = static_cast<int>(__ldg(rb[i] + gl)) - bin0;
            if (kBinTiles &&
                static_cast<unsigned>(b) >= static_cast<unsigned>(bpt))
              continue;
            Ch::add(tile, cells, gl * bpt + b, v, i);
          }
        }
      }
    }
  }
  __syncthreads();
  if (cur >= 0) flush_direct(a, tile, cells, cur, g0, ng, bin0, bpt);
}

// the plan's limits over bins of bin_bytes (1 or 2) a bin; false: refuse
// it.  Only 16-bit bins tile Bmax.
bool direct_plan_ok(const int64_t* q, int NB, int G, int Bmax,
                    int bin_bytes) {
  if (q == nullptr) return false;
  const int64_t bpt = q[kBinsPerTile];
  const bool bins_ok =
      bin_bytes == 1 ? (q[kBinTiles] == 1 && bpt == Bmax)
                     : (bpt >= 1 && bpt <= Bmax && q[kBinTiles] >= 1 &&
                        q[kBinTiles] <= 65535 &&
                        q[kBinTiles] * bpt >= Bmax &&
                        (q[kBinTiles] - 1) * bpt < Bmax &&
                        (q[kBinTiles] == 1 || q[kGroupsPerTile] == 1));
  return bins_ok && q[kGroupsPerTile] >= 1 && q[kGroupTiles] >= 1 &&
         q[kGroupTiles] * q[kGroupsPerTile] >= G &&
         (q[kGroupTiles] - 1) * q[kGroupsPerTile] < G &&
         q[kGroupTiles] <= 65535 && q[kBlocksPerRange] >= 1 &&
         q[kRanges] >= 1 && q[kRanges] <= INT_MAX &&
         q[kRanges] * q[kBlocksPerRange] >= NB &&
         (q[kRanges] - 1) * q[kBlocksPerRange] < (NB > 0 ? NB : 1) &&
         q[kPlanThreads] >= 32 && q[kPlanThreads] <= kDirectMaxThreads &&
         q[kPlanThreads] % 32 == 0 &&
         q[kPlanSmem] == q[kGroupsPerTile] * bpt * kCellBytes &&
         q[kPlanSmem] <= hist_tile::kMaxSmem;
}

template <class T>
cudaError_t launch_direct(const DirectArgs& a, const int64_t* plan,
                          cudaStream_t stream) {
  const int smem = static_cast<int>(plan[kPlanSmem]);
  cudaError_t err = cudaFuncSetAttribute(
      direct_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(plan[kRanges]),
                  static_cast<unsigned>(plan[kGroupTiles]),
                  static_cast<unsigned>(plan[kBinTiles]));
  direct_kernel<T><<<grid, static_cast<unsigned>(plan[kPlanThreads]), smem,
                     stream>>>(a);
  return cudaGetLastError();
}

// One launch of direct_kernel over a plan that direct_plan_ok accepts, for
// Bmax in [lo, hi] (hi 0: the most a group of bin_bytes a bin has).
int hist_sorted(const void* bins, int bin_bytes, int64_t n_rows, int G,
                const int32_t* gather_idx, const int32_t* scalars, int NB,
                int T, const float* grad, const float* hess, const float* cnt,
                int S, int Bmax, float scale, float inv_scale, int64_t* acc,
                float* hist, const int64_t* plan, int lo, int hi,
                cudaStream_t stream) {
  if (bin_bytes != 1 && bin_bytes != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hi == 0) hi = hist_tile::max_group_bins(bin_bytes);
  if (n_rows < 0 || G < 1 || T < 1 || S < 1 || Bmax < lo || Bmax > hi ||
      !direct_plan_ok(plan, NB, G, Bmax, bin_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* h_acc = reinterpret_cast<unsigned long long*>(acc);
  const int64_t cells = static_cast<int64_t>(S) * G * Bmax * 3;
  cudaError_t err = cudaMemsetAsync(h_acc, 0, sizeof(int64_t) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (NB > 0 && n_rows > 0) {
    DirectArgs a{};
    a.ch.out = h_acc;
    a.ch.scales = nullptr;
    a.ch.scale0 = scale;
    a.bins = bins;
    a.gather_idx = gather_idx;
    a.scalars = scalars;
    a.grad = grad;
    a.hess = hess;
    a.cnt = cnt;
    a.n = n_rows;
    a.G = G;
    a.Bmax = Bmax;
    a.NB = NB;
    a.T = T;
    a.S = S;
    a.groups_per_tile = static_cast<int>(plan[kGroupsPerTile]);
    a.blocks_per_range = static_cast<int>(plan[kBlocksPerRange]);
    a.bins_per_tile = static_cast<int>(plan[kBinsPerTile]);
    a.vec_idx = T % 4 == 0 && hist_tile::aligned(gather_idx, 16);
    a.vec_bins = G % 4 == 0 && a.groups_per_tile % 4 == 0 &&
                 hist_tile::aligned(bins, 4 * bin_bytes);
    err = bin_bytes == 2 ? launch_direct<uint16_t>(a, plan, stream)
                         : launch_direct<uint8_t>(a, plan, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_float_kernel<<<static_cast<unsigned>(ceil_div(cells, 256)), 256, 0,
                    stream>>>(h_acc, cells, inv_scale, hist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interfaces, loaded with ctypes.  Each launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  bins is
// the row-major (n_rows, G) matrix of bin_bytes (1: uint8, 2: 16-bit) a
// bin; gather_idx (NB*T) and scalars (NB, 3) are the block plan; acc is
// (S*G*Bmax*3) int64 scratch this call zeroes; hist is the (S, G, Bmax, 3)
// float32 result; plan is the host array of
// kernels/hist_sorted.py::sorted_plan.

// K6 (Bmax <= 128)
extern "C" int lgbt_hist_direct(
    const void* bins, int bin_bytes, int64_t n_rows, int G,
    const int32_t* gather_idx, const int32_t* scalars, int NB, int T,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    float scale, float inv_scale, int64_t* acc, float* hist,
    const int64_t* plan, cudaStream_t stream) {
  return hist_sorted(bins, bin_bytes, n_rows, G, gather_idx, scalars, NB, T,
                     grad, hess, cnt, S, Bmax, scale, inv_scale, acc, hist,
                     plan, 1, 128, stream);
}

// K7 (Bmax > 128: up to 256 over uint8 bins, 65 536 over 16-bit bins)
extern "C" int lgbt_hist_nibble(
    const void* bins, int bin_bytes, int64_t n_rows, int G,
    const int32_t* gather_idx, const int32_t* scalars, int NB, int T,
    const float* grad, const float* hess, const float* cnt, int S, int Bmax,
    float scale, float inv_scale, int64_t* acc, float* hist,
    const int64_t* plan, cudaStream_t stream) {
  return hist_sorted(bins, bin_bytes, n_rows, G, gather_idx, scalars, NB, T,
                     grad, hess, cnt, S, Bmax, scale, inv_scale, acc, hist,
                     plan, 129, 0, stream);
}
