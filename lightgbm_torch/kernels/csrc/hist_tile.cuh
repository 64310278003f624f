// The shared-memory tile pass of the row-order histogram kernels: K5 and K8
// (csrc/hist_rows.cu: grad, hess and count as fixed point) and the
// histogram pass of both forms of K2 (csrc/route_and_hist.cu: grad and hess
// as fixed point, or int8 grid values summed as int32).
//
// A block owns a tile of `pairs_per_tile` class-major (class, slot) pairs
// (pair = class * S + slot) x `groups_per_tile` groups x Bmax bins, one
// 32-bit word per channel word and cell, in shared memory.  It makes one
// pass over its range of rows, 4 rows a thread at a time (int4 slots, float4
// or one 32-bit word of int8 weights, one 32-bit word of 4 bin bytes per
// group; a scalar edge for a ragged end or unaligned operands), places each
// row's pair in the tile with no division and one compare, and adds each of
// its groups' cells with native 32-bit shared-memory atomics.
//
// Bins are uint8, or 16-bit for groups wider than 256 bins (the `T`
// template argument; the caller's int16 storage read as uint16_t): four
// rows' 16-bit bins load as one 8-byte word (uint2).  Only the 16-bit form
// has a bin-tile axis: where one pair's Bmax cells exceed a block's shared
// memory, a tile holds `bins_per_tile` bins [b0, b0 + bins_per_tile) and a
// row whose bin lies outside skips; `bin_tiles` tiles cover Bmax.  The
// 8-bit form's instructions are those it had before the 16-bit form.  An int64 sum
// is two words: the low word's add returns its old value, which says
// whether it carried into the high word (exact modulo 2**64, so exact for
// sums that fit in int64).  The block then flushes its tile once with
// global atomics.  The grid runs (pair tile, group tile, row range), row
// range slowest, so the blocks of one range share its reads in L2.  The
// launch plan (tile shape, row ranges, threads, shared memory) comes from
// kernels/hist_wide.py::hist_plan and is checked here by plan_ok.
//
// Channel sets (the `Ch` template argument): GradHessCount (five words a
// cell, 20 bytes), GradHess (four words, 16 bytes), GradHessInt (two int32
// words, 8 bytes).
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace hist_tile {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90

// plan fields, in the order of kernels/hist_wide.py::PLAN_FIELDS
enum {
  kPairsPerTile, kGroupsPerTile, kPairTiles, kGroupTiles, kRowRanges,
  kRowsPerRange, kThreads, kSmem, kBinsPerTile, kBinTiles
};

struct Args {
  const void* bins_T;      // (G, N) uint8, or uint16 (the `T` argument)
  const int32_t* slot;     // (K, N)
  const void* grad;        // (K, N) float32, or int8 grid values
  const void* hess;        // (K, N) float32, or int8 grid values
  const float* cnt;        // (N,) count weights (GradHessCount only)
  const float* scales;     // (2, K) device table, or null: scale0
  void* out;               // int64 sums, or the int32 result (GradHessInt)
  int64_t n;
  int64_t rows_per_range;
  int G, K, S, Bmax;
  int pairs_per_tile, groups_per_tile;
  int bins_per_tile, bin_tiles;  // the 16-bit form's bin tiles
  float scale0;
  int vec;                 // whole-word row loads allowed
};

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

// 4 bytes of 4 rows as one little-endian word (missing rows read 0)
__device__ __forceinline__ unsigned load_bytes4(const uint8_t* p, int nr,
                                                bool full) {
  if (full) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned w = 0u;
  for (int i = 0; i < nr; ++i)
    w |= static_cast<unsigned>(__ldg(p + i)) << (8 * i);
  return w;
}

// bins of 4 rows: uint8 as one 32-bit word of 4 bytes, 16-bit as one
// 8-byte word of 4 halves (missing rows read 0)
template <class T>
struct Bins4;

template <>
struct Bins4<uint8_t> {
  using Word = unsigned;
  __device__ __forceinline__ static Word load(const uint8_t* p, int nr,
                                              bool full) {
    return load_bytes4(p, nr, full);
  }
  __device__ __forceinline__ static int bin(Word w, int i) {
    return (w >> (8 * i)) & 0xff;
  }
};

template <>
struct Bins4<uint16_t> {
  using Word = uint2;
  __device__ __forceinline__ static Word load(const uint16_t* p, int nr,
                                              bool full) {
    if (full) return __ldg(reinterpret_cast<const uint2*>(p));
    uint2 w = make_uint2(0u, 0u);
    for (int i = 0; i < nr; ++i) {
      const unsigned v = static_cast<unsigned>(__ldg(p + i)) << (16 * (i & 1));
      if (i < 2) w.x |= v; else w.y |= v;
    }
    return w;
  }
  __device__ __forceinline__ static int bin(Word w, int i) {
    return ((i < 2 ? w.x : w.y) >> (16 * (i & 1))) & 0xffff;
  }
};

__device__ __forceinline__ void load4(const int8_t* p, int nr, bool full,
                                      int out[4]) {
  const unsigned w =
      load_bytes4(reinterpret_cast<const uint8_t*>(p), nr, full);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<int>(static_cast<int8_t>(w >> (8 * i)));
}

// add an int64 as two 32-bit words at lo and lo + cells
__device__ __forceinline__ void add_split(unsigned* lo, int cells,
                                          long long q) {
  const unsigned long long v = static_cast<unsigned long long>(q);
  const unsigned l = static_cast<unsigned>(v);
  unsigned h = static_cast<unsigned>(v >> 32);
  if (l != 0u) {
    const unsigned old = atomicAdd(lo, l);
    h += (old + l < old) ? 1u : 0u;  // the low word carried
  }
  if (h != 0u) atomicAdd(lo + cells, h);
}

__device__ __forceinline__ unsigned long long join(const unsigned* w,
                                                   int cells, int i) {
  return (static_cast<unsigned long long>(w[cells + i]) << 32) | w[i];
}

// grad, hess (float32 rounded once to int64 multiples of 2**-shift_k) and
// the count weight (rounded to an integer): words grad low, grad high, hess
// low, hess high, count; flushed into int64 (grad, hess, count) sums
struct GradHessCount {
  static constexpr int kWords = 5;
  struct Row { float c[4]; };
  struct Raw { float g[4], h[4]; };
  struct Val { long long g[4], h[4]; int c[4]; };

  __device__ __forceinline__ static void load_row(const Args& a, int64_t row,
                                                  int nr, bool full, Row& r) {
    load4(a.cnt + row, nr, full, r.c);
  }
  __device__ __forceinline__ static void load_class(const Args& a,
                                                    int64_t kr, int nr,
                                                    bool full, Raw& w) {
    load4(static_cast<const float*>(a.grad) + kr, nr, full, w.g);
    load4(static_cast<const float*>(a.hess) + kr, nr, full, w.h);
  }
  __device__ __forceinline__ static void value(const Args& a, int k,
                                               const Row& r, const Raw& w,
                                               Val& v) {
    const float sc = a.scales != nullptr ? __ldg(a.scales + k) : a.scale0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v.g[i] = __float2ll_rn(w.g[i] * sc);
      v.h[i] = __float2ll_rn(w.h[i] * sc);
      v.c[i] = __float2int_rn(r.c[i]);
    }
  }
  __device__ __forceinline__ static void add(unsigned* w, int cells,
                                             int cell, const Val& v, int i) {
    add_split(w + cell, cells, v.g[i]);
    add_split(w + 2 * cells + cell, cells, v.h[i]);
    if (v.c[i] != 0)
      atomicAdd(w + 4 * cells + cell, static_cast<unsigned>(v.c[i]));
  }
  __device__ __forceinline__ static void flush(const Args& a,
                                               const unsigned* w, int cells,
                                               int i, int64_t cell) {
    const unsigned long long vg = join(w, cells, i);
    const unsigned long long vh = join(w + 2 * cells, cells, i);
    const int vc = static_cast<int>(w[4 * cells + i]);
    unsigned long long* out =
        static_cast<unsigned long long*>(a.out) + cell * 3;
    if (vg != 0ull) atomicAdd(out, vg);
    if (vh != 0ull) atomicAdd(out + 1, vh);
    if (vc != 0)
      atomicAdd(out + 2, static_cast<unsigned long long>(
                             static_cast<long long>(vc)));
  }
};

// grad and hess as GradHessCount's, no count: words grad low, grad high,
// hess low, hess high; flushed into int64 (grad, hess) sums
struct GradHess {
  static constexpr int kWords = 4;
  struct Row {};
  using Raw = GradHessCount::Raw;
  struct Val { long long g[4], h[4]; };

  __device__ __forceinline__ static void load_row(const Args&, int64_t, int,
                                                  bool, Row&) {}
  __device__ __forceinline__ static void load_class(const Args& a,
                                                    int64_t kr, int nr,
                                                    bool full, Raw& w) {
    GradHessCount::load_class(a, kr, nr, full, w);
  }
  __device__ __forceinline__ static void value(const Args& a, int k,
                                               const Row&, const Raw& w,
                                               Val& v) {
    const float sc = __ldg(a.scales + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v.g[i] = __float2ll_rn(w.g[i] * sc);
      v.h[i] = __float2ll_rn(w.h[i] * sc);
    }
  }
  __device__ __forceinline__ static void add(unsigned* w, int cells,
                                             int cell, const Val& v, int i) {
    add_split(w + cell, cells, v.g[i]);
    add_split(w + 2 * cells + cell, cells, v.h[i]);
  }
  __device__ __forceinline__ static void flush(const Args& a,
                                               const unsigned* w, int cells,
                                               int i, int64_t cell) {
    const unsigned long long vg = join(w, cells, i);
    const unsigned long long vh = join(w + 2 * cells, cells, i);
    unsigned long long* out =
        static_cast<unsigned long long*>(a.out) + cell * 2;
    if (vg != 0ull) atomicAdd(out, vg);
    if (vh != 0ull) atomicAdd(out + 1, vh);
  }
};

// int8 grid values of grad and hess summed exactly as int32 (the caller
// keeps every sum inside int32): words grad, hess; flushed into the int32
// (grad, hess) result
struct GradHessInt {
  static constexpr int kWords = 2;
  struct Row {};
  struct Raw { int g[4], h[4]; };
  using Val = Raw;

  __device__ __forceinline__ static void load_row(const Args&, int64_t, int,
                                                  bool, Row&) {}
  __device__ __forceinline__ static void load_class(const Args& a,
                                                    int64_t kr, int nr,
                                                    bool full, Raw& w) {
    load4(static_cast<const int8_t*>(a.grad) + kr, nr, full, w.g);
    load4(static_cast<const int8_t*>(a.hess) + kr, nr, full, w.h);
  }
  __device__ __forceinline__ static void value(const Args&, int, const Row&,
                                               const Raw& w, Val& v) {
    v = w;
  }
  __device__ __forceinline__ static void add(unsigned* w, int cells,
                                             int cell, const Val& v, int i) {
    if (v.g[i] != 0) atomicAdd(w + cell, static_cast<unsigned>(v.g[i]));
    if (v.h[i] != 0)
      atomicAdd(w + cells + cell, static_cast<unsigned>(v.h[i]));
  }
  __device__ __forceinline__ static void flush(const Args& a,
                                               const unsigned* w, int cells,
                                               int i, int64_t cell) {
    const int vg = static_cast<int>(w[i]);
    const int vh = static_cast<int>(w[cells + i]);
    int* out = static_cast<int*>(a.out) + cell * 2;
    if (vg != 0) atomicAdd(out, vg);
    if (vh != 0) atomicAdd(out + 1, vh);
  }
};

// rows at or past r1 load as slot -1 (no slot), weights 0, bins 0
__device__ __forceinline__ int rows_left(int64_t row, int64_t r1) {
  return r1 - row >= 4 ? 4 : (r1 > row ? static_cast<int>(r1 - row) : 0);
}

// grid: x = pair tile (16-bit form: pair tile * bin_tiles + bin tile),
// y = group tile, z = row range
template <class Ch, class T>
__global__ void __launch_bounds__(kMaxThreads)
tile_kernel(const Args a) {
  constexpr bool kBinTiles = sizeof(T) > 1;
  extern __shared__ __align__(16) unsigned smem[];
  const int P = a.K * a.S;
  int pair_tile = static_cast<int>(blockIdx.x);
  int b0 = 0;          // the tile's first bin
  int bpt = a.Bmax;    // bins a tile holds
  if (kBinTiles) {
    pair_tile = static_cast<int>(blockIdx.x) / a.bin_tiles;
    bpt = a.bins_per_tile;
    b0 = (static_cast<int>(blockIdx.x) - pair_tile * a.bin_tiles) * bpt;
  }
  const int c0 = pair_tile * a.pairs_per_tile;
  const int c1 = min(c0 + a.pairs_per_tile, P);
  const int gpt = a.groups_per_tile;
  const int g0 = static_cast<int>(blockIdx.y) * gpt;
  const int ng = min(g0 + gpt, a.G) - g0;
  const int cells = a.pairs_per_tile * gpt * bpt;
  for (int i = threadIdx.x; i < Ch::kWords * cells; i += blockDim.x)
    smem[i] = 0u;
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
    typename Ch::Row rw;
    Ch::load_row(a, row, nr, full, rw);
    for (int k = k0; k <= k1; ++k) {
      // class k's slots in the tile's pairs: [lo, lo + span)
      const int lo = max(c0 - k * a.S, 0);
      const int span = min(c1 - k * a.S, a.S) - lo;
      const int64_t kr = static_cast<int64_t>(k) * a.n + row;
      int s[4];
      typename Ch::Raw raw;
      load4(a.slot + kr, nr, full, s);
      Ch::load_class(a, kr, nr, full, raw);
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
      typename Ch::Val v;
      Ch::value(a, k, rw, raw, v);
      using B4 = Bins4<T>;
      const T* col = static_cast<const T*>(a.bins_T) +
                     static_cast<int64_t>(g0) * a.n + row;
      typename B4::Word word = B4::load(col, nr, full);
      for (int gl = 0; gl < ng; ++gl) {
        // the next group's bins, loaded before this group's adds
        const typename B4::Word next_word =
            gl + 1 < ng ? B4::load(col + (gl + 1) * a.n, nr, full)
                        : typename B4::Word{};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (lp[i] < 0) continue;
          const int b = B4::bin(word, i) - b0;
          if (kBinTiles && static_cast<unsigned>(b) >=
                               static_cast<unsigned>(bpt))
            continue;  // outside the tile's bins
          Ch::add(smem, cells, (lp[i] * gpt + gl) * bpt + b, v, i);
        }
        word = next_word;
      }
    }
  }
  __syncthreads();

  // flush the tile once
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int b = i % bpt;
    const int t = i / bpt;
    const int g = g0 + t % gpt;
    const int p = c0 + t / gpt;
    if (p >= c1 || g >= g0 + ng || (kBinTiles && b0 + b >= a.Bmax)) continue;
    Ch::flush(a, smem, cells, i,
              (static_cast<int64_t>(p) * a.G + g) * a.Bmax + b0 + b);
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the plan's limits for a tile of cell_bytes a cell over bins of
// bin_bytes (1 or 2) a bin; false: refuse it.  Only 16-bit bins tile Bmax.
inline bool plan_ok(const int64_t* q, int64_t n, int G, int K, int S,
                    int Bmax, int cell_bytes, int bin_bytes) {
  const int64_t P = static_cast<int64_t>(K) * S;
  if (q == nullptr || (bin_bytes != 1 && bin_bytes != 2)) return false;
  const int64_t bpt = q[kBinsPerTile];
  const bool bins_ok =
      bin_bytes == 1 ? (q[kBinTiles] == 1 && bpt == Bmax)
                     : (bpt >= 1 && bpt <= Bmax && q[kBinTiles] >= 1 &&
                        q[kBinTiles] * bpt >= Bmax &&
                        (q[kBinTiles] - 1) * bpt < Bmax &&
                        q[kPairTiles] * q[kBinTiles] <= INT_MAX);
  return bins_ok && q[kPairsPerTile] >= 1 && q[kGroupsPerTile] >= 1 &&
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
         q[kSmem] == q[kPairsPerTile] * q[kGroupsPerTile] * bpt *
                         cell_bytes &&
         q[kSmem] <= kMaxSmem;
}

// Launch the tile pass of channel set Ch over a.n > 0 rows of T bins
// under a plan that plan_ok accepted.
template <class Ch, class T>
cudaError_t launch_tiles_of(Args a, const int64_t* plan,
                            cudaStream_t stream) {
  a.rows_per_range = plan[kRowsPerRange];
  a.pairs_per_tile = static_cast<int>(plan[kPairsPerTile]);
  a.groups_per_tile = static_cast<int>(plan[kGroupsPerTile]);
  a.bins_per_tile = static_cast<int>(plan[kBinsPerTile]);
  a.bin_tiles = static_cast<int>(plan[kBinTiles]);
  const int smem = static_cast<int>(plan[kSmem]);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<Ch, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(plan[kPairTiles] * plan[kBinTiles]),
                  static_cast<unsigned>(plan[kGroupTiles]),
                  static_cast<unsigned>(plan[kRowRanges]));
  tile_kernel<Ch, T><<<grid, static_cast<unsigned>(plan[kThreads]), smem,
                       stream>>>(a);
  return cudaGetLastError();
}

// launch_tiles_of at the bins' width, bin_bytes 1 (uint8) or 2 (16-bit)
template <class Ch>
cudaError_t launch_tiles(const Args& a, int bin_bytes, const int64_t* plan,
                         cudaStream_t stream) {
  return bin_bytes == 2 ? launch_tiles_of<Ch, uint16_t>(a, plan, stream)
                        : launch_tiles_of<Ch, uint8_t>(a, plan, stream);
}

// whole-word loads of 4 rows' bins allowed: the row count a multiple of 4
// and the bins aligned to 4 bins
inline bool bins_aligned(const void* bins_T, int64_t n, int bin_bytes) {
  return n % 4 == 0 && aligned(bins_T, 4 * static_cast<uintptr_t>(bin_bytes));
}

// the most bins a group of bin_bytes a bin can have
inline int max_group_bins(int bin_bytes) {
  return bin_bytes == 2 ? 65536 : 256;
}

}  // namespace hist_tile
