// Route replay: every row's leaf after a tree's growth rounds.  Starting
// from leaf 0, apply the R stored rounds of per-leaf route records in
// order to each row and write the row's final leaf once.
//
// Replaces the TPU kernel lightgbm_tpu/pallas/stream_kernel.py
// `route_replay` -> `_route_replay_kernel` (the GOSS/bagging route fusion
// of lightgbm_tpu/ops/grow.py:1562-1585).  A sampled tree grows on the
// compacted in-bag rows; this one launch gives every row its leaf for the
// score update, where the unfused path runs one route-only pass of the
// growth kernel over all rows per round.  The TPU's one-hot table matmul
// over 7-bit digits is not carried over: a row reads its leaf's record by
// index.
//
// The decision is K2's numeric route step: the row's bin in the split's
// group, unbundled when the feature shares an EFB group; a NaN or
// zero-as-missing bin (-1 = none) goes the default way, any other bin
// left when it is at most the threshold.  The grower keeps categorical
// trees off this path, as the reference does.  A child outside [0, L)
// stops the row at -1.
//
// Bins are uint8, or 16-bit where a group is wider than 256 bins (the `T`
// template argument, the caller's int16 storage read as uint16_t).  The
// packed record's 9-bit fields stay: in the 16-bit form a record whose
// threshold or NaN / zero bin is past 255 is special as well, and a row's
// bin is clamped to 256 before the packed compare, which decides a bin past
// 255 as the full record does (right of any threshold <= 255, equal to no
// missing bin <= 255 nor to the 0x1ff code of none).  The 8-bit form is
// unchanged.
//
// What bounds it on an H100: the bytes the rows need, 4 B of leaf id
// written per row plus one byte per distinct group on its path (~8.4 MB at
// 1M rows and 9 rounds, ~2.5 us at 3.35 TB/s).  The first port (one thread
// a row) made each round a chain of dependent global loads: the leaf's
// 64-byte record, then one bin byte of the (G, N) column layout.  This
// design:
//
//   * A small kernel packs each (round, leaf) record into the 8 bytes the
//     decision reads (kernels/route_replay.py::pack_records, the same
//     packing): word 0 the new leaf id and the group (16 bits each); word 1
//     the threshold bin plus one (9 bits, clamped), the NaN and
//     zero-as-missing bins (9 bits each, 0x1ff: none), default-left, a
//     chosen bit and a special bit.  An unsplit leaf packs to zero.  A
//     record that does not fit (an EFB bundle, a child or group past 16
//     bits, a group outside the bins; over 16-bit bins also a threshold or
//     missing bin past 255) is special and reads its full record from
//     global memory.
//   * Persistent blocks (about one wave) loop over tiles of rows
//     (kernels/route_replay.py::replay_plan).  Each block copies the packed
//     table into shared memory once (cp.async); a table too large for the
//     plan is read from global memory instead.
//   * A thread routes up to 4 rows of a tile (rows t, t + threads, ...),
//     round by round: every row's 8-byte record, then every row's bin byte
//     (a global load, cached in L1), before any decision, so that the rows'
//     loads overlap and the loop has no branch but the rare special one.
//   * The tile's bins are not staged in shared memory: staging all 28
//     groups of a tile (cp.async, double-buffered, in the column layout or
//     in words of 4 groups) copies ~28 MB at 1M rows, and measured slower
//     than these loads on the main path's data with the L2 warm and cold
//     (NVIDIA H100, scripts/torch_hist_bench.py; PERF.md).
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/route_replay.py::route_replay_plain.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// plan fields, in the order of kernels/route_replay.py::REPLAY_PLAN_FIELDS
enum { kRowsPerTile, kThreads, kTiles, kBlocks, kTabBytes };
// the packed record's second word, kernels/route_replay.py::PACK_BITS
enum {
  kNanShift = 9, kMzShift = 18, kDefaultLeftBit = 27, kChosenBit = 28,
  kSpecialBit = 31
};
constexpr unsigned kBinMask = 0x1ff;  // a 9-bit bin code; 0x1ff: none
constexpr int kMaxThreads = 512;      // 128 registers a thread at most
constexpr int kRows = 4;              // rows a thread in one tile, at most
constexpr int kMaxSmem = 232448;      // a block's dynamic shared memory, sm_90

struct Args {
  const void* bins_T;      // (G, n) uint8, or uint16 (the `T` argument)
  const int4* tabs;        // (R, L) records of 16 int32, as 4 int4
  const int2* packed;      // (R, L) packed records
  int32_t* out;            // (n,)
  int64_t n;
  int R, L;
  int rows_per_tile, tiles;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ unsigned missing_code(int b) {
  return b >= 0 && b <= 255 ? static_cast<unsigned>(b) : kBinMask;
}

// route record fields (kernels/layout.py ROUTE_FIELDS), as four int4:
//   q0 = (chosen, new_id, group, span_start)
//   q1 = (default_bin, bundled, nan_bin, mz_bin)
//   q2 = (num_bins, threshold, default_left, is_cat)
//   q3 = (slot_left, slot_right, slot_keep, unused)   -- not read here
// grid: x = round, y = a block of leaves.  wide: the bins are 16-bit.
__global__ void pack_kernel(const int4* __restrict__ tabs, int L, int G,
                            int wide, int2* __restrict__ packed) {
  const int r = static_cast<int>(blockIdx.x);
  const int l = static_cast<int>(blockIdx.y * blockDim.x + threadIdx.x);
  if (l > L) return;
  const int64_t i = static_cast<int64_t>(r) * (L + 1) + l;
  const int4* rec = tabs + (static_cast<int64_t>(r) * L + l) * 4;
  // leaf L: the stop leaf, never split
  const int4 q0 = l < L ? __ldg(rec) : make_int4(0, 0, 0, 0);
  if (q0.x <= 0) {
    packed[i] = make_int2(0, 0);
    return;
  }
  const int4 q1 = __ldg(rec + 1);
  const int4 q2 = __ldg(rec + 2);
  const int groups = G < 0x10000 ? G : 0x10000;
  const int leaves = L < 0x10000 ? L : 0x10000;
  if (q1.y > 0 || q0.y < 0 || q0.y >= leaves || q0.z < 0 ||
      q0.z >= groups ||
      (wide && (q2.y > 255 || q1.z > 255 || q1.w > 255))) {
    packed[i] = make_int2(
        0, static_cast<int>((1u << kChosenBit) | (1u << kSpecialBit)));
    return;
  }
  const int thr = q2.y;
  const unsigned t = thr < 0 ? 0u : (thr >= 255 ? 256u : thr + 1u);
  const unsigned w1 = t | missing_code(q1.z) << kNanShift |
                      missing_code(q1.w) << kMzShift |
                      (q2.z > 0 ? 1u : 0u) << kDefaultLeftBit |
                      1u << kChosenBit;
  packed[i] = make_int2(static_cast<int>(static_cast<unsigned>(q0.y) |
                                         static_cast<unsigned>(q0.z) << 16),
                        static_cast<int>(w1));
}

// The next leaf of row `row` at leaf `lid` in round r, from the full record
// and the row's bin in global memory (special records).
template <class T>
__device__ __noinline__ int special_step(const int4* __restrict__ tabs,
                                         const T* __restrict__ bins_T,
                                         int64_t n, int L, int r, int lid,
                                         int64_t row) {
  const int4* rec = tabs + (static_cast<int64_t>(r) * L + lid) * 4;
  const int4 q0 = __ldg(rec);
  const int4 q1 = __ldg(rec + 1);
  const int4 q2 = __ldg(rec + 2);
  const int gb = __ldg(bins_T + static_cast<int64_t>(q0.z) * n + row);
  int fb = gb;
  if (q1.y > 0) {
    // EFB bundle: the span holds the feature's non-default bins
    const int ls = gb - q0.w;
    fb = (ls >= 0 && ls < q2.x - 1) ? ls + (ls >= q1.x ? 1 : 0) : q1.x;
  }
  const bool missing = fb == q1.z || fb == q1.w;
  const bool go_left = missing ? q2.z > 0 : fb <= q2.y;
  return go_left ? lid : q0.y;
}

// rows of tile t
__device__ __forceinline__ int tile_rows(const Args& a, int t) {
  const int64_t left = a.n - static_cast<int64_t>(t) * a.rows_per_tile;
  return left < a.rows_per_tile ? static_cast<int>(left) : a.rows_per_tile;
}

// grid: persistent blocks, block b taking tiles b, b + gridDim.x, ...
// kTab: the packed table staged in shared memory (else read from global
// memory, a table too large for the plan); T: the bin type.
template <bool kTab, class T>
__global__ void __launch_bounds__(kMaxThreads)
replay_kernel(const Args a) {
  constexpr bool kWide = sizeof(T) > 1;
  const T* bins_T = static_cast<const T*>(a.bins_T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int2* stab = reinterpret_cast<const int2*>(smem);
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);

  if (kTab) {
    const int bytes = a.R * (a.L + 1) * 8;
    const auto* src = reinterpret_cast<const unsigned char*>(a.packed);
    for (int k = tid; 16 * k < bytes; k += nt)
      cp_async16(smem + 16 * k, src + 16 * k, min(16, bytes - 16 * k));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const int L = a.L;  // the stop leaf: every round's record L is zero
  // a group's offset as one 32 x 32 -> 64-bit multiply-add
  const uint64_t n32 = static_cast<uint32_t>(a.n);
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int64_t r0 = static_cast<int64_t>(tile) * a.rows_per_tile;
    const int nr = tile_rows(a, tile);
    int lid[kRows];             // L: the row stopped, or no row
    const T* row[kRows];        // the row's bin of group 0
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      lid[i] = tid + i * nt < nr ? 0 : L;
      row[i] = bins_T + r0 + min(tid + i * nt, nr - 1);
    }
    for (int r = 0; r < a.R; ++r) {
      const int2* trow = (kTab ? stab : a.packed) +
                         static_cast<int64_t>(r) * (L + 1);
      // every row's record, then every row's bin, loaded before any
      // decision, so that the rows' loads overlap
      int2 p[kRows];
      unsigned gb[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p[i] = kTab ? trow[lid[i]] : __ldg(trow + lid[i]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const unsigned g = static_cast<unsigned>(p[i].x) >> 16;
        gb[i] = p[i].y == 0 ? 0u : __ldg(row[i] + g * n32);
        // a 16-bit bin past 255 compares as 256 (see the head of the file)
        if (kWide) gb[i] = min(gb[i], 256u);
      }
      int nxt[kRows];
      unsigned special = 0u;  // rows whose record is special, one bit each
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const unsigned w = static_cast<unsigned>(p[i].y);
        const bool missing = gb[i] == ((w >> kNanShift) & kBinMask) ||
                             gb[i] == ((w >> kMzShift) & kBinMask);
        // an unsplit leaf (w = 0) keeps its rows; a packed child is a leaf
        const bool go_left =
            w == 0u || (missing ? ((w >> kDefaultLeftBit) & 1u) != 0
                                : gb[i] < (w & kBinMask));
        special |= (w >> kSpecialBit) << i;
        nxt[i] = go_left ? lid[i] : (p[i].x & 0xffff);
      }
      if (special != 0u) {
        // rare: out of the loop above, so that it stays free of calls
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (!((special >> i) & 1u)) continue;
          const int c = special_step(a.tabs, bins_T, a.n, L, r, lid[i],
                                     row[i] - bins_T);
          nxt[i] = c >= 0 && c < L ? c : L;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) lid[i] = nxt[i];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (tid + i * nt < nr) a.out[r0 + tid + i * nt] = lid[i] < L ? lid[i]
                                                                    : -1;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int64_t round16(int64_t x) { return (x + 15) / 16 * 16; }

bool plan_ok(const int64_t* q, int64_t n, int R, int L) {
  if (q == nullptr) return false;
  const int64_t tab = q[kTabBytes];
  return q[kThreads] >= 32 && q[kThreads] <= kMaxThreads &&
         q[kThreads] % 32 == 0 &&
         q[kRowsPerTile] >= 16 && q[kRowsPerTile] % 16 == 0 &&
         q[kRowsPerTile] <= kRows * q[kThreads] &&
         q[kTiles] >= 1 && q[kTiles] <= INT_MAX &&
         q[kTiles] * q[kRowsPerTile] >= n &&
         (q[kTiles] - 1) * q[kRowsPerTile] < n &&
         q[kBlocks] >= 1 && q[kBlocks] <= q[kTiles] &&
         (tab == 0 || tab == round16(8LL * R * (L + 1))) && tab <= kMaxSmem;
}

template <bool kTab, class T>
cudaError_t launch(const Args& a, const int64_t* q, cudaStream_t stream) {
  const int smem = static_cast<int>(q[kTabBytes]);
  cudaError_t err = cudaFuncSetAttribute(
      replay_kernel<kTab, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  replay_kernel<kTab, T><<<static_cast<unsigned>(q[kBlocks]),
                           static_cast<unsigned>(q[kThreads]), smem,
                           stream>>>(a);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_of(const Args& a, const int64_t* q, cudaStream_t stream) {
  return q[kTabBytes] > 0 ? launch<true, T>(a, q, stream)
                          : launch<false, T>(a, q, stream);
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched).  bins_T is
// the (G, n_rows) column layout, bin_bytes 1 (uint8) or 2 (16-bit) a bin;
// tabs holds R x L records of 16
// int32, packed is (R * (L + 1)) int2 scratch (16-byte aligned) this
// call fills, out the (n_rows,) int32 leaves; plan is the host array of
// kernels/route_replay.py::replay_plan.
extern "C" int lgbt_route_replay(const void* bins_T, int bin_bytes,
                                 int64_t n_rows, int G, const int32_t* tabs,
                                 int R, int L, int32_t* packed, int32_t* out,
                                 const int64_t* plan, cudaStream_t stream) {
  if ((bin_bytes != 1 && bin_bytes != 2) || n_rows < 1 ||
      n_rows > UINT32_MAX || G < 1 || R < 0 ||
      (R > 0 && (L < 1 || L / 256 + 1 > 65535)) ||
      !aligned(packed, 16) || !plan_ok(plan, n_rows, R, L))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.bins_T = bins_T;
  a.tabs = reinterpret_cast<const int4*>(tabs);
  a.packed = reinterpret_cast<const int2*>(packed);
  a.out = out;
  a.n = n_rows;
  a.R = R;
  a.L = L;
  a.rows_per_tile = static_cast<int>(plan[kRowsPerTile]);
  a.tiles = static_cast<int>(plan[kTiles]);
  if (R > 0) {
    const dim3 grid(static_cast<unsigned>(R),
                    static_cast<unsigned>(L / 256 + 1));
    pack_kernel<<<grid, 256, 0, stream>>>(a.tabs, L, G, bin_bytes == 2,
                                          reinterpret_cast<int2*>(packed));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err = bin_bytes == 2
                              ? launch_of<uint16_t>(a, plan, stream)
                              : launch_of<uint8_t>(a, plan, stream);
  return static_cast<int>(err);
}
