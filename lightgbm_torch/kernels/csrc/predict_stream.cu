// Batch prediction over binned rows: every row walks every tree of one
// class and sums the leaf values in float32, in tree order.
//
// Replaces the TPU kernel lightgbm_tpu/pallas/predict_kernel.py
// `predict_stream` -> `_predict_kernel` (reference analog:
// src/boosting/gbdt_prediction.cpp PredictRaw, per-row loop over trees).
//
// The TPU kernel advances a whole row block one tree level at a time with a
// node-one-hot matmul, because the TPU has no fast gather, and its tables
// digit-encode every field in 7 bits and store leaf values as bf16 hi/lo
// pairs so that bf16 matmuls stay exact.  None of that is copied: each row
// chases its own pointers through plain records, and the leaf values are
// the exact float32 values, so the sum is closer to the host float64 walk
// than the TPU kernel's (the two device kernels agree to a tolerance).
//
// What bounds it on an H100: the bytes a call must move (bins, tables,
// output) take far less time at the HBM rate than the operations of the
// node visits (bin address, compare, child select, leaf test) at the card's
// core rate, so the bound is set by operations (chip_smoke.py computes both
// from the visits of its run).  The first port (one thread a row, each
// visit three or four 16-byte loads of a 64-byte record from L2 and one
// bin byte from global memory) ran at L2's rate, ~100x its bound.  This
// design:
//
//   * Nodes are packed in word planes (kernels/predict.py::pack_nodes).  A
//     step reads two words: the children (16 bits each) and the group with
//     the threshold bin and a special-node bit.  Only a special node (NaN
//     or zero bin, EFB bundle, categorical bitset, or children past 16
//     bits) reads its flags, children and side words, from global memory.
//   * A block owns a tile of rows (kernels/predict.py::predict_plan) and
//     walks every tree over them.  The tile's (G, rows) bin bytes are copied
//     into shared memory once; the trees come in stages of a few (the two
//     walk words and the leaf value of each node, 12 bytes), double-
//     buffered: cp.async fetches stage s + 1 while stage s is walked.  The
//     model is re-read from L2 once per tile, not once per visit.  Trees too
//     large for a stage are walked from global memory, and bins too wide
//     for a tile's shared memory are read from global memory: paths of the
//     plan.
//   * The walk is one row a thread, the threads of a block taking each tree
//     together, so that the inner loop is one 8-byte load of the staged
//     walk words, a bin load, one compare and a child select; 1536 threads
//     an SM (three blocks at 42 registers) hide the loads' latency.  Chip
//     runs on an NVIDIA H100 (PERF.md) found this faster than rows that
//     move on to their next tree on their own (the bookkeeping cost more
//     instructions than the divergence it saved) and than several rows a
//     thread.  A warp still waits for its deepest row in each tree: ~60 %
//     of its lanes' steps do work on the main path's model.
//   * The same sums: each row adds its trees' leaf values in float32 in tree
//     order; the prediction early stop (reference:
//     prediction_early_stop.cpp CreateBinary) tests 2|score| > margin after
//     every es_freq trees and freezes the row; a block whose rows have all
//     stopped skips its remaining stages.
//   * Bins are uint8, or 16-bit where a group is wider than 256 bins (the
//     `T` template argument, the caller's int16 storage read as uint16_t):
//     a tile stages two bytes a bin, and the walk word's compare is
//     unsigned, so that a bin of 32 768 or more goes right of every 15-bit
//     threshold.  A node whose threshold bin does not fit those 15 bits, or
//     whose NaN or zero bin does not fit the flags' 9-bit codes, is special
//     and wide: its step reads the whole threshold and 16-bit missing bins
//     from their own planes.  The 8-bit form is unchanged.
//   * The walk of one tree is bounded by `max_depth` steps, so a malformed
//     model cannot hang the card; a row still on an internal node after
//     max_depth steps (a single-leaf tree) resolves to leaf 0, as the TPU
//     kernel does.
//   * The leaf form (`kLeaf`, entry point lgbt_predict_leaf; pred_leaf)
//     walks the same way and writes each (row, tree) leaf index as int32
//     into an (N, columns) matrix, tree t of the launch at column
//     col0 + t * col_step (the class's columns of a multiclass model), with
//     no sum and no early stop; it replaces the JAX package's host loop
//     over trees (lightgbm_tpu/basic.py:1414-1418).  The score form is the
//     same code with kLeaf false.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/predict.py::predict_stream_plain.  Both add the
// same float32 values in the same order, so they agree bit for bit.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// word planes of the packed nodes, in the order of
// kernels/predict.py::PACKED_WORDS.  Children: c < L an internal node,
// c >= L leaf c - L.
enum {
  kChildren16, kGroupThr, kFlags, kLeft, kRight, kSpanStart, kDefaultBin,
  kNumBins, kCatBase, kThreshold, kMissing, kPlanes
};
// the flags word, kernels/predict.py::FLAG_BITS
enum {
  kNanShift = 0, kMzShift = 9, kDefaultLeftBit = 18, kIsCatBit = 19,
  kBundledBit = 20, kWideBit = 21
};
constexpr unsigned kBinMask = 0x1ff;  // a 9-bit bin code; 0x1ff: none
constexpr int kNoBin16 = 0xffff;      // the missing plane's code of none
constexpr int kThrMask = 0x7fff;      // group_thr bits 16-30
// plan fields, kernels/predict.py::PREDICT_PLAN_FIELDS
enum {
  kRowsPerTile, kThreads, kTiles, kTreesPerStage, kBinsStride, kSmem
};
constexpr int kMaxThreads = 512;
// blocks of 512 threads an SM holds: at most 42 registers a thread
constexpr int kMinBlocks = 3;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory, sm_90
constexpr int kStageNodeBytes = 12;  // the two walk words, the leaf value

struct Args {
  const void* bins_T;        // (G, n) uint8, or uint16 (the `T` argument)
  const int32_t* planes;     // (kPlanes, T, L) packed nodes
  const float* leaf_value;   // (T, L)
  const uint32_t* cat_words;
  float* out;
  int64_t n;
  int G, T, L, max_depth, es_freq;
  float es_margin;
  int rows_per_tile, trees_per_stage, bins_stride;
  int vec_bins;              // bins copied in 16-byte chunks
};

// The leaf form's output: out[row * stride + col0 + t * col_step] for tree
// t of the launch.  A kernel parameter of its own, so that the score form's
// Args (copied to the stack for route_special) stay as they were.
struct LeafOut {
  int32_t* out;
  int64_t stride;
  int col0, col_step;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__host__ __device__ __forceinline__ int stage_bytes(int64_t trees, int L) {
  return static_cast<int>((kStageNodeBytes * trees * L + 15) / 16 * 16);
}

// The next node of a row at special node i of tree t (global index), given
// the row's bin of the node's group: c < L an internal node, c >= L leaf
// c - L.  Reads the node's other words from global memory.  T: the bin
// type (a 16-bit bin can equal the 9-bit code of none, 0x1ff).
template <class T>
__device__ __noinline__ int route_special(const Args& a, int t, int i,
                                          int gb) {
  const int32_t* w = a.planes + static_cast<int64_t>(t) * a.L + i;
  const int64_t plane = static_cast<int64_t>(a.T) * a.L;
  const unsigned f = static_cast<unsigned>(__ldg(w + kFlags * plane));
  const int left = __ldg(w + kLeft * plane);
  const int right = __ldg(w + kRight * plane);
  int fb = gb;
  if (f & (1u << kBundledBit)) {
    // EFB bundle: the span holds the feature's non-default bins
    const int ls = gb - __ldg(w + kSpanStart * plane);
    const int def = __ldg(w + kDefaultBin * plane);
    fb = (ls >= 0 && ls < __ldg(w + kNumBins * plane) - 1)
             ? ls + (ls >= def ? 1 : 0) : def;
  }
  if (f & (1u << kIsCatBit)) {
    // categorical: bin-domain bitset; missing flags never apply
    const uint32_t word =
        __ldg(a.cat_words + __ldg(w + kCatBase * plane) + (fb >> 5));
    return ((word >> (fb & 31)) & 1u) ? left : right;
  }
  int nan, mz, thr;
  if (f & (1u << kWideBit)) {
    // a threshold or missing bin too wide for the walk word and the flags
    const unsigned m = static_cast<unsigned>(__ldg(w + kMissing * plane));
    nan = (m & 0xffffu) == kNoBin16 ? -1 : static_cast<int>(m & 0xffffu);
    mz = (m >> 16) == kNoBin16 ? -1 : static_cast<int>(m >> 16);
    thr = __ldg(w + kThreshold * plane);
  } else {
    nan = static_cast<int>((f >> kNanShift) & kBinMask);
    mz = static_cast<int>((f >> kMzShift) & kBinMask);
    thr = (__ldg(w + kGroupThr * plane) >> 16) & kThrMask;
    if (sizeof(T) > 1) {
      nan = nan == static_cast<int>(kBinMask) ? -1 : nan;
      mz = mz == static_cast<int>(kBinMask) ? -1 : mz;
    }
  }
  const bool go_left = (fb == nan || fb == mz)
                           ? ((f >> kDefaultLeftBit) & 1u) != 0
                           : fb <= thr;
  return go_left ? left : right;
}

// grid: one block per tile of rows, one row a thread.  kTrees: trees
// staged in shared memory (else read from global memory); kBins: the
// tile's bins staged in shared memory (else read from global memory); T:
// the bin type; kLeaf: write each tree's leaf index instead of summing.
template <bool kTrees, bool kBins, class T, bool kLeaf>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
predict_kernel(const Args a, const LeafOut lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* bins_T = static_cast<const T*>(a.bins_T);
  const int L = a.L;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.rows_per_tile;
  const int64_t rows_left = a.n - r0;
  const int R = rows_left < a.rows_per_tile ? static_cast<int>(rows_left)
                                            : a.rows_per_tile;
  const int stride = a.bins_stride;  // bins a group
  T* sbins = reinterpret_cast<T*>(smem);
  unsigned char* stages =
      smem + (kBins ? a.G * stride * static_cast<int>(sizeof(T)) : 0);
  const int ts = kTrees ? a.trees_per_stage : a.T;
  const int sbytes = kTrees ? stage_bytes(ts, L) : 0;
  const int64_t plane = static_cast<int64_t>(a.T) * L;

  // the tile's bins: row r of group g at sbins[g * stride + r - r0]
  if (kBins) {
    // 16-byte chunks of a group's R bins (16 uint8 or 8 16-bit bins)
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    const int chunks = (R + kPer - 1) / kPer;
    if (a.vec_bins) {
      for (int k = threadIdx.x; k < a.G * chunks; k += blockDim.x) {
        const int g = k / chunks;
        const int c = k - g * chunks;
        cp_async16(sbins + g * stride + kPer * c,
                   bins_T + static_cast<int64_t>(g) * a.n + r0 + kPer * c,
                   static_cast<int>(sizeof(T)) * min(kPer, R - kPer * c));
      }
    } else {
      for (int k = threadIdx.x; k < a.G * R; k += blockDim.x) {
        const int g = k / R;
        const int r = k - g * R;
        sbins[g * stride + r] =
            __ldg(bins_T + static_cast<int64_t>(g) * a.n + r0 + r);
      }
    }
  }
  // stage s: trees [s * ts, min((s + 1) * ts, T)) into buffer s & 1: each
  // node's (children, group_thr) words side by side, then the leaf values,
  // which the leaf form never reads and does not stage
  auto issue = [&](int s) {
    const int t0 = s * ts;
    const int cnt = (min(t0 + ts, a.T) - t0) * L;
    int32_t* sw = reinterpret_cast<int32_t*>(stages + (s & 1) * sbytes);
    const int64_t base = static_cast<int64_t>(t0) * L;
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      cp_async4(sw + 2 * k, a.planes + kChildren16 * plane + base + k);
      cp_async4(sw + 2 * k + 1, a.planes + kGroupThr * plane + base + k);
      if (!kLeaf) cp_async4(sw + 2 * ts * L + k, a.leaf_value + base + k);
    }
  };
  const int n_stages = kTrees ? (a.T + ts - 1) / ts : 1;
  if (kTrees) issue(0);
  cp_async_commit();

  const int lr = threadIdx.x;       // the thread's row in the tile
  const int lq = min(lr, R - 1);    // ... clamped for loads
  bool live = lr < R;
  float score = 0.0f;
  for (int s = 0; s < n_stages; ++s) {
    if (kTrees && s + 1 < n_stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int t0 = s * ts;
    const int ns = min(t0 + ts, a.T) - t0;
    const int2* walk = nullptr;  // staged (children, group_thr) pairs
    const int32_t* ch = a.planes + kChildren16 * plane;
    const int32_t* gt = a.planes + kGroupThr * plane;
    const float* lv = a.leaf_value;
    if (kTrees) {
      walk = reinterpret_cast<const int2*>(stages + (s & 1) * sbytes);
      lv = reinterpret_cast<const float*>(walk + ts * L);
    }
    for (int tt = 0; tt < ns && live; ++tt) {
      const int tb = tt * L;  // the tree in the stage (global: t0 = 0)
      int nd = 0;
#pragma unroll 2
      for (int d = 0; d < a.max_depth && nd < L; ++d) {
        const int2 r = kTrees ? walk[tb + nd]
                              : make_int2(__ldg(ch + tb + nd),
                                          __ldg(gt + tb + nd));
        const int w = r.y;  // group | threshold bin << 16 | special << 31
        const int g = w & 0xffff;
        const int gb = kBins ? sbins[g * stride + lq]
                             : __ldg(bins_T + static_cast<int64_t>(g) *
                                     a.n + r0 + lq);
        if (w < 0) {
          nd = route_special<T>(a, t0 + tt, nd, gb);
        } else {
          // gb <= threshold bin, as (gb << 16) <= w: the group in w's low
          // half breaks no tie (16-bit bins: unsigned, a bin past 32 767
          // above every 15-bit threshold)
          const unsigned c = static_cast<unsigned>(r.x);
          bool left;
          if (sizeof(T) == 1)
            left = (gb << 16) <= w;
          else
            left = static_cast<unsigned>(gb) << 16 <=
                   static_cast<unsigned>(w);
          nd = left ? static_cast<int>(c & 0xffffu)
                    : static_cast<int>(c >> 16);
        }
      }
      if (kLeaf) {
        lo.out[(r0 + lr) * lo.stride + lo.col0 +
               static_cast<int64_t>(t0 + tt) * lo.col_step] =
            nd >= L ? nd - L : 0;
        continue;
      }
      const int leaf = tb + (nd >= L ? nd - L : 0);
      score += kTrees ? lv[leaf] : __ldg(lv + leaf);
      if (a.es_freq > 0 && (t0 + tt + 1) % a.es_freq == 0 &&
          2.0f * fabsf(score) > a.es_margin)
        live = false;
    }
    // every thread reaches this barrier; a block whose rows have all
    // stopped skips the rest
    if (!__syncthreads_or(live)) break;
  }
  cp_async_wait<0>();
  if (!kLeaf && lr < R) a.out[r0 + lr] = score;
}

bool plan_ok(const int64_t* q, int64_t n, int G, int T, int L,
             int bin_bytes) {
  if (q == nullptr) return false;
  const int64_t ts = q[kTreesPerStage];
  const int64_t stride = q[kBinsStride];
  const int64_t smem = G * stride * bin_bytes +
                       (ts > 0 ? 2LL * stage_bytes(ts, L) : 0);
  return q[kThreads] >= 32 && q[kThreads] <= kMaxThreads &&
         q[kThreads] % 32 == 0 &&
         q[kRowsPerTile] >= 16 && q[kRowsPerTile] % 16 == 0 &&
         q[kRowsPerTile] <= q[kThreads] &&
         q[kTiles] >= 1 && q[kTiles] <= INT_MAX &&
         q[kTiles] * q[kRowsPerTile] >= n &&
         (q[kTiles] - 1) * q[kRowsPerTile] < n &&
         ts >= 0 && ts <= T &&
         (stride == 0 || (stride >= q[kRowsPerTile] && stride % 16 == 0)) &&
         q[kSmem] == smem && q[kSmem] <= kMaxSmem;
}

template <bool kTrees, bool kBins, class T, bool kLeaf>
cudaError_t launch(const Args& a, const LeafOut& lo, const int64_t* q,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(q[kSmem]);
  cudaError_t err = cudaFuncSetAttribute(
      predict_kernel<kTrees, kBins, T, kLeaf>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  predict_kernel<kTrees, kBins, T, kLeaf>
      <<<static_cast<unsigned>(q[kTiles]), static_cast<unsigned>(q[kThreads]),
         smem, stream>>>(a, lo);
  return cudaGetLastError();
}

template <class T, bool kLeaf>
cudaError_t launch_of(const Args& a, const LeafOut& lo, const int64_t* q,
                      cudaStream_t stream) {
  const bool trees = q[kTreesPerStage] > 0, bins = q[kBinsStride] > 0;
  return trees ? (bins ? launch<true, true, T, kLeaf>(a, lo, q, stream)
                       : launch<true, false, T, kLeaf>(a, lo, q, stream))
               : (bins ? launch<false, true, T, kLeaf>(a, lo, q, stream)
                       : launch<false, false, T, kLeaf>(a, lo, q, stream));
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The Args of a launch of either form over checked operands, or false.
bool make_args(Args* a, const void* bins_T, int bin_bytes, int64_t n_rows,
               int G, const int32_t* nodes, const float* leaf_value,
               const int32_t* cat_words, int n_trees, int L, int max_depth,
               const int64_t* plan) {
  if ((bin_bytes != 1 && bin_bytes != 2) || n_rows < 1 || G < 1 ||
      n_trees < 1 || L < 1 || max_depth < 1 ||
      !plan_ok(plan, n_rows, G, n_trees, L, bin_bytes))
    return false;
  *a = Args{};
  a->bins_T = bins_T;
  a->planes = nodes;
  a->leaf_value = leaf_value;
  a->cat_words = reinterpret_cast<const uint32_t*>(cat_words);
  a->n = n_rows;
  a->G = G;
  a->T = n_trees;
  a->L = L;
  a->max_depth = max_depth;
  a->rows_per_tile = static_cast<int>(plan[kRowsPerTile]);
  a->trees_per_stage = static_cast<int>(plan[kTreesPerStage]);
  a->bins_stride = static_cast<int>(plan[kBinsStride]);
  // whole 16-byte chunks: each group's row run and the tile starts
  // 16-byte aligned (rows_per_tile is a multiple of 16)
  a->vec_bins = (n_rows * bin_bytes) % 16 == 0 && aligned(bins_T, 16);
  return true;
}

}  // namespace

// C interface, loaded with ctypes.  bins_T: (G, n_rows), bin_bytes 1
// (uint8) or 2 (16-bit) a bin; nodes: the (11, n_trees, L) int32 packed
// nodes; leaf_value:
// (n_trees, L) float32; plan: the host array of
// kernels/predict.py::predict_plan.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched;
// cudaErrorInvalidValue for a plan outside its limits or bad operands).
extern "C" int lgbt_predict_stream(const void* bins_T, int bin_bytes,
                                   int64_t n_rows, int G,
                                   const int32_t* nodes,
                                   const float* leaf_value,
                                   const int32_t* cat_words, int n_trees,
                                   int L, int max_depth, int es_freq,
                                   float es_margin, float* out,
                                   const int64_t* plan, cudaStream_t stream) {
  Args a;
  if (!make_args(&a, bins_T, bin_bytes, n_rows, G, nodes, leaf_value,
                 cat_words, n_trees, L, max_depth, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = out;
  a.es_freq = es_freq;
  a.es_margin = es_margin;
  const LeafOut none{};
  const cudaError_t err =
      bin_bytes == 2 ? launch_of<uint16_t, false>(a, none, plan, stream)
                     : launch_of<uint8_t, false>(a, none, plan, stream);
  return static_cast<int>(err);
}

// The leaf form: leaf_out[row * out_stride + col0 + t * col_step] = the
// leaf of tree t (of n_trees) that row reaches, int32; the other
// arguments as lgbt_predict_stream's.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error.
extern "C" int lgbt_predict_leaf(const void* bins_T, int bin_bytes,
                                 int64_t n_rows, int G, const int32_t* nodes,
                                 const float* leaf_value,
                                 const int32_t* cat_words, int n_trees,
                                 int L, int max_depth, int32_t* leaf_out,
                                 int64_t out_stride, int col0, int col_step,
                                 const int64_t* plan, cudaStream_t stream) {
  Args a;
  if (!make_args(&a, bins_T, bin_bytes, n_rows, G, nodes, leaf_value,
                 cat_words, n_trees, L, max_depth, plan) ||
      col0 < 0 || col_step < 1 ||
      col0 + static_cast<int64_t>(n_trees - 1) * col_step >= out_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const LeafOut lo{leaf_out, out_stride, col0, col_step};
  const cudaError_t err =
      bin_bytes == 2 ? launch_of<uint16_t, true>(a, lo, plan, stream)
                     : launch_of<uint8_t, true>(a, lo, plan, stream);
  return static_cast<int>(err);
}
