// TreeSHAP contributions of every row over packed leaf paths, in float64.
//
// Replaces no pallas_call: the JAX package's device TreeSHAP is one jitted
// lax.scan over padded (L, D, N) path tensors in float32
// (lightgbm_tpu/shap.py:337 `_shap_device`; reference analog: the
// OpenMP-parallel GBDT::PredictContrib, gbdt.cpp:655, over
// src/io/tree.cpp TreeSHAP).  Its contract, in float64 throughout: for
// every row, tree and leaf, the decision of each node on the leaf's path
// (shap.py `_all_decisions`: float64 compare, NaN and zero-as-missing by
// the node's missing type, default left), each unique feature slot's one
// fraction (1 when every occurrence of its feature goes the row's way),
// the path polynomial extended over the slots (`_extend_path`), and each
// slot's unwound sum (`_unwound_path_sum`) times the leaf value added to
// phi[class][feature][row].  The host builds the tables
// (lightgbm_torch/shap.py::shap_tables).
//
// What bounds it on an H100: float64 operations.  A (row, leaf) of d
// unique slots extends the path polynomial in d (d + 1) / 2 steps and
// unwinds each slot the row goes the leaf's way ("hot") in d steps; the
// bytes (the rows once, the tables, the contributions) are a few MB.
//
// Design (sm_90a):
//   * One thread a row, 128 rows a block; the threads of a warp take the
//     trees and leaves in the same order, so every table read is one
//     broadcast word and every branch on a path length is uniform.
//   * No division: the small-integer factors of the extend and the
//     unwound sums come from one __constant__ table of kFactorTables x 25 x
//     25 float64 values, initialised at compile time from the ratios below
//     (kernels/tree_shap.py::shap_factors computes the same values), and
//     the division by a slot's zero fraction is the table's 1/z (rzfrac).  A
//     slot the row does not go ("cold") needs no loop of its own: its
//     unwound sum is (sum_j pw[j] (d + 1) / (d - j)) / z, one sum a
//     (row, leaf) scaled by 1/z.  Fused multiply-adds where they help.
//   * The path polynomial in registers: each leaf runs a body compiled for
//     its own number of slots d (a uniform branch picks it), every loop
//     over the slots unrolled, every index into `pw` and the factor table a
//     constant, and no step past d.  The kernel is a template on the
//     longest path it takes (8, 16 or 24 slots, chosen per launch from the
//     tables' depth), which bounds its bodies and registers.
//   * Each row's node decisions are computed once a tree (not once a path
//     occurrence) into 32-bit words in shared memory, a column per
//     thread, when the tree's nodes fit (kernels/tree_shap.py::shap_plan,
//     dec_words); else each occurrence decides from the node tables.  A
//     leaf's occurrences are unrolled, so their reads are all in flight
//     at once.
//   * Determinism without atomics, under any plan and any row chunking:
//     a tree's contributions are summed (leaf by leaf, slot by slot, from
//     0) into a per-tree accumulator, and phi adds the trees' sums in tree
//     order.  The accumulator is a column of shared memory a thread where
//     the features fit (shared_acc), else a (F, n) scratch in device
//     memory; it is added into phi at the end of each tree.  Where rows
//     are few the plan splits the trees into contiguous groups (grid y):
//     each tree's sum then goes to its own slice of a (T, F, n) partial
//     buffer (the accumulator itself, when it is not in shared memory),
//     and a second kernel adds the slices in tree order.  All give the
//     same bytes.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/tree_shap.py::tree_shap_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 24;          // slots of a path (its raw depth)
constexpr int kSpan = kMaxDepth + 1;   // a factor table's rows and columns
constexpr int kMaxDecBytes = 16 * 1024;  // decision words a block at most
constexpr int kMaxAccBytes = 32 * 1024;  // a block's accumulators at most

// factor tables, in the order of kernels/tree_shap.py::FACTOR_TABLES;
// entry [a][b] of table t at c_factor[(t * kSpan + a) * kSpan + b]
enum { kExtUp, kExtKeep, kHotUp, kHotNext, kColdUp, kFactorTables };

// plan fields, in the order of kernels/tree_shap.py::SHAP_PLAN_FIELDS
enum {
  kPlanThreads, kPlanTiles, kPlanGroups, kPlanTreesPerGroup, kPlanBucket,
  kPlanDecWords, kPlanSharedAcc, kPlanSmem, kPlanFields
};

// The ratios of a step b of a over the slots, each a correctly rounded
// division of small integers evaluated by the compiler; 0 outside b < a.
// tests/test_torch_shap_plan.py evaluates these lines against shap_factors.
#define EXT_UP(a, b) (((b) + 1.0) / ((a) + 1.0))
#define EXT_KEEP(a, b) (((a) - (b) + 0.0) / ((a) + 1.0))
#define HOT_UP(a, b) (((a) + 1.0) / ((b) + 1.0))
#define HOT_NEXT(a, b) (((a) - (b) + 0.0) / ((b) + 1.0))
#define COLD_UP(a, b) (((a) + 1.0) / ((a) - (b) + 0.0))
#define FACTOR_(t, a, b) ((b) < (a) ? t(a, b) : 0.0)
#define FACTOR_ROW_(t, a) \
    FACTOR_(t, a, 0), FACTOR_(t, a, 1), FACTOR_(t, a, 2), FACTOR_(t, a, 3), \
    FACTOR_(t, a, 4), FACTOR_(t, a, 5), FACTOR_(t, a, 6), FACTOR_(t, a, 7), \
    FACTOR_(t, a, 8), FACTOR_(t, a, 9), FACTOR_(t, a, 10), FACTOR_(t, a, 11), \
    FACTOR_(t, a, 12), FACTOR_(t, a, 13), FACTOR_(t, a, 14), \
    FACTOR_(t, a, 15), FACTOR_(t, a, 16), FACTOR_(t, a, 17), \
    FACTOR_(t, a, 18), FACTOR_(t, a, 19), FACTOR_(t, a, 20), \
    FACTOR_(t, a, 21), FACTOR_(t, a, 22), FACTOR_(t, a, 23), FACTOR_(t, a, 24)
#define FACTOR_TABLE_(t) \
    FACTOR_ROW_(t, 0), FACTOR_ROW_(t, 1), FACTOR_ROW_(t, 2), \
    FACTOR_ROW_(t, 3), FACTOR_ROW_(t, 4), FACTOR_ROW_(t, 5), \
    FACTOR_ROW_(t, 6), FACTOR_ROW_(t, 7), FACTOR_ROW_(t, 8), \
    FACTOR_ROW_(t, 9), FACTOR_ROW_(t, 10), FACTOR_ROW_(t, 11), \
    FACTOR_ROW_(t, 12), FACTOR_ROW_(t, 13), FACTOR_ROW_(t, 14), \
    FACTOR_ROW_(t, 15), FACTOR_ROW_(t, 16), FACTOR_ROW_(t, 17), \
    FACTOR_ROW_(t, 18), FACTOR_ROW_(t, 19), FACTOR_ROW_(t, 20), \
    FACTOR_ROW_(t, 21), FACTOR_ROW_(t, 22), FACTOR_ROW_(t, 23), \
    FACTOR_ROW_(t, 24)

__constant__ double c_factor[kFactorTables * kSpan * kSpan] = {
    FACTOR_TABLE_(EXT_UP), FACTOR_TABLE_(EXT_KEEP), FACTOR_TABLE_(HOT_UP),
    FACTOR_TABLE_(HOT_NEXT), FACTOR_TABLE_(COLD_UP)};

struct Args {
  const double* X_T;           // (F, n) rows, feature-major
  const int32_t* split_feature;  // (T, L - 1)
  const double* threshold;     // (T, L - 1)
  const int32_t* decision_type;  // (T, L - 1)
  const double* leaf_value;    // (T, L)
  const int32_t* tree_class;   // (T,)
  const int32_t* feat;         // (T, L, D)
  const double* zfrac;         // (T, L, D)
  const double* rzfrac;        // (T, L, D): 1 / zfrac, 0 where zfrac is 0
  const int32_t* occ;          // (T, L, D): node << 6 | slot << 1 | left
  const int32_t* plen;         // (T, L)
  double* acc;                 // (F, n) scratch, or (T, F, n) partials,
                               // unless the accumulators are in shared
                               // memory (then (T, F, n) partials or none)
  double* phi_T;               // (K, F + 1, n)
  int64_t n;
  int F, T, L, D;
  int groups, trees_per_group, dec_words;
};

// a factor whose row and column are both constants of the unrolled loops
__device__ __forceinline__ double factor(int t, int a, int b) {
  return c_factor[(t * kSpan + a) * kSpan + b];
}

// shap.py `_all_decisions`, numeric branch: does the row go left?
__device__ __forceinline__ bool goes_left(double v, double thr, int dt) {
  const int mt = (dt >> 2) & 3;
  const bool nan = isnan(v);
  const bool missing = nan || (mt == 1 && fabs(v) < 1e-35);
  if (missing && mt != 0) return (dt & 2) != 0;
  return (nan ? 0.0 : v) <= thr;
}

// One (row, leaf) of exactly D slots: extend the path polynomial over the
// slots, then add each slot's unwound sum times (o - z) times the leaf
// value to acc[feature].  `hot` has bit i set where slot i's one fraction
// is 1.  Every loop bound and factor index is a constant: `pw` lives in
// registers and the factors are constant-bank operands.
template <int D>
__device__ __forceinline__ void leaf_exact(const Args& a, int64_t base,
                                           uint32_t hot, double lv,
                                           double* acc, int64_t stride) {
  double pw[D + 1];
  pw[0] = 1.0;
  // pw[i + 1] += o pw[i] (i + 1) / (k + 1); pw[i] = z pw[i] (k - i) / (k + 1)
#pragma unroll
  for (int k = 1; k <= D; ++k) {
    const double z = __ldg(a.zfrac + base + k - 1);
    const bool o = (hot >> (k - 1)) & 1u;
    pw[k] = 0.0;
#pragma unroll
    for (int i = k - 1; i >= 0; --i) {
      if (o) pw[i + 1] = fma(factor(kExtUp, k, i), pw[i], pw[i + 1]);
      pw[i] = pw[i] * (z * factor(kExtKeep, k, i));
    }
  }
  // the cold slots' common sum: sum_j pw[j] (D + 1) / (D - j)
  constexpr uint32_t all = (1u << D) - 1u;
  double cold = 0.0;
  if ((hot & all) != all) {
#pragma unroll
    for (int j = D - 1; j >= 0; --j)
      cold = fma(pw[j], factor(kColdUp, D, j), cold);
  }
#pragma unroll 1
  for (int i = 0; i < D; ++i) {
    const double z = __ldg(a.zfrac + base + i);
    double total, o;
    if ((hot >> i) & 1u) {
      // total += u (D + 1) / (j + 1); u = pw[j] - u z (D - j) / (j + 1)
      double u = pw[D];
      total = 0.0;
#pragma unroll
      for (int j = D - 1; j >= 0; --j) {
        total = fma(u, factor(kHotUp, D, j), total);
        u = fma(-u, z * factor(kHotNext, D, j), pw[j]);
      }
      o = 1.0;
    } else {
      total = cold * __ldg(a.rzfrac + base + i);
      o = 0.0;
    }
    double* p = acc + static_cast<int64_t>(__ldg(a.feat + base + i)) * stride;
    *p = *p + (total * (o - z)) * lv;
  }
}

// A leaf of d slots (1 <= d <= MAXD, uniform across the warp) to the body
// compiled for exactly d
template <int MAXD, int D = 1>
__device__ __forceinline__ void leaf_shap(const Args& a, int64_t base, int d,
                                          uint32_t hot, double lv,
                                          double* acc, int64_t stride) {
  if (d == D) {
    leaf_exact<D>(a, base, hot, lv, acc, stride);
    return;
  }
  if constexpr (D < MAXD)
    leaf_shap<MAXD, D + 1>(a, base, d, hot, lv, acc, stride);
}

template <int MAXD, bool kSharedDec, bool kSharedAcc>
__global__ void __launch_bounds__(kThreads, MAXD <= 16 ? 6 : 4)
tree_shap_kernel(const Args a) {
  // [word][thread] decision words, then [feature][thread] accumulators
  extern __shared__ __align__(16) unsigned char smem[];
  double* acc_s = reinterpret_cast<double*>(smem);
  uint32_t* dec_s = reinterpret_cast<uint32_t*>(
      smem + (kSharedAcc ? static_cast<size_t>(8) * a.F * kThreads : 0));
  const int tid = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  if (row >= a.n) return;   // no barrier below: every thread on its own
  const int ni = a.L - 1;
  const int t0 = blockIdx.y * a.trees_per_group;
  const int t1 = min(a.T, t0 + a.trees_per_group);
  if (kSharedAcc)
    for (int f = 0; f < a.F; ++f) acc_s[f * kThreads + tid] = 0.0;
  for (int t = t0; t < t1; ++t) {
    const int64_t tn = static_cast<int64_t>(t) * ni;
    // this tree's sum, from 0: in shared memory, the scratch, or the
    // tree's partial slice
    double* partial = a.acc + row + static_cast<int64_t>(t) * a.F * a.n;
    double* acc = kSharedAcc ? acc_s + tid
                             : (a.groups > 1 ? partial : a.acc + row);
    const int64_t stride = kSharedAcc ? kThreads : a.n;
    if (kSharedDec) {
      for (int w = 0; w < a.dec_words; ++w) {
        uint32_t bits = 0;
        const int nb = min(32, ni - w * 32);
        for (int b = 0; b < nb; ++b) {
          const int64_t node = tn + w * 32 + b;
          const double v = __ldg(a.X_T + static_cast<int64_t>(
                                             __ldg(a.split_feature + node)) *
                                             a.n + row);
          bits |= static_cast<uint32_t>(goes_left(
                      v, __ldg(a.threshold + node),
                      __ldg(a.decision_type + node))) << b;
        }
        dec_s[w * kThreads + tid] = bits;
      }
    }
    for (int l = 0; l < a.L; ++l) {
      const int64_t tl = static_cast<int64_t>(t) * a.L + l;
      const int d = __ldg(a.plen + tl);
      if (d == 0) continue;
      const int64_t base = tl * a.D;
      // the slots whose every occurrence goes the row's way
      uint32_t hot = (1u << d) - 1u;
#pragma unroll
      for (int r = 0; r < MAXD; ++r) {
        const int w = r < a.D ? __ldg(a.occ + base + r) : -1;
        if (w >= 0) {
          const int node = w >> 6;
          bool left;
          if (kSharedDec) {
            left = (dec_s[(node >> 5) * kThreads + tid] >> (node & 31)) & 1u;
          } else {
            const double v = __ldg(a.X_T + static_cast<int64_t>(__ldg(
                                               a.split_feature + tn + node)) *
                                               a.n + row);
            left = goes_left(v, __ldg(a.threshold + tn + node),
                             __ldg(a.decision_type + tn + node));
          }
          if (left != ((w & 1) != 0)) hot &= ~(1u << ((w >> 1) & 31));
        }
      }
      leaf_shap<MAXD>(a, base, d, hot, __ldg(a.leaf_value + tl), acc,
                      stride);
    }
    if (a.groups == 1 || kSharedAcc) {
      // the tree's sum into phi (one group) or its partial slice; the
      // accumulator back to 0.  Adding +0.0 leaves phi as it is (phi is
      // never -0.0) and the slices start at 0, so only the sums that are
      // not 0 move, and a feature met twice moves once.
      double* to = a.groups > 1
                       ? partial
                       : a.phi_T + static_cast<int64_t>(__ldg(
                                       a.tree_class + t)) * (a.F + 1) * a.n +
                             row;
      const int m = a.F <= ni ? a.F : ni;
      for (int j = 0; j < m; ++j) {
        const int64_t f = a.F <= ni ? j : __ldg(a.split_feature + tn + j);
        const double s = acc[f * stride];
        if (s != 0.0) {
          to[f * a.n] = to[f * a.n] + s;
          acc[f * stride] = 0.0;
        }
      }
    }
  }
}

// phi[class t][f][row] += partial[t][f][row], in tree order
__global__ void __launch_bounds__(256)
tree_shap_sum_kernel(const double* __restrict__ partial,
                     const int32_t* __restrict__ tree_class,
                     double* __restrict__ phi_T, int64_t n, int F, int T) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t fn = static_cast<int64_t>(F) * n;
  if (i >= fn) return;
  const int64_t f = i / n;
  const int64_t row = i - f * n;
  for (int t = 0; t < T; ++t) {
    double* p = phi_T + (static_cast<int64_t>(__ldg(tree_class + t)) *
                             (F + 1) + f) * n + row;
    *p = *p + __ldg(partial + static_cast<int64_t>(t) * fn + i);
  }
}

template <int MAXD, bool kSharedDec>
void launch_acc(const Args& a, bool shared_acc, dim3 grid, int smem,
                cudaStream_t stream) {
  if (shared_acc)
    tree_shap_kernel<MAXD, kSharedDec, true>
        <<<grid, kThreads, smem, stream>>>(a);
  else
    tree_shap_kernel<MAXD, kSharedDec, false>
        <<<grid, kThreads, smem, stream>>>(a);
}

template <int MAXD>
cudaError_t launch(const Args& a, bool shared_acc, dim3 grid, int smem,
                   cudaStream_t stream) {
  if (a.dec_words > 0)
    launch_acc<MAXD, true>(a, shared_acc, grid, smem, stream);
  else
    launch_acc<MAXD, false>(a, shared_acc, grid, smem, stream);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  X_T: (n_features, n_rows) float64;
// the tables of kernels/tree_shap.py::ShapTables for n_trees trees of L
// leaf slots and D <= 24 path slots; acc: float64 zeros, (n_trees,
// n_features, n_rows) under a plan of several tree groups, else
// (n_features, n_rows) unless the plan keeps the accumulators in shared
// memory (then unread); phi_T: (num_class, n_features + 1, n_rows)
// float64, zeroed by the caller, the contributions added; plan: the host
// array of kernels/tree_shap.py::shap_plan.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 = launched;
// cudaErrorInvalidValue for operands or a plan out of range).
extern "C" int lgbt_tree_shap(const double* X_T, int64_t n_rows,
                              int n_features, const int32_t* split_feature,
                              const double* threshold,
                              const int32_t* decision_type,
                              const double* leaf_value,
                              const int32_t* tree_class, const int32_t* feat,
                              const double* zfrac, const double* rzfrac,
                              const int32_t* occ, const int32_t* plen,
                              int n_trees, int L, int D, int num_class,
                              double* acc, double* phi_T,
                              const int64_t* plan, cudaStream_t stream) {
  if (n_rows < 1 || n_features < 1 || n_trees < 1 || L < 2 || D < 1 ||
      D > kMaxDepth || num_class < 1 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n_rows + kThreads - 1) / kThreads;
  const int64_t groups = plan[kPlanGroups];
  const int64_t per = plan[kPlanTreesPerGroup];
  const int64_t bucket = plan[kPlanBucket];
  const int64_t words = plan[kPlanDecWords];
  const int64_t shared_acc = plan[kPlanSharedAcc];
  const int64_t need_words = (L - 1 + 31) / 32;
  const int64_t acc_bytes = 8LL * n_features * kThreads;
  if (plan[kPlanThreads] != kThreads || plan[kPlanTiles] != tiles ||
      tiles > 0x7fffffffLL || groups < 1 || groups > 65535 || per < 1 ||
      (groups - 1) * per >= n_trees || groups * per < n_trees ||
      (bucket != 8 && bucket != 16 && bucket != 24) || bucket < D ||
      (bucket > 8 && bucket - 8 >= D) ||
      (words != 0 && words != need_words) || words * kThreads * 4 >
      kMaxDecBytes || (shared_acc != 0 && shared_acc != 1) ||
      (shared_acc && acc_bytes > kMaxAccBytes) ||
      plan[kPlanSmem] != words * kThreads * 4 + shared_acc * acc_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.X_T = X_T;
  a.split_feature = split_feature;
  a.threshold = threshold;
  a.decision_type = decision_type;
  a.leaf_value = leaf_value;
  a.tree_class = tree_class;
  a.feat = feat;
  a.zfrac = zfrac;
  a.rzfrac = rzfrac;
  a.occ = occ;
  a.plen = plen;
  a.acc = acc;
  a.phi_T = phi_T;
  a.n = n_rows;
  a.F = n_features;
  a.T = n_trees;
  a.L = L;
  a.D = D;
  a.groups = static_cast<int>(groups);
  a.trees_per_group = static_cast<int>(per);
  a.dec_words = static_cast<int>(words);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  const int smem = static_cast<int>(plan[kPlanSmem]);
  cudaError_t err;
  if (bucket == 8)
    err = launch<8>(a, shared_acc, grid, smem, stream);
  else if (bucket == 16)
    err = launch<16>(a, shared_acc, grid, smem, stream);
  else
    err = launch<24>(a, shared_acc, grid, smem, stream);
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const int64_t fn = static_cast<int64_t>(n_features) * n_rows;
  const int64_t blocks = (fn + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tree_shap_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      acc, tree_class, phi_T, n_rows, n_features, n_trees);
  return static_cast<int>(cudaGetLastError());
}
