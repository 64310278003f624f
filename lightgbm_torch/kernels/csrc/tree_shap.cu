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
// unique slots takes about 8 d^2 of them (the extend's d(d+1)/2 steps and
// the unwound sums' d^2), against 8 bytes read for each of its path
// occurrences (from L1: every row of a warp reads the same table word) and
// of each row's features (once a row, from device memory).
//
// Design (simple first): one thread a row, 128 rows a block.  The threads
// of a warp take the trees and leaves in the same order, so every table
// read is one broadcast word and every feature read of the row-major
// X_T (F, N) is coalesced.  The row's path polynomial lives in a 25-double
// local array (L1).  The row's phi is owned by its thread (phi_T is
// (K, F + 1, N), so a warp's adds are coalesced): no atomics, and a
// repeated call gives the same bytes.  Every add, multiply and divide is
// an explicit round-to-nearest intrinsic (no fused multiply-add), in the
// host walk's order of operations, so that a (row, leaf) computes the same
// float64 values as the plain version.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/tree_shap.py::tree_shap_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 24;          // slots of a path (its raw depth)

struct Args {
  const double* X_T;           // (F, n) rows, feature-major
  const int32_t* split_feature;  // (T, L - 1)
  const double* threshold;     // (T, L - 1)
  const int32_t* decision_type;  // (T, L - 1)
  const double* leaf_value;    // (T, L)
  const int32_t* tree_class;   // (T,)
  const int32_t* feat;         // (T, L, D)
  const double* zfrac;         // (T, L, D)
  const int32_t* occ;          // (T, L, D): node << 6 | slot << 1 | left
  const int32_t* plen;         // (T, L)
  double* phi_T;               // (K, F + 1, n)
  int64_t n;
  int F, T, L, D;
};

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double ddiv(double a, double b) {
  return __ddiv_rn(a, b);
}

// shap.py `_all_decisions`, numeric branch: does the row go left?
__device__ __forceinline__ bool goes_left(double v, double thr, int dt) {
  const int mt = (dt >> 2) & 3;
  const bool nan = isnan(v);
  const bool missing = nan || (mt == 1 && fabs(v) < 1e-35);
  if (missing && mt != 0) return (dt & 2) != 0;
  return (nan ? 0.0 : v) <= thr;
}

__global__ void __launch_bounds__(kThreads)
tree_shap_kernel(const Args a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= a.n) return;
  const int ni = a.L - 1;
  double pw[kMaxDepth + 1];
  for (int t = 0; t < a.T; ++t) {
    double* phi = a.phi_T + static_cast<int64_t>(__ldg(a.tree_class + t)) *
                                (a.F + 1) * a.n + row;
    const int64_t tn = static_cast<int64_t>(t) * ni;
    for (int l = 0; l < a.L; ++l) {
      const int64_t tl = static_cast<int64_t>(t) * a.L + l;
      const int d = __ldg(a.plen + tl);
      if (d == 0) continue;
      const int64_t base = tl * a.D;
      // the slots whose every occurrence goes the row's way
      uint32_t hot = (1u << d) - 1u;
      for (int r = 0; r < a.D; ++r) {
        const int w = __ldg(a.occ + base + r);
        if (w < 0) break;
        const int node = w >> 6;
        const int f = __ldg(a.split_feature + tn + node);
        const double v = __ldg(a.X_T + static_cast<int64_t>(f) * a.n + row);
        const bool left = goes_left(v, __ldg(a.threshold + tn + node),
                                    __ldg(a.decision_type + tn + node));
        if (left != ((w & 1) != 0)) hot &= ~(1u << ((w >> 1) & 31));
      }
      // extend the path polynomial: the root's dummy element, then the
      // slots in order (shap.py `_extend_path`)
      pw[0] = 1.0;
      for (int k = 1; k <= d; ++k) {
        const double z = __ldg(a.zfrac + base + k - 1);
        const double o = ((hot >> (k - 1)) & 1u) ? 1.0 : 0.0;
        const double dp1 = static_cast<double>(k + 1);
        pw[k] = 0.0;
        for (int i = k - 1; i >= 0; --i) {
          const double up = dmul(dmul(o, pw[i]), static_cast<double>(i + 1));
          pw[i + 1] = dadd(pw[i + 1], ddiv(up, dp1));
          pw[i] = ddiv(dmul(dmul(z, pw[i]), static_cast<double>(k - i)),
                       dp1);
        }
      }
      // each slot's unwound sum times the leaf value (`_unwound_path_sum`)
      const double lv = __ldg(a.leaf_value + tl);
      const double dp1 = static_cast<double>(d + 1);
      for (int i = 0; i < d; ++i) {
        const double z = __ldg(a.zfrac + base + i);
        const double o = ((hot >> i) & 1u) ? 1.0 : 0.0;
        double next_one = pw[d];
        double total = 0.0;
        for (int j = d - 1; j >= 0; --j) {
          const double q = ddiv(static_cast<double>(d - j), dp1);
          if (o != 0.0) {
            const double tmp = ddiv(dmul(next_one, dp1),
                                   dmul(static_cast<double>(j + 1), o));
            total = dadd(total, tmp);
            next_one = dsub(pw[j], dmul(dmul(tmp, z), q));
          } else if (z != 0.0) {
            total = dadd(total, ddiv(ddiv(pw[j], z), q));
          }
        }
        const int f = __ldg(a.feat + base + i);
        double* p = phi + static_cast<int64_t>(f) * a.n;
        *p = dadd(*p, dmul(dmul(total, dsub(o, z)), lv));
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  X_T: (n_features, n_rows) float64;
// the tables of kernels/tree_shap.py::ShapTables for n_trees trees of L
// leaf slots and D <= 24 path slots; phi_T: (num_class, n_features + 1,
// n_rows) float64, zeroed by the caller, the contributions added.
// Launches on `stream`, does not synchronise, and returns the first CUDA
// error (0 = launched; cudaErrorInvalidValue for operands out of range).
extern "C" int lgbt_tree_shap(const double* X_T, int64_t n_rows,
                              int n_features, const int32_t* split_feature,
                              const double* threshold,
                              const int32_t* decision_type,
                              const double* leaf_value,
                              const int32_t* tree_class, const int32_t* feat,
                              const double* zfrac, const int32_t* occ,
                              const int32_t* plen, int n_trees, int L, int D,
                              int num_class, double* phi_T,
                              cudaStream_t stream) {
  if (n_rows < 1 || n_features < 1 || n_trees < 1 || L < 2 || D < 1 ||
      D > kMaxDepth || num_class < 1 ||
      (n_rows + kThreads - 1) / kThreads > 0x7fffffffLL)
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
  a.occ = occ;
  a.plen = plen;
  a.phi_T = phi_T;
  a.n = n_rows;
  a.F = n_features;
  a.T = n_trees;
  a.L = L;
  a.D = D;
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kThreads - 1) / kThreads);
  tree_shap_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
