// Batch prediction over binned rows: every row walks every tree of one
// class and sums the leaf values in float32, in tree order.
//
// Replaces the TPU kernel lightgbm_tpu/pallas/predict_kernel.py
// `predict_stream` -> `_predict_kernel` (reference analog:
// src/boosting/gbdt_prediction.cpp PredictRaw, per-row loop over trees).
//
// Design (sm_90a, one thread per row):
//   * The TPU kernel advances a whole row block one tree level at a time with
//     a node-one-hot matmul, because the TPU has no fast gather.  Here each
//     thread chases its own row's pointers: node fields are read straight
//     from global memory, 64 bytes per node as four int4 loads.  At 500 trees
//     x 255 leaves the node tables are 8 MB and the leaf values 0.5 MB, so
//     the whole model stays resident in the 50 MB L2 after the first rows.
//   * The TPU tables digit-encode every field in 7 bits and store leaf values
//     as bf16 hi/lo pairs so that bf16 matmuls stay exact.  These tables are
//     plain int32, and the leaf values are the exact float32 values.  The sum
//     is therefore closer to the host float64 walk than the TPU kernel's, and
//     the two device kernels agree to a tolerance, not bit for bit.
//   * Bins are transposed (G, N) uint8 so that the threads of a warp read
//     neighbouring bytes when they sit at the same node.
//   * What bounds it: the bytes a call must move (bins + tables + output)
//     take far less time at the HBM rate than the operations the node
//     visits need (about 4 per visit on numeric data: bin address, compare,
//     child select, leaf test) at the card's core rate, so the bound is set
//     by operations; chip_smoke.py computes both from the visits of its run.
//     The kernel itself is held back by the walk being a chain of dependent
//     loads (node -> bin -> child) whose latency only the rows in flight
//     hide, and by the threads of a warp diverging to different nodes.  Its
//     times are in PERF.md; making it faster is later work.
//   * The depth loop is bounded by `max_depth`, so a malformed model cannot
//     hang the card; a row still on an internal node after max_depth steps
//     (a single-leaf tree) resolves to leaf 0, as the TPU kernel does.
//   * Binary prediction early stop: after every `es_freq` trees a row whose
//     margin 2|score| exceeds `es_margin` stops adding trees (reference:
//     prediction_early_stop.cpp CreateBinary); its score is final.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/predict.py::predict_stream_plain.  Both add the
// same float32 values in the same order, so they agree bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Node record: 16 int32 fields, in the order of NODE_FIELDS in
// lightgbm_torch/kernels/predict.py.
//   q0 = (group, span_start, default_bin, bundled)
//   q1 = (has_nan, nan_bin, has_mz, mz_bin)
//   q2 = (num_bins, threshold_bin, default_left, is_cat)
//   q3 = (left, right, cat_base, unused)
// Children: c >= 0 is an internal node, c >= L encodes leaf c - L.
constexpr int kInt4PerNode = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
predict_stream_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows,
                      const int4* __restrict__ nodes,
                      const float* __restrict__ leaf_value,
                      const uint32_t* __restrict__ cat_words, int n_trees,
                      int L, int max_depth, int es_freq, float es_margin,
                      float* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n_rows) return;
  float score = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const int4* tree = nodes + static_cast<int64_t>(t) * L * kInt4PerNode;
    int enc = 0;
    for (int d = 0; d < max_depth && enc < L; ++d) {
      const int4* nd = tree + static_cast<int64_t>(enc) * kInt4PerNode;
      const int4 q0 = __ldg(nd);
      const int4 q2 = __ldg(nd + 2);
      const int4 q3 = __ldg(nd + 3);
      const int gb = bins_T[static_cast<int64_t>(q0.x) * n_rows + row];
      int fb = gb;
      if (q0.w) {
        // EFB bundle: the span holds the feature's non-default bins
        const int ls = gb - q0.y;
        fb = (ls >= 0 && ls < q2.x - 1) ? ls + (ls >= q0.z ? 1 : 0) : q0.z;
      }
      bool go_left;
      if (q2.w) {
        // categorical: bin-domain bitset; missing flags never apply
        const uint32_t w = __ldg(cat_words + q3.z + (fb >> 5));
        go_left = (w >> (fb & 31)) & 1u;
      } else {
        const int4 q1 = __ldg(nd + 1);
        const bool missing = (q1.x && fb == q1.y) || (q1.z && fb == q1.w);
        go_left = missing ? (q2.z != 0) : (fb <= q2.y);
      }
      enc = go_left ? q3.x : q3.y;
    }
    const int leaf = enc >= L ? enc - L : 0;
    score += __ldg(leaf_value + static_cast<int64_t>(t) * L + leaf);
    if (es_freq > 0 && (t + 1) % es_freq == 0 &&
        2.0f * fabsf(score) > es_margin) {
      break;
    }
  }
  out[row] = score;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int lgbt_predict_stream(const uint8_t* bins_T, int64_t n_rows,
                                   const int32_t* nodes,
                                   const float* leaf_value,
                                   const int32_t* cat_words, int n_trees,
                                   int L, int max_depth, int es_freq,
                                   float es_margin, float* out,
                                   cudaStream_t stream) {
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  predict_stream_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      bins_T, n_rows, reinterpret_cast<const int4*>(nodes), leaf_value,
      reinterpret_cast<const uint32_t*>(cat_words), n_trees, L, max_depth,
      es_freq, es_margin, out);
  return static_cast<int>(cudaGetLastError());
}
