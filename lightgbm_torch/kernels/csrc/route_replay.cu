// Route replay: every row's leaf after a tree's growth rounds.  Starting
// from leaf 0, apply the R stored rounds of per-leaf route records in
// order to each row and write the row's final leaf once.
//
// Replaces the TPU kernel lightgbm_tpu/pallas/stream_kernel.py
// `route_replay` -> `_route_replay_kernel` (the GOSS/bagging route fusion
// of lightgbm_tpu/ops/grow.py:1562-1585).  A sampled tree grows on the
// compacted in-bag rows; this one launch gives every row its leaf for the
// score update, where the unfused path runs one route-only pass of the
// growth kernel over all rows per round.
//
// Design (sm_90a, one thread per row, its leaf id in a register):
//   * Per round the thread reads its leaf's 64-byte int32 record
//     (lightgbm_torch/kernels/layout.py ROUTE_FIELDS) as int4 loads through
//     the read-only cache: the first quad alone when the leaf is not split
//     that round, three when it is.  A round's records are 16 KB at 255
//     leaves and every block reads the same few, so they stay in L1/L2.
//   * A split leaf's row reads one byte, its bin in the split's group
//     column of the (G, N) uint8 bins (neighbouring threads, neighbouring
//     bytes when they split on the same group), unbundles an EFB bin, sends
//     NaN / zero-as-missing bins (-1 = none) the default way and any other
//     bin left when it is at most the threshold.  Only the numeric decision:
//     the grower keeps categorical trees off this path, as the reference
//     does.  The TPU's one-hot table matmul over 7-bit digits is not
//     carried over; it is a plain indexed load here.
//   * What bounds it: the bytes the rows need, 4 B of leaf id written per
//     row plus one byte per distinct group on its path (~10 MB at 1M rows
//     and 9 rounds, a few microseconds at 3.35 TB/s).  This first version
//     re-reads a bin a row read in an earlier round and stages no records
//     in shared memory; its times are in PERF.md.
//   * A leaf id outside [0, L) in the records stops the row at -1.
//
// Plain PyTorch version of the same contract:
// lightgbm_torch/kernels/route_replay.py::route_replay_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// route record fields (kernels/layout.py ROUTE_FIELDS), as four int4:
//   q0 = (chosen, new_id, group, span_start)
//   q1 = (default_bin, bundled, nan_bin, mz_bin)
//   q2 = (num_bins, threshold, default_left, is_cat)
//   q3 = (slot_left, slot_right, slot_keep, unused)   -- not read here
__global__ void __launch_bounds__(kThreads)
route_replay_kernel(const uint8_t* __restrict__ bins_T, int64_t n_rows,
                    const int4* __restrict__ tabs, int R, int L,
                    int32_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n_rows) return;
  int lid = 0;
  for (int r = 0; r < R; ++r) {
    const int4* rec = tabs + (static_cast<int64_t>(r) * L + lid) * 4;
    const int4 q0 = __ldg(rec);
    if (!q0.x) continue;
    const int4 q1 = __ldg(rec + 1);
    const int4 q2 = __ldg(rec + 2);
    const int gb = __ldg(bins_T + static_cast<int64_t>(q0.z) * n_rows + row);
    int fb = gb;
    if (q1.y) {
      // EFB bundle: the span holds the feature's non-default bins
      const int ls = gb - q0.w;
      fb = (ls >= 0 && ls < q2.x - 1) ? ls + (ls >= q1.x ? 1 : 0) : q1.x;
    }
    const bool missing = fb == q1.z || fb == q1.w;
    const bool go_left = missing ? (q2.z != 0) : (fb <= q2.y);
    if (!go_left) {
      lid = q0.y;
      if (lid < 0 || lid >= L) {
        lid = -1;
        break;
      }
    }
  }
  out[row] = lid;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).  tabs holds
// R x L records of 16 int32.
extern "C" int lgbt_route_replay(const uint8_t* bins_T, int64_t n_rows,
                                 const int32_t* tabs, int R, int L,
                                 int32_t* out, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  route_replay_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(bins_T, n_rows,
                                  reinterpret_cast<const int4*>(tabs), R, L,
                                  out);
  return static_cast<int>(cudaGetLastError());
}
