// The score update's gather: out[n] = values[leaf_id[n]].
//
// Replaces the TPU kernel lightgbm_tpu/pallas/stream_kernel.py
// `leaf_gather` -> `_leaf_gather_kernel` (reference analog:
// src/boosting/score_updater.hpp ScoreUpdater::AddScore).
//
// Design (sm_90a, one thread per row): the TPU forms each output as a
// one-hot (L, T) float32 contraction, because XLA's generic gather over
// millions of rows is slow there; one product is 1.0 x value, so it is
// exact.  Here each thread loads its leaf id and the value through the
// read-only cache: the (<= a few thousand) leaf values stay resident in L1,
// so the kernel moves the leaf ids in and the values out, 8 bytes per row,
// and is bound by that (8 MB, ~2.4 us at 1M rows and 3.35 TB/s).  The copy
// is exact, so it equals its plain version values[leaf_id] bit for bit.
// The score add stays a separate float32 add in the caller, in the same
// order on every device.  A leaf id outside [0, L) gives 0.
//
// Plain PyTorch version: lightgbm_torch/kernels/leaf_gather.py::
// leaf_gather_plain.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
leaf_gather_kernel(const int32_t* __restrict__ leaf_id, int64_t n,
                   const float* __restrict__ values, int L,
                   float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int lid = __ldg(leaf_id + i);
  out[i] = (lid >= 0 && lid < L) ? __ldg(values + lid) : 0.0f;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int lgbt_leaf_gather(const int32_t* leaf_id, int64_t n,
                                const float* values, int L, float* out,
                                cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  leaf_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      leaf_id, n, values, L, out);
  return static_cast<int>(cudaGetLastError());
}
