// Route-level SpMV: out[g, l] = sum_t sum_s V[g, t, s, l] * X[s, idx[g, t, s, l]].
//
// Replaces two TPU kernels of benchmarks/routed_spmv_probe.py:
//   * `kern` (:189-192, pallas_call at :195), the square take_along_axis
//     micro kernel: one level (T = 1), out[g, l] = sum_s V[g,s,l] X[s, idx];
//   * `route_kernel` (:299-304, pallas_call at :310), the route-level
//     matvec: T levels per group of W output rows, X[s, j] = x[j*S + s].
// Both are this kernel; the micro kernel is its T = 1 case.
//
// The probe's platform verdict (:23-46: Mosaic refuses lane gathers whose
// index shape differs from the source's and crashes on square shuffles
// wider than 128 lanes) has no counterpart here: a thread gathers from any
// column of X, so every (S, W, G) of the probe runs.
//
// What bounds it: bytes. Every slot (g, t, s, l) is read once (an int32
// index and a float32 value, 8 bytes) and does one FMA; X (S x Wx floats,
// 400 KB at n = 1e5) is gathered through the read-only path from L2. One
// thread owns an output (g, l): neighbouring threads read neighbouring l of
// each (t, s) row, so the slot stream is coalesced. It sums in the TPU
// kernel's order: over s into a level's partial sum, then the levels
// into the output in t order. No atomics; a run is deterministic.

#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
routed_levels_kernel(const float* __restrict__ X, const int* __restrict__ idx,
                     const float* __restrict__ V, float* __restrict__ out,
                     int G, int T, int S, int W, int Wx) {
  const i64 o = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (o >= (i64)G * W) return;
  const i64 g = o / W;
  const int l = (int)(o % W);
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const i64 base = (g * T + t) * S * (i64)W + l;
    float part = 0.0f;
    for (int s = 0; s < S; ++s) {
      const i64 slot = base + (i64)s * W;
      part = fmaf(__ldg(V + slot), __ldg(X + (i64)s * Wx + __ldg(idx + slot)),
                  part);
    }
    acc += part;
  }
  out[o] = acc;
}

}  // namespace

// X: (S, Wx) float32; idx, V: (G, T, S, W) int32 / float32 (every index in
// [0, Wx)); out: (G, W) float32. All contiguous.
extern "C" int qps_routed_levels(const float* X, const int* idx, const float* V,
                                 float* out, int G, int T, int S, int W, int Wx,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 outputs = (i64)G * W;
  const int blocks = (int)((outputs + kThreads - 1) / kThreads);
  if (blocks > 0)
    routed_levels_kernel<<<blocks, kThreads, 0, s>>>(X, idx, V, out, G, T, S,
                                                     W, Wx);
  return (int)cudaGetLastError();
}
