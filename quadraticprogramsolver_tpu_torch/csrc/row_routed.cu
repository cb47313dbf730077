// Row-routed SpMV rows: rows[r, k] = V[r, k] * Xw[r / L, idx[r, k]].
//
// Replaces the TPU kernel benchmarks/row_routed_probe.py:204-209
// `route_kernel` (pallas_call at :240): the tall same-width lane shuffle of
// the row-routed format, where row r of the packed matrix belongs to source
// window r / L of the grid Xw[a, j] = x[a*Wd + j] and lane k of it routes
// x[a*Wd + idx[r, k]] to output lane k, times the nnz value V[r, k]. The sum
// of the rows into their output blocks (the probe's one-hot MXU product,
// :256-265) stays outside the kernel, as in the probe
// (ops/routed_spmv.py: row_routed_matvec).
//
// The probe pads L to a divisor of its 1568-row grid step (:187, 210-236),
// a Mosaic tiling need: here each thread finds its window as r / L, so no
// padding layers are made.
//
// What bounds it: bytes. Each element reads an index and a value and writes
// one product (12 bytes); Xw (400 KB at n = 1e5) is gathered through the
// read-only path from L2. One thread per element, neighbouring threads on
// neighbouring lanes of a row: coalesced. One multiply, so the result is bit
// for bit the plain version's.

#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_routed_kernel(const float* __restrict__ Xw, const int* __restrict__ idx,
                  const float* __restrict__ V, float* __restrict__ rows, i64 R,
                  int Wd, int L) {
  const i64 e = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (e >= R * Wd) return;
  const i64 r = e / Wd;
  rows[e] = __ldg(V + e) * __ldg(Xw + (r / L) * Wd + __ldg(idx + e));
}

}  // namespace

// Xw: (n_win, Wd) float32 with R <= n_win * L; idx, V: (R, Wd) int32 /
// float32 (every index in [0, Wd)); rows: (R, Wd) float32. All contiguous.
extern "C" int qps_row_routed(const float* Xw, const int* idx, const float* V,
                              float* rows, long long R, int Wd, int L,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 elems = R * Wd;
  const i64 blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > 0)
    row_routed_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(Xw, idx, V, rows, R,
                                                            Wd, L);
  return (int)cudaGetLastError();
}
