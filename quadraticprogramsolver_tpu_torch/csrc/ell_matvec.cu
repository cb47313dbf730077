// ELL sparse matrix-vector product: y[r] = sum_j vals[r, j] * v[cols[r, j]].
//
// Replaces the TPU kernel benchmarks/ell_kernel_probe.py:84 `kernel`
// (pallas_call at :91), the Pallas form of the JAX package's ELL matvec
// (core/sparse_problem.py:_ell_matvec). Every P, A and A' product of the
// large sparse solve runs it (core/sparse_problem.py: SparseQP).
//
// Layout: the JAX package's row-major (rows, k) ELL arrays, float32 values
// and int32 columns, padding slots with value 0 and column 0 (they read
// v[0] and add 0 * v[0]).
//
// What bounds it: bytes. Each slot is read once (8 bytes: a value and a
// column) and does one FMA, so at n = 1e5 the 36 MB of P's ELL arrays set a
// 0.011 ms floor at 3.35 TB/s. The TPU kernel keeps v resident in VMEM; at
// n = 1e5 v is 400 KB, more than a block's 227 KB of shared memory, so here
// v is read through the read-only path (__ldg) from the 50 MB L2, which
// holds it whole. One sub-warp of L lanes (L = 1..32, the smallest power of
// two >= k, at most 32) owns a row: neighbouring lanes read neighbouring
// slots of that row, so the (vals, cols) stream is coalesced (a thread per
// row would read with a stride of k). Each lane sums its slots j = lane,
// lane + L, ... in order, then the sub-warp reduces by a fixed butterfly of
// shuffles: no atomics, and a run is deterministic.

#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int kThreads = 256;

template <int L>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                  const float* __restrict__ v, float* __restrict__ y, int rows,
                  int k) {
  const i64 t = (i64)blockIdx.x * kThreads + threadIdx.x;
  const i64 r = t / L;
  const int lane = (int)(t % L);
  float acc = 0.0f;
  if (r < rows) {
    const float* vr = vals + r * k;
    const int* cr = cols + r * k;
    for (int j = lane; j < k; j += L)
      acc = fmaf(__ldg(vr + j), __ldg(v + __ldg(cr + j)), acc);
  }
  // Every lane of the warp takes part in the shuffles (rows past the end
  // hold 0); the width L keeps each sub-warp's sum to itself.
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, L);
  if (r < rows && lane == 0) y[r] = acc;
}

template <int L>
int launch(const float* vals, const int* cols, const float* v, float* y,
           int rows, int k, cudaStream_t s) {
  const i64 threads = (i64)rows * L;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (blocks > 0)
    ell_matvec_kernel<L><<<blocks, kThreads, 0, s>>>(vals, cols, v, y, rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// vals: (rows, k) float32, cols: (rows, k) int32, both contiguous; v: the
// dense vector (every column index < its length); y: (rows,) float32.
extern "C" int qps_ell_matvec(const float* vals, const int* cols,
                              const float* v, float* y, int rows, int k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(vals, cols, v, y, rows, k, s);
  if (k <= 2) return launch<2>(vals, cols, v, y, rows, k, s);
  if (k <= 4) return launch<4>(vals, cols, v, y, rows, k, s);
  if (k <= 8) return launch<8>(vals, cols, v, y, rows, k, s);
  if (k <= 16) return launch<16>(vals, cols, v, y, rows, k, s);
  return launch<32>(vals, cols, v, y, rows, k, s);
}
