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
// column) and does one FMA, so at n = 1e5 the 35 MB of P's ELL arrays set a
// 0.0107 ms floor at 3.35 TB/s. The TPU kernel keeps v resident in VMEM; at
// n = 1e5 v is 400 KB, more than a block's 227 KB of shared memory, so here
// v is read through the read-only path (__ldg) from the 50 MB L2, which
// holds it whole.
//
// ell_matvec_kernel: a row is cut into units, 16 bytes (4 slots: one float4
// of values, one int4 of columns) when k % 4 == 0 and both arrays are
// 16-byte aligned, else one slot. G lanes share a row, G the fewest (a power
// of two, at most 32) that leave each lane at most 4 slots a round: at
// k = 44, 11 units of 4 slots, G = 16 lanes of one unit (5 idle); at k = 14
// (scalar), G = 4 lanes of up to 4 slots. Lane g takes the units g, g + G,
// ...: it first issues all its value and column loads of a round, then its
// 4 gathers of v, then its FMAs, where the previous kernel waited on each
// column before its gather. Neighbouring lanes read neighbouring units, so
// at k = 44 a warp's load covers two whole rows (352 contiguous bytes). The
// rule came from a sweep of the lanes a row (NVIDIA H100 80GB HBM3, 700 W;
// device time of back-to-back calls on one matrix, warm in L2): on config
// 4's P (k = 44) 16 lanes a row ran at 78 % of the bound, 8 at 72 %, 4 at
// 62 %, 32 at 59 %, so coalesced 16-byte loads matter more here than loads
// in flight a thread; with 4-byte units (A, k = 14), 4 lanes of up to 4
// slots ran 0.0041 ms, 16 lanes of one 0.0050 and the previous kernel
// 0.0053.
// The G lanes reduce by a fixed butterfly of shuffles and each lane sums its
// units in order, so a run is deterministic (the sum order is not the
// previous kernel's: the two agree to rounding).
//
// ell_matvec_prev_kernel: the kernel this one replaced (one sub-warp of L =
// min(32, the power of two >= k) lanes a row, one slot a lane per pass),
// kept as its witness and timing baseline; no solver launches it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

using i64 = long long;
constexpr int kThreads = 256;
constexpr int kMaxSlots = 4;  // slots a lane holds in a round

template <int V>
struct Unit;  // V slots of values and columns

template <>
struct Unit<1> {
  float v[1];
  int c[1];
  __device__ __forceinline__ void load(const float* vals, const int* cols, i64 u) {
    v[0] = __ldg(vals + u);
    c[0] = __ldg(cols + u);
  }
};

template <>
struct Unit<4> {
  float v[4];
  int c[4];
  __device__ __forceinline__ void load(const float* vals, const int* cols, i64 u) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(vals) + u);
    const int4 b = __ldg(reinterpret_cast<const int4*>(cols) + u);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    c[0] = b.x, c[1] = b.y, c[2] = b.z, c[3] = b.w;
  }
};

// V slots a unit, G lanes a row, J units a lane per round (the row's units
// = k / V; rounds of G J units until the row is done).
template <int V, int G, int J>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                  const float* __restrict__ v, float* __restrict__ y, int rows,
                  int k) {
  const i64 t = (i64)blockIdx.x * kThreads + threadIdx.x;
  const i64 r = t / G;
  const int lane = (int)(t % G);
  const int units = k / V;
  float acc = 0.0f;
  if (r < rows) {
    const i64 row0 = r * units;  // the row's first unit
    for (int base = lane; base < units; base += G * J) {
      Unit<V> u[J];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        const int q = base + G * i;
        if (q < units) {
          u[i].load(vals, cols, row0 + q);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) u[i].v[e] = 0.0f, u[i].c[e] = -1;
        }
      }
      float x[J][V];
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e)
          x[i][e] = u[i].c[e] >= 0 ? __ldg(v + u[i].c[e]) : 0.0f;
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (u[i].c[e] >= 0) acc = fmaf(u[i].v[e], x[i][e], acc);
    }
  }
  // Every lane of the warp takes part in the shuffles (rows past the end
  // hold 0); the width G keeps each row's sum to its lanes.
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
  if (r < rows && lane == 0) y[r] = acc;
}

template <int V, int G, int J>
int launch(const float* vals, const int* cols, const float* v, float* y,
           int rows, int k, cudaStream_t s) {
  const i64 threads = (i64)rows * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (blocks > 0)
    ell_matvec_kernel<V, G, J><<<blocks, kThreads, 0, s>>>(vals, cols, v, y, rows, k);
  return (int)cudaGetLastError();
}

// The lanes a row for `units` units of V slots: the fewest (a power of two,
// at most 32) that leave a lane at most kMaxSlots slots.
template <int V>
int lanes_for(int units) {
  int g = 1;
  while (g < 32 && g * (kMaxSlots / V) < units) g *= 2;
  return g;
}

template <int V, int G>
int launch_g(const float* vals, const int* cols, const float* v, float* y,
             int rows, int k, cudaStream_t s) {
  if constexpr (V == kMaxSlots) {
    return launch<V, G, 1>(vals, cols, v, y, rows, k, s);
  } else {
    const int per = (k / V + G - 1) / G;  // units a lane
    switch (per < 2 ? 1 : per > 4 ? 4 : per) {
      case 1: return launch<V, G, 1>(vals, cols, v, y, rows, k, s);
      case 2: return launch<V, G, 2>(vals, cols, v, y, rows, k, s);
      case 3: return launch<V, G, 3>(vals, cols, v, y, rows, k, s);
      default: return launch<V, G, 4>(vals, cols, v, y, rows, k, s);
    }
  }
}

template <int V>
int launch_v(const float* vals, const int* cols, const float* v, float* y,
             int rows, int k, cudaStream_t s) {
  switch (lanes_for<V>(k / V)) {
    case 1: return launch_g<V, 1>(vals, cols, v, y, rows, k, s);
    case 2: return launch_g<V, 2>(vals, cols, v, y, rows, k, s);
    case 4: return launch_g<V, 4>(vals, cols, v, y, rows, k, s);
    case 8: return launch_g<V, 8>(vals, cols, v, y, rows, k, s);
    case 16: return launch_g<V, 16>(vals, cols, v, y, rows, k, s);
    case 32: return launch_g<V, 32>(vals, cols, v, y, rows, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
ell_matvec_prev_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
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
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, L);
  if (r < rows && lane == 0) y[r] = acc;
}

template <int L>
int launch_prev(const float* vals, const int* cols, const float* v, float* y,
                int rows, int k, cudaStream_t s) {
  const i64 threads = (i64)rows * L;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  if (blocks > 0)
    ell_matvec_prev_kernel<L><<<blocks, kThreads, 0, s>>>(vals, cols, v, y, rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// vals: (rows, k) float32, cols: (rows, k) int32, both contiguous; v: the
// dense vector (every column index < its length); y: (rows,) float32.
extern "C" int qps_ell_matvec(const float* vals, const int* cols,
                              const float* v, float* y, int rows, int k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  return vec ? launch_v<4>(vals, cols, v, y, rows, k, s)
             : launch_v<1>(vals, cols, v, y, rows, k, s);
}

// The previous kernel, on the same arguments as qps_ell_matvec.
extern "C" int qps_ell_matvec_prev(const float* vals, const int* cols,
                                   const float* v, float* y, int rows, int k,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch_prev<1>(vals, cols, v, y, rows, k, s);
  if (k <= 2) return launch_prev<2>(vals, cols, v, y, rows, k, s);
  if (k <= 4) return launch_prev<4>(vals, cols, v, y, rows, k, s);
  if (k <= 8) return launch_prev<8>(vals, cols, v, y, rows, k, s);
  if (k <= 16) return launch_prev<16>(vals, cols, v, y, rows, k, s);
  return launch_prev<32>(vals, cols, v, y, rows, k, s);
}
