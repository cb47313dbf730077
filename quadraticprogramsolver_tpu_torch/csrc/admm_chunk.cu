// Sigma-free ADMM chunk: K OSQP-ADMM iterations per active lane in one launch.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_admm.py:
// _chunk_kernel in its sigma-free, "highest"-precision, lanes=1,
// refine=0 variant. Per lane and iteration:
//
//   t  = rho * z - y
//   xx = G t - g                 G = M^{-1}A' (n x m), g = M^{-1}q
//   zz = A xx
//   x  = alpha*xx + (1-alpha)*x
//   z  = clip(alpha*zz + (1-alpha)*z + (1/rho)*y, l, u)
//   y  = y + rho*(alpha*zz + (1-alpha)*z_prev - z)
//
// Outputs x, z, y, x_prev, z_prev (the iterate at the start of the last
// iteration) and the check products A x and A'y. A frozen lane (active == 0)
// passes through with x_prev = x and z_prev = z, and its A x and A'y are
// still computed, exactly as on the TPU (fused_admm.py:129-135, 196-212).
//
// What bounds it on the H100: bytes. G and A are 512 KB each per lane at
// n=512, m=256, more than a CTA's 227 KB of shared memory, so each iteration
// streams them from device memory: 4.3 GB per iteration at B=4096, ~1.3 ms at
// 3.35 TB/s, against 2.1 GFLOP (far below the FP32 peak). Design: one CTA of
// 8 warps owns a lane and runs all K iterations in a loop; the vectors live
// in shared memory; G t and A xx read their matrix one row per warp with
// 16-byte coalesced loads and a shuffle reduction; __syncthreads() separates
// the two products. A'y is a column reduction, one thread per column. Each
// CTA reads its own lane's active flag (the TPU kernel's scalar prefetch).
// Keeping G resident across a cluster is later work.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// out(row) = sum_c M[row, c] * v[c] for row < rows; cols % 128 == 0.
template <typename Store>
__device__ __forceinline__ void warp_rows_dot(const float* __restrict__ M,
                                              int cols, const float* v,
                                              int rows, Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int c4n = cols / 4;
#pragma unroll 2
  for (int row = warp; row < rows; row += WARPS) {
    const float4* r4 = reinterpret_cast<const float4*>(M + (i64)row * cols);
    float s = 0.0f;
    for (int c4 = lane; c4 < c4n; c4 += 32) {
      const float4 a = __ldg(r4 + c4);
      const float4 b = v4[c4];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) store(row, s);
  }
}
}  // namespace

__global__ void __launch_bounds__(THREADS)
admm_chunk_kernel(const float* __restrict__ G, const float* __restrict__ A,
                  const float* __restrict__ g, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x_in, const float* __restrict__ z_in,
                  const float* __restrict__ y_in, const int* __restrict__ active,
                  float* __restrict__ xo, float* __restrict__ zo,
                  float* __restrict__ yo, float* __restrict__ xpo,
                  float* __restrict__ zpo, float* __restrict__ Axo,
                  float* __restrict__ ATyo, int n, int m, int K, float alpha) {
  extern __shared__ __align__(16) float sm[];
  float* x = sm;
  float* xp = x + n;
  float* xx = xp + n;
  float* gv = xx + n;
  float* z = gv + n;
  float* zp = z + m;
  float* y = zp + m;
  float* lo = y + m;
  float* up = lo + m;
  float* rh = up + m;
  float* tt = rh + m;
  float* zz = tt + m;

  const int b = blockIdx.x, tid = threadIdx.x;
  const i64 bn = (i64)b * n, bm = (i64)b * m;
  const float* Ab = A + bm * n;
  for (int i = tid; i < n; i += THREADS) {
    x[i] = x_in[bn + i];
    xp[i] = x[i];
    gv[i] = g[bn + i];
  }
  for (int r = tid; r < m; r += THREADS) {
    z[r] = z_in[bm + r];
    zp[r] = z[r];
    y[r] = y_in[bm + r];
    lo[r] = l[bm + r];
    up[r] = u[bm + r];
    rh[r] = rho[bm + r];
  }
  __syncthreads();

  if (active[b] != 0) {  // uniform over the CTA
    const float* Gb = G + bn * m;
    const float al = alpha, al1 = 1.0f - alpha;
    for (int it = 0; it < K; ++it) {
      for (int r = tid; r < m; r += THREADS) tt[r] = rh[r] * z[r] - y[r];
      __syncthreads();
      warp_rows_dot(Gb, m, tt, n, [&](int i, float s) { xx[i] = s - gv[i]; });
      __syncthreads();
      warp_rows_dot(Ab, n, xx, m, [&](int r, float s) { zz[r] = s; });
      __syncthreads();
      for (int i = tid; i < n; i += THREADS) {
        const float xprev = x[i];
        xp[i] = xprev;
        x[i] = al * xx[i] + al1 * xprev;
      }
      for (int r = tid; r < m; r += THREADS) {
        const float zprev = z[r];
        const float zr = al * zz[r] + al1 * zprev;
        const float zn = fminf(fmaxf(zr + (1.0f / rh[r]) * y[r], lo[r]), up[r]);
        zp[r] = zprev;
        y[r] = y[r] + rh[r] * (zr - zn);
        z[r] = zn;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += THREADS) {
    xo[bn + i] = x[i];
    xpo[bn + i] = xp[i];
  }
  for (int r = tid; r < m; r += THREADS) {
    zo[bm + r] = z[r];
    zpo[bm + r] = zp[r];
    yo[bm + r] = y[r];
  }
  warp_rows_dot(Ab, n, x, m, [&](int r, float s) { Axo[bm + r] = s; });
  for (int i = tid; i < n; i += THREADS) {
    float s = 0.0f;
    for (int r = 0; r < m; ++r) s = fmaf(__ldg(Ab + (i64)r * n + i), y[r], s);
    ATyo[bn + i] = s;
  }
}

// Contiguous f32: G (B, n, m), A (B, m, n), g/x (B, n), l/u/rho/z/y (B, m);
// active (B,) int32. n % 128 == 0, m % 128 == 0.
extern "C" int qps_admm_chunk(const float* G, const float* A, const float* g,
                              const float* l, const float* u, const float* rho,
                              const float* x, const float* z, const float* y,
                              const int* active, float* xo, float* zo, float* yo,
                              float* xpo, float* zpo, float* Axo, float* ATyo,
                              int B, int n, int m, int K, float alpha,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(4 * n + 8 * m) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        admm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_chunk_kernel<<<B, THREADS, smem, s>>>(G, A, g, l, u, rho, x, z, y, active,
                                              xo, zo, yo, xpo, zpo, Axo, ATyo, n,
                                              m, K, alpha);
  return (int)cudaGetLastError();
}
