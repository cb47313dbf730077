// Sigma-free prox-ALM chunk: K ProxQP iterations per active lane in one launch.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_proxqp.py:
// _chunk_kernel in its sigma-free, "highest"-precision, lanes=1, refine=0
// variant. Per lane, with one scalar rho (the TPU kernel's scalar prefetch)
// and G = [Ga | Gc] = M^{-1}[A' C'] (n x (me + mi)), g = M^{-1}q:
//
//   t_a = rho*b - y,   t_c = rho*(d - s) - z
//   x   = G [t_a; t_c] - g
//   s   = max(d - C x - (1/rho)*z, 0)
//   y   = y + rho*(A x - b)
//   z   = max(z + rho*(C x - d + s), 0)
//
// Outputs x, s, y, z. A frozen lane (active == 0) passes its inputs through
// bit for bit. The check products (Px, A'y, C'z, Ax, Cx) are not emitted:
// the solver computes them outside the kernel, as on the TPU.
//
// What bounds it on the H100: bytes. G, A and C are 512 KB, 256 KB and
// 256 KB per lane at n=512, me=mi=128, more than a CTA's 227 KB of shared
// memory, so each iteration streams them from device memory: 4.3 GB per
// iteration at B=4096, ~1.3 ms at 3.35 TB/s, against 2.1 GFLOP (far below
// the FP32 peak). Design (that of admm_chunk.cu): one CTA of 8 warps owns a
// lane and runs all K iterations in a loop; the vectors live in shared
// memory; G t, C x and A x read their matrix one row per warp with 16-byte
// coalesced loads and a shuffle reduction (common.cuh: warp_rows_dot), and
// __syncthreads() separates the dependent products. x is one row-dot over
// the concatenated t = [t_a; t_c], so Ga and Gc are one contiguous operand.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
}  // namespace

__global__ void __launch_bounds__(THREADS)
prox_chunk_kernel(const float* __restrict__ G, const float* __restrict__ A,
                  const float* __restrict__ C, const float* __restrict__ g,
                  const float* __restrict__ bvec, const float* __restrict__ dvec,
                  const float* __restrict__ rho, const float* __restrict__ x_in,
                  const float* __restrict__ s_in, const float* __restrict__ y_in,
                  const float* __restrict__ z_in, const int* __restrict__ active,
                  float* __restrict__ xo, float* __restrict__ so,
                  float* __restrict__ yo, float* __restrict__ zo, int n, int me,
                  int mi, int K) {
  extern __shared__ __align__(16) float sm[];
  const int mt = me + mi;
  float* x = sm;
  float* gv = x + n;
  float* t = gv + n;
  float* y = t + mt;
  float* bv = y + me;
  float* ax = bv + me;
  float* z = ax + me;
  float* s = z + mi;
  float* dv = s + mi;
  float* cx = dv + mi;

  const int lane = blockIdx.x, tid = threadIdx.x;
  const i64 bn = (i64)lane * n, be = (i64)lane * me, bi = (i64)lane * mi;
  for (int i = tid; i < n; i += THREADS) {
    x[i] = x_in[bn + i];
    gv[i] = g[bn + i];
  }
  for (int k = tid; k < me; k += THREADS) {
    y[k] = y_in[be + k];
    bv[k] = bvec[be + k];
  }
  for (int k = tid; k < mi; k += THREADS) {
    z[k] = z_in[bi + k];
    s[k] = s_in[bi + k];
    dv[k] = dvec[bi + k];
  }
  __syncthreads();

  if (active[lane] != 0) {  // uniform over the CTA
    const float* Gb = G + bn * mt;
    const float* Ab = A + be * n;
    const float* Cb = C + bi * n;
    const float r = rho[lane];
    const float rinv = 1.0f / r;
    for (int it = 0; it < K; ++it) {
      for (int k = tid; k < me; k += THREADS) t[k] = r * bv[k] - y[k];
      for (int k = tid; k < mi; k += THREADS) t[me + k] = r * (dv[k] - s[k]) - z[k];
      __syncthreads();
      qps::warp_rows_dot<WARPS>(Gb, mt, t, n,
                                [&](int i, float v) { x[i] = v - gv[i]; });
      __syncthreads();
      qps::warp_rows_dot<WARPS>(Cb, n, x, mi, [&](int k, float v) { cx[k] = v; });
      qps::warp_rows_dot<WARPS>(Ab, n, x, me, [&](int k, float v) { ax[k] = v; });
      __syncthreads();
      for (int k = tid; k < mi; k += THREADS) {
        const float sn = fmaxf(dv[k] - cx[k] - rinv * z[k], 0.0f);
        z[k] = fmaxf(z[k] + r * (cx[k] - dv[k] + sn), 0.0f);
        s[k] = sn;
      }
      for (int k = tid; k < me; k += THREADS) y[k] = y[k] + r * (ax[k] - bv[k]);
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += THREADS) xo[bn + i] = x[i];
  for (int k = tid; k < me; k += THREADS) yo[be + k] = y[k];
  for (int k = tid; k < mi; k += THREADS) {
    so[bi + k] = s[k];
    zo[bi + k] = z[k];
  }
}

// Contiguous f32: G (B, n, me + mi), A (B, me, n), C (B, mi, n), g/x (B, n),
// b/y (B, me), d/s/z (B, mi), rho (B,); active (B,) int32.
// n, me, mi multiples of 4 (the solver gives multiples of 128).
extern "C" int qps_prox_chunk(const float* G, const float* A, const float* C,
                              const float* g, const float* b, const float* d,
                              const float* rho, const float* x, const float* s,
                              const float* y, const float* z, const int* active,
                              float* xo, float* so, float* yo, float* zo, int B,
                              int n, int me, int mi, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(2 * n + 4 * me + 5 * mi) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prox_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  prox_chunk_kernel<<<B, THREADS, smem, st>>>(G, A, C, g, b, d, rho, x, s, y, z,
                                               active, xo, so, yo, zo, n, me, mi,
                                               K);
  return (int)cudaGetLastError();
}

// M^{-1}-form prox-ALM chunk with in-kernel refinement.
//
// Replaces the same TPU kernel (fused_proxqp.py: _chunk_kernel) in its
// M^{-1}-form, "highest", lanes=1 variant with refine >= 0 passes
// (fused_proxqp.py:45-53, 141-157). Per lane and iteration, with
// M = P + sigma*I + rho*(A'A + C'C) and its cached inverse Minv:
//
//   r = -q + sigma*x + A'(rho*b - y) + C'(rho*(d - s) - z)
//   x = Minv r
//   refine times:  x += Minv (r - (P x + sigma*x + rho*(A'(A x) + C'(C x))))
//   then the s, y, z updates of the sigma-free kernel above.
//
// Contraction: x = Minv r contracts Minv's second axis (row dots), as the
// solver's torch chunk does; see admm_chunk.cu.
//
// What bounds it on the H100: bytes. With refine = 1 an iteration reads Minv
// twice, P once, and A and C four times each: 5 MB per lane at n=512,
// me = mi = 128. Design: that of the sigma-free kernel (one CTA of 8 warps per
// lane for all K iterations, vectors in shared memory, every matrix streamed
// each time it is used), with the A' and C' products as column reductions
// (cols_dot). Frozen lanes pass their inputs through bit for bit.
__global__ void __launch_bounds__(THREADS)
prox_chunk_minv_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                       const float* __restrict__ C, const float* __restrict__ P,
                       const float* __restrict__ q, const float* __restrict__ bvec,
                       const float* __restrict__ dvec, const float* __restrict__ rho,
                       const float* __restrict__ x_in, const float* __restrict__ s_in,
                       const float* __restrict__ y_in, const float* __restrict__ z_in,
                       const int* __restrict__ active, float* __restrict__ xo,
                       float* __restrict__ so, float* __restrict__ yo,
                       float* __restrict__ zo, int n, int me, int mi, int K,
                       int refine, float sigma) {
  extern __shared__ __align__(16) float sm[];
  float* x = sm;
  float* qv = x + n;
  float* rhs = qv + n;
  float* wv = rhs + n;
  float* t = wv + n;          // [t_a (me) | t_c (mi)]
  float* y = t + me + mi;
  float* bv = y + me;
  float* ax = bv + me;
  float* z = ax + me;
  float* s = z + mi;
  float* dv = s + mi;
  float* cx = dv + mi;
  float* part = cx + mi;

  const int lane = blockIdx.x, tid = threadIdx.x;
  const i64 bn = (i64)lane * n, be = (i64)lane * me, bi = (i64)lane * mi;
  for (int i = tid; i < n; i += THREADS) {
    x[i] = x_in[bn + i];
    qv[i] = q[bn + i];
  }
  for (int k = tid; k < me; k += THREADS) {
    y[k] = y_in[be + k];
    bv[k] = bvec[be + k];
  }
  for (int k = tid; k < mi; k += THREADS) {
    z[k] = z_in[bi + k];
    s[k] = s_in[bi + k];
    dv[k] = dvec[bi + k];
  }
  __syncthreads();

  if (active[lane] != 0) {  // uniform over the CTA
    const float* Mb = Minv + bn * n;
    const float* Pb = refine > 0 ? P + bn * n : nullptr;
    const float* Ab = A + be * n;
    const float* Cb = C + bi * n;
    const float r = rho[lane];
    const float rinv = 1.0f / r;
    const float sg = sigma;
    for (int it = 0; it < K; ++it) {
      for (int k = tid; k < me; k += THREADS) t[k] = r * bv[k] - y[k];
      for (int k = tid; k < mi; k += THREADS) t[me + k] = r * (dv[k] - s[k]) - z[k];
      __syncthreads();
      qps::cols_dot<THREADS>(Ab, n, t, me, part, [&](int i, float v) {
        rhs[i] = (sg * x[i] - qv[i]) + v;
      });
      __syncthreads();
      qps::cols_dot<THREADS>(Cb, n, t + me, mi, part,
                             [&](int i, float v) { rhs[i] += v; });
      __syncthreads();
      qps::warp_rows_dot<WARPS>(Mb, n, rhs, n, [&](int i, float v) { x[i] = v; });
      __syncthreads();
      for (int pass = 0; pass < refine; ++pass) {
        qps::warp_rows_dot<WARPS>(Ab, n, x, me, [&](int k, float v) { ax[k] = v; });
        qps::warp_rows_dot<WARPS>(Cb, n, x, mi, [&](int k, float v) { cx[k] = v; });
        __syncthreads();
        qps::cols_dot<THREADS>(Ab, n, ax, me, part,
                               [&](int i, float v) { wv[i] = v; });
        __syncthreads();
        qps::cols_dot<THREADS>(Cb, n, cx, mi, part,
                               [&](int i, float v) { wv[i] += v; });
        __syncthreads();
        qps::warp_rows_dot<WARPS>(Pb, n, x, n, [&](int i, float v) {
          wv[i] = rhs[i] - ((v + sg * x[i]) + r * wv[i]);
        });
        __syncthreads();
        qps::warp_rows_dot<WARPS>(Mb, n, wv, n, [&](int i, float v) { x[i] += v; });
        __syncthreads();
      }
      qps::warp_rows_dot<WARPS>(Cb, n, x, mi, [&](int k, float v) { cx[k] = v; });
      qps::warp_rows_dot<WARPS>(Ab, n, x, me, [&](int k, float v) { ax[k] = v; });
      __syncthreads();
      for (int k = tid; k < mi; k += THREADS) {
        const float sn = fmaxf(dv[k] - cx[k] - rinv * z[k], 0.0f);
        z[k] = fmaxf(z[k] + r * (cx[k] - dv[k] + sn), 0.0f);
        s[k] = sn;
      }
      for (int k = tid; k < me; k += THREADS) y[k] = y[k] + r * (ax[k] - bv[k]);
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += THREADS) xo[bn + i] = x[i];
  for (int k = tid; k < me; k += THREADS) yo[be + k] = y[k];
  for (int k = tid; k < mi; k += THREADS) {
    so[bi + k] = s[k];
    zo[bi + k] = z[k];
  }
}

// Contiguous f32: Minv/P (B, n, n) (P read only when refine > 0, else may be
// null), A (B, me, n), C (B, mi, n), q/x (B, n), b/y (B, me), d/s/z (B, mi),
// rho (B,); active (B,) int32. n, me, mi multiples of 128.
extern "C" int qps_prox_chunk_minv(const float* Minv, const float* A,
                                   const float* C, const float* P,
                                   const float* q, const float* b,
                                   const float* d, const float* rho,
                                   const float* x, const float* s,
                                   const float* y, const float* z,
                                   const int* active, float* xo, float* so,
                                   float* yo, float* zo, int B, int n, int me,
                                   int mi, int K, int refine, float sigma,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(4 * n + 4 * me + 5 * mi +
                               qps::cols_dot_part(THREADS)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prox_chunk_minv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  prox_chunk_minv_kernel<<<B, THREADS, smem, st>>>(
      Minv, A, C, P, q, b, d, rho, x, s, y, z, active, xo, so, yo, zo, n, me, mi,
      K, refine, sigma);
  return (int)cudaGetLastError();
}
