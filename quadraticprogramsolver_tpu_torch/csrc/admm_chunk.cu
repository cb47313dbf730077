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
      qps::warp_rows_dot<WARPS>(Gb, m, tt, n,
                                [&](int i, float s) { xx[i] = s - gv[i]; });
      __syncthreads();
      qps::warp_rows_dot<WARPS>(Ab, n, xx, m, [&](int r, float s) { zz[r] = s; });
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
  qps::warp_rows_dot<WARPS>(Ab, n, x, m, [&](int r, float s) { Axo[bm + r] = s; });
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

// M^{-1}-form ADMM chunk with in-kernel refinement.
//
// Replaces the same TPU kernel (fused_admm.py: _chunk_kernel) in its
// M^{-1}-form, "highest", lanes=1 variant with refine >= 0 passes
// (fused_admm.py:71-79, 167-178). Per lane and iteration, with
// M = P + sigma*I + A' diag(rho) A and its cached inverse Minv:
//
//   rhs = sigma*x - q + A'(rho*z - y)
//   xx  = Minv rhs
//   refine times:  xx += Minv (rhs - (P xx + sigma*xx + A'(rho * A xx)))
//   zz  = A xx,  then the x, z, y updates of the sigma-free kernel above.
//
// Contraction: xx = Minv rhs contracts Minv's SECOND axis (row dots), as the
// solver's torch chunk does (models/kkt.py: matvec(M_inv, b)); the TPU kernel
// contracts the first axis (rhs Minv). The sweep's inverse is symmetric only
// to rounding, so the plain version (ops/fused_admm.py) uses this kernel's
// contraction. P is symmetric, so P xx is a row dot either way.
//
// What bounds it on the H100: bytes. With refine = 1 an iteration reads Minv
// twice, P once and A four times (A' t, A xx twice, A'(rho A xx)): 5 MB per
// lane at n=512, m=256, ~10.7 GB per iteration at B=2048, against ~10 MFLOP a
// lane. Design: that of the sigma-free kernel, one CTA of 8 warps per lane for
// all K iterations, vectors in shared memory, every matrix streamed from
// device memory each time it is used: row products one warp per row
// (warp_rows_dot), A' products as column reductions with 16-byte loads
// (cols_dot). Keeping Minv and P on chip across a cluster is later work.
__global__ void __launch_bounds__(THREADS)
admm_chunk_minv_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                       const float* __restrict__ P, const float* __restrict__ q,
                       const float* __restrict__ l, const float* __restrict__ u,
                       const float* __restrict__ rho, const float* __restrict__ x_in,
                       const float* __restrict__ z_in, const float* __restrict__ y_in,
                       const int* __restrict__ active, float* __restrict__ xo,
                       float* __restrict__ zo, float* __restrict__ yo,
                       float* __restrict__ xpo, float* __restrict__ zpo,
                       float* __restrict__ Axo, float* __restrict__ ATyo, int n,
                       int m, int K, int refine, float alpha, float sigma) {
  extern __shared__ __align__(16) float sm[];
  float* x = sm;
  float* xp = x + n;
  float* xx = xp + n;
  float* rhs = xx + n;
  float* qv = rhs + n;
  float* wv = qv + n;
  float* z = wv + n;
  float* zp = z + m;
  float* y = zp + m;
  float* lo = y + m;
  float* up = lo + m;
  float* rh = up + m;
  float* tt = rh + m;
  float* zz = tt + m;
  float* part = zz + m;

  const int b = blockIdx.x, tid = threadIdx.x;
  const i64 bn = (i64)b * n, bm = (i64)b * m;
  const float* Ab = A + bm * n;
  for (int i = tid; i < n; i += THREADS) {
    x[i] = x_in[bn + i];
    xp[i] = x[i];
    qv[i] = q[bn + i];
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
    const float* Mb = Minv + bn * n;
    const float* Pb = refine > 0 ? P + bn * n : nullptr;
    const float al = alpha, al1 = 1.0f - alpha, sg = sigma;
    for (int it = 0; it < K; ++it) {
      for (int r = tid; r < m; r += THREADS) tt[r] = rh[r] * z[r] - y[r];
      __syncthreads();
      qps::cols_dot<THREADS>(Ab, n, tt, m, part, [&](int i, float s) {
        rhs[i] = (sg * x[i] - qv[i]) + s;
      });
      __syncthreads();
      qps::warp_rows_dot<WARPS>(Mb, n, rhs, n, [&](int i, float s) { xx[i] = s; });
      __syncthreads();
      for (int pass = 0; pass < refine; ++pass) {
        qps::warp_rows_dot<WARPS>(Ab, n, xx, m,
                                  [&](int r, float s) { tt[r] = rh[r] * s; });
        __syncthreads();
        qps::cols_dot<THREADS>(Ab, n, tt, m, part,
                               [&](int i, float s) { wv[i] = s; });
        __syncthreads();
        qps::warp_rows_dot<WARPS>(Pb, n, xx, n, [&](int i, float s) {
          wv[i] = rhs[i] - ((s + sg * xx[i]) + wv[i]);
        });
        __syncthreads();
        qps::warp_rows_dot<WARPS>(Mb, n, wv, n, [&](int i, float s) { xx[i] += s; });
        __syncthreads();
      }
      qps::warp_rows_dot<WARPS>(Ab, n, xx, m, [&](int r, float s) { zz[r] = s; });
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
  qps::warp_rows_dot<WARPS>(Ab, n, x, m, [&](int r, float s) { Axo[bm + r] = s; });
  qps::cols_dot<THREADS>(Ab, n, y, m, part, [&](int i, float s) { ATyo[bn + i] = s; });
}

// Contiguous f32: Minv/P (B, n, n) (P read only when refine > 0, else may be
// null), A (B, m, n), q/x (B, n), l/u/rho/z/y (B, m); active (B,) int32.
// n % 128 == 0, m % 128 == 0.
extern "C" int qps_admm_chunk_minv(const float* Minv, const float* A,
                                   const float* P, const float* q,
                                   const float* l, const float* u,
                                   const float* rho, const float* x,
                                   const float* z, const float* y,
                                   const int* active, float* xo, float* zo,
                                   float* yo, float* xpo, float* zpo, float* Axo,
                                   float* ATyo, int B, int n, int m, int K,
                                   int refine, float alpha, float sigma,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)(6 * n + 8 * m + qps::cols_dot_part(THREADS)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        admm_chunk_minv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_chunk_minv_kernel<<<B, THREADS, smem, s>>>(
      Minv, A, P, q, l, u, rho, x, z, y, active, xo, zo, yo, xpo, zpo, Axo, ATyo,
      n, m, K, refine, alpha, sigma);
  return (int)cudaGetLastError();
}
