// Slab build: seeds the factor slab of the sigma-free CHOLESKY backend.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_factor.py:
// _build_slab_kernel, for one constraint block (the box-form path) or two
// row blocks (the prox-ALM family's A and C). Per lane b, with the blocks
// A0 (m0 x n) and A1 (m1 x n, m1 = 0 for one block) and m = m0 + m1:
//
//   S[b, :, 0:m0]     = A0[b]'
//   S[b, :, m0:m]     = A1[b]'
//   S[b, :, m]        = q[b]
//   S[b, :, m+1:kp]   = 0
//   S[b, :, kp:kp+n]  = P[b] + sigma*I + sum_i Ai[b]' diag(rho_i[b]) Ai[b]
//
// with rho (B, m) in block order and kp = m + 1 rounded up to a multiple of
// 64 (ops/fused_factor.py: slab_k; m + 64 for the m % 64 == 0 the solvers
// give it), not the TPU layout's m + 128 lane width. The concatenation
// [A0; A1] is never materialized: the gram accumulates the blocks' k-tiles
// in row order into the same registers.
//
// What bounds it on the H100: the gram's symmetric half is n(n+1)m FLOPs
// per lane, 0.27 TFLOP at n=512, m=256, B=4096 (4.1 ms at 67 TFLOP/s FP32),
// against 4.3 GB of P and 2.1 GB of A read and 6.8 GB of slab written (3.9
// ms at 3.35 TB/s): near the ridge, so the loads must overlap the FMAs.
//
// slab_build_kernel (qps_slab_build, n % 128 == 0): one launch over the
// gram's upper triangle of 128 x 128 tiles, T(T+1)/2 CTAs a lane (T =
// n/128), on sgemm.cuh's core (8 x 8 outputs a thread, A's k-tiles through a
// 3-stage cp.async ring, rho applied by each thread to the B elements it
// copied once they land). A tile (i0, j0) writes M[i, j] = P[i, j] + (g +
// sigma*delta_ij) and the mirror M[j, i] = P[j, i] + g below the diagonal,
// transposed through shared memory so its stores coalesce. The diagonal
// tiles hold A[:, i0:i0+128] staged for the gram anyway and write
// the A' columns of their rows from it, then the q column and the zero pad.
// The upper triangle and [A' | q | 0] are bit for bit the previous kernel's;
// the gram part of M is exactly symmetric.
//
// The previous kernels (qps_slab_build_prev: any n % 64 == 0; the witness of
// the new one): slab_gram_prev_kernel, the full n x n gram in 64 x 64 SIMT
// tiles (common.cuh: tile_gemm), and slab_rhs_prev_kernel, the A' columns
// through a 32 x 32 shared-memory transpose, the q column and the zero pad.

#include "common.cuh"
#include "sgemm.cuh"

using qps::i64;

__global__ void __launch_bounds__(qps::TPB)
slab_gram_prev_kernel(const float* __restrict__ P,
                      const float* __restrict__ A0,
                      const float* __restrict__ A1,
                      const float* __restrict__ rho, float* __restrict__ S,
                      int n, int m0, int m1, int kp, float sigma) {
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qps::TM, j0 = blockIdx.x * qps::TN;
  const i64 W = (i64)kp + n;
  const int m = m0 + m1;
  float acc[4][4] = {};
  // a(i, r) = Ak[r, i0 + i] (Ak', i contiguous); b(r, j) = rho[r] * Ak[r, j0 + j].
  const float* A0b = A0 + (i64)b * m0 * n;
  qps::tile_gemm<false>(A0b + i0, n, A0b + j0, n, rho + (i64)b * m, m0, acc);
  if (m1 > 0) {
    const float* A1b = A1 + (i64)b * m1 * n;
    qps::tile_gemm<false>(A1b + i0, n, A1b + j0, n, rho + (i64)b * m + m0, m1,
                          acc);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    const int j = j0 + tx * 4;
    const float4 p =
        *reinterpret_cast<const float4*>(P + (i64)b * n * n + (i64)i * n + j);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float g = acc[r][c] + (i == j + c ? sigma : 0.0f);
      o[c] = pv[c] + g;
    }
    *reinterpret_cast<float4*>(S + (i64)b * n * W + (i64)i * W + kp + j) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// S[b, i, r] = A0[b, r, i] (r < m0), A1[b, r - m0, i] (m0 <= r < m),
// q[b, i] (r == m), 0 (m < r < kp). Grid (kp/32, n/32, B), block (32, 8).
__global__ void slab_rhs_prev_kernel(const float* __restrict__ A0,
                                const float* __restrict__ A1,
                                const float* __restrict__ q,
                                float* __restrict__ S, int n, int m0, int m1,
                                int kp) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const i64 W = (i64)kp + n;
  const int m = m0 + m1;
  for (int k = ty; k < 32; k += 8) {
    const int r = r0 + k, i = i0 + tx;
    float v = 0.0f;
    if (r < m0)
      v = A0[(i64)b * m0 * n + (i64)r * n + i];
    else if (r < m)
      v = A1[(i64)b * m1 * n + (i64)(r - m0) * n + i];
    else if (r == m)
      v = q[(i64)b * n + i];
    tile[k][tx] = v;
  }
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    const int i = i0 + k, r = r0 + tx;
    S[(i64)b * n * W + (i64)i * W + r] = tile[tx][k];
  }
}

// Requires n % 64 == 0, m0 % 16 == 0, m1 % 16 == 0 (m1 = 0 and A1 unused for
// one block), kp % 32 == 0, kp > m0 + m1, contiguous f32.
extern "C" int qps_slab_build_prev(const float* P, const float* A0,
                                   const float* A1, const float* q,
                                   const float* rho, float* S, int B, int n,
                                   int m0, int m1, int kp, float sigma,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 g1(n / qps::TN, n / qps::TM, B);
  slab_gram_prev_kernel<<<g1, qps::TPB, 0, s>>>(P, A0, A1, rho, S, n, m0, m1,
                                                kp, sigma);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2(kp / 32, n / 32, B);
  slab_rhs_prev_kernel<<<g2, dim3(32, 8), 0, s>>>(A0, A1, q, S, n, m0, m1, kp);
  return (int)cudaGetLastError();
}

namespace {
namespace sg = qps::sgemm;

constexpr int GT = 128;                // gram tile, rows and columns
constexpr int B_STAGE = sg::TK * GT;   // floats of one B stage
constexpr int LDT = GT + 4;            // pitch of the mirror's transpose
constexpr size_t BUILD_SMEM =
    sizeof(float) * sg::STAGES * (sg::A_STAGE + B_STAGE);
static_assert(64 * LDT <= sg::STAGES * (sg::A_STAGE + B_STAGE),
              "the mirror's half tile fits in the ring");
}  // namespace

// Grid (T(T+1)/2, B), T = n/128: x walks the tile pairs (ti, tj), ti <= tj,
// of one lane, row by row. Dynamic shared memory BUILD_SMEM: the ring's A
// stages, then its B stages; the mirror's transpose reuses it.
__global__ void __launch_bounds__(sg::THREADS, sg::MIN_BLOCKS)
slab_build_kernel(const float* __restrict__ P, const float* __restrict__ A0,
                  const float* __restrict__ A1, const float* __restrict__ q,
                  const float* __restrict__ rho, float* __restrict__ S, int n,
                  int m0, int m1, int kp, float sigma) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + sg::STAGES * sg::A_STAGE;
  const int b = blockIdx.y, t = threadIdx.x;
  int ti = 0, p = blockIdx.x;
  for (int T = n / GT; p >= T - ti; ++ti) p -= T - ti;
  const int i0 = ti * GT, j0 = (ti + p) * GT;
  const bool diag = p == 0;
  const int m = m0 + m1, KT = m / sg::TK;
  const i64 W = (i64)kp + n;
  const float* A0b = A0 + (i64)b * m0 * n;
  const float* A1b = A1 + (i64)b * m1 * n;
  const float* rhob = rho + (i64)b * m;
  const float* Pb = P + (i64)b * n * n;
  float* Sb = S + (i64)b * n * W;
  // Row r of [A0; A1] (a k-tile never straddles the blocks: m0 % 16 == 0).
  auto a_row = [&](int r) { return r < m0 ? A0b + (i64)r * n : A1b + (i64)(r - m0) * n; };
  // This thread copies rows t/32 + 8e, e < NR, of each B tile (load_b<128>)
  // and scales them by their rho once they land; rho is read a tile ahead.
  constexpr int NR = sg::TK / 8;
  const int kr = t / 32, c4 = (t % 32) * 4;
  float rho_next[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) rho_next[e] = rhob[kr + 8 * e];
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  sg::pipeline(
      KT,
      [&](int kt, int s) {
        const float* src = a_row(kt * sg::TK);
        sg::load_a_kmajor(As + s * sg::A_STAGE, src + i0, n);
        sg::load_b<GT>(Bs + s * B_STAGE, src + j0, n);
      },
      [&](int kt, int s) {
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          const float sc = rho_next[e];
          if (kt + 1 < KT) rho_next[e] = rhob[(kt + 1) * sg::TK + kr + 8 * e];
          float4* v = reinterpret_cast<float4*>(Bs + s * B_STAGE + (kr + 8 * e) * GT + c4);
          float4 u = *v;
          u.x *= sc;
          u.y *= sc;
          u.z *= sc;
          u.w *= sc;
          *v = u;
        }
      },
      [&](int kt, int s) {
        const float* Ast = As + s * sg::A_STAGE;
        sg::mma<GT>(Ast, Bs + s * B_STAGE, GT, acc);
        if (diag) {
          // S[i0 + i, r0 + 4qq .. + 3] = A[r0 + 4qq .. + 3, i0 + i].
          const int r0 = kt * sg::TK;
#pragma unroll
          for (int e = 0; e < sg::TK / 8; ++e) {
            const int f = t + sg::THREADS * e;
            const int i = (f / (2 * sg::TK)) * 8 + f % 8, qq = (f / 8) % (sg::TK / 4);
            const float4 v = make_float4(
                Ast[(4 * qq + 0) * sg::LDA + i], Ast[(4 * qq + 1) * sg::LDA + i],
                Ast[(4 * qq + 2) * sg::LDA + i], Ast[(4 * qq + 3) * sg::LDA + i]);
            *reinterpret_cast<float4*>(Sb + (i64)(i0 + i) * W + r0 + 4 * qq) = v;
          }
        }
      });

  const int ty = sg::tile_ty(), tx = sg::tile_tx();
  // The upper tile: M[i, j] = P[i, j] + (g + sigma * delta_ij).
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty * 8 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      const float4 pv = *reinterpret_cast<const float4*>(Pb + (i64)i * n + j);
      const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float g = acc[r][h * 4 + c] + (i == j + c ? sigma : 0.0f);
        o[c] = pp[c] + g;
      }
      *reinterpret_cast<float4*>(Sb + (i64)i * W + kp + j) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  // The mirror M[j, i] = P[j, i] + g(i, j) below the diagonal, 64 rows j at
  // a time through Ts[j - j0 - 64h][i - i0] (the ring is free: pipeline()
  // ended with a barrier). In a diagonal tile it overwrites the entries below
  // the diagonal that the store above wrote (the barrier orders the two).
  float* Ts = smem;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* col = Ts + (tx * 4 + c) * LDT + ty * 8;
      *reinterpret_cast<float4*>(col) =
          make_float4(acc[0][h * 4 + c] + 0.0f, acc[1][h * 4 + c] + 0.0f,
                      acc[2][h * 4 + c] + 0.0f, acc[3][h * 4 + c] + 0.0f);
      *reinterpret_cast<float4*>(col + 4) =
          make_float4(acc[4][h * 4 + c] + 0.0f, acc[5][h * 4 + c] + 0.0f,
                      acc[6][h * 4 + c] + 0.0f, acc[7][h * 4 + c] + 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = t + sg::THREADS * e;
      const int jj = h * 64 + f / 32, i4 = (f % 32) * 4;
      // A diagonal tile mirrors only i < j: columns i4 + u < jj.
      if (diag && i4 >= jj) continue;
      const float4 g = *reinterpret_cast<const float4*>(Ts + (jj - h * 64) * LDT + i4);
      const float4 pv =
          *reinterpret_cast<const float4*>(Pb + (i64)(j0 + jj) * n + i0 + i4);
      float* out = Sb + (i64)(j0 + jj) * W + kp + i0 + i4;
      const float o[4] = {pv.x + g.x, pv.y + g.y, pv.z + g.z, pv.w + g.w};
      if (!diag || i4 + 3 < jj) {
        *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i4 + u < jj) out[u] = o[u];
      }
    }
    __syncthreads();
  }
  if (diag) {
    // The q column and the zero pad of this tile's rows.
    const int w4 = (kp - m) / 4;
    const float* qb = q + (i64)b * n;
    for (int f = t; f < GT * w4; f += sg::THREADS) {
      const int i = i0 + f / w4, c = m + (f % w4) * 4;
      *reinterpret_cast<float4*>(Sb + (i64)i * W + c) =
          make_float4(c == m ? qb[i] : 0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Requires n % 128 == 0, m0 % 16 == 0, m1 % 16 == 0 (m1 = 0 and A1 unused
// for one block), kp % 16 == 0, kp > m0 + m1, contiguous 16-byte aligned
// f32, 0 < B <= 65535.
extern "C" int qps_slab_build(const float* P, const float* A0, const float* A1,
                              const float* q, const float* rho, float* S, int B,
                              int n, int m0, int m1, int kp, float sigma,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      slab_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BUILD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int T = n / GT;
  slab_build_kernel<<<dim3(T * (T + 1) / 2, B), sg::THREADS, BUILD_SMEM, s>>>(
      P, A0, A1, q, rho, S, n, m0, m1, kp, sigma);
  return (int)cudaGetLastError();
}

extern "C" const char* qps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
