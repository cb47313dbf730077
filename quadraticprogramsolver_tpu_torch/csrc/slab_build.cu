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
// [A0; A1] is never materialized: the gram tile accumulates one tile_gemm
// per block into the same registers, and the transpose kernel reads row r
// of the right-hand side from whichever block holds it.
//
// What bounds it on the H100: the gram is 2*n*n*m FLOPs per lane, 0.55
// TFLOP at n=512, m=256, B=4096, against 4.3 GB of P read, 2.1 GB of A read
// (twice, once per operand, mostly from L2) and 6.8 GB of slab written: at
// 67 TFLOP/s FP32 and 3.35 TB/s both bounds are a few ms, so it sits near the
// ridge. Design: the gram is one 64x64 SIMT tile per CTA (common.cuh), with
// both operands read straight from the blocks (A' is never materialized for
// it), rho applied while staging the second operand, and P + sigma*I added
// in the epilogue as the tile is stored into the slab. A sibling kernel in
// the same call writes the A' columns through a 32x32 shared-memory
// transpose so both its reads and its writes are coalesced, plus the q
// column and the zero pad.

#include "common.cuh"

using qps::i64;

__global__ void __launch_bounds__(qps::TPB)
slab_gram_kernel(const float* __restrict__ P, const float* __restrict__ A0,
                 const float* __restrict__ A1, const float* __restrict__ rho,
                 float* __restrict__ S, int n, int m0, int m1, int kp,
                 float sigma) {
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
__global__ void slab_rhs_kernel(const float* __restrict__ A0,
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
extern "C" int qps_slab_build(const float* P, const float* A0, const float* A1,
                              const float* q, const float* rho, float* S, int B,
                              int n, int m0, int m1, int kp, float sigma,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 g1(n / qps::TN, n / qps::TM, B);
  slab_gram_kernel<<<g1, qps::TPB, 0, s>>>(P, A0, A1, rho, S, n, m0, m1, kp,
                                           sigma);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2(kp / 32, n / 32, B);
  slab_rhs_kernel<<<g2, dim3(32, 8), 0, s>>>(A0, A1, q, S, n, m0, m1, kp);
  return (int)cudaGetLastError();
}

extern "C" const char* qps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
