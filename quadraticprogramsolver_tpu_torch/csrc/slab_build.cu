// Slab build: seeds the factor slab of the sigma-free CHOLESKY backend.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_factor.py:
// _build_slab_kernel (one A block, the box-form path). Per lane b:
//
//   S[b, :, 0:m]      = A[b]'                       (n x m)
//   S[b, :, m]        = q[b]
//   S[b, :, m+1:kp]   = 0
//   S[b, :, kp:kp+n]  = P[b] + sigma*I + A[b]' diag(rho[b]) A[b]
//
// with kp = m + 1 rounded up to a multiple of 64 (ops/fused_factor.py:
// slab_k; m + 64 for the m % 64 == 0 the solver gives it), not the TPU
// layout's m + 128 lane width.
//
// What bounds it on the H100: the gram is 2*n*n*m FLOPs per lane, 0.55
// TFLOP at n=512, m=256, B=4096, against 4.3 GB of P read, 2.1 GB of A read
// (twice, once per operand, mostly from L2) and 6.8 GB of slab written: at
// 67 TFLOP/s FP32 and 3.35 TB/s both bounds are a few ms, so it sits near the
// ridge. Design: the gram is one 64x64 SIMT tile per CTA (common.cuh), with
// both operands read straight from A (A' is never materialized for it), rho
// applied while staging the second operand, and P + sigma*I added in the
// epilogue as the tile is stored into the slab. A sibling kernel in the same
// call writes the A' columns through a 32x32 shared-memory transpose so both
// its reads and its writes are coalesced, plus the q column and the zero pad.

#include "common.cuh"

using qps::i64;

__global__ void __launch_bounds__(qps::TPB)
slab_gram_kernel(const float* __restrict__ P, const float* __restrict__ A,
                 const float* __restrict__ rho, float* __restrict__ S, int n,
                 int m, int kp, float sigma) {
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qps::TM, j0 = blockIdx.x * qps::TN;
  const i64 W = (i64)kp + n;
  const float* Ab = A + (i64)b * m * n;
  float acc[4][4] = {};
  // a(i, r) = A[r, i0 + i] (A', i contiguous); b(r, j) = rho[r] * A[r, j0 + j].
  qps::tile_gemm<false>(Ab + i0, n, Ab + j0, n, rho + (i64)b * m, m, acc);
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

// S[b, i, r] = A[b, r, i] (r < m), q[b, i] (r == m), 0 (m < r < kp).
// Grid (kp/32, n/32, B), block (32, 8).
__global__ void slab_rhs_kernel(const float* __restrict__ A,
                                const float* __restrict__ q,
                                float* __restrict__ S, int n, int m, int kp) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const i64 W = (i64)kp + n;
  for (int k = ty; k < 32; k += 8) {
    const int r = r0 + k, i = i0 + tx;
    float v = 0.0f;
    if (r < m)
      v = A[(i64)b * m * n + (i64)r * n + i];
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

// Requires n % 64 == 0, m % 16 == 0, kp % 32 == 0, kp > m, contiguous f32.
extern "C" int qps_slab_build(const float* P, const float* A, const float* q,
                              const float* rho, float* S, int B, int n, int m,
                              int kp, float sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 g1(n / qps::TN, n / qps::TM, B);
  slab_gram_kernel<<<g1, qps::TPB, 0, s>>>(P, A, rho, S, n, m, kp, sigma);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2(kp / 32, n / 32, B);
  slab_rhs_kernel<<<g2, dim3(32, 8), 0, s>>>(A, q, S, n, m, kp);
  return (int)cudaGetLastError();
}

extern "C" const char* qps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
