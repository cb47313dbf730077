// Shared pieces of the port's hand-written Hopper kernels (sm_90a, FP32 on the
// CUDA cores: FMA only, no TF32, no bf16 split).
//
// tile_gemm: a 64x64 output tile of a batched FP32 product, accumulated by 256
// threads that each own a 4x4 sub-tile, with the K dimension staged through
// shared memory 16 deep. It is the classic SIMT SGEMM shape: each k step costs
// two 16-byte shared loads for 16 FMAs per thread. Simple and correct first;
// wgmma/TMA pipelines are later work.

#pragma once

#include <cuda_runtime.h>

namespace qps {

using i64 = long long;

constexpr int TM = 64;   // output tile rows
constexpr int TN = 64;   // output tile columns
constexpr int TK = 16;   // K depth staged per shared-memory round
constexpr int TPB = 256; // threads per tile (16 x 16, 4 x 4 outputs each)

// acc[r][c] += sum_{k < K} a(ty*4 + r, k) * b(k, tx*4 + c) * bscale[k]
// with ty = threadIdx.x / 16, tx = threadIdx.x % 16.
//   A_ROW = true : a(i, k) = a[i * lda + k]   (k contiguous)
//   A_ROW = false: a(i, k) = a[k * lda + i]   (i contiguous)
//   b(k, j) = b[k * ldb + j]                  (j contiguous)
// a and b point at the tile's origin. K % 16 == 0; every row start used is
// 16-byte aligned (lda, ldb and the origins are multiples of 4 floats).
// bscale may be nullptr. Must be called by all 256 threads of the block.
template <bool A_ROW>
__device__ __forceinline__ void tile_gemm(const float* __restrict__ a, i64 lda,
                                          const float* __restrict__ b, i64 ldb,
                                          const float* __restrict__ bscale,
                                          int K, float acc[4][4]) {
  __shared__ __align__(16) float As[TK][TM];
  __shared__ __align__(16) float Bs[TK][TN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    if (A_ROW) {
      const int i = t / 4, kk = (t % 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(a + (i64)i * lda + k0 + kk);
      As[kk + 0][i] = v.x;
      As[kk + 1][i] = v.y;
      As[kk + 2][i] = v.z;
      As[kk + 3][i] = v.w;
    } else {
      const int kk = t / 16, i = (t % 16) * 4;
      *reinterpret_cast<float4*>(&As[kk][i]) =
          *reinterpret_cast<const float4*>(a + (i64)(k0 + kk) * lda + i);
    }
    {
      const int kk = t / 16, j = (t % 16) * 4;
      float4 v = *reinterpret_cast<const float4*>(b + (i64)(k0 + kk) * ldb + j);
      if (bscale != nullptr) {
        const float s = bscale[k0 + kk];
        v.x *= s;
        v.y *= s;
        v.z *= s;
        v.w *= s;
      }
      *reinterpret_cast<float4*>(&Bs[kk][j]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    __syncthreads();
  }
}

}  // namespace qps
