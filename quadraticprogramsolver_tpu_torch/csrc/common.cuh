// Shared pieces of the port's hand-written Hopper kernels (sm_90a, FP32 on the
// CUDA cores: FMA only, no TF32, no bf16 split).
//
// tile_gemm: a 64x64 output tile of a batched FP32 product, accumulated by 256
// threads that each own a 4x4 sub-tile, with the K dimension staged through
// shared memory 16 deep. It is the classic SIMT SGEMM shape: each k step costs
// two 16-byte shared loads for 16 FMAs per thread. Simple and correct first;
// wgmma/TMA pipelines are later work.
//
// warp_rows_dot: the row-by-row matrix-vector product of the chunk kernels
// (admm_chunk.cu, prox_chunk.cu). cols_dot: the column reduction (M'v) of
// their M^{-1}-form kernels.

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

// out(row) = sum_c M[row, c] * v[c] for row < rows, one warp per row: each
// lane reads 16 bytes at a time (neighbouring lanes on neighbouring
// addresses) and a shuffle tree sums the 32 partial dots; lane 0 calls
// store(row, sum). M is row-major with `cols` floats a row, cols % 4 == 0,
// M and v 16-byte aligned. v may live in shared memory. Warps of the block
// take rows round robin, so the block needs kWarps warps.
template <int kWarps, typename Store>
__device__ __forceinline__ void warp_rows_dot(const float* __restrict__ M,
                                              int cols, const float* v,
                                              int rows, Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const int c4n = cols / 4;
#pragma unroll 2
  for (int row = warp; row < rows; row += kWarps) {
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

// Shared-memory floats cols_dot needs for its partial sums.
constexpr int cols_dot_part(int threads) { return 4 * threads; }

// out(col) = sum_{r < rows} M[r, col] * v[r] for col < cols, i.e. M'v. M is
// row-major with `cols` floats a row, cols % 128 == 0, M 16-byte aligned; v
// may live in shared memory. Each thread owns four neighbouring columns (one
// 16-byte load a row, a warp's loads contiguous) and every groups-th row,
// groups = kThreads / (cols / 4) (at least 1); the groups' partial sums meet
// in `part` (shared memory, cols_dot_part(kThreads) floats, 16-byte aligned)
// and store(col, sum) is called once per column. Must be called by all
// kThreads threads; the caller puts a __syncthreads() between this call and
// anything that reads what store wrote or reuses `part`.
template <int kThreads, typename Store>
__device__ __forceinline__ void cols_dot(const float* __restrict__ M, int cols,
                                         const float* v, int rows, float* part,
                                         Store store) {
  const int tid = threadIdx.x;
  const int q4n = cols / 4;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  if (q4n >= kThreads) {
    for (int q = tid; q < q4n; q += kThreads) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float4 a = __ldg(M4 + (i64)r * q4n + q);
        const float w = v[r];
        acc.x = fmaf(a.x, w, acc.x);
        acc.y = fmaf(a.y, w, acc.y);
        acc.z = fmaf(a.z, w, acc.z);
        acc.w = fmaf(a.w, w, acc.w);
      }
      store(4 * q, acc.x);
      store(4 * q + 1, acc.y);
      store(4 * q + 2, acc.z);
      store(4 * q + 3, acc.w);
    }
    return;
  }
  const int groups = kThreads / q4n;
  const int q = tid % q4n, grp = tid / q4n;
  if (grp < groups) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = grp; r < rows; r += groups) {
      const float4 a = __ldg(M4 + (i64)r * q4n + q);
      const float w = v[r];
      acc.x = fmaf(a.x, w, acc.x);
      acc.y = fmaf(a.y, w, acc.y);
      acc.z = fmaf(a.z, w, acc.z);
      acc.w = fmaf(a.w, w, acc.w);
    }
    reinterpret_cast<float4*>(part + grp * cols)[q] = acc;
  }
  __syncthreads();
  for (int c = tid; c < cols; c += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += part[g * cols + c];
    store(c, s);
  }
}

}  // namespace qps
