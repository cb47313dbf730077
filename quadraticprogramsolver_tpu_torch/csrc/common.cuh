// Shared pieces of the port's hand-written Hopper kernels (sm_90a, FP32 on the
// CUDA cores: FMA only, no TF32; the chunks' bf16 precisions are bf16-rounded
// operands in FP32 FMAs, see Prec).
//
// tile_gemm: a 64x64 output tile of a batched FP32 product, accumulated by 256
// threads that each own a 4x4 sub-tile, with the K dimension staged through
// shared memory 16 deep. It is the classic SIMT SGEMM shape: each k step costs
// two 16-byte shared loads for 16 FMAs per thread. Simple and correct first;
// wgmma/TMA pipelines are later work.
//
// rows_dot / rows_dot_split / warp_rows_dot: the row-by-row matrix-vector
// product of the chunk kernels (admm_chunk.cu, prox_chunk.cu) at each
// precision. cols_dot: the column reduction (M'v) of the M^{-1}-form kernels
// and of the ADMM chunks' A'y.

#pragma once

#include <cuda_bf16.h>
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

// Precision of a chunk kernel's products (the TPU kernel's dot_precision):
//   kHighest: FP32 products, FP32 sums.
//   kHigh:    bf16x3. Both operands are split into bf16 halves, a = ah + al
//             with ah = bf16(a) and al = bf16(a - ah), both round to nearest
//             even (__float2bfloat16_rn, as astype(bfloat16) and
//             tensor.to(torch.bfloat16) round), and a*v ~ ah*vh + ah*vl +
//             al*vh (al*vl, ~2^-16 of the product, is dropped).
//   kDefault: one bf16 pass, a*v ~ bf16(a)*bf16(v).
// A product of two bf16 values is exact in FP32, so each term is one FP32
// FMA into the row's FP32 sum: what one MXU pass computes. The vector's
// halves are made once per use in shared memory (split_store); a matrix
// element is split in registers as it is loaded, or arrives split from
// memory (rows_dot_split), and both give the same halves, hence the same
// bits.
enum class Prec : int { kHighest = 0, kHigh = 1, kDefault = 2 };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// s + ah*vh + ah*vl + al*vh, in this order (rows_dot and rows_dot_split).
__device__ __forceinline__ float fma3(float ah, float al, float vh, float vl,
                                      float s) {
  s = fmaf(ah, vh, s);
  s = fmaf(ah, vl, s);
  return fmaf(al, vh, s);
}

// s + a*v at precision P; vh (and vl for kHigh) are v's halves as
// split_store wrote them (vh = v for kHighest).
template <Prec P>
__device__ __forceinline__ float madd(float a, float vh, float vl, float s) {
  if constexpr (P == Prec::kHighest) {
    return fmaf(a, vh, s);
  } else if constexpr (P == Prec::kDefault) {
    return fmaf(bf16r(a), vh, s);
  } else {
    const float ah = bf16r(a);
    return fma3(ah, bf16r(a - ah), vh, vl, s);
  }
}

// Writes v's operand form at precision P: vh[i] = v (kHighest), bf16(v)
// (kDefault), or the two bf16 halves vh[i], vl[i] (kHigh).
template <Prec P>
__device__ __forceinline__ void split_store(float v, float* vh, float* vl,
                                            int i) {
  if constexpr (P == Prec::kHighest) {
    vh[i] = v;
  } else if constexpr (P == Prec::kDefault) {
    vh[i] = bf16r(v);
  } else {
    const float h = bf16r(v);
    vh[i] = h;
    vl[i] = bf16r(v - h);
  }
}

// The exact float values of four packed bf16s (element 0 in the low half).
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 r) {
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// The shuffle tree of the row dots: lane 0 ends with the warp's sum.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// out(row) = sum_c M[row, c] * v[c] for row < rows at precision P, one warp
// per row: each lane reads 16 bytes at a time (neighbouring lanes on
// neighbouring addresses) and a shuffle tree sums the 32 partial dots; lane 0
// calls store(row, sum). Row r starts at M + r * ld; cols % 4 == 0, ld % 4 ==
// 0, M and vh/vl 16-byte aligned; vh/vl (v's operand form, split_store) may
// live in shared memory. Warps of the block take rows round robin, so the
// block needs kWarps warps. Each row's sum is taken in the same order
// whatever kWarps and whichever warp takes it, so callers that give a warp
// several rows (or several lanes' rows) get the same bits per row.
template <int kWarps, Prec P, typename Store>
__device__ __forceinline__ void rows_dot(const float* __restrict__ M, i64 ld,
                                         int cols, const float* vh,
                                         const float* vl, int rows, Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* h4 = reinterpret_cast<const float4*>(vh);
  const float4* l4 = reinterpret_cast<const float4*>(vl);
  const int c4n = cols / 4;
#pragma unroll 2
  for (int row = warp; row < rows; row += kWarps) {
    const float4* r4 = reinterpret_cast<const float4*>(M + (i64)row * ld);
    float s = 0.0f;
    for (int c4 = lane; c4 < c4n; c4 += 32) {
      const float4 a = __ldg(r4 + c4);
      const float4 b = h4[c4];
      float4 c = b;
      if constexpr (P == Prec::kHigh) c = l4[c4];
      s = madd<P>(a.x, b.x, c.x, s);
      s = madd<P>(a.y, b.y, c.y, s);
      s = madd<P>(a.z, b.z, c.z, s);
      s = madd<P>(a.w, b.w, c.w, s);
    }
    s = warp_sum(s);
    if (lane == 0) store(row, s);
  }
}

// rows_dot at kHigh with the matrix already split: Mh and Ml are the bf16
// halves of M (row r at Mh + r * ld, 8-byte loads of four elements). Gives
// the bits rows_dot<kHigh> gives on the f32 M they were split from.
template <int kWarps, typename Store>
__device__ __forceinline__ void rows_dot_split(const unsigned short* __restrict__ Mh,
                                               const unsigned short* __restrict__ Ml,
                                               i64 ld, int cols, const float* vh,
                                               const float* vl, int rows,
                                               Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* h4 = reinterpret_cast<const float4*>(vh);
  const float4* l4 = reinterpret_cast<const float4*>(vl);
  const int c4n = cols / 4;
#pragma unroll 2
  for (int row = warp; row < rows; row += kWarps) {
    const uint2* rh = reinterpret_cast<const uint2*>(Mh + (i64)row * ld);
    const uint2* rl = reinterpret_cast<const uint2*>(Ml + (i64)row * ld);
    float s = 0.0f;
    for (int c4 = lane; c4 < c4n; c4 += 32) {
      const float4 ah = bf16x4_to_float4(__ldg(rh + c4));
      const float4 al = bf16x4_to_float4(__ldg(rl + c4));
      const float4 b = h4[c4];
      const float4 c = l4[c4];
      s = fma3(ah.x, al.x, b.x, c.x, s);
      s = fma3(ah.y, al.y, b.y, c.y, s);
      s = fma3(ah.z, al.z, b.z, c.z, s);
      s = fma3(ah.w, al.w, b.w, c.w, s);
    }
    s = warp_sum(s);
    if (lane == 0) store(row, s);
  }
}

// rows_dot in full FP32 over a row-major M with `cols` floats a row.
template <int kWarps, typename Store>
__device__ __forceinline__ void warp_rows_dot(const float* __restrict__ M,
                                              int cols, const float* v,
                                              int rows, Store store) {
  rows_dot<kWarps, Prec::kHighest>(M, cols, cols, v, v, rows, store);
}

// Shared-memory floats cols_dot needs for its partial sums.
constexpr int cols_dot_part(int threads) { return 4 * threads; }

// out(col) = sum_{r < rows} M[r, col] * v[r] for col < cols, i.e. M'v, at
// precision P (vh/vl: v's operand form, split_store; vh = v for kHighest).
// M is row-major with `cols` floats a row, cols % 128 == 0, M 16-byte
// aligned; vh/vl may live in shared memory. Each thread owns four
// neighbouring columns (one 16-byte load a row, a warp's loads contiguous)
// and every groups-th row, groups = kThreads / (cols / 4) (at least 1); the
// groups' partial sums meet in `part` (shared memory,
// cols_dot_part(kThreads) floats, 16-byte aligned) and store(col, sum) is
// called once per column. Must be called by all kThreads threads; the caller
// puts a __syncthreads() between this call and anything that reads what
// store wrote or reuses `part`.
template <int kThreads, Prec P = Prec::kHighest, typename Store>
__device__ __forceinline__ void cols_dot(const float* __restrict__ M, int cols,
                                         const float* vh, const float* vl,
                                         int rows, float* part, Store store) {
  const int tid = threadIdx.x;
  const int q4n = cols / 4;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  auto column_sums = [&](int q, int r0, int step) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = r0; r < rows; r += step) {
      const float4 a = __ldg(M4 + (i64)r * q4n + q);
      const float wh = vh[r];
      const float wl = P == Prec::kHigh ? vl[r] : wh;
      acc.x = madd<P>(a.x, wh, wl, acc.x);
      acc.y = madd<P>(a.y, wh, wl, acc.y);
      acc.z = madd<P>(a.z, wh, wl, acc.z);
      acc.w = madd<P>(a.w, wh, wl, acc.w);
    }
    return acc;
  };
  if (q4n >= kThreads) {
    for (int q = tid; q < q4n; q += kThreads) {
      const float4 acc = column_sums(q, 0, 1);
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
    reinterpret_cast<float4*>(part + grp * cols)[q] = column_sums(q, grp, groups);
  }
  __syncthreads();
  for (int c = tid; c < cols; c += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += part[g * cols + c];
    store(c, s);
  }
}

}  // namespace qps
