// Slab level: one block Gauss-Jordan level of the sigma-free factor.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_factor.py:
// _slab_level_kernel. Per lane, with the live region T = S[:, 0:w_out], the
// pivot columns C = S[:, w_out:w_out+128] and Dinv the inverse of the pivot
// block S[j rows, w_out:w_out+128]:
//
//   DinvT          = Dinv . T[j*128:(j+1)*128, :]
//   T[rows not j] -= C[rows not j] . DinvT
//   T[rows j]      = DinvT
//
// The race a block-by-block carry-over would have: on the TPU one grid step
// held a lane's whole live region in VMEM, so writing the pivot rows in place
// was safe. Here the live region (n x w_out, up to 1.4 MB per lane at
// n=512, m=256) is tiled over many CTAs, and a tile that overwrote the pivot
// rows would race every other tile still reading them. So the level is two
// launches: the first computes DinvT into a scratch buffer (B, 128, >= w_out);
// the second runs the rank-128 update tile by tile, taking the pivot rows
// from the scratch. The pivot columns C are never written at this level.
//
// Precision (Settings.factor_precision, the TPU kernel's prec): kHighest
// multiplies in FP32; kHigh is its manual bf16x3 branch (fused_factor.py:
// 151-165). There the level's small operands, Dinv and the pivot rows of T in
// the first launch, C and DinvT in the second, are split into bf16 halves as
// they are staged (round to nearest even, common.cuh: Prec), and the tile's
// product is three bf16 passes on the tensor cores, ah.bh + ah.bl + al.bh
// with FP32 accumulation (mma.sync m16n8k16; lo.lo dropped, as the TPU
// kernel drops it); T itself enters the update elementwise, unsplit.
//
// What bounds it on the H100: FLOPs. At n=512, m=256 the four levels cost
// 2*n*128*sum(w_out) + 2*128*128*sum(w_out) = 0.34 GFLOP per lane, 1.4
// TFLOP at B=4096 (~21 ms at the 67 TFLOP/s FP32 peak), against ~38 GB of
// slab read and written (~11 ms at 3.35 TB/s). Design: both launches are 64x64
// tiles with K = 128 (SIMT at kHighest, common.cuh; tensor cores at kHigh);
// update tiles in the pivot rows skip the product and copy DinvT.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int NB = 128;

// tile_gemm<true>'s 64x64 tile (common.cuh) in bf16x3 on the tensor cores:
// acc[r][c] = sum_k a(i, k) b(k, j) for i = ty*4 + r, j = tx*4 + c, with K
// staged 16 deep. Each element of a and b is split into its bf16 halves as it
// is staged (a row-major in Ah/Al, b transposed in Bh/Bl, so both fragments
// load pairs along k). Warp w owns rows (w % 4)*16 and columns (w / 4)*32 of
// the tile: per 16-deep chunk, four 16x8 products, each as the three passes
// ah.bh, ah.bl, al.bh (m16n8k16, bf16 in, FP32 accumulators). The warps'
// accumulators are then laid out as tile_gemm's through shared memory, so the
// callers' epilogues are the FP32 tile's.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tile_gemm3(const float* __restrict__ a, i64 lda,
                                           const float* __restrict__ b, i64 ldb,
                                           int K, float acc[4][4]) {
  using qps::TK;
  using qps::TM;
  using qps::TN;
  constexpr int LDK = TK + 8;  // bf16 row pitch of the staged chunks
  __shared__ __align__(16) __nv_bfloat16 Ah[TM][LDK], Al[TM][LDK];
  __shared__ __align__(16) __nv_bfloat16 Bh[TN][LDK], Bl[TN][LDK];
  __shared__ __align__(16) float Cs[TM][TN + 4];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, tg = lane % 4;
  const int r0 = (warp % 4) * 16, n0 = (warp / 4) * 32;
  float c[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    {
      const int i = t / 4, kk = (t % 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(a + (i64)i * lda + k0 + kk);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const __nv_bfloat16 h = __float2bfloat16_rn(e[u]);
        Ah[i][kk + u] = h;
        Al[i][kk + u] = __float2bfloat16_rn(e[u] - __bfloat162float(h));
      }
    }
    {
      const int kk = t / 16, j = (t % 16) * 4;
      const float4 v = *reinterpret_cast<const float4*>(b + (i64)(k0 + kk) * ldb + j);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const __nv_bfloat16 h = __float2bfloat16_rn(e[u]);
        Bh[j + u][kk] = h;
        Bl[j + u][kk] = __float2bfloat16_rn(e[u] - __bfloat162float(h));
      }
    }
    __syncthreads();
    auto pair = [](const __nv_bfloat16* p) {
      return *reinterpret_cast<const unsigned*>(p);
    };
    const unsigned ah[4] = {pair(&Ah[r0 + g][tg * 2]), pair(&Ah[r0 + g + 8][tg * 2]),
                            pair(&Ah[r0 + g][tg * 2 + 8]), pair(&Ah[r0 + g + 8][tg * 2 + 8])};
    const unsigned al[4] = {pair(&Al[r0 + g][tg * 2]), pair(&Al[r0 + g + 8][tg * 2]),
                            pair(&Al[r0 + g][tg * 2 + 8]), pair(&Al[r0 + g + 8][tg * 2 + 8])};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + nt * 8 + g;
      const unsigned bh0 = pair(&Bh[col][tg * 2]), bh1 = pair(&Bh[col][tg * 2 + 8]);
      const unsigned bl0 = pair(&Bl[col][tg * 2]), bl1 = pair(&Bl[col][tg * 2 + 8]);
      mma_bf16(c[nt], ah, bh0, bh1);
      mma_bf16(c[nt], ah, bl0, bl1);
      mma_bf16(c[nt], al, bh0, bh1);
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + nt * 8 + tg * 2;
    Cs[r0 + g][col] = c[nt][0];
    Cs[r0 + g][col + 1] = c[nt][1];
    Cs[r0 + g + 8][col] = c[nt][2];
    Cs[r0 + g + 8][col + 1] = c[nt][3];
  }
  __syncthreads();
  const int tx = t % 16, ty = t / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] += Cs[ty * 4 + r][tx * 4 + cc];
}

// The level's product at precision P (kHighest or kHigh), a row-major.
template <qps::Prec P>
__device__ __forceinline__ void level_gemm(const float* __restrict__ a, i64 lda,
                                           const float* __restrict__ b, i64 ldb,
                                           float acc[4][4]) {
  if constexpr (P == qps::Prec::kHigh) {
    tile_gemm3(a, lda, b, ldb, NB, acc);
  } else {
    qps::tile_gemm<true>(a, lda, b, ldb, nullptr, NB, acc);
  }
}
}  // namespace

// DinvT[b, i, c] = sum_k Dinv[b, i, k] * S[b, j*128 + k, c].
// Grid (w_out/64, 2, B).
template <qps::Prec P>
__global__ void __launch_bounds__(qps::TPB)
level_dinvt_kernel(const float* __restrict__ S, const float* __restrict__ Dinv,
                   float* __restrict__ T, i64 ld_t, int n, int wid, int j) {
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qps::TM, c0 = blockIdx.x * qps::TN;
  const float* Sb = S + (i64)b * n * wid;
  float acc[4][4] = {};
  level_gemm<P>(Dinv + (i64)b * NB * NB + (i64)i0 * NB, NB,
                Sb + (i64)j * NB * wid + c0, wid, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* Tb = T + (i64)b * NB * ld_t;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(Tb + (i64)(i0 + ty * 4 + r) * ld_t + c0 + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// S[b, i, c] (c < w_out): DinvT row for pivot rows, else S - C . DinvT.
// Grid (w_out/64, n/64, B).
template <qps::Prec P>
__global__ void __launch_bounds__(qps::TPB)
level_update_kernel(float* __restrict__ S, const float* __restrict__ T,
                    i64 ld_t, int n, int wid, int j, int w_out) {
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qps::TM, c0 = blockIdx.x * qps::TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* Sb = S + (i64)b * n * wid;
  const float* Tb = T + (i64)b * NB * ld_t;
  if (i0 >= j * NB && i0 < (j + 1) * NB) {  // uniform over the CTA
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      *reinterpret_cast<float4*>(Sb + (i64)i * wid + c0 + tx * 4) =
          *reinterpret_cast<const float4*>(Tb + (i64)(i - j * NB) * ld_t + c0 + tx * 4);
    }
    return;
  }
  float acc[4][4] = {};
  level_gemm<P>(Sb + (i64)i0 * wid + w_out, wid, Tb + c0, ld_t, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* row = Sb + (i64)(i0 + ty * 4 + r) * wid + c0 + tx * 4;
    float4 v = *reinterpret_cast<float4*>(row);
    v.x -= acc[r][0];
    v.y -= acc[r][1];
    v.z -= acc[r][2];
    v.w -= acc[r][3];
    *reinterpret_cast<float4*>(row) = v;
  }
}

// S: contiguous (B, n, wid); Dinv: contiguous (B, 128, 128); scratch:
// (B, 128, ld_t) with ld_t >= w_out. n % 128 == 0, w_out % 64 == 0,
// w_out + 128 <= wid, wid % 4 == 0, ld_t % 4 == 0. prec: 0 FP32 (kHighest),
// 1 bf16x3 (kHigh).
template <qps::Prec P>
static int slab_level(float* S, const float* Dinv, float* scratch, i64 ld_t,
                      int B, int n, int wid, int j, int w_out, cudaStream_t s) {
  dim3 g1(w_out / qps::TN, NB / qps::TM, B);
  level_dinvt_kernel<P><<<g1, qps::TPB, 0, s>>>(S, Dinv, scratch, ld_t, n, wid, j);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2(w_out / qps::TN, n / qps::TM, B);
  level_update_kernel<P><<<g2, qps::TPB, 0, s>>>(S, scratch, ld_t, n, wid, j, w_out);
  return (int)cudaGetLastError();
}

extern "C" int qps_slab_level(float* S, const float* Dinv, float* scratch,
                              i64 ld_t, int B, int n, int wid, int j, int w_out,
                              int prec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prec == static_cast<int>(qps::Prec::kHigh))
    return slab_level<qps::Prec::kHigh>(S, Dinv, scratch, ld_t, B, n, wid, j, w_out, s);
  if (prec != static_cast<int>(qps::Prec::kHighest)) return (int)cudaErrorInvalidValue;
  return slab_level<qps::Prec::kHighest>(S, Dinv, scratch, ld_t, B, n, wid, j, w_out, s);
}
