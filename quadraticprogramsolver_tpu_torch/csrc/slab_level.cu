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
// n=512, m=256) is spread over many CTAs, and a CTA that overwrote the pivot
// rows would race every other CTA still reading them.
//
// What bounds it on the H100: at n=512, m=256 the four levels cost
// 2*n*128*sum(w_out) = 0.27 GFLOP per lane, 1.10 TFLOP at B=4096 (16.4 ms
// at the 67 TFLOP/s FP32 peak), against ~38.6 GB of slab read and written
// (11.5 ms at 3.35 TB/s): near the ridge, so the loads must overlap the FMAs.
//
// level_strip_kernel (qps_slab_level_strip at prec 0, FP32, "highest"): one
// launch a level over column strips. A CTA owns the columns [c0, c0 + 128)
// of one lane (the last strip 64 wide when w_out % 128 == 64), over all n
// rows, so no other CTA reads or writes them: it computes DinvT for its strip
// into shared memory (Dinv and the strip's pivot rows through sgemm.cuh's
// cp.async ring), writes it into the pivot rows, then streams C's 128-row
// blocks through the ring against the resident DinvT and subtracts each 128 x
// 128 product from its block of the strip. The pivot columns are not written
// at this level. No scratch. The grid is (strips, B), strips fastest, so a
// lane's strips share C and Dinv in the L2. Bit for bit the two-launch FP32
// level below (same operands, same k order, one fmaf a term).
//
// level_strip_kernel_high (qps_slab_level_strip at prec 1, bf16x3, kHigh,
// Settings.factor_precision="high", the TPU kernel's manual branch,
// fused_factor.py: 151-165): the same plan on the tensor cores. Phase 1
// computes the strip's DinvT = Dinv . T[j rows, strip] as three bf16 passes
// (mma.sync m16n8k16, FP32 accumulators), writes it into the pivot rows in
// FP32 and keeps it in shared memory as its bf16 halves (2 x 128 x 128 x 2
// bytes, the FP32 DinvT's 64 KB); phase 2 streams C's 128-row blocks through
// the cp.async ring, each 16-deep k-tile split into its halves in place by
// the thread that copied it, and subtracts each 128 x 128 product from its
// block of the strip in FP32, straight from the accumulator fragments, the
// block's strip prefetched into the L2 at its first k-tile. Warp
// w computes rows (w % 4) * 32 .. + 31 and the strip's columns (w / 4) *
// TN/2 .. + TN/2 - 1. Split and pass order are tile_gemm3's below: hi =
// rn(x), lo = rn(x - hi); per 16-deep k chunk, ascending, the passes ah.bh,
// ah.bl, al.bh into one accumulator an element started at 0 (lo.lo dropped);
// T enters unsplit. An m16n8k16 result element depends only on its
// accumulator and its 16 products, so the same fragments in the same order
// give the two-launch kernel's bits whichever warp holds the element. Its
// bound at B=512, j=3: the slab's bytes (0.49 ms); its products are 3 * 2 *
// 128 * w_out * n FLOPs a lane at the bf16 rate (0.12 ms).
//
// The two-launch level (qps_slab_level): level_dinvt_kernel computes DinvT
// into a scratch buffer (B, 128, >= w_out); level_update_kernel then runs the
// rank-128 update in 64x64 tiles, taking the pivot rows from the scratch.
// It is the previous kernel at both precisions, kept as the strip kernels'
// witness (no solver launches it). At bf16x3 (prec 1) the level's small
// operands, Dinv and the pivot rows of T in the first launch, C and DinvT in
// the second, are split into bf16 halves as they are staged (round to
// nearest even, common.cuh: Prec), and the tile's product is three bf16
// passes on the tensor cores, ah.bh + ah.bl + al.bh with FP32 accumulation
// (mma.sync m16n8k16; lo.lo dropped, as the TPU kernel drops it); T itself
// enters the update elementwise, unsplit. Update tiles in the pivot rows
// skip the product and copy DinvT.

#include "common.cuh"
#include "sgemm.cuh"

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

namespace {
namespace sg = qps::sgemm;

// Dynamic shared memory of the strip kernel: DinvT (128 x 128; the first
// phase's B stages live in it), then the ring's A stages.
constexpr size_t STRIP_SMEM = sizeof(float) * (NB * NB + sg::STAGES * sg::A_STAGE);
static_assert(sg::STAGES * sg::TK * 128 <= NB * NB,
              "the first phase's B stages fit in DinvT's space");

// One lane's strip [c0, c0 + TN) of the level.
template <int TN>
__device__ __forceinline__ void level_strip(float* __restrict__ Sb,
                                            const float* __restrict__ Db,
                                            int n, int wid, int j, int w_out,
                                            int c0, float* smem) {
  constexpr int NC = TN / 16;
  constexpr int KT = NB / sg::TK;  // k-tiles of a 128-deep product
  float* Dt = smem;                // DinvT[k][c], pitch TN
  float* As = smem + NB * NB;
  const int ty = sg::tile_ty(), tx = sg::tile_tx();
  float acc[8][NC];
  auto zero = [&]() {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  };
  auto none = [](int, int) {};
  // DinvT = Dinv . T[j rows, strip]: Dinv's k-tiles transposed into the A
  // stages, the pivot rows' k-tiles into B stages inside Dt.
  zero();
  const float* piv = Sb + (i64)j * NB * wid + c0;
  sg::pipeline(
      KT,
      [&](int kt, int s) {
        sg::load_a_rowmajor(As + s * sg::A_STAGE, Db + kt * sg::TK, NB);
        sg::load_b<TN>(Dt + s * sg::TK * TN, piv + (i64)kt * sg::TK * wid, wid);
      },
      none,
      [&](int, int s) {
        sg::mma<TN>(As + s * sg::A_STAGE, Dt + s * sg::TK * TN, TN, acc);
      });
  // pipeline() ended with a barrier: Dt is free. DinvT into Dt and into
  // the pivot rows (every read of them has landed).
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < NC / 4; ++h) {
      const float4 v = make_float4(acc[r][h * 4], acc[r][h * 4 + 1],
                                   acc[r][h * 4 + 2], acc[r][h * 4 + 3]);
      const int i = ty * 8 + r, c = h * 64 + tx * 4;
      *reinterpret_cast<float4*>(Dt + i * TN + c) = v;
      *reinterpret_cast<float4*>(Sb + (i64)(j * NB + i) * wid + c0 + c) = v;
    }
  __syncthreads();
  // S[ib rows, strip] -= C[ib rows] . DinvT for every row block ib != j: C's
  // k-tiles (transposed) stream through the ring across the blocks.
  zero();
  const float* C = Sb + w_out;
  const int blocks = n / NB - 1;
  sg::pipeline(
      blocks * KT,
      [&](int kt, int s) {
        const int blk = kt / KT, ib = blk < j ? blk : blk + 1;
        sg::load_a_rowmajor(As + s * sg::A_STAGE,
                            C + (i64)ib * NB * wid + (kt % KT) * sg::TK, wid);
      },
      none,
      [&](int kt, int s) {
        sg::mma<TN>(As + s * sg::A_STAGE, Dt + (kt % KT) * sg::TK * TN, TN, acc);
        if (kt % KT != KT - 1) return;
        const int blk = kt / KT, ib = blk < j ? blk : blk + 1;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int h = 0; h < NC / 4; ++h) {
            float* row = Sb + (i64)(ib * NB + ty * 8 + r) * wid + c0 + h * 64 + tx * 4;
            float4 v = *reinterpret_cast<float4*>(row);
            v.x -= acc[r][h * 4];
            v.y -= acc[r][h * 4 + 1];
            v.z -= acc[r][h * 4 + 2];
            v.w -= acc[r][h * 4 + 3];
            *reinterpret_cast<float4*>(row) = v;
          }
        zero();
      });
}
}  // namespace

// Grid (ceil(w_out / 128), B): CTA (x, b) owns lane b's columns [128x,
// 128x + 128) of the live region, or [128x, 128x + 64) for the last strip
// when w_out % 128 == 64.
__global__ void __launch_bounds__(sg::THREADS, sg::MIN_BLOCKS)
level_strip_kernel(float* __restrict__ S, const float* __restrict__ Dinv,
                   int n, int wid, int j, int w_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, c0 = blockIdx.x * 128;
  float* Sb = S + (i64)b * n * wid;
  const float* Db = Dinv + (i64)b * NB * NB;
  if (c0 + 128 <= w_out)
    level_strip<128>(Sb, Db, n, wid, j, w_out, c0, smem);
  else
    level_strip<64>(Sb, Db, n, wid, j, w_out, c0, smem);
}

namespace {
// The bf16x3 strip kernel's shared memory: DinvT's halves Dh, Dl ([c][k],
// k < 128 contiguous, pitch H_DLD bf16; phase 1 stages its B operand in
// this space), then the ring's A stages (128 rows x 16 k, pitch H_ALD
// floats, split in place).
constexpr int H_DLD = NB + 8;
constexpr int H_ALD = 24;
constexpr int H_ASTAGE = NB * H_ALD;  // floats of an A stage
constexpr int H_BLD = sg::TK + 8;     // bf16 a column of a split B stage
constexpr size_t H_DBYTES = 2 * sizeof(__nv_bfloat16) * NB * H_DLD;
constexpr size_t HIGH_SMEM = H_DBYTES + sizeof(float) * sg::STAGES * H_ASTAGE;
static_assert(sizeof(float) * sg::STAGES * sg::TK * (128 + 4) +
                      2 * 2 * sizeof(__nv_bfloat16) * 128 * H_BLD <=
                  H_DBYTES,
              "phase 1's B stages fit in DinvT's space");

// hi = rn(x), lo = rn(x - hi) of x and y, packed as (x's, y's) pairs.
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  const __nv_bfloat16 lx = __float2bfloat16_rn(x - __bfloat162float(hx));
  const __nv_bfloat16 ly = __float2bfloat16_rn(y - __bfloat162float(hy));
  hi = (unsigned)__bfloat16_as_ushort(hx) | ((unsigned)__bfloat16_as_ushort(hy) << 16);
  lo = (unsigned)__bfloat16_as_ushort(lx) | ((unsigned)__bfloat16_as_ushort(ly) << 16);
}

// An A stage from a row-major 128 x 16 source: thread t copies the 16-byte
// quads f = t, t + 256 (row f / 4, k 4 (f % 4) .. + 3) and later splits them.
__device__ __forceinline__ void high_load_a(float* As, const float* g, i64 ld) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int f = threadIdx.x + sg::THREADS * e, i = f / 4, q = f % 4;
    sg::cp_async16(As + i * H_ALD + q * 4, g + (i64)i * ld + q * 4);
  }
}

// This thread's quads of an A stage, split in place: the 16 bytes of k =
// 4q .. 4q+3 become the bf16 pairs (hi k, k+1), (lo k, k+1), (hi k+2, k+3),
// (lo k+2, k+3), the hi and lo words swapped in rows with (i >> 2) & 1, so
// that a fragment's 8 rows read 32 distinct banks: the hi pair of (k, k+1)
// sits at word k + s of the row, the lo pair at k + 1 - s.
__device__ __forceinline__ void high_split_a(float* As) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int f = threadIdx.x + sg::THREADS * e, i = f / 4, q = f % 4;
    float4* p = reinterpret_cast<float4*>(As + i * H_ALD + q * 4);
    const float4 v = *p;
    unsigned h0, l0, h1, l1;
    split2(v.x, v.y, h0, l0);
    split2(v.z, v.w, h1, l1);
    *reinterpret_cast<uint4*>(p) =
        (i >> 2) & 1 ? make_uint4(l0, h0, l1, h1) : make_uint4(h0, l0, h1, l1);
  }
}

// A B stage of phase 1 (16 pivot rows x TN columns, pitch TN + 4 floats):
// thread t copies (k, c) = (f % 16, 4 (f / 16)) for f = t, t + 256, ...
template <int TN>
__device__ __forceinline__ void high_load_b(float* Bs, const float* g, i64 ld) {
#pragma unroll
  for (int e = 0; e < TN / 64; ++e) {
    const int f = threadIdx.x + sg::THREADS * e, k = f % 16, c = (f / 16) * 4;
    sg::cp_async16(Bs + k * (TN + 4) + c, g + (i64)k * ld + c);
  }
}

// This thread's copies of a B stage, split and transposed into Bh[c][k],
// Bl[c][k] (pitch H_BLD), as tile_gemm3 stages its B operand.
template <int TN>
__device__ __forceinline__ void high_split_b(const float* Bs, __nv_bfloat16* Bh,
                                             __nv_bfloat16* Bl) {
#pragma unroll
  for (int e = 0; e < TN / 64; ++e) {
    const int f = threadIdx.x + sg::THREADS * e, k = f % 16, c = (f / 16) * 4;
    const float4 v = *reinterpret_cast<const float4*>(Bs + k * (TN + 4) + c);
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const __nv_bfloat16 h = __float2bfloat16_rn(x[u]);
      Bh[(c + u) * H_BLD + k] = h;
      Bl[(c + u) * H_BLD + k] = __float2bfloat16_rn(x[u] - __bfloat162float(h));
    }
  }
}

// acc[mt][nt] += the three passes of one 16-deep k chunk: A from an A stage
// (rows m0 + 16 mt + g, + 8), B from Bh / Bl[c][kb + k] (pitch ldb bf16,
// columns n0 + 8 nt + g).
template <int NT>
__device__ __forceinline__ void high_mma(const float* As, int m0,
                                         const __nv_bfloat16* Bh,
                                         const __nv_bfloat16* Bl, int ldb,
                                         int n0, int kb, float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const int s = (g >> 2) & 1;
  const unsigned* a = reinterpret_cast<const unsigned*>(As);
  auto pair = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned*>(p);
  };
  unsigned ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = (m0 + mt * 16 + g) * H_ALD + tg * 2, r1 = r0 + 8 * H_ALD;
    ah[mt][0] = a[r0 + s];
    ah[mt][1] = a[r1 + s];
    ah[mt][2] = a[r0 + 8 + s];
    ah[mt][3] = a[r1 + 8 + s];
    al[mt][0] = a[r0 + 1 - s];
    al[mt][1] = a[r1 + 1 - s];
    al[mt][2] = a[r0 + 9 - s];
    al[mt][3] = a[r1 + 9 - s];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = (n0 + nt * 8 + g) * ldb + kb + tg * 2;
    const unsigned bh0 = pair(Bh + col), bh1 = pair(Bh + col + 8);
    const unsigned bl0 = pair(Bl + col), bl1 = pair(Bl + col + 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(acc[mt][nt], ah[mt], bh0, bh1);
      mma_bf16(acc[mt][nt], ah[mt], bl0, bl1);
      mma_bf16(acc[mt][nt], al[mt], bh0, bh1);
    }
  }
}

// One lane's strip [c0, c0 + TN) of the bf16x3 level.
template <int TN>
__device__ __forceinline__ void level_strip_high(float* __restrict__ Sb,
                                                 const float* __restrict__ Db,
                                                 int n, int wid, int j, int w_out,
                                                 int c0, unsigned char* smem) {
  constexpr int NT = TN / 16;        // 8-column tiles of a warp's TN/2 columns
  constexpr int KT = NB / sg::TK;    // k-tiles of a 128-deep product
  constexpr int BSPLIT = 128 * H_BLD;  // bf16 of one half of a split B stage
  __nv_bfloat16* Dh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Dl = Dh + NB * H_DLD;
  float* Braw = reinterpret_cast<float*>(smem);
  __nv_bfloat16* Bsp = reinterpret_cast<__nv_bfloat16*>(
      smem + sizeof(float) * sg::STAGES * sg::TK * (TN + 4));
  float* As = reinterpret_cast<float*>(smem + H_DBYTES);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = (warp % 4) * 32, n0 = (warp / 4) * (TN / 2);
  float acc[2][NT][4];
  auto zero = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  };
  // Phase 1: DinvT = Dinv . T[j rows, strip]; Dinv's k-tiles through the A
  // stages, the pivot rows' through raw B stages split into double-buffered
  // halves.
  zero();
  const float* piv = Sb + (i64)j * NB * wid + c0;
  sg::pipeline(
      KT,
      [&](int kt, int s) {
        high_load_a(As + s * H_ASTAGE, Db + kt * sg::TK, NB);
        high_load_b<TN>(Braw + s * sg::TK * (TN + 4), piv + (i64)kt * sg::TK * wid,
                        wid);
      },
      [&](int kt, int s) {
        high_split_a(As + s * H_ASTAGE);
        __nv_bfloat16* bh = Bsp + (kt & 1) * 2 * BSPLIT;
        high_split_b<TN>(Braw + s * sg::TK * (TN + 4), bh, bh + BSPLIT);
      },
      [&](int kt, int s) {
        const __nv_bfloat16* bh = Bsp + (kt & 1) * 2 * BSPLIT;
        high_mma<NT>(As + s * H_ASTAGE, m0, bh, bh + BSPLIT, H_BLD, n0, 0, acc);
      });
  // pipeline() ended with a barrier: the B staging is free. DinvT (0 +
  // the sum, as the two-launch kernel's tile accumulates it) into the
  // pivot rows in FP32 and into Dh / Dl[c][i] as its halves.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + mt * 16 + g + 8 * h, c = n0 + nt * 8 + tg * 2;
        const float v0 = 0.0f + acc[mt][nt][2 * h], v1 = 0.0f + acc[mt][nt][2 * h + 1];
        *reinterpret_cast<float2*>(Sb + (i64)(j * NB + i) * wid + c0 + c) =
            make_float2(v0, v1);
        const __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
        Dh[c * H_DLD + i] = h0;
        Dh[(c + 1) * H_DLD + i] = h1;
        Dl[c * H_DLD + i] = __float2bfloat16_rn(v0 - __bfloat162float(h0));
        Dl[(c + 1) * H_DLD + i] = __float2bfloat16_rn(v1 - __bfloat162float(h1));
      }
  __syncthreads();
  // Phase 2: S[ib rows, strip] -= C[ib rows] . DinvT for every row block ib
  // != j, C's k-tiles streaming through the ring across the blocks.
  zero();
  const float* C = Sb + w_out;
  const int blocks = n / NB - 1;
  sg::pipeline(
      blocks * KT,
      [&](int kt, int s) {
        const int blk = kt / KT, ib = blk < j ? blk : blk + 1;
        high_load_a(As + s * H_ASTAGE, C + (i64)ib * NB * wid + (kt % KT) * sg::TK,
                    wid);
      },
      [&](int, int s) { high_split_a(As + s * H_ASTAGE); },
      [&](int kt, int s) {
        const int blk = kt / KT, ib = blk < j ? blk : blk + 1;
        if (kt % KT == 0) {
          // The block's strip into the L2 ahead of its epilogue (128 rows
          // of TN floats, TN / 32 lines of 128 bytes a row): the epilogue's
          // loads then wait on the L2, not on device memory.
#pragma unroll
          for (int e = 0; e < TN / 64; ++e) {
            const int f = threadIdx.x + sg::THREADS * e, r = f / (TN / 32),
                      c = (f % (TN / 32)) * 32;
            asm volatile("prefetch.global.L2 [%0];" ::"l"(
                Sb + (i64)(ib * NB + r) * wid + c0 + c));
          }
        }
        high_mma<NT>(As + s * H_ASTAGE, m0, Dh, Dl, H_DLD, n0, (kt % KT) * sg::TK,
                     acc);
        if (kt % KT != KT - 1) return;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = ib * NB + m0 + mt * 16 + g + 8 * h;
              float2* p = reinterpret_cast<float2*>(
                  Sb + (i64)i * wid + c0 + n0 + nt * 8 + tg * 2);
              float2 v = *p;
              v.x -= 0.0f + acc[mt][nt][2 * h];
              v.y -= 0.0f + acc[mt][nt][2 * h + 1];
              *p = v;
            }
        zero();
      });
}
}  // namespace

// Grid (ceil(w_out / 128), B), as level_strip_kernel's.
__global__ void __launch_bounds__(sg::THREADS, sg::MIN_BLOCKS)
level_strip_kernel_high(float* __restrict__ S, const float* __restrict__ Dinv,
                        int n, int wid, int j, int w_out) {
  extern __shared__ __align__(16) unsigned char hsmem[];
  const int b = blockIdx.y, c0 = blockIdx.x * 128;
  float* Sb = S + (i64)b * n * wid;
  const float* Db = Dinv + (i64)b * NB * NB;
  if (c0 + 128 <= w_out)
    level_strip_high<128>(Sb, Db, n, wid, j, w_out, c0, hsmem);
  else
    level_strip_high<64>(Sb, Db, n, wid, j, w_out, c0, hsmem);
}

// S: contiguous (B, n, wid); Dinv: contiguous (B, 128, 128); both 16-byte
// aligned. n % 128 == 0, 0 <= j < n / 128, w_out % 64 == 0, w_out + 128 <=
// wid, wid % 4 == 0, 0 < B <= 65535. prec: 0 FP32 (level_strip_kernel), 1
// bf16x3 (level_strip_kernel_high).
extern "C" int qps_slab_level_strip(float* S, const float* Dinv, int B, int n,
                                    int wid, int j, int w_out, int prec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prec != static_cast<int>(qps::Prec::kHighest) &&
      prec != static_cast<int>(qps::Prec::kHigh))
    return (int)cudaErrorInvalidValue;
  const bool high = prec == static_cast<int>(qps::Prec::kHigh);
  auto kernel = high ? level_strip_kernel_high : level_strip_kernel;
  const size_t bytes = high ? HIGH_SMEM : STRIP_SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((w_out + 127) / 128, B), sg::THREADS, bytes, s>>>(
      S, Dinv, n, wid, j, w_out);
  return (int)cudaGetLastError();
}
