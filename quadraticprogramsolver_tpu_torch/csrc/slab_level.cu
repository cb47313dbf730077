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
// rows would race every other CTA still reading them. Both strip kernels
// below avoid it the same way: a CTA owns the columns [c0, c0 + 128) of one
// lane (the last strip 64 wide when w_out % 128 == 64) over all n rows, so
// no other CTA reads or writes them; the pivot columns are not written at
// this level. The grid is (strips, B), strips fastest, so a lane's strips
// share C and Dinv in the L2.
//
// level_strip_kernel_x6 (qps_slab_level_strip at prec 0, "highest", the TPU
// kernel's Precision.HIGHEST dots): the FP32 level on the tensor cores. Every
// FP32 operand x is split into three bf16 pieces, hi = rn(x), mid = rn(x -
// hi), lo = rn(x - hi - mid), which hold its 24-bit significand exactly, and
// a product keeps the six cross terms down to 2^-16 of it: per 16-deep k
// chunk the passes lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi, small terms
// first, each a wgmma m64nTNk16 with A's pieces in registers and B's in
// shared memory; mid.lo, lo.mid and lo.lo, below 2^-23 of the product, are
// dropped. This is XLA's bf16x6 arithmetic for Precision.HIGHEST on a TPU
// (BF16_BF16_F32_X6). The tensor cores round each pass's sum toward zero, so
// a chunk's six passes go into a fresh accumulator, added into the FP32 sum
// on the CUDA cores with von Neumann rounding (unbias below): one running
// accumulator over all 48 passes had 3-8x the FP32 level's error against
// float64, and chunk sums added as they came drifted toward zero over a
// whole factor; as built, its error is 0.5-0.9x the FP32 level's.
//   Per CTA, 384 threads: warpgroups 0 and 1 consume, warpgroup 2 gives its
// registers up (setmaxnreg) and one of its threads produces. The producer
// streams, through a 3-stage ring, the strip's pivot rows, Dinv and then
// C's 64-row halves (every row block but j) as 2D TMA copies of 64 rows,
// each completing on a barrier of its warpgroup, and prefetches each half's
// strip rows into the L2. Phase 1: warpgroup c splits pivot half c into
// phase 1's B pieces (K-major 8 x 8 core matrices, no swizzle) and computes
// DinvT's rows 64c .. 64c + 63 = Dinv . T[j rows, strip]; DinvT stays in
// shared memory as phase 2's B pieces (3 x 128 x 128 bf16, 96 KB) and goes
// into the pivot rows in FP32. Phase 2: warpgroup c takes the halves h = c,
// c + 2, ..., splits each 16-deep chunk of C in registers (the next chunk's
// split overlapping this one's passes), and subtracts the 64 x TN
// product from its rows of the strip, read and written once. One CTA an SM
// (198 KB of shared memory).
//   What bounds it on the H100: at n=512, m=256, B=4096 the four levels
// read and write ~38.6 GB of slab (11.5 ms at 3.35 TB/s) and cost 1.10 TFLOP
// of FP32 products, 6.6 PFLOP of bf16 ones at six passes (6.7 ms at 989
// TFLOP/s): the bytes bind, as they did not on the CUDA cores (16.4 ms at 67
// TFLOP/s). The design reads and writes the strip once and streams C, Dinv
// and the pivot rows by TMA ahead of their use; the splits and the chunk
// sums run beside the products. It reaches about half the bound: a
// warpgroup's chunks wait on their sums, and a CTA's phases run in turn.
//
// level_strip_kernel_high (qps_slab_level_strip at prec 1, bf16x3, kHigh,
// Settings.factor_precision="high", the TPU kernel's manual branch,
// fused_factor.py: 151-165): the same strips on the tensor cores in bf16x3
// with mma.sync. Phase 1
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
// witness (no solver launches it): at FP32 (prec 0) sequential fmaf sums on
// the CUDA cores, the FP32 error the x6 kernel is held to. At bf16x3 (prec 1)
// the level's small
// operands, Dinv and the pivot rows of T in the first launch, C and DinvT in
// the second, are split into bf16 halves as they are staged (round to
// nearest even, common.cuh: Prec), and the tile's product is three bf16
// passes on the tensor cores, ah.bh + ah.bl + al.bh with FP32 accumulation
// (mma.sync m16n8k16; lo.lo dropped, as the TPU kernel drops it); T itself
// enters the update elementwise, unsplit. Update tiles in the pivot rows
// skip the product and copy DinvT.

#include <cuda.h>

#include <cstdint>

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

// ---- level_strip_kernel_x6 -------------------------------------------------
namespace x6 {
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume; 2 produces
constexpr int STAGES = 3;
constexpr int ROWS = 64;       // C rows a stage: one warpgroup's task
constexpr int PITCH = NB + 8;  // floats a ring row (544 bytes): the float2
                               // fragment loads of a half-warp hit 32 banks;
                               // also the TMA box's width
constexpr int STAGE_FLOATS = ROWS * PITCH;
constexpr int PIECES_BYTES = 3 * NB * 128 * 2;  // hi, mid, lo at TN = 128
constexpr size_t RING_BYTES = sizeof(float) * STAGES * STAGE_FLOATS;
constexpr size_t SMEM = PIECES_BYTES + RING_BYTES + 3 * STAGES * 8;
}  // namespace x6

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier 1 over the two consumer warpgroups (the producer never waits on
// it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the computation of A's pieces past a wait.
__device__ __forceinline__ void fence_regs(unsigned (&a)[3][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][i])::"memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A . B + (scale_d ? d : 0) for a 64 x N tile (N = 128 or 64), 16 deep
// (one wgmma.mma_async, not waited for): A's bf16 fragment
// in registers (warp w of the warpgroup rows 16w .. 16w + 15; thread (g, tg)
// = (lane / 4, lane % 4) the pairs (g, 2tg), (g + 8, 2tg), (g, 2tg + 8), (g
// + 8, 2tg + 8) along k), B in shared memory behind the descriptor, FP32
// accumulators d[4i + 2h + u] at (16w + g + 8h, 8i + 2tg + u).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


template <int TN>
__device__ __forceinline__ void wgmma(float (&d)[TN / 2], const unsigned (&a)[4],
                                      uint64_t desc, int scale_d = 1) {
  if constexpr (TN == 128)
    wgmma_n128(d, a, desc, scale_d);
  else
    wgmma_n64(d, a, desc, scale_d);
}

// The three bf16 pieces of x and of y, packed as (x's, y's) pairs: hi =
// rn(x), mid = rn(x - hi), lo = rn(x - hi - mid), round to nearest even.
// Both subtractions are exact in FP32, and the three pieces hold the 24-bit
// significand exactly (for |x| >= 2^-110, where lo is not below bf16's
// least subnormal, and below bf16's largest finite value).
__device__ __forceinline__ void split3(float x, float y, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x -= __low2float(h);
  y -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  x -= __low2float(m);
  y -= __high2float(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  mid = *reinterpret_cast<const unsigned*>(&m);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Byte offset of element (k, c) in one bf16 piece of a wgmma B operand of
// 128 rows k and TN columns c, K-major without swizzle: 8 x 8 core matrices
// of 128 contiguous bytes (8 columns of 16 bytes, 8 k each); a 16-deep
// chunk's two k halves 128 bytes apart (the descriptor's leading offset),
// its 8-column groups 256 bytes apart (the stride offset), chunks 32 TN
// bytes apart. A piece is 256 TN bytes.
template <int TN>
__device__ __forceinline__ int b_offset(int k, int c) {
  return (k >> 4) * (32 * TN) + (c >> 3) * 256 + ((k >> 3) & 1) * 128 +
         (c & 7) * 16 + (k & 7) * 2;
}

__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// v with the last bit of its significand set: v itself or its neighbour
// away from zero, as that bit was (von Neumann rounding). The tensor cores
// round a pass's sum toward zero, which cuts off half an ulp on average;
// this puts it back on average, so the chunks' sums add up with no drift
// toward zero, for one integer operation.
__device__ __forceinline__ float unbias(float v) {
  return __int_as_float(__float_as_int(v) | 1);
}

// acc = A . B for a 64 x TN tile, 128 deep, in bf16x6: for each 16-deep
// chunk kc, its six passes (lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi of
// A's pieces in registers against B's at bbase + p * 256 TN + 32 TN kc)
// into a fresh accumulator c, then acc += unbias(c) on the CUDA cores
// (round to nearest): the tensor cores round each pass's sum toward zero,
// so a chunk's rounding is relative to that chunk's sum, not to the whole
// product's, and unbias takes out its drift toward zero. mid.lo, lo.mid and
// lo.lo (below 2^-23 of the product) are dropped. frag(kc, f) gives the
// thread's four FP32 pairs of A's chunk kc; released() runs once the last
// chunk's pairs are in registers. The next chunk's split overlaps this
// chunk's passes (two register sets); one accumulator c, as a second one
// leaves the warpgroup too few registers to keep its passes in flight.
template <int TN, class Frag, class Released>
__device__ __forceinline__ void product6(float (&acc)[TN / 2], float (&c)[TN / 2],
                                         unsigned bbase, Frag frag,
                                         Released released) {
  constexpr int KC = NB / 16, PB = 256 * TN;
  unsigned a[2][3][4];
  auto split = [&](int kc) {
    float2 f[4];
    frag(kc, f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split3(f[i].x, f[i].y, a[kc & 1][0][i], a[kc & 1][1][i], a[kc & 1][2][i]);
    if (kc == KC - 1) released();
  };
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
  const uint64_t desc0 = b_desc(bbase);
  split(0);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    // Each chunk's descriptors from one base, so that the compiler keeps
    // two registers for them and not 48: a descriptor's low 14 bits are the
    // address in 16-byte units, and every piece lies below 256 KB.
    uint64_t d = desc0;
    asm volatile("" : "+l"(d));
    d += kc * 32 * TN / 16;
    const unsigned (&p)[3][4] = a[kc & 1];
    wgmma_fence();
    wgmma<TN>(c, p[2], d, 0);
    wgmma<TN>(c, p[1], d + PB / 16);
    wgmma<TN>(c, p[0], d + 2 * PB / 16);
    wgmma<TN>(c, p[1], d);
    wgmma<TN>(c, p[0], d + PB / 16);
    wgmma<TN>(c, p[0], d);
    wgmma_commit();
    if (kc + 1 < KC) {
      split(kc + 1);
      fence_regs(a[(kc + 1) & 1]);
    }
    wgmma_wait<0>();
    fence_acc(c);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] += unbias(c[i]);
  }
}

// Half e of the strip's pivot rows (k = 64e .. 64e + 63 of the pivot block,
// FP32 in a ring stage, pitch x6::PITCH) as phase 1's three B pieces: each
// warp of the warpgroup splits 8 x 8 tiles, lane (kp, cl) = (lane % 4, lane
// / 4) the rows 2kp, 2kp + 1 of column cl, so a warp's 4-byte stores fall in
// 32 distinct banks.
template <int TN>
__device__ __forceinline__ void pivot_pieces(unsigned char* D, const float* st,
                                             int e, int t) {
  constexpr int TILES = TN / 4;  // a warp's 8 x 8 tiles of the 64 x TN half
  constexpr int PB = 256 * TN;
  const int warp = (t % 128) / 32, kp = t % 4, cl = (t % 32) / 4;
#pragma unroll
  for (int i = 0; i < TILES; ++i) {
    const int tile = warp + 4 * i, r = (tile % 8) * 8 + 2 * kp, col = (tile / 8) * 8 + cl;
    unsigned h, m, l;
    split3(st[r * x6::PITCH + col], st[(r + 1) * x6::PITCH + col], h, m, l);
    unsigned char* p = D + b_offset<TN>(64 * e + r, col);
    *reinterpret_cast<unsigned*>(p) = h;
    *reinterpret_cast<unsigned*>(p + PB) = m;
    *reinterpret_cast<unsigned*>(p + 2 * PB) = l;
  }
}

// One lane's strip [c0, c0 + TN) of the FP32 level, bf16x6 on the tensor
// cores: threads 0-255 the two consumer warpgroups, warpgroup 2 the producer.
// The ring carries, in order, the items: the two 64-row halves of the
// strip's pivot rows (TN columns), the two 64-row halves of Dinv, then C's
// 64-row halves of every row block but j (128 columns). Item i goes to
// warpgroup i % 2 and to stage i % STAGES; it completes on full barrier
// (i % STAGES, i % 2), so that a warpgroup waits only on its own items.
template <int TN>
__device__ __forceinline__ void level_strip_x6(float* __restrict__ Sb,
                                               const CUtensorMap* tm_s,
                                               const CUtensorMap* tm_d, int b,
                                               int n, int wid, int j, int w_out,
                                               int c0, unsigned char* smem) {
  constexpr int R = TN / 2;
  unsigned char* D = smem;  // the pivot rows' pieces, then DinvT's
  float* ring = reinterpret_cast<float*>(smem + x6::PIECES_BYTES);
  const unsigned full = smem_u32(smem + x6::PIECES_BYTES + x6::RING_BYTES);
  const unsigned empty = full + 16 * x6::STAGES;
  auto full_bar = [&](int i) { return full + 16 * (i % x6::STAGES) + 8 * (i % 2); };
  auto stage = [&](int i) { return ring + (i % x6::STAGES) * x6::STAGE_FLOATS; };
  const int t = threadIdx.x, lane = t % 32;
  const int tasks = 2 * (n / NB - 1);  // 64-row halves of the blocks != j
  auto task_row = [&](int h) {
    const int blk = h / 2;
    return (blk < j ? blk : blk + 1) * NB + (h % 2) * x6::ROWS;
  };
  if (t >= 256) {
    // Producer: warpgroup 2 hands its registers to the consumers, and one
    // thread streams the items, each one 2D TMA copy of 64 rows by PITCH
    // columns (the columns past the item's land in the stage unused, zeros
    // past a row's end); each C half's strip rows are prefetched into the
    // L2 for its epilogue by one more.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t != 256) return;
    const int row0 = b * n;  // the lane's first row in tm_s
    for (int i = 0; i < tasks + 4; ++i) {
      const int s = i % x6::STAGES, use = i / x6::STAGES;
      if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);
      const CUtensorMap* map = i >= 2 && i < 4 ? tm_d : tm_s;
      int col, row;
      if (i < 2)
        col = c0, row = row0 + j * NB + x6::ROWS * i;
      else if (i < 4)
        col = 0, row = b * NB + x6::ROWS * (i - 2);
      else
        col = w_out, row = row0 + task_row(i - 4);
      const unsigned bar = full_bar(i);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(x6::STAGE_FLOATS * 4)
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(stage(i))),
          "l"(map), "r"(col), "r"(row), "r"(bar)
          : "memory");
      if (i >= 4)
        asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];" ::"l"(tm_s),
                     "r"(c0), "r"(row)
                     : "memory");
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = t / 128, w = (t % 128) / 32, g = lane / 4, tg = lane % 4;
  const unsigned dbase = smem_u32(D);
  // Warpgroup c's m-th item is item c + 2m, the (m / STAGES)-th of its
  // items in that stage.
  auto wait_item = [&](int m) {
    mbar_wait(full_bar(c + 2 * m), (m / x6::STAGES) & 1);
  };
  // The thread's four FP32 pairs of a 64-row item's 16-deep chunk kc.
  auto frag_of = [&](int i) {
    const float* st = stage(i) + (16 * w + g) * x6::PITCH + 2 * tg;
    return [st](int kc, float2 (&f)[4]) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f[q] = *reinterpret_cast<const float2*>(st + 8 * (q & 1) * x6::PITCH + 16 * kc +
                                                8 * (q >> 1));
    };
  };
  float acc[R], chunk[R];
  // Phase 1: DinvT = Dinv . T[j rows, strip]. Warpgroup c splits pivot half
  // c (item c) into the B pieces, then computes DinvT's rows 64c .. 64c + 63
  // from Dinv's half c (item 2 + c).
  {
    wait_item(0);
    pivot_pieces<TN>(D, stage(c), c, t);
    mbar_arrive(empty + 8 * (c % x6::STAGES));
    fence_proxy_async();
    consumers_sync();
    wait_item(1);
    product6<TN>(acc, chunk, dbase, frag_of(2 + c),
                 [&] { mbar_arrive(empty + 8 * ((2 + c) % x6::STAGES)); });
    consumers_sync();  // both warpgroups' products have read the pieces
    // DinvT into D as phase 2's B pieces: lanes g and g + 1 swap one value,
    // so that each stores a (k, k + 1) pair, g even of column 2tg, g odd of
    // 2tg + 1. Then into the pivot rows in FP32.
    const int r = 64 * c + 16 * w + g, odd = g & 1;
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        unsigned hi, mid, lo;
        split3(odd ? other : v0, odd ? v1 : other, hi, mid, lo);
        unsigned char* p = D + b_offset<TN>(r + 8 * h - odd, 8 * i + 2 * tg + odd);
        *reinterpret_cast<unsigned*>(p) = hi;
        *reinterpret_cast<unsigned*>(p + 256 * TN) = mid;
        *reinterpret_cast<unsigned*>(p + 512 * TN) = lo;
      }
    fence_proxy_async();
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Sb + (i64)(j * NB + r + 8 * h) * wid + c0 + 8 * i +
                                   2 * tg) = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    consumers_sync();
  }
  // Phase 2: S[task rows, strip] -= C[task rows] . DinvT; warpgroup c takes
  // the tasks h = c, c + 2, ... (its items 2 + h / 2... = item 4 + h).
  for (int h = c; h < tasks; h += 2) {
    wait_item(2 + h / 2);
    product6<TN>(acc, chunk, dbase, frag_of(4 + h),
                 [&] { mbar_arrive(empty + 8 * ((4 + h) % x6::STAGES)); });
    // Every load of the block's strip rows before the first store.
    float* row = Sb + (i64)(task_row(h) + 16 * w + g) * wid + c0 + 2 * tg;
    float2 v[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i)
      v[i] = *reinterpret_cast<const float2*>(row + (i64)8 * (i & 1) * wid + 8 * (i >> 1));
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      v[i].x -= acc[2 * i];
      v[i].y -= acc[2 * i + 1];
      *reinterpret_cast<float2*>(row + (i64)8 * (i & 1) * wid + 8 * (i >> 1)) = v[i];
    }
  }
}
}  // namespace

// Grid (ceil(w_out / 128), B), 384 threads: CTA (x, b) owns lane b's columns
// [128x, 128x + 128) of the live region, or [128x, 128x + 64) for the last
// strip when w_out % 128 == 64.
__global__ void __launch_bounds__(x6::THREADS, 1)
level_strip_kernel_x6(float* __restrict__ S, const __grid_constant__ CUtensorMap tm_s,
                      const __grid_constant__ CUtensorMap tm_d, int n, int wid,
                      int j, int w_out) {
  extern __shared__ __align__(128) unsigned char x6smem[];
  const int b = blockIdx.y, c0 = blockIdx.x * 128;
  if (threadIdx.x == 0) {
    const unsigned full = smem_u32(x6smem + x6::PIECES_BYTES + x6::RING_BYTES);
    for (int s = 0; s < 2 * x6::STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full + 8 * s) : "memory");
    for (int s = 0; s < x6::STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 128;" ::"r"(full + 16 * x6::STAGES + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float* Sb = S + (i64)b * n * wid;
  if (c0 + 128 <= w_out)
    level_strip_x6<128>(Sb, &tm_s, &tm_d, b, n, wid, j, w_out, c0, x6smem);
  else
    level_strip_x6<64>(Sb, &tm_s, &tm_d, b, n, wid, j, w_out, c0, x6smem);
}

// The tensor maps of the x6 kernel's TMA copies: a (rows, cols) float32
// matrix with a row pitch of ld floats, read in boxes of 64 rows by PITCH
// columns (zeros past the last column). cuTensorMapEncodeTiled is looked
// up through the runtime's entry-point query, so the library links no
// libcuda.
static int x6_tensor_map(CUtensorMap* map, const float* base, long long rows,
                         int cols, int ld) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (e != cudaSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)x6::PITCH, (cuuint32_t)x6::ROWS};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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

// Grid (ceil(w_out / 128), B), CTA (x, b) lane b's strip x as
// level_strip_kernel_x6's.
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
// wid, wid % 4 == 0, 0 < B <= 65535. prec: 0 FP32 (level_strip_kernel_x6,
// bf16x6 on the tensor cores), 1 bf16x3 (level_strip_kernel_high).
extern "C" int qps_slab_level_strip(float* S, const float* Dinv, int B, int n,
                                    int wid, int j, int w_out, int prec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w_out + 127) / 128, B);
  if (prec == static_cast<int>(qps::Prec::kHigh)) {
    cudaError_t e = cudaFuncSetAttribute(
        level_strip_kernel_high, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)HIGH_SMEM);
    if (e != cudaSuccess) return (int)e;
    level_strip_kernel_high<<<grid, sg::THREADS, HIGH_SMEM, s>>>(S, Dinv, n, wid, j, w_out);
    return (int)cudaGetLastError();
  }
  if (prec != static_cast<int>(qps::Prec::kHighest)) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_s, tm_d;
  int code = x6_tensor_map(&tm_s, S, (long long)B * n, wid, wid);
  if (code == 0) code = x6_tensor_map(&tm_d, Dinv, (long long)B * NB, NB, NB);
  if (code != 0) return code;
  cudaError_t e = cudaFuncSetAttribute(
      level_strip_kernel_x6, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)x6::SMEM);
  if (e != cudaSuccess) return (int)e;
  level_strip_kernel_x6<<<grid, x6::THREADS, x6::SMEM, s>>>(S, tm_s, tm_d, n, wid, j, w_out);
  return (int)cudaGetLastError();
}
