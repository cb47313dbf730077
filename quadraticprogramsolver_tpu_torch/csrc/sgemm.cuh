// FP32 product core for Hopper's CUDA cores (sm_90a): the slab build's gram
// (slab_build.cu) and the slab level's products (slab_level.cu).
//
// A 128 x TN output tile (TN = 64 or 128) of 256 threads. Thread (ty, tx),
// ty, tx < 16, owns rows ty*8 .. ty*8+7 and the columns tx*4 .. tx*4+3 (and,
// at TN = 128, 64 + tx*4 .. 64 + tx*4+3): an 8 x 4 or 8 x 8 register
// micro-tile. A warp covers 4 row groups by 8 column groups, so a k step
// reads its fragments with two 16-byte shared loads of A and TN/64 of B, each
// one conflict-free wavefront, for 8 * TN/16 FMAs.
//
// K is staged TK = 16 deep through a ring of STAGES shared-memory stages
// filled by cp.async (pipeline()): the loads of stage kt + 2 are in flight
// while stage kt's FMAs run, and a stage costs one __syncthreads.
//   A stage is k-major, As[k][i] with pitch LDA = 132 floats: copied 16 bytes
//   at a time from a k-major source (load_a_kmajor), or transposed element by
//   element from a row-major one (load_a_rowmajor: a warp covers 4 rows by 8
//   k, whose shared addresses fall in 32 distinct banks at this pitch).
//   A B stage is Bs[k][c] with pitch TN (load_b).
//
// Bits: every output element has one accumulator, started at 0 by the caller
// and summed over k in order with explicit fmaf, as common.cuh: tile_gemm
// sums it. The same operands in the same k order give tile_gemm's bits.
//
// Two CTAs an SM (128 registers a thread) beat one: on the H100 a 4-stage
// ring, 32-deep stages, one CTA an SM with no spill, or an L2 prefetch of the
// epilogues' tiles each gained nothing or lost (PERF.md).

#pragma once

#include "common.cuh"

namespace qps {
namespace sgemm {

constexpr int TM = 128;      // tile rows
constexpr int TK = 16;       // k depth of a stage
constexpr int LDA = TM + 4;  // pitch of a k-major A stage, floats
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int A_STAGE = TK * LDA;  // floats of one A stage
constexpr int MIN_BLOCKS = 2;  // CTAs an SM: at most 128 registers a thread

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int tile_ty() {
  return (threadIdx.x % 32) / 8 + 4 * (threadIdx.x / 64);
}

__device__ __forceinline__ int tile_tx() {
  return threadIdx.x % 8 + 8 * ((threadIdx.x / 32) % 2);
}

// A stage from a k-major source: As[k][i] = g[k * ld + i], k < 16, i < 128.
// g and ld 16-byte aligned.
__device__ __forceinline__ void load_a_kmajor(float* As, const float* g, i64 ld) {
#pragma unroll
  for (int e = 0; e < TK / 8; ++e) {
    const int f = threadIdx.x + THREADS * e;
    const int k = f / 32, i4 = (f % 32) * 4;
    cp_async16(As + k * LDA + i4, g + k * ld + i4);
  }
}

// A stage from a row-major source, transposed: As[k][i] = g[i * ld + k].
__device__ __forceinline__ void load_a_rowmajor(float* As, const float* g, i64 ld) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < TK / 2; ++e) {
    const int task = warp + 8 * e;  // 32 row quads x TK/8 k octets
    const int i = (task % 32) * 4 + lane % 4, k = (task / 32) * 8 + lane / 4;
    cp_async4(As + k * LDA + i, g + (i64)i * ld + k);
  }
}

// A B stage: Bs[k][c] = g[k * ld + c], k < 16, c < TN. g and ld 16-byte
// aligned. At TN = 128 thread t copies rows t/32 and t/32 + 8, columns
// (t % 32) * 4 .. + 3 (slab_build.cu scales what it copied).
template <int TN>
__device__ __forceinline__ void load_b(float* Bs, const float* g, i64 ld) {
  constexpr int Q = TN / 4;  // float4s a row
#pragma unroll
  for (int e = 0; e < TK * Q / THREADS; ++e) {
    const int f = threadIdx.x + THREADS * e;
    const int k = f / Q, c4 = (f % Q) * 4;
    cp_async16(Bs + k * TN + c4, g + k * ld + c4);
  }
}

// acc[r][c] += sum_{k < TK} As[k][ty*8 + r] * Bs[k * ldb + (c/4)*64 + tx*4 +
// c%4], k in order, one fmaf a term.
template <int TN>
__device__ __forceinline__ void mma(const float* As, const float* Bs, int ldb,
                                    float (&acc)[8][TN / 16]) {
  constexpr int NC = TN / 16;
  const int ty = tile_ty(), tx = tile_tx();
  const float* a = As + ty * 8;
  const float* bp = Bs + tx * 4;
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * LDA + 4);
    const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float br[NC];
#pragma unroll
    for (int h = 0; h < NC / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(bp + k * ldb + h * 64);
      br[h * 4 + 0] = v.x;
      br[h * 4 + 1] = v.y;
      br[h * 4 + 2] = v.z;
      br[h * 4 + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// Runs KT k-tiles through the ring: issue(kt, s) starts tile kt's cp.async
// copies into stage s; arrived(kt, s) runs once this thread's own copies of
// tile kt have landed (it may rewrite them) and before the block-wide
// barrier that publishes the stage; consume(kt, s) reads stage s. Ends with
// every copy landed and a barrier, so the caller may reuse the ring.
template <typename Issue, typename Arrived, typename Consume>
__device__ __forceinline__ void pipeline(int KT, Issue issue, Arrived arrived,
                                         Consume consume) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    arrived(kt, kt % STAGES);
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) issue(next, next % STAGES);
    cp_async_commit();
    consume(kt, kt % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace sgemm
}  // namespace qps
