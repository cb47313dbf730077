// Paired-64 pivot sweep: batched 64x64 SPD inverse by v3's Jacobi-scaled,
// folded-fix Gauss-Jordan sweep, with the pivot column divided by the pivot.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/spd_kernels.py:
// _pivot_sweep_v3p_kernel (reached through pallas_spd_inverse_64p, which
// spd_inverse_128_schur calls twice). Per block D:
//
//   s = rsqrt(diag(D));  W = (D * s_col) * s_row
//   for j in 0..63:
//     a = (W[:, j] - e_j) / W[j, j]          (IEEE division, as :440-441;
//     W -= a (W[j, :] - e_j)'                 v3 multiplies by 1/W[j, j])
//   out = ((2I - W) * s_col) * s_row
//
// each product and difference rounded on its own (__fmul_rn, __fsub_rn,
// __fdiv_rn) and the scales by rsqrtf, as the plain PyTorch version computes
// them on the card (torch.rsqrt).
//
// The TPU kernel packs two blocks side by side into one 128-lane tile, a
// layout trick for the TPU's lane width: each block's arithmetic is its own,
// so here each block is inverted alone.
//
// Design for Hopper: one warp per block, four blocks (warps) per CTA, the
// whole block in registers: lane l holds rows l and l + 32, all 64 columns
// (128 floats). A 64x64 block is 16 KB, small enough for one warp's
// registers, and a warp needs no barrier: step j broadcasts the pivot row
// from lane j % 32 by warp shuffles (64 a step), each lane divides its own
// two column entries by the pivot, and every lane updates its 128 elements.
// The j and k loops are unrolled, so every register index is static. What
// bounds it on the H100: the 64 dependent steps of one warp (latency); the
// bound from bytes (16 KB in, 16 KB out a block) is far below. The v3 kernel
// of pivot_sweep.cu, by contrast, needs 512 threads and a block barrier for
// each of its 128 steps.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int HB = 64;
constexpr int WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;
}  // namespace

__global__ void __launch_bounds__(32 * WARPS)
pivot_sweep_v3p_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                       float* __restrict__ out, int B) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp; no block-wide barrier follows
  const float* Db = D + (i64)b * d_batch;

  float w[2][HB];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < HB; ++k) w[h][k] = Db[(i64)(lane + 32 * h) * d_row + k];
  // Jacobi scaling: sc[h] scales row lane + 32h; column k's scale is lane
  // k % 32's sc[k / 32].
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    sc[h] = rsqrtf(Db[(i64)i * d_row + i]);
  }
#pragma unroll
  for (int k = 0; k < HB; ++k) {
    const float sk = __shfl_sync(FULL, sc[k >> 5], k & 31);
#pragma unroll
    for (int h = 0; h < 2; ++h) w[h][k] = __fmul_rn(__fmul_rn(w[h][k], sc[h]), sk);
  }

#pragma unroll
  for (int j = 0; j < HB; ++j) {
    // Lane j % 32 holds row j as its register row j / 32.
    const float d = __shfl_sync(FULL, w[j >> 5][j], j & 31);
    float a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a[h] = __fdiv_rn(__fsub_rn(w[h][j], lane + 32 * h == j ? 1.0f : 0.0f), d);
    // Column k of row j is read before column k is updated.
#pragma unroll
    for (int k = 0; k < HB; ++k) {
      float rk = __shfl_sync(FULL, w[j >> 5][k], j & 31);
      if (k == j) rk = __fsub_rn(rk, 1.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) w[h][k] = __fsub_rn(w[h][k], __fmul_rn(a[h], rk));
    }
  }

  float* ob = out + (i64)b * HB * HB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    float4* row = reinterpret_cast<float4*>(ob + i * HB);
#pragma unroll
    for (int k4 = 0; k4 < HB / 4; ++k4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * k4 + e;
        const float sk = __shfl_sync(FULL, sc[k >> 5], k & 31);
        v[e] = __fmul_rn(__fmul_rn(__fsub_rn(i == k ? 2.0f : 0.0f, w[h][k]), sc[h]), sk);
      }
      row[k4] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// D: (B, 64, 64) view with element (b, i, k) at D[b*d_batch + i*d_row + k].
// out: contiguous (B, 64, 64), 16-byte aligned.
extern "C" int qps_pivot_sweep_v3p(const float* D, i64 d_batch, i64 d_row,
                                   float* out, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pivot_sweep_v3p_kernel<<<(B + WARPS - 1) / WARPS, 32 * WARPS, 0, s>>>(
      D, d_batch, d_row, out, B);
  return (int)cudaGetLastError();
}
