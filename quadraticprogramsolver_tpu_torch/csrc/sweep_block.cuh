// The unscaled scalar sweep of a 128x128 block, in its two forms. Included
// by pivot_variants.cu ("ref", FOLD), pivot_sweep_2d.cu (row 6, GUARD) and
// normal_inverse.cu (its levels' pivot, neither).
//
// Arithmetic, per block D, W = D:
//
//   for j in 0..127, with the column c and row r of W read before the step:
//     d = W[j, j]  (GUARD: d == 0 reads as 1);  dinv = 1 / d
//     FOLD:  W -= (c dinv)(r - e_j)'   ("ref": the fix folded into the row)
//     else:  W -= (c dinv) r';  column j = c dinv
//     row j = r dinv;  (j, j) = -dinv   (after the column, in that order)
//   out = -W
//
// FOLD is _pivot_sweep_unrolled_kernel; GUARD without FOLD is
// _pivot_sweep_kernel_2d, and neither is _sweep_inverse_block, of
// quadraticprogramsolver_tpu/ops/spd_kernels.py, operation for operation:
// each product is rounded before it is subtracted (the non-contracting
// intrinsics __fmul_rn, __fsub_rn) and 1 / d is IEEE division, so the kernel
// rounds as its plain PyTorch version does.
//
// Layout: one CTA of 512 threads per block, the block in registers (thread
// (ty, tx) holds rows ty*8..ty*8+7 at columns tx + 32c), one barrier per
// step with the pivot row and column double-buffered in shared memory by
// step parity, as v3 (pivot_sweep.cu). D is read through strides (a pivot
// block of a larger matrix needs no copy); out is a contiguous
// (B, 128, 128). What bounds it on the H100: the 128 dependent steps
// (latency), as v3.

#pragma once

#include "common.cuh"

namespace qps {

constexpr int kSweepThreads = 512;

template <bool GUARD, bool FOLD>
__global__ void __launch_bounds__(kSweepThreads)
sweep_block_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                   float* __restrict__ out) {
  constexpr int NB = 128;
  __shared__ float cbuf[2][NB];
  __shared__ float rbuf[2][NB];
  const int b = blockIdx.x;
  const int t = threadIdx.x, tx = t & 31, ty = t >> 5;
  const float* Db = D + (i64)b * d_batch;

  float w[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) w[r][c] = Db[(i64)(ty * 8 + r) * d_row + tx + 32 * c];

  for (int j = 0; j < NB; ++j) {
    const int buf = j & 1;
    // Publish pivot row j (warp j/8, register row j%8) and pivot column j
    // (lane j%32 of every warp, register column j/32).
    if (ty == (j >> 3)) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r == (j & 7)) {
#pragma unroll
          for (int c = 0; c < 4; ++c) rbuf[buf][tx + 32 * c] = w[r][c];
        }
    }
    if (tx == (j & 31)) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c == (j >> 5)) {
#pragma unroll
          for (int r = 0; r < 8; ++r) cbuf[buf][ty * 8 + r] = w[r][c];
        }
    }
    __syncthreads();
    float d = rbuf[buf][j];
    if (GUARD && d == 0.0f) d = 1.0f;
    const float dinv = 1.0f / d;
    float a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = __fmul_rn(cbuf[buf][ty * 8 + r], dinv);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = tx + 32 * c;
      const float rc = FOLD ? __fsub_rn(rbuf[buf][k], k == j ? 1.0f : 0.0f) : rbuf[buf][k];
#pragma unroll
      for (int r = 0; r < 8; ++r) w[r][c] = __fsub_rn(w[r][c], __fmul_rn(a[r], rc));
    }
    if (!FOLD && tx == (j & 31)) {  // column j = c dinv
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c == (j >> 5)) {
#pragma unroll
          for (int r = 0; r < 8; ++r) w[r][c] = a[r];
        }
    }
    if (ty == (j >> 3)) {  // row j = r dinv, then (j, j) = -dinv
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r == (j & 7)) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = tx + 32 * c;
            w[r][c] = k == j ? -dinv : __fmul_rn(rbuf[buf][k], dinv);
          }
        }
    }
  }

  float* ob = out + (i64)b * NB * NB;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ob[(ty * 8 + r) * NB + tx + 32 * c] = -w[r][c];
}

}  // namespace qps
