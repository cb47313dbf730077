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
// What bounds it on the H100: 128 dependent rank-1 steps of 16,384 products
// a block (4.2 MFLOP a block with the rounded product and the subtraction
// apart), each waiting on the one before it: the chain's latency, unless the
// SM has other chains to run meanwhile. The bytes (the block read once and
// written once) are 0.020 ms at B=512.
//
// sweep_block_kernel (every entry point's): pivot_sweep.cu's v3 layout. One
// CTA of 256 threads a block, two CTAs an SM (two independent chains). Warp
// w holds rows 16w..16w+15 and lane l columns 4l..4l+3 of W in 64
// registers. The step loop is unrolled by 16 inside a loop over the 8 row
// owners, so every register index is a compile-time constant: pivot row j
// sits in register row j % 16 of warp j / 16, pivot column j in register
// column j % 4 of lane j / 4. A step reads the pivot column (4 broadcast
// 16-byte loads), its own four pivot-row entries (one 16-byte load) and the
// pivot; the row's and the column's owners publish the next pivot row and
// column into the other half of a double buffer, and one __syncthreads()
// separates the steps. FOLD's e_j fix touches one column, so it runs only in
// that column's owners: r - 0 is r, bit for bit.
//
// sweep_block_prev_kernel (the witness entries qps_pivot_sweep_2d_prev,
// qps_pivot_sweep_ref_prev and qps_normal_inverse_prev): the first port of
// the same arithmetic, kept as the new kernel's bit-for-bit witness and
// timing baseline; nothing in the solver or the entry points launches it.
// One CTA of 512 threads a block (rows ty*8..ty*8+7 at columns tx + 32c)
// whose step loop is not unrolled, so the pivot's register row and column
// depend on the step and every step selects them through predicated copies.
//
// Both read D through strides (a pivot block of a larger matrix needs no
// copy) and write a contiguous (B, 128, 128) tensor.

#pragma once

#include "common.cuh"

namespace qps {

constexpr int kSweepThreads = 256;      // sweep_block_kernel
constexpr int kSweepPrevThreads = 512;  // sweep_block_prev_kernel

template <bool GUARD, bool FOLD>
__global__ void __launch_bounds__(kSweepThreads, 2)
sweep_block_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                   float* __restrict__ out) {
  constexpr int NB = 128;
  constexpr int ROWS = NB / (kSweepThreads / 32);  // rows a warp holds: 16
  __shared__ __align__(16) float cbuf[2][NB];
  __shared__ __align__(16) float rbuf[2][NB];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = warp * ROWS, k0 = lane * 4;
  const float* Db = D + (i64)b * d_batch;

  float w[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) w[r][c] = Db[(i64)(i0 + r) * d_row + k0 + c];

  for (int jb = 0; jb < NB / ROWS; ++jb) {  // pivot rows owned by warp jb
#pragma unroll
    for (int jr = 0; jr < ROWS; ++jr) {
      const int j = jb * ROWS + jr;
      const int buf = jr & 1, cj = jr & 3;  // j & 1, j & 3 (ROWS % 4 == 0)
      const bool row_owner = warp == jb, col_owner = lane == (j >> 2);
      // Publish pivot row j and pivot column j as step j - 1 left them.
      if (row_owner)
        *reinterpret_cast<float4*>(&rbuf[buf][k0]) =
            make_float4(w[jr][0], w[jr][1], w[jr][2], w[jr][3]);
      if (col_owner) {
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q)
          *reinterpret_cast<float4*>(&cbuf[buf][i0 + 4 * q]) =
              make_float4(w[4 * q][cj], w[4 * q + 1][cj], w[4 * q + 2][cj],
                          w[4 * q + 3][cj]);
      }
      __syncthreads();
      float d = rbuf[buf][j];
      if (GUARD && d == 0.0f) d = 1.0f;
      const float dinv = 1.0f / d;
      float a[ROWS], r[4], rc[4];
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&cbuf[buf][i0 + 4 * q]);
        a[4 * q] = __fmul_rn(v.x, dinv);
        a[4 * q + 1] = __fmul_rn(v.y, dinv);
        a[4 * q + 2] = __fmul_rn(v.z, dinv);
        a[4 * q + 3] = __fmul_rn(v.w, dinv);
      }
      {
        const float4 v = *reinterpret_cast<const float4*>(&rbuf[buf][k0]);
        r[0] = rc[0] = v.x;
        r[1] = rc[1] = v.y;
        r[2] = rc[2] = v.z;
        r[3] = rc[3] = v.w;
      }
      if (FOLD && col_owner) rc[cj] = __fsub_rn(r[cj], 1.0f);  // k == j
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          w[i][c] = __fsub_rn(w[i][c], __fmul_rn(a[i], rc[c]));
      if (!FOLD && col_owner) {  // column j = c dinv
#pragma unroll
        for (int i = 0; i < ROWS; ++i) w[i][cj] = a[i];
      }
      if (row_owner) {  // row j = r dinv, then (j, j) = -dinv
#pragma unroll
        for (int c = 0; c < 4; ++c) w[jr][c] = __fmul_rn(r[c], dinv);
        if (col_owner) w[jr][cj] = -dinv;
      }
    }
  }

  float* ob = out + (i64)b * NB * NB;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    *reinterpret_cast<float4*>(&ob[(i0 + i) * NB + k0]) =
        make_float4(-w[i][0], -w[i][1], -w[i][2], -w[i][3]);
}

template <bool GUARD, bool FOLD>
__global__ void __launch_bounds__(kSweepPrevThreads)
sweep_block_prev_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
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

// Launches the sweep on B blocks of D (element (b, i, k) at D[b*d_batch +
// i*d_row + k]) into the contiguous (B, 128, 128) out; PREV picks the
// witness kernel.
template <bool GUARD, bool FOLD, bool PREV = false>
inline int launch_sweep_block(const float* D, i64 d_batch, i64 d_row,
                              float* out, int B, cudaStream_t s) {
  if (PREV)
    sweep_block_prev_kernel<GUARD, FOLD><<<B, kSweepPrevThreads, 0, s>>>(D, d_batch, d_row, out);
  else
    sweep_block_kernel<GUARD, FOLD><<<B, kSweepThreads, 0, s>>>(D, d_batch, d_row, out);
  return (int)cudaGetLastError();
}

}  // namespace qps
