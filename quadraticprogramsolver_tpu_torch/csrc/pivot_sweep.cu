// v3 pivot sweep: batched 128x128 SPD inverse by unpivoted Gauss-Jordan.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/spd_kernels.py:
// _pivot_sweep_v3_kernel (reached through pallas_spd_inverse_unrolled with
// variant="v3"). Same arithmetic, per block D:
//
//   s = 1/sqrt(diag(D));  W = D * s_col * s_row        (Jacobi scaling)
//   for j in 0..127:                                    (folded row fix)
//     dinv = 1 / W[j, j];  a = (W[:, j] - e_j) * dinv
//     W -= a (W[j, :] - e_j)'                           (one contracted FMA)
//   out = (2I - W) * s_col * s_row
//
// Without the scaling the folded row fix loses about 3 digits when the
// diagonal is large (spd_kernels.py:238-242), so it is kept.
//
// What bounds it on the H100: 128 dependent rank-1 steps of 16,384 FMAs
// each per block (2.1 MFLOP a block, 32 us of FP32 FMA at B=512 on the whole
// card). Each step waits on the one before it, so the time is the chain's
// latency unless the SM has other chains to run meanwhile.
//
// pivot_sweep_v3_kernel (the solver's, entry qps_pivot_sweep_v3): one CTA
// of 256 threads per block, two CTAs per SM (two independent chains). Warp w
// holds rows 16w..16w+15 and lane l columns 4l..4l+3 of W in 64 registers.
// The step loop is unrolled by 16 inside a loop over the 8 row owners, so
// every register index is known at compile time: pivot row j sits in
// register row j % 16 of warp j / 16, pivot column j in register column
// j % 4 of lane j / 4. A step reads the pivot column (4 broadcast 16-byte
// loads), its own four pivot-row entries (one 16-byte load) and the pivot,
// then runs its 64 FMAs; the row's and the column's owners publish the next
// pivot row and column into the other half of a double buffer, and one
// __syncthreads() separates the steps. The e_j fixes touch one row and one
// column, so they run only in their owners: (c - 0) * dinv is c * dinv and
// r - 0 is r, bit for bit.
//
// pivot_sweep_v3_prev_kernel (entry qps_pivot_sweep_v3_prev): the first
// port of the same arithmetic, kept as the new kernel's bit-for-bit witness
// and timing baseline; nothing in the solver launches it. One CTA of 512
// threads per block (rows ty*8..ty*8+7 at columns tx + 32c) indexes its
// register array with the step (w[j % 8][j / 32]), which puts the array in
// local memory (128 bytes of stack a thread): every step's 32 FMAs a
// thread then go through L1, and one such CTA fills an SM's registers.
//
// Both read D through strides (a pivot block of the slab needs no copy) and
// write a contiguous (B, 128, 128) tensor.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int NB = 128;
constexpr int THREADS = 256;       // pivot_sweep_v3_kernel
constexpr int PREV_THREADS = 512;  // pivot_sweep_v3_prev_kernel
constexpr int ROWS = NB / (THREADS / 32);  // rows a warp holds: 16
}  // namespace

__global__ void __launch_bounds__(THREADS, 2)
pivot_sweep_v3_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                      float* __restrict__ out) {
  __shared__ float diag[NB];
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
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + r, k = k0 + c;
      w[r][c] = Db[(i64)i * d_row + k];
      if (i == k) diag[i] = w[r][c];
    }
  __syncthreads();
  {
    float s_row[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s_row[c] = 1.0f / sqrtf(diag[k0 + c]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s_col = 1.0f / sqrtf(diag[i0 + r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = w[r][c] * s_col * s_row[c];
    }
  }

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
      const float dinv = 1.0f / rbuf[buf][j];
      float a[ROWS], rr[4];
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&cbuf[buf][i0 + 4 * q]);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      {
        const float4 v = *reinterpret_cast<const float4*>(&rbuf[buf][k0]);
        rr[0] = v.x;
        rr[1] = v.y;
        rr[2] = v.z;
        rr[3] = v.w;
      }
      if (row_owner) a[jr] = a[jr] - 1.0f;    // i == j
      if (col_owner) rr[cj] = rr[cj] - 1.0f;  // k == j
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = a[r] * dinv;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) w[r][c] -= a[r] * rr[c];
    }
  }

  float* ob = out + (i64)b * NB * NB;
  float s_row[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s_row[c] = 1.0f / sqrtf(diag[k0 + c]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + r;
    const float s_col = 1.0f / sqrtf(diag[i]);
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = ((i == k0 + c ? 2.0f : 0.0f) - w[r][c]) * s_col * s_row[c];
    *reinterpret_cast<float4*>(&ob[i * NB + k0]) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

__global__ void __launch_bounds__(PREV_THREADS)
pivot_sweep_v3_prev_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                      float* __restrict__ out) {
  __shared__ float diag[NB];
  __shared__ float cbuf[2][NB];
  __shared__ float rbuf[2][NB];
  const int b = blockIdx.x;
  const int t = threadIdx.x, tx = t & 31, ty = t >> 5;
  const float* Db = D + (i64)b * d_batch;

  float w[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty * 8 + r, k = tx + 32 * c;
      w[r][c] = Db[(i64)i * d_row + k];
      if (i == k) diag[i] = w[r][c];
    }
  __syncthreads();

  float s_col[8], s_row[4];
#pragma unroll
  for (int r = 0; r < 8; ++r) s_col[r] = 1.0f / sqrtf(diag[ty * 8 + r]);
#pragma unroll
  for (int c = 0; c < 4; ++c) s_row[c] = 1.0f / sqrtf(diag[tx + 32 * c]);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) w[r][c] = w[r][c] * s_col[r] * s_row[c];

  for (int j = 0; j < NB; ++j) {
    const int buf = j & 1;
    // Publish pivot row j (owned by warp j/8, register row j%8) and pivot
    // column j (owned by lane j%32 of every warp, register column j/32).
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
    const float dinv = 1.0f / rbuf[buf][j];
    float a[8], rr[4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      a[r] = (cbuf[buf][i] - (i == j ? 1.0f : 0.0f)) * dinv;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = tx + 32 * c;
      rr[c] = rbuf[buf][k] - (k == j ? 1.0f : 0.0f);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] -= a[r] * rr[c];
  }

  float* ob = out + (i64)b * NB * NB;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty * 8 + r, k = tx + 32 * c;
      ob[i * NB + k] = ((i == k ? 2.0f : 0.0f) - w[r][c]) * s_col[r] * s_row[c];
    }
}

// D: (B, 128, 128) view with element (b, i, k) at D[b*d_batch + i*d_row + k].
// out: contiguous (B, 128, 128).
extern "C" int qps_pivot_sweep_v3(const float* D, i64 d_batch, i64 d_row,
                                  float* out, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pivot_sweep_v3_kernel<<<B, THREADS, 0, s>>>(D, d_batch, d_row, out);
  return (int)cudaGetLastError();
}

// The same arguments, through pivot_sweep_v3_prev_kernel.
extern "C" int qps_pivot_sweep_v3_prev(const float* D, i64 d_batch, i64 d_row,
                                       float* out, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pivot_sweep_v3_prev_kernel<<<B, PREV_THREADS, 0, s>>>(D, d_batch, d_row, out);
  return (int)cudaGetLastError();
}
