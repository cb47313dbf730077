// v3 pivot sweep: batched 128x128 SPD inverse by unpivoted Gauss-Jordan.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/spd_kernels.py:
// _pivot_sweep_v3_kernel (reached through pallas_spd_inverse_unrolled with
// variant="v3"). Same arithmetic, per block D:
//
//   s = 1/sqrt(diag(D));  W = D * s_col * s_row        (Jacobi scaling)
//   for j in 0..127:                                    (folded row fix)
//     dinv = 1 / W[j, j];  a = (W[:, j] - e_j) * dinv
//     W -= a (W[j, :] - e_j)'
//   out = (2I - W) * s_col * s_row
//
// Without the scaling the folded row fix loses about 3 digits when the
// diagonal is large (spd_kernels.py:238-242), so it is kept.
//
// What bounds it on the H100: 128 dependent rank-1 steps of 16,384 FMAs
// each per block, 2.1 MFLOP/block, 4 blocks per lane at n=512: 35 GFLOP at
// B=4096. It is latency-bound (one barrier per step), not FLOP- or
// byte-bound. Design: one CTA of 512 threads per block with the whole block
// in registers (32 floats per thread: rows ty*8..ty*8+7, columns tx+32c), so
// a step reads only the pivot row and column from shared memory (12 loads per
// thread) and one __syncthreads() separates the steps — it stands in for the
// sequential order the TPU got for free. The pivot row/column buffers are
// double-buffered by step parity, which is what makes one barrier per step
// enough. D is read through strides (a pivot block of the slab needs no
// copy); the output is a contiguous (B, 128, 128) tensor.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int NB = 128;
constexpr int THREADS = 512;
}  // namespace

__global__ void __launch_bounds__(THREADS)
pivot_sweep_v3_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
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
