// The pivot sweep's other formulations: batched 128x128 SPD inverses by
// unpivoted Gauss-Jordan, as Settings.pivot_variant names them.
//
// Replaces the TPU kernels of quadraticprogramsolver_tpu/ops/spd_kernels.py
// reached through pallas_spd_inverse_unrolled:
//
//   "ref"    _pivot_sweep_unrolled_kernel  -> sweep_block_kernel<false, true>
//                                            (sweep_block.cuh)
//   "r<q>"   _pivot_sweep_rq_kernel        -> pivot_sweep_group_kernel<false>
//   "panel"  _pivot_sweep_panel_kernel     -> pivot_sweep_group_kernel<true>
//
// ("v3" and "value", one arithmetic, are pivot_sweep.cu.) Each copies its TPU
// kernel's arithmetic operation for operation: products and sums are the
// non-contracting intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) wherever the
// TPU kernel rounds a product before it adds it, so the kernel and its plain
// PyTorch version round alike; only the panel's V.U product is a dot, summed
// by FMAs. Layout of the group kernels as in pivot_sweep_v3_prev: one CTA of 512
// threads per block, the block in registers (thread (ty, tx) holds rows
// ty*8..ty*8+7 at columns tx + 32c), D read through strides, the output a
// contiguous (B, 128, 128).
//
// "ref": no Jacobi scaling. Step j, with the column C and row r read before
// it: W -= (C dinv)(r - e_j), row j = r dinv, (j, j) = -dinv; out = -W. One
// barrier per step, as v3. Its kernel is the unscaled sweep that rows 6 and
// 12 share, with the e_j fix folded into the row (sweep_block.cuh, FOLD), in
// pivot_sweep.cu's v3 register layout; qps_pivot_sweep_ref_prev runs the first
// port (sweep_block_prev_kernel), kept as its bit-for-bit witness.
//
// "r<q>" and "panel" (q = 8): v3's scaling and folded fixes, the 128 steps
// taken q at a time. Step t of a group needs the group's pivot row and column
// as they stood at the group's start, less the earlier steps' a_u w_u: the
// in-group corrections, whose q x q scalars come from the group's own rows and
// columns. So a group is: publish its q rows and q columns to shared memory
// (barrier); one warp runs the q steps on the q x q core of those rows and
// columns, in step order (warp-synchronous); every thread then finishes the
// factors a_t (rows outside the core) and w_t (columns outside it), one
// thread a row or column (barrier); and each thread applies the whole group's
// update to its registers. Three barriers per group (four when q > 32, whose
// buffers are not doubled), 3 * 128/q per sweep against v3's 128. The rank-q
// form subtracts the summed update (a_0 w_0 + ... + a_{q-1} w_{q-1}), each
// product rounded, as the TPU kernel's elementwise sum; the panel subtracts the
// product V.U of its factors V = [a_0 .. a_7], U = [w_0; ..; w_7], summed by
// FMAs. Its factors follow the TPU kernel's panel slabs Wc = W[:, K] and Wr =
// W[K, :] updated step by step, which is the rank-q correction order.
//
// What bounds them on the H100: as v3 (latency, one dependent barrier chain),
// with fewer barriers per sweep and q^2/2 more work per row and column per
// group; the one-warp core is sequential in q.

#include "sweep_block.cuh"

using qps::i64;

namespace {
constexpr int NB = 128;
constexpr int THREADS = 512;
}  // namespace

// Floats of one group buffer: R[q][128] (the pivot rows, then w_t), Cc[q][128]
// (the pivot columns, then a_t), dinv[q] padded to 16 bytes.
__host__ __device__ constexpr int group_floats(int q) {
  return 2 * q * NB + ((q + 3) & ~3);
}

template <bool PANEL>
__global__ void __launch_bounds__(THREADS)
pivot_sweep_group_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                         float* __restrict__ out, int q, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float diag[NB];
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
  // Jacobi scaling to unit diagonal, as v3 (the scales are re-read from diag
  // at the end).
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[r][c] = w[r][c] * (1.0f / sqrtf(diag[ty * 8 + r])) *
                (1.0f / sqrtf(diag[tx + 32 * c]));

  const int per = group_floats(q);
  for (int p = 0; p < NB / q; ++p) {
    float* R = smem + (nbuf == 2 ? (p & 1) : 0) * per;
    float* Cc = R + q * NB;
    float* dv = Cc + q * NB;
    const int j0 = p * q;
    if (nbuf == 1 && p > 0) __syncthreads();  // last group's readers are done
    // Publish the group's pivot rows (R[t][k] = W[j0 + t, k]) and columns
    // (Cc[t][i] = W[i, j0 + t]) as they stand at the group's start.
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int tr = ty * 8 + r - j0;
      if (tr >= 0 && tr < q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) R[tr * NB + tx + 32 * c] = w[r][c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int tc = tx + 32 * c - j0;
      if (tc >= 0 && tc < q) {
#pragma unroll
        for (int r = 0; r < 8; ++r) Cc[tc * NB + ty * 8 + r] = w[r][c];
      }
    }
    __syncthreads();
    // The core: the q steps on the entries (j0 + s, j0 + v) of the published
    // rows and columns, by warp 0 in step order. Step t turns column t into
    // a_t = (c_t - e) dinv and row t into w_t = r_t - e there, then corrects
    // the later rows and columns: r_s -= a_t[j_s] w_t, c_s -= a_t w_t[j_s].
    if (ty == 0) {
      for (int s = 0; s < q; ++s) {
        const float dinv = 1.0f / R[s * NB + j0 + s];
        __syncwarp();
        for (int v = tx; v < q; v += 32) {
          const float e = v == s ? 1.0f : 0.0f;
          Cc[s * NB + j0 + v] = __fmul_rn(__fsub_rn(Cc[s * NB + j0 + v], e), dinv);
          R[s * NB + j0 + v] = __fsub_rn(R[s * NB + j0 + v], e);
        }
        if (tx == 0) dv[s] = dinv;
        __syncwarp();
        for (int idx = tx; idx < (q - 1 - s) * q; idx += 32) {
          const int s2 = s + 1 + idx / q, v = idx % q;
          R[s2 * NB + j0 + v] = __fsub_rn(
              R[s2 * NB + j0 + v], __fmul_rn(Cc[s * NB + j0 + s2], R[s * NB + j0 + v]));
          Cc[s2 * NB + j0 + v] = __fsub_rn(
              Cc[s2 * NB + j0 + v], __fmul_rn(Cc[s * NB + j0 + v], R[s * NB + j0 + s2]));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // The factors outside the core, one thread a row (a_t[i]) or a column
    // (w_t[k]), each corrected by the earlier steps in step order.
    if (t < NB) {
      const int i = t;
      if (i < j0 || i >= j0 + q) {
        for (int s = 0; s < q; ++s) {
          float v = Cc[s * NB + i];
          for (int u = 0; u < s; ++u)
            v = __fsub_rn(v, __fmul_rn(Cc[u * NB + i], R[u * NB + j0 + s]));
          Cc[s * NB + i] = __fmul_rn(v, dv[s]);
        }
      }
    } else if (t < 2 * NB) {
      const int k = t - NB;
      if (k < j0 || k >= j0 + q) {
        for (int s = 0; s < q; ++s) {
          float v = R[s * NB + k];
          for (int u = 0; u < s; ++u)
            v = __fsub_rn(v, __fmul_rn(Cc[u * NB + j0 + s], R[u * NB + k]));
          R[s * NB + k] = v;
        }
      }
    }
    __syncthreads();
    // The group's update: W -= sum_t a_t w_t (rank-q: products rounded, then
    // summed in step order) or W -= V.U (panel: an FMA dot).
    float upd[8][4] = {};
    for (int s = 0; s < q; ++s) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Cc[s * NB + ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Cc[s * NB + ty * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float ww[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ww[c] = R[s * NB + tx + 32 * c];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          upd[r][c] = PANEL ? fmaf(a[r], ww[c], upd[r][c])
                            : __fadd_rn(upd[r][c], __fmul_rn(a[r], ww[c]));
        }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = __fsub_rn(w[r][c], upd[r][c]);
  }

  float* ob = out + (i64)b * NB * NB;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty * 8 + r, k = tx + 32 * c;
      ob[i * NB + k] = ((i == k ? 2.0f : 0.0f) - w[r][c]) *
                       (1.0f / sqrtf(diag[i])) * (1.0f / sqrtf(diag[k]));
    }
}

// D: (B, 128, 128) view with element (b, i, k) at D[b*d_batch + i*d_row + k].
// out: contiguous (B, 128, 128).
extern "C" int qps_pivot_sweep_ref(const float* D, i64 d_batch, i64 d_row,
                                   float* out, int B, void* stream) {
  return qps::launch_sweep_block<false, true>(D, d_batch, d_row, out, B,
                                              static_cast<cudaStream_t>(stream));
}

// The same arguments, through the witness sweep_block_prev_kernel.
extern "C" int qps_pivot_sweep_ref_prev(const float* D, i64 d_batch, i64 d_row,
                                        float* out, int B, void* stream) {
  return qps::launch_sweep_block<false, true, true>(
      D, d_batch, d_row, out, B, static_cast<cudaStream_t>(stream));
}

// q: the group size, 2 <= q <= 128 dividing 128 (the panel: q = 8, panel = 1).
extern "C" int qps_pivot_sweep_group(const float* D, i64 d_batch, i64 d_row,
                                     float* out, int B, int q, int panel,
                                     void* stream) {
  if (q < 2 || NB % q) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbuf = q <= 32 ? 2 : 1;
  const size_t bytes = sizeof(float) * nbuf * group_floats(q);
  auto kernel = panel ? pivot_sweep_group_kernel<true> : pivot_sweep_group_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, THREADS, bytes, s>>>(D, d_batch, d_row, out, q, nbuf);
  return (int)cudaGetLastError();
}
