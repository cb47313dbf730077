// The pivot sweep's other formulations: batched 128x128 SPD inverses by
// unpivoted Gauss-Jordan, as Settings.pivot_variant names them.
//
// Replaces the TPU kernels of quadraticprogramsolver_tpu/ops/spd_kernels.py
// reached through pallas_spd_inverse_unrolled:
//
//   "ref"    _pivot_sweep_unrolled_kernel  -> sweep_block_kernel<false, true>
//                                            (sweep_block.cuh)
//   "r<q>"   _pivot_sweep_rq_kernel        -> group_sweep_kernel<q, false>
//                                            (q <= 16; q >= 32:
//                                            pivot_sweep_group_kernel<false>)
//   "panel"  _pivot_sweep_panel_kernel     -> group_sweep_kernel<8, true>
//
// ("v3" and "value", one arithmetic, are pivot_sweep.cu.) Each copies its TPU
// kernel's arithmetic operation for operation: products and sums are the
// non-contracting intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) wherever the
// TPU kernel rounds a product before it adds it, so the kernel and its plain
// PyTorch version round alike; only the panel's V.U product is a dot, summed
// by FMAs. Every kernel reads D through strides and writes a contiguous
// (B, 128, 128).
//
// "ref": no Jacobi scaling. Step j, with the column C and row r read before
// it: W -= (C dinv)(r - e_j), row j = r dinv, (j, j) = -dinv; out = -W. One
// barrier per step, as v3. Its kernel is the unscaled sweep that rows 6 and
// 12 share, with the e_j fix folded into the row (sweep_block.cuh, FOLD), in
// pivot_sweep.cu's v3 register layout; qps_pivot_sweep_ref_prev runs the first
// port (sweep_block_prev_kernel), kept as its bit-for-bit witness.
//
// "r<q>" and "panel" (q = 8): v3's scaling and folded fixes, the 128 steps
// taken q at a time. Step t of a group reads the group's pivot row and
// column as they stood at the group's start, less the earlier steps' a_u w_u:
// for every row or column index x, in step order,
//
//   a_t[x] = (C_t[x] - sum_{u<t} a_u[x] w_u[j_t] - e) dinv_t
//   w_t[x] =  R_t[x] - sum_{u<t} a_u[j_t] w_u[x] - e      (e = [x == j_t])
//   dinv_t = 1 / (w_t[j_t] before its e)
//
// each correction a rounded product subtracted in turn (u ascending). The
// group then subtracts its update from W once: the rank-q form the sum of the
// rounded products a_t w_t in step order, the panel the FMA chain of V.U
// (its factors follow the TPU kernel's panel slabs Wc = W[:, K] and Wr =
// W[K, :] updated step by step, which is this correction order).
//
// group_sweep_kernel<Q, PANEL> (the solver's, q in {2, 4, 8, 16}): v3's
// register layout. One CTA of 256 threads a block, two CTAs an SM (one at
// q = 16, whose step history takes 64 more registers): warp w holds rows
// 16w..16w+15 and lane l columns 4l..4l+3 of W in 64 registers. A group's
// q pivots lie in one warp's rows, and the group loop is unrolled inside a
// loop over the 8 row owners, so every pivot's register row and column are
// compile-time constants. One __syncthreads() a group: the owners of the
// group's q rows and q columns publish them (as the previous group's update
// left them) into one half of a double buffer, and after the barrier every
// warp works alone. Each lane finishes w_t for its own 4 columns and a_t for
// one row (lanes 0-15 the warp's rows, lanes 16..16+q-1 the group's pivot
// rows); the core values a_u[j_t], w_u[j_t] and the pivots pass between
// lanes by __shfl_sync, so every warp runs the q x q core itself, in step
// order. The warp's a_t go to its own shared slice (one __syncwarp), and each
// thread applies the whole update to its registers, four rows at a time:
// 128/q barriers a sweep (64, 32, 16, 8) against v3's 128.
//
// pivot_sweep_group_kernel<PANEL> (entry qps_pivot_sweep_group_prev): the
// first port, kept as the new kernel's bit-for-bit witness and timing
// baseline, and the kernel of q in {32, 64, 128} (a group spans warps there).
// One CTA of 512 threads a block (rows ty*8..ty*8+7 at columns tx + 32c): a
// group publishes its rows and columns (barrier), warp 0 runs the core while
// the other warps wait (barrier), 256 threads finish the factors, one row or
// column each (barrier), and every thread applies the update: three barriers
// a group (four when q > 32, whose buffers are not doubled).
//
// What bounds them on the H100: as v3, latency: the steps form one dependent
// chain. The new kernel's chain is q shuffle-linked steps a group plus one
// barrier; most of its instructions are the update, 2 * 64 * 128 rounded
// operations a thread a sweep for the rank-q form (twice v3's FMAs) and
// 64 * 128 FMAs for the panel.

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

namespace {
constexpr int G_THREADS = 256;  // group_sweep_kernel
constexpr int G_ROWS = 16;      // rows a warp holds
constexpr unsigned FULL = 0xffffffffu;
}  // namespace

// Publishes group (jb, g)'s pivot rows and columns into buffer `b`: the
// rows j0 + t (warp jb's register rows g*Q + t) as R[t][k], the columns
// j0 + t (register column (j0 + t) % 4 of lane (j0 + t) / 4) as Cc[t][i].
template <int Q>
__device__ __forceinline__ void group_publish(const float (&w)[G_ROWS][4],
                                              float (*R)[NB], float (*Cc)[NB],
                                              int jb, int g, int warp, int lane) {
  const int j0 = jb * G_ROWS + g * Q, i0 = warp * G_ROWS, k0 = lane * 4;
  if (warp == jb) {
#pragma unroll
    for (int t = 0; t < Q; ++t)
      *reinterpret_cast<float4*>(&R[t][k0]) =
          make_float4(w[g * Q + t][0], w[g * Q + t][1], w[g * Q + t][2],
                      w[g * Q + t][3]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int t = k0 + c - j0;
    if (t >= 0 && t < Q) {
#pragma unroll
      for (int q4 = 0; q4 < G_ROWS / 4; ++q4)
        *reinterpret_cast<float4*>(&Cc[t][i0 + 4 * q4]) =
            make_float4(w[4 * q4][c], w[4 * q4 + 1][c], w[4 * q4 + 2][c],
                        w[4 * q4 + 3][c]);
    }
  }
}

template <int Q, bool PANEL>
__global__ void __launch_bounds__(G_THREADS, Q <= 8 ? 2 : 1)
group_sweep_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                   float* __restrict__ out) {
  constexpr int G = G_ROWS / Q;  // groups a row owner holds
  __shared__ float diag[NB];
  __shared__ __align__(16) float R[2][Q][NB];   // published pivot rows
  __shared__ __align__(16) float Cc[2][Q][NB];  // published pivot columns
  __shared__ __align__(16) float A[G_THREADS / 32][Q][G_ROWS];  // a warp's a_t
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = warp * G_ROWS, k0 = lane * 4;
  const float* Db = D + (i64)b * d_batch;

  float w[G_ROWS][4];
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r)
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
    for (int r = 0; r < G_ROWS; ++r) {
      const float s_col = 1.0f / sqrtf(diag[i0 + r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = w[r][c] * s_col * s_row[c];
    }
  }
  group_publish<Q>(w, R[0], Cc[0], 0, 0, warp, lane);

  for (int jb = 0; jb < NB / G_ROWS; ++jb) {  // pivot rows owned by warp jb
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int buf = (jb * G + g) & 1;
      const int j0 = jb * G_ROWS + g * Q;
      __syncthreads();
      // This lane's a-row: its warp's row i0 + lane, or pivot row j0 +
      // lane - 16 (lanes past 16 + Q repeat the last; nothing reads them).
      const int x = lane < 16 ? i0 + lane : j0 + min(lane - 16, Q - 1);
      float av[Q], wv[Q][4];
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(&R[buf][t][k0]);
        wv[t][0] = v.x;
        wv[t][1] = v.y;
        wv[t][2] = v.z;
        wv[t][3] = v.w;
        av[t] = Cc[buf][t][x];
      }
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        const int ct = (g * Q + t) & 3;                 // j_t's register column
        const int lt = jb * 4 + ((g * Q + t) >> 2);     // and its lane
        // w_t: w_t[k] -= a_u[j_t] w_u[k], a_u[j_t] from lane 16 + t.
#pragma unroll
        for (int u = 0; u < t; ++u) {
          const float au = __shfl_sync(FULL, av[u], 16 + t);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wv[t][c] = __fsub_rn(wv[t][c], __fmul_rn(au, wv[u][c]));
        }
        const float dinv = 1.0f / __shfl_sync(FULL, wv[t][ct], lt);
        if (lane == lt) wv[t][ct] = __fsub_rn(wv[t][ct], 1.0f);
        // a_t: a_t[x] -= a_u[x] w_u[j_t], w_u[j_t] from lane lt.
#pragma unroll
        for (int u = 0; u < t; ++u)
          av[t] = __fsub_rn(av[t], __fmul_rn(av[u], __shfl_sync(FULL, wv[u][ct], lt)));
        if (x == j0 + t) av[t] = __fsub_rn(av[t], 1.0f);
        av[t] = __fmul_rn(av[t], dinv);
      }
      if (lane < 16) {
#pragma unroll
        for (int t = 0; t < Q; ++t) A[warp][t][lane] = av[t];
      }
      __syncwarp();
      // The group's update, four rows at a time: W -= sum_t a_t w_t
      // (rank-q: each product rounded, summed in step order; panel: one FMA
      // chain).
#pragma unroll
      for (int rc = 0; rc < G_ROWS / 4; ++rc) {
        float upd[4][4] = {};
#pragma unroll
        for (int t = 0; t < Q; ++t) {
          const float4 a4 = *reinterpret_cast<const float4*>(&A[warp][t][4 * rc]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              upd[r][c] = PANEL ? fmaf(a[r], wv[t][c], upd[r][c])
                                : __fadd_rn(upd[r][c], __fmul_rn(a[r], wv[t][c]));
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            w[4 * rc + r][c] = __fsub_rn(w[4 * rc + r][c], upd[r][c]);
      }
      // The next group's rows and columns, as this update left them.
      if (g + 1 < G)
        group_publish<Q>(w, R[buf ^ 1], Cc[buf ^ 1], jb, g + 1, warp, lane);
      else if (jb + 1 < NB / G_ROWS)
        group_publish<Q>(w, R[buf ^ 1], Cc[buf ^ 1], jb + 1, 0, warp, lane);
    }
  }

  float* ob = out + (i64)b * NB * NB;
  float s_row[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s_row[c] = 1.0f / sqrtf(diag[k0 + c]);
#pragma unroll
  for (int r = 0; r < G_ROWS; ++r) {
    const int i = i0 + r;
    const float s_col = 1.0f / sqrtf(diag[i]);
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = ((i == k0 + c ? 2.0f : 0.0f) - w[r][c]) * s_col * s_row[c];
    *reinterpret_cast<float4*>(&ob[i * NB + k0]) = make_float4(o[0], o[1], o[2], o[3]);
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

// q: the group size, 2 <= q <= 128 dividing 128 (the panel: q = 8, panel =
// 1), through the first port (pivot_sweep_group_kernel).
extern "C" int qps_pivot_sweep_group_prev(const float* D, i64 d_batch, i64 d_row,
                                          float* out, int B, int q, int panel,
                                          void* stream) {
  if (q < 2 || NB % q || (panel && q != 8)) return (int)cudaErrorInvalidValue;
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

// The same arguments, through group_sweep_kernel: q in {2, 4, 8, 16} (the
// panel: q = 8, panel = 1).
extern "C" int qps_pivot_sweep_group(const float* D, i64 d_batch, i64 d_row,
                                     float* out, int B, int q, int panel,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const float*, i64, i64, float*) = nullptr;
  if (panel) {
    if (q == 8) kernel = group_sweep_kernel<8, true>;
  } else if (q == 2) {
    kernel = group_sweep_kernel<2, false>;
  } else if (q == 4) {
    kernel = group_sweep_kernel<4, false>;
  } else if (q == 8) {
    kernel = group_sweep_kernel<8, false>;
  } else if (q == 16) {
    kernel = group_sweep_kernel<16, false>;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<B, G_THREADS, 0, s>>>(D, d_batch, d_row, out);
  return (int)cudaGetLastError();
}
