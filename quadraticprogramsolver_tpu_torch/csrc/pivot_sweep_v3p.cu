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
// What bounds it on the H100: 64 dependent rank-1 steps of 4,096 rounded
// products and differences a block, each waiting on the one before it. The
// bound is the bytes (16 KB in and 16 KB out a block, 0.005 ms at B=512 at
// 3.35 TB/s); the 2 x 64 x 4,096 rounded operations a block take 0.008 ms
// of the card's FP32 issue rate. So the time is the step chain's latency
// unless the SM has other chains, and other warps of the same chain, to
// issue meanwhile.
//
// pivot_sweep_v3p_kernel (entry qps_pivot_sweep_v3p): pivot_sweep.cu's v3
// layout turned on its side, so that a step's 64 divisions spread over the
// lanes of one warp. One CTA of 128 threads a block, up to eight CTAs an SM
// (64 registers, no spill), W in registers: lane l holds rows l and l + 32,
// warp w columns 16w..16w+15 (32 floats a thread). The step loop is
// unrolled over a warp's 16 columns inside a loop over the four column
// owners, so every register index is a compile-time constant but the pivot
// row's register row, j / 32, one per owner. At the top of step j the
// owners publish what step j - 1 left: lane j % 32 of every warp its 16
// entries of row j (16-byte stores), and warp j / 16 the 64 multipliers
// a_i = (W[i, j] - d_ij) / W[j, j], two divisions a lane, the pivot taken
// from lane j % 32 by one shuffle. One __syncthreads() separates the steps
// (a double buffer); each thread then reads its two multipliers and its 16
// pivot-row entries (16-byte broadcast loads) and updates its 32 elements.
// The e_j fix of the pivot row touches one column, so it runs only in that
// column's owner warp: r - 0 is r, bit for bit. The block comes in and goes
// out through a shared-memory tile (64 x 68 floats): each warp moves its 16
// columns as rows of 64 contiguous bytes, four lanes a row, where lane l's
// own rows would spread every 16-byte access of a warp over 32 rows.
//
// The layout was chosen by A/B on an H100 80GB HBM3 at 700 W: each
// alternative built from this kernel with its knobs as macros, checked bit
// for bit against the witness and timed in turns with it, in one run
// (device ms a call, 20 back-to-back calls on one set of operands, so
// partly from the L2, at B = 512 / 3072 / 4096; registers). The knobs and
// the script that built them were removed once the layout was chosen;
// chip_smoke.py times this kernel and its witness from device memory
// (phases 2 and 2b).
//
//   the witness (255 registers)                   0.0806 / 0.4801 / 0.6093
//   this layout (64, no spill)                    0.0288 / 0.1342 / 0.1717
//   each lane loads and stores its own rows       0.0347 / 0.1458 / 0.1876
//   every warp divides for its own rows           0.0299 / 0.1437 / 0.1852
//   4 resident CTAs an SM (80 registers)          0.0295 / 0.1432 / 0.1882
//   8 warps of 8 columns, 4 CTAs (54 registers)   0.0297 / 0.1675 / 0.2183
//   load, scale and store only (no step)          0.0067 / 0.0462 / 0.0603
//   the same, each lane its own rows              0.0127 / 0.0854 / 0.1121
//   the bound (bytes at 3.35 TB/s)                0.0050 / 0.0300 / 0.0401
//
// What holds it: at B=512 (one wave, about four CTAs an SM) the 64 steps
// take most of the time, about 0.34 us a step, in which each warp issues
// its 64 rounded products and differences, the loads, the row's
// publication, the owner's shuffle and two divisions and the barrier, its
// scheduler serving one warp of each of the four CTAs; at B=3072 and 4096
// the load and store phase adds to the steps instead of overlapping them.
//
// pivot_sweep_v3p_prev_kernel (entry qps_pivot_sweep_v3p_prev): the first
// port of the same arithmetic, kept as the new kernel's bit-for-bit witness
// and timing baseline; nothing in the entry points launches it. One warp per
// block, four blocks (warps) per CTA, the whole block in registers: lane l
// holds rows l and l + 32, all 64 columns (128 floats). Step j broadcasts
// the pivot row from lane j % 32 by warp shuffles (64 a step), each lane
// divides its own two column entries by the pivot, and every lane updates
// its 128 elements; the j and k loops are unrolled (255 registers). One warp
// a block leaves about one warp a scheduler at B=512, and each shuffle feeds
// a dependent product and difference, so the 64 steps run one after another
// at the shuffles' latency.
//
// Both read D through strides (a pivot block of the slab needs no copy) and
// write a contiguous (B, 64, 64) tensor.

#include <cstdint>

#include "common.cuh"

using qps::i64;

namespace {
constexpr int HB = 64;
constexpr int WARPS = 4;       // pivot_sweep_v3p_kernel
constexpr int CW = HB / WARPS;  // columns a warp holds
constexpr int TP = HB + 4;      // the staging tile's row pitch
constexpr int PREV_WARPS = 4;   // pivot_sweep_v3p_prev_kernel
constexpr unsigned FULL = 0xffffffffu;
}  // namespace

// Step j's multipliers a_i = (W[i, j] - d_ij) / W[j, j] into cbuf, from
// column j in register column cj of the calling warp (its owner), the pivot
// from lane j % 32.
__device__ __forceinline__ void publish_column(const float (&w)[2][CW], int cj, int j,
                                               int lane, float* cbuf) {
  const float d = __shfl_sync(FULL, (j >> 5) ? w[1][cj] : w[0][cj], j & 31);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cbuf[lane + 32 * h] =
        __fdiv_rn(lane + 32 * h == j ? __fsub_rn(w[h][cj], 1.0f) : w[h][cj], d);
}

// A warp's CW = 16 columns of the 64 rows between global memory (row
// pitch ld) and its part of the staging tile, four lanes a row and one
// 16-byte access each (rows of 64 contiguous bytes), or four floats a lane
// where the rows are not 16-byte aligned.
template <bool LOAD>
__device__ __forceinline__ void stage(float (*tile)[TP], float* g, i64 ld, int k0,
                                      int lane, bool vec) {
  constexpr int LPR = CW / 4, RPI = 32 / LPR;  // lanes a row, rows an access
  const int i0 = lane / LPR, c = k0 + 4 * (lane % LPR);
#pragma unroll
  for (int q = 0; q < HB / RPI; ++q) {
    const int i = q * RPI + i0;
    float4* t = reinterpret_cast<float4*>(&tile[i][c]);
    float* gi = g + (i64)i * ld + c;
    if (!LOAD) {
      *reinterpret_cast<float4*>(gi) = *t;
    } else if (vec) {
      *t = *reinterpret_cast<const float4*>(gi);
    } else {
      *t = make_float4(gi[0], gi[1], gi[2], gi[3]);
    }
  }
}

__global__ void __launch_bounds__(32 * WARPS, 8)
pivot_sweep_v3p_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                       float* __restrict__ out) {
  __shared__ float sc[HB];                     // rsqrt(diag(D))
  __shared__ __align__(16) float cbuf[2][HB];  // multipliers j
  __shared__ __align__(16) float rbuf[2][HB];  // pivot row j
  __shared__ __align__(16) float tile[HB][TP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = warp * CW;
  const float* Db = D + (i64)blockIdx.x * d_batch;
  float* ob = out + (i64)blockIdx.x * HB * HB;

  if (threadIdx.x < HB) sc[threadIdx.x] = rsqrtf(Db[(i64)threadIdx.x * d_row + threadIdx.x]);
  float w[2][CW];
  const bool vec = ((reinterpret_cast<uintptr_t>(Db) | (uintptr_t)(d_row * 4)) & 15) == 0;
  stage<true>(tile, const_cast<float*>(Db), d_row, k0, lane, vec);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = &tile[lane + 32 * h][k0];
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
      w[h][4 * q] = v.x;
      w[h][4 * q + 1] = v.y;
      w[h][4 * q + 2] = v.z;
      w[h][4 * q + 3] = v.w;
    }
  }
  __syncthreads();
  {
    const float sr[2] = {sc[lane], sc[lane + 32]};
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const float s = sc[k0 + c];
#pragma unroll
      for (int h = 0; h < 2; ++h) w[h][c] = __fmul_rn(__fmul_rn(w[h][c], sr[h]), s);
    }
  }

  for (int jb = 0; jb < WARPS; ++jb) {  // pivot columns of warp jb
    const int hj = (jb * CW) >> 5;  // register row of the pivot rows j here
    const bool col_owner = warp == jb;
#pragma unroll
    for (int jr = 0; jr < CW; ++jr) {
      const int j = jb * CW + jr;
      const int buf = jr & 1;  // j & 1 (CW is even)
      // Publish pivot row j and the multipliers of step j as step j - 1
      // left W.
      if (lane == (j & 31)) {
#pragma unroll
        for (int q = 0; q < CW / 4; ++q)
          *reinterpret_cast<float4*>(&rbuf[buf][k0 + 4 * q]) =
              hj ? make_float4(w[1][4 * q], w[1][4 * q + 1], w[1][4 * q + 2], w[1][4 * q + 3])
                 : make_float4(w[0][4 * q], w[0][4 * q + 1], w[0][4 * q + 2], w[0][4 * q + 3]);
      }
      if (col_owner) publish_column(w, jr, j, lane, cbuf[buf]);
      __syncthreads();
      const float a[2] = {cbuf[buf][lane], cbuf[buf][lane + 32]};
      float r[CW];
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&rbuf[buf][k0 + 4 * q]);
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
      if (col_owner) r[jr] = __fsub_rn(r[jr], 1.0f);  // k == j
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          w[h][c] = __fsub_rn(w[h][c], __fmul_rn(a[h], r[c]));
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    const float sr = sc[i];
    float* row = &tile[i][k0];
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e, k = k0 + c;
        v[e] = __fmul_rn(__fmul_rn(__fsub_rn(i == k ? 2.0f : 0.0f, w[h][c]), sr), sc[k]);
      }
      *reinterpret_cast<float4*>(row + 4 * q) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncwarp();
  stage<false>(tile, ob, HB, k0, lane, true);
}

__global__ void __launch_bounds__(32 * PREV_WARPS)
pivot_sweep_v3p_prev_kernel(const float* __restrict__ D, i64 d_batch, i64 d_row,
                            float* __restrict__ out, int B) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * PREV_WARPS + (threadIdx.x >> 5);
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
  pivot_sweep_v3p_kernel<<<B, 32 * WARPS, 0, s>>>(D, d_batch, d_row, out);
  return (int)cudaGetLastError();
}

// The same arguments, through pivot_sweep_v3p_prev_kernel.
extern "C" int qps_pivot_sweep_v3p_prev(const float* D, i64 d_batch, i64 d_row,
                                        float* out, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pivot_sweep_v3p_prev_kernel<<<(B + PREV_WARPS - 1) / PREV_WARPS, 32 * PREV_WARPS,
                                0, s>>>(D, d_batch, d_row, out, B);
  return (int)cudaGetLastError();
}
