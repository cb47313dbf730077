// Fused normal-matrix inverse: per lane, M = (P + sigma I) + rho_b (A'A)
// and its inverse by the flat blocked sweep, with hand-written products only.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/spd_kernels.py:
// _normal_inverse_kernel (reached through pallas_normal_inverse). On the TPU
// one grid step holds a lane's whole working matrix in VMEM (1 MB at
// n = 512), builds M with one gram product and sweeps it in place. An H100
// CTA has at most 227 KB of shared memory, so here the working matrix X
// lives in the output tensor and the lane's work is a fixed sequence of
// launches on one stream, 1 + 3 n/128 of them (13 at n = 512):
//
//   gram:      X = (P + sigma I) + rho_b (A'A)  (normal_gram_kernel)
//   per level k (s = rows and columns 128k .. 128k + 127):
//     pivot:   Dinv = the unguarded sweep of X[s, s], read in place
//              (sweep_block.cuh: sweep_block_kernel, _sweep_inverse_block's
//              arithmetic)
//     CD:      CD = X[:, s] Dinv for the row blocks outside s
//              (normal_cd_kernel)
//     strip:   X - CD X[s, :] off the block row and column, CD on the block
//              column, Dinv X[s, :] on the block row, -Dinv on the diagonal
//              block, in place (normal_strip_kernel); the last level writes
//              the negation, so X ends as M^{-1}.
//
// What bounds it on the H100: operations. The least work is n(n+1)m + n^3
// FLOPs a lane (the gram's distinct entries and one SPD inverse), 201.5 MFLOP
// at n = 512, m = 256; the sweep here does the full rank-128 updates of
// every level (about 2.4 n^3 with the level products), on SIMT FP32.
//
// The products run on sgemm.cuh's core (128-row tiles, 8 x 8 outputs a
// thread, k staged 16 deep through a 3-stage cp.async ring, two CTAs an SM).
//   normal_gram_kernel: one launch over the upper triangle's 128 x 128 tiles,
//     T(T+1)/2 CTAs a lane (T = n/128), a(i, k) = A[k, i] staged k-major and
//     b(k, j) = A[k, j]. A tile writes fl(P + sigma delta_ij) + fl(rho_b g)
//     and, off the diagonal, its mirror, transposed through shared memory so
//     its stores coalesce. g(i, j) and g(j, i) sum the same products in the
//     same k order (fmaf is symmetric in its factors), so the mirror is what
//     a tile below the diagonal would compute, bit for bit.
//   normal_cd_kernel: one 128 x 128 tile of CD a CTA; X's block column
//     transposed into the A stages, Dinv's k-tiles as B stages. CD's rows in
//     s are never read, so they are not computed (at n = 128 the launch has
//     nothing to do).
//   normal_strip_kernel: a CTA owns one lane's 128-column strip over all n
//     rows, so no other CTA reads or writes those columns and the level is in
//     place. It stages the strip's block row R = X[s, strip] in shared memory
//     (the B side of its first product), writes Dinv R into the block row,
//     then streams CD's 128-row blocks through the ring against the resident
//     R and writes X - CD R, a block at a time. The strip that holds columns s
//     copies CD and -Dinv into its rows, with no product.
// Every output sums the same operands in the same k order, one fmaf a term
// from 0, as the witness's common.cuh: tile_gemm does, so the inverse is the
// witness's bit for bit. Workspaces: CD (B, n, 128) and Dinv (B, 128, 128).
//
// The witness (qps_normal_inverse_prev, launched by no entry point): the
// first port of the same sequence, with 64 x 64 SIMT tiles (tile_gemm), the
// level products CD and DR = Dinv X[s, :] into scratch, the level update from
// X_k into X_{k+1} (two (B, n, n) buffers in turn, the output and one
// workspace) and sweep_block_prev_kernel as the pivot.

#include "sgemm.cuh"
#include "sweep_block.cuh"

using qps::i64;
using qps::TM;
using qps::TN;
using qps::TPB;

namespace {
constexpr int NB = 128;
}  // namespace

// One tile (ti <= tj) of X = (P + sigma I) + rho_b (A'A), and its mirror.
__global__ void __launch_bounds__(TPB)
normal_gram_prev_kernel(const float* __restrict__ P, const float* __restrict__ A,
                        const float* __restrict__ rho, float* __restrict__ X,
                        int n, int m, float sigma) {
  __shared__ float tr[TN][TM + 1];
  const int T = n / TM;
  int tile = blockIdx.x, ti = 0;
  while (tile >= T - ti) {  // row ti holds the tiles tj = ti .. T - 1
    tile -= T - ti;
    ++ti;
  }
  const int tj = ti + tile;
  const int b = blockIdx.y;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const float* Ab = A + (i64)b * m * n;
  const float* Pb = P + (i64)b * n * n;
  float* Xb = X + (i64)b * n * n;
  const float rb = rho[b];
  const int i0 = ti * TM, j0 = tj * TN;
  // acc[r][c] = sum_k A[k, i0 + ty*4 + r] A[k, j0 + tx*4 + c]
  float acc[4][4] = {};
  qps::tile_gemm<false>(Ab + i0, n, Ab + j0, n, nullptr, m, acc);
  auto entry = [&](int i, int j, float g) {
    float p = Pb[(i64)i * n + j];
    if (i == j) p = __fadd_rn(p, sigma);
    Xb[(i64)i * n + j] = __fadd_rn(p, __fmul_rn(rb, g));
  };
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      entry(i0 + ty * 4 + r, j0 + tx * 4 + c, acc[r][c]);
      tr[tx * 4 + c][ty * 4 + r] = acc[r][c];
    }
  if (ti == tj) return;
  __syncthreads();
  for (int e = t; e < TM * TN; e += TPB) {
    const int r = e / TM, c = e % TM;
    entry(j0 + r, i0 + c, tr[r][c]);
  }
}

// Level products: CD = X[:, s] Dinv (n x 128) and DR = Dinv X[s, :] (128 x n),
// s starting at s0; one 64x64 output tile a CTA.
__global__ void __launch_bounds__(TPB)
normal_level_products_prev_kernel(const float* __restrict__ X,
                                  const float* __restrict__ Dinv,
                                  float* __restrict__ CD, float* __restrict__ DR,
                                  int n, int s0) {
  const int b = blockIdx.y;
  const int T = n / TM;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const float* Xb = X + (i64)b * n * n;
  const float* Db = Dinv + (i64)b * NB * NB;
  float acc[4][4] = {};
  int tile = blockIdx.x;
  if (tile < 2 * T) {
    const int i0 = (tile >> 1) * TM, j0 = (tile & 1) * TN;
    qps::tile_gemm<true>(Xb + (i64)i0 * n + s0, n, Db + j0, NB, nullptr, NB, acc);
    float* out = CD + (i64)b * n * NB;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(i64)(i0 + ty * 4 + r) * NB + j0 + tx * 4 + c] = acc[r][c];
  } else {
    tile -= 2 * T;
    const int i0 = (tile / T) * TM, j0 = (tile % T) * TN;
    qps::tile_gemm<true>(Db + (i64)i0 * NB, NB, Xb + (i64)s0 * n + j0, n, nullptr, NB, acc);
    float* out = DR + (i64)b * NB * n;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(i64)(i0 + ty * 4 + r) * n + j0 + tx * 4 + c] = acc[r][c];
  }
}

// Level update: Y = X - CD X[s, :] off the block row and column s, CD on the
// block column, DR on the block row, -Dinv on the diagonal block; negated
// when `neg`. One 64x64 tile a CTA (every branch is uniform over the CTA).
__global__ void __launch_bounds__(TPB)
normal_level_update_prev_kernel(const float* __restrict__ X,
                                const float* __restrict__ CD,
                                const float* __restrict__ DR,
                                const float* __restrict__ Dinv,
                                float* __restrict__ Y, int n, int s0, int neg) {
  const int j0 = blockIdx.x * TN, i0 = blockIdx.y * TM, b = blockIdx.z;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const bool in_r = i0 >= s0 && i0 < s0 + NB, in_c = j0 >= s0 && j0 < s0 + NB;
  const float* Xb = X + (i64)b * n * n;
  const float* CDb = CD + (i64)b * n * NB;
  float v[4][4];
  if (in_r && in_c) {
    const float* Db = Dinv + (i64)b * NB * NB;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[r][c] = -Db[(i0 - s0 + ty * 4 + r) * NB + j0 - s0 + tx * 4 + c];
  } else if (in_c) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[r][c] = CDb[(i64)(i0 + ty * 4 + r) * NB + j0 - s0 + tx * 4 + c];
  } else if (in_r) {
    const float* DRb = DR + (i64)b * NB * n;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[r][c] = DRb[(i64)(i0 - s0 + ty * 4 + r) * n + j0 + tx * 4 + c];
  } else {
    float acc[4][4] = {};
    qps::tile_gemm<true>(CDb + (i64)i0 * NB, NB, Xb + (i64)s0 * n + j0, n, nullptr, NB, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[r][c] = __fsub_rn(Xb[(i64)(i0 + ty * 4 + r) * n + j0 + tx * 4 + c], acc[r][c]);
  }
  float* Yb = Y + (i64)b * n * n;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      Yb[(i64)(i0 + ty * 4 + r) * n + j0 + tx * 4 + c] = neg ? -v[r][c] : v[r][c];
}

// The witness sequence. P (B, n, n), A (B, m, n), rho (B,): contiguous
// inputs. out and ws: (B, n, n); CD (B, n, 128), DR (B, 128, n), Dinv (B,
// 128, 128): contiguous workspaces. n and m multiples of 128. Enqueues the
// 1 + 3 n/128 launches.
extern "C" int qps_normal_inverse_prev(const float* P, const float* A,
                                       const float* rho, float* out, float* ws,
                                       float* CD, float* DR, float* Dinv, int B,
                                       int n, int m, float sigma, void* stream) {
  if (n % NB || m % NB || n <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int levels = n / NB, T = n / TM;
  // X_k for k = 0 .. levels; X_levels is the output.
  auto X = [&](int k) { return (levels - k) % 2 == 0 ? out : ws; };
  normal_gram_prev_kernel<<<dim3(T * (T + 1) / 2, B), TPB, 0, s>>>(P, A, rho, X(0), n, m, sigma);
  cudaError_t e = cudaGetLastError();
  for (int k = 0; k < levels && e == cudaSuccess; ++k) {
    const int s0 = k * NB;
    e = (cudaError_t)qps::launch_sweep_block<false, false, true>(
        X(k) + (i64)s0 * n + s0, (i64)n * n, n, Dinv, B, s);
    if (e != cudaSuccess) break;
    normal_level_products_prev_kernel<<<dim3(4 * T, B), TPB, 0, s>>>(X(k), Dinv, CD, DR, n, s0);
    normal_level_update_prev_kernel<<<dim3(T, T, B), TPB, 0, s>>>(
        X(k), CD, DR, Dinv, X(k + 1), n, s0, k == levels - 1);
    e = cudaGetLastError();
  }
  return (int)e;
}

namespace {
namespace sg = qps::sgemm;

constexpr int GT = 128;                 // a tile's rows and columns
constexpr int KT = NB / sg::TK;         // k-tiles of a 128-deep product
constexpr int B_STAGE = sg::TK * GT;    // floats of one B stage
constexpr int LDT = GT + 4;             // pitch of the mirror's transpose
// The gram's and CD's ring: A stages, then B stages (the mirror reuses it).
constexpr size_t RING_SMEM = sizeof(float) * sg::STAGES * (sg::A_STAGE + B_STAGE);
// The strip's resident block row R (128 x 128), then the ring's A stages.
constexpr size_t STRIP_SMEM = sizeof(float) * (NB * GT + sg::STAGES * sg::A_STAGE);
static_assert(64 * LDT <= sg::STAGES * (sg::A_STAGE + B_STAGE),
              "the mirror's half tile fits in the ring");

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
}
}  // namespace

// Grid (T(T+1)/2, B), T = n/128: x walks the tile pairs (ti, tj), ti <= tj,
// of one lane, row by row. Dynamic shared memory RING_SMEM.
__global__ void __launch_bounds__(sg::THREADS, sg::MIN_BLOCKS)
normal_gram_kernel(const float* __restrict__ P, const float* __restrict__ A,
                   const float* __restrict__ rho, float* __restrict__ X,
                   int n, int m, float sigma) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + sg::STAGES * sg::A_STAGE;
  const int b = blockIdx.y, t = threadIdx.x;
  int ti = 0, p = blockIdx.x;
  for (int T = n / GT; p >= T - ti; ++ti) p -= T - ti;
  const int i0 = ti * GT, j0 = (ti + p) * GT;
  const float* Ab = A + (i64)b * m * n;
  const float* Pb = P + (i64)b * n * n;
  float* Xb = X + (i64)b * n * n;
  const float rb = rho[b];
  // acc[r][c] = sum_k A[k, i0 + ty*8 + r] A[k, j0 + (c/4)*64 + tx*4 + c%4]
  float acc[8][8];
  zero(acc);
  sg::pipeline(
      m / sg::TK,
      [&](int kt, int s) {
        const float* src = Ab + (i64)kt * sg::TK * n;
        sg::load_a_kmajor(As + s * sg::A_STAGE, src + i0, n);
        sg::load_b<GT>(Bs + s * B_STAGE, src + j0, n);
      },
      [](int, int) {},
      [&](int, int s) {
        sg::mma<GT>(As + s * sg::A_STAGE, Bs + s * B_STAGE, GT, acc);
      });
  const int ty = sg::tile_ty(), tx = sg::tile_tx();
  // The tile: X[i, j] = fl(P[i, j] + sigma delta_ij) + fl(rho_b g).
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty * 8 + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      const float4 pv = *reinterpret_cast<const float4*>(Pb + (i64)i * n + j);
      float o[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (i == j + c) o[c] = __fadd_rn(o[c], sigma);
        o[c] = __fadd_rn(o[c], __fmul_rn(rb, acc[r][h * 4 + c]));
      }
      *reinterpret_cast<float4*>(Xb + (i64)i * n + j) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  if (p == 0) return;  // a diagonal tile wrote all of its entries
  // The mirror X[j, i] = fl(P[j, i]) + fl(rho_b g(i, j)), 64 rows j at a time
  // through Ts[j - j0 - 64h][i - i0] (the ring is free: pipeline() ended with
  // a barrier).
  float* Ts = smem;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* col = Ts + (tx * 4 + c) * LDT + ty * 8;
      *reinterpret_cast<float4*>(col) =
          make_float4(acc[0][h * 4 + c], acc[1][h * 4 + c], acc[2][h * 4 + c],
                      acc[3][h * 4 + c]);
      *reinterpret_cast<float4*>(col + 4) =
          make_float4(acc[4][h * 4 + c], acc[5][h * 4 + c], acc[6][h * 4 + c],
                      acc[7][h * 4 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = t + sg::THREADS * e;
      const int jj = f / 32, i4 = (f % 32) * 4;
      const float4 g = *reinterpret_cast<const float4*>(Ts + jj * LDT + i4);
      const i64 off = (i64)(j0 + h * 64 + jj) * n + i0 + i4;
      const float4 pv = *reinterpret_cast<const float4*>(Pb + off);
      *reinterpret_cast<float4*>(Xb + off) = make_float4(
          __fadd_rn(pv.x, __fmul_rn(rb, g.x)), __fadd_rn(pv.y, __fmul_rn(rb, g.y)),
          __fadd_rn(pv.z, __fmul_rn(rb, g.z)), __fadd_rn(pv.w, __fmul_rn(rb, g.w)));
    }
    __syncthreads();
  }
}

// CD[b, i, c] = sum_k X[b, i, s0 + k] Dinv[b, k, c] for the row blocks i
// outside level k's. Grid (max(T - 1, 1), B). Dynamic shared memory RING_SMEM.
__global__ void __launch_bounds__(sg::THREADS, sg::MIN_BLOCKS)
normal_cd_kernel(const float* __restrict__ X, const float* __restrict__ Dinv,
                 float* __restrict__ CD, int n, int k) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + sg::STAGES * sg::A_STAGE;
  const int b = blockIdx.y;
  const int ib = (int)blockIdx.x < k ? blockIdx.x : blockIdx.x + 1;
  if (ib >= n / NB) return;  // n = 128: no row block outside s
  const float* Xs = X + (i64)b * n * n + (i64)ib * NB * n + k * NB;
  const float* Db = Dinv + (i64)b * NB * NB;
  float acc[8][8];
  zero(acc);
  sg::pipeline(
      KT,
      [&](int kt, int s) {
        sg::load_a_rowmajor(As + s * sg::A_STAGE, Xs + kt * sg::TK, n);
        sg::load_b<GT>(Bs + s * B_STAGE, Db + kt * sg::TK * NB, NB);
      },
      [](int, int) {},
      [&](int, int s) {
        sg::mma<GT>(As + s * sg::A_STAGE, Bs + s * B_STAGE, GT, acc);
      });
  const int ty = sg::tile_ty(), tx = sg::tile_tx();
  float* out = CD + (i64)b * n * NB + (i64)ib * NB * NB;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(out + (ty * 8 + r) * NB + h * 64 + tx * 4) =
          make_float4(acc[r][h * 4], acc[r][h * 4 + 1], acc[r][h * 4 + 2],
                      acc[r][h * 4 + 3]);
}

// Level k's update of lane b's strip [c0, c0 + 128), in place. Grid (T, B),
// strips fastest (a lane's strips share CD and Dinv in the L2). Dynamic
// shared memory STRIP_SMEM. neg: the last level, which writes -X.
__global__ void __launch_bounds__(sg::THREADS, sg::MIN_BLOCKS)
normal_strip_kernel(float* __restrict__ X, const float* __restrict__ CD,
                    const float* __restrict__ Dinv, int n, int k, int neg) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;  // R[kk][c] = X[s0 + kk, c0 + c], pitch 128
  float* As = smem + NB * GT;
  const int b = blockIdx.y, t = threadIdx.x;
  const int c0 = blockIdx.x * GT, s0 = k * NB, T = n / NB;
  auto sign = [&](float4 v) {
    return neg ? make_float4(-v.x, -v.y, -v.z, -v.w) : v;
  };
  float* Xb = X + (i64)b * n * n;
  const float* CDb = CD + (i64)b * n * NB;
  const float* Db = Dinv + (i64)b * NB * NB;
  if (c0 == s0) {
    // The block column: CD off the diagonal block, -Dinv on it.
    for (int f = t; f < n * (NB / 4); f += sg::THREADS) {
      const int i = f / (NB / 4), c4 = (f % (NB / 4)) * 4;
      float4 v;
      if (i >= s0 && i < s0 + NB) {
        v = *reinterpret_cast<const float4*>(Db + (i - s0) * NB + c4);
        v = make_float4(-v.x, -v.y, -v.z, -v.w);
      } else {
        v = *reinterpret_cast<const float4*>(CDb + (i64)i * NB + c4);
      }
      *reinterpret_cast<float4*>(Xb + (i64)i * n + s0 + c4) = sign(v);
    }
    return;
  }
  const int ty = sg::tile_ty(), tx = sg::tile_tx();
  float acc[8][8];
  // The block row: Dinv R, with R's k-tiles copied to their places in Rs
  // (each once, so no ring) and Dinv's transposed into the A stages.
  zero(acc);
  const float* Xr = Xb + (i64)s0 * n + c0;
  sg::pipeline(
      KT,
      [&](int kt, int s) {
        sg::load_a_rowmajor(As + s * sg::A_STAGE, Db + kt * sg::TK, NB);
        sg::load_b<GT>(Rs + kt * B_STAGE, Xr + (i64)kt * sg::TK * n, n);
      },
      [](int, int) {},
      [&](int kt, int s) {
        sg::mma<GT>(As + s * sg::A_STAGE, Rs + kt * B_STAGE, GT, acc);
      });
  // Every read of R from X has landed (pipeline() ended with a barrier).
  auto store = [&](int i, int h, const float4& v) {
    *reinterpret_cast<float4*>(Xb + (i64)i * n + c0 + h * 64 + tx * 4) = sign(v);
  };
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store(s0 + ty * 8 + r, h,
            make_float4(acc[r][h * 4], acc[r][h * 4 + 1], acc[r][h * 4 + 2],
                        acc[r][h * 4 + 3]));
  // X[ib rows, strip] - CD[ib rows] R for every row block ib != k: CD's
  // k-tiles (transposed) stream through the ring across the blocks.
  zero(acc);
  sg::pipeline(
      (T - 1) * KT,
      [&](int kt, int s) {
        const int blk = kt / KT, ib = blk < k ? blk : blk + 1;
        sg::load_a_rowmajor(As + s * sg::A_STAGE,
                            CDb + (i64)ib * NB * NB + (kt % KT) * sg::TK, NB);
      },
      [](int, int) {},
      [&](int kt, int s) {
        sg::mma<GT>(As + s * sg::A_STAGE, Rs + (kt % KT) * B_STAGE, GT, acc);
        if (kt % KT != KT - 1) return;
        const int blk = kt / KT, ib = blk < k ? blk : blk + 1;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ib * NB + ty * 8 + r;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 x = *reinterpret_cast<const float4*>(
                Xb + (i64)i * n + c0 + h * 64 + tx * 4);
            store(i, h, make_float4(__fsub_rn(x.x, acc[r][h * 4]),
                                    __fsub_rn(x.y, acc[r][h * 4 + 1]),
                                    __fsub_rn(x.z, acc[r][h * 4 + 2]),
                                    __fsub_rn(x.w, acc[r][h * 4 + 3])));
          }
        }
        zero(acc);
      });
}

// P (B, n, n), A (B, m, n), rho (B,): contiguous inputs. out (B, n, n): the
// working matrix, then M^{-1}. CD (B, n, 128), Dinv (B, 128, 128):
// contiguous workspaces. All 16-byte aligned; n and m multiples of 128,
// 0 < B <= 65535. Enqueues the 1 + 3 n/128 launches.
extern "C" int qps_normal_inverse(const float* P, const float* A,
                                  const float* rho, float* out, float* CD,
                                  float* Dinv, int B, int n, int m, float sigma,
                                  void* stream) {
  if (n % NB || m % NB || n <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      normal_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RING_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(normal_cd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)RING_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(normal_strip_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STRIP_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int T = n / NB;
  normal_gram_kernel<<<dim3(T * (T + 1) / 2, B), sg::THREADS, RING_SMEM, s>>>(
      P, A, rho, out, n, m, sigma);
  e = cudaGetLastError();
  for (int k = 0; k < T && e == cudaSuccess; ++k) {
    const int s0 = k * NB;
    e = (cudaError_t)qps::launch_sweep_block<false, false>(
        out + (i64)s0 * n + s0, (i64)n * n, n, Dinv, B, s);
    if (e != cudaSuccess) break;
    normal_cd_kernel<<<dim3(T > 1 ? T - 1 : 1, B), sg::THREADS, RING_SMEM, s>>>(
        out, Dinv, CD, n, k);
    normal_strip_kernel<<<dim3(T, B), sg::THREADS, STRIP_SMEM, s>>>(
        out, CD, Dinv, n, k, k == T - 1);
    e = cudaGetLastError();
  }
  return (int)e;
}
