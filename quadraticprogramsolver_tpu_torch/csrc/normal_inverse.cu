// Fused normal-matrix inverse: per lane, M = (P + sigma I) + rho_b (A'A)
// and its inverse by the flat blocked sweep, with hand-written products only.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/spd_kernels.py:
// _normal_inverse_kernel (reached through pallas_normal_inverse). On the TPU
// one grid step holds a lane's whole working matrix in VMEM (1 MB at
// n = 512), builds M with one gram product and sweeps it in place. An H100
// CTA has at most 227 KB of shared memory, so here the working matrix lives
// in a global workspace and the lane's work is a fixed sequence of launches
// on one stream, 1 + 3 n/128 of them (13 at n = 512):
//
//   gram:           X_0 = (P + sigma I) + rho_b (A'A), one 64x64 tile a CTA;
//                   A'A is symmetric, so a CTA computes a tile at or above
//                   the diagonal and writes it and its mirror (staged through
//                   shared memory, so both stores are coalesced).
//   per level k (s = rows and columns 128k .. 128k + 127):
//     pivot:        Dinv = the unguarded sweep of X_k[s, s]
//                   (sweep_block.cuh, _sweep_inverse_block's arithmetic)
//     products:     CD = X_k[:, s] Dinv and DR = Dinv X_k[s, :]
//     update:       X_{k+1} = X_k - CD X_k[s, :] off the block row and
//                   column, CD on the block column, DR on the block row,
//                   -Dinv on the diagonal block; the last level writes the
//                   negation, so X_{n/128} = M^{-1}.
//
// The levels read X_k and write X_{k+1} (two buffers in turn, the output and
// one workspace), so no tile reads what another tile of the same launch
// writes: the TPU kernel's order of reads and writes within a level is kept.
// The products are qps::tile_gemm (common.cuh: FP32 FMAs on the CUDA cores,
// 64x64 tiles). Each entry rounds as the TPU kernel's does, but the sums of
// the products run in another order.
//
// What bounds it on the H100: operations. The least work is n(n+1)m + n^3
// FLOPs a lane (the gram's distinct entries and one SPD inverse), 201.5 MFLOP
// at n = 512, m = 256; the sweep here does the full rank-128 updates of
// every level (about 2.4 n^3 with the level products), on SIMT FP32. A
// thread-block cluster holding the working matrix in distributed shared
// memory, with tensor-core products, is the later design.

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
normal_gram_kernel(const float* __restrict__ P, const float* __restrict__ A,
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
normal_level_products_kernel(const float* __restrict__ X,
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
normal_level_update_kernel(const float* __restrict__ X,
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

// P (B, n, n), A (B, m, n), rho (B,): contiguous inputs. out and ws:
// (B, n, n); CD (B, n, 128), DR (B, 128, n), Dinv (B, 128, 128): contiguous
// workspaces. n and m multiples of 128. Enqueues the 1 + 3 n/128 launches.
extern "C" int qps_normal_inverse(const float* P, const float* A,
                                  const float* rho, float* out, float* ws,
                                  float* CD, float* DR, float* Dinv, int B,
                                  int n, int m, float sigma, void* stream) {
  if (n % NB || m % NB || n <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int levels = n / NB, T = n / TM;
  // X_k for k = 0 .. levels; X_levels is the output.
  auto X = [&](int k) { return (levels - k) % 2 == 0 ? out : ws; };
  normal_gram_kernel<<<dim3(T * (T + 1) / 2, B), TPB, 0, s>>>(P, A, rho, X(0), n, m, sigma);
  cudaError_t e = cudaGetLastError();
  for (int k = 0; k < levels && e == cudaSuccess; ++k) {
    const int s0 = k * NB;
    qps::sweep_block_kernel<false, false><<<B, qps::kSweepThreads, 0, s>>>(
        X(k) + (i64)s0 * n + s0, (i64)n * n, n, Dinv);
    normal_level_products_kernel<<<dim3(4 * T, B), TPB, 0, s>>>(X(k), Dinv, CD, DR, n, s0);
    normal_level_update_kernel<<<dim3(T, T, B), TPB, 0, s>>>(
        X(k), CD, DR, Dinv, X(k + 1), n, s0, k == levels - 1);
    e = cudaGetLastError();
  }
  return (int)e;
}
