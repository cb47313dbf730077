// ADMM chunks: K OSQP-ADMM iterations per active lane in one launch.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_admm.py:
// _chunk_kernel in every variant the solver reaches: the sigma-free form
// (admm_chunk_kernel) with its G as a contiguous f32 (B, n, m) operand, as a
// window of the factor's slab (row pitch kp + n, Settings.slab_cache) or as
// two bf16 halves (Settings.split_cache), at each product precision
// ("highest", "high" = bf16x3, "default" = one bf16 pass; common.cuh: Prec),
// and the M^{-1} form with refinement (admm_chunk_minv_kernel); both with
// `lanes` lanes per CTA. Per lane and iteration (sigma-free):
//
//   t  = rho * z - y
//   xx = G t - g                 G = M^{-1}A' (n x m), g = M^{-1}q
//   zz = A xx
//   x  = alpha*xx + (1-alpha)*x
//   z  = clip(alpha*zz + (1-alpha)*z + (1/rho)*y, l, u)
//   y  = y + rho*(alpha*zz + (1-alpha)*z_prev - z)
//
// Outputs x, z, y, x_prev, z_prev (the iterate at the start of the last
// iteration) and the check products A x and A'y. A frozen lane (active == 0)
// passes through with x_prev = x and z_prev = z, and its A x and A'y are
// still computed, exactly as on the TPU (fused_admm.py:129-135, 196-212).
//
// What bounds it on the H100: bytes. G and A are 512 KB each per lane at
// n=512, m=256, more than a CTA's 227 KB of shared memory, so each iteration
// streams them from device memory: 4.3 GB per iteration at B=4096, ~1.3 ms at
// 3.35 TB/s, against 2.1 GFLOP (far below the FP32 peak). Design: one CTA of
// 8 warps owns `lanes` lanes and runs all K iterations in a loop; the vectors
// live in shared memory; G t and A xx read their matrix one row per warp with
// 16-byte coalesced loads and a shuffle reduction (common.cuh: rows_dot);
// __syncthreads() separates the dependent products. A'y is a column
// reduction (cols_dot). Each CTA reads its lanes' active flags (the TPU
// kernel's scalar prefetch). Where a lane fits a thread-block cluster the
// solver runs admm_chunk_cluster.cu instead, which holds G and A on chip
// in every variant below (the same bits); this kernel serves the other
// shapes and is that kernel's witness.
//
// What each TPU knob means here (none changes the bytes streamed):
//   lanes: L lanes per CTA, grid B / L. Each stage issues the row dots of
//     all L lanes back to back between two barriers, and each row's sum is
//     taken in one fixed order (common.cuh: rows_dot), so every lane, frozen
//     or not, gets the bits it gets at L = 1. Frozen lanes of an active pack
//     skip the work and pass through. Shared memory grows with L.
//   "high": G t and A xx as bf16x3: the matrix elements are split in
//     registers as they are loaded, t and xx once per iteration into bf16
//     halves in shared memory, three FP32 FMAs per element. The check
//     products stay FP32 (fused_admm.py:209-212).
//   "default": every product at one bf16 pass, the check products A x and
//     A'y included, as on the TPU (its `dot` runs at the chunk's precision).
//   slab window: G is read with row pitch ldG = kp + n from the slab, whose
//     first m columns are G (ops/fused_factor.py); no (B, n, m) copy.
//   split: G arrives as bf16 halves Ghi, Glo (8-byte loads of four elements
//     each); "high" only, and the same bits as "high" on the f32 G.

#include "common.cuh"

using qps::i64;
using qps::Prec;

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a CTA can have

// Floats of shared memory each lane of admm_chunk_kernel<P> needs: the
// iterate vectors (t's operand form among them), plus xx's bf16 operand form
// and, at "high", t's low half.
template <Prec P>
__host__ __device__ constexpr int admm_lane_floats(int n, int m) {
  return 4 * n + 8 * m +
         (P == Prec::kHighest ? 0 : (P == Prec::kHigh ? m + 2 * n : n));
}

// One lane's vectors in shared memory (admm_chunk_kernel).
struct AdmmLane {
  float *x, *xp, *xx, *gv, *xh, *xl, *z, *zp, *y, *lo, *up, *rh, *th, *tl, *zz;
};

template <Prec P>
__device__ __forceinline__ AdmmLane admm_lane(float* base, int n, int m) {
  AdmmLane v;
  v.x = base;
  v.xp = v.x + n;
  v.xx = v.xp + n;
  v.gv = v.xx + n;
  v.z = v.gv + n;
  v.zp = v.z + m;
  v.y = v.zp + m;
  v.lo = v.y + m;
  v.up = v.lo + m;
  v.rh = v.up + m;
  v.zz = v.rh + m;
  v.th = v.zz + m;  // t's operand form (t itself at "highest")
  float* ext = v.th + m;
  if (P == Prec::kHighest) {
    v.tl = v.th;
    v.xh = v.xl = v.xx;
  } else if (P == Prec::kDefault) {
    v.tl = v.th;
    v.xh = v.xl = ext;
  } else {
    v.tl = ext;
    v.xh = ext + m;
    v.xl = v.xh + n;
  }
  return v;
}
}  // namespace

template <Prec P, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
admm_chunk_kernel(const float* __restrict__ G, const unsigned short* __restrict__ Ghi,
                  const unsigned short* __restrict__ Glo, int ldG,
                  const float* __restrict__ A, const float* __restrict__ g,
                  const float* __restrict__ l, const float* __restrict__ u,
                  const float* __restrict__ rho, const float* __restrict__ x_in,
                  const float* __restrict__ z_in, const float* __restrict__ y_in,
                  const int* __restrict__ active, float* __restrict__ xo,
                  float* __restrict__ zo, float* __restrict__ yo,
                  float* __restrict__ xpo, float* __restrict__ zpo,
                  float* __restrict__ Axo, float* __restrict__ ATyo, int n, int m,
                  int K, int lanes, float alpha) {
  // The check products' precision: one bf16 pass at "default", else FP32.
  constexpr Prec PC = P == Prec::kDefault ? Prec::kDefault : Prec::kHighest;
  extern __shared__ __align__(16) float sm[];
  const int per = admm_lane_floats<P>(n, m);
  float* part = sm + (i64)lanes * per;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * lanes;

  bool any = false;
  for (int li = 0; li < lanes; ++li) {
    const int b = b0 + li;
    const i64 bn = (i64)b * n, bm = (i64)b * m;
    AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
    for (int i = tid; i < n; i += THREADS) {
      v.x[i] = x_in[bn + i];
      v.xp[i] = v.x[i];
      v.gv[i] = g[bn + i];
    }
    for (int r = tid; r < m; r += THREADS) {
      v.z[r] = z_in[bm + r];
      v.zp[r] = v.z[r];
      v.y[r] = y_in[bm + r];
      v.lo[r] = l[bm + r];
      v.up[r] = u[bm + r];
      v.rh[r] = rho[bm + r];
    }
    any = any || active[b] != 0;
  }
  __syncthreads();

  if (any) {  // uniform over the CTA
    const float al = alpha, al1 = 1.0f - alpha;
    for (int it = 0; it < K; ++it) {
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
        for (int r = tid; r < m; r += THREADS)
          qps::split_store<P>(v.rh[r] * v.z[r] - v.y[r], v.th, v.tl, r);
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        const int b = b0 + li;
        if (active[b] == 0) continue;
        AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
        auto store = [&](int i, float s) {
          const float xv = s - v.gv[i];
          v.xx[i] = xv;
          qps::split_store<P>(xv, v.xh, v.xl, i);
        };
        if constexpr (SPLIT) {
          const i64 off = (i64)b * n * m;
          qps::rows_dot_split<WARPS>(Ghi + off, Glo + off, m, m, v.th, v.tl, n,
                                     store);
        } else {
          qps::rows_dot<WARPS, P>(G + (i64)b * n * ldG, ldG, m, v.th, v.tl, n,
                                  store);
        }
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        const int b = b0 + li;
        if (active[b] == 0) continue;
        AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
        qps::rows_dot<WARPS, P>(A + (i64)b * m * n, n, n, v.xh, v.xl, m,
                                [&](int r, float s) { v.zz[r] = s; });
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
        for (int i = tid; i < n; i += THREADS) {
          const float xprev = v.x[i];
          v.xp[i] = xprev;
          v.x[i] = al * v.xx[i] + al1 * xprev;
        }
        for (int r = tid; r < m; r += THREADS) {
          const float zprev = v.z[r];
          const float zr = al * v.zz[r] + al1 * zprev;
          const float zn = fminf(fmaxf(zr + (1.0f / v.rh[r]) * v.y[r], v.lo[r]), v.up[r]);
          v.zp[r] = zprev;
          v.y[r] = v.y[r] + v.rh[r] * (zr - zn);
          v.z[r] = zn;
        }
      }
      __syncthreads();
    }
  }

  for (int li = 0; li < lanes; ++li) {
    const i64 bn = (i64)(b0 + li) * n, bm = (i64)(b0 + li) * m;
    AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
    for (int i = tid; i < n; i += THREADS) {
      xo[bn + i] = v.x[i];
      xpo[bn + i] = v.xp[i];
      if (PC == Prec::kDefault) v.xh[i] = qps::bf16r(v.x[i]);
    }
    for (int r = tid; r < m; r += THREADS) {
      zo[bm + r] = v.z[r];
      zpo[bm + r] = v.zp[r];
      yo[bm + r] = v.y[r];
      if (PC == Prec::kDefault) v.th[r] = qps::bf16r(v.y[r]);
    }
  }
  __syncthreads();
  for (int li = 0; li < lanes; ++li) {
    const int b = b0 + li;
    AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
    const float* xv = PC == Prec::kDefault ? v.xh : v.x;
    qps::rows_dot<WARPS, PC>(A + (i64)b * m * n, n, n, xv, xv, m,
                             [&](int r, float s) { Axo[(i64)b * m + r] = s; });
  }
  for (int li = 0; li < lanes; ++li) {
    const int b = b0 + li;
    AdmmLane v = admm_lane<P>(sm + (i64)li * per, n, m);
    const float* yv = PC == Prec::kDefault ? v.th : v.y;
    qps::cols_dot<THREADS, PC>(A + (i64)b * m * n, n, yv, yv, m, part,
                               [&](int i, float s) { ATyo[(i64)b * n + i] = s; });
    __syncthreads();
  }
}

namespace {
template <Prec P, bool SPLIT>
int launch_admm_chunk(const float* G, const void* Ghi, const void* Glo, int ldG,
                      const float* A, const float* g, const float* l,
                      const float* u, const float* rho, const float* x,
                      const float* z, const float* y, const int* active,
                      float* xo, float* zo, float* yo, float* xpo, float* zpo,
                      float* Axo, float* ATyo, int B, int n, int m, int K,
                      int lanes, float alpha, cudaStream_t s) {
  const size_t smem = ((size_t)lanes * admm_lane_floats<P>(n, m) +
                       qps::cols_dot_part(THREADS)) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kern = admm_chunk_kernel<P, SPLIT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B / lanes, THREADS, smem, s>>>(
      G, static_cast<const unsigned short*>(Ghi),
      static_cast<const unsigned short*>(Glo), ldG, A, g, l, u, rho, x, z, y,
      active, xo, zo, yo, xpo, zpo, Axo, ATyo, n, m, K, lanes, alpha);
  return (int)cudaGetLastError();
}
}  // namespace

// G: f32 rows of pitch ldG (ldG = m for a contiguous (B, n, m) G, kp + n for
// the slab window), lane stride n * ldG; or, with Ghi != null, the bf16
// halves Ghi, Glo (B, n, m) and G unused (prec must be 1, "high"). A (B, m,
// n), g/x (B, n), l/u/rho/z/y (B, m) contiguous f32; active (B,) int32.
// n % 128 == 0, m % 128 == 0, ldG % 4 == 0, B % lanes == 0; prec 0 = highest,
// 1 = high, 2 = default.
extern "C" int qps_admm_chunk(const float* G, const void* Ghi, const void* Glo,
                              const float* A, const float* g, const float* l,
                              const float* u, const float* rho, const float* x,
                              const float* z, const float* y, const int* active,
                              float* xo, float* zo, float* yo, float* xpo,
                              float* zpo, float* Axo, float* ATyo, int B, int n,
                              int m, int ldG, int K, int lanes, int prec,
                              float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || B % lanes) return (int)cudaErrorInvalidValue;
#define QPS_ADMM_ARGS                                                           \
  G, Ghi, Glo, ldG, A, g, l, u, rho, x, z, y, active, xo, zo, yo, xpo, zpo, Axo, \
      ATyo, B, n, m, K, lanes, alpha, s
  if (Ghi != nullptr) {
    if (prec != 1) return (int)cudaErrorInvalidValue;
    return launch_admm_chunk<Prec::kHigh, true>(QPS_ADMM_ARGS);
  }
  switch (prec) {
    case 0: return launch_admm_chunk<Prec::kHighest, false>(QPS_ADMM_ARGS);
    case 1: return launch_admm_chunk<Prec::kHigh, false>(QPS_ADMM_ARGS);
    case 2: return launch_admm_chunk<Prec::kDefault, false>(QPS_ADMM_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef QPS_ADMM_ARGS
}

// M^{-1}-form ADMM chunk with in-kernel refinement.
//
// Replaces the same TPU kernel (fused_admm.py: _chunk_kernel) in its
// M^{-1}-form, "highest" variant with refine >= 0 passes (fused_admm.py:71-79,
// 167-178) and `lanes` lanes per CTA (as above: the row dots of all lanes
// back to back, the column reductions lane after lane, each lane's bits
// those of lanes = 1). Per lane and iteration, with M = P + sigma*I +
// A' diag(rho) A and its cached inverse Minv:
//
//   rhs = sigma*x - q + A'(rho*z - y)
//   xx  = Minv rhs
//   refine times:  xx += Minv (rhs - (P xx + sigma*xx + A'(rho * A xx)))
//   zz  = A xx,  then the x, z, y updates of the sigma-free kernel above.
//
// Contraction: xx = Minv rhs contracts Minv's SECOND axis (row dots), as the
// solver's torch chunk does (models/kkt.py: matvec(M_inv, b)); the TPU kernel
// contracts the first axis (rhs Minv). The sweep's inverse is symmetric only
// to rounding, so the plain version (ops/fused_admm.py) uses this kernel's
// contraction. P is symmetric, so P xx is a row dot either way.
//
// What bounds it on the H100: bytes. With refine = 1 an iteration reads Minv
// twice, P once and A four times (A' t, A xx twice, A'(rho A xx)): 5 MB per
// lane at n=512, m=256, ~10.7 GB per iteration at B=2048, against ~10 MFLOP a
// lane. Design: that of the sigma-free kernel, one CTA of 8 warps for all K
// iterations, vectors in shared memory, every matrix streamed from device
// memory each time it is used: row products one warp per row (warp_rows_dot),
// A' products as column reductions with 16-byte loads (cols_dot). Where a
// lane fits a cluster, at any lanes, the solver runs
// admm_chunk_minv_cluster.cu instead, which holds Minv, A and P on chip
// across a cluster (the same bits); this kernel serves the other shapes
// and is that kernel's witness.
namespace {
__host__ __device__ constexpr int minv_lane_floats(int n, int m) { return 6 * n + 8 * m; }

struct MinvLane {
  float *x, *xp, *xx, *rhs, *qv, *wv, *z, *zp, *y, *lo, *up, *rh, *tt, *zz;
};

__device__ __forceinline__ MinvLane minv_lane(float* base, int n, int m) {
  MinvLane v;
  v.x = base;
  v.xp = v.x + n;
  v.xx = v.xp + n;
  v.rhs = v.xx + n;
  v.qv = v.rhs + n;
  v.wv = v.qv + n;
  v.z = v.wv + n;
  v.zp = v.z + m;
  v.y = v.zp + m;
  v.lo = v.y + m;
  v.up = v.lo + m;
  v.rh = v.up + m;
  v.tt = v.rh + m;
  v.zz = v.tt + m;
  return v;
}
}  // namespace

__global__ void __launch_bounds__(THREADS)
admm_chunk_minv_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                       const float* __restrict__ P, const float* __restrict__ q,
                       const float* __restrict__ l, const float* __restrict__ u,
                       const float* __restrict__ rho, const float* __restrict__ x_in,
                       const float* __restrict__ z_in, const float* __restrict__ y_in,
                       const int* __restrict__ active, float* __restrict__ xo,
                       float* __restrict__ zo, float* __restrict__ yo,
                       float* __restrict__ xpo, float* __restrict__ zpo,
                       float* __restrict__ Axo, float* __restrict__ ATyo, int n,
                       int m, int K, int refine, int lanes, float alpha,
                       float sigma) {
  extern __shared__ __align__(16) float sm[];
  const int per = minv_lane_floats(n, m);
  float* part = sm + (i64)lanes * per;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * lanes;

  bool any = false;
  for (int li = 0; li < lanes; ++li) {
    const int b = b0 + li;
    const i64 bn = (i64)b * n, bm = (i64)b * m;
    MinvLane v = minv_lane(sm + (i64)li * per, n, m);
    for (int i = tid; i < n; i += THREADS) {
      v.x[i] = x_in[bn + i];
      v.xp[i] = v.x[i];
      v.qv[i] = q[bn + i];
    }
    for (int r = tid; r < m; r += THREADS) {
      v.z[r] = z_in[bm + r];
      v.zp[r] = v.z[r];
      v.y[r] = y_in[bm + r];
      v.lo[r] = l[bm + r];
      v.up[r] = u[bm + r];
      v.rh[r] = rho[bm + r];
    }
    any = any || active[b] != 0;
  }
  __syncthreads();

  // Lane li's matrices and view; `act` is uniform over the CTA.
#define QPS_LANE(li)                                           \
  const int b = b0 + (li);                                     \
  MinvLane v = minv_lane(sm + (i64)(li) * per, n, m);          \
  const float* Ab = A + (i64)b * m * n;                        \
  const float* Mb = Minv + (i64)b * n * n;                     \
  (void)Mb;                                                    \
  (void)Ab
  if (any) {
    const float al = alpha, al1 = 1.0f - alpha, sg = sigma;
    for (int it = 0; it < K; ++it) {
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        MinvLane v = minv_lane(sm + (i64)li * per, n, m);
        for (int r = tid; r < m; r += THREADS) v.tt[r] = v.rh[r] * v.z[r] - v.y[r];
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        qps::cols_dot<THREADS>(Ab, n, v.tt, v.tt, m, part, [&](int i, float s) {
          v.rhs[i] = (sg * v.x[i] - v.qv[i]) + s;
        });
        __syncthreads();
      }
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        qps::warp_rows_dot<WARPS>(Mb, n, v.rhs, n, [&](int i, float s) { v.xx[i] = s; });
      }
      __syncthreads();
      for (int pass = 0; pass < refine; ++pass) {
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::warp_rows_dot<WARPS>(Ab, n, v.xx, m,
                                    [&](int r, float s) { v.tt[r] = v.rh[r] * s; });
        }
        __syncthreads();
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::cols_dot<THREADS>(Ab, n, v.tt, v.tt, m, part,
                                 [&](int i, float s) { v.wv[i] = s; });
          __syncthreads();
        }
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::warp_rows_dot<WARPS>(P + (i64)b * n * n, n, v.xx, n, [&](int i, float s) {
            v.wv[i] = v.rhs[i] - ((s + sg * v.xx[i]) + v.wv[i]);
          });
        }
        __syncthreads();
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::warp_rows_dot<WARPS>(Mb, n, v.wv, n, [&](int i, float s) { v.xx[i] += s; });
        }
        __syncthreads();
      }
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        qps::warp_rows_dot<WARPS>(Ab, n, v.xx, m, [&](int r, float s) { v.zz[r] = s; });
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        MinvLane v = minv_lane(sm + (i64)li * per, n, m);
        for (int i = tid; i < n; i += THREADS) {
          const float xprev = v.x[i];
          v.xp[i] = xprev;
          v.x[i] = al * v.xx[i] + al1 * xprev;
        }
        for (int r = tid; r < m; r += THREADS) {
          const float zprev = v.z[r];
          const float zr = al * v.zz[r] + al1 * zprev;
          const float zn = fminf(fmaxf(zr + (1.0f / v.rh[r]) * v.y[r], v.lo[r]), v.up[r]);
          v.zp[r] = zprev;
          v.y[r] = v.y[r] + v.rh[r] * (zr - zn);
          v.z[r] = zn;
        }
      }
      __syncthreads();
    }
  }

  for (int li = 0; li < lanes; ++li) {
    QPS_LANE(li);
    const i64 bn = (i64)b * n, bm = (i64)b * m;
    for (int i = tid; i < n; i += THREADS) {
      xo[bn + i] = v.x[i];
      xpo[bn + i] = v.xp[i];
    }
    for (int r = tid; r < m; r += THREADS) {
      zo[bm + r] = v.z[r];
      zpo[bm + r] = v.zp[r];
      yo[bm + r] = v.y[r];
    }
    qps::warp_rows_dot<WARPS>(Ab, n, v.x, m, [&](int r, float s) { Axo[bm + r] = s; });
  }
  for (int li = 0; li < lanes; ++li) {
    QPS_LANE(li);
    qps::cols_dot<THREADS>(Ab, n, v.y, v.y, m, part,
                           [&](int i, float s) { ATyo[(i64)b * n + i] = s; });
    __syncthreads();
  }
#undef QPS_LANE
}

// Contiguous f32: Minv/P (B, n, n) (P read only when refine > 0, else may be
// null), A (B, m, n), q/x (B, n), l/u/rho/z/y (B, m); active (B,) int32.
// n % 128 == 0, m % 128 == 0, B % lanes == 0.
extern "C" int qps_admm_chunk_minv(const float* Minv, const float* A,
                                   const float* P, const float* q,
                                   const float* l, const float* u,
                                   const float* rho, const float* x,
                                   const float* z, const float* y,
                                   const int* active, float* xo, float* zo,
                                   float* yo, float* xpo, float* zpo, float* Axo,
                                   float* ATyo, int B, int n, int m, int K,
                                   int refine, int lanes, float alpha,
                                   float sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || B % lanes) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)lanes * minv_lane_floats(n, m) +
                       qps::cols_dot_part(THREADS)) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        admm_chunk_minv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  admm_chunk_minv_kernel<<<B / lanes, THREADS, smem, s>>>(
      Minv, A, P, q, l, u, rho, x, z, y, active, xo, zo, yo, xpo, zpo, Axo, ATyo,
      n, m, K, refine, lanes, alpha, sigma);
  return (int)cudaGetLastError();
}
