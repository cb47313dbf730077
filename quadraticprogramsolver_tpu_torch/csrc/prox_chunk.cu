// Prox-ALM chunks: K ProxQP iterations per active lane in one launch.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_proxqp.py:
// _chunk_kernel in every variant the solver reaches: the sigma-free form
// (prox_chunk_kernel) at each product precision ("highest", "high" = bf16x3,
// "default" = one bf16 pass; common.cuh: Prec) and the M^{-1} form with
// refinement (prox_chunk_minv_kernel); both with `lanes` lanes per CTA. Per
// lane, with one scalar rho (the TPU kernel's scalar prefetch) and
// G = [Ga | Gc] = M^{-1}[A' C'] (n x (me + mi)), g = M^{-1}q:
//
//   t_a = rho*b - y,   t_c = rho*(d - s) - z
//   x   = G [t_a; t_c] - g
//   s   = max(d - C x - (1/rho)*z, 0)
//   y   = y + rho*(A x - b)
//   z   = max(z + rho*(C x - d + s), 0)
//
// Outputs x, s, y, z. A frozen lane (active == 0) passes its inputs through
// bit for bit. The check products (Px, A'y, C'z, Ax, Cx) are not emitted:
// the solver computes them outside the kernel, as on the TPU.
//
// What bounds it on the H100: bytes. G, A and C are 512 KB, 256 KB and
// 256 KB per lane at n=512, me=mi=128, more than a CTA's 227 KB of shared
// memory, so each iteration streams them from device memory: 4.3 GB per
// iteration at B=4096, ~1.3 ms at 3.35 TB/s, against 2.1 GFLOP (far below
// the FP32 peak). Design (that of admm_chunk.cu): one CTA of 8 warps owns
// `lanes` lanes and runs all K iterations in a loop; the vectors live in
// shared memory; G t, C x and A x read their matrix one row per warp with
// 16-byte coalesced loads and a shuffle reduction (common.cuh: rows_dot), and
// __syncthreads() separates the dependent products. x is one row dot over
// the concatenated t = [t_a; t_c], so Ga and Gc are one contiguous operand.
//
// The knobs, as in admm_chunk.cu (none changes the bytes streamed): lanes =
// L lanes per CTA, each stage's row dots of all L lanes back to back, every
// lane's bits those of L = 1; "high" = G t, C x and A x as bf16x3 (matrix
// elements split in registers, t and x split once per iteration in shared
// memory; fused_proxqp.py:93-164); "default" = the same three products at
// one bf16 pass (fused_proxqp.py:85-91). Where a lane fits a thread-block
// cluster the solver runs prox_chunk_cluster.cu instead, which holds G, A
// and C on chip in every variant (the same bits); this kernel serves the
// other shapes and is that kernel's witness.

#include "common.cuh"

using qps::i64;
using qps::Prec;

namespace {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a CTA can have

// Floats of shared memory each lane of prox_chunk_kernel<P> needs: the
// iterate vectors (t's operand form among them), plus x's bf16 operand form
// and, at "high", t's low half.
template <Prec P>
__host__ __device__ constexpr int prox_lane_floats(int n, int me, int mi) {
  return 2 * n + 4 * me + 5 * mi +
         (P == Prec::kHighest ? 0 : (P == Prec::kHigh ? me + mi + 2 * n : n));
}

// One lane's vectors in shared memory (prox_chunk_kernel).
struct ProxLane {
  float *x, *gv, *th, *tl, *xh, *xl, *y, *bv, *ax, *z, *s, *dv, *cx;
};

template <Prec P>
__device__ __forceinline__ ProxLane prox_lane(float* base, int n, int me, int mi) {
  ProxLane v;
  v.x = base;
  v.gv = v.x + n;
  v.th = v.gv + n;  // [t_a | t_c]'s operand form (t itself at "highest")
  v.y = v.th + me + mi;
  v.bv = v.y + me;
  v.ax = v.bv + me;
  v.z = v.ax + me;
  v.s = v.z + mi;
  v.dv = v.s + mi;
  v.cx = v.dv + mi;
  float* ext = v.cx + mi;
  if (P == Prec::kHighest) {
    v.tl = v.th;
    v.xh = v.xl = v.x;
  } else if (P == Prec::kDefault) {
    v.tl = v.th;
    v.xh = v.xl = ext;
  } else {
    v.tl = ext;
    v.xh = ext + me + mi;
    v.xl = v.xh + n;
  }
  return v;
}
}  // namespace

template <Prec P>
__global__ void __launch_bounds__(THREADS)
prox_chunk_kernel(const float* __restrict__ G, const float* __restrict__ A,
                  const float* __restrict__ C, const float* __restrict__ g,
                  const float* __restrict__ bvec, const float* __restrict__ dvec,
                  const float* __restrict__ rho, const float* __restrict__ x_in,
                  const float* __restrict__ s_in, const float* __restrict__ y_in,
                  const float* __restrict__ z_in, const int* __restrict__ active,
                  float* __restrict__ xo, float* __restrict__ so,
                  float* __restrict__ yo, float* __restrict__ zo, int n, int me,
                  int mi, int K, int lanes) {
  extern __shared__ __align__(16) float sm[];
  const int mt = me + mi;
  const int per = prox_lane_floats<P>(n, me, mi);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * lanes;

  bool any = false;
  for (int li = 0; li < lanes; ++li) {
    const int lane = b0 + li;
    const i64 bn = (i64)lane * n, be = (i64)lane * me, bi = (i64)lane * mi;
    ProxLane v = prox_lane<P>(sm + (i64)li * per, n, me, mi);
    for (int i = tid; i < n; i += THREADS) {
      v.x[i] = x_in[bn + i];
      v.gv[i] = g[bn + i];
    }
    for (int k = tid; k < me; k += THREADS) {
      v.y[k] = y_in[be + k];
      v.bv[k] = bvec[be + k];
    }
    for (int k = tid; k < mi; k += THREADS) {
      v.z[k] = z_in[bi + k];
      v.s[k] = s_in[bi + k];
      v.dv[k] = dvec[bi + k];
    }
    any = any || active[lane] != 0;
  }
  __syncthreads();

  if (any) {  // uniform over the CTA
    for (int it = 0; it < K; ++it) {
      for (int li = 0; li < lanes; ++li) {
        const int lane = b0 + li;
        if (active[lane] == 0) continue;
        ProxLane v = prox_lane<P>(sm + (i64)li * per, n, me, mi);
        const float r = rho[lane];
        for (int k = tid; k < me; k += THREADS)
          qps::split_store<P>(r * v.bv[k] - v.y[k], v.th, v.tl, k);
        for (int k = tid; k < mi; k += THREADS)
          qps::split_store<P>(r * (v.dv[k] - v.s[k]) - v.z[k], v.th + me, v.tl + me, k);
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        const int lane = b0 + li;
        if (active[lane] == 0) continue;
        ProxLane v = prox_lane<P>(sm + (i64)li * per, n, me, mi);
        qps::rows_dot<WARPS, P>(G + (i64)lane * n * mt, mt, mt, v.th, v.tl, n,
                                [&](int i, float s) {
                                  const float xv = s - v.gv[i];
                                  v.x[i] = xv;
                                  if (P != Prec::kHighest)
                                    qps::split_store<P>(xv, v.xh, v.xl, i);
                                });
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        const int lane = b0 + li;
        if (active[lane] == 0) continue;
        ProxLane v = prox_lane<P>(sm + (i64)li * per, n, me, mi);
        qps::rows_dot<WARPS, P>(C + (i64)lane * mi * n, n, n, v.xh, v.xl, mi,
                                [&](int k, float s) { v.cx[k] = s; });
        qps::rows_dot<WARPS, P>(A + (i64)lane * me * n, n, n, v.xh, v.xl, me,
                                [&](int k, float s) { v.ax[k] = s; });
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        const int lane = b0 + li;
        if (active[lane] == 0) continue;
        ProxLane v = prox_lane<P>(sm + (i64)li * per, n, me, mi);
        const float r = rho[lane];
        const float rinv = 1.0f / r;
        for (int k = tid; k < mi; k += THREADS) {
          const float sn = fmaxf(v.dv[k] - v.cx[k] - rinv * v.z[k], 0.0f);
          v.z[k] = fmaxf(v.z[k] + r * (v.cx[k] - v.dv[k] + sn), 0.0f);
          v.s[k] = sn;
        }
        for (int k = tid; k < me; k += THREADS) v.y[k] = v.y[k] + r * (v.ax[k] - v.bv[k]);
      }
      __syncthreads();
    }
  }

  for (int li = 0; li < lanes; ++li) {
    const int lane = b0 + li;
    const i64 bn = (i64)lane * n, be = (i64)lane * me, bi = (i64)lane * mi;
    ProxLane v = prox_lane<P>(sm + (i64)li * per, n, me, mi);
    for (int i = tid; i < n; i += THREADS) xo[bn + i] = v.x[i];
    for (int k = tid; k < me; k += THREADS) yo[be + k] = v.y[k];
    for (int k = tid; k < mi; k += THREADS) {
      so[bi + k] = v.s[k];
      zo[bi + k] = v.z[k];
    }
  }
}

namespace {
template <Prec P>
int launch_prox_chunk(const float* G, const float* A, const float* C,
                      const float* g, const float* b, const float* d,
                      const float* rho, const float* x, const float* s,
                      const float* y, const float* z, const int* active,
                      float* xo, float* so, float* yo, float* zo, int B, int n,
                      int me, int mi, int K, int lanes, cudaStream_t st) {
  const size_t smem = (size_t)lanes * prox_lane_floats<P>(n, me, mi) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  auto kern = prox_chunk_kernel<P>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B / lanes, THREADS, smem, st>>>(G, A, C, g, b, d, rho, x, s, y, z,
                                         active, xo, so, yo, zo, n, me, mi, K,
                                         lanes);
  return (int)cudaGetLastError();
}
}  // namespace

// Contiguous f32: G (B, n, me + mi), A (B, me, n), C (B, mi, n), g/x (B, n),
// b/y (B, me), d/s/z (B, mi), rho (B,); active (B,) int32. n and me + mi
// multiples of 128, me and mi of 4 (16-byte rows of t and of the lane's
// vectors in shared memory); B % lanes == 0; prec 0 = highest, 1 = high,
// 2 = default.
extern "C" int qps_prox_chunk(const float* G, const float* A, const float* C,
                              const float* g, const float* b, const float* d,
                              const float* rho, const float* x, const float* s,
                              const float* y, const float* z, const int* active,
                              float* xo, float* so, float* yo, float* zo, int B,
                              int n, int me, int mi, int K, int lanes, int prec,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || B % lanes) return (int)cudaErrorInvalidValue;
#define QPS_PROX_ARGS \
  G, A, C, g, b, d, rho, x, s, y, z, active, xo, so, yo, zo, B, n, me, mi, K, lanes, st
  switch (prec) {
    case 0: return launch_prox_chunk<Prec::kHighest>(QPS_PROX_ARGS);
    case 1: return launch_prox_chunk<Prec::kHigh>(QPS_PROX_ARGS);
    case 2: return launch_prox_chunk<Prec::kDefault>(QPS_PROX_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef QPS_PROX_ARGS
}

// M^{-1}-form prox-ALM chunk with in-kernel refinement.
//
// Replaces the same TPU kernel (fused_proxqp.py: _chunk_kernel) in its
// M^{-1}-form, "highest" variant with refine >= 0 passes (fused_proxqp.py:
// 45-53, 141-157) and `lanes` lanes per CTA (the row dots of all lanes back
// to back, the column reductions lane after lane; each lane's bits those of
// lanes = 1). Per lane and iteration, with M = P + sigma*I + rho*(A'A + C'C)
// and its cached inverse Minv:
//
//   r = -q + sigma*x + A'(rho*b - y) + C'(rho*(d - s) - z)
//   x = Minv r
//   refine times:  x += Minv (r - (P x + sigma*x + rho*(A'(A x) + C'(C x))))
//   then the s, y, z updates of the sigma-free kernel above.
//
// Contraction: x = Minv r contracts Minv's second axis (row dots), as the
// solver's torch chunk does; see admm_chunk.cu.
//
// What bounds it on the H100: bytes. With refine = 1 an iteration reads Minv
// twice, P once, and A and C four times each: 5 MB per lane at n=512,
// me = mi = 128. Design: that of the sigma-free kernel (one CTA of 8 warps for
// all K iterations, vectors in shared memory, every matrix streamed each time
// it is used), with the A' and C' products as column reductions (cols_dot).
// Frozen lanes pass their inputs through bit for bit. Where a lane fits a
// cluster, at any lanes, the solver runs prox_chunk_minv_cluster.cu instead
// (Minv, [A; C] and P on chip across a cluster, the same bits); this kernel
// serves the other shapes and is that kernel's witness.
namespace {
__host__ __device__ constexpr int minv_lane_floats(int n, int me, int mi) {
  return 4 * n + 4 * me + 5 * mi;
}

struct MinvLane {
  float *x, *qv, *rhs, *wv, *t, *y, *bv, *ax, *z, *s, *dv, *cx;
};

__device__ __forceinline__ MinvLane minv_lane(float* base, int n, int me, int mi) {
  MinvLane v;
  v.x = base;
  v.qv = v.x + n;
  v.rhs = v.qv + n;
  v.wv = v.rhs + n;
  v.t = v.wv + n;  // [t_a (me) | t_c (mi)]
  v.y = v.t + me + mi;
  v.bv = v.y + me;
  v.ax = v.bv + me;
  v.z = v.ax + me;
  v.s = v.z + mi;
  v.dv = v.s + mi;
  v.cx = v.dv + mi;
  return v;
}
}  // namespace

__global__ void __launch_bounds__(THREADS)
prox_chunk_minv_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                       const float* __restrict__ C, const float* __restrict__ P,
                       const float* __restrict__ q, const float* __restrict__ bvec,
                       const float* __restrict__ dvec, const float* __restrict__ rho,
                       const float* __restrict__ x_in, const float* __restrict__ s_in,
                       const float* __restrict__ y_in, const float* __restrict__ z_in,
                       const int* __restrict__ active, float* __restrict__ xo,
                       float* __restrict__ so, float* __restrict__ yo,
                       float* __restrict__ zo, int n, int me, int mi, int K,
                       int refine, int lanes, float sigma) {
  extern __shared__ __align__(16) float sm[];
  const int per = minv_lane_floats(n, me, mi);
  float* part = sm + (i64)lanes * per;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * lanes;

  bool any = false;
  for (int li = 0; li < lanes; ++li) {
    const int lane = b0 + li;
    const i64 bn = (i64)lane * n, be = (i64)lane * me, bi = (i64)lane * mi;
    MinvLane v = minv_lane(sm + (i64)li * per, n, me, mi);
    for (int i = tid; i < n; i += THREADS) {
      v.x[i] = x_in[bn + i];
      v.qv[i] = q[bn + i];
    }
    for (int k = tid; k < me; k += THREADS) {
      v.y[k] = y_in[be + k];
      v.bv[k] = bvec[be + k];
    }
    for (int k = tid; k < mi; k += THREADS) {
      v.z[k] = z_in[bi + k];
      v.s[k] = s_in[bi + k];
      v.dv[k] = dvec[bi + k];
    }
    any = any || active[lane] != 0;
  }
  __syncthreads();

  // Lane li's view and matrices; `active` is uniform over the CTA.
#define QPS_LANE(li)                                             \
  const int lane = b0 + (li);                                    \
  MinvLane v = minv_lane(sm + (i64)(li) * per, n, me, mi);       \
  const float* Mb = Minv + (i64)lane * n * n;                    \
  const float* Ab = A + (i64)lane * me * n;                      \
  const float* Cb = C + (i64)lane * mi * n;                      \
  const float r = rho[lane];                                     \
  (void)Mb;                                                      \
  (void)Ab;                                                      \
  (void)Cb;                                                      \
  (void)r
  if (any) {
    const float sg = sigma;
    for (int it = 0; it < K; ++it) {
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        for (int k = tid; k < me; k += THREADS) v.t[k] = r * v.bv[k] - v.y[k];
        for (int k = tid; k < mi; k += THREADS) v.t[me + k] = r * (v.dv[k] - v.s[k]) - v.z[k];
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        qps::cols_dot<THREADS>(Ab, n, v.t, v.t, me, part, [&](int i, float s) {
          v.rhs[i] = (sg * v.x[i] - v.qv[i]) + s;
        });
        __syncthreads();
        qps::cols_dot<THREADS>(Cb, n, v.t + me, v.t + me, mi, part,
                               [&](int i, float s) { v.rhs[i] += s; });
        __syncthreads();
      }
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        qps::warp_rows_dot<WARPS>(Mb, n, v.rhs, n, [&](int i, float s) { v.x[i] = s; });
      }
      __syncthreads();
      for (int pass = 0; pass < refine; ++pass) {
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::warp_rows_dot<WARPS>(Ab, n, v.x, me, [&](int k, float s) { v.ax[k] = s; });
          qps::warp_rows_dot<WARPS>(Cb, n, v.x, mi, [&](int k, float s) { v.cx[k] = s; });
        }
        __syncthreads();
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::cols_dot<THREADS>(Ab, n, v.ax, v.ax, me, part,
                                 [&](int i, float s) { v.wv[i] = s; });
          __syncthreads();
          qps::cols_dot<THREADS>(Cb, n, v.cx, v.cx, mi, part,
                                 [&](int i, float s) { v.wv[i] += s; });
          __syncthreads();
        }
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::warp_rows_dot<WARPS>(P + (i64)lane * n * n, n, v.x, n, [&](int i, float s) {
            v.wv[i] = v.rhs[i] - ((s + sg * v.x[i]) + r * v.wv[i]);
          });
        }
        __syncthreads();
        for (int li = 0; li < lanes; ++li) {
          if (active[b0 + li] == 0) continue;
          QPS_LANE(li);
          qps::warp_rows_dot<WARPS>(Mb, n, v.wv, n, [&](int i, float s) { v.x[i] += s; });
        }
        __syncthreads();
      }
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        qps::warp_rows_dot<WARPS>(Cb, n, v.x, mi, [&](int k, float s) { v.cx[k] = s; });
        qps::warp_rows_dot<WARPS>(Ab, n, v.x, me, [&](int k, float s) { v.ax[k] = s; });
      }
      __syncthreads();
      for (int li = 0; li < lanes; ++li) {
        if (active[b0 + li] == 0) continue;
        QPS_LANE(li);
        const float rinv = 1.0f / r;
        for (int k = tid; k < mi; k += THREADS) {
          const float sn = fmaxf(v.dv[k] - v.cx[k] - rinv * v.z[k], 0.0f);
          v.z[k] = fmaxf(v.z[k] + r * (v.cx[k] - v.dv[k] + sn), 0.0f);
          v.s[k] = sn;
        }
        for (int k = tid; k < me; k += THREADS) v.y[k] = v.y[k] + r * (v.ax[k] - v.bv[k]);
      }
      __syncthreads();
    }
  }
#undef QPS_LANE

  for (int li = 0; li < lanes; ++li) {
    const int lane = b0 + li;
    const i64 bn = (i64)lane * n, be = (i64)lane * me, bi = (i64)lane * mi;
    MinvLane v = minv_lane(sm + (i64)li * per, n, me, mi);
    for (int i = tid; i < n; i += THREADS) xo[bn + i] = v.x[i];
    for (int k = tid; k < me; k += THREADS) yo[be + k] = v.y[k];
    for (int k = tid; k < mi; k += THREADS) {
      so[bi + k] = v.s[k];
      zo[bi + k] = v.z[k];
    }
  }
}

// Contiguous f32: Minv/P (B, n, n) (P read only when refine > 0, else may be
// null), A (B, me, n), C (B, mi, n), q/x (B, n), b/y (B, me), d/s/z (B, mi),
// rho (B,); active (B,) int32. n, me, mi multiples of 128; B % lanes == 0.
extern "C" int qps_prox_chunk_minv(const float* Minv, const float* A,
                                   const float* C, const float* P,
                                   const float* q, const float* b,
                                   const float* d, const float* rho,
                                   const float* x, const float* s,
                                   const float* y, const float* z,
                                   const int* active, float* xo, float* so,
                                   float* yo, float* zo, int B, int n, int me,
                                   int mi, int K, int refine, int lanes,
                                   float sigma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || B % lanes) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)lanes * minv_lane_floats(n, me, mi) +
                       qps::cols_dot_part(THREADS)) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        prox_chunk_minv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  prox_chunk_minv_kernel<<<B / lanes, THREADS, smem, st>>>(
      Minv, A, C, P, q, b, d, rho, x, s, y, z, active, xo, so, yo, zo, n, me, mi,
      K, refine, lanes, sigma);
  return (int)cudaGetLastError();
}
