// M^{-1}-form prox-ALM chunk with in-kernel refinement, each lane's M^{-1},
// A, C and P held on chip by a thread-block cluster.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_proxqp.py:
// _chunk_kernel, M^{-1} branch with its refinement loop (fused_proxqp.py:
// 45-53, 141-157) at every `lanes` (one lane a cluster: the outputs do not
// depend on how JAX interleaves lanes), which prox_chunk.cu's
// prox_chunk_minv_kernel also runs (and runs still at the shapes that do not
// fit a cluster). Per lane and iteration, with one
// scalar rho, M = P + sigma*I + rho(A'A + C'C) and its cached inverse Minv:
//
//   r = -q + sigma*x + A'(rho*b - y) + C'(rho*(d - s) - z)
//   x = Minv r
//   refine times:  x += Minv (r - (P x + sigma*x + rho*(A'(A x) + C'(C x))))
//   s = max(d - C x - (1/rho)*z, 0),  y = y + rho*(A x - b),
//   z = max(z + rho*(C x - d + s), 0)
//
// with the same outputs (x, s, y, z) and frozen lanes (active == 0: the
// inputs pass through).
//
// What bounds it on the H100: the streaming kernel reads Minv twice, P once
// and A and C four times each an iteration at refine 1 (5 MB a lane at
// n=512, me = mi = 128) from device memory. This is admm_chunk_minv_cluster.cu's
// design with the stacked rows [A; C] (mt = me + mi) in place of A, as
// prox_chunk_cluster.cu stacks them: a cluster of 8 CTAs of 512 threads holds
// one lane. CTA r keeps rows i0 = r n/8 .. of Minv and r0 = r mt/8 .. of
// [A; C] in registers (4 (n/128)(n/128 + mt/128) floats a thread, 96 at
// 512/256), rows i0.. of P (refine > 0) and columns i0.. of [A; C] in shared
// memory (207,296 bytes a CTA at 512/128/128 with refine, 76,224 without P;
// see prox_minv_cluster_floats), and owns those rows of x, q and of y, b (an
// A row) or z, s, d (a C row). A stacked row's kind follows its index (A
// below me), so a warp walks its rows one at a time and each row's branch is
// uniform over the warp. An iteration is the chain of all-gathers
//
//   T   t rows = [rho b - y; rho(d - s) - z]  -> A't_a, C't_c: rhs rows
//   R   rhs rows                              -> Minv rows: x rows
//   X   x rows                                -> stacked rows: [A x; C x];
//                                                 P rows: P x
//   U   [A x; C x] rows                       -> A', C' over the columns: w
//   W   w rows                                -> Minv rows: x += ...  (X)
//   X   x rows                                -> stacked rows: the s, y, z
//                                                 updates and the next t (T)
//
// (three exchanges and three more a refinement pass), one buffer and one
// mbarrier each, as in the ADMM kernel. No output needs another CTA's rows,
// so a lane ends without a cluster barrier: a CTA cannot send the next lane's
// first t before every CTA has sent it this lane's last x, which each sends
// after its last read of this lane's buffers.
//
// Bits: row dots in rows_dot's order, A' and C' products in cols_dot's order
// at the streaming kernel's 256 threads (A's and C's columns summed
// separately, then rhs = ((sigma x - q) + A't_a) + C't_c and A'Ax + C'Cx as
// the streaming kernel adds them), the updates with the FMAs nvcc forms there
// (prox_chunk_cluster.cu writes the same ones), 1/rho the same quotient. So
// x, s, y and z equal prox_chunk_minv_kernel's bit for bit. Shapes: n and
// me + mi multiples of 128, both at most 512, with (n/128)((me+mi)/128) <= 8,
// me and mi multiples of 4, the shared memory within a CTA's;
// ops/fused_proxqp.py: minv_chunk_kernel sends every other shape to the
// streaming kernel.

#include "cluster.cuh"

using qps::i64;
using namespace qps::cluster;

namespace {
// The exchanges' mbarriers, by index.
enum : int { kT = 0, kU = 1, kR = 2, kX = 3, kW = 4 };

// Floats of shared memory a CTA needs: 5 mbarriers (16 floats), the exchange
// buffers t, u (mt each), rhs, x, w (n each), the CTA's vector rows (x, q,
// rhs, P x; y or z, b or d, s), the A' and C' products' partial sums, the
// CTA's mt x n/8 columns of [A; C] and, with refinement, its n/8 x n rows of
// P.
__host__ __device__ constexpr int prox_minv_cluster_floats(int n, int mt, bool withP) {
  return 16 + 2 * mt + 3 * n + 4 * (n / C) + 3 * (mt / C) + 2 * col_groups(n) * (n / C) +
         mt * (n / C) + (withP ? (n / C) * n : 0);
}
}  // namespace

// NB = n / 128 (Minv rows a warp, float4s a row a lane), MB = mt / 128
// (stacked rows a warp).
template <int NB, int MB>
__global__ void __launch_bounds__(THREADS, 1)
prox_chunk_minv_cluster_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                               const float* __restrict__ Cm, const float* __restrict__ P,
                               const float* __restrict__ q, const float* __restrict__ bvec,
                               const float* __restrict__ dvec, const float* __restrict__ rho,
                               const float* __restrict__ x_in, const float* __restrict__ s_in,
                               const float* __restrict__ y_in, const float* __restrict__ z_in,
                               const int* __restrict__ active, float* __restrict__ xo,
                               float* __restrict__ so, float* __restrict__ yo,
                               float* __restrict__ zo, int B, int me, int K, int refine,
                               float sigma) {
  constexpr int n = 128 * NB, mt = 128 * MB, nr = n / C, mr = mt / C;
  constexpr int G = col_groups(n);
  constexpr int S4 = nr / 4;  // float4s of the CTA's rows of an n-vector
  const int mi = mt - me;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = static_cast<int>(__clusterRelativeBlockRank());
  const int cid = static_cast<int>(__clusterIdx().x);
  const int ncl = static_cast<int>(__clusterGridDimInClusters().x);
  const int i0 = rank * nr, r0 = rank * mr;

  float* tb = sm + 16;     // mt: t                      (exchange T)
  float* ub = tb + mt;     // mt: [A x; C x]             (exchange U)
  float* rb = ub + mt;     // n: rhs                     (exchange R)
  float* xb = rb + n;      // n: x                       (exchange X)
  float* wb = xb + n;      // n: the refinement residual  (exchange W)
  float* x = wb + n;       // nr each, rows i0..: x, q, rhs, P x
  float* qv = x + nr;
  float* rl = qv + nr;
  float* pl = rl + nr;
  float* wv = pl + nr;     // mr each, stacked rows r0..: y (A) or z (C),
  float* wbv = wv + mr;    //   b (A) or d (C),
  float* ws = wbv + mr;    //   s (C)
  float* part = ws + mr;   // 2 x G x nr: A's, then C's partial sums
  float* partC = part + G * nr;
  float* AC = part + 2 * G * nr;  // mt x nr: this lane's [A; C] columns i0..
  float* PS = AC + mt * nr;       // nr x n: this lane's P rows i0.. (refine > 0)

  const unsigned mb = smem_u32(sm);
  // Bytes exchange k brings: t and u are mt-vectors, the others n-vectors.
  auto bytes = [](int k) { return 4u * (k < kR ? mt : n); };
  if (tid == 0) {
    for (int k = 0; k < 5; ++k) mbar_init(mb + 8 * k);
    for (int k = 0; k < 5; ++k) mbar_expect(mb + 8 * k, bytes(k));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA of the cluster must have started (and armed its mbarriers)
  // before another sends to it: arrive now, wait before the first send.
  cluster_arrive();
  unsigned phase = 0;  // bit k: the parity of mbarrier k's next completion
  // Waits for exchange k's buffer to be whole, then re-arms its mbarrier.
  auto await = [&](int k) {
    mbar_wait(mb + 8 * k, (phase >> k) & 1u);
    phase ^= 1u << k;
    if (tid == 0) mbar_expect(mb + 8 * k, bytes(k));
  };
  // Lane k < C of a warp sends the warp's values v to CTA k's copy of `dst`
  // (a float of this CTA's buffer), counted on its mbarrier `bar`.
  auto send_warp = [&](const float* dst, const auto& v, int bar) {
    if (lane < C) send(mapa(smem_u32(dst), lane), v, mapa(mb + 8 * bar, lane));
  };
  // Thread e < S4 * C sends float4 e % S4 of the CTA's rows of an n-vector,
  // made by f(i) for the four rows i, to CTA e / S4's copy of buffer `buf`;
  // the sender to CTA 0 also keeps them in `keep` (may be null).
  auto send_rows = [&](float* buf, int bar, float* keep, auto f) {
    if (tid < S4 * C) {
      const int c4 = tid % S4, to = tid / S4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = f(4 * c4 + e);
      if (keep != nullptr && to == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) keep[4 * c4 + e] = v[e];
      }
      send(mapa(smem_u32(buf + i0 + 4 * c4), to), v, mapa(mb + 8 * bar, to));
    }
  };
  // The A' and C' products of the stacked vector v over the CTA's columns:
  // A's rows on threads 0.., C's on the next nr * G threads.
  auto stacked_chains = [&](const float* v) {
    col_chains<G>(AC, nr, v, me, part, 0);
    col_chains<G>(AC + me * nr, nr, v + me, mi, partC, nr * G);
  };
  cluster_wait();

  float4 mr4[NB][NB], ar[MB][NB];
  const float sg = sigma;
  for (int b = cid; b < B; b += ncl) {
    const bool act = active[b] != 0;  // uniform over the cluster
    if (act) {
      // [A; C]'s columns i0.. and P's rows i0.. into shared memory.
      const int c4n = nr / 4;
      for (int e = tid; e < mt * c4n; e += THREADS) {
        const int r = e / c4n, c4 = e - r * c4n;
        const float* src = r < me ? A + ((i64)b * me + r) * n : Cm + ((i64)b * mi + r - me) * n;
        cp_async16(AC + r * nr + 4 * c4, src + i0 + 4 * c4);
      }
      if (refine > 0) load_rows(PS, P + (i64)b * n * n + (i64)i0 * n, n, nr, n);
      cp_async_commit();
      const float* Mb = Minv + (i64)b * n * n;
#pragma unroll
      for (int qq = 0; qq < NB; ++qq)
#pragma unroll
        for (int k = 0; k < NB; ++k)
          mr4[qq][k] = __ldg(reinterpret_cast<const float4*>(
                                 Mb + (i64)(i0 + warp * NB + qq) * n) + lane + 32 * k);
#pragma unroll
      for (int qq = 0; qq < MB; ++qq) {
        const int r = r0 + warp * MB + qq;
        const float* row = r < me ? A + ((i64)b * me + r) * n : Cm + ((i64)b * mi + r - me) * n;
#pragma unroll
        for (int k = 0; k < NB; ++k)
          ar[qq][k] = __ldg(reinterpret_cast<const float4*>(row) + lane + 32 * k);
      }
    }
    for (int i = tid; i < nr; i += THREADS) {
      x[i] = x_in[(i64)b * n + i0 + i];
      qv[i] = q[(i64)b * n + i0 + i];
    }
    for (int j = tid; j < mr; j += THREADS) {
      const int r = r0 + j;
      if (r < me) {
        wv[j] = y_in[(i64)b * me + r];
        wbv[j] = bvec[(i64)b * me + r];
      } else {
        const i64 k = (i64)b * mi + (r - me);
        wv[j] = z_in[k];
        wbv[j] = dvec[k];
        ws[j] = s_in[k];
      }
    }
    const float rr = rho[b];
    const float rinv = 1.0f / rr;
    cp_async_wait<0>();
    __syncthreads();

    if (act) {
      // The first t, into every CTA's copy.
      for (int e = tid; e < mr * C; e += THREADS) {
        const int j = e % mr, to = e / mr;
        const float t0[1] = {r0 + j < me ? __fmaf_rn(rr, wbv[j], -wv[j])
                                         : __fmaf_rn(rr, wbv[j] - ws[j], -wv[j])};
        send(mapa(smem_u32(tb + r0 + j), to), t0, mapa(mb + 8 * kT, to));
      }
      for (int it = 0; it < K; ++it) {
        // T -> rhs rows = ((sigma x - q) + A't_a) + C't_c, sent (R).
        await(kT);
        stacked_chains(tb);
        __syncthreads();
        send_rows(rb, kR, rl, [&](int i) {
          return __fadd_rn(__fadd_rn(__fmaf_rn(sg, x[i], -qv[i]), col_sum<G>(part, nr, i)),
                           col_sum<G>(partC, nr, i));
        });
        __syncthreads();  // x, part read before they change
        // R -> x rows = Minv rhs, sent (X).
        await(kR);
        float xs[NB];
#pragma unroll
        for (int qq = 0; qq < NB; ++qq) xs[qq] = reg_dot(mr4[qq], rb, lane);
        send_warp(xb + i0 + warp * NB, xs, kX);
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int qq = 0; qq < NB; ++qq) x[warp * NB + qq] = xs[qq];
        }
        for (int pass = 0; pass < refine; ++pass) {
          // X -> [A x; C x] rows, sent (U); P x rows kept.
          await(kX);
          float us[MB];
#pragma unroll
          for (int qq = 0; qq < MB; ++qq) us[qq] = reg_dot(ar[qq], xb, lane);
          send_warp(ub + r0 + warp * MB, us, kU);
#pragma unroll
          for (int qq = 0; qq < NB; ++qq) {
            const float s = smem_dot<NB>(PS + (warp * NB + qq) * n, xb, lane);
            if (lane == 0) pl[warp * NB + qq] = s;
          }
          __syncthreads();  // x, pl whole
          // U -> w rows = rhs - ((P x + sigma x) + rho (A'Ax + C'Cx)), sent (W).
          await(kU);
          stacked_chains(ub);
          __syncthreads();
          send_rows(wb, kW, nullptr, [&](int i) {
            const float w = __fadd_rn(col_sum<G>(part, nr, i), col_sum<G>(partC, nr, i));
            return __fsub_rn(rl[i], __fmaf_rn(rr, w, __fmaf_rn(sg, x[i], pl[i])));
          });
          __syncthreads();  // x, part read before they change
          // W -> x rows += Minv w, sent (X).
          await(kW);
#pragma unroll
          for (int qq = 0; qq < NB; ++qq)
            xs[qq] = __fadd_rn(xs[qq], reg_dot(mr4[qq], wb, lane));
          send_warp(xb + i0 + warp * NB, xs, kX);
          __syncwarp();
          if (lane == 0) {
#pragma unroll
            for (int qq = 0; qq < NB; ++qq) x[warp * NB + qq] = xs[qq];
          }
        }
        // X -> C x or A x rows: the row's update and the next t, sent (T).
        await(kX);
        float ts[MB];
#pragma unroll
        for (int qq = 0; qq < MB; ++qq) {
          const int j = warp * MB + qq;
          const float dot = reg_dot(ar[qq], xb, lane);
          const float wj = wv[j], bj = wbv[j];
          if (r0 + j < me) {
            const float yn = __fmaf_rn(rr, dot - bj, wj);
            __syncwarp();
            if (lane == 0) wv[j] = yn;
            ts[qq] = __fmaf_rn(rr, bj, -yn);
          } else {
            const float sn = fmaxf(__fmaf_rn(-rinv, wj, bj - dot), 0.0f);
            const float zn = fmaxf(__fmaf_rn(rr, dot - bj + sn, wj), 0.0f);
            __syncwarp();
            if (lane == 0) {
              wv[j] = zn;
              ws[j] = sn;
            }
            ts[qq] = __fmaf_rn(rr, bj - sn, -zn);
          }
        }
        if (it + 1 < K) send_warp(tb + r0 + warp * MB, ts, kT);
        __syncthreads();
      }
    }

    // This CTA's rows of the iterate (a frozen lane's are its inputs).
    for (int i = tid; i < nr; i += THREADS) xo[(i64)b * n + i0 + i] = x[i];
    for (int j = tid; j < mr; j += THREADS) {
      const int r = r0 + j;
      if (r < me) {
        yo[(i64)b * me + r] = wv[j];
      } else {
        const i64 k = (i64)b * mi + (r - me);
        zo[k] = wv[j];
        so[k] = ws[j];
      }
    }
    __syncthreads();  // the vector rows read before the next lane's
  }
  // No CTA may exit while another can still send to it.
  cluster_sync();
}

namespace {
template <int NB, int MB>
int smem_bytes(bool withP) {
  return prox_minv_cluster_floats(128 * NB, 128 * MB, withP) * (int)sizeof(float);
}

template <int NB, int MB>
cudaError_t resident_nm(int refine, int* out) {
  return resident(prox_chunk_minv_cluster_kernel<NB, MB>, smem_bytes<NB, MB>(refine > 0),
                  out);
}

template <int NB, int MB>
cudaError_t launch(const float* Minv, const float* A, const float* Cm, const float* P,
                   const float* q, const float* b, const float* d, const float* rho,
                   const float* x, const float* s, const float* y, const float* z,
                   const int* active, float* xo, float* so, float* yo, float* zo, int B,
                   int me, int K, int refine, float sigma, cudaStream_t st) {
  const int smem = smem_bytes<NB, MB>(refine > 0);
  if (smem > (int)MAX_SMEM) return cudaErrorInvalidValue;
  return launch_persistent(prox_chunk_minv_cluster_kernel<NB, MB>, smem, B, st, Minv, A,
                           Cm, P, q, b, d, rho, x, s, y, z, active, xo, so, yo, zo, B, me,
                           K, refine, sigma);
}

cudaError_t launch_for(int n, int mt, const float* Minv, const float* A, const float* Cm,
                       const float* P, const float* q, const float* b, const float* d,
                       const float* rho, const float* x, const float* s, const float* y,
                       const float* z, const int* active, float* xo, float* so, float* yo,
                       float* zo, int B, int me, int K, int refine, float sigma,
                       cudaStream_t st) {
  QPS_CLUSTER_DISPATCH(launch, n, mt, Minv, A, Cm, P, q, b, d, rho, x, s, y, z, active, xo,
                       so, yo, zo, B, me, K, refine, sigma, st)
}

cudaError_t resident_for(int n, int mt, int refine, int* out) {
  QPS_CLUSTER_DISPATCH(resident_nm, n, mt, refine, out)
}
}  // namespace

// Contiguous f32, 16-byte aligned: Minv/P (B, n, n) (P read only when refine
// > 0, else may be null), A (B, me, n), C (B, mi, n), q/x (B, n), b/y (B, me),
// d/s/z (B, mi), rho (B,); active (B,) int32. n and me + mi multiples of 128,
// at most 512, with (n/128)((me+mi)/128) <= 8, me and mi multiples of 4, the
// shared memory within a CTA's (cudaErrorInvalidValue otherwise); K >= 1,
// refine >= 0.
extern "C" int qps_prox_chunk_minv_cluster(const float* Minv, const float* A,
                                           const float* Cm, const float* P,
                                           const float* q, const float* b,
                                           const float* d, const float* rho,
                                           const float* x, const float* s,
                                           const float* y, const float* z,
                                           const int* active, float* xo, float* so,
                                           float* yo, float* zo, int B, int n, int me,
                                           int mi, int K, int refine, float sigma,
                                           void* stream) {
  if (K < 1 || B < 1 || refine < 0 || me < 0 || mi < 0 || me % 4 || mi % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_for(n, me + mi, Minv, A, Cm, P, q, b, d, rho, x, s, y, z, active,
                             xo, so, yo, zo, B, me, K, refine, sigma,
                             static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of qps_prox_chunk_minv_cluster at (n, me + mi, refine) the
// card holds at once (cudaOccupancyMaxActiveClusters): the lanes in flight.
// Into *out.
extern "C" int qps_prox_chunk_minv_cluster_occupancy(int n, int mt, int refine, int* out) {
  return (int)resident_for(n, mt, refine, out);
}
