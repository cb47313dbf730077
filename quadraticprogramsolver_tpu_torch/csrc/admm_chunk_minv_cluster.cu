// M^{-1}-form ADMM chunk with in-kernel refinement, each lane's M^{-1}, A and
// P held on chip by a thread-block cluster.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_admm.py:
// _chunk_kernel, M^{-1} branch with its refinement loop (fused_admm.py:71-79,
// 167-178) at every `lanes` (one lane a cluster: the outputs do not depend
// on how JAX interleaves lanes), which admm_chunk.cu's admm_chunk_minv_kernel
// also runs (and runs still at the shapes that do not fit a cluster). Per
// lane and iteration, with M = P +
// sigma*I + A' diag(rho) A and its cached inverse Minv:
//
//   t   = rho*z - y
//   rhs = sigma*x - q + A't
//   xx  = Minv rhs
//   refine times:  xx += Minv (rhs - (P xx + sigma*xx + A'(rho * A xx)))
//   zz  = A xx,  then the x, z, y updates of the sigma-free chunk
//
// with the same outputs (x, z, y, x_prev, z_prev, A x, A'y) and frozen lanes
// (active == 0: pass through, check products still computed).
//
// What bounds it on the H100: the streaming kernel reads every matrix from
// device memory each time it is used: with refine 1, Minv twice, P once and
// A four times an iteration, 5 MB a lane at n=512, m=256, so it runs at the
// memory's rate, some 40-55x the operations bound (about 2.6 MFLOP a lane
// and iteration). Here a cluster of 8 CTAs of 512 threads holds one lane for
// all K iterations. CTA r keeps, for its rows i0 = r n/8 .. of x and r0 =
// r m/8 .. of z:
//
//   registers: rows i0.. of Minv and r0.. of A, warp w the n/128 rows
//     i0 + w n/128 .. of Minv and the m/128 rows r0 + w m/128 .. of A, each
//     lane the 16-byte pieces rows_dot gives it: 4 (n/128)(n/128 + m/128)
//     floats a thread, 96 at 512/256;
//   shared memory: rows i0.. of P (refine > 0 only) and columns i0.. of A
//     (for A't, A'(rho A xx) and A'y), with the exchange buffers and the
//     CTA's vector rows: 213,952 bytes at 512/256 with refine (see
//     minv_cluster_floats; 82,880 without P).
//
// An iteration is a chain of cluster-wide all-gathers, each one every CTA
// sending its rows of a vector into every CTA's copy (st.async into
// distributed shared memory, counted by the receiver's mbarrier):
//
//   T   t rows (A-row owners)   -> A't over the CTA's A columns: rhs rows
//   R   rhs rows                -> Minv rows: xx rows
//   X   xx rows                 -> A rows: rho A xx rows; P rows: P xx
//   U   rho A xx rows           -> A' over the columns: the residual w rows
//   W   w rows                  -> Minv rows: xx += ...   (X again)
//   X   xx rows                 -> A rows: zz, the z, y updates, next t (T)
//
// three exchanges and three more a refinement pass (six at refine 1). Each
// exchange has one buffer and one mbarrier, re-armed by its waiter; a sender
// reaches a buffer again only after every CTA has sent it an exchange that
// follows the buffer's last read, so one buffer each suffices. No matrix is
// read from device memory inside an iteration, so the time is the latency of
// that chain times K. The clusters are persistent (as many as the card holds
// at once) and walk the lanes; a lane's matrices are loaded when it starts
// (registers by 16-byte loads, shared memory by cp.async), since the CTA's
// shared memory has no room for the next lane's. The epilogue gathers x and
// y into every CTA (one cluster barrier), takes A x from the register rows
// and A'y from the CTA's columns of A.
//
// Bits: every row dot keeps rows_dot's lane mapping and sum order (lane l
// sums the float4s l, l + 32, ..., one FMA an element, then the shuffle
// tree); every A' product keeps cols_dot's order at the streaming kernel's
// 256 threads (cluster.cuh: col_chains, col_sum: the CTA holds whole columns
// of A); the updates are the streaming kernel's expressions with the FMA
// contractions nvcc gives them there, written out (relax, and __fmaf_rn
// where one product meets one sum). So all seven outputs equal
// admm_chunk_minv_kernel's bit for bit. Shapes: n, m multiples of 128 with
// (n/128)(m/128) <= 8 and both <= 512 (then 4 (n/128)(n/128 + m/128) <= 96
// register floats a thread), the shared memory within a CTA's;
// ops/fused_admm.py: minv_chunk_kernel sends every other shape to the
// streaming kernel.

#include "cluster.cuh"

using qps::i64;
using namespace qps::cluster;

namespace {
// The exchanges' mbarriers, by index.
enum : int { kT = 0, kU = 1, kR = 2, kX = 3, kW = 4 };

// Floats of shared memory a CTA needs: 5 mbarriers (16 floats), the exchange
// buffers t, u (m each), rhs, xx, w (n each), the x and y gathers twice, the
// CTA's vector rows (x, x_prev, q, rhs, xx, P xx; z, z_prev, y, l, u, rho,
// 1/rho), the A' products' partial sums, the CTA's m x n/8 columns of A and,
// with refinement, its n/8 x n rows of P.
__host__ __device__ constexpr int minv_cluster_floats(int n, int m, bool withP) {
  return 16 + 2 * m + 3 * n + 2 * (n + m) + 6 * (n / C) + 7 * (m / C) +
         col_groups(n) * (n / C) + m * (n / C) + (withP ? (n / C) * n : 0);
}

// al * v + al1 * prev as the streaming kernel's compiler contracts it (the
// product with prev is the fused one); see admm_chunk_cluster.cu.
__device__ __forceinline__ float relax(float al, float v, float al1, float prev) {
  return __fmaf_rn(al1, prev, __fmul_rn(al, v));
}
}  // namespace

// NB = n / 128 (Minv rows a warp, float4s a row a lane), MB = m / 128 (A rows
// a warp).
template <int NB, int MB>
__global__ void __launch_bounds__(THREADS, 1)
admm_chunk_minv_cluster_kernel(const float* __restrict__ Minv, const float* __restrict__ A,
                               const float* __restrict__ P, const float* __restrict__ q,
                               const float* __restrict__ l, const float* __restrict__ u,
                               const float* __restrict__ rho, const float* __restrict__ x_in,
                               const float* __restrict__ z_in, const float* __restrict__ y_in,
                               const int* __restrict__ active, float* __restrict__ xo,
                               float* __restrict__ zo, float* __restrict__ yo,
                               float* __restrict__ xpo, float* __restrict__ zpo,
                               float* __restrict__ Axo, float* __restrict__ ATyo, int B,
                               int K, int refine, float alpha, float sigma) {
  constexpr int n = 128 * NB, m = 128 * MB, nr = n / C, mr = m / C;
  constexpr int G = col_groups(n);
  constexpr int S4 = nr / 4;  // float4s of the CTA's rows of an n-vector
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = static_cast<int>(__clusterRelativeBlockRank());
  const int cid = static_cast<int>(__clusterIdx().x);
  const int ncl = static_cast<int>(__clusterGridDimInClusters().x);
  const int i0 = rank * nr, r0 = rank * mr;

  float* tb = sm + 16;     // m: t                      (exchange T)
  float* ub = tb + m;      // m: rho * A xx             (exchange U)
  float* rb = ub + m;      // n: rhs                    (exchange R)
  float* xb = rb + n;      // n: xx                     (exchange X)
  float* wb = xb + n;      // n: the refinement residual (exchange W)
  float* xg = wb + n;      // 2 x n: x gathered, by lane parity
  float* yg = xg + 2 * n;  // 2 x m: y gathered, by lane parity
  float* x = yg + 2 * m;   // nr each, rows i0..: x, x_prev, q, rhs, xx, P xx
  float* xp = x + nr;
  float* qv = xp + nr;
  float* rl = qv + nr;
  float* xl = rl + nr;
  float* pl = xl + nr;
  float* z = pl + nr;      // mr each, rows r0..: z, z_prev, y, l, u, rho, 1/rho
  float* zp = z + mr;
  float* y = zp + mr;
  float* lo = y + mr;
  float* up = lo + mr;
  float* rh = up + mr;
  float* ri = rh + mr;
  float* part = ri + mr;   // G x nr: the A' products' partial sums
  float* AC = part + G * nr;  // m x nr: this lane's A columns i0..
  float* PS = AC + m * nr;    // nr x n: this lane's P rows i0.. (refine > 0)

  const unsigned mb = smem_u32(sm);
  // Bytes exchange k brings: t and u are m-vectors, the others n-vectors.
  auto bytes = [](int k) { return 4u * (k < kR ? m : n); };
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
  // Lane k < C of a warp sends the warp's W values v to CTA k's copy of
  // `dst` (a float of this CTA's buffer), counted on its mbarrier `bar`.
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
  cluster_wait();

  float4 mr4[NB][NB], ar[MB][NB];
  const float al = alpha, al1 = 1.0f - alpha, sg = sigma;
  for (int b = cid, lp = 0; b < B; b += ncl, lp ^= 1) {
    const bool act = active[b] != 0;  // uniform over the cluster
    const float* Ab = A + (i64)b * m * n;
    load_rows(AC, Ab + i0, n, m, nr);
    if (act && refine > 0) load_rows(PS, P + (i64)b * n * n + (i64)i0 * n, n, nr, n);
    cp_async_commit();
#pragma unroll
    for (int qq = 0; qq < MB; ++qq)
#pragma unroll
      for (int k = 0; k < NB; ++k)
        ar[qq][k] = __ldg(reinterpret_cast<const float4*>(
                              Ab + (i64)(r0 + warp * MB + qq) * n) + lane + 32 * k);
    if (act) {
      const float* Mb = Minv + (i64)b * n * n;
#pragma unroll
      for (int qq = 0; qq < NB; ++qq)
#pragma unroll
        for (int k = 0; k < NB; ++k)
          mr4[qq][k] = __ldg(reinterpret_cast<const float4*>(
                                 Mb + (i64)(i0 + warp * NB + qq) * n) + lane + 32 * k);
    }
    for (int i = tid; i < nr; i += THREADS) {
      x[i] = x_in[(i64)b * n + i0 + i];
      xp[i] = x[i];
      qv[i] = q[(i64)b * n + i0 + i];
    }
    for (int r = tid; r < mr; r += THREADS) {
      const i64 br = (i64)b * m + r0 + r;
      z[r] = z_in[br];
      zp[r] = z[r];
      y[r] = y_in[br];
      lo[r] = l[br];
      up[r] = u[br];
      rh[r] = rho[br];
      ri[r] = 1.0f / rh[r];
    }
    cp_async_wait<0>();
    __syncthreads();

    if (act) {
      // The first t, into every CTA's copy.
      for (int e = tid; e < mr * C; e += THREADS) {
        const int r = e % mr, to = e / mr;
        const float t0[1] = {__fmaf_rn(rh[r], z[r], -y[r])};
        send(mapa(smem_u32(tb + r0 + r), to), t0, mapa(mb + 8 * kT, to));
      }
      for (int it = 0; it < K; ++it) {
        // T -> rhs rows = (sigma x - q) + A't, sent (R).
        await(kT);
        col_chains<G>(AC, nr, tb, m, part, 0);
        __syncthreads();
        send_rows(rb, kR, rl, [&](int i) {
          return __fadd_rn(__fmaf_rn(sg, x[i], -qv[i]), col_sum<G>(part, nr, i));
        });
        __syncthreads();  // x, part read before they change
        // R -> xx rows = Minv rhs, sent (X).
        await(kR);
        float xs[NB];
#pragma unroll
        for (int qq = 0; qq < NB; ++qq) xs[qq] = reg_dot(mr4[qq], rb, lane);
        send_warp(xb + i0 + warp * NB, xs, kX);
        for (int pass = 0; pass < refine; ++pass) {
          __syncwarp();
          if (lane == 0) {
#pragma unroll
            for (int qq = 0; qq < NB; ++qq) xl[warp * NB + qq] = xs[qq];
          }
          // X -> u rows = rho * (A xx), sent (U); P xx rows kept.
          await(kX);
          float us[MB];
#pragma unroll
          for (int qq = 0; qq < MB; ++qq)
            us[qq] = __fmul_rn(rh[warp * MB + qq], reg_dot(ar[qq], xb, lane));
          send_warp(ub + r0 + warp * MB, us, kU);
#pragma unroll
          for (int qq = 0; qq < NB; ++qq) {
            const float s = smem_dot<NB>(PS + (warp * NB + qq) * n, xb, lane);
            if (lane == 0) pl[warp * NB + qq] = s;
          }
          __syncthreads();  // xl, pl whole
          // U -> w rows = rhs - ((P xx + sigma xx) + A'u), sent (W).
          await(kU);
          col_chains<G>(AC, nr, ub, m, part, 0);
          __syncthreads();
          send_rows(wb, kW, nullptr, [&](int i) {
            return __fsub_rn(rl[i], __fadd_rn(__fmaf_rn(sg, xl[i], pl[i]),
                                              col_sum<G>(part, nr, i)));
          });
          __syncthreads();  // xl, part read before they change
          // W -> xx rows += Minv w, sent (X).
          await(kW);
#pragma unroll
          for (int qq = 0; qq < NB; ++qq)
            xs[qq] = __fadd_rn(xs[qq], reg_dot(mr4[qq], wb, lane));
          send_warp(xb + i0 + warp * NB, xs, kX);
        }
        // The x update of the warp's rows i0.. (xs is xx there).
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int qq = 0; qq < NB; ++qq) {
            const int i = warp * NB + qq;
            const float xprev = x[i];
            xp[i] = xprev;
            x[i] = relax(al, xs[qq], al1, xprev);
          }
        }
        // X -> zz rows = A xx: the z, y updates and the next t, sent (T).
        await(kX);
        float ts[MB];
#pragma unroll
        for (int qq = 0; qq < MB; ++qq) {
          const int r = warp * MB + qq;
          const float s = reg_dot(ar[qq], xb, lane);
          const float zprev = z[r];
          const float zr = relax(al, s, al1, zprev);
          const float zn = fminf(fmaxf(__fmaf_rn(ri[r], y[r], zr), lo[r]), up[r]);
          const float yn = __fmaf_rn(rh[r], __fsub_rn(zr, zn), y[r]);
          __syncwarp();
          if (lane == 0) {
            zp[r] = zprev;
            y[r] = yn;
            z[r] = zn;
          }
          ts[qq] = __fmaf_rn(rh[r], zn, -yn);
        }
        if (it + 1 < K) send_warp(tb + r0 + warp * MB, ts, kT);
        __syncthreads();
      }
    }

    // Epilogue: this CTA's rows of the iterate; x and y into every CTA.
    for (int i = tid; i < nr; i += THREADS) {
      xo[(i64)b * n + i0 + i] = x[i];
      xpo[(i64)b * n + i0 + i] = xp[i];
    }
    for (int r = tid; r < mr; r += THREADS) {
      const i64 br = (i64)b * m + r0 + r;
      zo[br] = z[r];
      zpo[br] = zp[r];
      yo[br] = y[r];
    }
    float* xgl = xg + lp * n;
    float* ygl = yg + lp * m;
    for (int e = tid; e < nr * C; e += THREADS) {
      const int i = e % nr;
      float* d = static_cast<float*>(__cluster_map_shared_rank(xgl + i0 + i, e / nr));
      *d = x[i];
    }
    for (int e = tid; e < mr * C; e += THREADS) {
      const int r = e % mr;
      float* d = static_cast<float*>(__cluster_map_shared_rank(ygl + r0 + r, e / mr));
      *d = y[r];
    }
    // Every gather has landed; a CTA can be at most one lane ahead of
    // another past here, and the gathers alternate buffers by lane.
    cluster_sync();
    // A x, rows r0.. (rows_dot's order).
#pragma unroll
    for (int qq = 0; qq < MB; ++qq) {
      const float s = reg_dot(ar[qq], xgl, lane);
      if (lane == 0) Axo[(i64)b * m + r0 + warp * MB + qq] = s;
    }
    // A'y, columns i0.. (cols_dot's order at the streaming kernel's threads).
    col_chains<G>(AC, nr, ygl, m, part, 0);
    __syncthreads();
    for (int c = tid; c < nr; c += THREADS)
      ATyo[(i64)b * n + i0 + c] = col_sum<G>(part, nr, c);
    __syncthreads();  // AC, part read before the next lane's loads
  }
}

namespace {
template <int NB, int MB>
int smem_bytes(bool withP) {
  return minv_cluster_floats(128 * NB, 128 * MB, withP) * (int)sizeof(float);
}

template <int NB, int MB>
cudaError_t resident_nm(int refine, int* out) {
  return resident(admm_chunk_minv_cluster_kernel<NB, MB>, smem_bytes<NB, MB>(refine > 0),
                  out);
}

template <int NB, int MB>
cudaError_t launch(const float* Minv, const float* A, const float* P, const float* q,
                   const float* l, const float* u, const float* rho, const float* x,
                   const float* z, const float* y, const int* active, float* xo,
                   float* zo, float* yo, float* xpo, float* zpo, float* Axo,
                   float* ATyo, int B, int K, int refine, float alpha, float sigma,
                   cudaStream_t s) {
  const int smem = smem_bytes<NB, MB>(refine > 0);
  if (smem > (int)MAX_SMEM) return cudaErrorInvalidValue;
  return launch_persistent(admm_chunk_minv_cluster_kernel<NB, MB>, smem, B, s, Minv, A, P,
                           q, l, u, rho, x, z, y, active, xo, zo, yo, xpo, zpo, Axo, ATyo,
                           B, K, refine, alpha, sigma);
}

cudaError_t launch_for(int n, int m, const float* Minv, const float* A, const float* P,
                       const float* q, const float* l, const float* u, const float* rho,
                       const float* x, const float* z, const float* y, const int* active,
                       float* xo, float* zo, float* yo, float* xpo, float* zpo,
                       float* Axo, float* ATyo, int B, int K, int refine, float alpha,
                       float sigma, cudaStream_t s) {
  QPS_CLUSTER_DISPATCH(launch, n, m, Minv, A, P, q, l, u, rho, x, z, y, active, xo, zo,
                       yo, xpo, zpo, Axo, ATyo, B, K, refine, alpha, sigma, s)
}

cudaError_t resident_for(int n, int m, int refine, int* out) {
  QPS_CLUSTER_DISPATCH(resident_nm, n, m, refine, out)
}
}  // namespace

// Contiguous f32, 16-byte aligned: Minv/P (B, n, n) (P read only when refine
// > 0, else may be null), A (B, m, n), q/x (B, n), l/u/rho/z/y (B, m); active
// (B,) int32. n and m multiples of 128, at most 512, with (n/128)(m/128) <= 8
// and the shared memory within a CTA's (cudaErrorInvalidValue otherwise);
// K >= 1, refine >= 0.
extern "C" int qps_admm_chunk_minv_cluster(const float* Minv, const float* A,
                                           const float* P, const float* q,
                                           const float* l, const float* u,
                                           const float* rho, const float* x,
                                           const float* z, const float* y,
                                           const int* active, float* xo, float* zo,
                                           float* yo, float* xpo, float* zpo,
                                           float* Axo, float* ATyo, int B, int n,
                                           int m, int K, int refine, float alpha,
                                           float sigma, void* stream) {
  if (K < 1 || B < 1 || refine < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_for(n, m, Minv, A, P, q, l, u, rho, x, z, y, active, xo, zo, yo,
                             xpo, zpo, Axo, ATyo, B, K, refine, alpha, sigma,
                             static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of qps_admm_chunk_minv_cluster at (n, m, refine) the card
// holds at once (cudaOccupancyMaxActiveClusters): the lanes in flight. Into
// *out.
extern "C" int qps_admm_chunk_minv_cluster_occupancy(int n, int m, int refine, int* out) {
  return (int)resident_for(n, m, refine, out);
}
