// Sigma-free ADMM chunk at "highest" with each lane's G and A held on chip by
// a thread-block cluster.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_admm.py:
// _chunk_kernel, sigma-free branch at dot_precision "highest" and lanes 1,
// which admm_chunk.cu's admm_chunk_kernel<kHighest, false> also runs (and
// runs still for every other variant). Per lane and iteration:
//
//   t  = rho * z - y
//   xx = G t - g                 G = M^{-1}A' (n x m), g = M^{-1}q
//   zz = A xx
//   x  = alpha*xx + (1-alpha)*x
//   z  = clip(alpha*zz + (1-alpha)*z + (1/rho)*y, l, u)
//   y  = y + rho*(alpha*zz + (1-alpha)*z_prev - z)
//
// with the same outputs (x, z, y, x_prev, z_prev, A x, A'y) and frozen lanes
// (active == 0: pass through, check products still computed).
//
// What bounds it on the H100: the streaming kernel reads G and A (1 MB a
// lane at n=512, m=256) from device memory every iteration, because a CTA's
// 227 KB cannot hold them. Here a cluster of 8 CTAs (the portable size) of
// 512 threads holds one lane in registers: CTA r keeps rows [r n/8, (r+1)
// n/8) of G and [r m/8, (r+1) m/8) of A, warp w of it n/128 of those G rows
// and m/128 of those A rows, each lane the 16-byte pieces rows_dot gives it
// (8 (n/128)(m/128) floats a thread, 64 at 512/256), and owns those rows of
// x, xx, g and of z, y, l, u, rho. An iteration is then:
//
//   1. G rows: xx_i = G_i . t - g_i for the CTA's rows, sent into every
//      CTA's copy of xx (st.async into distributed shared memory, counted by
//      the receiver's mbarrier; a warp's n/128 rows go in one 16-byte
//      store a CTA: the count of stores, not their bytes, sets the time);
//   2. once its mbarrier has all of xx: the x update of the CTA's rows; A
//      rows: zz_r = A_r . xx, the z, y update of those rows and the next
//      iteration's t_r = rho_r z_r - y_r, sent into every CTA's copy of t.
//
// t and xx are double-buffered (and their mbarriers with them), so a CTA
// waits only for the data it reads: a sender can only reach a buffer again
// after every CTA has sent it the data that followed the buffer's last read.
// The iteration reads no matrix from memory of any kind, so its time is the
// latency of that chain (two warp dots, two cluster-wide sends) times K.
// The clusters are persistent (as many as the card holds at once) and walk
// the lanes; while one lane iterates, cp.async brings the next lane's G and
// A rows and this lane's A columns (for A'y) into shared memory (3nm/8
// floats, 192 KB at 512/256), so the loads hide behind the iterations. The
// epilogue gathers x and y into every CTA (one cluster barrier), takes A x
// from the register rows and A'y from the CTA's n/8 columns of A.
//
// Bits: every row dot keeps rows_dot's lane mapping and sum order (lane l
// sums the float4s l, l + 32, ..., one FMA an element, then the shuffle
// tree), the updates are the streaming kernel's expressions with its FMA
// contractions (relax; 1/rho once a lane, the same quotient), and A'y keeps
// cols_dot's order at the streaming kernel's 256 threads: column c sums the
// rows r = g, g + G, ... in groups g < G = 256 / (n/4), then 0 + group 0 +
// group 1 + .... So all seven outputs equal admm_chunk_kernel<kHighest,
// false>'s bit for bit. Shapes: n, m multiples of 128 with (n/128)(m/128)
// <= 8 and both <= 512 (the register budget); ops/fused_admm.py:
// chunk_kernel sends every other shape to the streaming kernel.

#include "cluster.cuh"

using qps::i64;
using namespace qps::cluster;

namespace {
constexpr int STREAM_THREADS = 256;  // admm_chunk.cu's THREADS (cols_dot's order)

// cols_dot's row groups at the streaming kernel's thread count (n <= 512,
// so n/4 < 256 and every column is summed in groups).
__host__ __device__ constexpr int aty_groups(int n) { return STREAM_THREADS / (n / 4); }

// Floats of shared memory a CTA needs: 4 mbarriers (16 floats), the next
// lane's G and A rows and this lane's A columns, t and xx twice, the x and y
// gathers twice, the CTA's vector rows and A'y's partial sums.
__host__ __device__ constexpr int cluster_floats(int n, int m) {
  return 16 + 3 * (n / C) * m + 4 * (m + n) + 3 * (n / C) + 7 * (m / C) +
         aty_groups(n) * (n / C);
}

// al * v + al1 * prev as the streaming kernel's compiler contracts it:
// the product with prev is the fused one (fma(al1, prev, al * v)). Written
// out, since which of two products nvcc fuses follows the order in which
// their operands were computed, and here v comes from a warp's shuffles.
__device__ __forceinline__ float relax(float al, float v, float al1, float prev) {
  return __fmaf_rn(al1, prev, __fmul_rn(al, v));
}
}  // namespace

// NB = n / 128 (G rows a warp, float4s an A row a lane), MB = m / 128 (A
// rows a warp, float4s a G row a lane).
template <int NB, int MB>
__global__ void __launch_bounds__(THREADS, 1)
admm_chunk_cluster_kernel(const float* __restrict__ G, int ldG,
                          const float* __restrict__ A, const float* __restrict__ g,
                          const float* __restrict__ l, const float* __restrict__ u,
                          const float* __restrict__ rho, const float* __restrict__ x_in,
                          const float* __restrict__ z_in, const float* __restrict__ y_in,
                          const int* __restrict__ active, float* __restrict__ xo,
                          float* __restrict__ zo, float* __restrict__ yo,
                          float* __restrict__ xpo, float* __restrict__ zpo,
                          float* __restrict__ Axo, float* __restrict__ ATyo, int B,
                          int K, float alpha) {
  constexpr int n = 128 * NB, m = 128 * MB, nr = n / C, mr = m / C;
  constexpr int groups = aty_groups(n);
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = static_cast<int>(__clusterRelativeBlockRank());
  const int cid = static_cast<int>(__clusterIdx().x);
  const int ncl = static_cast<int>(__clusterGridDimInClusters().x);
  const int i0 = rank * nr, r0 = rank * mr;

  float* PG = sm + 16;        // nr x m: the next lane's G rows i0..
  float* PA = PG + nr * m;    // mr x n: the next lane's A rows r0..
  float* AC = PA + mr * n;    // m x nr: this lane's A columns i0..
  float* tv = AC + m * nr;    // 2 x m: t, by iteration parity
  float* xv = tv + 2 * m;     // 2 x n: xx, by iteration parity
  float* yg = xv + 2 * n;     // 2 x m: y gathered, by lane parity
  float* xg = yg + 2 * m;     // 2 x n: x gathered, by lane parity
  float* x = xg + 2 * n;      // nr each: x, x_prev, g of rows i0..
  float* xp = x + nr;
  float* gv = xp + nr;
  float* z = gv + nr;         // mr each: z, z_prev, y, l, u, rho, 1/rho of rows r0..
  float* zp = z + mr;
  float* y = zp + mr;
  float* lo = y + mr;
  float* up = lo + mr;
  float* rh = up + mr;
  float* ri = rh + mr;
  float* part = ri + mr;      // groups x nr: A'y's partial sums
  // mbarriers: t of parity 0 and 1, then xx of parity 0 and 1.
  const unsigned mb = smem_u32(sm);
  if (tid == 0) {
    for (int q = 0; q < 4; ++q) mbar_init(mb + 8 * q);
    for (int q = 0; q < 4; ++q) mbar_expect(mb + 8 * q, (q < 2 ? m : n) * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA of the cluster must have started (and armed its mbarriers)
  // before another sends to it: arrive now, wait before the first send.
  cluster_arrive();
  if (cid < B) {
    load_rows(PG, G + (i64)cid * n * ldG + (i64)i0 * ldG, ldG, nr, m);
    load_rows(PA, A + (i64)cid * m * n + (i64)r0 * n, n, mr, n);
  }
  cp_async_commit();
  // This lane's (lane < C) destination CTA: the addresses it sends to.
  const int dst = lane < C ? lane : 0;
  const unsigned tv_d = mapa(smem_u32(tv), dst), xv_d = mapa(smem_u32(xv), dst);
  const unsigned mb_d = mapa(mb, dst);
  cluster_wait();

  float4 gr[NB][MB], ar[MB][NB];
  unsigned phase_t[2] = {0, 0}, phase_x[2] = {0, 0};
  const float al = alpha, al1 = 1.0f - alpha;
  for (int b = cid, lp = 0; b < B; b += ncl, lp ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // lane b's rows are in PG, PA
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int k = 0; k < MB; ++k)
        gr[q][k] = reinterpret_cast<const float4*>(PG + (warp * NB + q) * m)[lane + 32 * k];
#pragma unroll
    for (int q = 0; q < MB; ++q)
#pragma unroll
      for (int k = 0; k < NB; ++k)
        ar[q][k] = reinterpret_cast<const float4*>(PA + (warp * MB + q) * n)[lane + 32 * k];
    __syncthreads();  // PG, PA read: refill them behind the iterations
    const float* Ab = A + (i64)b * m * n;
    load_rows(AC, Ab + i0, n, m, nr);
    cp_async_commit();
    if (b + ncl < B) {
      load_rows(PG, G + (i64)(b + ncl) * n * ldG + (i64)i0 * ldG, ldG, nr, m);
      load_rows(PA, A + (i64)(b + ncl) * m * n + (i64)r0 * n, n, mr, n);
    }
    cp_async_commit();
    for (int i = tid; i < nr; i += THREADS) {
      x[i] = x_in[(i64)b * n + i0 + i];
      xp[i] = x[i];
      gv[i] = g[(i64)b * n + i0 + i];
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
    __syncthreads();

    if (active[b] != 0) {  // uniform over the cluster
      // The first t, into every CTA's parity-0 copy.
      for (int e = tid; e < mr * C; e += THREADS) {
        const int r = e % mr, to = e / mr;
        const float t0[1] = {rh[r] * z[r] - y[r]};
        send(mapa(smem_u32(tv + r0 + r), to), t0, mapa(mb, to));
      }
      for (int it = 0; it < K; ++it) {
        const int p = it & 1;
        // 1. Once t is whole: xx for the warp's NB rows of i0.., sent to
        //    every CTA in one store (lane k of the warp to CTA k).
        mbar_wait(mb + 8 * p, phase_t[p]);
        phase_t[p] ^= 1;
        if (tid == 0) mbar_expect(mb + 8 * p, m * 4);
        float xs[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q)
          xs[q] = reg_dot(gr[q], tv + p * m, lane) - gv[warp * NB + q];
        if (lane < C) send(xv_d + 4 * (p * n + i0 + warp * NB), xs, mb_d + 8 * (2 + p));
        // 2. Once xx is whole: x rows i0..; zz, z, y and the next t for
        //    rows r0...
        mbar_wait(mb + 8 * (2 + p), phase_x[p]);
        phase_x[p] ^= 1;
        if (tid == 0) mbar_expect(mb + 8 * (2 + p), n * 4);
        for (int i = tid; i < nr; i += THREADS) {
          const float xprev = x[i];
          xp[i] = xprev;
          x[i] = relax(al, xv[p * n + i0 + i], al1, xprev);
        }
        float ts[MB];
#pragma unroll
        for (int q = 0; q < MB; ++q) {
          const int r = warp * MB + q;
          const float s = reg_dot(ar[q], xv + p * n, lane);
          const float zprev = z[r];
          const float zr = relax(al, s, al1, zprev);
          const float zn = fminf(fmaxf(zr + ri[r] * y[r], lo[r]), up[r]);
          const float yn = y[r] + rh[r] * (zr - zn);
          __syncwarp();
          if (lane == 0) {
            zp[r] = zprev;
            y[r] = yn;
            z[r] = zn;
          }
          ts[q] = rh[r] * zn - yn;
        }
        if (it + 1 < K && lane < C)
          send(tv_d + 4 * ((p ^ 1) * m + r0 + warp * MB), ts, mb_d + 8 * (p ^ 1));
        // No warp may fall a phase behind on an mbarrier (a phase can only
        // complete again after every warp here has sent its share).
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
    for (int q = 0; q < MB; ++q) {
      const float s = reg_dot(ar[q], xgl, lane);
      if (lane == 0) Axo[(i64)b * m + r0 + warp * MB + q] = s;
    }
    // A'y, columns i0.. (cols_dot's order at the streaming kernel's threads).
    cp_async_wait<1>();  // this lane's A columns (the next lane's rows may pend)
    __syncthreads();
    for (int e = tid; e < nr * groups; e += THREADS) {
      const int c = e % nr, grp = e / nr;
      float acc = 0.0f;
      for (int r = grp; r < m; r += groups) acc = fmaf(AC[r * nr + c], ygl[r], acc);
      part[grp * nr + c] = acc;
    }
    __syncthreads();
    for (int c = tid; c < nr; c += THREADS) {
      float s = 0.0f;
      for (int grp = 0; grp < groups; ++grp) s += part[grp * nr + c];
      ATyo[(i64)b * n + i0 + c] = s;
    }
  }
}

namespace {
template <int NB, int MB>
constexpr int smem_bytes() {
  constexpr int bytes = cluster_floats(128 * NB, 128 * MB) * (int)sizeof(float);
  static_assert(bytes <= (int)MAX_SMEM, "a CTA's shared memory");
  return bytes;
}

template <int NB, int MB>
cudaError_t resident_nm(int* out) {
  return resident(admm_chunk_cluster_kernel<NB, MB>, smem_bytes<NB, MB>(), out);
}

template <int NB, int MB>
cudaError_t launch(const float* G, int ldG, const float* A, const float* g,
                   const float* l, const float* u, const float* rho,
                   const float* x, const float* z, const float* y,
                   const int* active, float* xo, float* zo, float* yo,
                   float* xpo, float* zpo, float* Axo, float* ATyo, int B,
                   int K, float alpha, cudaStream_t s) {
  return launch_persistent(admm_chunk_cluster_kernel<NB, MB>, smem_bytes<NB, MB>(), B, s,
                           G, ldG, A, g, l, u, rho, x, z, y, active, xo, zo, yo, xpo,
                           zpo, Axo, ATyo, B, K, alpha);
}

cudaError_t launch_for(int n, int m, const float* G, int ldG, const float* A,
                       const float* g, const float* l, const float* u,
                       const float* rho, const float* x, const float* z,
                       const float* y, const int* active, float* xo, float* zo,
                       float* yo, float* xpo, float* zpo, float* Axo, float* ATyo,
                       int B, int K, float alpha, cudaStream_t s) {
  QPS_CLUSTER_DISPATCH(launch, n, m, G, ldG, A, g, l, u, rho, x, z, y, active, xo, zo,
                       yo, xpo, zpo, Axo, ATyo, B, K, alpha, s)
}

cudaError_t resident_for(int n, int m, int* out) {
  QPS_CLUSTER_DISPATCH(resident_nm, n, m, out)
}
}  // namespace

// G: f32 rows of pitch ldG (m for a contiguous (B, n, m) G, kp + n for the
// slab window), lane stride n * ldG; A (B, m, n), g/x (B, n), l/u/rho/z/y
// (B, m) contiguous f32, 16-byte aligned; active (B,) int32. n and m
// multiples of 128, at most 512, with (n/128)(m/128) <= 8
// (cudaErrorInvalidValue otherwise); ldG % 4 == 0, K >= 1.
extern "C" int qps_admm_chunk_cluster(const float* G, const float* A, const float* g,
                                      const float* l, const float* u,
                                      const float* rho, const float* x,
                                      const float* z, const float* y,
                                      const int* active, float* xo, float* zo,
                                      float* yo, float* xpo, float* zpo, float* Axo,
                                      float* ATyo, int B, int n, int m, int ldG,
                                      int K, float alpha, void* stream) {
  if (K < 1 || B < 1 || ldG % 4 || ldG < m) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_for(n, m, G, ldG, A, g, l, u, rho, x, z, y, active, xo, zo, yo,
                             xpo, zpo, Axo, ATyo, B, K, alpha,
                             static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of qps_admm_chunk_cluster at (n, m) the card holds at once
// (cudaOccupancyMaxActiveClusters): the lanes in flight. Into *out.
extern "C" int qps_admm_chunk_cluster_occupancy(int n, int m, int* out) {
  return (int)resident_for(n, m, out);
}
