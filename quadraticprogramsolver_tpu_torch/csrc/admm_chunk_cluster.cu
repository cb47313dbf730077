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

#include "common.cuh"

using qps::i64;

namespace {
constexpr int C = 8;                 // CTAs a cluster (a lane)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;  // 16: nr = 16 (n/128), mr = 16 (m/128)
constexpr int STREAM_THREADS = 256;  // admm_chunk.cu's THREADS (cols_dot's order)
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a CTA can have

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory word in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned mapa(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Arms the barrier's current phase: one arrival, `bytes` still to come.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Stores v[0..W) at the cluster address `a` and counts their bytes on the
// receiver's mbarrier `bar` (a cluster address too): one 8- or 16-byte
// store for W = 2 or 4 (a aligned to it), else W 4-byte stores.
template <int W>
__device__ __forceinline__ void send(unsigned a, const float (&v)[W], unsigned bar) {
  if constexpr (W == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
        "[%5];\n" ::"r"(a),
        "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(__float_as_uint(v[2])),
        "r"(__float_as_uint(v[3])), "r"(bar)
        : "memory");
  } else if constexpr (W == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
        ::"r"(a), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(bar)
        : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q)
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                   ::"r"(a + 4 * q), "r"(__float_as_uint(v[q])), "r"(bar)
                   : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Copies rows x cols floats (cols % 4 == 0) from global (row pitch ld) to
// shared memory (row pitch cols) with 16-byte cp.async, all threads (the
// caller commits the group).
__device__ __forceinline__ void load_rows(float* dst, const float* src, i64 ld,
                                          int rows, int cols) {
  const int c4n = cols / 4;
  for (int e = threadIdx.x; e < rows * c4n; e += THREADS) {
    const int r = e / c4n, c4 = e - r * c4n;
    cp_async16(dst + (i64)r * cols + 4 * c4, src + (i64)r * ld + 4 * c4);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every cp.async group of this thread but the `n` newest.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// al * v + al1 * prev as the streaming kernel's compiler contracts it:
// the product with prev is the fused one (fma(al1, prev, al * v)). Written
// out, since which of two products nvcc fuses follows the order in which
// their operands were computed, and here v comes from a warp's shuffles.
__device__ __forceinline__ float relax(float al, float v, float al1, float prev) {
  return __fmaf_rn(al1, prev, __fmul_rn(al, v));
}

// The dot of a register row (lane's float4s k = 0..KW-1 at l + 32k) with the
// shared vector v in rows_dot's order; every lane gets the sum.
template <int KW>
__device__ __forceinline__ float reg_dot(const float4 (&row)[KW], const float* v, int lane) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const float4 a = row[k], b = v4[lane + 32 * k];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return qps::warp_sum(s);
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
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (cid < B) {
    load_rows(PG, G + (i64)cid * n * ldG + (i64)i0 * ldG, ldG, nr, m);
    load_rows(PA, A + (i64)cid * m * n + (i64)r0 * n, n, mr, n);
  }
  cp_async_commit();
  // This lane's (lane < C) destination CTA: the addresses it sends to.
  const int dst = lane < C ? lane : 0;
  const unsigned tv_d = mapa(smem_u32(tv), dst), xv_d = mapa(smem_u32(xv), dst);
  const unsigned mb_d = mapa(mb, dst);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

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

cudaLaunchConfig_t launch_config(int grid, int smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of the instance the card holds at once, into *out.
template <int NB, int MB>
cudaError_t resident(int* out) {
  cudaError_t e = cudaFuncSetAttribute(admm_chunk_cluster_kernel<NB, MB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes<NB, MB>());
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(C, smem_bytes<NB, MB>(), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, admm_chunk_cluster_kernel<NB, MB>, &cfg);
}

template <int NB, int MB>
cudaError_t launch(const float* G, int ldG, const float* A, const float* g,
                   const float* l, const float* u, const float* rho,
                   const float* x, const float* z, const float* y,
                   const int* active, float* xo, float* zo, float* yo,
                   float* xpo, float* zpo, float* Axo, float* ATyo, int B,
                   int K, float alpha, cudaStream_t s) {
  int clusters = 0;
  cudaError_t e = resident<NB, MB>(&clusters);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(C * (B < clusters ? B : clusters), smem_bytes<NB, MB>(), s, &attr);
  return cudaLaunchKernelEx(&cfg, admm_chunk_cluster_kernel<NB, MB>, G, ldG, A, g, l, u, rho, x, z, y, active, xo,
                            zo, yo, xpo, zpo, Axo, ATyo, B, K, alpha);
}

// Calls F<NB, MB>(args...) for the (n, m) of one instance, or returns
// cudaErrorInvalidValue: n, m multiples of 128, at most 512, with
// (n/128)(m/128) <= 8.
#define QPS_CLUSTER_DISPATCH(F, ...)                                   \
  switch ((n / 128) * 16 + m / 128) {                                  \
    case 0x11: return F<1, 1>(__VA_ARGS__);                            \
    case 0x12: return F<1, 2>(__VA_ARGS__);                            \
    case 0x13: return F<1, 3>(__VA_ARGS__);                            \
    case 0x14: return F<1, 4>(__VA_ARGS__);                            \
    case 0x21: return F<2, 1>(__VA_ARGS__);                            \
    case 0x22: return F<2, 2>(__VA_ARGS__);                            \
    case 0x23: return F<2, 3>(__VA_ARGS__);                            \
    case 0x24: return F<2, 4>(__VA_ARGS__);                            \
    case 0x31: return F<3, 1>(__VA_ARGS__);                            \
    case 0x32: return F<3, 2>(__VA_ARGS__);                            \
    case 0x41: return F<4, 1>(__VA_ARGS__);                            \
    case 0x42: return F<4, 2>(__VA_ARGS__);                            \
    default: return cudaErrorInvalidValue;                             \
  }

cudaError_t launch_for(int n, int m, const float* G, int ldG, const float* A,
                       const float* g, const float* l, const float* u,
                       const float* rho, const float* x, const float* z,
                       const float* y, const int* active, float* xo, float* zo,
                       float* yo, float* xpo, float* zpo, float* Axo, float* ATyo,
                       int B, int K, float alpha, cudaStream_t s) {
  if (n % 128 || m % 128) return cudaErrorInvalidValue;
  QPS_CLUSTER_DISPATCH(launch, G, ldG, A, g, l, u, rho, x, z, y, active, xo, zo, yo,
                       xpo, zpo, Axo, ATyo, B, K, alpha, s)
}

cudaError_t resident_for(int n, int m, int* out) {
  if (n % 128 || m % 128) return cudaErrorInvalidValue;
  QPS_CLUSTER_DISPATCH(resident, out)
}
#undef QPS_CLUSTER_DISPATCH
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
