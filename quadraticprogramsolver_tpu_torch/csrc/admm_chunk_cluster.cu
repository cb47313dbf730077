// Sigma-free ADMM chunk with each lane's G and A held on chip by a
// thread-block cluster, at every product precision and G source.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_admm.py:
// _chunk_kernel, sigma-free branch, at dot_precision "highest", "high"
// (bf16x3: the halves of G split once a grid step at :150-155, the stage at
// :158-170, FP32 check products at :206-212) and "default" (one bf16 pass,
// the check products too), from a contiguous G, the slab window or the
// bf16 halves (Settings.split_cache), at every `lanes`: JAX interleaves L
// lanes so the MXU has independent work while one lane's dots wait; here
// each lane runs in a cluster of its own and the outputs do not depend on
// L (a frozen lane of an active pack passes through, fused_admm.py:197),
// so `lanes` changes no kernel. admm_chunk.cu's admm_chunk_kernel<P, SPLIT>
// runs the same variants by streaming G and A (the shapes that do not fit a
// cluster, and this kernel's witness). Per lane and iteration:
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
// (8 (n/128)(m/128) 32-bit words a thread, 64 at 512/256), and owns those
// rows of x, g and of z, y, l, u, rho. An iteration is then:
//
//   1. G rows: xx_i = G_i . t - g_i for the CTA's rows and the x update of
//      those rows, xx's operand form sent into every CTA's copy of xx
//      (st.async into distributed shared memory, counted by the receiver's
//      mbarrier; a warp's n/128 rows go in one 16-byte store a CTA, two at
//      "high": the count of stores, not their bytes, sets the time);
//   2. once its mbarrier has all of xx: A rows: zz_r = A_r . xx, the z, y
//      update of those rows and the next iteration's t_r = rho_r z_r - y_r,
//      its operand form sent into every CTA's copy of t.
//
// The precisions (common.cuh: Prec; cluster.cuh: operand forms). G takes
// its operand form once a lane, in the prefetch buffer just before its rows
// move into registers (load_reg_rows: each thread converts the elements it
// then reads, so the conversion needs no registers beside the rows'; done
// in registers it spilled 72-80 bytes at 512/256): f32, bf16 at "default",
// at "high" each element's two bf16 halves packed into the 32-bit register
// that holds it (the same 64 registers a thread). The split source brings
// Ghi and Glo into the prefetch buffer (the same bytes as the f32 rows) and
// packs them as it loads them.
// A stays f32 at "high", since the check products read it in FP32, and is
// split at use in the iteration's A xx; at "default" it is bf16, which is
// all any product reads. The exchanges carry the operand form: t and xx at
// "highest", bf16(t) and bf16(xx) at "default", and at "high" each
// element's (vh, vl) pair interleaved, split by the sender once an
// iteration (as the streaming kernel splits them into shared memory), so a
// receiver reads the pairs straight into its dots (at "high" a warp's rows
// advance together chunk by chunk, reg_dots, so a chunk's pairs are read
// once); the x update reads the f32 xx the warp computed.
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
// epilogue gathers x and y (their bf16 roundings at "default") into every
// CTA (one cluster barrier), takes A x from the register rows and A'y from
// the CTA's n/8 columns of A.
//
// Bits: every row dot keeps rows_dot's lane mapping and sum order (lane l
// sums the float4s l, l + 32, ..., one FMA an element, three at "high" in
// fma3's order, then the shuffle tree) over the operands rows_dot<P> forms,
// the updates are the streaming kernel's expressions with its FMA
// contractions (relax; 1/rho once a lane, the same quotient), and A'y keeps
// cols_dot's order at the streaming kernel's 256 threads: column c sums the
// rows r = g, g + G, ... in groups g < G = 256 / (n/4), then 0 + group 0 +
// group 1 + .... So all seven outputs equal admm_chunk_kernel<P, SPLIT>'s
// bit for bit. Shapes: n, m multiples of 128 with (n/128)(m/128) <= 8 and
// both <= 512 (the register budget); ops/fused_admm.py: chunk_kernel sends
// every other shape to the streaming kernel.

#include "cluster.cuh"

using qps::i64;
using qps::Prec;
using namespace qps::cluster;

namespace {
constexpr int STREAM_THREADS = 256;  // admm_chunk.cu's THREADS (cols_dot's order)

// cols_dot's row groups at the streaming kernel's thread count (n <= 512,
// so n/4 < 256 and every column is summed in groups).
__host__ __device__ constexpr int aty_groups(int n) { return STREAM_THREADS / (n / 4); }

// Floats of shared memory a CTA needs at precision P: 4 mbarriers (16
// floats), the next lane's G and A rows and this lane's A columns, t and xx
// twice in their exchange form (two floats an element at "high"), the x
// and y gathers twice, the CTA's vector rows and A'y's partial sums: at
// 512/256, 211,136 bytes at "highest" and "default", 217,280 at "high"
// (from any G source).
template <Prec P>
__host__ __device__ constexpr int cluster_floats(int n, int m) {
  return 16 + 3 * (n / C) * m + 2 * operand_width<P>() * (m + n) + 2 * (m + n) +
         3 * (n / C) + 7 * (m / C) + aty_groups(n) * (n / C);
}

// al * v + al1 * prev as the streaming kernel's compiler contracts it:
// the product with prev is the fused one (fma(al1, prev, al * v)). Written
// out, since which of two products nvcc fuses follows the order in which
// their operands were computed, and here v comes from a warp's shuffles.
__device__ __forceinline__ float relax(float al, float v, float al1, float prev) {
  return __fmaf_rn(al1, prev, __fmul_rn(al, v));
}
}  // namespace

// P: the precision; SPLIT: G arrives as its bf16 halves Ghi, Glo (P must be
// kHigh). NB = n / 128 (G rows a warp, float4s an A row a lane), MB = m /
// 128 (A rows a warp, float4s a G row a lane).
template <Prec P, bool SPLIT, int NB, int MB>
__global__ void __launch_bounds__(THREADS, 1)
admm_chunk_cluster_kernel(const float* __restrict__ G,
                          const unsigned short* __restrict__ Ghi,
                          const unsigned short* __restrict__ Glo, int ldG,
                          const float* __restrict__ A, const float* __restrict__ g,
                          const float* __restrict__ l, const float* __restrict__ u,
                          const float* __restrict__ rho, const float* __restrict__ x_in,
                          const float* __restrict__ z_in, const float* __restrict__ y_in,
                          const int* __restrict__ active, float* __restrict__ xo,
                          float* __restrict__ zo, float* __restrict__ yo,
                          float* __restrict__ xpo, float* __restrict__ zpo,
                          float* __restrict__ Axo, float* __restrict__ ATyo, int B,
                          int K, float alpha) {
  static_assert(!SPLIT || P == Prec::kHigh, "split halves are bf16x3 operands");
  constexpr int n = 128 * NB, m = 128 * MB, nr = n / C, mr = m / C;
  constexpr int V = operand_width<P>();  // floats an exchanged element
  constexpr int groups = aty_groups(n);
  constexpr bool DEF = P == Prec::kDefault;  // the check products at one bf16 pass
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = static_cast<int>(__clusterRelativeBlockRank());
  const int cid = static_cast<int>(__clusterIdx().x);
  const int ncl = static_cast<int>(__clusterGridDimInClusters().x);
  const int i0 = rank * nr, r0 = rank * mr;

  float* PG = sm + 16;        // nr x m: the next lane's G rows i0.. (SPLIT: hi, then lo)
  float* PA = PG + nr * m;    // mr x n: the next lane's A rows r0..
  float* AC = PA + mr * n;    // m x nr: this lane's A columns i0..
  float* tv = AC + m * nr;    // 2 x V m: t's exchange form, by iteration parity
  float* xv = tv + 2 * V * m; // 2 x V n: xx's exchange form, by iteration parity
  float* yg = xv + 2 * V * n; // 2 x m: y (bf16(y) at "default") gathered, by lane parity
  float* xg = yg + 2 * m;     // 2 x n: x (bf16(x) at "default") gathered, by lane parity
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
  // The next lane's G rows into PG: f32 rows of pitch ldG, or the halves.
  auto load_G = [&](int b) {
    if constexpr (SPLIT) {
      const i64 off = ((i64)b * n + i0) * m;
      load_rows(PG, reinterpret_cast<const float*>(Ghi + off), m / 2, nr, m / 2);
      load_rows(PG + nr * m / 2, reinterpret_cast<const float*>(Glo + off), m / 2, nr,
                m / 2);
    } else {
      load_rows(PG, G + (i64)b * n * ldG + (i64)i0 * ldG, ldG, nr, m);
    }
  };
  // mbarriers: t of parity 0 and 1, then xx of parity 0 and 1.
  const unsigned mb = smem_u32(sm);
  if (tid == 0) {
    for (int q = 0; q < 4; ++q) mbar_init(mb + 8 * q);
    for (int q = 0; q < 4; ++q) mbar_expect(mb + 8 * q, (q < 2 ? m : n) * V * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA of the cluster must have started (and armed its mbarriers)
  // before another sends to it: arrive now, wait before the first send.
  cluster_arrive();
  if (cid < B) {
    load_G(cid);
    load_rows(PA, A + (i64)cid * m * n + (i64)r0 * n, n, mr, n);
  }
  cp_async_commit();
  // This lane's (lane < C) destination CTA: the addresses it sends to.
  const int dst = lane < C ? lane : 0;
  const unsigned tv_d = mapa(smem_u32(tv), dst), xv_d = mapa(smem_u32(xv), dst);
  const unsigned mb_d = mapa(mb, dst);
  cluster_wait();

  // G in its operand form; A f32 (bf16 at "default").
  float4 gr[NB][MB], ar[MB][NB];
  unsigned phase_t[2] = {0, 0}, phase_x[2] = {0, 0};
  const float al = alpha, al1 = 1.0f - alpha;
  for (int b = cid, lp = 0; b < B; b += ncl, lp ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // lane b's rows are in PG, PA
    if constexpr (SPLIT) {
      const unsigned short* PGh = reinterpret_cast<const unsigned short*>(PG);
      const unsigned short* PGl = PGh + nr * m;
#pragma unroll
      for (int q = 0; q < NB; ++q)
#pragma unroll
        for (int k = 0; k < MB; ++k) {
          const int row = warp * NB + q, c4 = lane + 32 * k;
          gr[q][k] = pack_split(reinterpret_cast<const uint2*>(PGh + row * m)[c4],
                                reinterpret_cast<const uint2*>(PGl + row * m)[c4]);
        }
    } else {
      load_reg_rows<P>(gr, PG, m, warp * NB, lane);
    }
    load_reg_rows<DEF ? Prec::kDefault : Prec::kHighest>(ar, PA, n, warp * MB, lane);
    __syncthreads();  // PG, PA read: refill them behind the iterations
    const float* Ab = A + (i64)b * m * n;
    load_rows(AC, Ab + i0, n, m, nr);
    cp_async_commit();
    if (b + ncl < B) {
      load_G(b + ncl);
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
        float op[V];
        operand_pairs<P>(t0, op);
        send(mapa(smem_u32(tv + V * (r0 + r)), to), op, mapa(mb, to));
      }
      for (int it = 0; it < K; ++it) {
        const int p = it & 1;
        // 1. Once t is whole: xx and the x update for the warp's NB rows of
        //    i0.., xx sent to every CTA in one store (lane k of the warp to
        //    CTA k; two at "high").
        mbar_wait(mb + 8 * p, phase_t[p]);
        phase_t[p] ^= 1;
        if (tid == 0) mbar_expect(mb + 8 * p, m * V * 4);
        float xs[NB];
        reg_dots<P>(gr, tv + p * V * m, lane, xs);
#pragma unroll
        for (int q = 0; q < NB; ++q) xs[q] -= gv[warp * NB + q];
        if (lane < C) {
          float op[NB * V];
          operand_pairs<P>(xs, op);
          send(xv_d + 4 * V * (p * n + i0 + warp * NB), op, mb_d + 8 * (2 + p));
        }
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < NB; ++q) {
            const int i = warp * NB + q;
            const float xprev = x[i];
            xp[i] = xprev;
            x[i] = relax(al, xs[q], al1, xprev);
          }
        }
        // 2. Once xx is whole: zz, z, y and the next t for rows r0...
        mbar_wait(mb + 8 * (2 + p), phase_x[p]);
        phase_x[p] ^= 1;
        if (tid == 0) mbar_expect(mb + 8 * (2 + p), n * V * 4);
        float ts[MB], zz[MB];
        reg_dots<P, true>(ar, xv + p * V * n, lane, zz);
#pragma unroll
        for (int q = 0; q < MB; ++q) {
          const int r = warp * MB + q;
          const float s = zz[q];
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
        if (it + 1 < K && lane < C) {
          float op[MB * V];
          operand_pairs<P>(ts, op);
          send(tv_d + 4 * V * ((p ^ 1) * m + r0 + warp * MB), op, mb_d + 8 * (p ^ 1));
        }
        // No warp may fall a phase behind on an mbarrier (a phase can only
        // complete again after every warp here has sent its share).
        __syncthreads();
      }
    }

    // Epilogue: this CTA's rows of the iterate; x and y (the check
    // products' operands) into every CTA.
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
      *d = DEF ? qps::bf16r(x[i]) : x[i];
    }
    for (int e = tid; e < mr * C; e += THREADS) {
      const int r = e % mr;
      float* d = static_cast<float*>(__cluster_map_shared_rank(ygl + r0 + r, e / mr));
      *d = DEF ? qps::bf16r(y[r]) : y[r];
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
      for (int r = grp; r < m; r += groups) {
        const float a = AC[r * nr + c];
        acc = fmaf(DEF ? qps::bf16r(a) : a, ygl[r], acc);
      }
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
template <Prec P, int NB, int MB>
constexpr int smem_bytes() {
  constexpr int bytes = cluster_floats<P>(128 * NB, 128 * MB) * (int)sizeof(float);
  static_assert(bytes <= (int)MAX_SMEM, "a CTA's shared memory");
  return bytes;
}

// The launch arguments after the template parameters.
struct Args {
  const float* G;
  const unsigned short *Ghi, *Glo;
  int ldG;
  const float *A, *g, *l, *u, *rho, *x, *z, *y;
  const int* active;
  float *xo, *zo, *yo, *xpo, *zpo, *Axo, *ATyo;
  int B, K;
  float alpha;
};

template <Prec P, bool SPLIT>
struct Variant {
  template <int NB, int MB>
  static cudaError_t resident_nm(int* out) {
    return resident(admm_chunk_cluster_kernel<P, SPLIT, NB, MB>, smem_bytes<P, NB, MB>(),
                    out);
  }

  template <int NB, int MB>
  static cudaError_t launch(const Args& a, cudaStream_t s) {
    return launch_persistent(admm_chunk_cluster_kernel<P, SPLIT, NB, MB>,
                             smem_bytes<P, NB, MB>(), a.B, s, a.G, a.Ghi, a.Glo, a.ldG,
                             a.A, a.g, a.l, a.u, a.rho, a.x, a.z, a.y, a.active, a.xo,
                             a.zo, a.yo, a.xpo, a.zpo, a.Axo, a.ATyo, a.B, a.K, a.alpha);
  }

  static cudaError_t launch_for(int n, int m, const Args& a, cudaStream_t s) {
    QPS_CLUSTER_DISPATCH(launch, n, m, a, s)
  }

  static cudaError_t resident_for(int n, int m, int* out) {
    QPS_CLUSTER_DISPATCH(resident_nm, n, m, out)
  }
};

// Calls Variant<P, SPLIT>::F(args...) for prec (0 highest, 1 high, 2
// default) and split; cudaErrorInvalidValue for a split G at another
// precision than "high", or another prec.
#define QPS_ADMM_VARIANT(F, prec, split, ...)                                   \
  if (split) {                                                                 \
    if ((prec) != 1) return cudaErrorInvalidValue;                             \
    return Variant<Prec::kHigh, true>::F(__VA_ARGS__);                         \
  }                                                                            \
  switch (prec) {                                                              \
    case 0: return Variant<Prec::kHighest, false>::F(__VA_ARGS__);             \
    case 1: return Variant<Prec::kHigh, false>::F(__VA_ARGS__);                \
    case 2: return Variant<Prec::kDefault, false>::F(__VA_ARGS__);             \
    default: return cudaErrorInvalidValue;                                     \
  }

cudaError_t launch_variant(int prec, bool split, int n, int m, const Args& a,
                           cudaStream_t s) {
  QPS_ADMM_VARIANT(launch_for, prec, split, n, m, a, s)
}

cudaError_t resident_variant(int prec, bool split, int n, int m, int* out) {
  QPS_ADMM_VARIANT(resident_for, prec, split, n, m, out)
}
}  // namespace

// G: f32 rows of pitch ldG (m for a contiguous (B, n, m) G, kp + n for the
// slab window), lane stride n * ldG; or, with Ghi != null, the bf16 halves
// Ghi, Glo (B, n, m) and G unused (prec must be 1, "high"). A (B, m, n),
// g/x (B, n), l/u/rho/z/y (B, m) contiguous f32, 16-byte aligned; active
// (B,) int32. n and m multiples of 128, at most 512, with (n/128)(m/128)
// <= 8 (cudaErrorInvalidValue otherwise); ldG % 4 == 0, K >= 1; prec 0 =
// highest, 1 = high, 2 = default.
extern "C" int qps_admm_chunk_cluster(const float* G, const void* Ghi, const void* Glo,
                                      const float* A, const float* g,
                                      const float* l, const float* u,
                                      const float* rho, const float* x,
                                      const float* z, const float* y,
                                      const int* active, float* xo, float* zo,
                                      float* yo, float* xpo, float* zpo, float* Axo,
                                      float* ATyo, int B, int n, int m, int ldG,
                                      int K, int prec, float alpha, void* stream) {
  const bool split = Ghi != nullptr;
  if (split) ldG = m;
  if (K < 1 || B < 1 || ldG % 4 || ldG < m) return (int)cudaErrorInvalidValue;
  const Args a = {G, static_cast<const unsigned short*>(Ghi),
                  static_cast<const unsigned short*>(Glo), ldG, A, g, l, u, rho, x, z,
                  y, active, xo, zo, yo, xpo, zpo, Axo, ATyo, B, K, alpha};
  cudaError_t e = launch_variant(prec, split, n, m, a, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of qps_admm_chunk_cluster at (n, m) and prec (the split
// source holds what "high" holds) the card holds at once
// (cudaOccupancyMaxActiveClusters): the lanes in flight. Into *out.
extern "C" int qps_admm_chunk_cluster_occupancy(int n, int m, int prec, int* out) {
  return (int)resident_variant(prec, false, n, m, out);
}
