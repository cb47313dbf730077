// Sigma-free prox-ALM chunk with each lane's G, A and C held on chip by a
// thread-block cluster, at every product precision.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_proxqp.py:
// _chunk_kernel, sigma-free branch, at dot_precision "highest", "high"
// (bf16x3 at :114, 122-131, 160-161: G t, C x and A x all three-pass, no
// FP32 product left) and "default" (one bf16 pass, :82-91, 106), at every
// `lanes` (JAX interleaves L lanes for the MXU; the outputs do not depend
// on L, and each lane runs in a cluster of its own here, so `lanes` changes
// no kernel). prox_chunk.cu's prox_chunk_kernel<P> runs the same variants
// by streaming the matrices (the shapes that do not fit a cluster, and this
// kernel's witness). Per lane and iteration, with G = [Ga | Gc]
// (n x (me + mi)) and the stacked rows [A; C] ((me + mi) x n):
//
//   t_a = rho*b - y,   t_c = rho*(d - s) - z
//   x   = G [t_a; t_c] - g
//   s   = max(d - C x - (1/rho)*z, 0)
//   y   = y + rho*(A x - b)
//   z   = max(z + rho*(C x - d + s), 0)
//
// with the same outputs (x, s, y, z) and frozen lanes (active == 0: the
// inputs pass through).
//
// What bounds it on the H100: the streaming kernel reads G, A and C (1 MB a
// lane at n=512, me = mi = 128) from device memory every iteration. This is
// admm_chunk_cluster.cu's design with G's n rows of width mt = me + mi in
// place of the ADMM G and the stacked rows of [A; C] in place of A: a
// cluster of 8 CTAs of 512 threads holds one lane in registers. CTA r keeps
// rows [r n/8, (r+1) n/8) of G and [r mt/8, (r+1) mt/8) of [A; C], warp w
// of it n/128 of those G rows and mt/128 of those stacked rows, each lane
// the 16-byte pieces rows_dot gives it (8 (n/128)(mt/128) 32-bit words a
// thread, 64 at 512/256), and owns those rows of x, g and of y, b (an A
// row) or z, s, d (a C row). A stacked row's kind follows its index (A
// below me), so a CTA or a warp may hold both kinds; a warp walks its rows
// one at a time, so each row's branch is uniform over the warp. An
// iteration is then:
//
//   1. G rows: x_i = G_i . t - g_i for the CTA's rows, x's operand form
//      sent into every CTA's copy of x (st.async into distributed shared
//      memory, counted by the receiver's mbarrier; a warp's n/128 rows in
//      one store a CTA, two at "high");
//   2. once its mbarrier has all of x: the stacked rows r: Cx_r or Ax_r,
//      the s, z (C) or y (A) update of the row, and the next iteration's
//      t_r, its operand form sent into every CTA's copy of t.
//
// The precisions (common.cuh: Prec; cluster.cuh: operand forms). No product
// reads a matrix in FP32 below "highest", so G and [A; C] both take their
// operand form once a lane, in the prefetch buffer just before their rows
// move into registers (load_reg_rows; converted in registers, "high"
// spilled 248-312 bytes at 512/128/128): bf16 at "default", at "high" each
// element's two bf16 halves packed into the 32-bit register that holds it
// (the same 64 registers a thread). The
// exchanges carry t's and x's operand forms (bf16 at "default", the
// interleaved (vh, vl) pairs at "high", split by the sender once an
// iteration as the streaming kernel splits them into shared memory); below
// "highest" each CTA keeps its rows of the f32 x for the output.
//
// t and x are double-buffered with their mbarriers, as in the ADMM cluster
// chunk: a sender reaches a buffer again only after every CTA has sent it
// the data that followed the buffer's last read. The clusters are
// persistent and walk the lanes; while one lane iterates, cp.async brings
// the next lane's G and [A; C] rows into shared memory (n mt / 4 floats a
// CTA, 128 KB at 512/256). No output needs another CTA's rows (the
// prox chunk emits no check products), so a lane ends without a cluster
// barrier: a CTA cannot send the next lane's x before every CTA has sent
// that lane's first t, which each sends after its last read of this lane's
// buffers.
//
// Bits: every row dot keeps rows_dot's lane mapping and sum order (lane l
// sums the float4s l, l + 32, ..., one FMA an element, three at "high" in
// fma3's order, then the shuffle tree) over the operands rows_dot<P> forms,
// the updates are the streaming kernel's expressions with the FMA
// contractions nvcc gives them there (each has one product, fused with its
// sum; written out below), and 1/rho is the same quotient. So x, s, y and
// z equal prox_chunk_kernel<P>'s bit for bit. Shapes: n and me + mi
// multiples of 128, both at most 512, with (n/128)((me+mi)/128) <= 8 (the
// register budget); me and mi multiples of 4; ops/fused_proxqp.py:
// chunk_kernel sends every other shape to the streaming kernel.

#include "cluster.cuh"

using qps::i64;
using qps::Prec;
using namespace qps::cluster;

namespace {
// Floats of shared memory a CTA needs at precision P: 4 mbarriers (16
// floats), the next lane's G rows and stacked rows, t and x twice in their
// exchange form (two floats an element at "high"), the CTA's g rows (and,
// below "highest", its rows of the f32 x) and its three vectors of stacked
// rows (y or z; b or d; s): at n=512, me = mi = 128, 137,920 bytes at
// "highest", 138,176 at "default", 144,320 at "high".
template <Prec P>
__host__ __device__ constexpr int prox_cluster_floats(int n, int mt) {
  return 16 + (n / C) * mt + (mt / C) * n + 2 * operand_width<P>() * (mt + n) +
         (P == Prec::kHighest ? 1 : 2) * (n / C) + 3 * (mt / C);
}

// The stacked row r of lane b: A's row r below me, C's row r - me above.
__device__ __forceinline__ const float* stacked_row(const float* A, const float* Cm,
                                                    int b, int r, int n, int me, int mi) {
  return r < me ? A + ((i64)b * me + r) * n : Cm + ((i64)b * mi + (r - me)) * n;
}

// cp.async of lane b's stacked rows r0 .. r0 + rows (width n) into dst.
__device__ __forceinline__ void load_stacked(float* dst, const float* A, const float* Cm,
                                             int b, int r0, int rows, int n, int me,
                                             int mi) {
  const int c4n = n / 4;
  for (int e = threadIdx.x; e < rows * c4n; e += THREADS) {
    const int r = e / c4n, c4 = e - r * c4n;
    cp_async16(dst + (i64)r * n + 4 * c4,
               stacked_row(A, Cm, b, r0 + r, n, me, mi) + 4 * c4);
  }
}
}  // namespace

// P: the precision. NB = n / 128 (G rows a warp, float4s a stacked row a
// lane), MB = mt / 128 (stacked rows a warp, float4s a G row a lane).
template <Prec P, int NB, int MB>
__global__ void __launch_bounds__(THREADS, 1)
prox_chunk_cluster_kernel(const float* __restrict__ G, const float* __restrict__ A,
                          const float* __restrict__ Cm, const float* __restrict__ g,
                          const float* __restrict__ bvec, const float* __restrict__ dvec,
                          const float* __restrict__ rho, const float* __restrict__ x_in,
                          const float* __restrict__ s_in, const float* __restrict__ y_in,
                          const float* __restrict__ z_in, const int* __restrict__ active,
                          float* __restrict__ xo, float* __restrict__ so,
                          float* __restrict__ yo, float* __restrict__ zo, int B, int me,
                          int K) {
  constexpr int n = 128 * NB, mt = 128 * MB, nr = n / C, mr = mt / C;
  constexpr int V = operand_width<P>();  // floats an exchanged element
  constexpr bool F32 = P == Prec::kHighest;  // the exchanged x is the output x
  const int mi = mt - me;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = static_cast<int>(__clusterRelativeBlockRank());
  const int cid = static_cast<int>(__clusterIdx().x);
  const int ncl = static_cast<int>(__clusterGridDimInClusters().x);
  const int i0 = rank * nr, r0 = rank * mr;

  float* PG = sm + 16;          // nr x mt: the next lane's G rows i0..
  float* PS = PG + nr * mt;     // mr x n: the next lane's stacked rows r0..
  float* tv = PS + mr * n;      // 2 x V mt: t's exchange form, by iteration parity
  float* xv = tv + 2 * V * mt;  // 2 x V n: x's exchange form, by iteration parity
  float* gv = xv + 2 * V * n;   // nr: g of rows i0..
  float* xf = gv + nr;          // nr below "highest": the f32 x of rows i0..
  float* wv = xf + (F32 ? 0 : nr);  // mr each, rows r0..: y (A) or z (C),
  float* wb = wv + mr;          //   b (A) or d (C),
  float* ws = wb + mr;          //   s (C)
  // mbarriers: t of parity 0 and 1, then x of parity 0 and 1.
  const unsigned mb = smem_u32(sm);
  if (tid == 0) {
    for (int q = 0; q < 4; ++q) mbar_init(mb + 8 * q);
    for (int q = 0; q < 4; ++q) mbar_expect(mb + 8 * q, (q < 2 ? mt : n) * V * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA of the cluster must have started (and armed its mbarriers)
  // before another sends to it: arrive now, wait before the first send.
  cluster_arrive();
  if (cid < B) {
    load_rows(PG, G + ((i64)cid * n + i0) * mt, mt, nr, mt);
    load_stacked(PS, A, Cm, cid, r0, mr, n, me, mi);
  }
  cp_async_commit();
  // This lane's (lane < C) destination CTA: the addresses it sends to.
  const int dst = lane < C ? lane : 0;
  const unsigned tv_d = mapa(smem_u32(tv), dst), xv_d = mapa(smem_u32(xv), dst);
  const unsigned mb_d = mapa(mb, dst);
  cluster_wait();

  // G and the stacked rows in their operand form.
  float4 gr[NB][MB], ar[MB][NB];
  unsigned phase_t[2] = {0, 0}, phase_x[2] = {0, 0};
  for (int b = cid; b < B; b += ncl) {
    cp_async_wait<0>();
    __syncthreads();  // lane b's rows are in PG, PS
    load_reg_rows<P>(gr, PG, mt, warp * NB, lane);
    load_reg_rows<P>(ar, PS, n, warp * MB, lane);
    __syncthreads();  // PG, PS read: refill them behind the iterations
    if (b + ncl < B) {
      load_rows(PG, G + ((i64)(b + ncl) * n + i0) * mt, mt, nr, mt);
      load_stacked(PS, A, Cm, b + ncl, r0, mr, n, me, mi);
    }
    cp_async_commit();
    for (int i = tid; i < nr; i += THREADS) gv[i] = g[(i64)b * n + i0 + i];
    for (int j = tid; j < mr; j += THREADS) {
      const int r = r0 + j;
      if (r < me) {
        wv[j] = y_in[(i64)b * me + r];
        wb[j] = bvec[(i64)b * me + r];
      } else {
        const i64 k = (i64)b * mi + (r - me);
        wv[j] = z_in[k];
        wb[j] = dvec[k];
        ws[j] = s_in[k];
      }
    }
    const float rr = rho[b];
    const float rinv = 1.0f / rr;
    const bool act = active[b] != 0;  // uniform over the cluster
    __syncthreads();

    int last = 0;  // the parity of the last iteration's x
    if (act) {
      // The first t, into every CTA's parity-0 copy.
      for (int e = tid; e < mr * C; e += THREADS) {
        const int j = e % mr, to = e / mr;
        const float t0[1] = {r0 + j < me ? __fmaf_rn(rr, wb[j], -wv[j])
                                         : __fmaf_rn(rr, wb[j] - ws[j], -wv[j])};
        float op[V];
        operand_pairs<P>(t0, op);
        send(mapa(smem_u32(tv + V * (r0 + j)), to), op, mapa(mb, to));
      }
      for (int it = 0; it < K; ++it) {
        const int p = it & 1;
        // 1. Once t is whole: x for the warp's NB rows of i0.., sent to
        //    every CTA in one store (lane k of the warp to CTA k; two at
        //    "high").
        mbar_wait(mb + 8 * p, phase_t[p]);
        phase_t[p] ^= 1;
        if (tid == 0) mbar_expect(mb + 8 * p, mt * V * 4);
        float xs[NB];
        reg_dots<P>(gr, tv + p * V * mt, lane, xs);
#pragma unroll
        for (int q = 0; q < NB; ++q) xs[q] -= gv[warp * NB + q];
        if (lane < C) {
          float op[NB * V];
          operand_pairs<P>(xs, op);
          send(xv_d + 4 * V * (p * n + i0 + warp * NB), op, mb_d + 8 * (2 + p));
        }
        if (!F32 && lane == 0) {
#pragma unroll
          for (int q = 0; q < NB; ++q) xf[warp * NB + q] = xs[q];
        }
        // 2. Once x is whole: Cx or Ax, the row's update and the next t
        //    for rows r0...
        mbar_wait(mb + 8 * (2 + p), phase_x[p]);
        phase_x[p] ^= 1;
        if (tid == 0) mbar_expect(mb + 8 * (2 + p), n * V * 4);
        float ts[MB], dots[MB];
        reg_dots<P>(ar, xv + p * V * n, lane, dots);
#pragma unroll
        for (int q = 0; q < MB; ++q) {
          const int j = warp * MB + q;
          const float dot = dots[q];
          const float wj = wv[j], bj = wb[j];
          if (r0 + j < me) {
            const float yn = __fmaf_rn(rr, dot - bj, wj);
            __syncwarp();
            if (lane == 0) wv[j] = yn;
            ts[q] = __fmaf_rn(rr, bj, -yn);
          } else {
            const float sn = fmaxf(__fmaf_rn(-rinv, wj, bj - dot), 0.0f);
            const float zn = fmaxf(__fmaf_rn(rr, dot - bj + sn, wj), 0.0f);
            __syncwarp();
            if (lane == 0) {
              wv[j] = zn;
              ws[j] = sn;
            }
            ts[q] = __fmaf_rn(rr, bj - sn, -zn);
          }
        }
        if (it + 1 < K && lane < C) {
          float op[MB * V];
          operand_pairs<P>(ts, op);
          send(tv_d + 4 * V * ((p ^ 1) * mt + r0 + warp * MB), op, mb_d + 8 * (p ^ 1));
        }
        // No warp may fall a phase behind on an mbarrier (a phase can only
        // complete again after every warp here has sent its share).
        __syncthreads();
      }
      last = (K - 1) & 1;
    }

    // This CTA's rows of the iterate.
    for (int i = tid; i < nr; i += THREADS) {
      const i64 k = (i64)b * n + i0 + i;
      xo[k] = act ? (F32 ? xv[last * n + i0 + i] : xf[i]) : x_in[k];
    }
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
  }
  // No CTA may exit while another can still send to it.
  cluster_sync();
}

namespace {
template <Prec P, int NB, int MB>
constexpr int smem_bytes() {
  constexpr int bytes = prox_cluster_floats<P>(128 * NB, 128 * MB) * (int)sizeof(float);
  static_assert(bytes <= (int)MAX_SMEM, "a CTA's shared memory");
  return bytes;
}

// The launch arguments after the template parameters.
struct Args {
  const float *G, *A, *Cm, *g, *b, *d, *rho, *x, *s, *y, *z;
  const int* active;
  float *xo, *so, *yo, *zo;
  int B, me, K;
};

template <Prec P>
struct Variant {
  template <int NB, int MB>
  static cudaError_t resident_nm(int* out) {
    return resident(prox_chunk_cluster_kernel<P, NB, MB>, smem_bytes<P, NB, MB>(), out);
  }

  template <int NB, int MB>
  static cudaError_t launch(const Args& a, cudaStream_t st) {
    return launch_persistent(prox_chunk_cluster_kernel<P, NB, MB>, smem_bytes<P, NB, MB>(),
                             a.B, st, a.G, a.A, a.Cm, a.g, a.b, a.d, a.rho, a.x, a.s, a.y,
                             a.z, a.active, a.xo, a.so, a.yo, a.zo, a.B, a.me, a.K);
  }

  static cudaError_t launch_for(int n, int mt, const Args& a, cudaStream_t st) {
    QPS_CLUSTER_DISPATCH(launch, n, mt, a, st)
  }

  static cudaError_t resident_for(int n, int mt, int* out) {
    QPS_CLUSTER_DISPATCH(resident_nm, n, mt, out)
  }
};

// Calls Variant<P>::F(args...) for prec 0 (highest), 1 (high), 2
// (default); cudaErrorInvalidValue for another.
#define QPS_PROX_VARIANT(F, prec, ...)                              \
  switch (prec) {                                                   \
    case 0: return Variant<Prec::kHighest>::F(__VA_ARGS__);         \
    case 1: return Variant<Prec::kHigh>::F(__VA_ARGS__);            \
    case 2: return Variant<Prec::kDefault>::F(__VA_ARGS__);         \
    default: return cudaErrorInvalidValue;                          \
  }

cudaError_t launch_variant(int prec, int n, int mt, const Args& a, cudaStream_t st) {
  QPS_PROX_VARIANT(launch_for, prec, n, mt, a, st)
}

cudaError_t resident_variant(int prec, int n, int mt, int* out) {
  QPS_PROX_VARIANT(resident_for, prec, n, mt, out)
}
}  // namespace

// Contiguous f32, 16-byte aligned: G (B, n, me + mi), A (B, me, n),
// C (B, mi, n), g/x (B, n), b/y (B, me), d/s/z (B, mi), rho (B,); active
// (B,) int32. n and me + mi multiples of 128, at most 512, with
// (n/128)((me+mi)/128) <= 8, me and mi multiples of 4 (cudaErrorInvalidValue
// otherwise); K >= 1; prec 0 = highest, 1 = high, 2 = default.
extern "C" int qps_prox_chunk_cluster(const float* G, const float* A, const float* Cm,
                                      const float* g, const float* b, const float* d,
                                      const float* rho, const float* x, const float* s,
                                      const float* y, const float* z, const int* active,
                                      float* xo, float* so, float* yo, float* zo, int B,
                                      int n, int me, int mi, int K, int prec,
                                      void* stream) {
  if (K < 1 || B < 1 || me < 0 || mi < 0 || me % 4 || mi % 4)
    return (int)cudaErrorInvalidValue;
  const Args a = {G, A, Cm, g, b, d, rho, x, s, y, z, active, xo, so, yo, zo, B, me, K};
  cudaError_t e =
      launch_variant(prec, n, me + mi, a, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of qps_prox_chunk_cluster at (n, me + mi) and prec the card
// holds at once (cudaOccupancyMaxActiveClusters): the lanes in flight. Into
// *out.
extern "C" int qps_prox_chunk_cluster_occupancy(int n, int mt, int prec, int* out) {
  return (int)resident_variant(prec, n, mt, out);
}
