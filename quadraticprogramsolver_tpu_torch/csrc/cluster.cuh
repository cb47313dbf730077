// Shared pieces of the four cluster chunks (the sigma-free
// admm_chunk_cluster.cu, prox_chunk_cluster.cu and the M^{-1}-form
// admm_chunk_minv_cluster.cu, prox_chunk_minv_cluster.cu): one lane per
// thread-block cluster of 8 CTAs, its matrices held in registers (and, in
// the M^{-1} form, shared memory), vectors exchanged between the CTAs with
// st.async into distributed shared memory and counted by the receiver's
// mbarrier, matrix rows brought into shared memory by cp.async; the row dots
// in rows_dot's order (reg_dot, smem_dot; at the sigma-free chunks' bf16
// precisions reg_dots over the operand forms of common.cuh's Prec) and the
// A' products in cols_dot's at the streaming chunks' 256 threads
// (col_chains, col_sum).

#pragma once

#include "common.cuh"

namespace qps {
namespace cluster {

constexpr int C = 8;                 // CTAs a cluster (a lane), the portable size
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a CTA can have

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
// store for W = 2 or 4 (a aligned to it), two 16-byte stores for W = 8 (a
// 16-byte aligned), three 8-byte ones for W = 6 (a 8-byte aligned), else W
// 4-byte stores.
template <int W>
__device__ __forceinline__ void send(unsigned a, const float (&v)[W], unsigned bar) {
  if constexpr (W == 8 || W == 6) {  // bf16x3 operand pairs: 2 v4 or 3 v2
    constexpr int S = W == 8 ? 4 : 2;
#pragma unroll
    for (int q = 0; q < W / S; ++q) {
      float part[S];
#pragma unroll
      for (int e = 0; e < S; ++e) part[e] = v[q * S + e];
      send(a + 4 * S * q, part, bar);
    }
  } else if constexpr (W == 4) {
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Copies rows x cols floats (cols % 4 == 0) from global (row pitch ld) to
// shared memory (row pitch cols) with 16-byte cp.async, all THREADS threads
// (the caller commits the group).
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
  return warp_sum(s);
}

// The sigma-free cluster chunks' operand forms at precision P (common.cuh:
// Prec). A matrix row held in registers is, element for element, the f32
// value at kHighest, its bf16 rounding at kDefault, and at kHigh its two
// bf16 halves packed into one 32-bit word (the high half's bits in the low
// 16, the low half's in the high 16: __nv_bfloat162 order), split once a
// lane as the row moves into registers. A vector in an exchange buffer is
// likewise v, bf16(v), or at kHigh the interleaved pair (vh, vl) of each
// element (2 floats an element), written by its sender (operand_pairs).
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// a's packed halves: ah = bf16(a), al = bf16(a - ah) (split_store's).
__device__ __forceinline__ float pack_halves(float a) {
  const float h = bf16r(a);
  return __uint_as_float(bf16_bits(h) | (bf16_bits(a - h) << 16));
}

// The register form at precision P of four f32 matrix elements.
template <Prec P>
__device__ __forceinline__ float4 row_operand(float4 a) {
  if constexpr (P == Prec::kHighest) {
    return a;
  } else if constexpr (P == Prec::kDefault) {
    return make_float4(bf16r(a.x), bf16r(a.y), bf16r(a.z), bf16r(a.w));
  } else {
    return make_float4(pack_halves(a.x), pack_halves(a.y), pack_halves(a.z),
                       pack_halves(a.w));
  }
}

// A warp's R register rows in their operand form at P: row r's float4s
// lane + 32 k at base + (row0 + r) * pitch (shared memory). Below
// kHighest the elements are converted in place first, each by the thread
// that then reads it back, so no other thread is involved; the compiler
// barrier between makes the rows come back from shared memory, and the
// conversion's temporaries do not compete with the rows for registers.
template <Prec P, int R, int KW>
__device__ __forceinline__ void load_reg_rows(float4 (&rows)[R][KW], float* base,
                                              int pitch, int row0, int lane) {
  if constexpr (P != Prec::kHighest) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        float4* e = reinterpret_cast<float4*>(base + (row0 + r) * pitch) + lane + 32 * k;
        *e = row_operand<P>(*e);
      }
    asm volatile("" ::: "memory");
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < KW; ++k)
      rows[r][k] = reinterpret_cast<const float4*>(base + (row0 + r) * pitch)[lane + 32 * k];
}

// The packed form of four elements that arrive split: h and l hold four
// bf16 high and low halves each (element 0 in the low bits).
__device__ __forceinline__ float4 pack_split(uint2 h, uint2 l) {
  return make_float4(__uint_as_float(__byte_perm(h.x, l.x, 0x5410)),
                     __uint_as_float(__byte_perm(h.x, l.x, 0x7632)),
                     __uint_as_float(__byte_perm(h.y, l.y, 0x5410)),
                     __uint_as_float(__byte_perm(h.y, l.y, 0x7632)));
}

// Floats an element of a vector takes in an exchange buffer at P.
template <Prec P>
__host__ __device__ constexpr int operand_width() {
  return P == Prec::kHigh ? 2 : 1;
}

// The exchange form at precision P of W f32 values (split_store's halves
// at kHigh, interleaved: out[2e] = vh, out[2e + 1] = vl).
template <Prec P, int W>
__device__ __forceinline__ void operand_pairs(const float (&v)[W],
                                              float (&out)[W * operand_width<P>()]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if constexpr (P == Prec::kHighest) {
      out[e] = v[e];
    } else if constexpr (P == Prec::kDefault) {
      out[e] = bf16r(v[e]);
    } else {
      const float h = bf16r(v[e]);
      out[2 * e] = h;
      out[2 * e + 1] = bf16r(v[e] - h);
    }
  }
}

// s + the bf16x3 product of a register element w with the pair (vh, vl),
// in rows_dot<kHigh>'s order (fma3): w packed (row_operand), or with
// SPLIT_AT_USE an f32 element split here, as madd<kHigh> splits it.
template <bool SPLIT_AT_USE>
__device__ __forceinline__ float fma3_elem(float w, float vh, float vl, float s) {
  if constexpr (SPLIT_AT_USE) {
    const float h = bf16r(w);
    return fma3(h, bf16r(w - h), vh, vl, s);
  } else {
    const unsigned u = __float_as_uint(w);
    return fma3(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u), vh, vl, s);
  }
}

// reg_dot at precision P for each of a warp's NR register rows (in their
// operand form, row_operand) against the exchange buffer v (in its,
// operand_pairs), into out[0..NR): rows_dot<P>'s lane mapping, element
// order and shuffle tree, so rows_dot<P>'s bits. With SPLIT_AT_USE (kHigh
// only) the rows hold f32 elements, split as they are used, as
// rows_dot<kHigh> splits the elements it loads. At kHigh the rows advance
// together, chunk by chunk, so that a chunk's pairs (twice the floats of
// an f32 chunk) are read once and dropped rather than held for every row;
// each row's sum keeps its own order.
template <Prec P, bool SPLIT_AT_USE = false, int NR, int KW>
__device__ __forceinline__ void reg_dots(const float4 (&rows)[NR][KW], const float* v,
                                         int lane, float (&out)[NR]) {
  if constexpr (P != Prec::kHigh) {
#pragma unroll
    for (int q = 0; q < NR; ++q) out[q] = reg_dot(rows[q], v, lane);
  } else {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float s[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) s[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const float4 b0 = v4[2 * (lane + 32 * k)], b1 = v4[2 * (lane + 32 * k) + 1];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float4 a = rows[q][k];
        s[q] = fma3_elem<SPLIT_AT_USE>(a.x, b0.x, b0.y, s[q]);
        s[q] = fma3_elem<SPLIT_AT_USE>(a.y, b0.z, b0.w, s[q]);
        s[q] = fma3_elem<SPLIT_AT_USE>(a.z, b1.x, b1.y, s[q]);
        s[q] = fma3_elem<SPLIT_AT_USE>(a.w, b1.z, b1.w, s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < NR; ++q) out[q] = warp_sum(s[q]);
  }
}

// reg_dot with the row in shared memory (the same float4s, the same order).
template <int KW>
__device__ __forceinline__ float smem_dot(const float* row, const float* v, int lane) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const float4 a = r4[lane + 32 * k], b = v4[lane + 32 * k];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return warp_sum(s);
}

// The row groups cols_dot splits an n-wide M'v into at the streaming chunks'
// 256 threads (n <= 512, so n/4 < 256 and every column is summed in groups).
__host__ __device__ constexpr int col_groups(int n) { return 256 / (n / 4); }

// cols_dot's partial sums for a CTA's `cols` columns of M'v: column c of AC
// (rows x cols, row pitch cols, in shared memory) against v (rows), group
// g < G summing rows g, g + G, ... in order, one FMA a row, into
// part[g * cols + c]. Threads first .. first + cols * G - 1 take one
// (column, group) each; the caller syncs before col_sum reads part.
template <int G>
__device__ __forceinline__ void col_chains(const float* AC, int cols, const float* v,
                                           int rows, float* part, int first) {
  const int t = static_cast<int>(threadIdx.x) - first;
  if (t >= 0 && t < cols * G) {
    const int c = t % cols, g = t / cols;
    float acc = 0.0f;
#pragma unroll 8
    for (int r = g; r < rows; r += G) acc = fmaf(AC[r * cols + c], v[r], acc);
    part[g * cols + c] = acc;
  }
}

// Column c's sum of its G partial sums, in cols_dot's order (0 + group 0 +
// group 1 + ...).
template <int G>
__device__ __forceinline__ float col_sum(const float* part, int cols, int c) {
  float s = 0.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) s += part[g * cols + c];
  return s;
}

inline cudaLaunchConfig_t launch_config(int grid, int smem, cudaStream_t s,
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

// The clusters of `kern` (smem bytes of dynamic shared memory a CTA) the
// card holds at once, into *out.
template <typename Kernel>
cudaError_t resident(Kernel kern, int smem, int* out) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(C, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// Launches `kern` as min(lanes, resident) persistent clusters.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kern, int smem, int lanes, cudaStream_t s,
                              Args... args) {
  int clusters = 0;
  cudaError_t e = resident(kern, smem, &clusters);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config(C * (lanes < clusters ? lanes : clusters), smem, s, &attr);
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace cluster
}  // namespace qps

// Calls F<NB, MB>(args...) for NB = n / 128 and MB = m / 128, or returns
// cudaErrorInvalidValue: n, m multiples of 128, at most 512, with
// (n/128)(m/128) <= 8 (the register budget of a cluster chunk).
#define QPS_CLUSTER_DISPATCH(F, n, m, ...)                             \
  if ((n) % 128 || (m) % 128) return cudaErrorInvalidValue;            \
  switch (((n) / 128) * 16 + (m) / 128) {                              \
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
