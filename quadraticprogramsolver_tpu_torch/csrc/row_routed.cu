// Row-routed SpMV: two kernels.
//
// row_routed_blocks_kernel (row 15): the fused matvec
//   y[b, k] = sum over the rows r of output block b of V[r, k] * Xw[r / L, idx[r, k]]
// in one launch, writing (n_blk, 128) and nothing else.
//
// Replaces the TPU kernel benchmarks/row_routed_probe.py:204-209
// `route_kernel` (pallas_call at :240) together with the probe's block sum,
// a one-hot MXU product (:256-265). On the TPU that product was the cheap
// step; on this card a one-hot FP32 product over the packed rows is ~100
// GFLOP at config 4's P and took ~90 % of the matvec. So the rows are never
// written: the packer's rows are indexed block-major on the device
// (ops/routed_spmv.py: row_routed_index): `order` lists the used rows
// sorted stably by output block (padding rows left out), `blk_ptr[b]` where
// block b's rows start in it, and `mask[r, w]` bit j says that slot 32 w + j
// of row r holds a nonzero.
//
// What bounds it: bytes, and at config 4 the slots are 98.5 % empty (66.7
// slots a nnz). A warp's load fetches only the 32-byte sectors its active
// lanes touch, so a lane loads V, idx and the Xw gather only where its
// occupancy bits are set: the traffic is the masks (16 bytes a row), the
// occupied sectors of V and idx, the row order, Xw (from L2) and y.
// One CTA an output block, 8 warps; each warp walks a contiguous run of the
// block's rows, lane l owning output lanes 4l..4l+3 (16-byte loads of V and
// idx, one mask nibble). A warp stages 32 rows' ids and mask words in shared
// memory (one coalesced load each, the next batch's in flight meanwhile);
// each lane then visits only the rows where its nibble is set, kUnroll of
// them with their loads in flight at once, lowest row first. At config 4 a
// row holds ~2 nonzeros of 128 slots, so a lane has work in ~2 rows of 32,
// and the walk costs a few memory latencies a batch instead of two every
// few rows. (On an H100 80GB HBM3 at 700 W, 8 warps and 2 rows in flight
// measured best of 4-32 warps, 2-8 rows and register caps; a block-major
// copy of V and idx saved only 6 %: the occupied sectors lie one or two to
// a 512-byte row, so the walk runs at the card's rate for scattered
// sectors, not at its streaming rate.) The warps' partial sums meet in
// shared memory, added in warp order: no atomics, so two runs give the same
// bits. A slot whose bit is clear
// (empty, or an explicit zero of P) is skipped, which changes y only where
// x is not finite.
//
// row_routed_kernel (the first port; now the witness): rows[r, k] =
// V[r, k] * Xw[r / L, idx[r, k]], the probe's kernel itself, one thread an
// element (12 bytes each), bit for bit its plain version. The probe pads L
// to a divisor of its 1568-row grid step (:187, 210-236), a Mosaic tiling
// need: here a thread finds its window as r / L, so no padding layers are
// made.

#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int kThreads = 256;
constexpr int kWarps = 8;    // warps a CTA of the fused kernel
constexpr int kUnroll = 2;   // rows a lane has in flight at once

__global__ void __launch_bounds__(kThreads)
row_routed_kernel(const float* __restrict__ Xw, const int* __restrict__ idx,
                  const float* __restrict__ V, float* __restrict__ rows, i64 R,
                  int Wd, int L) {
  const i64 e = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (e >= R * Wd) return;
  const i64 r = e / Wd;
  rows[e] = __ldg(V + e) * __ldg(Xw + (r / L) * Wd + __ldg(idx + e));
}

__global__ void __launch_bounds__(kWarps * 32)
row_routed_blocks_kernel(const float* __restrict__ Xw, const int* __restrict__ idx,
                         const float* __restrict__ V,
                         const unsigned* __restrict__ mask,
                         const int* __restrict__ order,
                         const int* __restrict__ blk_ptr, float* __restrict__ y,
                         int L) {
  __shared__ __align__(16) float part[kWarps][128];
  __shared__ __align__(16) uint4 smask[kWarps][32];
  __shared__ int srow[kWarps][32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = __ldg(blk_ptr + b), n = __ldg(blk_ptr + b + 1) - lo;
  const int per = (n + kWarps - 1) / kWarps;
  const int r0 = lo + min(n, warp * per), r1 = lo + min(n, (warp + 1) * per);
  const int word = lane >> 3, shift = (lane & 7) * 4;
  const uint4* mask4 = reinterpret_cast<const uint4*>(mask);
  const unsigned* wmask = reinterpret_cast<const unsigned*>(smask[warp]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // Lane j fetches the id and the four mask words of a batch's row j; the
  // next batch's are in flight while this one is summed.
  int rn = 0;
  uint4 mn = make_uint4(0u, 0u, 0u, 0u);
  if (r0 + lane < r1) {
    rn = __ldg(order + r0 + lane);
    mn = __ldg(mask4 + rn);
  }
  for (int base = r0; base < r1; base += 32) {
    const int cnt = min(32, r1 - base);
    __syncwarp();
    srow[warp][lane] = rn;
    smask[warp][lane] = mn;
    __syncwarp();
    if (base + 32 + lane < r1) {
      rn = __ldg(order + base + 32 + lane);
      mn = __ldg(mask4 + rn);
    }
    // The batch's rows in which this lane's four slots hold a nonzero.
    unsigned todo = 0u;
    for (int i = 0; i < cnt; ++i)
      if ((wmask[i * 4 + word] >> shift) & 0xfu) todo |= 1u << i;
    while (todo) {
      int ii[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ii[u] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1u;
      }
      int r[kUnroll];
      unsigned m[kUnroll];
      float4 v[kUnroll];
      int4 c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = 0;
        m[u] = 0u;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        c[u] = make_int4(0, 0, 0, 0);
        if (ii[u] >= 0) {
          r[u] = srow[warp][ii[u]];
          m[u] = (wmask[ii[u] * 4 + word] >> shift) & 0xfu;
          v[u] = __ldg(reinterpret_cast<const float4*>(V + (i64)r[u] * 128) + lane);
          c[u] = __ldg(reinterpret_cast<const int4*>(idx + (i64)r[u] * 128) + lane);
        }
      }
      // Ascending r: the rows come out of `todo` lowest first.
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* xr = Xw + (i64)(r[u] / L) * 128;
        if (m[u] & 1u) acc.x = fmaf(v[u].x, __ldg(xr + c[u].x), acc.x);
        if (m[u] & 2u) acc.y = fmaf(v[u].y, __ldg(xr + c[u].y), acc.y);
        if (m[u] & 4u) acc.z = fmaf(v[u].z, __ldg(xr + c[u].z), acc.z);
        if (m[u] & 8u) acc.w = fmaf(v[u].w, __ldg(xr + c[u].w), acc.w);
      }
    }
  }
  reinterpret_cast<float4*>(part[warp])[lane] = acc;
  __syncthreads();
  if (threadIdx.x < 128) {
    float s = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][threadIdx.x];
    y[(i64)b * 128 + threadIdx.x] = s;
  }
}

}  // namespace

// Xw: (n_win, Wd) float32 with R <= n_win * L; idx, V: (R, Wd) int32 /
// float32 (every index in [0, Wd)); rows: (R, Wd) float32. All contiguous.
extern "C" int qps_row_routed(const float* Xw, const int* idx, const float* V,
                              float* rows, long long R, int Wd, int L,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 elems = R * Wd;
  const i64 blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > 0)
    row_routed_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(Xw, idx, V, rows, R,
                                                            Wd, L);
  return (int)cudaGetLastError();
}

// Xw: (n_win, 128) float32; idx, V: (R, 128) int32 / float32 with R <=
// n_win * L (every index in [0, 128)); mask: (R, 4) uint32; order: the used
// rows block-major, int32 in [0, R); blk_ptr: (n_blk + 1,) int32, ascending
// from 0 to order's length; y: (n_blk, 128) float32. All contiguous; Xw, idx,
// V and mask 16-byte aligned.
extern "C" int qps_row_routed_blocks(const float* Xw, const int* idx,
                                     const float* V, const unsigned* mask,
                                     const int* order, const int* blk_ptr,
                                     float* y, int n_blk, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blk > 0)
    row_routed_blocks_kernel<<<n_blk, kWarps * 32, 0, s>>>(
        Xw, idx, V, mask, order, blk_ptr, y, L);
  return (int)cudaGetLastError();
}
