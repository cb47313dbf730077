// Slab level: one block Gauss-Jordan level of the sigma-free factor.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/fused_factor.py:
// _slab_level_kernel. Per lane, with the live region T = S[:, 0:w_out], the
// pivot columns C = S[:, w_out:w_out+128] and Dinv the inverse of the pivot
// block S[j rows, w_out:w_out+128]:
//
//   DinvT          = Dinv . T[j*128:(j+1)*128, :]
//   T[rows not j] -= C[rows not j] . DinvT
//   T[rows j]      = DinvT
//
// The race a block-by-block carry-over would have: on the TPU one grid step
// held a lane's whole live region in VMEM, so writing the pivot rows in place
// was safe. Here the live region (n x w_out, up to 1.4 MB per lane at
// n=512, m=256) is tiled over many CTAs, and a tile that overwrote the pivot
// rows would race every other tile still reading them. So the level is two
// launches: the first computes DinvT into a scratch buffer (B, 128, >= w_out);
// the second runs the rank-128 update tile by tile, taking the pivot rows
// from the scratch. The pivot columns C are never written at this level.
//
// What bounds it on the H100: FLOPs. At n=512, m=256 the four levels cost
// 2*n*128*sum(w_out) + 2*128*128*sum(w_out) = 0.34 GFLOP per lane, 1.4
// TFLOP at B=4096 (~21 ms at the 67 TFLOP/s FP32 peak), against ~38 GB of
// slab read and written (~11 ms at 3.35 TB/s). Design: both launches are 64x64 SIMT
// tiles (common.cuh) with K = 128; update tiles in the pivot rows skip the
// product and copy DinvT.

#include "common.cuh"

using qps::i64;

namespace {
constexpr int NB = 128;
}

// DinvT[b, i, c] = sum_k Dinv[b, i, k] * S[b, j*128 + k, c].
// Grid (w_out/64, 2, B).
__global__ void __launch_bounds__(qps::TPB)
level_dinvt_kernel(const float* __restrict__ S, const float* __restrict__ Dinv,
                   float* __restrict__ T, i64 ld_t, int n, int wid, int j) {
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qps::TM, c0 = blockIdx.x * qps::TN;
  const float* Sb = S + (i64)b * n * wid;
  float acc[4][4] = {};
  qps::tile_gemm<true>(Dinv + (i64)b * NB * NB + (i64)i0 * NB, NB,
                       Sb + (i64)j * NB * wid + c0, wid, nullptr, NB, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* Tb = T + (i64)b * NB * ld_t;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(Tb + (i64)(i0 + ty * 4 + r) * ld_t + c0 + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// S[b, i, c] (c < w_out): DinvT row for pivot rows, else S - C . DinvT.
// Grid (w_out/64, n/64, B).
__global__ void __launch_bounds__(qps::TPB)
level_update_kernel(float* __restrict__ S, const float* __restrict__ T,
                    i64 ld_t, int n, int wid, int j, int w_out) {
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qps::TM, c0 = blockIdx.x * qps::TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* Sb = S + (i64)b * n * wid;
  const float* Tb = T + (i64)b * NB * ld_t;
  if (i0 >= j * NB && i0 < (j + 1) * NB) {  // uniform over the CTA
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      *reinterpret_cast<float4*>(Sb + (i64)i * wid + c0 + tx * 4) =
          *reinterpret_cast<const float4*>(Tb + (i64)(i - j * NB) * ld_t + c0 + tx * 4);
    }
    return;
  }
  float acc[4][4] = {};
  qps::tile_gemm<true>(Sb + (i64)i0 * wid + w_out, wid, Tb + c0, ld_t, nullptr,
                       NB, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* row = Sb + (i64)(i0 + ty * 4 + r) * wid + c0 + tx * 4;
    float4 v = *reinterpret_cast<float4*>(row);
    v.x -= acc[r][0];
    v.y -= acc[r][1];
    v.z -= acc[r][2];
    v.w -= acc[r][3];
    *reinterpret_cast<float4*>(row) = v;
  }
}

// S: contiguous (B, n, wid); Dinv: contiguous (B, 128, 128); scratch:
// (B, 128, ld_t) with ld_t >= w_out. n % 128 == 0, w_out % 64 == 0,
// w_out + 128 <= wid, wid % 4 == 0, ld_t % 4 == 0.
extern "C" int qps_slab_level(float* S, const float* Dinv, float* scratch,
                              i64 ld_t, int B, int n, int wid, int j, int w_out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 g1(w_out / qps::TN, NB / qps::TM, B);
  level_dinvt_kernel<<<g1, qps::TPB, 0, s>>>(S, Dinv, scratch, ld_t, n, wid, j);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2(w_out / qps::TN, n / qps::TM, B);
  level_update_kernel<<<g2, qps::TPB, 0, s>>>(S, scratch, ld_t, n, wid, j, w_out);
  return (int)cudaGetLastError();
}
