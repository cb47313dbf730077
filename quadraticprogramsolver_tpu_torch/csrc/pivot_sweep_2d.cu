// Round-1 pivot sweep: batched 128x128 SPD inverse by the unscaled scalar
// sweep with its zero-pivot guard.
//
// Replaces the TPU kernel quadraticprogramsolver_tpu/ops/spd_kernels.py:
// _pivot_sweep_kernel_2d (reached through pallas_spd_inverse_nb, the default
// pivot inverse of spd_inverse_sweep). The TPU kernel stacks `lanes` blocks
// as one (lanes*128, 128) tile and pulls each step's pivot row and scalar out
// with masks and one-hot matmuls, because Mosaic rejected rank-3 layouts and
// strided value slices then; those are layout devices with no arithmetic of
// their own (a one-hot dot adds zeros), so on Hopper each block is one CTA
// and `lanes` has no counterpart. The arithmetic, the layout and what bounds
// it are sweep_block.cuh's, with GUARD = true: a zero pivot reads as 1.
// qps_pivot_sweep_2d runs sweep_block_kernel (pivot_sweep.cu's v3 layout), and
// qps_pivot_sweep_2d_prev the first port, sweep_block_prev_kernel, kept as
// its bit-for-bit witness.

#include "sweep_block.cuh"

using qps::i64;

// D: (B, 128, 128) view with element (b, i, k) at D[b*d_batch + i*d_row + k].
// out: contiguous (B, 128, 128).
extern "C" int qps_pivot_sweep_2d(const float* D, i64 d_batch, i64 d_row,
                                  float* out, int B, void* stream) {
  return qps::launch_sweep_block<true, false>(D, d_batch, d_row, out, B,
                                              static_cast<cudaStream_t>(stream));
}

// The same arguments, through the witness sweep_block_prev_kernel.
extern "C" int qps_pivot_sweep_2d_prev(const float* D, i64 d_batch, i64 d_row,
                                       float* out, int B, void* stream) {
  return qps::launch_sweep_block<true, false, true>(
      D, d_batch, d_row, out, B, static_cast<cudaStream_t>(stream));
}
