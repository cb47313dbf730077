// Route-level SpMV: out[g, l] = sum_t sum_s V[g, t, s, l] * X[s, idx[g, t, s, l]].
//
// Replaces two TPU kernels of benchmarks/routed_spmv_probe.py:
//   * `kern` (:189-192, pallas_call at :195), the square take_along_axis
//     micro kernel: one level (T = 1), out[g, l] = sum_s V[g,s,l] X[s, idx];
//   * `route_kernel` (:299-304, pallas_call at :310), the route-level
//     matvec: T levels per group of W output rows, X[s, j] = x[j*S + s].
// Both are these kernels; the micro kernel is their T = 1 case.
//
// The probe's platform verdict (:23-46: Mosaic refuses lane gathers whose
// index shape differs from the source's and crashes on square shuffles
// wider than 128 lanes) has no counterpart here: a thread gathers from any
// column of X, so every (S, W, G) of the probe runs.
//
// Both kernels sum in the TPU kernel's order: over s into a level's partial
// sum (FMAs from 0), then the levels into the output in t order. No
// atomics; a run is deterministic, and the two give the same bits.
//
// routed_levels_kernel (row 14b). What bounds it: bytes, and at
// config 4's P (fill 0.104, T = 12) most slots are empty, more so at high t.
// An optional occupancy mask (bit l % 32 of word (g, t, s, l / 32) set where
// the slot holds a nonzero) lets a lane load V, idx and the X gather only
// for its occupied slots: a warp's load then fetches only the 32-byte
// sectors its active lanes touch. A skipped FMA adds a product of 0 and a
// finite x, which is the partial sum itself but for the sign of a zero, so
// the result matches the unmasked sum (and the witness) wherever x is
// finite. To fill the card, the T levels of a tile of outputs are split
// across the CTA's level groups (LG, a power of two up to 16, one round for
// T <= 16): at config 4 (T = 12) 1.2 M (output, level) items where the
// witness ran 100 k threads walking 12 levels in turn. Each group writes
// its level's part to shared memory and group 0 adds the parts in t order.
// Giving a thread 2-4 levels with all their loads in flight, or more rounds
// of fewer groups, measured slower on an H100 (0.0247-0.0322 ms against
// 0.0230 at config 4's P). S = 8 (the probe's route levels) is unrolled;
// other S loop. One dense level (T = 1, no mask: row 14a) launches the
// witness's kernel, routed_levels_prev_kernel, one thread an output, which
// the level-split kernel did not beat there (chip_smoke.py phase 11d times
// both at every micro shape). Neighbouring threads read neighbouring l of
// each (t, s) row: coalesced.
//
// routed_levels_prev_kernel (the first port; now the witness): one
// thread an output (g, l), walking every slot of its T levels in turn.

#include <cuda_runtime.h>

namespace {

using i64 = long long;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
routed_levels_prev_kernel(const float* __restrict__ X, const int* __restrict__ idx,
                          const float* __restrict__ V, float* __restrict__ out,
                          int G, int T, int S, int W, int Wx) {
  const i64 o = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (o >= (i64)G * W) return;
  const i64 g = o / W;
  const int l = (int)(o % W);
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const i64 base = (g * T + t) * S * (i64)W + l;
    float part = 0.0f;
    for (int s = 0; s < S; ++s) {
      const i64 slot = base + (i64)s * W;
      part = fmaf(__ldg(V + slot), __ldg(X + (i64)s * Wx + __ldg(idx + slot)),
                  part);
    }
    acc += part;
  }
  out[o] = acc;
}

// One level's part: sum_s V[slot s] * X[s, idx[slot s]] by FMAs from 0 in s
// order, slot s at base + s * W, skipping the slots whose bit in mrow (word
// s * Wm, bit `bit`) is clear when mrow is given. S_T > 0: S = S_T unrolled,
// every load of the level in flight at once; S_T = 0: S looped.
template <int S_T>
__device__ __forceinline__ float level_part(const float* __restrict__ X,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ V,
                                            const unsigned* __restrict__ mrow,
                                            i64 base, int S, int W, int Wx,
                                            int Wm, int bit) {
  float part = 0.0f;
  if constexpr (S_T > 0) {
    bool on[S_T];
    float v[S_T];
    int c[S_T];
#pragma unroll
    for (int s = 0; s < S_T; ++s)
      on[s] = mrow == nullptr || ((__ldg(mrow + (i64)s * Wm) >> bit) & 1u);
#pragma unroll
    for (int s = 0; s < S_T; ++s) {
      v[s] = 0.0f;
      c[s] = 0;
      if (on[s]) {
        v[s] = __ldg(V + base + (i64)s * W);
        c[s] = __ldg(idx + base + (i64)s * W);
      }
    }
#pragma unroll
    for (int s = 0; s < S_T; ++s)
      if (on[s]) part = fmaf(v[s], __ldg(X + (i64)s * Wx + c[s]), part);
  } else {
    for (int s = 0; s < S; ++s) {
      if (mrow != nullptr && !((__ldg(mrow + (i64)s * Wm) >> bit) & 1u))
        continue;
      const i64 slot = base + (i64)s * W;
      part = fmaf(__ldg(V + slot), __ldg(X + (i64)s * Wx + __ldg(idx + slot)),
                  part);
    }
  }
  return part;
}

template <int LG>
__host__ __device__ constexpr int threads_of() {
  return LG <= 8 ? kThreads : 32 * LG;
}

// A CTA: TW = threads / LG outputs of one group g and LG level groups, level
// t0 + grp to group grp in a round of LG levels. Each group writes its
// level's part to shared memory and group 0 adds the parts in t order.
template <int LG, int S_T>
__global__ void __launch_bounds__(threads_of<LG>())
routed_levels_kernel(const float* __restrict__ X, const int* __restrict__ idx,
                     const float* __restrict__ V,
                     const unsigned* __restrict__ mask, float* __restrict__ out,
                     int T, int S, int W, int Wx, int Wm, int tiles) {
  constexpr int TW = threads_of<LG>() / LG;
  __shared__ float part[LG][TW];
  const int g = blockIdx.x / tiles;
  const int lt = threadIdx.x % TW, grp = threadIdx.x / TW;
  const int l = (blockIdx.x % tiles) * TW + lt;
  const bool live = l < W;
  float acc = 0.0f;
  for (int t0 = 0; t0 < T; t0 += LG) {
    const int t = t0 + grp;
    float p = 0.0f;
    if (live && t < T) {
      const i64 lvl = (i64)g * T + t;
      p = level_part<S_T>(X, idx, V,
                          mask == nullptr ? nullptr : mask + lvl * S * Wm + (l >> 5),
                          lvl * S * (i64)W + l, S, W, Wx, Wm, l & 31);
    }
    if constexpr (LG == 1) {
      acc += p;
    } else {
      part[grp][lt] = p;
      __syncthreads();
      if (grp == 0)
        for (int j = 0; j < LG && t0 + j < T; ++j) acc += part[j][lt];
      __syncthreads();
    }
  }
  if (grp == 0 && live) out[(i64)g * W + l] = acc;
}

template <int LG, int S_T>
void launch_levels(const float* X, const int* idx, const float* V,
                   const unsigned* mask, float* out, int G, int T, int S, int W,
                   int Wx, cudaStream_t s) {
  constexpr int TW = threads_of<LG>() / LG;
  const int tiles = (W + TW - 1) / TW;
  const i64 blocks = (i64)G * tiles;
  if (blocks > 0)
    routed_levels_kernel<LG, S_T><<<(unsigned)blocks, threads_of<LG>(), 0, s>>>(
        X, idx, V, mask, out, T, S, W, Wx, (W + 31) / 32, tiles);
}

template <int LG>
void launch_levels_s(const float* X, const int* idx, const float* V,
                     const unsigned* mask, float* out, int G, int T, int S,
                     int W, int Wx, cudaStream_t s) {
  if (S == 8)
    launch_levels<LG, 8>(X, idx, V, mask, out, G, T, S, W, Wx, s);
  else
    launch_levels<LG, 0>(X, idx, V, mask, out, G, T, S, W, Wx, s);
}

}  // namespace

// X: (S, Wx) float32; idx, V: (G, T, S, W) int32 / float32 (every index in
// [0, Wx)); mask: nullptr or (G, T, S, ceil(W / 32)) uint32; out: (G, W)
// float32. All contiguous.
extern "C" int qps_routed_levels(const float* X, const int* idx, const float* V,
                                 const unsigned* mask, float* out, int G, int T,
                                 int S, int W, int Wx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 1 && mask == nullptr) {
    // One dense level (row 14a): the witness's kernel, which the
    // level-split kernel did not beat there.
    const i64 outputs = (i64)G * W;
    const int blocks = (int)((outputs + kThreads - 1) / kThreads);
    if (blocks > 0)
      routed_levels_prev_kernel<<<blocks, kThreads, 0, s>>>(X, idx, V, out, G,
                                                            T, S, W, Wx);
  } else if (T <= 1) {
    launch_levels_s<1>(X, idx, V, mask, out, G, T, S, W, Wx, s);
  } else if (T == 2) {
    launch_levels_s<2>(X, idx, V, mask, out, G, T, S, W, Wx, s);
  } else if (T <= 4) {
    launch_levels_s<4>(X, idx, V, mask, out, G, T, S, W, Wx, s);
  } else if (T <= 8) {
    launch_levels_s<8>(X, idx, V, mask, out, G, T, S, W, Wx, s);
  } else {
    launch_levels_s<16>(X, idx, V, mask, out, G, T, S, W, Wx, s);
  }
  return (int)cudaGetLastError();
}

// The witness: the same function, one thread an output, every slot read.
extern "C" int qps_routed_levels_prev(const float* X, const int* idx,
                                      const float* V, float* out, int G, int T,
                                      int S, int W, int Wx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const i64 outputs = (i64)G * W;
  const int blocks = (int)((outputs + kThreads - 1) / kThreads);
  if (blocks > 0)
    routed_levels_prev_kernel<<<blocks, kThreads, 0, s>>>(X, idx, V, out, G, T,
                                                          S, W, Wx);
  return (int)cudaGetLastError();
}
