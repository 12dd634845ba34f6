// Forward tile compositor for Hopper (sm_90a).
//
// Replaces s3gaussian_tpu/ops/tile_kernels.py::composite_fwd_pallas (the
// Pallas TPU kernel); plain PyTorch version and oracle:
// s3gaussian_tpu_torch/ops/composite.py::composite_tiles_torch.
//
// What bounds it on the card: the reads of the depth-sorted pair stream
// (16 rows x 4 B per pair; the kernel reads the 10 data rows, and at the
// slice's M ~ 3.28M slots the whole stream is ~210 MB) and one exp per
// pixel-pair inside the blend loop.  This first version is the simple,
// correct design: one block per tile, one thread per pixel, batches of
// blockDim pairs staged through shared memory with plain coalesced loads.
// Making it fast (a narrower stream, cp.async/TMA double-buffering of the
// batches, fewer pixel-pairs per exp) is later work.
//
// Semantics (identical to the Pallas kernel and the plain version):
//   alpha = min(0.99, opacity * exp(power)), skipped where power > 0 or
//   alpha < 1/255; a pair contributes while the transmittance after it
//   stays >= 1e-4; w = alpha * T accumulates rgb, depth and sum(w).
//   Output [T, 8, P]: rows 0-2 rgb, 3 depth, 4 final_T = 1 - sum(w)
//   (the backward reads 1 - row 4 as sum(w)), 5 the count of contributing
//   pairs, 6-7 zero.  No atomics: the output is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace s3g;

__global__ void composite_fwd_kernel(const float* __restrict__ feat,
                                     int64_t m,
                                     const int* __restrict__ tile_starts,
                                     float* __restrict__ out,
                                     int grid_x, int tile_x, int tile_y) {
  extern __shared__ float batch[];  // [kDataRows][P]
  const int p = tile_x * tile_y;    // == blockDim.x
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const float px = static_cast<float>((tile % grid_x) * tile_x + i % tile_x);
  const float py = static_cast<float>((tile / grid_x) * tile_y + i / tile_x);

  float T = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f, sum_w = 0.0f, n_contrib = 0.0f;
  bool done = false;

  for (int base = start; base < end; base += p) {
    // Whole-tile early exit once every pixel is saturated.  The vote is
    // also the barrier that keeps the previous batch alive until every
    // thread has finished blending it.
    if (__syncthreads_count(done) == p) break;
    const int j = base + i;
    if (j < end) {
#pragma unroll
      for (int row = 0; row < kDataRows; ++row)
        batch[row * p + i] = feat[row * m + j];
    }
    __syncthreads();
    const int n = min(p, end - base);
    for (int k = 0; k < n && !done; ++k) {
      const float dx = batch[FX * p + k] - px;
      const float dy = batch[FY * p + k] - py;
      const float power = conic_power(batch[FCA * p + k], batch[FCB * p + k],
                                      batch[FCC * p + k], dx, dy);
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, batch[FOP * p + k] * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
      r += w * batch[FR * p + k];
      g += w * batch[FG * p + k];
      b += w * batch[FB * p + k];
      d += w * batch[FD * p + k];
      sum_w += w;
      n_contrib += 1.0f;
      T = test_T;
    }
  }

  float* o = out + static_cast<int64_t>(tile) * kOutRows * p + i;
  o[0 * p] = r;
  o[1 * p] = g;
  o[2 * p] = b;
  o[3 * p] = d;
  o[4 * p] = 1.0f - sum_w;
  o[5 * p] = n_contrib;
  o[6 * p] = 0.0f;
  o[7 * p] = 0.0f;
}

}  // namespace

// feat: [16, m] float32 on the device; tile_starts: [grid_x*grid_y + 1]
// int32; out: [grid_x*grid_y, 8, tile_x*tile_y] float32.  Launches on
// `stream` and returns the launch status (cudaError_t) without
// synchronising.
extern "C" int composite_fwd(const float* feat, int64_t m,
                             const int* tile_starts, float* out, int grid_x,
                             int grid_y, int tile_x, int tile_y,
                             void* stream) {
  const int n_tiles = grid_x * grid_y;
  const int p = tile_x * tile_y;
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * kDataRows * p;  // <= 40 KB at p = 1024
  composite_fwd_kernel<<<n_tiles, p, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      feat, m, tile_starts, out, grid_x, tile_x, tile_y);
  return static_cast<int>(cudaGetLastError());
}
