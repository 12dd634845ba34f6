// Forward tile compositor for Hopper (sm_90a).
//
// Replaces s3gaussian_tpu/ops/tile_kernels.py::composite_fwd_pallas (the
// Pallas TPU kernel); plain PyTorch version and oracle:
// s3gaussian_tpu_torch/ops/composite.py::composite_tiles_torch.
//
// Semantics (identical to the Pallas kernel and the plain version):
//   alpha = min(0.99, opacity * exp(power)), skipped where power > 0 or
//   alpha < 1/255; a pair contributes while the transmittance after it
//   stays >= 1e-4; w = alpha * T accumulates rgb, depth and sum(w).
//   Output [T, 8, P]: rows 0-2 rgb, 3 depth, 4 final_T = 1 - sum(w)
//   (the backward reads 1 - row 4 as sum(w)), 5 the count of contributing
//   pairs, 6-7 zero.  No atomics: the output is deterministic.
//
// What bounds it on the card: instructions per pixel-pair and their
// latency, not bytes.  On the headline 640x960 view a tile reads 197.5
// pairs on average (p99 549, of ~1,190 in range) before its pixels
// saturate: 101.1 M pixel-pairs are evaluated and 92.4 M contribute,
// against 38.6 MB of stream and output (0.0115 ms at 3.35 TB/s).  The
// first version (one pixel per thread, a pair's six values read one by
// one, branches for the skips) retired ~60 instructions per contributing
// pixel-pair, and its per-pixel chain (power -> exp -> alpha -> T) ran
// one pair after another.
//
// What the design does about it.  A block per tile, each thread owning
// kPixelsPerThread (2) vertically adjacent pixels of one column
// (composite_common.cuh):
//   - a pair's values are loaded from shared memory once per thread, not
//     once per pixel, four pairs at a time (one float4 per alpha row, the
//     colours one float4 per pair), and dx with its conic products
//     (conic_dx) is computed once for the column;
//   - the blend is branch-free (blend_pair): the skips and the exit are
//     selects, so the pixels' chains interleave and the alpha of the
//     next pairs, which does not depend on T, overlaps this pair's T
//     update.  ~38 instructions per pixel-pair (ptxas: 54 registers, no
//     spills);
//   - each pixel's exit is checked inside the unrolled group; a warp
//     whose pixels are all saturated leaves the batch, and the block
//     leaves the tile once all are (__syncthreads_count, once per batch);
//   - batches of 128 pairs go through a two-deep ring in shared memory
//     filled with cp.async, so the next batch's load overlaps this
//     batch's blend.
// 2 pixels per thread measured faster on the headline view than 1 or 4
// (4 take 85 registers and leave too few warps resident; PERF.md).
//
// Why no tensor cores: there is no matrix product here.  The blend is a
// per-pixel sequential recurrence with a data-dependent exit, and its sums
// over pairs (w * colour) run in the order of T; TF32 would also break
// the 5e-4 tolerance against the plain version without a three-way split.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace s3g;

constexpr int kPPT = kPixelsPerThread;

// The state of one thread's pixels.
struct FwdPixels {
  float py[kPPT];
  float T[kPPT];
  float r[kPPT], g[kPPT], b[kPPT], d[kPPT], sum_w[kPPT], n_contrib[kPPT];
  bool done[kPPT];

  __device__ __forceinline__ bool all_done() const {
    bool all = true;
#pragma unroll
    for (int s = 0; s < kPPT; ++s) all = all && done[s];
    return all;
  }
};

// Blends one pair into the thread's pixels, front to back.  Branch-free:
// the skips and the exit become selects, so the pixels' chains and the
// alpha of the next pairs (which does not depend on T) interleave.  A
// pixel that does not take the pair adds w = 0 and keeps its T.
__device__ __forceinline__ void blend_pair(FwdPixels& q, float px,
                                           float x, float y, float ca,
                                           float cb, float cc, float op,
                                           float4 rgbd) {
  const ConicDx c = conic_dx(ca, cb, x - px);
#pragma unroll
  for (int s = 0; s < kPPT; ++s) {
    const float power = conic_power(c, cc, y - q.py[s]);
    const float alpha = fminf(kAlphaMax, op * expf(power));
    const float test_T = q.T[s] * (1.0f - alpha);
    // the skips of the plain version: power > 0, alpha < 1/255
    const bool live = !q.done[s] && !(power > 0.0f) && !(alpha < kAlphaMin);
    const bool contrib = live && !(test_T < kTEps);
    q.done[s] = q.done[s] || (live && !contrib);
    const float w = contrib ? alpha * q.T[s] : 0.0f;
    q.r[s] += w * rgbd.x;
    q.g[s] += w * rgbd.y;
    q.b[s] += w * rgbd.z;
    q.d[s] += w * rgbd.w;
    q.sum_w[s] += w;
    q.n_contrib[s] += contrib ? 1.0f : 0.0f;
    q.T[s] = contrib ? test_T : q.T[s];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    composite_fwd_kernel(const float* __restrict__ feat, int64_t m,
                         const int* __restrict__ tile_starts,
                         float* __restrict__ out, int grid_x, int tile_x,
                         int tile_y) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);  // 2 stages
  const int p = tile_x * tile_y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const float px =
      static_cast<float>((tile % grid_x) * tile_x + tid % tile_x);

  FwdPixels q;
  int pix[kPPT];
#pragma unroll
  for (int s = 0; s < kPPT; ++s) {
    pix[s] = pixel_slot(tid, s, tile_x, tile_y);
    q.py[s] = static_cast<float>((tile / grid_x) * tile_y +
                                 (tid / tile_x) * kPPT + s);
    q.T[s] = 1.0f;
    q.r[s] = q.g[s] = q.b[s] = q.d[s] = q.sum_w[s] = q.n_contrib[s] = 0.0f;
    q.done[s] = pix[s] < 0;
  }

  constexpr int B = kBatch;
  const int n_batches = (end - start + B - 1) / B;
  if (n_batches > 0)
    stage_batch(ring, feat, m, start, min(B, end - start), tid, nthreads);
  cp_async_commit();
  for (int bi = 0; bi < n_batches; ++bi) {
    // Whole-tile early exit once every pixel is saturated.  The vote is
    // also the barrier after which the stage read in the previous batch
    // may be refilled.
    if (__syncthreads_count(q.all_done()) == nthreads) break;
    const int base = start + bi * B;
    if (bi + 1 < n_batches) {
      stage_batch(ring + ((bi + 1) & 1) * kStageFloats, feat, m, base + B,
                  min(B, end - base - B), tid, nthreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = ring + (bi & 1) * kStageFloats;
    const float4* colour = reinterpret_cast<const float4*>(st + kAlphaRows * B);
    const int n = min(B, end - base);
    // slots [n, B) are zero-filled: alpha 0, skipped
    for (int k = 0; k < n; k += 4) {
      if (__all_sync(kFull, q.all_done())) break;
      const float4 x = *reinterpret_cast<const float4*>(st + FX * B + k);
      const float4 y = *reinterpret_cast<const float4*>(st + FY * B + k);
      const float4 ca = *reinterpret_cast<const float4*>(st + FCA * B + k);
      const float4 cb = *reinterpret_cast<const float4*>(st + FCB * B + k);
      const float4 cc = *reinterpret_cast<const float4*>(st + FCC * B + k);
      const float4 op = *reinterpret_cast<const float4*>(st + FOP * B + k);
      blend_pair(q, px, x.x, y.x, ca.x, cb.x, cc.x, op.x, colour[k]);
      blend_pair(q, px, x.y, y.y, ca.y, cb.y, cc.y, op.y, colour[k + 1]);
      blend_pair(q, px, x.z, y.z, ca.z, cb.z, cc.z, op.z, colour[k + 2]);
      blend_pair(q, px, x.w, y.w, ca.w, cb.w, cc.w, op.w, colour[k + 3]);
    }
  }
  cp_async_wait<0>();  // no copy in flight when the block exits

  float* o = out + static_cast<int64_t>(tile) * kOutRows * p;
#pragma unroll
  for (int s = 0; s < kPPT; ++s) {
    if (pix[s] < 0) continue;
    o[0 * p + pix[s]] = q.r[s];
    o[1 * p + pix[s]] = q.g[s];
    o[2 * p + pix[s]] = q.b[s];
    o[3 * p + pix[s]] = q.d[s];
    o[4 * p + pix[s]] = 1.0f - q.sum_w[s];
    o[5 * p + pix[s]] = q.n_contrib[s];
    o[6 * p + pix[s]] = 0.0f;
    o[7 * p + pix[s]] = 0.0f;
  }
}

}  // namespace

// feat: [16, m] float32 on the device; tile_starts: [grid_x*grid_y + 1]
// int32; out: [grid_x*grid_y, 8, tile_x*tile_y] float32.  threads and
// smem_bytes come from ops/tile_kernels.py::launch_geometry; a launch
// that does not cover the tile returns cudaErrorInvalidValue without
// launching.  Launches on `stream` and returns the launch status
// (cudaError_t) without synchronising.
extern "C" int composite_fwd(const float* feat, int64_t m,
                             const int* tile_starts, float* out, int grid_x,
                             int grid_y, int tile_x, int tile_y, int threads,
                             int smem_bytes, void* stream) {
  const int n_tiles = grid_x * grid_y;
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const int rows = (tile_y + kPixelsPerThread - 1) / kPixelsPerThread;
  const long need = 2L * kStageFloats * sizeof(float);
  if (threads % 32 != 0 || threads > kMaxThreads ||
      threads < tile_x * rows || smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_fwd_kernel<<<n_tiles, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      feat, m, tile_starts, out, grid_x, tile_x, tile_y);
  return static_cast<int>(cudaGetLastError());
}
