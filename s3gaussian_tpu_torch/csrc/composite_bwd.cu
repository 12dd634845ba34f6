// Backward tile compositor for Hopper (sm_90a): the VJP of
// composite_fwd.cu.
//
// Replaces s3gaussian_tpu/ops/tile_kernels.py::composite_bwd_pallas (the
// Pallas TPU kernel); plain PyTorch version and oracle:
// s3gaussian_tpu_torch/ops/composite.py::composite_tiles_bwd_torch.
//
// Input: the depth-sorted [16, M] pair stream, tile_starts [T+1], the
// forward output out [T, 8, P] and its cotangent dout [T, 8, P] (rows 5-7
// of dout are not read).  Output: per-pair gradients [16, M] of x, y, the
// conic (a, b, c), opacity, rgb and depth (rows 0-9) in sorted-pair
// order.  The caller allocates it zeroed: rows 10-15, slots past the last
// tile range and pairs after a tile's early exit are never written.
//
// Arithmetic.  Each thread walks its tile's pairs front to back and
// recomputes the transmittance T of each of its pixels with the forward's
// arithmetic (the sequential product; test_T < 1e-4 => done; conic_power
// from composite_common.cuh), so a pair contributes here exactly when it
// did in the forward.  The five output channels collapse into one scalar
// state per pixel (tile_kernels.py:270-274): with d5 = (dout[0:4],
// -dout[4]) (the ones channel carries -d final_T), e = d5 . (rgb, depth,
// 1) for a pair and E_total = d5 . (out[0:4], 1 - out[4]), the running
// prefix = sum of w*e gives
//   d_alpha = e*T_excl - (E_total - prefix_incl) / (1 - alpha).
// Each pair's 10 gradient values are summed over the tile's pixels inside
// the block, in a fixed order, and every pair belongs to one tile, so each
// column is written once, with no global atomics, and the result is the
// same from run to run.  The TPU kernel's boundary read-modify-write of
// shared blocks and its sequential grid (tile_kernels.py:346-378) exist
// because its blocks straddle tiles; here a block owns exactly its tile's
// pair range, so neither is needed.
//
// What bounds it on the card: the per-pair sum over pixels and the
// arithmetic around it, not bytes (stream, out/dout and the [16, M]
// gradient are 253 MB, 0.076 ms at 3.35 TB/s).  On the headline 640x960
// view 3.16 M warp-pairs have a contributing pixel when a thread owns one
// pixel; the first version summed each of the 10 values with a 5-step
// butterfly, 50 shuffles per warp-pair (158 M in all, ~0.6 ms at one
// warp-wide shuffle per clock per SM), and ran each pixel's chain one pair
// after another behind branches.
//
// What the design does about it (composite_common.cuh has the geometry):
//   - each thread owns kPixelsPerThread (2) vertically adjacent pixels of
//     one column, so a warp covers a compact 16 x 4 block of a 16-wide
//     tile and 1.62 M warp-pairs have a contributor; the thread adds its
//     pixels' values in registers before any shuffle, and loads each
//     pair from shared memory once for its pixels, four pairs at a
//     time;
//   - the pixels share dx, so the thread reduces the sums of d_power
//     times (dx, dy, dx^2, dx*dy, dy^2) and the last pass applies the
//     pair's conic once (kSdx...), instead of five conic products per
//     pixel;
//   - the warp sum is a transposed reduce-scatter (warp_reduce_scatter):
//     5 + 3 + 2 + 1 + 1 = 12 shuffles leave each value's warp total on its
//     own pair of lanes, and ten lanes store the ten partials with one
//     instruction;
//   - the step is branch-free (pair_sums) and the reduction runs for every
//     pair a warp visits (most have a contributor: chip_smoke.py prints
//     both counts), so the shuffles of one pair overlap the arithmetic of
//     the next;
//   - a warp whose pixels are all saturated leaves the batch; the last
//     pass sums, in warp order, only the partials each warp wrote and only
//     up to the furthest pair any warp reached, so nothing is zero-filled;
//     partials are laid out [warp][pair][11] (odd stride: no bank
//     conflicts in the stores or in that pass);
//   - batches of 128 pairs go through a two-deep ring in shared memory
//     filled with cp.async, so the next batch's load overlaps this
//     batch's steps.
// ptxas: 81 registers, no spills.  2 pixels per thread measured faster on
// the headline view than 1 or 4, batch 128 than 64 or 256 (PERF.md).
//
// Why no tensor cores: the TPU kernel sums over pixels on the MXU
// (tile_kernels.py:319-344) because its values are already [P, C] arrays
// in VMEM.  Here each pixel's values sit in one thread's registers; an
// mma.sync would need them transposed into fragments first, the same
// traffic as the shuffles it replaces, and it would compute in TF32,
// whose ~3 digits break the 1e-5 * scale tolerance unless each product is
// split three ways.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace s3g;

constexpr int kGradRows = 10;    // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr int kPartStride = 11;  // floats per (warp, pair) partial: odd
// The 10 sums over a tile's pixels reduced for each pair: those of
// d_power * (dx, dy, dx^2, dx*dy, dy^2), from which the kernel's last
// pass forms the pair's x, y and conic gradients, then the gradient rows
// FOP..FD themselves.  d_power = d loss / d power of the pixel.
constexpr int kSdx = 0, kSdy = 1, kSdxx = 2, kSdxdy = 3, kSdyy = 4;

constexpr int kPPT = kPixelsPerThread;

// The state of one thread's pixels.
struct BwdPixels {
  float py[kPPT];
  float d5[kPPT][5];
  float e_total[kPPT];
  float T[kPPT], prefix[kPPT];
  bool done[kPPT];

  __device__ __forceinline__ bool all_done() const {
    bool all = true;
#pragma unroll
    for (int s = 0; s < kPPT; ++s) all = all && done[s];
    return all;
  }
};

// Steps the thread's pixels past one pair and returns in u the thread's
// part of the pair's 10 sums over pixels (kSdx..kSdyy, FOP..FD).
// Branch-free, as the forward's blend_pair: a pixel that does not take the
// pair adds zeros (G and w are selected to 0 first, so an overflowing exp
// of a skipped pair never reaches a product) and keeps its T and prefix.
// The thread's pixels share dx, so its conic sums need one product by dx
// each.
__device__ __forceinline__ void pair_sums(BwdPixels& q, float px,
                                          float x, float y, float ca,
                                          float cb, float cc, float op,
                                          float4 rgbd, float u[kGradRows]) {
  const float dx = x - px;
  const ConicDx c = conic_dx(ca, cb, dx);
  float sd = 0.0f, sdy = 0.0f, sdyy = 0.0f;  // sums of d_power (* dy, dy^2)
#pragma unroll
  for (int r = FOP; r < kGradRows; ++r) u[r] = 0.0f;
#pragma unroll
  for (int s = 0; s < kPPT; ++s) {
    const float dy = y - q.py[s];
    const float power = conic_power(c, cc, dy);
    const float g = expf(power);
    const float alpha = fminf(kAlphaMax, op * g);
    const float test_T = q.T[s] * (1.0f - alpha);
    // the skips of the plain version: power > 0, alpha < 1/255
    const bool live = !q.done[s] && !(power > 0.0f) && !(alpha < kAlphaMin);
    const bool contrib = live && !(test_T < kTEps);
    q.done[s] = q.done[s] || (live && !contrib);
    const float G = contrib ? g : 0.0f;
    const float* d5 = q.d5[s];
    const float w = contrib ? alpha * q.T[s] : 0.0f;
    const float e = d5[0] * rgbd.x + d5[1] * rgbd.y + d5[2] * rgbd.z +
                    d5[3] * rgbd.w + d5[4];
    q.prefix[s] += w * e;
    const float d_alpha =
        e * q.T[s] - (q.e_total[s] - q.prefix[s]) / (1.0f - alpha);
    const float d_power = op * d_alpha * G;
    const float d_dy = d_power * dy;
    sd += d_power;
    sdy += d_dy;
    sdyy += d_dy * dy;
    u[FOP] += G * d_alpha;
    u[FR] += w * d5[0];
    u[FG] += w * d5[1];
    u[FB] += w * d5[2];
    u[FD] += w * d5[3];
    q.T[s] = contrib ? test_T : q.T[s];
  }
  u[kSdx] = sd * dx;
  u[kSdy] = sdy;
  u[kSdxx] = u[kSdx] * dx;
  u[kSdxdy] = sdy * dx;
  u[kSdyy] = sdyy;
}

// Sums v[0..9] over the warp's 32 lanes with 12 shuffles: a transposed
// reduce-scatter, in which at each step a lane keeps part of its values,
// sends the rest to its partner and adds what it receives (offset 16:
// keep 5 of 10; 8: 3 of 5; 4: 2 of 3; 2: 1 of 2; 1: a butterfly).  Each
// row's total ends on the two lanes that grad_row names; the order of the
// additions depends on the lane numbers alone.
__device__ __forceinline__ float warp_reduce_scatter(const float v[kGradRows],
                                                     int lane) {
  const bool h16 = lane & 16;
  float a[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    a[j] = (h16 ? v[j + 5] : v[j]) +
           __shfl_xor_sync(kFull, h16 ? v[j] : v[j + 5], 16);
  const bool h8 = lane & 8;  // keep a[0..2] (h8 = 0) or a[3..4] (h8 = 1)
  float b[3];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    b[j] = (h8 ? a[j + 3] : a[j]) +
           __shfl_xor_sync(kFull, h8 ? a[j] : a[j + 3], 8);
  b[2] = (h8 ? 0.0f : a[2]) + __shfl_xor_sync(kFull, h8 ? a[2] : 0.0f, 8);
  const bool h4 = lane & 4;  // keep b[0..1] (h4 = 0) or b[2] (h4 = 1)
  const float c0 =
      (h4 ? b[2] : b[0]) + __shfl_xor_sync(kFull, h4 ? b[0] : b[2], 4);
  const float c1 =
      (h4 ? 0.0f : b[1]) + __shfl_xor_sync(kFull, h4 ? b[1] : 0.0f, 4);
  const bool h2 = lane & 2;  // keep c0 (h2 = 0) or c1 (h2 = 1)
  const float d = (h2 ? c1 : c0) + __shfl_xor_sync(kFull, h2 ? c0 : c1, 2);
  return d + __shfl_xor_sync(kFull, d, 1);
}

// The gradient row whose warp total warp_reduce_scatter leaves on `lane`,
// or -1: ten even lanes, one row each.
__device__ __forceinline__ int grad_row(int lane) {
  if (lane & 1) return -1;
  const int base = (lane & 16) ? 5 : 0;
  switch ((lane >> 1) & 7) {  // bits h8 h4 h2
    case 0: return base + 0;
    case 1: return base + 1;
    case 2: return base + 2;
    case 4: return base + 3;
    case 5: return base + 4;
    default: return -1;
  }
}

// One pair's warp total of row `row` (grad_row), from the ten lanes that
// hold one each.
__device__ __forceinline__ void store_partial(float* part_k, int row,
                                              float total) {
  if (row >= 0) part_k[row] = total;
}

__global__ void __launch_bounds__(kMaxThreads)
    composite_bwd_kernel(const float* __restrict__ feat, int64_t m,
                         const int* __restrict__ tile_starts,
                         const float* __restrict__ out,
                         const float* __restrict__ dout,
                         float* __restrict__ grads, int grid_x, int tile_x,
                         int tile_y) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);  // 2 stages
  constexpr int B = kBatch;
  float* const partial = ring + 2 * kStageFloats;  // [warp][B][11]
  __shared__ int warp_end[kMaxThreads / 32];  // pairs each warp visited
  const int p = tile_x * tile_y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* const part = partial + warp * B * kPartStride;
  const int row = grad_row(lane);
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const float px =
      static_cast<float>((tile % grid_x) * tile_x + tid % tile_x);

  BwdPixels q;
#pragma unroll
  for (int s = 0; s < kPPT; ++s) {
    const int pix = pixel_slot(tid, s, tile_x, tile_y);
    q.py[s] = static_cast<float>((tile / grid_x) * tile_y +
                                 (tid / tile_x) * kPPT + s);
    q.T[s] = 1.0f;
    q.prefix[s] = 0.0f;
    q.done[s] = pix < 0;
    q.e_total[s] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) q.d5[s][ch] = 0.0f;
    if (pix >= 0) {
      const int64_t o = static_cast<int64_t>(tile) * kOutRows * p + pix;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        q.d5[s][ch] = dout[o + ch * p];
        q.e_total[s] += q.d5[s][ch] * out[o + ch * p];
      }
      q.d5[s][4] = -dout[o + 4 * p];
      q.e_total[s] += q.d5[s][4] * (1.0f - out[o + 4 * p]);
    }
  }

  const int n_batches = (end - start + B - 1) / B;
  if (n_batches > 0)
    stage_batch(ring, feat, m, start, min(B, end - start), tid, nthreads);
  cp_async_commit();
  for (int bi = 0; bi < n_batches; ++bi) {
    // Whole-tile early exit; also the barrier after which the previous
    // batch's stage may be refilled and its partials overwritten.
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

    // four pairs at a time; the reduction runs for every pair the warp
    // visits, so it overlaps the next pair's arithmetic
    int k = 0;
    for (; k < n; k += 4) {
      if (__all_sync(kFull, q.all_done())) break;
      const float4 x = *reinterpret_cast<const float4*>(st + FX * B + k);
      const float4 y = *reinterpret_cast<const float4*>(st + FY * B + k);
      const float4 ca = *reinterpret_cast<const float4*>(st + FCA * B + k);
      const float4 cb = *reinterpret_cast<const float4*>(st + FCB * B + k);
      const float4 cc = *reinterpret_cast<const float4*>(st + FCC * B + k);
      const float4 op = *reinterpret_cast<const float4*>(st + FOP * B + k);
      float u[kGradRows];
      pair_sums(q, px, x.x, y.x, ca.x, cb.x, cc.x, op.x, colour[k], u);
      store_partial(part + k * kPartStride, row, warp_reduce_scatter(u, lane));
      pair_sums(q, px, x.y, y.y, ca.y, cb.y, cc.y, op.y, colour[k + 1], u);
      store_partial(part + (k + 1) * kPartStride, row,
                    warp_reduce_scatter(u, lane));
      pair_sums(q, px, x.z, y.z, ca.z, cb.z, cc.z, op.z, colour[k + 2], u);
      store_partial(part + (k + 2) * kPartStride, row,
                    warp_reduce_scatter(u, lane));
      pair_sums(q, px, x.w, y.w, ca.w, cb.w, cc.w, op.w, colour[k + 3], u);
      store_partial(part + (k + 3) * kPartStride, row,
                    warp_reduce_scatter(u, lane));
    }
    if (lane == 0) warp_end[warp] = min(k, n);
    __syncthreads();

    // per pair the warps reached: their partials summed in warp order (a
    // warp that left the batch early adds nothing past its end), then the
    // pair's 10 gradient rows, each written once; pairs no warp reached
    // keep the caller's zeros
    int k_end = 0;
    for (int w = 0; w < nwarps; ++w) k_end = max(k_end, warp_end[w]);
    for (int j = tid; j < k_end; j += nthreads) {
      float sum[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) sum[r] = 0.0f;
      for (int w = 0; w < nwarps; ++w) {
        if (j >= warp_end[w]) continue;
#pragma unroll
        for (int r = 0; r < kGradRows; ++r)
          sum[r] += partial[(w * B + j) * kPartStride + r];
      }
      const float ca = st[FCA * B + j], cb = st[FCB * B + j];
      const float cc = st[FCC * B + j];
      float* g = grads + base + j;
      g[FX * m] = -ca * sum[kSdx] - cb * sum[kSdy];
      g[FY * m] = -cc * sum[kSdy] - cb * sum[kSdx];
      g[FCA * m] = -0.5f * sum[kSdxx];
      g[FCB * m] = -sum[kSdxdy];
      g[FCC * m] = -0.5f * sum[kSdyy];
#pragma unroll
      for (int r = FOP; r < kGradRows; ++r) g[r * m] = sum[r];
    }
  }
  cp_async_wait<0>();  // no copy in flight when the block exits
}

}  // namespace

// feat: [16, m] float32 on the device; tile_starts: [grid_x*grid_y + 1]
// int32; out, dout: [grid_x*grid_y, 8, tile_x*tile_y] float32; grads:
// [16, m] float32, zeroed by the caller.  threads and smem_bytes come from
// ops/tile_kernels.py::launch_geometry; a launch that does not cover the
// tile returns cudaErrorInvalidValue without launching.  Launches on
// `stream` and returns the launch status (cudaError_t) without
// synchronising.
extern "C" int composite_bwd(const float* feat, int64_t m,
                             const int* tile_starts, const float* out,
                             const float* dout, float* grads, int grid_x,
                             int grid_y, int tile_x, int tile_y, int threads,
                             int smem_bytes, void* stream) {
  const int n_tiles = grid_x * grid_y;
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const int rows = (tile_y + kPixelsPerThread - 1) / kPixelsPerThread;
  const long need =
      (2L * kStageFloats + (threads / 32) * kPartStride * kBatch) *
      sizeof(float);
  if (threads % 32 != 0 || threads > kMaxThreads ||
      threads < tile_x * rows || smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_bwd_kernel<<<n_tiles, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      feat, m, tile_starts, out, dout, grads, grid_x, tile_x, tile_y);
  return static_cast<int>(cudaGetLastError());
}
