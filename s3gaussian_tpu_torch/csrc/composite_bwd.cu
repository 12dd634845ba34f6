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
// Design.  One block per tile, one thread per pixel (the block rounded up
// to whole warps).  Each thread walks its tile's pairs front to back and
// recomputes the transmittance T with the forward's arithmetic (the
// sequential product; test_T < 1e-4 => done; conic_power from
// composite_common.cuh), so a pair contributes here exactly when it did
// in the forward.  The five output channels collapse into one scalar
// state per pixel (tile_kernels.py:270-274): with d5 = (dout[0:4],
// -dout[4]) (the ones channel carries -d final_T), e = d5 . (rgb, depth,
// 1) for a pair and E_total = d5 . (out[0:4], 1 - out[4]), the running
// prefix = sum of w*e gives
//   d_alpha = e*T_excl - (E_total - prefix_incl) / (1 - alpha).
// Each pair's 10 gradient values are summed over the tile's pixels inside
// the block: a butterfly of warp shuffles, then per-warp partials in
// shared memory summed in warp order by one thread per (row, pair).  The
// order is fixed, so the result is the same from run to run, and every
// pair belongs to one tile, so each column is written once with no global
// atomics.  A warp in which no pixel contributes to a pair skips its
// reduction; a warp whose pixels are all saturated stops walking the batch;
// the block stops when every pixel is (the forward's whole-tile exit).
//
// The TPU kernel's boundary read-modify-write of shared blocks and its
// sequential grid (tile_kernels.py:346-378) exist because its blocks
// straddle tiles; here a block owns exactly its tile's pair range, so
// neither is needed.
//
// What bounds it on the card: the per-pair reductions (10 values x 5
// shuffle steps per warp and pair) and the per-pixel-pair arithmetic, not
// bytes (the stream read and the [16, M] gradient write are ~0.4 GB at
// the slice).  This first version is the simple, correct design; a
// cheaper reduction (transposed shuffles, fewer values per pair) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace s3g;

constexpr int kBatch = 64;     // pairs staged in shared memory at a time
constexpr int kGradRows = 10;  // x, y, conic a/b/c, opacity, r, g, b, depth
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void composite_bwd_kernel(const float* __restrict__ feat,
                                     int64_t m,
                                     const int* __restrict__ tile_starts,
                                     const float* __restrict__ out,
                                     const float* __restrict__ dout,
                                     float* __restrict__ grads, int grid_x,
                                     int tile_x, int tile_y) {
  extern __shared__ float smem[];
  const int p = tile_x * tile_y;
  const int nthreads = blockDim.x;  // p rounded up to a multiple of 32
  const int nwarps = nthreads / 32;
  float* batch = smem;                          // [kDataRows][kBatch]
  float* partial = smem + kDataRows * kBatch;   // [nwarps][kGradRows][kBatch]
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const bool pixel = i < p;
  const int start = tile_starts[tile];
  const int end = tile_starts[tile + 1];
  const float px = static_cast<float>((tile % grid_x) * tile_x + i % tile_x);
  const float py = static_cast<float>((tile / grid_x) * tile_y + i / tile_x);

  float d5[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float e_total = 0.0f;
  if (pixel) {
    const int64_t o = static_cast<int64_t>(tile) * kOutRows * p + i;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      d5[ch] = dout[o + ch * p];
      e_total += d5[ch] * out[o + ch * p];
    }
    d5[4] = -dout[o + 4 * p];
    e_total += d5[4] * (1.0f - out[o + 4 * p]);
  }

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = !pixel;

  for (int base = start; base < end; base += kBatch) {
    // whole-tile early exit; also the barrier before the shared buffers
    // of the previous batch are overwritten
    if (__syncthreads_count(done) == nthreads) break;
    const int n = min(kBatch, end - base);
    for (int idx = i; idx < kDataRows * kBatch; idx += nthreads) {
      const int row = idx / kBatch;
      const int k = idx - row * kBatch;
      batch[idx] = k < n ? feat[row * m + base + k] : 0.0f;
    }
    for (int idx = i; idx < nwarps * kGradRows * kBatch; idx += nthreads)
      partial[idx] = 0.0f;
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      if (__all_sync(kFull, done)) break;
      float v[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) v[r] = 0.0f;
      bool contrib = false;
      if (!done) {
        const float ca = batch[FCA * kBatch + k];
        const float cb = batch[FCB * kBatch + k];
        const float cc = batch[FCC * kBatch + k];
        const float op = batch[FOP * kBatch + k];
        const float dx = batch[FX * kBatch + k] - px;
        const float dy = batch[FY * kBatch + k] - py;
        const float power = conic_power(ca, cb, cc, dx, dy);
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha = fminf(kAlphaMax, op * G);
          if (alpha >= kAlphaMin) {
            const float test_T = T * (1.0f - alpha);
            if (test_T < kTEps) {
              done = true;
            } else {
              contrib = true;
              const float w = alpha * T;
              const float e = d5[0] * batch[FR * kBatch + k] +
                              d5[1] * batch[FG * kBatch + k] +
                              d5[2] * batch[FB * kBatch + k] +
                              d5[3] * batch[FD * kBatch + k] + d5[4];
              prefix += w * e;
              const float d_alpha =
                  e * T - (e_total - prefix) / (1.0f - alpha);
              const float d_power = op * d_alpha * G;
              v[FX] = d_power * (-ca * dx - cb * dy);
              v[FY] = d_power * (-cc * dy - cb * dx);
              v[FCA] = d_power * (-0.5f * dx * dx);
              v[FCB] = d_power * (-dx * dy);
              v[FCC] = d_power * (-0.5f * dy * dy);
              v[FOP] = G * d_alpha;
              v[FR] = w * d5[0];
              v[FG] = w * d5[1];
              v[FB] = w * d5[2];
              v[FD] = w * d5[3];
              T = test_T;
            }
          }
        }
      }
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) v[r] = warp_sum(v[r]);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kGradRows; ++r)
            partial[(warp * kGradRows + r) * kBatch + k] = v[r];
        }
      }
    }
    __syncthreads();

    // per-warp partials summed in warp order; each (row, pair) once
    for (int idx = i; idx < kGradRows * n; idx += nthreads) {
      const int r = idx / n;
      const int k = idx - r * n;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w)
        s += partial[(w * kGradRows + r) * kBatch + k];
      grads[r * m + base + k] = s;
    }
  }
}

}  // namespace

// feat: [16, m] float32 on the device; tile_starts: [grid_x*grid_y + 1]
// int32; out, dout: [grid_x*grid_y, 8, tile_x*tile_y] float32; grads:
// [16, m] float32, zeroed by the caller.  Launches on `stream` and returns
// the launch status (cudaError_t) without synchronising.
extern "C" int composite_bwd(const float* feat, int64_t m,
                             const int* tile_starts, const float* out,
                             const float* dout, float* grads, int grid_x,
                             int grid_y, int tile_x, int tile_y,
                             void* stream) {
  const int n_tiles = grid_x * grid_y;
  const int p = tile_x * tile_y;
  if (n_tiles <= 0) return static_cast<int>(cudaSuccess);
  const int nthreads = (p + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * (kDataRows + (nthreads / 32) * kGradRows) * kBatch;
  if (smem > 48 * 1024) {  // 82.5 KB at p = 1024
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  composite_bwd_kernel<<<n_tiles, nthreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      feat, m, tile_starts, out, dout, grads, grid_x, tile_x, tile_y);
  return static_cast<int>(cudaGetLastError());
}
