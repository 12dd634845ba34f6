// Definitions shared by the forward and backward tile compositors
// (composite_fwd.cu, composite_bwd.cu).
//
// Both kernels evaluate a pair's alpha with conic_power below, so a pair
// counts as contributing in the backward exactly when it did in the
// forward, and both match the plain PyTorch versions
// (s3gaussian_tpu_torch/ops/composite.py) op for op.
//
// The launch geometry (ops/tile_kernels.py::launch_geometry, mirrored by
// pixel_slot and kStageFloats here): a block per tile; thread t owns the
// kPixelsPerThread pixels of column t % tile_x in rows
// (t / tile_x) * kPixelsPerThread + s (slots past the tile's last row own
// no pixel), so a warp of a 16-wide tile covers a compact 16 x 4 block.
// Pair batches of kBatch are staged through a two-deep ring in shared
// memory filled with cp.async.

#pragma once

#include <stdint.h>

namespace s3g {

// rows of the feature-major [16, M] pair stream (ops/composite.py)
constexpr int FX = 0, FY = 1, FCA = 2, FCB = 3, FCC = 4, FOP = 5,
              FR = 6, FG = 7, FB = 8, FD = 9;
constexpr int kDataRows = 10;
constexpr int kAlphaRows = 6;        // x, y, conic a/b/c, opacity
constexpr int kOutRows = 8;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr int kMaxThreads = 512;     // __launch_bounds__ of both kernels
constexpr int kPixelsPerThread = 2;  // pixels of one column per thread
constexpr int kBatch = 128;          // pairs per ring stage
constexpr unsigned kFull = 0xffffffffu;

// The products of conic_power that depend on dx alone, computed once for
// the pixels of one column.
struct ConicDx {
  float qa;    // (ca * dx) * dx
  float cbdx;  // cb * dx
};

__device__ __forceinline__ ConicDx conic_dx(float ca, float cb, float dx) {
  return {__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(cb, dx)};
}

// -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy from conic_dx(ca, cb, dx),
// rounded op by op in the order the plain version computes it.  The _rn
// intrinsics are never contracted into FMAs, so alpha, and with it every
// skip and early-exit decision, is the same as the plain version's on the
// same inputs.
__device__ __forceinline__ float conic_power(ConicDx q, float cc, float dy) {
  const float qc = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float qb = __fmul_rn(q.cbdx, dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(q.qa, qc)), qb);
}

// The pixel (row-major index in the tile) of slot s of thread tid, or -1
// where the slot owns none.
__device__ __forceinline__ int pixel_slot(int tid, int s, int tile_x,
                                          int tile_y) {
  const int row = (tid / tile_x) * kPixelsPerThread + s;
  return row < tile_y ? row * tile_x + tid % tile_x : -1;
}

// One ring stage of a batch of kBatch pairs, in floats: the alpha rows
// x, y, ca, cb, cc, opacity as [6][kBatch] (read four pairs at a time as
// float4), then the colours pair-major as [kBatch][4] (r, g, b, depth:
// one float4 per pair).
constexpr int kStageFloats = kDataRows * kBatch;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 reads nothing and fills the 4 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of pairs [base, base + n) of the stream into one ring
// stage; slots k >= n are zero-filled, which every kernel loop skips
// (opacity 0 gives alpha 0 < kAlphaMin).  Coalesced: consecutive threads
// copy consecutive pairs of one row.
__device__ __forceinline__ void stage_batch(float* stage,
                                            const float* __restrict__ feat,
                                            int64_t m, int base, int n,
                                            int tid, int nthreads) {
  for (int idx = tid; idx < kStageFloats; idx += nthreads) {
    const int row = idx / kBatch;
    const int k = idx % kBatch;
    const bool valid = k < n;
    float* dst = row < kAlphaRows
                     ? stage + row * kBatch + k
                     : stage + kAlphaRows * kBatch + 4 * k + (row - kAlphaRows);
    cp_async4(dst, valid ? feat + row * m + base + k : feat, valid);
  }
}

}  // namespace s3g
