// Ordered segment sums for Hopper (sm_90a): the grid gradient of the
// deformation field's row gathers, with no atomics.
//
// Replaces the scatter-add that the JAX package leaves to XLA for the
// hexplane's plane gradients (autodiff of the gathers in
// s3gaussian_tpu/ops/gridsample.py, and the one-hot product of the time
// rows' VJP at :143-157); plain PyTorch version and oracle:
// s3gaussian_tpu_torch/ops/segsum.py::ranges_torch (one
// torch.segment_reduce); the caller, ops/gridsample.py::segment_sum,
// sorts the rows by cell and sums them in levels of ranges of at most 32
// rows.
//
// Semantics (identical to the plain version): out[p, c] = the sum, in
// row order from 0.0f, of vals[row(j), c] for j in [offs[p], offs[p+1]),
// where row(j) = perm[j], or j when perm is null.  Each output is written
// once by one lane, so the result is the same bits on every run.
//
// What bounds it: bytes (each value read once, 4 bytes an add), and the
// latency of the loads where a lane has few in flight.  The plain
// version's kernel (torch.segment_reduce) gives each (range, column) a
// thread that adds its rows one load after another; at the field's
// shapes (ranges of at most 32 rows, 32-64 columns) that ran at a few
// hundred GB/s, and its caller first gathered the rows into sorted order
// (one more pass).
//
// What the design does about it: a warp per range, a lane per column
// (up to kMaxCols columns a lane, strided by 32), so a row's columns are
// one coalesced read; the rows' loads are issued kUnroll at a time before
// any of them is added, so a lane keeps kUnroll loads in flight; the
// gather through perm is read in the same pass.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kUnroll = 8;
constexpr int kMaxCols = 4;                 // columns a lane: d <= 128
constexpr int kThreads = 256;

template <int COLS>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ offs, int64_t n_ranges, int d,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t p = (static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x) >> 5;
       p < n_ranges; p += warps) {
    const int64_t a = offs[p];
    const int64_t b = offs[p + 1];
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
    for (int64_t j0 = a; j0 < b; j0 += kUnroll) {
      float v[kUnroll][COLS];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + u;
        const bool in = j < b;
        const int64_t row = in ? (perm != nullptr ? perm[j] : j) : 0;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int col = lane + 32 * c;
          v[u][c] = (in && col < d) ? vals[row * d + col] : 0.0f;
        }
      }
      // in row order, as the plain version adds them
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u < b) {
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[c] += v[u][c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = lane + 32 * c;
      if (col < d) out[p * d + col] = acc[c];
    }
  }
}

}  // namespace

// vals [rows, d] float32 row-major; perm [n] int64 or null; offs
// [n_ranges + 1] int64 non-decreasing; out [n_ranges, d] float32.
// Returns a cudaError_t.
extern "C" int segment_sum(const float* vals, const int64_t* perm,
                           const int64_t* offs, int64_t n_ranges, int d,
                           float* out, void* stream) {
  if (n_ranges <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (d > 32 * kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n_ranges * 32 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 31) / 32) {
    case 1:
      segment_sum_kernel<1><<<blocks, kThreads, 0, s>>>(vals, perm, offs,
                                                        n_ranges, d, out);
      break;
    case 2:
      segment_sum_kernel<2><<<blocks, kThreads, 0, s>>>(vals, perm, offs,
                                                        n_ranges, d, out);
      break;
    case 3:
      segment_sum_kernel<3><<<blocks, kThreads, 0, s>>>(vals, perm, offs,
                                                        n_ranges, d, out);
      break;
    default:
      segment_sum_kernel<4><<<blocks, kThreads, 0, s>>>(vals, perm, offs,
                                                        n_ranges, d, out);
  }
  return static_cast<int>(cudaGetLastError());
}
