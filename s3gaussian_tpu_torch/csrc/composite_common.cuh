// Definitions shared by the forward and backward tile compositors
// (composite_fwd.cu, composite_bwd.cu).
//
// Both kernels evaluate a pair's alpha with conic_power below, so a pair
// counts as contributing in the backward exactly when it did in the
// forward, and both match the plain PyTorch versions
// (s3gaussian_tpu_torch/ops/composite.py) op for op.

#pragma once

namespace s3g {

// rows of the feature-major [16, M] pair stream (ops/composite.py)
constexpr int FX = 0, FY = 1, FCA = 2, FCB = 3, FCC = 4, FOP = 5,
              FR = 6, FG = 7, FB = 8, FD = 9;
constexpr int kDataRows = 10;
constexpr int kOutRows = 8;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// -0.5 * (ca*dx*dx + cc*dy*dy) - cb*dx*dy, rounded op by op in the order
// the plain version computes it.  The _rn intrinsics are never contracted
// into FMAs, so alpha, and with it every skip and early-exit decision,
// is the same as the plain version's on the same inputs.
__device__ __forceinline__ float conic_power(float ca, float cb, float cc,
                                             float dx, float dy) {
  const float qa = __fmul_rn(__fmul_rn(ca, dx), dx);
  const float qc = __fmul_rn(__fmul_rn(cc, dy), dy);
  const float qb = __fmul_rn(__fmul_rn(cb, dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
}

}  // namespace s3g
