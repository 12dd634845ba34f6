// The rasterizer's per-Gaussian preprocessing and its backward, for Hopper
// (sm_90a): the world covariance from scale and quaternion, the EWA
// projection to pixel centre, depth, conic, radius and tile rectangle, and
// the view-dependent SH colour.
//
// Replaces no Pallas kernel: it fuses what the JAX package leaves to XLA in
// s3gaussian_tpu/ops/project.py (build_cov3d, project_gaussians,
// sh_to_color) and s3gaussian_tpu/ops/sh.py (eval_sh), and their VJPs,
// which the port ran as some 1,400 ATen kernels a pass.  The plain PyTorch
// version and oracle is the port's CPU path, ops/project.py
// (build_cov3d, project_gaussians, sh_to_color_plain).
//
// Semantics.  project_fwd is build_cov3d + project_gaussians of one row:
// every float32 operation of the plain path is one rounded __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn / __frcp_rn / __fsqrt_rn in the plain
// path's order, so nvcc's FMA contraction cannot change a bit.  Two
// reductions of the plain path are repeated as PyTorch runs them on the
// card (measured on an H100 with PyTorch 2.11 / CUDA 12.8 at 1,037 to
// 2,097,152 rows): cuBLAS's [N, 4] @ [4, 4] as the FMA chain
// fma(m2, M2k, fma(m1, M1k, m0·M0k)) + M3k, and torch.linalg.norm over
// four values as (r² + y²) + (x² + z²).  So xy, depth, conic, the tile
// rects, radii and visibility are the plain path's bits there (on another
// build of PyTorch they agree to rounding).  The camera's tan(fov/2) comes either as host
// values (focal and the 1.3·tan clamp bound computed in double, as the
// plain path's Python floats are) or as 0-d device tensors, read here
// (focal = reciprocal(2·tan)·size, bound = 1.3f·tan, as PyTorch evaluates
// the same expressions on a tensor).  project_bwd takes the cotangents of
// xy, depth and conic back to the means, the activated scales, the raw
// quaternions and the NDC tap; it recomputes the forward's intermediates
// from the inputs and is autograd's graph edge for edge: torch.clamp
// passes a gradient with its bound included, torch.where's branches
// (tz at depth 0.2, det == 0) keep theirs.  The radius, rects and
// visibility carry no gradient.
//
// sh_fwd is clamp_min(eval_sh(deg, sh, dir) + 0.5, 0) with dir the unit
// vector from the camera centre to the given position (its norm clamped
// at 1e-8); a degree held on the device (int32) masks the bands above it
// as ops/sh.py::eval_sh_dynamic does.  The forward follows eval_sh's
// order and torch.linalg.norm's on the card for the direction (so the
// colours are the plain path's bits there; on another build of PyTorch
// they agree to rounding).  sh_bwd writes the coefficients' and the
// positions' gradients.
//
// What bounds it on this card: bytes.  A row reads 12 B of position, 12
// of scale, 16 of quaternion (plus tap, alive and opacity) and writes 44
// in the projection; the SH colour reads 192 B of coefficients at degree
// 3.  At 2,097,152 rows every kernel's work is a fraction of a
// millisecond of DRAM time (chip_smoke.py's phase 3d prints each bound).
// What the design does about it: one thread a row, nothing saved for the
// backward but the inputs (the backward recomputes the forward in
// registers, where autograd saved the plain path's intermediates), the
// 192-B SH rows staged through shared memory with 16-B loads and stores so
// that a warp's accesses are coalesced (row stride padded to an odd count
// of floats: no bank conflicts when a thread reads its row), and no
// atomics: every output row is written by one thread, so a replay gives
// the same bits as an eager call.  Measured at 2,097,152 rows (phase 3d):
// each kernel at 0.72-0.78 of its DRAM bound.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;      // projection rows a block
constexpr int kShThreads = 128;    // SH rows a block

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float frcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ float fsqrt(float a) { return __fsqrt_rn(a); }
// torch.clamp and clamp_min: a NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// --- projection ----------------------------------------------------------

struct Camera {
  const float* view;  // [4, 4] row-vector world -> view
  const float* proj;  // [4, 4] row-vector world -> clip
  const float* tanx;  // 0-d device tensors, or null: focal/lim given
  const float* tany;
  float focal_x, focal_y, lim_x, lim_y;
  int width, height;
};

struct Fov {
  float fx, fy, lx, ly;
};

__device__ __forceinline__ Fov fov(const Camera& cam) {
  Fov f{cam.focal_x, cam.focal_y, cam.lim_x, cam.lim_y};
  if (cam.tanx != nullptr) {
    const float t = __ldg(cam.tanx);
    f.fx = fmul(frcp(fmul(2.0f, t)), static_cast<float>(cam.width));
    f.lx = fmul(1.3f, t);
  }
  if (cam.tany != nullptr) {
    const float t = __ldg(cam.tany);
    f.fy = fmul(frcp(fmul(2.0f, t)), static_cast<float>(cam.height));
    f.ly = fmul(1.3f, t);
  }
  return f;
}

// column k of [m, 1] @ M as cuBLAS computes it on the card: an FMA chain
// over the three coordinates, then the homogeneous row
__device__ __forceinline__ float affine(const float m[3], const float* M,
                                        int k) {
  return fadd(__fmaf_rn(m[2], __ldg(M + 8 + k),
                        __fmaf_rn(m[1], __ldg(M + 4 + k),
                                  fmul(m[0], __ldg(M + k)))),
              __ldg(M + 12 + k));
}

// The forward of one row up to the conic, every intermediate the backward
// needs kept.
struct Ewa {
  float pv[3];              // view-space position; pv[2] is the depth
  float ph0, ph1, pw;       // clip x, y and 1 / (w + 1e-7)
  float tz, iz, ux, uy, cx, cy, tx, ty;
  float j00, j02, j11, j12;
  float t0[3], t1[3];
  float nrm, q[4];          // the quaternion's norm, the quaternion normalised
  float R[9];               // row-major rotation
  float s[3], sq[3];        // the scale, its square
  float cov[6];             // xx, xy, xz, yy, yz, zz
  float a, b, c, det, inv_det;
};

__device__ __forceinline__ float quad(const float* C, const float u[3],
                                      const float v[3]) {
  const float r0 = fadd(fadd(fmul(C[0], v[0]), fmul(C[1], v[1])),
                        fmul(C[2], v[2]));
  const float r1 = fadd(fadd(fmul(C[1], v[0]), fmul(C[3], v[1])),
                        fmul(C[4], v[2]));
  const float r2 = fadd(fadd(fmul(C[2], v[0]), fmul(C[4], v[1])),
                        fmul(C[5], v[2]));
  return fadd(fadd(fmul(u[0], r0), fmul(u[1], r1)), fmul(u[2], r2));
}

__device__ __forceinline__ void ewa(const Camera& cam, const Fov& f,
                                    const float m[3], const float sc[3],
                                    const float rot[4], Ewa& e) {
#pragma unroll
  for (int k = 0; k < 3; ++k) e.pv[k] = affine(m, cam.view, k);
  e.ph0 = affine(m, cam.proj, 0);
  e.ph1 = affine(m, cam.proj, 1);
  e.pw = frcp(fadd(affine(m, cam.proj, 3), 1e-7f));

  const float depth = e.pv[2];
  e.tz = depth > 0.2f ? depth : 1.0f;
  e.ux = fdiv(e.pv[0], e.tz);
  e.uy = fdiv(e.pv[1], e.tz);
  e.cx = clampf(e.ux, -f.lx, f.lx);
  e.cy = clampf(e.uy, -f.ly, f.ly);
  e.tx = fmul(e.cx, e.tz);
  e.ty = fmul(e.cy, e.tz);
  e.iz = frcp(e.tz);
  e.j00 = fmul(f.fx, e.iz);
  e.j02 = fmul(fmul(fmul(-f.fx, e.tx), e.iz), e.iz);
  e.j11 = fmul(f.fy, e.iz);
  e.j12 = fmul(fmul(fmul(-f.fy, e.ty), e.iz), e.iz);
  // Rw2c[i][k] = view[k][i]
  const float* V = cam.view;
  for (int k = 0; k < 3; ++k) {
    e.t0[k] = fadd(fmul(e.j00, __ldg(V + 4 * k)),
                   fmul(e.j02, __ldg(V + 4 * k + 2)));
    e.t1[k] = fadd(fmul(e.j11, __ldg(V + 4 * k + 1)),
                   fmul(e.j12, __ldg(V + 4 * k + 2)));
  }

  // build_cov3d
  // (r² + y²) + (x² + z²): torch.linalg.norm's order over four values on
  // the card
  e.nrm = fsqrt(fadd(fadd(fmul(rot[0], rot[0]), fmul(rot[2], rot[2])),
                     fadd(fmul(rot[1], rot[1]), fmul(rot[3], rot[3]))));
  for (int i = 0; i < 4; ++i) e.q[i] = fdiv(rot[i], e.nrm);
  const float r = e.q[0], x = e.q[1], y = e.q[2], z = e.q[3];
  e.R[0] = fsub(1.0f, fmul(2.0f, fadd(fmul(y, y), fmul(z, z))));
  e.R[1] = fmul(2.0f, fsub(fmul(x, y), fmul(r, z)));
  e.R[2] = fmul(2.0f, fadd(fmul(x, z), fmul(r, y)));
  e.R[3] = fmul(2.0f, fadd(fmul(x, y), fmul(r, z)));
  e.R[4] = fsub(1.0f, fmul(2.0f, fadd(fmul(x, x), fmul(z, z))));
  e.R[5] = fmul(2.0f, fsub(fmul(y, z), fmul(r, x)));
  e.R[6] = fmul(2.0f, fsub(fmul(x, z), fmul(r, y)));
  e.R[7] = fmul(2.0f, fadd(fmul(y, z), fmul(r, x)));
  e.R[8] = fsub(1.0f, fmul(2.0f, fadd(fmul(x, x), fmul(y, y))));
  for (int j = 0; j < 3; ++j) {
    e.s[j] = sc[j];
    e.sq[j] = fmul(e.s[j], e.s[j]);
  }
  const int pi[6] = {0, 0, 0, 1, 1, 2}, pk[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const float* Ri = e.R + 3 * pi[p];
    const float* Rk = e.R + 3 * pk[p];
    e.cov[p] = fadd(fadd(fmul(fmul(e.sq[0], Ri[0]), Rk[0]),
                         fmul(fmul(e.sq[1], Ri[1]), Rk[1])),
                    fmul(fmul(e.sq[2], Ri[2]), Rk[2]));
  }

  e.a = fadd(quad(e.cov, e.t0, e.t0), 0.3f);
  e.c = fadd(quad(e.cov, e.t1, e.t1), 0.3f);
  e.b = quad(e.cov, e.t0, e.t1);
  e.det = fsub(fmul(e.a, e.c), fmul(e.b, e.b));
  e.inv_det = frcp(e.det == 0.0f ? 1.0f : e.det);
}

struct FwdArgs {
  const float* means;    // [n, 3]
  const float* scales;   // [n, 3], activated
  const float* rots;     // [n, 4], as given
  const float* tap;      // [n, 2] or null
  const uint8_t* alive;  // [n] bool or null
  const float* opac;     // [n] or null: the tight rect
  int tile_x, tile_y, grid_x, grid_y;
  float radius_margin;
  float* xy;             // [n, 2]
  float* depth;          // [n]
  float* conic;          // [n, 3]
  int* radius;           // [n]
  int4* rect;            // [n] (x0, y0, x1, y1)
  uint8_t* visible;      // [n] bool
};

// clamp(floor(v / size), 0, n) as int32; PyTorch divides a CUDA tensor by
// a Python number as a product with its float32 reciprocal
__device__ __forceinline__ int cell(float v, int n, float inv_size) {
  return static_cast<int>(clampf(floorf(fmul(v, inv_size)), 0.0f,
                                 static_cast<float>(n)));
}

__global__ void __launch_bounds__(kThreads)
    project_fwd_kernel(Camera cam, FwdArgs a, int64_t n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  const Fov f = fov(cam);
  float m[3], sc[3], rot[4];
  for (int k = 0; k < 3; ++k) {
    m[k] = __ldg(a.means + 3 * row + k);
    sc[k] = __ldg(a.scales + 3 * row + k);
  }
  const float4 r4 = __ldg(reinterpret_cast<const float4*>(a.rots) + row);
  rot[0] = r4.x; rot[1] = r4.y; rot[2] = r4.z; rot[3] = r4.w;
  Ewa e;
  ewa(cam, f, m, sc, rot, e);

  float ndc0 = fmul(e.ph0, e.pw), ndc1 = fmul(e.ph1, e.pw);
  if (a.tap != nullptr) {
    ndc0 = fadd(ndc0, __ldg(a.tap + 2 * row));
    ndc1 = fadd(ndc1, __ldg(a.tap + 2 * row + 1));
  }
  const float x = fmul(fsub(fmul(fadd(ndc0, 1.0f),
                                 static_cast<float>(cam.width)), 1.0f), 0.5f);
  const float y = fmul(fsub(fmul(fadd(ndc1, 1.0f),
                                 static_cast<float>(cam.height)), 1.0f), 0.5f);
  const float depth = e.pv[2];

  const float mid = fmul(0.5f, fadd(e.a, e.c));
  const float disc = fsqrt(clamp_min(fsub(fmul(mid, mid), e.det), 0.1f));
  const float lambda1 = fadd(mid, disc);
  const float r_f = ceilf(fmul(3.0f, fsqrt(clamp_min(lambda1, 1e-12f))));

  const float margin = a.radius_margin;
  const float ix = fdiv(1.0f, static_cast<float>(a.tile_x));
  const float iy = fdiv(1.0f, static_cast<float>(a.tile_y));
  const float txf = static_cast<float>(a.tile_x);
  const float tyf = static_cast<float>(a.tile_y);
  float rx, ry;
  if (a.opac != nullptr) {
    const float op = clamp_min(__ldg(a.opac + row), 1e-9f);
    const float q_cut = clamp_min(fmul(2.0f, logf(fmul(op, 255.0f))), 0.0f);
    rx = ceilf(fsqrt(fmul(q_cut, clamp_min(e.a, 0.0f))));
    ry = ceilf(fsqrt(fmul(q_cut, clamp_min(e.c, 0.0f))));
  } else {
    rx = ry = r_f;
  }
  rx = fadd(rx, margin);
  ry = fadd(ry, margin);
  const int x0 = cell(fsub(x, rx), a.grid_x, ix);
  const int y0 = cell(fsub(y, ry), a.grid_y, iy);
  const int x1 = cell(fsub(fadd(fadd(x, rx), txf), 1.0f), a.grid_x, ix);
  const int y1 = cell(fsub(fadd(fadd(y, ry), tyf), 1.0f), a.grid_y, iy);
  int vx0 = x0, vy0 = y0, vx1 = x1, vy1 = y1;
  if (a.opac != nullptr) {
    const float rc = fadd(r_f, margin);
    vx0 = cell(fsub(x, rc), a.grid_x, ix);
    vy0 = cell(fsub(y, rc), a.grid_y, iy);
    vx1 = cell(fsub(fadd(fadd(x, rc), txf), 1.0f), a.grid_x, ix);
    vy1 = cell(fsub(fadd(fadd(y, rc), tyf), 1.0f), a.grid_y, iy);
  }
  bool vis = depth > 0.2f && e.det > 0.0f && (vx1 - vx0) * (vy1 - vy0) > 0;
  if (a.alive != nullptr) vis = vis && a.alive[row] != 0;

  reinterpret_cast<float2*>(a.xy)[row] = make_float2(x, y);
  a.depth[row] = depth;
  a.conic[3 * row] = fmul(e.c, e.inv_det);
  a.conic[3 * row + 1] = fmul(-e.b, e.inv_det);
  a.conic[3 * row + 2] = fmul(e.a, e.inv_det);
  a.radius[row] = vis ? static_cast<int>(r_f) : 0;
  a.rect[row] = make_int4(x0, y0, x1, y1);
  a.visible[row] = vis ? 1 : 0;
}

struct BwdArgs {
  const float* means;
  const float* scales;
  const float* rots;
  const float* g_xy;     // [n, 2] or null
  const float* g_depth;  // [n] or null
  const float* g_conic;  // [n, 3] or null
  float* d_means;        // [n, 3] or null
  float* d_scales;       // [n, 3] or null
  float* d_rots;         // [n, 4] or null
  float* d_tap;          // [n, 2] or null
};

__global__ void __launch_bounds__(kThreads)
    project_bwd_kernel(Camera cam, BwdArgs a, int64_t n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= n) return;
  const Fov f = fov(cam);
  float m[3], sc[3], rot[4];
  for (int k = 0; k < 3; ++k) {
    m[k] = __ldg(a.means + 3 * row + k);
    sc[k] = __ldg(a.scales + 3 * row + k);
  }
  const float4 r4 = __ldg(reinterpret_cast<const float4*>(a.rots) + row);
  rot[0] = r4.x; rot[1] = r4.y; rot[2] = r4.z; rot[3] = r4.w;
  Ewa e;
  ewa(cam, f, m, sc, rot, e);

  const float gx = a.g_xy ? __ldg(a.g_xy + 2 * row) : 0.0f;
  const float gy = a.g_xy ? __ldg(a.g_xy + 2 * row + 1) : 0.0f;
  const float gd = a.g_depth ? __ldg(a.g_depth + row) : 0.0f;
  float gk[3] = {0.0f, 0.0f, 0.0f};
  if (a.g_conic) {
    for (int k = 0; k < 3; ++k) gk[k] = __ldg(a.g_conic + 3 * row + k);
  }

  // conic = (c, -b, a) / det_safe
  float ga = gk[2] * e.inv_det;
  float gb = -gk[1] * e.inv_det;
  float gc = gk[0] * e.inv_det;
  const float g_inv = gk[0] * e.c - gk[1] * e.b + gk[2] * e.a;
  const float g_det = e.det == 0.0f ? 0.0f : -g_inv * e.inv_det * e.inv_det;
  ga += g_det * e.c;
  gc += g_det * e.a;
  gb -= 2.0f * e.b * g_det;

  // a = t0' C t0 + 0.3, c = t1' C t1 + 0.3, b = t0' C t1
  const float* C = e.cov;
  float ct0[3], ct1[3];
  const float Cf[9] = {C[0], C[1], C[2], C[1], C[3], C[4], C[2], C[4], C[5]};
  for (int i = 0; i < 3; ++i) {
    ct0[i] = Cf[3 * i] * e.t0[0] + Cf[3 * i + 1] * e.t0[1] +
             Cf[3 * i + 2] * e.t0[2];
    ct1[i] = Cf[3 * i] * e.t1[0] + Cf[3 * i + 1] * e.t1[1] +
             Cf[3 * i + 2] * e.t1[2];
  }
  float gt0[3], gt1[3];
  for (int i = 0; i < 3; ++i) {
    gt0[i] = 2.0f * ga * ct0[i] + gb * ct1[i];
    gt1[i] = 2.0f * gc * ct1[i] + gb * ct0[i];
  }
  float dcov[6];
  {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pk[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int i = pi[p], k = pk[p];
      if (i == k) {
        dcov[p] = ga * e.t0[i] * e.t0[i] + gc * e.t1[i] * e.t1[i] +
                  gb * e.t0[i] * e.t1[i];
      } else {
        dcov[p] = 2.0f * ga * e.t0[i] * e.t0[k] +
                  2.0f * gc * e.t1[i] * e.t1[k] +
                  gb * (e.t0[i] * e.t1[k] + e.t0[k] * e.t1[i]);
      }
    }
  }

  // t0_k = j00 Rw2c[0][k] + j02 Rw2c[2][k], t1_k = j11 Rw2c[1][k] + j12 ..
  const float* V = cam.view;
  float gj00 = 0.0f, gj02 = 0.0f, gj11 = 0.0f, gj12 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    gj00 += gt0[k] * __ldg(V + 4 * k);
    gj02 += gt0[k] * __ldg(V + 4 * k + 2);
    gj11 += gt1[k] * __ldg(V + 4 * k + 1);
    gj12 += gt1[k] * __ldg(V + 4 * k + 2);
  }
  const float iz2 = e.iz * e.iz;
  float g_iz = gj00 * f.fx + gj11 * f.fy;
  const float g_tx = gj02 * -f.fx * iz2;
  const float g_ty = gj12 * -f.fy * iz2;
  g_iz += gj02 * 2.0f * (-f.fx * e.tx) * e.iz +
          gj12 * 2.0f * (-f.fy * e.ty) * e.iz;
  float g_tz = -g_iz * iz2;
  // tx = clamp(ux, -lim, lim) · tz, ux = pv0 / tz
  g_tz += g_tx * e.cx + g_ty * e.cy;
  const float g_ux = (e.ux >= -f.lx && e.ux <= f.lx) ? g_tx * e.tz : 0.0f;
  const float g_uy = (e.uy >= -f.ly && e.uy <= f.ly) ? g_ty * e.tz : 0.0f;
  float g_pv[3];
  g_pv[0] = g_ux / e.tz;
  g_pv[1] = g_uy / e.tz;
  g_tz -= g_ux * e.pv[0] / (e.tz * e.tz) + g_uy * e.pv[1] / (e.tz * e.tz);
  g_pv[2] = gd + (e.pv[2] > 0.2f ? g_tz : 0.0f);

  // xy = ((ndc + 1) · size - 1) / 2, ndc = clip · pw (+ tap)
  const float g_n0 = gx * static_cast<float>(cam.width) * 0.5f;
  const float g_n1 = gy * static_cast<float>(cam.height) * 0.5f;
  if (a.d_tap != nullptr) {
    reinterpret_cast<float2*>(a.d_tap)[row] = make_float2(g_n0, g_n1);
  }
  const float g_ph0 = g_n0 * e.pw, g_ph1 = g_n1 * e.pw;
  const float g_pw = g_n0 * e.ph0 + g_n1 * e.ph1;
  const float g_ph3 = -g_pw * e.pw * e.pw;
  if (a.d_means != nullptr) {
    const float* P = cam.proj;
    for (int i = 0; i < 3; ++i) {
      a.d_means[3 * row + i] =
          g_pv[0] * __ldg(V + 4 * i) + g_pv[1] * __ldg(V + 4 * i + 1) +
          g_pv[2] * __ldg(V + 4 * i + 2) + g_ph0 * __ldg(P + 4 * i) +
          g_ph1 * __ldg(P + 4 * i + 1) + g_ph3 * __ldg(P + 4 * i + 3);
    }
  }

  // cov_ik = sum_j sq_j R_ij R_kj; D the symmetric cotangent with the
  // diagonal doubled
  const float D[9] = {2.0f * dcov[0], dcov[1], dcov[2],
                      dcov[1], 2.0f * dcov[3], dcov[4],
                      dcov[2], dcov[4], 2.0f * dcov[5]};
  const float* R = e.R;
  if (a.d_scales != nullptr) {
    for (int j = 0; j < 3; ++j) {
      float g_sq = 0.0f;
      const int pi[6] = {0, 0, 0, 1, 1, 2}, pk[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        g_sq += dcov[p] * R[3 * pi[p] + j] * R[3 * pk[p] + j];
      }
      a.d_scales[3 * row + j] = g_sq * 2.0f * e.s[j];
    }
  }
  if (a.d_rots != nullptr) {
    float G[9];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        G[3 * i + j] = e.sq[j] * (D[3 * i] * R[j] + D[3 * i + 1] * R[3 + j] +
                                  D[3 * i + 2] * R[6 + j]);
      }
    }
    const float r = e.q[0], x = e.q[1], y = e.q[2], z = e.q[3];
    float dq[4];
    dq[0] = 2.0f * (-z * G[1] + y * G[2] + z * G[3] - x * G[5] - y * G[6] +
                    x * G[7]);
    dq[1] = 2.0f * (y * G[1] + z * G[2] + y * G[3] - 2.0f * x * G[4] -
                    r * G[5] + z * G[6] + r * G[7] - 2.0f * x * G[8]);
    dq[2] = 2.0f * (-2.0f * y * G[0] + x * G[1] + r * G[2] + x * G[3] +
                    z * G[5] - r * G[6] + z * G[7] - 2.0f * y * G[8]);
    dq[3] = 2.0f * (-2.0f * z * G[0] - r * G[1] + x * G[2] + r * G[3] -
                    2.0f * z * G[4] + y * G[5] + x * G[6] + y * G[7]);
    // q = raw / |raw|
    const float qd = r * dq[0] + x * dq[1] + y * dq[2] + z * dq[3];
    float4 out;
    out.x = (dq[0] - r * qd) / e.nrm;
    out.y = (dq[1] - x * qd) / e.nrm;
    out.z = (dq[2] - y * qd) / e.nrm;
    out.w = (dq[3] - z * qd) / e.nrm;
    reinterpret_cast<float4*>(a.d_rots)[row] = out;
  }
}

// --- SH colour -----------------------------------------------------------

constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

// The rows [row0, row0 + rows) of a [n, L] float array staged into (or
// out of) shared memory at an odd row stride S, with 16-byte global
// accesses where they stay inside the block's rows.
template <int L, int S>
__device__ __forceinline__ void stage_in(const float* g, int rows,
                                         float* tile) {
  const int total = rows * L;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
    const float4 v = __ldcs(g4 + i);
    const float vs[4] = {v.x, v.y, v.z, v.w};
    for (int j = 0; j < 4; ++j) {
      const int el = 4 * i + j;
      tile[(el / L) * S + el % L] = vs[j];
    }
  }
  for (int el = (total / 4) * 4 + threadIdx.x; el < total; el += blockDim.x) {
    tile[(el / L) * S + el % L] = g[el];
  }
}

template <int L, int S>
__device__ __forceinline__ void stage_out(const float* tile, int rows,
                                          float* g) {
  const int total = rows * L;
  float4* g4 = reinterpret_cast<float4*>(g);
  for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
    float vs[4];
    for (int j = 0; j < 4; ++j) {
      const int el = 4 * i + j;
      vs[j] = tile[(el / L) * S + el % L];
    }
    __stcs(g4 + i, make_float4(vs[0], vs[1], vs[2], vs[3]));
  }
  for (int el = (total / 4) * 4 + threadIdx.x; el < total; el += blockDim.x) {
    g[el] = tile[(el / L) * S + el % L];
  }
}

// The 16 basis functions of eval_sh at a unit direction, each the factor
// the plain path multiplies its coefficient by (its sign included), and
// their gradients with respect to the direction.
struct Basis {
  float v[16];
};

__device__ __forceinline__ void basis(float x, float y, float z, Basis& b) {
  const float xx = fmul(x, x), yy = fmul(y, y), zz = fmul(z, z);
  const float xy = fmul(x, y), yz = fmul(y, z), xz = fmul(x, z);
  b.v[0] = C0;
  b.v[1] = -fmul(C1, y);
  b.v[2] = fmul(C1, z);
  b.v[3] = -fmul(C1, x);
  b.v[4] = fmul(C2_0, xy);
  b.v[5] = fmul(C2_1, yz);
  b.v[6] = fmul(C2_2, fsub(fsub(fmul(2.0f, zz), xx), yy));
  b.v[7] = fmul(C2_3, xz);
  b.v[8] = fmul(C2_4, fsub(xx, yy));
  b.v[9] = fmul(fmul(C3_0, y), fsub(fmul(3.0f, xx), yy));
  b.v[10] = fmul(fmul(C3_1, xy), z);
  b.v[11] = fmul(fmul(C3_2, y), fsub(fsub(fmul(4.0f, zz), xx), yy));
  b.v[12] = fmul(fmul(C3_3, z),
                 fsub(fsub(fmul(2.0f, zz), fmul(3.0f, xx)), fmul(3.0f, yy)));
  b.v[13] = fmul(fmul(C3_4, x), fsub(fsub(fmul(4.0f, zz), xx), yy));
  b.v[14] = fmul(fmul(C3_5, z), fsub(xx, yy));
  b.v[15] = fmul(fmul(C3_6, x), fsub(xx, fmul(3.0f, yy)));
}

__device__ __forceinline__ void basis_grad(float x, float y, float z, int k,
                                           float g[3]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  switch (k) {
    case 1: g[0] = 0.0f; g[1] = -C1; g[2] = 0.0f; break;
    case 2: g[0] = 0.0f; g[1] = 0.0f; g[2] = C1; break;
    case 3: g[0] = -C1; g[1] = 0.0f; g[2] = 0.0f; break;
    case 4: g[0] = C2_0 * y; g[1] = C2_0 * x; g[2] = 0.0f; break;
    case 5: g[0] = 0.0f; g[1] = C2_1 * z; g[2] = C2_1 * y; break;
    case 6:
      g[0] = -2.0f * C2_2 * x; g[1] = -2.0f * C2_2 * y; g[2] = 4.0f * C2_2 * z;
      break;
    case 7: g[0] = C2_3 * z; g[1] = 0.0f; g[2] = C2_3 * x; break;
    case 8: g[0] = 2.0f * C2_4 * x; g[1] = -2.0f * C2_4 * y; g[2] = 0.0f; break;
    case 9:
      g[0] = C3_0 * 6.0f * x * y; g[1] = C3_0 * (3.0f * xx - 3.0f * yy);
      g[2] = 0.0f;
      break;
    case 10:
      g[0] = C3_1 * y * z; g[1] = C3_1 * x * z; g[2] = C3_1 * x * y;
      break;
    case 11:
      g[0] = C3_2 * -2.0f * x * y; g[1] = C3_2 * (4.0f * zz - xx - 3.0f * yy);
      g[2] = C3_2 * 8.0f * y * z;
      break;
    case 12:
      g[0] = C3_3 * -6.0f * x * z; g[1] = C3_3 * -6.0f * y * z;
      g[2] = C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      break;
    case 13:
      g[0] = C3_4 * (4.0f * zz - 3.0f * xx - yy); g[1] = C3_4 * -2.0f * x * y;
      g[2] = C3_4 * 8.0f * x * z;
      break;
    case 14:
      g[0] = C3_5 * 2.0f * x * z; g[1] = C3_5 * -2.0f * y * z;
      g[2] = C3_5 * (xx - yy);
      break;
    case 15:
      g[0] = C3_6 * (3.0f * xx - 3.0f * yy); g[1] = C3_6 * -6.0f * x * y;
      g[2] = 0.0f;
      break;
    default: g[0] = g[1] = g[2] = 0.0f;
  }
}

__device__ __forceinline__ int band(int k) {
  return k < 1 ? 0 : k < 4 ? 1 : k < 9 ? 2 : 3;
}

// The degree a launch evaluates (eval) and the bands it keeps (keep): a
// host degree evaluates its own bands; a device degree (eval_sh_dynamic)
// evaluates every band of the coefficients and masks those above it.
struct Degree {
  int eval, keep;
  bool masked;
};

__device__ __forceinline__ Degree degree(int deg_val, const int* deg_ptr,
                                         int max_deg) {
  if (deg_ptr == nullptr) return Degree{deg_val, deg_val, false};
  return Degree{max_deg, __ldg(deg_ptr), true};
}

struct Dir {
  float d[3];        // camera centre -> position, unnormalised
  float n, nc;       // its norm, clamped at 1e-8
  float u[3];        // the unit direction
};

__device__ __forceinline__ void view_dir(const float* means,
                                         const float* campos, int64_t row,
                                         Dir& v) {
  for (int k = 0; k < 3; ++k) {
    v.d[k] = fsub(__ldg(means + 3 * row + k), __ldg(campos + k));
  }
  // (x² + z²) + y²: torch.linalg.norm's order over three values on the
  // card, so the colours are the plain path's bits there
  v.n = fsqrt(fadd(fadd(fmul(v.d[0], v.d[0]), fmul(v.d[2], v.d[2])),
                   fmul(v.d[1], v.d[1])));
  v.nc = clamp_min(v.n, 1e-8f);
  for (int k = 0; k < 3; ++k) v.u[k] = fdiv(v.d[k], v.nc);
}

// eval_sh's sum for channel ch in its order, the coefficients of bands
// above deg.keep multiplied by 0 where the degree is masked
template <int K>
__device__ __forceinline__ float sh_sum(const float* row, int ch,
                                        const Basis& b, const Degree& deg) {
  float res = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int bk = band(k);
    if (bk > deg.eval) break;
    float coef = row[3 * k + ch];
    if (deg.masked) coef = fmul(coef, bk <= deg.keep ? 1.0f : 0.0f);
    if (k == 0) {
      res = fmul(b.v[0], coef);
    } else if (k == 1 || k == 3) {
      // result - C1·y·sh1, result - C1·x·sh3
      res = fsub(res, fmul(-b.v[k], coef));
    } else {
      res = fadd(res, fmul(b.v[k], coef));
    }
  }
  return res;
}

template <int K>
__global__ void __launch_bounds__(kShThreads)
    sh_fwd_kernel(const float* __restrict__ shs,
                  const float* __restrict__ means,
                  const float* __restrict__ campos, int64_t n, int deg_val,
                  const int* __restrict__ deg_ptr, int max_deg,
                  float* __restrict__ out) {
  constexpr int L = 3 * K;
  constexpr int S = L | 1;
  __shared__ float tile[kShThreads * S];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kShThreads;
  const int rows = n - row0 < kShThreads ? static_cast<int>(n - row0)
                                         : kShThreads;
  stage_in<L, S>(shs + row0 * L, rows, tile);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const int64_t row = row0 + threadIdx.x;
  const Degree deg = degree(deg_val, deg_ptr, max_deg);
  Dir v;
  view_dir(means, campos, row, v);
  Basis b;
  basis(v.u[0], v.u[1], v.u[2], b);
  const float* mine = tile + threadIdx.x * S;
  for (int ch = 0; ch < 3; ++ch) {
    out[3 * row + ch] = clamp_min(fadd(sh_sum<K>(mine, ch, b, deg), 0.5f),
                                  0.0f);
  }
}

template <int K>
__global__ void __launch_bounds__(kShThreads)
    sh_bwd_kernel(const float* __restrict__ shs,
                  const float* __restrict__ means,
                  const float* __restrict__ campos, int64_t n, int deg_val,
                  const int* __restrict__ deg_ptr, int max_deg,
                  const float* __restrict__ g_out, float* __restrict__ d_shs,
                  float* __restrict__ d_means) {
  constexpr int L = 3 * K;
  constexpr int S = L | 1;
  __shared__ float tile[kShThreads * S];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kShThreads;
  const int rows = n - row0 < kShThreads ? static_cast<int>(n - row0)
                                         : kShThreads;
  stage_in<L, S>(shs + row0 * L, rows, tile);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows) {
    const int64_t row = row0 + threadIdx.x;
    const Degree deg = degree(deg_val, deg_ptr, max_deg);
    Dir v;
    view_dir(means, campos, row, v);
    Basis b;
    basis(v.u[0], v.u[1], v.u[2], b);
    float* mine = tile + threadIdx.x * S;
    float g_rgb[3];
    for (int ch = 0; ch < 3; ++ch) {
      const float res = sh_sum<K>(mine, ch, b, deg);
      // clamp_min passes the gradient where rgb + 0.5 >= 0
      g_rgb[ch] = fadd(res, 0.5f) >= 0.0f ? __ldg(g_out + 3 * row + ch)
                                          : 0.0f;
    }
    float g_u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int bk = band(k);
      const bool used = bk <= deg.eval && (!deg.masked || bk <= deg.keep);
      if (used && k > 0) {
        float gb[3];
        basis_grad(v.u[0], v.u[1], v.u[2], k, gb);
        const float s = g_rgb[0] * mine[3 * k] + g_rgb[1] * mine[3 * k + 1] +
                        g_rgb[2] * mine[3 * k + 2];
        for (int i = 0; i < 3; ++i) g_u[i] += s * gb[i];
      }
      // the row's own slots, read above, now take its gradient
      for (int ch = 0; ch < 3; ++ch) {
        mine[3 * k + ch] = used ? g_rgb[ch] * b.v[k] : 0.0f;
      }
    }
    if (d_means != nullptr) {
      // u = d / max(|d|, 1e-8); the norm's gradient only where unclamped
      const float dot = g_u[0] * v.d[0] + g_u[1] * v.d[1] + g_u[2] * v.d[2];
      const float g_nc = -dot / (v.nc * v.nc);
      const float g_n = v.n >= 1e-8f ? g_nc : 0.0f;
      for (int i = 0; i < 3; ++i) {
        float g = g_u[i] / v.nc;
        if (v.n > 0.0f) g += g_n * v.d[i] / v.n;
        d_means[3 * row + i] = g;
      }
    }
  }
  __syncthreads();
  stage_out<L, S>(tile, rows, d_shs + row0 * L);
}

int blocks_for(int64_t n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int project_fwd(const float* means, const float* scales,
                           const float* rots, const float* tap,
                           const uint8_t* alive, const float* opac,
                           const float* view, const float* proj,
                           const float* tanx, const float* tany,
                           float focal_x, float focal_y, float lim_x,
                           float lim_y, int64_t n, int width, int height,
                           int tile_x, int tile_y, float radius_margin,
                           float* xy, float* depth,
                           float* conic, int* radius, int* rect,
                           uint8_t* visible, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Camera cam{view, proj, tanx, tany, focal_x, focal_y, lim_x, lim_y,
             width, height};
  FwdArgs a{means, scales, rots, tap, alive, opac, tile_x, tile_y,
            (width + tile_x - 1) / tile_x, (height + tile_y - 1) / tile_y,
            radius_margin, xy, depth, conic, radius,
            reinterpret_cast<int4*>(rect), visible};
  project_fwd_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(cam, a, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int project_bwd(const float* means, const float* scales,
                           const float* rots, const float* view,
                           const float* proj, const float* tanx,
                           const float* tany, float focal_x, float focal_y,
                           float lim_x, float lim_y, int64_t n, int width,
                           int height, const float* g_xy,
                           const float* g_depth, const float* g_conic,
                           float* d_means, float* d_scales, float* d_rots,
                           float* d_tap, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Camera cam{view, proj, tanx, tany, focal_x, focal_y, lim_x, lim_y,
             width, height};
  BwdArgs a{means, scales, rots, g_xy, g_depth, g_conic,
            d_means, d_scales, d_rots, d_tap};
  project_bwd_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(cam, a, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sh_fwd(const float* shs, int k, const float* means,
                      const float* campos, int64_t n, int deg_val,
                      const int* deg_ptr, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n, kShThreads);
  switch (k) {
    case 1: sh_fwd_kernel<1><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 0, out); break;
    case 4: sh_fwd_kernel<4><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 1, out); break;
    case 9: sh_fwd_kernel<9><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 2, out); break;
    case 16: sh_fwd_kernel<16><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 3, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sh_bwd(const float* shs, int k, const float* means,
                      const float* campos, int64_t n, int deg_val,
                      const int* deg_ptr, const float* g_out, float* d_shs,
                      float* d_means, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n, kShThreads);
  switch (k) {
    case 1: sh_bwd_kernel<1><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 0, g_out, d_shs, d_means);
      break;
    case 4: sh_bwd_kernel<4><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 1, g_out, d_shs, d_means);
      break;
    case 9: sh_bwd_kernel<9><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 2, g_out, d_shs, d_means);
      break;
    case 16: sh_bwd_kernel<16><<<blocks, kShThreads, 0, st>>>(
        shs, means, campos, n, deg_val, deg_ptr, 3, g_out, d_shs, d_means);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
