// The hexplane query of the deformation field and its backward, fused,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it fuses what the JAX package leaves to XLA
// in s3gaussian_tpu/models/hexplane.py::query_hexplane and
// s3gaussian_tpu/ops/gridsample.py (the bilinear samples of the three
// spatial planes a scale, the lerps of the three time planes' pair rows,
// the product of the six, and their VJPs).  The plain PyTorch version and
// oracle is the port's CPU path, models/hexplane.py::query_hexplane over
// ops/gridsample.py (grid_sample_2d, sample_time_plane).
//
// Semantics (identical to the plain version, bit for bit): per row, the
// coordinates x [3] (already normalised by the aabb); per scale the six
// planes in COO_COMBS order, (0,1) (0,2) (0,3) (1,2) (1,3) (2,3), those
// with a 3 (time) folded at the scalar t into pair rows [W, 2C] by the
// caller.  A spatial plane [H, W, C] (channel-last, in the grid's compute
// dtype) is sampled at (x[c0] -> W, x[c1] -> H), align_corners with
// border clamping: u = clamp((v + 1) * 0.5 * (n - 1), 0, n - 1), the
// corners floor(u) and min(floor(u) + 1, n - 1), weight u - floor(u), the
// value (1-wy)*((1-wx)*v00 + wx*v01) + wy*((1-wx)*v10 + wx*v11) in
// float32 from the grid-dtype corners; a time plane's pair row at
// floor(u) of x[c0] lerped as (1-wx)*lo + wx*hi.  The scale's feature is
// ((((v0*v1)*v2)*v3)*v4)*v5.  Every float32 operation is one rounded
// __fadd_rn / __fsub_rn / __fmul_rn in the plain version's order, so
// nvcc's FMA contraction cannot change a bit.
//
// The backward (one launch a scale) recomputes the scale's six samples
// and writes autograd's cotangents: d v_k = d acc_k * acc_{k-1}, d
// acc_{k-1} = d acc_k * v_k; a spatial plane's four corners ds*(1-wx),
// ds*wx with ds0 = dv*(1-wy), ds1 = dv*wy, rounded to the grid's dtype and
// stored as float32 corner-major [4N, C] beside their int32 cell keys
// [4N]; a time plane's pair (1-wx)*dv, wx*dv rounded the same way, [N,
// 2C], beside its int32 row keys [N].  The caller sums them by key with
// ops/gridsample.py::segment_sum, as the plain version does.  The
// coordinate gradient (clamp's mask, the axis scale) is summed over the
// channels by warp shuffles in a fixed butterfly order and added over the
// scales into dx [N, 3]; it is the one output that differs from the plain
// version's rounding (autograd sums the channels in another order).
//
// What bounds it on this card: bytes.  The work has to move through the
// device memory each row's coordinates (12 B), the forward's features
// (0.5 KB over 4 scales of 32 channels), the backward's cotangent and the
// cotangents and keys it writes (2.5 KB a row a scale), and the laid-out
// planes once (67 MB for the default field in bfloat16); chip_smoke.py's
// phase 3c takes that traffic at the device memory's rate as the bound.
// The gathers read far more, 12 corners of C grid values and 3 pair rows
// of 2C a scale (4.6 KB a row over 4 scales), but mostly from L2: the
// coarse scales' planes (0.8-13 MB for three) fit in the 50 MB L2 and the
// finest scale's (3 x 17 MB) nearly.  Phase 3c prints them at the device
// memory's rate as a ceiling, not a bound.  At 2.1 M rows the forward
// runs at 0.09 of its bound (the gathers' latency, not bytes, sets its
// time), the backward at 0.48.
//
// What the design does about it: a warp per row, a lane per channel, so
// one corner's C channels are one coalesced read (64 bytes in bfloat16,
// channel-last planes) and the corner cotangents one coalesced write; a
// scale's 15 gathers are issued before any is used.  The backward keeps
// of each sample only its weights, value and the coordinate gradient's
// two factors (80 registers, 3 blocks of 8 warps an SM; keeping the
// gathered values took 92, 2 blocks, and 18% more time), and writes its
// cotangents with streaming stores (the sort reads them once, later; 3%
// less time).  Nothing per row is saved for the backward: recomputing
// the samples reads about a third of what saving the gathered values
// and partial products would write and read again (autograd saved ~1.6
// GB a spatial plane at 2.1 M rows).  No atomics: every output is
// written once, by one lane, so a replay gives the same bits as an eager
// call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPlanes = 6;        // a scale's planes, COO_COMBS order
constexpr int kMaxScales = 8;
constexpr int kMaxChannels = 32;  // a lane a channel
constexpr int kThreads = 256;     // 8 warps, a row each
// the coordinate each plane's W axis (c0) and H axis (c1) reads; planes
// 2, 4 and 5 pair c0 with time
__host__ __device__ constexpr int c0(int i) {
  return i < 3 ? 0 : i < 5 ? 1 : 2;
}
__host__ __device__ constexpr int c1(int i) {
  return i == 0 ? 1 : (i == 1 || i == 3) ? 2 : 3;
}
__host__ __device__ constexpr bool is_time(int i) {
  return i == 2 || i == 4 || i == 5;
}
// the slot of a plane among the scale's three spatial or three time ones
__host__ __device__ constexpr int slot(int i) {
  return i < 2 ? i : i == 2 ? 0 : i == 3 ? 2 : i == 4 ? 1 : 2;
}

struct Plane {
  const void* data;  // spatial [h, w, c]; time [w, 2c]
  int h;             // spatial rows (1 for a time plane)
  int w;
};

struct FwdArgs {
  Plane p[kMaxScales][kPlanes];
};

struct BwdArgs {
  Plane p[kPlanes];
  float* corner_vals[3];  // [4n, c] each, spatial planes 0, 1, 3
  int* corner_keys[3];    // [4n]
  float* pair_vals[3];    // [n, 2c] each, time planes 2, 4, 5
  int* pair_keys[3];      // [n]
};

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// a float32 cotangent rounded to the grid's dtype where autograd rounds
// it (the gradient of a gathered grid-dtype value)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Axis {
  int i0, i1;   // low and high index
  float w;      // u - floor(u)
  float scale;  // du/dv: (n - 1) * 0.5 inside clamp's range, else 0
};

// _axis of ops/gridsample.py: u = clamp((v + 1) * 0.5 * (n - 1), 0, n - 1)
__device__ __forceinline__ Axis axis(float v, int n) {
  const float top = static_cast<float>(n - 1);
  const float raw = __fmul_rn(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f), top);
  const float u = fminf(fmaxf(raw, 0.0f), top);
  const float u0 = floorf(u);
  Axis a;
  a.i0 = min(max(static_cast<int>(u0), 0), n - 1);
  a.i1 = min(a.i0 + 1, n - 1);
  a.w = __fsub_rn(u, u0);
  // clamp passes the gradient where min <= raw <= max
  a.scale = (raw >= 0.0f && raw <= top) ? __fmul_rn(top, 0.5f) : 0.0f;
  return a;
}

__device__ __forceinline__ float lerp(float lo, float hi, float w) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, w), lo), __fmul_rn(w, hi));
}

// One plane's sample of one row at channel ch, with what its backward
// needs: the coordinate gradient's factors, so that the gathered values
// need not stay live (a spatial plane: dv/dwx = (1-wy)*(v01-v00) +
// wy*(v11-v10) and dv/dwy = s1 - s0; a time plane: hi - lo, rounded to the
// grid's dtype as the plain version's difference of two grid values).
struct Sample {
  Axis ax, ay;       // ay only for a spatial plane
  float v;           // the sample
  float gx, gy;      // gy only for a spatial plane
};

template <typename T, int I>
__device__ __forceinline__ Sample sample(const Plane& pl, const float* xc,
                                         int c, int ch) {
  Sample s;
  const T* d = static_cast<const T*>(pl.data);
  s.ax = axis(xc[c0(I)], pl.w);
  if constexpr (is_time(I)) {
    const T* row = d + static_cast<int64_t>(s.ax.i0) * 2 * c;
    const float lo = load<T>(row + ch);
    const float hi = load<T>(row + c + ch);
    s.v = lerp(lo, hi, s.ax.w);
    s.gx = round_to<T>(__fsub_rn(hi, lo));
  } else {
    s.ay = axis(xc[c1(I)], pl.h);
    const int64_t r0 = static_cast<int64_t>(s.ay.i0) * pl.w;
    const int64_t r1 = static_cast<int64_t>(s.ay.i1) * pl.w;
    const float v00 = load<T>(d + (r0 + s.ax.i0) * c + ch);
    const float v01 = load<T>(d + (r0 + s.ax.i1) * c + ch);
    const float v10 = load<T>(d + (r1 + s.ax.i0) * c + ch);
    const float v11 = load<T>(d + (r1 + s.ax.i1) * c + ch);
    const float s0 = lerp(v00, v01, s.ax.w);
    const float s1 = lerp(v10, v11, s.ax.w);
    s.v = lerp(s0, s1, s.ay.w);
    s.gx = lerp(__fsub_rn(v01, v00), __fsub_rn(v11, v10), s.ay.w);
    s.gy = __fsub_rn(s1, s0);
  }
  return s;
}

template <typename T>
__device__ __forceinline__ void sample_scale(const Plane* p, const float* xc,
                                             int c, int ch, Sample* s) {
  s[0] = sample<T, 0>(p[0], xc, c, ch);
  s[1] = sample<T, 1>(p[1], xc, c, ch);
  s[2] = sample<T, 2>(p[2], xc, c, ch);
  s[3] = sample<T, 3>(p[3], xc, c, ch);
  s[4] = sample<T, 4>(p[4], xc, c, ch);
  s[5] = sample<T, 5>(p[5], xc, c, ch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hexplane_fwd_kernel(const float* __restrict__ x, int64_t n, int n_scales,
                    int c, FwdArgs a, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n) return;
  const float xc[3] = {x[row * 3], x[row * 3 + 1], x[row * 3 + 2]};
  const int ch = lane < c ? lane : 0;  // spare lanes read channel 0
  float* o = out + row * c * n_scales;
  // unrolled, so that every plane's fields are read from the parameter
  // space at a fixed offset (a runtime index would copy the table to
  // local memory)
#pragma unroll
  for (int sc = 0; sc < kMaxScales; ++sc) {
    if (sc >= n_scales) break;
    Sample s[kPlanes];
    sample_scale<T>(a.p[sc], xc, c, ch, s);
    float acc = s[0].v;
#pragma unroll
    for (int i = 1; i < kPlanes; ++i) acc = __fmul_rn(acc, s[i].v);
    if (lane < c) o[sc * c + lane] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Plane I's cotangents of one row from its sample's cotangent dv: the
// grid-dtype corner (or pair) cotangents and their keys, and this
// channel's part of the coordinate gradient, added to dc.
template <typename T, int I>
__device__ __forceinline__ void plane_bwd(const Sample& s, float dv,
                                          const BwdArgs& a, int64_t row,
                                          int64_t n, int c, int lane,
                                          float* dc) {
  const bool on = lane < c;
  const float omx = __fsub_rn(1.0f, s.ax.w);
  const int k = slot(I);
  if constexpr (is_time(I)) {
    // _SampleRows1d.backward: the pair's products in the grid's dtype;
    // the position's the channel sum of (hi - lo) * dv
    float* pv = a.pair_vals[k] + row * 2 * c;
    if (on) {  // streaming stores: the sort reads them once, later
      __stcs(&pv[lane], round_to<T>(__fmul_rn(omx, dv)));
      __stcs(&pv[c + lane], round_to<T>(__fmul_rn(s.ax.w, dv)));
    }
    if (lane == 0) a.pair_keys[k][row] = s.ax.i0;
    dc[c0(I)] += __fmul_rn(__fmul_rn(s.gx, dv), s.ax.scale);
  } else {
    // grid_sample_2d's autograd: ds0 = dv*(1-wy), ds1 = dv*wy, then each
    // corner's weight, rounded to the grid's dtype
    const float ds0 = __fmul_rn(dv, __fsub_rn(1.0f, s.ay.w));
    const float ds1 = __fmul_rn(dv, s.ay.w);
    float* cv = a.corner_vals[k] + row * c;
    const int64_t step = n * c;  // corner-major: corner q at q * n rows
    if (on) {  // streaming stores, as the pairs' above
      __stcs(&cv[lane], round_to<T>(__fmul_rn(ds0, omx)));
      __stcs(&cv[step + lane], round_to<T>(__fmul_rn(ds0, s.ax.w)));
      __stcs(&cv[2 * step + lane], round_to<T>(__fmul_rn(ds1, omx)));
      __stcs(&cv[3 * step + lane], round_to<T>(__fmul_rn(ds1, s.ax.w)));
    }
    if (lane < 4) {  // keys y0*w+x0, y0*w+x1, y1*w+x0, y1*w+x1
      const int y = lane < 2 ? s.ay.i0 : s.ay.i1;
      const int xx = (lane & 1) ? s.ax.i1 : s.ax.i0;
      a.corner_keys[k][lane * n + row] = y * a.p[I].w + xx;
    }
    dc[c0(I)] += __fmul_rn(__fmul_rn(dv, s.gx), s.ax.scale);
    dc[c1(I)] += __fmul_rn(__fmul_rn(dv, s.gy), s.ay.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hexplane_bwd_kernel(const float* __restrict__ x, int64_t n, int c,
                    const float* __restrict__ g, int g_stride, int g_offset,
                    BwdArgs a, float* __restrict__ dx, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= n) return;
  const float xc[3] = {x[row * 3], x[row * 3 + 1], x[row * 3 + 2]};
  const bool on = lane < c;
  const int ch = on ? lane : 0;  // spare lanes read channel 0
  Sample s[kPlanes];
  sample_scale<T>(a.p, xc, c, ch, s);
  const float dout = on ? g[row * g_stride + g_offset + lane] : 0.0f;

  // the product's VJP in autograd's order: acc_k = acc_{k-1} * v_k
  float acc[kPlanes - 1];
  acc[0] = s[0].v;
#pragma unroll
  for (int i = 1; i < kPlanes - 1; ++i) acc[i] = __fmul_rn(acc[i - 1], s[i].v);
  float dv[kPlanes];
  float d = dout;  // d acc_5
#pragma unroll
  for (int i = kPlanes - 1; i >= 1; --i) {
    dv[i] = __fmul_rn(d, acc[i - 1]);
    d = __fmul_rn(d, s[i].v);
  }
  dv[0] = d;

  float dc[3] = {0.0f, 0.0f, 0.0f};  // this channel's part of d x
  plane_bwd<T, 0>(s[0], dv[0], a, row, n, c, lane, dc);
  plane_bwd<T, 1>(s[1], dv[1], a, row, n, c, lane, dc);
  plane_bwd<T, 2>(s[2], dv[2], a, row, n, c, lane, dc);
  plane_bwd<T, 3>(s[3], dv[3], a, row, n, c, lane, dc);
  plane_bwd<T, 4>(s[4], dv[4], a, row, n, c, lane, dc);
  plane_bwd<T, 5>(s[5], dv[5], a, row, n, c, lane, dc);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float sum = warp_sum(on ? dc[j] : 0.0f);
    if (lane == 0) dx[row * 3 + j] = accumulate ? dx[row * 3 + j] + sum : sum;
  }
}

Plane plane_of(const void* data, const int* dims) {
  return Plane{data, dims[0], dims[1]};
}

}  // namespace

// x [n, 3] float32 (normalised coordinates); data[s * 6 + i] the plane i
// of scale s (spatial [h, w, c], time pair rows [w, 2c]) in bfloat16
// (bf16 != 0) or float32, dims[2 * (s * 6 + i)] its (h, w) (h 1 for a
// time plane); out [n, c * n_scales] float32.  Returns a cudaError_t.
extern "C" int hexplane_fwd(const float* x, int64_t n, int n_scales, int c,
                            int bf16, const void* const* data,
                            const int* dims, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_scales < 1 || n_scales > kMaxScales || c < 1 || c > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  for (int s = 0; s < n_scales; ++s)
    for (int i = 0; i < kPlanes; ++i)
      a.p[s][i] = plane_of(data[s * kPlanes + i], dims + 2 * (s * kPlanes + i));
  const unsigned blocks =
      static_cast<unsigned>((n * 32 + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    hexplane_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        x, n, n_scales, c, a, out);
  else
    hexplane_fwd_kernel<float><<<blocks, kThreads, 0, st>>>(x, n, n_scales,
                                                            c, a, out);
  return static_cast<int>(cudaGetLastError());
}

// One scale's backward.  data[i] / dims[2 * i] the scale's six planes as
// in hexplane_fwd; g [n, g_stride] float32, the scale's cotangent at
// column g_offset; outs: corner_vals[3] ([4n, c] float32), corner_keys[3]
// ([4n] int32), pair_vals[3] ([n, 2c] float32), pair_keys[3] ([n] int32),
// in that order; dx [n, 3] float32, written (accumulate 0) or added to.
// Returns a cudaError_t.
extern "C" int hexplane_bwd(const float* x, int64_t n, int c, int bf16,
                            const void* const* data, const int* dims,
                            const float* g, int g_stride, int g_offset,
                            void* const* outs, float* dx, int accumulate,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (c < 1 || c > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  for (int i = 0; i < kPlanes; ++i) a.p[i] = plane_of(data[i], dims + 2 * i);
  for (int k = 0; k < 3; ++k) {
    a.corner_vals[k] = static_cast<float*>(outs[k]);
    a.corner_keys[k] = static_cast<int*>(outs[3 + k]);
    a.pair_vals[k] = static_cast<float*>(outs[6 + k]);
    a.pair_keys[k] = static_cast<int*>(outs[9 + k]);
  }
  const unsigned blocks =
      static_cast<unsigned>((n * 32 + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    hexplane_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        x, n, c, g, g_stride, g_offset, a, dx, accumulate);
  else
    hexplane_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        x, n, c, g, g_stride, g_offset, a, dx, accumulate);
  return static_cast<int>(cudaGetLastError());
}
