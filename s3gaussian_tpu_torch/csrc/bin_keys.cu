// The binning's pair-key emission for Hopper (sm_90a): every pair slot's
// key of a view's single-class emission, in one launch.
//
// Replaces no Pallas kernel: it fuses what the JAX package leaves to XLA in
// s3gaussian_tpu/ops/binning.py::make_pair_keys (the centre clamp, the rect
// mask, the exact ellipse-tile cut and the packed key), which the port ran
// as some 60-80 ATen elementwise passes over the [render slots, rect cap]
// slot grid.  The plain PyTorch version and oracle is the port's own
// make_pair_keys (ops/binning.py), which CPU tensors and two-class
// emission still take; the compaction (sel, sel_visible) stays there.
//
// Semantics.  Slot i = s * rect_w * rect_h + r of render slot s (pool row
// sel[s]) and rect offset (r % rect_w, r / rect_w): the tile of the rect
// placed around the projected centre, kept where the offset lies inside
// the clamped rect, the slot is a visible Gaussian and (with the conic and
// the opacity given) the conic's minimum over the tile's pixel box reaches
// the alpha cut-off 2 ln(255 opacity).  Every float32 operation is one
// rounded __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain
// path's order (so nvcc's FMA contraction cannot move a bit), the floor
// division is c10::div_floor_floating (for the power-of-two tile sizes it
// equals PyTorch's reciprocal form of a scalar divisor), logf is the log
// of PyTorch's CUDA kernel, and torch.clamp / torch.minimum keep their
// NaN rules: the cut decides which pairs exist, so the keys are the plain
// path's bits.
//
// Two key layouts, as the tile count decides (ops/binning.py::two_key):
// below 4,095 tiles the uint32 key (tile << 20) | (depth bits >> 12),
// invalid slots 0xFFFFFFFF, stored as int32 with the sign bit flipped (so
// that signed order is the unsigned order); from 4,095 tiles on the int64
// key (tile << 32) | depth bits, invalid slots tile 0x7FFFFFFF with their
// own depth bits.
//
// What bounds it on this card: bytes.  A render slot reads its row's
// 8-byte index, visibility, 16-byte rect, xy, conic, opacity and depth
// (~45 B) and writes rect_cap keys of 4 (or 8) B; at the perf cell's
// 1,171,456 render slots and 4x4 rects that is ~128 MB, 0.04 ms at
// 3.35 TB/s.  What the design does about it: a thread a key, so a warp's
// stores are one coalesced run and the 16 threads of a render slot read
// its row's values in one broadcast; no shared memory, no atomics, every
// key written once, so a replay gives the same bits as an eager call.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDepthBits = 20;
constexpr uint32_t kInvalidKey = 0xFFFFFFFFu;
constexpr int64_t kInvalidTileTwoKey = 0x7FFFFFFF;

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
// torch.clamp(v, min=lo): a NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// torch.clamp(v, lo, hi) with tensor bounds: a NaN of v, then of a bound,
// wins
__device__ __forceinline__ float clamp3(float v, float lo, float hi) {
  if (v != v) return v;
  if (lo != lo) return lo;
  if (hi != hi) return hi;
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// torch.minimum: a NaN wins
__device__ __forceinline__ float minimum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.div(a, b, rounding_mode="floor"): c10::div_floor_floating
__device__ __forceinline__ float div_floor(float a, float b) {
  if (b == 0.0f) return fdiv(a, b);
  const float mod = fmodf(a, b);
  float div = fdiv(fsub(a, mod), b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div = fsub(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, fdiv(a, b));
  float fl = floorf(div);
  if (fsub(div, fl) > 0.5f) fl = fadd(fl, 1.0f);
  return fl;
}

// ca·dx² + 2·cb·dx·dy + cc·dy², as ops/binning.py::_quad_min_box's qv
// evaluates it (cb2 = 2·cb)
__device__ __forceinline__ float qv(float ca, float cb2, float cc, float dx,
                                    float dy) {
  return fadd(fadd(fmul(fmul(ca, dx), dx), fmul(fmul(cb2, dx), dy)),
              fmul(fmul(cc, dy), dy));
}

// ops/binning.py::_ellipse_ok of one (slot, tile): the conic quadratic's
// minimum over the tile's pixel box reaches q_cut
__device__ __forceinline__ bool ellipse_ok(float ca, float cb, float cc,
                                           float q_cut, float px, float py,
                                           int tx, int ty, int tile_x,
                                           int tile_y) {
  const float bx0 = fsub(__int2float_rn(tx * tile_x), px);
  const float by0 = fsub(__int2float_rn(ty * tile_y), py);
  const float bx1 = fadd(bx0, __int2float_rn(tile_x - 1));
  const float by1 = fadd(by0, __int2float_rn(tile_y - 1));
  if (bx0 <= 0.0f && 0.0f <= bx1 && by0 <= 0.0f && 0.0f <= by1) {
    return 0.0f <= q_cut;
  }
  const float ncb = -cb;
  const float cb2 = fmul(2.0f, cb);
  // x edges: dy clamped to the box at -cb·dx/cc; y edges: dx at -cb·dy/ca
  const float e0 = qv(ca, cb2, cc, bx0, clamp3(fdiv(fmul(ncb, bx0), cc),
                                               by0, by1));
  const float e1 = qv(ca, cb2, cc, bx1, clamp3(fdiv(fmul(ncb, bx1), cc),
                                               by0, by1));
  const float e2 = qv(ca, cb2, cc, clamp3(fdiv(fmul(ncb, by0), ca), bx0,
                                          bx1), by0);
  const float e3 = qv(ca, cb2, cc, clamp3(fdiv(fmul(ncb, by1), ca), bx0,
                                          bx1), by1);
  return minimum(minimum(e0, e1), minimum(e2, e3)) <= q_cut;
}

struct Args {
  const int64_t* sel;          // [nr] pool row of each render slot
  const uint8_t* sel_visible;  // [nr] the slot is a visible Gaussian
  const int4* rect;            // [n] tile rect (x0, y0, x1, y1), half-open
  const float* xy;             // [n, 2] pixel centre
  const float* depth;          // [n]
  const float* conic;          // [n, 3], or null: no ellipse cut
  const float* opac;           // [n] activated opacity (with the conic)
  int rect_w, rect_h, tile_x, tile_y, grid_x;
};

template <bool TWO_KEY>
__global__ void __launch_bounds__(kThreads)
bin_keys_kernel(Args a, int64_t m,
                typename std::conditional<TWO_KEY, int64_t, int32_t>::type*
                    __restrict__ keys) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const int cap = a.rect_w * a.rect_h;
  const int64_t s = i / cap;
  const int r = static_cast<int>(i - s * cap);
  const int dx = r % a.rect_w;
  const int dy = r / a.rect_w;
  const int64_t row = __ldg(a.sel + s);
  bool valid = false;
  int tile = 0;
  if (__ldg(a.sel_visible + s) != 0) {
    const int4 rc = __ldg(a.rect + row);
    const int wc = min(rc.z - rc.x, a.rect_w);
    const int hc = min(rc.w - rc.y, a.rect_h);
    if (dx < wc && dy < hc) {
      const float px = __ldg(a.xy + 2 * row);
      const float py = __ldg(a.xy + 2 * row + 1);
      // centre-clamp oversized rects: the tile of the projected mean stays
      const int cx = clamp_int(
          static_cast<int>(div_floor(px, static_cast<float>(a.tile_x))),
          rc.x, max(rc.x, rc.z - 1));
      const int cy = clamp_int(
          static_cast<int>(div_floor(py, static_cast<float>(a.tile_y))),
          rc.y, max(rc.y, rc.w - 1));
      const int tx = clamp_int(cx - a.rect_w / 2, rc.x,
                               max(rc.x, rc.z - wc)) + dx;
      const int ty = clamp_int(cy - a.rect_h / 2, rc.y,
                               max(rc.y, rc.w - hc)) + dy;
      valid = true;
      if (a.conic != nullptr) {
        // dead or culled rows may carry garbage conics: only visible
        // slots get here
        const float op = clamp_min(__ldg(a.opac + row), 1e-9f);
        const float q_cut =
            clamp_min(fmul(2.0f, logf(fmul(op, 255.0f))), 0.0f);
        valid = ellipse_ok(clamp_min(__ldg(a.conic + 3 * row), 1e-12f),
                           __ldg(a.conic + 3 * row + 1),
                           clamp_min(__ldg(a.conic + 3 * row + 2), 1e-12f),
                           q_cut, px, py, tx, ty, a.tile_x, a.tile_y);
      }
      tile = ty * a.grid_x + tx;
    }
  }
  if constexpr (TWO_KEY) {
    const int64_t d = __float_as_uint(__ldg(a.depth + row));
    keys[i] = (static_cast<int64_t>(valid ? tile : kInvalidTileTwoKey)
               << 32) | d;
  } else {
    uint32_t k = kInvalidKey;
    if (valid) {
      k = (static_cast<uint32_t>(tile) << kDepthBits) |
          (__float_as_uint(__ldg(a.depth + row)) >> (32 - kDepthBits));
    }
    keys[i] = static_cast<int32_t>(k ^ 0x80000000u);
  }
}

}  // namespace

// keys: [nr * rect_w * rect_h] int32 (two_key 0) or int64 (two_key 1)
extern "C" int bin_keys(const int64_t* sel, const uint8_t* sel_visible,
                        const int* rect, const float* xy, const float* depth,
                        const float* conic, const float* opac, int64_t nr,
                        int rect_w, int rect_h, int tile_x, int tile_y,
                        int grid_x, int two_key, void* keys, void* stream) {
  const int64_t m = nr * rect_w * rect_h;
  if (m <= 0) return static_cast<int>(cudaSuccess);
  Args a{sel, sel_visible, reinterpret_cast<const int4*>(rect), xy, depth,
         conic, opac, rect_w, rect_h, tile_x, tile_y, grid_x};
  const int blocks = static_cast<int>((m + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (two_key) {
    bin_keys_kernel<true><<<blocks, kThreads, 0, st>>>(
        a, m, static_cast<int64_t*>(keys));
  } else {
    bin_keys_kernel<false><<<blocks, kThreads, 0, st>>>(
        a, m, static_cast<int32_t*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}
