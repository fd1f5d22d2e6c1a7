// Tile-raster kernel for Hopper (sm_90a).
//
// Replaces webrender_tpu/ops/pallas/tile_raster.py::render_tiles_pallas_dense
// (its pl.pallas_call at :1175) for the branches the 4K browsing and
// effects frames reach: KIND_SOLID, KIND_LINEAR_GRAD; the translation fast
// path of KIND_GLYPH (alpha atlas), KIND_PICTURE (surface atlas) and
// KIND_SUBPX_GLYPH (color atlas); the separable K_SEP_IMAGE and
// K_SEP_PICTURE (swgl 7-bit bilinear); the pictures' color matrix (flags 0
// and 1); rect and rounded-rect clips; swgl integer compose for blend ops
// 0, 7 and 8; and the init_tiles input of continuation passes (the
// accumulator starts from the tile's current pixels instead of the clear
// color).
//
// Design.  One thread per pixel; a block covers ROWS rows of one 128x64
// tile.  Each thread walks the tile's dense records in painter order and
// keeps its four accumulator channels in registers, so the tile never
// round-trips through device memory between records.  All threads of a
// block read the same record, so record loads are warp broadcasts.  The
// TPU kernel's DMA windows, lane rolls and one-hot MXU contractions are
// exact gathers of four texels; here they are direct loads of those
// texels, and a tap outside the atlas reads 0 (such pixels have zero
// coverage).
//
// Two instantiations.  The wrapper picks one from the dispatch's kind
// set, as the TPU kernel compiles its static kind LUT into each build:
// kSurfaceKinds = false serves dispatches without KIND_GLYPH, KIND_PICTURE
// and K_SEP_PICTURE (the browsing passes) and compiles neither the alpha
// and surface atlases' samplers nor the color matrix; true serves any
// ported kind set.
//
// Bound.  At 4K a frame is ~8 M pixels x up to 128 records; the work is
// per-pixel f32 arithmetic plus record and texel loads that hit L1/L2, so
// the kernel is bound by issue rate, not device memory.  Making it fast
// (shared-memory record staging, kind-sorted warps) is later work.
//
// Numerics.  Built with -fmad=false and without fast math: every float op
// is IEEE-rounded and written in the order of the numpy/JAX source
// (ops/patterns.py, ops/blend.py), so results are bitwise equal to the
// plain version.  Constants are Python's doubles cast to float, as numpy
// and JAX cast weak scalars.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_W 128
#define TILE_H 64
#define ROWS 2
#define REC 128

#define F(x) (static_cast<float>(x))

namespace {

constexpr int REC_KIND = 64;
constexpr int REC_BLEND = 65;
constexpr int REC_EDGE = 66;
constexpr int REC_CLIP_COUNT = 67;
constexpr int REC_CLIP_ROW = 68;
constexpr int REC_TROW = 69;

constexpr int KIND_SOLID = 0;
constexpr int KIND_LINEAR_GRAD = 2;
constexpr int KIND_GLYPH = 5;
constexpr int KIND_PICTURE = 6;
constexpr int KIND_SUBPX_GLYPH = 10;
constexpr int K_SEP_IMAGE = 13;
constexpr int K_SEP_PICTURE = 15;

constexpr int BLEND_CH_CLEAR = 7;
constexpr int BLEND_ADD = 8;

// numpy's minimum / maximum: NaN propagates, ties keep the first operand
__device__ __forceinline__ float np_min(float a, float b) {
  return (a <= b || a != a) ? a : b;
}
__device__ __forceinline__ float np_max(float a, float b) {
  return (a >= b || a != a) ? a : b;
}
__device__ __forceinline__ float np_clip(float x, float lo, float hi) {
  return np_min(np_max(x, lo), hi);
}
// numpy's float remainder (sign of the divisor)
__device__ __forceinline__ float np_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

__device__ __forceinline__ void inverse_map(const float* t, float px,
                                            float py, float& lx, float& ly) {
  float u = px * t[0] + py * t[3] + t[6];
  float v = px * t[1] + py * t[4] + t[7];
  float w = px * t[2] + py * t[5] + t[8];
  bool ok = w > F(1e-9);
  w = ok ? w : 1.0f;
  lx = ok ? u / w : F(1e8);
  ly = ok ? v / w : F(1e8);
}

__device__ __forceinline__ float edge_term(float d, bool aa) {
  return aa ? np_min(d, 0.5f) : (d >= 0.0f ? 0.5f : F(-1e3));
}

__device__ __forceinline__ float local_fwidth(const float* t, float lx,
                                              float ly, float px, float py) {
  float w = px * t[2] + py * t[5] + t[8];
  w = fabsf(w) > F(1e-9) ? w : F(1e-9);
  float dlx = (t[0] - lx * t[2]) / w;
  float dly = (t[1] - ly * t[2]) / w;
  return fabsf(dlx) + fabsf(dly);
}

// patterns.rect_coverage_auto
__device__ float rect_coverage_auto(const float* t, float x0, float y0,
                                    float x1, float y1, float lx, float ly,
                                    float px, float py, int edge_aa) {
  bool is_tx = np_mod(floorf(t[11] * 0.25f), 2.0f) >= 1.0f;
  if (!is_tx) {
    float sx = t[9], sy = t[10];
    float dl = (lx - x0) * sx;
    float dr = (x1 - lx) * sx;
    float dt = (ly - y0) * sy;
    float db = (y1 - ly) * sy;
    float tl = edge_term(dl, (edge_aa & 1) > 0);
    float tr = edge_term(dr, (edge_aa & 4) > 0);
    float tt = edge_term(dt, (edge_aa & 2) > 0);
    float tb = edge_term(db, (edge_aa & 8) > 0);
    float cov_x = np_clip(tl + tr, 0.0f, 1.0f);
    float cov_y = np_clip(tt + tb, 0.0f, 1.0f);
    return cov_x * cov_y;
  }
  float dx = np_max(x0 - lx, lx - x1);
  float dy = np_max(y0 - ly, ly - y1);
  if (edge_aa > 0) {
    float fw = local_fwidth(t, lx, ly, px, py);
    float fw_safe = fw > F(1e-9) ? fw : F(1e-9);
    float d = np_max(dx, dy) / fw_safe;
    return np_clip(0.5f - d, 0.0f, 1.0f);
  }
  return np_max(dx, dy) < F(1.0 / 1024.0) ? 1.0f : 0.0f;
}

// patterns.rounded_rect_sdf_coverage
__device__ float rounded_sdf(const float* rc, const float* rd, float lx,
                             float ly, float aa_mul) {
  float x0 = rc[0], y0 = rc[1], x1 = rc[2], y1 = rc[3];
  float cpx = F(1e-6), cpy = F(1e-6), civx = 1.0f, civy = 1.0f;
#define CORNER(RX, RY, NX, NY, PPX, PPY, CX, CY)                   \
  {                                                                \
    float rx = (RX), ry = (RY), nx = (NX), ny = (NY);              \
    float off = nx * (PPX) + ny * (PPY);                           \
    bool sel = (nx * lx + ny * ly) > off;                          \
    float ivx = 1.0f / np_max(rx * rx, F(1e-6));                   \
    float ivy = 1.0f / np_max(ry * ry, F(1e-6));                   \
    if (sel) {                                                     \
      cpx = (CX);                                                  \
      cpy = (CY);                                                  \
      civx = ivx;                                                  \
      civy = ivy;                                                  \
    }                                                              \
  }
  CORNER(rd[0], rd[1], -rd[1], -rd[0], x0, y0 + rd[1],
         (x0 + rx) - lx, (y0 + ry) - ly)
  CORNER(rd[2], rd[3], rd[3], -rd[2], x1 - rd[2], y0,
         -((x1 - rx) - lx), (y0 + ry) - ly)
  CORNER(rd[4], rd[5], rd[5], rd[4], x1, y1 - rd[5],
         lx - (x1 - rx), ly - (y1 - ry))
  CORNER(rd[6], rd[7], -rd[7], rd[6], x0 + rd[6], y1,
         (x0 + rx) - lx, -((y1 - ry) - ly))
#undef CORNER
  float prx = cpx * civx;
  float pry = cpy * civy;
  float g = cpx * prx + cpy * pry - 1.0f;
  float dgx = 2.0f * prx;
  float dgy = 2.0f * pry;
  float norm = sqrtf(dgx * dgx + dgy * dgy);
  float ell = g / (norm > F(1e-12) ? norm : F(1e-12));
  float rect = np_max(np_max(x0 - lx, lx - x1), np_max(y0 - ly, ly - y1));
  float dist = np_max(ell, rect);
  return np_clip(0.5f - dist * aa_mul, 0.0f, 1.0f);
}

// patterns.rounded_rect_fast_coverage
__device__ float rounded_fast(const float* rc, float radius, float lx,
                              float ly, float aa_mul) {
  float cx = (rc[0] + rc[2]) * 0.5f;
  float cy = (rc[1] + rc[3]) * 0.5f;
  float hx = (rc[2] - rc[0]) * 0.5f - radius;
  float hy = (rc[3] - rc[1]) * 0.5f - radius;
  float dx = fabsf(lx - cx) - hx;
  float dy = fabsf(ly - cy) - hy;
  float mx = np_max(dx, 0.0f);
  float my = np_max(dy, 0.0f);
  float outside = sqrtf(mx * mx + my * my);
  float inside = np_min(np_max(dx, dy), 0.0f);
  float dist = outside + inside - radius;
  return np_clip(0.5f - dist * aa_mul, 0.0f, 1.0f);
}

__device__ __forceinline__ float quantize_cov(float c, float scale) {
  return floorf(c * scale + F(0.5 + 1.0 / 1024.0));
}

__device__ __forceinline__ float u8(float v) {
  return floorf(v * 255.0f + 0.5f);
}

// swgl's truncating 7-bit lerp, y first, then x
__device__ __forceinline__ float fixed_bilinear(float t00, float t10,
                                                float t01, float t11,
                                                float frx, float fry) {
  float a = t00 + floorf((t01 - t00) * fry * F(1.0 / 128.0));
  float b = t10 + floorf((t11 - t10) * fry * F(1.0 / 128.0));
  return (a + floorf((b - a) * frx * F(1.0 / 128.0))) * F(1.0 / 255.0);
}

__device__ __forceinline__ float tap(const float* plane, int H, int W,
                                     long long y, long long x) {
  if (y < 0 || y >= H || x < 0 || x >= W) return 0.0f;
  return __ldg(plane + y * W + x);
}

// The translation fast path reads its taps from the TPU kernel's DMA
// window (tile_raster.py:933-960): the window starts at the (128, 8)-
// aligned (x0c, y0c) clamped inside the atlas, columns wrap around its
// SAMP_W lanes, rows shift by at most 7, rows above the atlas read zero.
// Inside the atlas these are the texels themselves.  Scratch rows the DMA
// leaves unwritten (an instance more than 7 rows above the atlas) read
// zero here.  The TPU kernel's floor divisions and remainders on int32 are
// by powers of two: arithmetic shifts and masks here.
constexpr int SAMP_H = TILE_H + 8;
constexpr int SAMP_W = TILE_W + 128;
static_assert((SAMP_W & (SAMP_W - 1)) == 0, "SAMP_W is a power of two");

struct Window {
  int x0c, y0c, dsty, dxs, shift;
};

__device__ __forceinline__ Window make_window(int x0i, int y0i, int H,
                                              int W) {
  Window w;
  const int xc = min(max(x0i, 0), W - SAMP_W);
  const int yc = min(max(y0i, 0), H - SAMP_H);
  w.x0c = (xc >> 7) << 7;
  w.y0c = (yc >> 3) << 3;
  const int d = min(max(w.y0c - y0i, 0), 72);
  w.dsty = (d >> 3) << 3;
  w.dxs = x0i - w.x0c;
  w.shift = min(max(y0i - w.y0c + w.dsty, -8), 7);
  return w;
}

// the texel of tap (r, c) = (row + di, col + dj) in the window
__device__ __forceinline__ float window_tap(const float* plane, int H, int W,
                                            const Window& w, int r, int c) {
  const int rr = w.shift + r;
  if (rr < w.dsty) return 0.0f;
  const int cc = (c + w.dxs) & (SAMP_W - 1);  // Python's % SAMP_W
  return tap(plane, H, W, w.y0c - w.dsty + rr, w.x0c + cc);
}

// one atlas: its planes of h x w f32 texels, one after the other
struct Atlas {
  const float* data;
  int h, w;
};

struct Args {
  const float* dense;
  const int* counts;
  const float* origins;
  const float* clear;
  const float* init;  // [nt, 4, TILE_H, TILE_W] starting pixels, or null
  const float* f32;
  long long n_f32;
  Atlas alpha;    // [H, W], glyph masks
  Atlas surface;  // [4, H, W], offscreen surfaces
  Atlas color;    // [4, H, W], images and subpixel glyph masks
  float* out;
  int nt, slots;
};

// _sep_sample (tile_raster.py:640) in swgl mode: the four taps of each of
// the atlas's four planes, combined by the truncating 7-bit lerp.  Every
// tap lies in the window the TPU kernel DMAs (the wrapper's host check
// keeps each instance's span inside it).
__device__ void sep_sample(const Atlas& at, float u, float v, const float* p,
                           float nearest, float tex[4]) {
  float lo_u = p[8] + 0.5f;
  float hi_u = np_max(p[10] - 0.5f, lo_u);
  float lo_v = p[9] + 0.5f;
  float hi_v = np_max(p[11] - 0.5f, lo_v);
  u = np_clip(u, lo_u, hi_u);
  v = np_clip(v, lo_v, hi_v);
  if (nearest > 0.5f) {
    u = floorf(u) + 0.5f;
    v = floorf(v) + 0.5f;
  }
  const int H = at.h, W = at.w;
  const float wm2 = static_cast<float>(W - 2);
  const float hm1 = static_cast<float>(H - 1);
  float qu = floorf(u * 128.0f - 63.5f);
  float qv = floorf(v * 128.0f - 63.5f);
  float ixf = floorf(qu * F(1.0 / 128.0));
  float iyf = floorf(qv * F(1.0 / 128.0));
  float fx = qu - ixf * 128.0f;
  float fy = qv - iyf * 128.0f;
  if (ixf < 0.0f) fx = 0.0f;
  if (ixf > wm2) fx = 128.0f;
  long long x0 = static_cast<long long>(np_clip(ixf, 0.0f, wm2));
  long long y0 = static_cast<long long>(np_clip(iyf, 0.0f, hm1));
  long long y1 = y0 + ((iyf >= 0.0f && iyf < hm1) ? 1 : 0);
  long long x1 = x0 + 1 < W - 1 ? x0 + 1 : W - 1;
  const long long plane = static_cast<long long>(H) * W;
  for (int c = 0; c < 4; ++c) {
    const float* pl = at.data + c * plane;
    float t00 = u8(tap(pl, H, W, y0, x0));
    float t10 = u8(tap(pl, H, W, y0, x1));
    float t01 = u8(tap(pl, H, W, y1, x0));
    float t11 = u8(tap(pl, H, W, y1, x1));
    tex[c] = fixed_bilinear(t00, t10, t01, t11, fx, fy);
  }
}

// patterns.apply_color_matrix for flags 0 (passthrough) and 1 (straight-
// alpha 4x5 matrix in sRGB); m = the record's payload [16:36].  Each row
// sums its five products left to right, as the reference does.
__device__ void color_matrix(float c[4], const float* m, float flag) {
  if (!(flag > 0.5f)) return;
  const float a = c[3];
  const float safe = a > F(1e-6) ? a : 1.0f;
  const float r = c[0] / safe, g = c[1] / safe, b = c[2] / safe;
  float n[4];
  for (int k = 0; k < 4; ++k) {
    const float* row = m + 5 * k;
    n[k] = np_clip(__ldg(row) * r + __ldg(row + 1) * g + __ldg(row + 2) * b +
                       __ldg(row + 3) * a + __ldg(row + 4),
                   0.0f, 1.0f);
  }
  c[0] = n[0] * n[3];
  c[1] = n[1] * n[3];
  c[2] = n[2] * n[3];
  c[3] = n[3];
}

__device__ __forceinline__ float f32_at(const Args& a, long long i) {
  return (i >= 0 && i < a.n_f32) ? __ldg(a.f32 + i) : 0.0f;
}

template <bool kSurfaceKinds>
__global__ void __launch_bounds__(TILE_W * ROWS)
tile_raster_kernel(Args a) {
  const int groups = TILE_H / ROWS;
  const int tile = blockIdx.x / groups;
  const int row = (blockIdx.x % groups) * ROWS + threadIdx.y;
  const int col = threadIdx.x;
  const float ox = __ldg(a.origins + 2 * tile);
  const float oy = __ldg(a.origins + 2 * tile + 1);
  const float px = ox + static_cast<float>(col) + 0.5f;
  const float py = oy + static_cast<float>(row) + 0.5f;
  float acc[4];
  if (a.init != nullptr) {
    const float* in = a.init + static_cast<long long>(tile) * 4 * TILE_H *
                                   TILE_W + row * TILE_W + col;
    for (int c = 0; c < 4; ++c) acc[c] = __ldg(in + c * TILE_H * TILE_W);
  } else {
    for (int c = 0; c < 4; ++c) acc[c] = __ldg(a.clear + c);
  }
  const long long n_rows = a.n_f32 / REC;

  // a tile's count never reads past its own slots
  const int cnt = min(max(__ldg(a.counts + tile), 0), a.slots);
  for (int i = 0; i < cnt; ++i) {
    const float* r =
        a.dense + (static_cast<long long>(tile) * a.slots + i) * REC;
    float p[26];  // the payload prefix the ported kinds read
#pragma unroll
    for (int k = 0; k < 26; ++k) p[k] = __ldg(r + k);
    float tr[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) tr[k] = __ldg(r + REC_TROW + k);
    const int kind = static_cast<int>(__ldg(r + REC_KIND));
    const int op = static_cast<int>(__ldg(r + REC_BLEND));
    const int edge_aa = static_cast<int>(__ldg(r + REC_EDGE));
    const int n_clip = static_cast<int>(__ldg(r + REC_CLIP_COUNT));
    const int clip_row = static_cast<int>(__ldg(r + REC_CLIP_ROW));

    float lx, ly;
    inverse_map(tr, px, py, lx, ly);
    float cov = rect_coverage_auto(tr, p[4], p[5], p[6], p[7], lx, ly, px, py,
                                   edge_aa);

    // clip chain: rect clips join the span, others the u8 mask chain
    float m8 = 255.0f;
    for (int j = 0; j < n_clip; ++j) {
      long long cr = clip_row + j;
      cr = cr < 0 ? 0 : (cr >= n_rows ? n_rows - 1 : cr);
      const float* crec = a.f32 + cr * REC;
      float ct[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) ct[k] = __ldg(crec + 96 + k);
      float cb[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) cb[k] = __ldg(crec + k);
      const float ckind = __ldg(crec + 14);
      const float invert = __ldg(crec + 12);
      float clx, cly;
      inverse_map(ct, px, py, clx, cly);
      float ccov;
      if (ckind < 0.5f) {
        ccov = rect_coverage_auto(ct, cb[0], cb[1], cb[2], cb[3], clx, cly,
                                  px, py, 0xF);
      } else {
        float fw = local_fwidth(ct, clx, cly, px, py);
        float aa_mul = 1.0f / (fw > F(1e-9) ? fw : F(1e-9));
        ccov = __ldg(crec + 15) > 0.5f
                   ? rounded_fast(cb, cb[4], clx, cly, aa_mul)
                   : rounded_sdf(cb, cb + 4, clx, cly, aa_mul);
      }
      if (invert > 0.5f) ccov = 1.0f - ccov;
      if (ckind < 0.5f && invert < 0.5f) {
        cov = cov * ccov;
      } else {
        float c8 = quantize_cov(ccov, 255.0f);
        m8 = floorf((c8 * m8 + c8) * F(1.0 / 256.0));
      }
    }
    const float mcov = m8 * F(1.0 / 255.0);
    // fragments with zero geometric coverage are never rasterized
    if (!(cov > 0.0f)) continue;

    float color[4];
    if (kind == KIND_SOLID) {
      for (int c = 0; c < 4; ++c) color[c] = p[8 + c];
    } else if (kind == KIND_LINEAR_GRAD) {
      float sw = np_max(p[16], F(1e-6));
      float sh = np_max(p[17], F(1e-6));
      float oxl = lx - p[0];
      float oyl = ly - p[1];
      float perx = sw + p[18];
      float pery = sh + p[19];
      perx = perx > F(1e-6) ? perx : F(1e6);
      pery = pery > F(1e-6) ? pery : F(1e6);
      float tx = oxl - floorf(oxl / perx) * perx;
      float ty = oyl - floorf(oyl / pery) * pery;
      bool in_tile = (tx < sw + F(1e-4)) && (ty < sh + F(1e-4));
      float dx = p[10] - p[8];
      float dy = p[11] - p[9];
      float denom = dx * dx + dy * dy;
      denom = denom > F(1e-9) ? denom : F(1e-9);
      float t = ((tx - p[8]) * dx + (ty - p[9]) * dy) / denom;
      // stops: 8-float records from the row of p[12], premultiplied
      const long long base = (static_cast<int>(p[12]) / 128) * 128LL;
      int n = static_cast<int>(p[14]);
      if (p[13] > 0.5f) t = t - floorf(t);
      for (int c = 0; c < 4; ++c) color[c] = f32_at(a, base + 1 + c);
      for (int s = 1; s < n; ++s) {
        float o0 = f32_at(a, base + (s - 1) * 8);
        float o1 = f32_at(a, base + s * 8);
        float den = o1 - o0;
        float w = den > F(1e-9) ? np_clip((t - o0) / den, 0.0f, 1.0f)
                                : (t >= o1 ? 1.0f : 0.0f);
        for (int c = 0; c < 4; ++c) {
          float c1 = f32_at(a, base + s * 8 + 1 + c);
          color[c] = color[c] + (c1 - color[c]) * w;
        }
      }
      if (p[15] > 0.5f) {
        for (int c = 0; c < 4; ++c)
          color[c] = np_clip(rintf(color[c] * 255.0f), 0.0f, 255.0f) *
                     F(1.0 / 255.0);
      }
      const float m = in_tile ? 1.0f : 0.0f;
      for (int c = 0; c < 4; ++c) color[c] = color[c] * m;
    } else if (kind == KIND_SUBPX_GLYPH ||
               (kSurfaceKinds &&
                (kind == KIND_GLYPH || kind == KIND_PICTURE))) {
      // translation fast path: constant 7-bit fraction over the tile
      const bool subpx = !kSurfaceKinds || kind == KIND_SUBPX_GLYPH;
      const Atlas& at = subpx                ? a.color
                        : kind == KIND_GLYPH ? a.alpha
                                             : a.surface;
      const int planes = subpx ? 3 : (kind == KIND_GLYPH ? 1 : 4);
      float fx = ox + tr[6] + (p[8] - p[0]);
      float fy = oy + tr[7] + (p[9] - p[1]);
      float qx = floorf(fx * 128.0f + 0.5f);
      float qy = floorf(fy * 128.0f + 0.5f);
      float x0f = floorf(qx * F(1.0 / 128.0));
      float y0f = floorf(qy * F(1.0 / 128.0));
      float frx = qx - x0f * 128.0f;
      float fry = qy - y0f * 128.0f;
      const float lim = 1073741824.0f;
      const Window win = make_window(static_cast<int>(np_clip(x0f, -lim, lim)),
                                     static_cast<int>(np_clip(y0f, -lim, lim)),
                                     at.h, at.w);
      const long long plane = static_cast<long long>(at.h) * at.w;
      float tex[4];
      for (int c = 0; c < planes; ++c) {
        const float* pl = at.data + c * plane;
        float t00 = u8(window_tap(pl, at.h, at.w, win, row, col));
        float t10 = u8(window_tap(pl, at.h, at.w, win, row, col + 1));
        float t01 = u8(window_tap(pl, at.h, at.w, win, row + 1, col));
        float t11 = u8(window_tap(pl, at.h, at.w, win, row + 1, col + 1));
        tex[c] = fixed_bilinear(t00, t10, t01, t11, frx, fry);
      }
      if (subpx) {
        float m_avg = (tex[0] + tex[1] + tex[2]) * F(1.0 / 3.0);
        color[0] = tex[0] * p[12];
        color[1] = tex[1] * p[13];
        color[2] = tex[2] * p[14];
        color[3] = m_avg * p[15];
      } else if (kind == KIND_GLYPH) {
        for (int c = 0; c < 4; ++c) color[c] = p[12 + c] * tex[0];
      } else {
        for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c];
        color_matrix(color, r + 16, __ldg(r + 36));
      }
    } else if (kind == K_SEP_IMAGE) {
      // u from the tile's first row of lx, v from its first column of ly
      float lx_row, ly_col, dummy;
      inverse_map(tr, px, oy + 0.5f, lx_row, dummy);
      inverse_map(tr, ox + 0.5f, py, dummy, ly_col);
      float sw = np_max(p[18], F(1e-6));
      float sh = np_max(p[19], F(1e-6));
      float oxl = np_clip(lx_row - p[0], 0.0f,
                          np_max(p[2] - p[0] - F(1e-3), 0.0f));
      float oyl = np_clip(ly_col - p[1], 0.0f,
                          np_max(p[3] - p[1] - F(1e-3), 0.0f));
      float perx = sw + p[20];
      float pery = sh + p[21];
      perx = perx > F(1e-6) ? perx : F(1e6);
      pery = pery > F(1e-6) ? pery : F(1e6);
      float tx = oxl - floorf(oxl / perx) * perx;
      float ty = oyl - floorf(oyl / pery) * pery;
      float in_x = tx < sw + F(1e-4) ? 1.0f : 0.0f;
      float in_y = ty < sh + F(1e-4) ? 1.0f : 0.0f;
      float u = p[8] + tx * p[22] - p[24];
      float v = p[9] + ty * p[23] - p[25];
      float tex[4];
      sep_sample(a.color, u, v, p, p[16], tex);
      float in_t = in_x * in_y;
      for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c] * in_t;
    } else if (kSurfaceKinds && kind == K_SEP_PICTURE) {
      // device-space mapping, or raster-root local mode (p[37])
      float w_ = np_max(p[2] - p[0], F(1e-6));
      float h_ = np_max(p[3] - p[1], F(1e-6));
      float su = (p[10] - p[8]) / w_;
      float sv = (p[11] - p[9]) / h_;
      float u = p[8] + (px - p[0]) * su;
      float v = p[9] + (py - p[1]) * sv;
      if (__ldg(r + 37) > 0.5f) {
        float lx_row, ly_col, dummy;
        inverse_map(tr, px, oy + 0.5f, lx_row, dummy);
        inverse_map(tr, ox + 0.5f, py, dummy, ly_col);
        const float scale = __ldg(r + 40);
        u = p[8] + lx_row * scale - __ldg(r + 38);
        v = p[9] + ly_col * scale - __ldg(r + 39);
      }
      float tex[4];
      sep_sample(a.surface, u, v, p, 0.0f, tex);
      for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c];
      color_matrix(color, r + 16, __ldg(r + 36));
    } else {
      // unported kinds never reach the kernel (the wrapper raises first),
      // and the surface kinds reach only its kSurfaceKinds build
      continue;
    }

    // blend.compose_swgl, integer swgl blend cases on the u8 grid
    float s[4], d[4], o[4];
    const float aa = quantize_cov(np_clip(cov, 0.0f, 1.0f), 256.0f);
    const float mq = quantize_cov(np_clip(mcov, 0.0f, 1.0f), 255.0f);
    for (int c = 0; c < 4; ++c) {
      float v = np_clip(rintf(color[c] * 255.0f), 0.0f, 255.0f);
      v = floorf(v * aa * F(1.0 / 256.0));
      s[c] = floorf((v * mq + v) * F(1.0 / 256.0));
      d[c] = floorf(acc[c] * 255.0f + 0.5f);
    }
    for (int c = 0; c < 4; ++c) {
      if (op == BLEND_CH_CLEAR) {
        o[c] = d[c] - floorf((d[c] * s[c] + d[c]) * F(1.0 / 256.0));
      } else if (op == BLEND_ADD) {
        o[c] = s[c] + d[c];
      } else {  // BLEND_NORMAL (0)
        o[c] = s[c] + d[c] - floorf((d[c] * s[3] + d[c]) * F(1.0 / 256.0));
      }
    }
    for (int c = 0; c < 4; ++c)
      acc[c] = np_clip(o[c], 0.0f, 255.0f) * F(1.0 / 255.0);
  }
  float* o = a.out + static_cast<long long>(tile) * 4 * TILE_H * TILE_W +
             row * TILE_W + col;
  for (int c = 0; c < 4; ++c) o[c * TILE_H * TILE_W] = acc[c];
}

}  // namespace

extern "C" int wr_tile_raster(const float* dense, const int* counts,
                              const float* origins, const float* clear,
                              const float* init, const float* f32,
                              long long n_f32, const float* alpha_atlas,
                              int aa_h, int aa_w, const float* surface_atlas,
                              int sa_h, int sa_w, const float* color_atlas,
                              int ca_h, int ca_w, float* out, int nt,
                              int slots, int surface_kinds, void* stream) {
  Args a{dense,
         counts,
         origins,
         clear,
         init,
         f32,
         n_f32,
         {alpha_atlas, aa_h, aa_w},
         {surface_atlas, sa_h, sa_w},
         {color_atlas, ca_h, ca_w},
         out,
         nt,
         slots};
  dim3 block(TILE_W, ROWS);
  dim3 grid(static_cast<unsigned>(nt) * (TILE_H / ROWS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (surface_kinds)
    tile_raster_kernel<true><<<grid, block, 0, st>>>(a);
  else
    tile_raster_kernel<false><<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
