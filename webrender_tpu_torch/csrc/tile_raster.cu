// Tile-raster kernel for Hopper (sm_90a).
//
// Replaces webrender_tpu/ops/pallas/tile_raster.py::render_tiles_pallas_dense
// (its pl.pallas_call at :1175) for the branches the 4K browsing, effects,
// content and zoomed frames reach: KIND_SOLID; linear, radial and conic
// gradients (the conic angle through the shared polynomial atan2);
// KIND_CLEAR; KIND_BOX_SHADOW (sharp and blurred arms) and KIND_LINE_DEC
// (dotted, dashed, wavy); the translation fast path of KIND_GLYPH (alpha
// atlas), KIND_PICTURE (surface atlas) and KIND_SUBPX_GLYPH (color atlas);
// the separable K_SEP_IMAGE, K_SEP_PICTURE, K_SEP_GLYPH and K_SEP_SUBPX
// (scaled text) and K_SEP_YUV (three planes of the alpha atlas and the
// color-space matrix), all through the swgl 7-bit bilinear; the pictures'
// color matrix (flags 0 and 1); rect and rounded-rect clips, and the
// image-mask and box-shadow nine-patch clips (the TPU kernel's mask_clips);
// the polygon clip of preserve-3d plane fragments (in the general and
// filter builds, see below); swgl integer compose for blend ops 0, 1, 7, 8
// and the mix-blend modes 16-32; and the init_tiles input of continuation
// passes (the accumulator starts from the tile's current pixels instead of
// the clear color).
//
// SVG filters.  The surface passes of an SVG filter graph composite their
// inputs with the blend ops that blend.compose_swgl runs in the float
// domain, not on the u8 grid: the Porter-Duff composites 2-6 (feComposite
// in, out, atop, xor, lighter), the SVGFE mixes 40-56 (feBlend: the float
// mix_blend_rgb formulas) and, from 64, any op in linearRGB (both operands
// converted from sRGB first, the result converted back); and a picture's
// color matrix may run in linearRGB (flag 2, feColorMatrix).  The float
// domain has no zero-coverage skip: a record still composites color times
// zero over the pixels of its tiles that it does not cover (an `in`
// composite clears them).
//
// General tiles.  The JAX renderer keeps on the TPU kernel only the tiles
// whose instances all fit its DMA windows (axis-aligned sampling within
// 256x128 texels a tile, gradients of 16 stops) and draws every other tile
// with ops/raster.py::render_tiles, which samples per pixel.  Global memory
// has no window, so here those tiles are more branches of this kernel: a
// record of such a tile carries REC_GENERAL, and its sampled kinds are the
// general ones (K_GEN_*), which evaluate patterns.pattern_image,
// pattern_glyph, pattern_subpx_glyph, pattern_picture and pattern_yuv at
// every pixel's own local position; its clip chain samples the image-mask
// and nine-patch clips per pixel (patterns.clip_coverage); its gradients
// read their stops at the payload's own address.  `step` is the device
// pixels between two pixels of a tile (render_tiles' step; every tile of a
// pass with another step than 1 is general).
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
// Six instantiations.  The wrapper picks one from the dispatch's kinds,
// blends and mask_clips, as the TPU kernel compiles its static kind and
// blend LUTs into each build: <false, false, false> (browsing) serves
// dispatches without KIND_GLYPH, KIND_PICTURE and K_SEP_PICTURE and
// compiles neither the alpha and surface atlases' samplers nor the color
// matrix; <true, false, false> (surface) adds those; <true, true, false>
// (content) adds the content kinds, mask clips and mix-blend modes;
// <true, true, true> (media) adds scaled text, video, KIND_CLEAR and
// BLEND_CLEAR; a fourth flag (general) the general tiles' branches and
// the step; and a fifth (filter) the float-domain blend ops and the
// linearRGB color matrix, so that it serves any ported dispatch and the
// browsing, effects, content, zoomed and transformed passes do not pay for
// its code.
//
// Polygon clips.  A preserve-3d context's planes are split against each
// other on the host (frame/plane_split.py) and each fragment is clipped to
// its device-space convex polygon: clip kind 3, up to 8 inward half-planes
// (patterns.polygon_coverage).  The general and filter builds hold it, in
// both clip chains; the wrapper sends a dispatch with such a clip to the
// general build.  As in the TPU kernel, a tile that is not general reads
// the image-mask and nine-patch kinds as polygons when the dispatch was made
// without mask_clips, which these two builds read from the slot count's
// kNoMaskClips bit (the older builds never see a polygon, and read those
// kinds as masks).
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
// and JAX cast weak scalars.  The sRGB <-> linearRGB power is
// expf(y * logf(x)), as blend._pow writes it: the plain version's
// torch.exp and torch.log on the card call the same CUDA functions.
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
constexpr int REC_GENERAL = 81;  // 1.0 in every record of a general tile

constexpr int KIND_SOLID = 0;
constexpr int KIND_LINEAR_GRAD = 2;
constexpr int KIND_RADIAL_GRAD = 3;
constexpr int KIND_CONIC_GRAD = 4;
constexpr int KIND_GLYPH = 5;
constexpr int KIND_PICTURE = 6;
constexpr int KIND_CLEAR = 7;
constexpr int KIND_BOX_SHADOW = 8;
constexpr int KIND_SUBPX_GLYPH = 10;
constexpr int KIND_LINE_DEC = 11;
constexpr int K_SEP_IMAGE = 13;
constexpr int K_SEP_GLYPH = 14;
constexpr int K_SEP_PICTURE = 15;
constexpr int K_SEP_SUBPX = 16;
constexpr int K_SEP_YUV = 17;
// the general tiles' per-pixel sampling kinds: an image and a video keep
// their instance kinds (KIND_IMAGE, KIND_YUV)
constexpr int K_GEN_IMAGE = 1;
constexpr int K_GEN_YUV = 12;
constexpr int K_GEN_GLYPH = 18;
constexpr int K_GEN_PICTURE = 19;
constexpr int K_GEN_SUBPX = 20;

constexpr int BLEND_CLEAR = 1;
constexpr int BLEND_CH_CLEAR = 7;
constexpr int BLEND_ADD = 8;
constexpr int BLEND_MIX_BASE = 16;  // + MixBlendMode, 0 (normal) to 16

// in the general and filter builds, the bit of Args::slots that says the
// dispatch was made without mask_clips
constexpr int kNoMaskClips = 1 << 30;

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

// --- the content kinds' pattern math (ops/patterns.py) ----------------------

// patterns._tile_coords: repeat tiling of the local position
__device__ __forceinline__ void tile_coords(const float* p, float lx, float ly,
                                            float sw, float sh, float spx,
                                            float spy, float& tx, float& ty,
                                            bool& in_tile) {
  float oxl = lx - p[0];
  float oyl = ly - p[1];
  float perx = sw + spx;
  float pery = sh + spy;
  perx = perx > F(1e-6) ? perx : F(1e6);
  pery = pery > F(1e-6) ? pery : F(1e6);
  tx = oxl - floorf(oxl / perx) * perx;
  ty = oyl - floorf(oyl / pery) * pery;
  in_tile = (tx < sw + F(1e-4)) && (ty < sh + F(1e-4));
}

// patterns.atan2_shared: the polynomial atan2 every backend shares (not
// atan2f, whose last ulp differs)
__device__ float atan2_shared(float y, float x) {
  float ax = fabsf(x);
  float ay = fabsf(y);
  float hi = np_max(ax, ay);
  float lo = np_min(ax, ay);
  float z = lo / (hi > 0.0f ? hi : 1.0f);
  float z2 = z * z;
  float q = ((((F(-0.0117212) * z2 + F(0.05265332)) * z2 - F(0.11643287)) *
                  z2 +
              F(0.19354346)) *
                 z2 -
             F(0.33262348)) *
            z2;
  float a = z + z * q;
  a = ay > ax ? F(1.5707963267948966) - a : a;
  a = x < 0.0f ? F(3.141592653589793) - a : a;
  return y < 0.0f ? -a : a;
}

// the reciprocal of a gradient's offset range (p[17] - p[16]), or 0
__device__ __forceinline__ float offset_scale(const float* p) {
  float denom = p[17] - p[16];
  return fabsf(denom) > F(1e-9) ? 1.0f / denom : 0.0f;
}

// patterns.gradient_t_radial
__device__ float gradient_t_radial(const float* p, float lx, float ly,
                                   bool& in_tile) {
  float tx, ty;
  tile_coords(p, lx, ly, np_max(p[18], F(1e-6)), np_max(p[19], F(1e-6)),
              p[20], p[21], tx, ty, in_tile);
  float rx = p[10] > F(1e-6) ? p[10] : F(1e-6);
  float ry = p[11] > F(1e-6) ? p[11] : rx;
  float dx = tx - p[8];
  float dy = (ty - p[9]) * (rx / ry);
  float d = sqrtf(dx * dx + dy * dy) / rx;
  return (d - p[16]) * offset_scale(p);
}

// patterns.gradient_t_conic: the angle from atan2_shared, its turn fraction
// by IEEE division, then the floor-based fract
__device__ float gradient_t_conic(const float* p, float lx, float ly,
                                  bool& in_tile) {
  float tx, ty;
  tile_coords(p, lx, ly, np_max(p[18], F(1e-6)), np_max(p[19], F(1e-6)),
              p[20], p[21], tx, ty, in_tile);
  float dx = tx - p[8];
  float dy = ty - p[9];
  float theta = atan2_shared(dy, dx) + (F(1.5707963267948966) - p[10]);
  float tr = theta / F(6.283185307179586);
  tr = tr - floorf(tr);
  return (tr - p[16]) * offset_scale(p);
}

// patterns.rect_coverage with every edge anti-aliased
__device__ __forceinline__ float rect_coverage_aa(const float* rc, float lx,
                                                  float ly, float sx,
                                                  float sy) {
  float dl = (lx - rc[0]) * sx;
  float dr = (rc[2] - lx) * sx;
  float dt = (ly - rc[1]) * sy;
  float db = (rc[3] - ly) * sy;
  float cov_x = np_clip(np_min(dl, 0.5f) + np_min(dr, 0.5f), 0.0f, 1.0f);
  float cov_y = np_clip(np_min(dt, 0.5f) + np_min(db, 0.5f), 0.0f, 1.0f);
  return cov_x * cov_y;
}

// patterns._corner_coverage: first-order ellipse distance of one corner
__device__ float corner_coverage(float lx, float ly, float cx, float cy,
                                 float rx, float ry, float sgx, float sgy,
                                 float scale) {
  bool active = (rx > 0.0f) && (ry > 0.0f);
  float rxs = active ? rx : 1.0f;
  float rys = active ? ry : 1.0f;
  float dx = np_clip((cx - lx) * sgx, F(-1e6), F(1e6));
  float dy = np_clip((cy - ly) * sgy, F(-1e6), F(1e6));
  bool in_region = (dx > 0.0f) && (dy > 0.0f) && active;
  float ex = np_clip(dx / rxs, F(-1e4), F(1e4));
  float ey = np_clip(dy / rys, F(-1e4), F(1e4));
  float g = sqrtf(ex * ex + ey * ey);
  float gx = dx / (rxs * rxs);
  float gy = dy / (rys * rys);
  float grad = sqrtf(gx * gx + gy * gy);
  grad = grad > F(1e-6) ? grad : F(1e-6);
  float dist = (g - 1.0f) * g / grad;
  float cov = np_clip(0.5f - dist * scale, 0.0f, 1.0f);
  return in_region ? cov : 1.0f;
}

// patterns.rounded_rect_coverage: rect [0:4], radii [0:8]
__device__ float rounded_rect_coverage(const float* rc, const float* rd,
                                       float lx, float ly, float sx,
                                       float sy) {
  float cov = rect_coverage_aa(rc, lx, ly, sx, sy);
  float scale = sqrtf(sx * sy);
  cov = cov * corner_coverage(lx, ly, rc[0] + rd[0], rc[1] + rd[1], rd[0],
                              rd[1], 1.0f, 1.0f, scale);
  cov = cov * corner_coverage(lx, ly, rc[2] - rd[2], rc[1] + rd[3], rd[2],
                              rd[3], -1.0f, 1.0f, scale);
  cov = cov * corner_coverage(lx, ly, rc[2] - rd[4], rc[3] - rd[5], rd[4],
                              rd[5], -1.0f, -1.0f, scale);
  cov = cov * corner_coverage(lx, ly, rc[0] + rd[6], rc[3] - rd[7], rd[6],
                              rd[7], 1.0f, -1.0f, scale);
  return cov;
}

// patterns.erf (Abramowitz & Stegun 7.1.26); expf may differ from XLA's
// exp in the last ulp
__device__ float erf_shared(float x) {
  float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
  float ax = fabsf(x);
  float t = 1.0f / (1.0f + F(0.3275911) * ax);
  float y = 1.0f - (((((F(1.061405429) * t - F(1.453152027)) * t) +
                       F(1.421413741)) *
                          t -
                      F(0.284496736)) *
                         t +
                     F(0.254829592)) *
                        t * expf(-ax * ax);
  return s * y;
}

// patterns._blurred_rect_coverage
__device__ float blurred_rect_coverage(const float* rc, float sigma, float lx,
                                       float ly) {
  float s = (sigma > F(1e-3) ? sigma : F(1e-3)) * F(1.4142135623730951);
  float bx = 0.5f * (erf_shared((lx - rc[0]) / s) -
                     erf_shared((lx - rc[2]) / s));
  float by = 0.5f * (erf_shared((ly - rc[1]) / s) -
                     erf_shared((ly - rc[3]) / s));
  return bx * by;
}

// patterns._blurred_rounded_rect_coverage: the blurred rect less each
// corner's cut, integrated over 8 midpoints of its y-range
__device__ float blurred_rounded_rect_coverage(const float* rc,
                                               const float* rd, float sigma,
                                               float lx, float ly) {
  float sig = sigma > F(1e-3) ? sigma : F(1e-3);
  float s = sig * F(1.4142135623730951);
  float base = blurred_rect_coverage(rc, sigma, lx, ly);
  float invnorm = 1.0f / (sig * F(2.5066282746310002));
  for (int k = 0; k < 4; ++k) {  // TL, TR, BR, BL
    float rx = rd[2 * k], ry = rd[2 * k + 1];
    float ye = k < 2 ? rc[1] : rc[3];
    float sgn = k < 2 ? 1.0f : -1.0f;
    bool left = k == 0 || k == 3;
    bool act = (rx > F(1e-6)) && (ry > F(1e-6));
    float rys = ry > F(1e-6) ? ry : 1.0f;
    float rxs = rx > F(1e-6) ? rx : 1.0f;
    float c_lo = np_min(ye, ye + sgn * rys);
    float c_hi = np_max(ye, ye + sgn * rys);
    float lo = np_clip(ly - 4.0f * sig, c_lo, c_hi);
    float hi = np_clip(ly + 4.0f * sig, c_lo, c_hi);
    float step = np_max(hi - lo, 0.0f) / 8.0f;
    float corr = 0.0f;
    for (int i = 0; i < 8; ++i) {
      float yp = lo + (static_cast<float>(i) + 0.5f) * step;
      float dy = fabsf(yp - ye);
      float dc = 1.0f - dy / rys;
      float inset = rxs * (1.0f - sqrtf(np_clip(1.0f - dc * dc, 0.0f, 1.0f)));
      float covx = left ? 0.5f * (erf_shared((lx - rc[0]) / s) -
                                  erf_shared((lx - (rc[0] + inset)) / s))
                        : 0.5f * (erf_shared((lx - (rc[2] - inset)) / s) -
                                  erf_shared((lx - rc[2]) / s));
      float q = (yp - ly) / sig;
      float w = expf(F(-0.5) * (q * q)) * invnorm * step;
      corr = corr + w * covx;
    }
    base = base - (act ? corr : 0.0f);
  }
  return np_clip(base, 0.0f, 1.0f);
}

// patterns.pattern_box_shadow: [8:12] shadow rect, [12:20] its radii,
// [20] sigma, [21] inset, [22:26] box, [26:34] its radii, [34:38] color
__device__ void box_shadow(const float* r, float lx, float ly, float sx,
                           float sy, float color[4]) {
  float q[38];
#pragma unroll
  for (int k = 8; k < 38; ++k) q[k] = __ldg(r + k);
  const float sigma = q[20];
  float blurred;
  if (sigma <= F(1e-3)) {
    blurred = rounded_rect_coverage(q + 8, q + 12, lx, ly, sx, sy);
  } else {
    bool any_r = (q[12] + q[13] + q[14] + q[15] + q[16] + q[17] + q[18] +
                  q[19]) > F(1e-6);
    blurred = any_r
                  ? blurred_rounded_rect_coverage(q + 8, q + 12, sigma, lx, ly)
                  : blurred_rect_coverage(q + 8, sigma, lx, ly);
  }
  float box_cov = rounded_rect_coverage(q + 22, q + 26, lx, ly, sx, sy);
  float cov = q[21] > 0.5f ? (1.0f - blurred) * box_cov
                           : blurred * (1.0f - box_cov);
  cov = quantize_cov(cov, 255.0f) * F(1.0 / 255.0);
  for (int c = 0; c < 4; ++c) color[c] = q[34 + c] * cov;
}

// patterns.pattern_line_dec: [8:12] color, [12] style (1 dotted, 2 dashed,
// 3 wavy), [13] axis (1 vertical), [14] wavy line thickness
__device__ void line_dec(const float* p, float lx, float ly, float sx,
                         float sy, float color[4]) {
  const bool axis_v = p[13] > 0.5f;
  const float par = axis_v ? ly - p[1] : lx - p[0];
  const float perp = axis_v ? lx - p[0] : ly - p[1];
  const float hh = axis_v ? p[2] - p[0] : p[3] - p[1];
  const float aa = sqrtf(sx * sy);
  const float style = p[12];
  float alpha = 1.0f;
  if (style < 0.5f) {
    alpha = 1.0f;
  } else if (style < 1.5f) {  // dotted
    float diameter = np_clip(hh, 1.0f, 64.0f);
    float period = 2.0f * diameter;
    float pxd = par - floorf(par / period) * period;
    float pyd = perp - floorf(perp / diameter) * diameter;
    float rr = diameter * 0.5f;
    float ex = pxd - rr;
    float ey = pyd - rr;
    float dd = sqrtf(ex * ex + ey * ey) - rr;
    alpha = np_clip(0.5f - dd * aa, 0.0f, 1.0f);
  } else if (style < 2.5f) {  // dashed
    float dash = np_clip(3.0f * hh, 1.0f, 64.0f);
    float period = 2.0f * dash;
    float pxs = par - floorf(par / period) * period;
    alpha = floorf(pxs + 0.5f) <= dash ? 1.0f : 0.0f;
  } else {  // wavy
    float lt = np_max(p[14], 1.0f);
    float half_lt = lt * 0.5f;
    float slope = hh - lt;
    float flat = np_max((lt - 1.0f) * 2.0f, 1.0f);
    float half_period = slope + flat;
    float mid = hh * 0.5f;
    float m2 = par - floorf(par / (2.0f * half_period)) * (2.0f * half_period);
    float flip = m2 <= half_period ? -1.0f : 1.0f;
    float peak_h = mid + (mid - half_lt) * flip;
    float pxm = par - floorf(par / half_period) * half_period;
    float across = -flip * (peak_h - perp);
    float d1 = (1.0f * (0.0f - pxm) + across) * F(0.7071067811865476);
    float d2 = (0.0f * (0.0f - pxm) + across) * 1.0f;
    float d3 = (-1.0f * (flat - pxm) + across) * F(0.7071067811865476);
    float dist = fabsf(np_max(np_max(d1, d2), d3));
    float a = np_clip(0.5f - (dist - half_lt) * aa, 0.0f, 1.0f);
    alpha = half_lt <= 1.0f ? (a > 0.5f ? 1.0f : 0.0f) : a;
  }
  for (int c = 0; c < 4; ++c) color[c] = p[8 + c] * alpha;
}

// --- the mix-blend modes (blend._blend_case_int) on the u8 grid -------------

// swgl muldiv255
__device__ __forceinline__ float mul255(float x, float y) {
  return floorf((x * y + x) * F(1.0 / 256.0));
}

__device__ __forceinline__ float lum255(const float c[3]) {
  return F(0.3) * c[0] + F(0.59) * c[1] + F(0.11) * c[2];
}

// blend._set_lum255: base moved to ref's luminance, clipped into [0, alpha]
__device__ void set_lum255(const float base[3], const float ref[3],
                           float alpha, float c[3]) {
  const float lum = lum255(base);
  const float diff = lum255(ref) - lum;
  for (int k = 0; k < 3; ++k) c[k] = base[k] + diff;
  const float l = lum + diff;
  const float cmin = np_min(np_min(c[0], c[1]), c[2]);
  const float lo_safe = fabsf(l - cmin) > F(1e-6) ? l - cmin : F(1e-6);
  if (cmin < 0.0f) {
    const float q = l / lo_safe;
    for (int k = 0; k < 3; ++k) c[k] = l + (c[k] - l) * q;
  }
  const float cmax = np_max(np_max(c[0], c[1]), c[2]);
  const float hi_safe = fabsf(cmax - l) > F(1e-6) ? cmax - l : F(1e-6);
  if (cmax > alpha) {
    const float q = (alpha - l) / hi_safe;
    for (int k = 0; k < 3; ++k) c[k] = l + (c[k] - l) * q;
  }
}

// blend._set_lum_sat255
__device__ void set_lum_sat255(const float base[3], const float sref[3],
                               const float lref[3], float alpha, float c[3]) {
  const float cmin = np_min(np_min(base[0], base[1]), base[2]);
  const float cmax = np_max(np_max(base[0], base[1]), base[2]);
  const float d = cmax - cmin;
  const float smax = np_max(np_max(sref[0], sref[1]), sref[2]) -
                     np_min(np_min(sref[0], sref[1]), sref[2]);
  const float safe = d > F(1e-6) ? d : 1.0f;
  float scaled[3];
  for (int k = 0; k < 3; ++k)
    scaled[k] = d > F(1e-6) ? (base[k] - cmin) * (smax / safe) : 0.0f;
  set_lum255(scaled, lref, alpha, c);
}

// blend._blend_case_int for MixBlendMode 1-15 (op - BLEND_MIX_BASE): the
// unsaturated result of source s over destination d, u8 integers
__device__ void mix_blend(int mode, const float s[4], const float d[4],
                          float o[4]) {
  const float sA = s[3], dA = d[3];
  if (mode == 1) {  // multiply
    float diff[4];
    for (int c = 0; c < 3; ++c) diff[c] = mul255(sA - s[c], dA - d[c]);
    diff[3] = mul255(sA - 0.0f, dA - 0.0f);
    for (int c = 0; c < 3; ++c) o[c] = s[c] + d[c] + diff[c] - diff[3];
    o[3] = s[3] + d[3] + 0.0f - diff[3];
  } else if (mode == 2) {  // screen
    for (int c = 0; c < 4; ++c) o[c] = s[c] + d[c] - mul255(s[c], d[c]);
  } else if (mode == 3 || mode == 8) {  // overlay, hard-light
    float diff[4];
    for (int c = 0; c < 4; ++c)
      diff[c] = mul255(s[c], d[c]) + mul255(sA - s[c], dA - d[c]);
    for (int c = 0; c < 4; ++c) {
      const bool sel = mode == 3 ? d[c] * 2.0f <= dA : s[c] * 2.0f <= sA;
      const float rgb = c < 3 ? diff[c] : 0.0f;
      o[c] = s[c] + d[c] + (sel ? rgb - diff[3] : -diff[c]);
    }
  } else if (mode == 4 || mode == 5) {  // darken, lighten
    for (int c = 0; c < 4; ++c) {
      const float a = mul255(s[c], dA), b = mul255(d[c], sA);
      o[c] = s[c] + d[c] - (mode == 4 ? np_max(a, b) : np_min(a, b));
    }
  } else if (mode == 6 || mode == 7) {  // color-dodge, color-burn (FP)
    for (int c = 0; c < 4; ++c) {
      float t;
      if (mode == 6) {
        const float den = sA - s[c];
        const float recip = den != 0.0f ? 1.0f / den : 255.0f;
        t = np_min(dA, d[c] * sA * recip);
      } else {
        const float recip = s[c] != 0.0f ? 1.0f / s[c] : 255.0f;
        t = dA - np_min(dA, (dA - d[c]) * sA * recip);
      }
      const float term = sA * (c < 3 ? t : d[3]);
      const float v = (term + s[c] * (255.0f - dA) + d[c] * (255.0f - sA)) *
                      F(1.0 / 255.0);
      o[c] = floorf(v + 0.5f);
    }
  } else if (mode == 9) {  // soft-light (FP)
    for (int c = 0; c < 4; ++c) {
      const float dU = dA > 0.0f ? d[c] / dA : 0.0f;
      const float scale = s[c] + s[c] - sA;
      const float inv_sqrt = dU > 0.0f ? 1.0f / sqrtf(dU) : F(1e6);
      const float inner =
          scale < 0.0f ? 1.0f - dU
                       : np_min((16.0f * dU - 12.0f) * dU + 3.0f,
                                inv_sqrt - 1.0f);
      const float lane = c < 3 ? scale * inner : inner * 0.0f;
      const float v =
          (d[c] * (255.0f + lane) + s[c] * (255.0f - dA)) * F(1.0 / 255.0);
      o[c] = floorf(v + 0.5f);
    }
  } else if (mode == 10 || mode == 11) {  // difference, exclusion
    float diff[4];
    for (int c = 0; c < 4; ++c)
      diff[c] = mode == 10 ? np_min(mul255(d[c], sA), mul255(s[c], dA))
                           : mul255(s[c], d[c]);
    for (int c = 0; c < 4; ++c)
      o[c] = s[c] + d[c] - diff[c] - (c < 3 ? diff[c] : 0.0f);
  } else {  // hue, saturation, color, luminosity (FP at 0..255 scale)
    const float srcA = s[3] * F(1.0 / 255.0);
    const float dstA = d[3] * F(1.0 / 255.0);
    const float srcDstA = s[3] * dstA;
    float srcC[3], dstC[3], rgb[3];
    for (int c = 0; c < 3; ++c) {
      srcC[c] = s[c] * dstA;
      dstC[c] = d[c] * srcA;
    }
    if (mode == 12)
      set_lum_sat255(srcC, dstC, dstC, srcDstA, rgb);
    else if (mode == 13)
      set_lum_sat255(dstC, srcC, dstC, srcDstA, rgb);
    else if (mode == 14)
      set_lum255(srcC, dstC, srcDstA, rgb);
    else
      set_lum255(dstC, srcC, srcDstA, rgb);
    for (int c = 0; c < 3; ++c)
      o[c] = floorf(rgb[c] + s[c] - srcC[c] + d[c] - dstC[c] + 0.5f);
    o[3] = floorf(s[3] + d[3] - srcDstA + 0.5f);
  }
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
  // device pixels between two pixels of a tile.  It stands where the tile
  // count stood, which the kernel never read: a larger struct costs the
  // content and media builds 5 and 8 registers (ptxas, CUDA 12.9)
  float step;
  int slots;
};

// _sep_sample (tile_raster.py:640) in swgl mode: the four taps of each of
// the atlas's first kPlanes planes, combined by the truncating 7-bit lerp;
// uv = the uv rect (u0, v0, u1, v1).  Every tap lies in the window the TPU
// kernel DMAs, or, in a general tile, anywhere in the uv rect: the loads
// are direct (patterns.sample_rgba and sample_alpha).
template <int kPlanes = 4>
__device__ void sep_sample(const Atlas& at, float u, float v, const float* uv,
                           float nearest, float tex[kPlanes]) {
  float lo_u = uv[0] + 0.5f;
  float hi_u = np_max(uv[2] - 0.5f, lo_u);
  float lo_v = uv[1] + 0.5f;
  float hi_v = np_max(uv[3] - 0.5f, lo_v);
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
  for (int c = 0; c < kPlanes; ++c) {
    const float* pl = at.data + c * plane;
    float t00 = u8(tap(pl, H, W, y0, x0));
    float t10 = u8(tap(pl, H, W, y0, x1));
    float t01 = u8(tap(pl, H, W, y1, x0));
    float t11 = u8(tap(pl, H, W, y1, x1));
    tex[c] = fixed_bilinear(t00, t10, t01, t11, fx, fy);
  }
}

// blend._pow, srgb_to_linear and linear_to_srgb on straight values
__device__ __forceinline__ float pow_exp_log(float x, float y) {
  return expf(y * logf(np_max(x, F(1e-12))));
}
__device__ __forceinline__ float srgb_to_linear(float c) {
  return c <= F(0.04045)
             ? c / F(12.92)
             : pow_exp_log(np_max(c / F(1.055) + F(0.055 / 1.055), 0.0f),
                           F(2.4));
}
__device__ __forceinline__ float linear_to_srgb(float c) {
  return c <= F(0.0031308)
             ? c * F(12.92)
             : F(1.055) * pow_exp_log(np_max(c, 0.0f), F(1.0 / 2.4)) -
                   F(0.055);
}

// patterns.apply_color_matrix for flags 0 (passthrough), 1 (straight-alpha
// 4x5 matrix in sRGB) and, with kLinear, 2 (the same in linearRGB: the
// straight rgb converted first, the clipped result converted back); m =
// the record's payload [16:36].  Each row sums its five products left to
// right, as the reference does.
template <bool kLinear = false>
__device__ void color_matrix(float c[4], const float* m, float flag) {
  if (!(flag > 0.5f)) return;
  const float a = c[3];
  const float safe = a > F(1e-6) ? a : 1.0f;
  float r = c[0] / safe, g = c[1] / safe, b = c[2] / safe;
  const bool lin = kLinear && flag > 1.5f;
  if (lin) {
    r = srgb_to_linear(r);
    g = srgb_to_linear(g);
    b = srgb_to_linear(b);
  }
  float n[4];
  for (int k = 0; k < 4; ++k) {
    const float* row = m + 5 * k;
    n[k] = np_clip(__ldg(row) * r + __ldg(row + 1) * g + __ldg(row + 2) * b +
                       __ldg(row + 3) * a + __ldg(row + 4),
                   0.0f, 1.0f);
  }
  if (lin) {
    for (int k = 0; k < 3; ++k) n[k] = linear_to_srgb(n[k]);
  }
  c[0] = n[0] * n[3];
  c[1] = n[1] * n[3];
  c[2] = n[2] * n[3];
  c[3] = n[3];
}

__device__ __forceinline__ float f32_at(const Args& a, long long i) {
  return (i >= 0 && i < a.n_f32) ? __ldg(a.f32 + i) : 0.0f;
}

// grad_branch's stop evaluation (tile_raster.py:988-998, _eval_stops_row
// :329) for the radial and conic gradients: 8-float premultiplied stop
// records from the row of p[12], the repeat fract, the p[15] u8 quantize,
// and the tile mask.  The linear branch keeps its own copy inline: through
// this helper the browsing build takes 89 registers instead of 88.
// kExact (a general tile): the stops start at p[12] itself, any number of
// them (patterns.eval_gradient_stops).
template <bool kExact = false>
__device__ __forceinline__ void eval_stops(const Args& a, const float* p,
                                           float t, bool in_tile,
                                           float color[4]) {
  const long long base = kExact ? static_cast<int>(p[12])
                                : (static_cast<int>(p[12]) / 128) * 128LL;
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
}

// the clip-record coverage of the image-mask (kind 2) and box-shadow
// nine-patch (kind 4) clips, _mask_cov and _bs_cov (tile_raster.py:787-829):
// the color atlas's red plane, with u from the tile's first row of the
// clip's local x (lxr) and v from its first column of local y (lyc), as
// the TPU kernel samples them (a general tile passes every pixel's own lx
// and ly, and for the nine-patch the plain rect coverage as rect_cov:
// patterns.clip_coverage); cb = the record's [0:12]
__device__ float mask_clip_coverage(const Args& a, const float* crec,
                                    const float* cb, float ckind, float lxr,
                                    float lyc, float rect_cov) {
  float uv[4];
  for (int k = 0; k < 4; ++k) uv[k] = __ldg(crec + 16 + k);
  float mu, mv;
  if (ckind < 2.5f) {
    float rw = np_max(cb[2] - cb[0], F(1e-6));
    float rh = np_max(cb[3] - cb[1], F(1e-6));
    mu = uv[0] + (lxr - cb[0]) / rw * (uv[2] - uv[0]);
    mv = uv[1] + (lyc - cb[1]) / rh * (uv[3] - uv[1]);
    float m;
    sep_sample<1>(a.color, mu, mv, uv, 0.0f, &m);
    return m * rect_cov;
  }
  float dw = np_max(cb[2] - cb[0], F(1e-6));
  float dh = np_max(cb[3] - cb[1], F(1e-6));
  float aw = np_max(cb[4], F(1e-6));
  float ah = np_max(cb[5], F(1e-6));
  const bool st_x = cb[6] > 0.5f, st_y = cb[7] > 0.5f;  // stretch modes
  float u_lin = st_x ? (lxr - cb[0]) / aw : (lxr - cb[0]) / dw;
  float v_lin = st_y ? (lyc - cb[1]) / ah : (lyc - cb[1]) / dh;
  float e0x = st_x ? 0.5f : 1.0f;
  float e1x = st_x ? dw / aw - 0.5f : 1.0f;
  float e0y = st_y ? 0.5f : 1.0f;
  float e1y = st_y ? dh / ah - 0.5f : 1.0f;
  float uu = np_clip(u_lin, 0.0f, e0x) + np_max(0.0f, u_lin - e1x);
  float vv = np_clip(v_lin, 0.0f, e0y) + np_max(0.0f, v_lin - e1y);
  mu = uv[0] + uu * (uv[2] - uv[0]);
  mv = uv[1] + vv * (uv[3] - uv[1]);
  float texel;
  sep_sample<1>(a.color, mu, mv, uv, 0.0f, &texel);
  const float mode = __ldg(crec + 15);  // 0 outset, 1 inset
  float alpha = texel * (1.0f - mode) + (1.0f - texel) * mode;
  return mode * (1.0f - rect_cov) + alpha * rect_cov;
}

// patterns.polygon_coverage, the polygon clip (kind 3): 8 inward
// half-planes (a, b, c) at [24 + 3i] of the clip record, unit-normalized,
// unused ones padded with (0, 0, big); the minimum over them of
// clip(a * px + b * py + c + 0.5, 0, 1) at the pixel's device position
__device__ float polygon_coverage(const float* crec, float px, float py) {
  float cov = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float* e = crec + 24 + 3 * i;
    const float d = np_clip(
        __ldg(e) * px + __ldg(e + 1) * py + __ldg(e + 2) + 0.5f, 0.0f, 1.0f);
    cov = i == 0 ? d : np_min(cov, d);
  }
  return cov;
}

// The general tiles' glyph, subpixel glyph and picture (patterns.
// pattern_glyph, pattern_subpx_glyph, pattern_picture): what the separable
// branches of the kernel compute, from this pixel's own position (lx, ly;
// px, py for a picture mapped by device position).  They stand beside those
// branches, not inside them, so that the older builds compile the code
// they always did.
template <bool kLinear>
__device__ void gen_sampled(const Args& a, int kind, const float* r,
                            const float* p, float px, float py, float lx,
                            float ly, float color[4]) {
  const float su = (p[10] - p[8]) / np_max(p[2] - p[0], F(1e-6));
  const float sv = (p[11] - p[9]) / np_max(p[3] - p[1], F(1e-6));
  if (kind == K_GEN_PICTURE) {
    float u = p[8] + (px - p[0]) * su;
    float v = p[9] + (py - p[1]) * sv;
    if (__ldg(r + 37) > 0.5f) {
      const float scale = __ldg(r + 40);
      u = p[8] + lx * scale - __ldg(r + 38);
      v = p[9] + ly * scale - __ldg(r + 39);
    }
    float tex[4];
    sep_sample(a.surface, u, v, p + 8, 0.0f, tex);
    for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c];
    color_matrix<kLinear>(color, r + 16, __ldg(r + 36));
    return;
  }
  const float u = p[8] + (lx - p[0]) * su;
  const float v = p[9] + (ly - p[1]) * sv;
  if (kind == K_GEN_GLYPH) {
    float m;
    sep_sample<1>(a.alpha, u, v, p + 8, 0.0f, &m);
    for (int c = 0; c < 4; ++c) color[c] = p[12 + c] * m;
  } else {  // K_GEN_SUBPX
    float m[3];
    sep_sample<3>(a.color, u, v, p + 8, 0.0f, m);
    const float m_avg = (m[0] + m[1] + m[2]) * F(1.0 / 3.0);
    color[0] = m[0] * p[12];
    color[1] = m[1] * p[13];
    color[2] = m[2] * p[14];
    color[3] = m_avg * p[15];
  }
}

// The general tiles' video (patterns.pattern_yuv): the three planes at
// this pixel's own local position, the payload as in K_SEP_YUV.
__device__ void gen_yuv(const Args& a, const float* r, const float* p,
                        float lx, float ly, float color[4]) {
  const float oxl = lx - p[0];
  const float oyl = ly - p[1];
  float yy, uu, vv;
  sep_sample<1>(a.alpha, p[8] + oxl * p[22], p[9] + oyl * p[23], p + 8, 0.0f,
                &yy);
  sep_sample<1>(a.alpha, p[12] + oxl * p[24], p[13] + oyl * p[25], p + 12,
                0.0f, &uu);
  sep_sample<1>(a.alpha, p[16] + oxl * p[24], p[17] + oyl * p[25], p + 16,
                0.0f, &vv);
  const float sy_ = yy - __ldg(r + 36);
  const float su_ = uu - __ldg(r + 37);
  const float sv_ = vv - __ldg(r + 38);
  for (int c = 0; c < 3; ++c) {
    const float* m = r + 27 + 3 * c;
    color[c] = np_clip(
        __ldg(m) * sy_ + __ldg(m + 1) * su_ + __ldg(m + 2) * sv_, 0.0f, 1.0f);
  }
  color[3] = 1.0f;
}

// --- the SVG filter ops: blend.compose_swgl's float domain ------------------

// dense.FLOAT_BLENDS: the ops compose_swgl blends in the float domain
__device__ __forceinline__ bool is_float_op(int op) {
  return (op >= 2 && op <= 6) || op >= 40;
}

// blend.premult_srgb_to_linear (kToLinear) and premult_linear_to_srgb: the
// straight rgb converted, premultiplied again by the unchanged alpha
template <bool kToLinear>
__device__ void premult_convert(float c[4]) {
  const float a = c[3];
  const float safe = a > F(1e-6) ? a : 1.0f;
  for (int k = 0; k < 3; ++k) {
    const float v = c[k] / safe;
    c[k] = (kToLinear ? srgb_to_linear(v) : linear_to_srgb(v)) * a;
  }
}

// blend._lum, _clip_color, _set_lum, _sat and _set_sat: the float HSL
// helpers on straight rgb in [0, 1] (not the u8-grid swgl ones above)
__device__ __forceinline__ float lum_f(const float c[3]) {
  return F(0.3) * c[0] + F(0.59) * c[1] + F(0.11) * c[2];
}

__device__ void set_lum_f(float c[3], float l) {
  const float shift = l - lum_f(c);
  for (int k = 0; k < 3; ++k) c[k] = c[k] + shift;
  // _clip_color: both clips around the luminance before them
  const float ll = lum_f(c);
  const float n = np_min(np_min(c[0], c[1]), c[2]);
  const float dn = fabsf(ll - n) > F(1e-6) ? ll - n : F(1e-6);
  if (n < 0.0f) {
    const float q = ll / dn;
    for (int k = 0; k < 3; ++k) c[k] = ll + (c[k] - ll) * q;
  }
  const float x = np_max(np_max(c[0], c[1]), c[2]);
  const float dx = fabsf(x - ll) > F(1e-6) ? x - ll : F(1e-6);
  if (x > 1.0f) {
    const float q = (1.0f - ll) / dx;
    for (int k = 0; k < 3; ++k) c[k] = ll + (c[k] - ll) * q;
  }
}

__device__ __forceinline__ float sat_f(const float c[3]) {
  return np_max(np_max(c[0], c[1]), c[2]) - np_min(np_min(c[0], c[1]), c[2]);
}

__device__ void set_sat_f(float c[3], float s) {
  const float cmin = np_min(np_min(c[0], c[1]), c[2]);
  const float cmax = np_max(np_max(c[0], c[1]), c[2]);
  const float d = cmax - cmin;
  const float safe = d > F(1e-6) ? d : 1.0f;
  for (int k = 0; k < 3; ++k)
    c[k] = d > F(1e-6) ? (c[k] - cmin) * (s / safe) : 0.0f;
}

// blend.mix_blend_rgb's hard-light of source s over backdrop b
__device__ __forceinline__ float hard_light_f(float b, float s) {
  const float t = 2.0f * s - 1.0f;
  return s <= 0.5f ? b * (2.0f * s) : b + t - b * t;
}

// blend.mix_blend_rgb, one channel, for the separable modes 1-11
__device__ float mix_channel_f(int mode, float cb, float cs) {
  switch (mode) {
    case 1:  // multiply
      return cb * cs;
    case 2:  // screen
      return cb + cs - cb * cs;
    case 3:  // overlay: hard-light with the operands swapped
      return hard_light_f(cs, cb);
    case 4:  // darken
      return np_min(cb, cs);
    case 5:  // lighten
      return np_max(cb, cs);
    case 6: {  // color-dodge
      const float safe = cs < 1.0f ? 1.0f - cs : F(1e-6);
      const float out = np_min(1.0f, cb / safe);
      return cb <= 0.0f ? 0.0f : (cs >= 1.0f ? 1.0f : out);
    }
    case 7: {  // color-burn
      const float safe = cs > 0.0f ? cs : F(1e-6);
      const float out = 1.0f - np_min(1.0f, (1.0f - cb) / safe);
      return cb >= 1.0f ? 1.0f : (cs <= 0.0f ? 0.0f : out);
    }
    case 8:  // hard-light
      return hard_light_f(cb, cs);
    case 9: {  // soft-light
      const float d_lo = ((16.0f * cb - 12.0f) * cb + 4.0f) * cb;
      const float d_hi = sqrtf(np_max(cb, 0.0f));
      const float d = cb <= 0.25f ? d_lo : d_hi;
      return cs <= 0.5f ? cb - (1.0f - 2.0f * cs) * cb * (1.0f - cb)
                        : cb + (2.0f * cs - 1.0f) * (d - cb);
    }
    case 10:  // difference
      return fabsf(cb - cs);
    case 11:  // exclusion
      return cb + cs - 2.0f * cb * cs;
    default:  // any other mode blends as the source
      return cs;
  }
}

// blend.mix_blend_rgb B(cb, cs) for MixBlendMode `mode` (not 0 or 16)
__device__ void mix_blend_rgb(int mode, const float cb[3], const float cs[3],
                              float b[3]) {
  if (mode >= 12 && mode <= 15) {  // hue, saturation, color, luminosity
    const float* base = (mode == 12 || mode == 14) ? cs : cb;
    for (int k = 0; k < 3; ++k) b[k] = base[k];
    if (mode == 12) set_sat_f(b, sat_f(cb));
    if (mode == 13) set_sat_f(b, sat_f(cs));
    set_lum_f(b, lum_f(mode == 15 ? cs : cb));
    return;
  }
  for (int k = 0; k < 3; ++k) b[k] = mix_channel_f(mode, cb[k], cs[k]);
}

// blend.blend_src_over_dst for the ops below 64 (an op from 64 is the same
// op less 64, converted around: compose_float), premultiplied s over d
__device__ void blend_float(int op, const float s[4], const float d[4],
                            float o[4]) {
  if (op >= 40) op = BLEND_MIX_BASE + (op - 40);  // SVGFE mix = its mode
  if (op >= 2 && op <= 8) {
    for (int c = 0; c < 4; ++c) {
      if (op == 2)  // in
        o[c] = s[c] * d[3];
      else if (op == 3)  // out
        o[c] = s[c] * (1.0f - d[3]);
      else if (op == 4)  // atop
        o[c] = s[c] * d[3] + d[c] * (1.0f - s[3]);
      else if (op == 5)  // xor
        o[c] = s[c] * (1.0f - d[3]) + d[c] * (1.0f - s[3]);
      else if (op == 6)  // lighter
        o[c] = np_min(s[c] + d[c], 1.0f);
      else if (op == BLEND_CH_CLEAR)
        o[c] = d[c] * (1.0f - s[c]);
      else  // BLEND_ADD
        o[c] = np_min(d[c] + s[c], 1.0f);
    }
    return;
  }
  if (op == BLEND_CLEAR) {
    for (int c = 0; c < 4; ++c) o[c] = d[c] * (1.0f - s[3]);
    return;
  }
  const int mode = op - BLEND_MIX_BASE;
  if (op < BLEND_MIX_BASE || mode == 0) {  // normal
    for (int c = 0; c < 4; ++c) o[c] = s[c] + d[c] * (1.0f - s[3]);
    return;
  }
  if (mode == 16) {  // plus-lighter
    for (int c = 0; c < 4; ++c) o[c] = np_min(s[c] + d[c], 1.0f);
    return;
  }
  // W3C compositing in premultiplied form
  const float a_s = s[3], a_b = d[3];
  const float safe_s = a_s > F(1e-6) ? a_s : 1.0f;
  const float safe_b = a_b > F(1e-6) ? a_b : 1.0f;
  float cs[3], cb[3], b[3];
  for (int k = 0; k < 3; ++k) {
    cs[k] = s[k] / safe_s;
    cb[k] = d[k] / safe_b;
  }
  mix_blend_rgb(mode, cb, cs, b);
  for (int k = 0; k < 3; ++k)
    o[k] = (1.0f - a_b) * s[k] + a_b * a_s * b[k] + (1.0f - a_s) * d[k];
  o[3] = a_s + a_b * (1.0f - a_s);
}

// compose_swgl's float domain: src = color * (cov * mcov) blended over the
// accumulator in f32 (in linearRGB for ops from 64), then _pack_float
__device__ void compose_float(int op, const float color[4], float cov,
                              float mcov, float acc[4]) {
  const float w = cov * mcov;
  float s[4], d[4], o[4];
  for (int c = 0; c < 4; ++c) {
    s[c] = color[c] * w;
    d[c] = acc[c];
  }
  const bool lin = op >= 64;
  if (lin) {
    premult_convert<true>(s);
    premult_convert<true>(d);
    op -= 64;
  }
  blend_float(op, s, d, o);
  if (lin) premult_convert<false>(o);
  for (int c = 0; c < 4; ++c)
    acc[c] = np_clip(rintf(o[c] * 255.0f), 0.0f, 255.0f) * F(1.0 / 255.0);
}

// kSurfaceKinds: the alpha and surface atlases' samplers and the color
// matrix (KIND_GLYPH, KIND_PICTURE, K_SEP_PICTURE).  kContent (only with
// kSurfaceKinds): radial and conic gradients, KIND_BOX_SHADOW and
// KIND_LINE_DEC, the image-mask and box-shadow clips (the TPU kernel's
// mask_clips) and the mix-blend ops 16-32.  kMedia (only with kContent):
// scaled text (K_SEP_GLYPH, K_SEP_SUBPX), video (K_SEP_YUV), KIND_CLEAR and
// BLEND_CLEAR.  kGeneral (only with kMedia): the general tiles (records with
// REC_GENERAL: the K_GEN_* kinds, the per-pixel clip chain, the stops at
// their own address), the step and the polygon clip.  kFilter (only with
// kGeneral): the float-domain blend ops and color-matrix flag 2.
template <bool kSurfaceKinds, bool kContent, bool kMedia, bool kGeneral,
          bool kFilter>
__global__ void __launch_bounds__(TILE_W * ROWS)
tile_raster_kernel(Args a) {
  static_assert(kSurfaceKinds || !kContent, "content builds hold surfaces");
  static_assert(kContent || !kMedia, "the media build holds content");
  static_assert(kMedia || !kGeneral, "the general build holds the media");
  static_assert(kGeneral || !kFilter, "the filter build holds every branch");
  const int groups = TILE_H / ROWS;
  const int tile = blockIdx.x / groups;
  const int row = (blockIdx.x % groups) * ROWS + threadIdx.y;
  const int col = threadIdx.x;
  const float ox = __ldg(a.origins + 2 * tile);
  const float oy = __ldg(a.origins + 2 * tile + 1);
  const float px = kGeneral
                       ? ox + (static_cast<float>(col) + 0.5f) * a.step
                       : ox + static_cast<float>(col) + 0.5f;
  const float py = kGeneral
                       ? oy + (static_cast<float>(row) + 0.5f) * a.step
                       : oy + static_cast<float>(row) + 0.5f;
  float acc[4];
  if (a.init != nullptr) {
    const float* in = a.init + static_cast<long long>(tile) * 4 * TILE_H *
                                   TILE_W + row * TILE_W + col;
    for (int c = 0; c < 4; ++c) acc[c] = __ldg(in + c * TILE_H * TILE_W);
  } else {
    for (int c = 0; c < 4; ++c) acc[c] = __ldg(a.clear + c);
  }
  const long long n_rows = a.n_f32 / REC;
  const int slots = kGeneral ? (a.slots & ~kNoMaskClips) : a.slots;
  const bool no_mask_clips = kGeneral && (a.slots & kNoMaskClips) != 0;

  // a tile's count never reads past its own slots
  const int cnt = min(max(__ldg(a.counts + tile), 0), slots);
  for (int i = 0; i < cnt; ++i) {
    const float* r =
        a.dense + (static_cast<long long>(tile) * slots + i) * REC;
    float p[26];  // the payload prefix the ported kinds read
#pragma unroll
    for (int k = 0; k < 26; ++k) p[k] = __ldg(r + k);
    float tr[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) tr[k] = __ldg(r + REC_TROW + k);
    const int kind = static_cast<int>(__ldg(r + REC_KIND));
    const int op = static_cast<int>(__ldg(r + REC_BLEND));
    const bool float_op = kFilter && is_float_op(op);
    const int edge_aa = static_cast<int>(__ldg(r + REC_EDGE));
    const int n_clip = static_cast<int>(__ldg(r + REC_CLIP_COUNT));
    const int clip_row = static_cast<int>(__ldg(r + REC_CLIP_ROW));
    const bool general = kGeneral && __ldg(r + REC_GENERAL) > 0.5f;

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
      } else if (kGeneral && ckind >= 1.5f &&
                 ((no_mask_clips && !general) ||
                  (ckind >= 2.5f && ckind < 3.5f))) {
        // kind 3, and without mask_clips kinds 2 and 4 outside a general
        // tile (tile_raster.py:842-847, patterns.clip_coverage)
        ccov = polygon_coverage(crec, px, py);
      } else if (kContent && ckind >= 1.5f) {
        // kinds 2 and 4 (kind 3, the polygon, is the branch above: only
        // the general and filter builds see it)
        float rect_cov = rect_coverage_auto(ct, cb[0], cb[1], cb[2], cb[3],
                                            clx, cly, px, py, 0xF);
        if (kGeneral && general) {
          // patterns.clip_coverage: the mask at this pixel's own position;
          // the nine-patch with the plain rect coverage
          if (ckind >= 3.5f)
            rect_cov = rect_coverage_aa(cb, clx, cly, ct[9], ct[10]);
          ccov = mask_clip_coverage(a, crec, cb, ckind, clx, cly, rect_cov);
        } else {
          float lxr, lyc, dummy;
          inverse_map(ct, px, oy + 0.5f, lxr, dummy);
          inverse_map(ct, ox + 0.5f, py, dummy, lyc);
          ccov = mask_clip_coverage(a, crec, cb, ckind, lxr, lyc, rect_cov);
        }
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
    // fragments with zero geometric coverage are never rasterized, but in
    // the float domain, which composites color * 0 there
    if (!(cov > 0.0f) && !float_op) continue;

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
      // stops: 8-float records from the row of p[12] (a general tile's
      // from p[12] itself), premultiplied
      const long long base = general
                                 ? static_cast<int>(p[12])
                                 : (static_cast<int>(p[12]) / 128) * 128LL;
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
    } else if (kContent &&
               (kind == KIND_RADIAL_GRAD || kind == KIND_CONIC_GRAD)) {
      bool in_tile;
      const float t = kind == KIND_RADIAL_GRAD
                          ? gradient_t_radial(p, lx, ly, in_tile)
                          : gradient_t_conic(p, lx, ly, in_tile);
      if (kGeneral && general)
        eval_stops<true>(a, p, t, in_tile, color);
      else
        eval_stops(a, p, t, in_tile, color);
    } else if (kContent && kind == KIND_BOX_SHADOW) {
      box_shadow(r, lx, ly, tr[9], tr[10], color);
    } else if (kContent && kind == KIND_LINE_DEC) {
      line_dec(p, lx, ly, tr[9], tr[10], color);
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
        color_matrix<kFilter>(color, r + 16, __ldg(r + 36));
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
      sep_sample(a.color, u, v, p + 8, p[16], tex);
      float in_t = in_x * in_y;
      for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c] * in_t;
    } else if (kGeneral && kind == K_GEN_IMAGE) {
      // patterns.pattern_image: the repeat tiling of this pixel's own
      // local position (no clamp into the rect), the 2-D sample
      float tx, ty;
      bool in_tile;
      tile_coords(p, lx, ly, np_max(p[18], F(1e-6)), np_max(p[19], F(1e-6)),
                  p[20], p[21], tx, ty, in_tile);
      float u = p[8] + tx * p[22] - p[24];
      float v = p[9] + ty * p[23] - p[25];
      float tex[4];
      sep_sample(a.color, u, v, p + 8, p[16], tex);
      const float in_t = in_tile ? 1.0f : 0.0f;
      for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c] * in_t;
    } else if (kGeneral && kind >= K_GEN_GLYPH) {
      gen_sampled<kFilter>(a, kind, r, p, px, py, lx, ly, color);
    } else if (kGeneral && kind == K_GEN_YUV) {
      gen_yuv(a, r, p, lx, ly, color);
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
      sep_sample(a.surface, u, v, p + 8, 0.0f, tex);
      for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c];
      color_matrix<kFilter>(color, r + 16, __ldg(r + 36));
    } else if (kMedia && kind == KIND_CLEAR) {
      // _pattern_math (tile_raster.py:377): ones; BLEND_CLEAR punches the
      // destination by the source's alpha
      for (int c = 0; c < 4; ++c) color[c] = 1.0f;
    } else if (kMedia && (kind == K_SEP_GLYPH || kind == K_SEP_SUBPX)) {
      // scaled text (tile_raster.py:1036): the glyph's uv rect over its
      // local rect, u from the tile's first row of lx, v from its first
      // column of ly
      float lx_row, ly_col, dummy;
      inverse_map(tr, px, oy + 0.5f, lx_row, dummy);
      inverse_map(tr, ox + 0.5f, py, dummy, ly_col);
      float su = (p[10] - p[8]) / np_max(p[2] - p[0], F(1e-6));
      float sv = (p[11] - p[9]) / np_max(p[3] - p[1], F(1e-6));
      float u = p[8] + (lx_row - p[0]) * su;
      float v = p[9] + (ly_col - p[1]) * sv;
      if (kind == K_SEP_GLYPH) {
        float m;
        sep_sample<1>(a.alpha, u, v, p + 8, 0.0f, &m);
        for (int c = 0; c < 4; ++c) color[c] = p[12 + c] * m;
      } else {
        float m[3];
        sep_sample<3>(a.color, u, v, p + 8, 0.0f, m);
        float m_avg = (m[0] + m[1] + m[2]) * F(1.0 / 3.0);
        color[0] = m[0] * p[12];
        color[1] = m[1] * p[13];
        color[2] = m[2] * p[14];
        color[3] = m_avg * p[15];
      }
    } else if (kMedia && kind == K_SEP_YUV) {
      // video (tile_raster.py:1051; the payload of patterns.pattern_yuv):
      // the Y, U and V planes of the alpha atlas at their own uv rects
      // ([8:12], [12:16], [16:20]) and scales ([22:24] luma, [24:26]
      // chroma), always bilinear (the TPU kernel does not read the nearest
      // flag [26]); less the zero points [36:39]; the 3x3 matrix [27:36],
      // each row summed left to right; clipped; alpha 1
      float lx_row, ly_col, dummy;
      inverse_map(tr, px, oy + 0.5f, lx_row, dummy);
      inverse_map(tr, ox + 0.5f, py, dummy, ly_col);
      float oxl = lx_row - p[0];
      float oyl = ly_col - p[1];
      float yy, uu, vv;
      sep_sample<1>(a.alpha, p[8] + oxl * p[22], p[9] + oyl * p[23], p + 8,
                    0.0f, &yy);
      sep_sample<1>(a.alpha, p[12] + oxl * p[24], p[13] + oyl * p[25], p + 12,
                    0.0f, &uu);
      sep_sample<1>(a.alpha, p[16] + oxl * p[24], p[17] + oyl * p[25], p + 16,
                    0.0f, &vv);
      float sy_ = yy - __ldg(r + 36);
      float su_ = uu - __ldg(r + 37);
      float sv_ = vv - __ldg(r + 38);
      for (int c = 0; c < 3; ++c) {
        const float* m = r + 27 + 3 * c;
        color[c] = np_clip(
            __ldg(m) * sy_ + __ldg(m + 1) * su_ + __ldg(m + 2) * sv_, 0.0f,
            1.0f);
      }
      color[3] = 1.0f;
    } else {
      // unported kinds never reach the kernel (the wrapper raises first),
      // and each kind reaches only a build that holds it
      continue;
    }

    if (float_op) {
      compose_float(op, color, cov, mcov, acc);
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
    if (kContent && op > BLEND_MIX_BASE && op < BLEND_MIX_BASE + 16) {
      mix_blend(op - BLEND_MIX_BASE, s, d, o);
    } else {
      for (int c = 0; c < 4; ++c) {
        if (op == BLEND_CH_CLEAR) {
          o[c] = d[c] - floorf((d[c] * s[c] + d[c]) * F(1.0 / 256.0));
        } else if (kMedia && op == BLEND_CLEAR) {
          o[c] = d[c] - floorf((d[c] * s[3] + d[c]) * F(1.0 / 256.0));
        } else if (op == BLEND_ADD ||
                   (kContent && op == BLEND_MIX_BASE + 16)) {  // plus-lighter
          o[c] = s[c] + d[c];
        } else {  // BLEND_NORMAL (0), and mix-blend normal (16)
          o[c] = s[c] + d[c] - floorf((d[c] * s[3] + d[c]) * F(1.0 / 256.0));
        }
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
                              int slots, int surface_kinds, int content,
                              int media, int general, int filter, float step,
                              void* stream) {
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
         step,
         slots};
  dim3 block(TILE_W, ROWS);
  dim3 grid(static_cast<unsigned>(nt) * (TILE_H / ROWS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (filter)
    tile_raster_kernel<true, true, true, true, true><<<grid, block, 0, st>>>(
        a);
  else if (general)
    tile_raster_kernel<true, true, true, true, false><<<grid, block, 0, st>>>(
        a);
  else if (media)
    tile_raster_kernel<true, true, true, false, false>
        <<<grid, block, 0, st>>>(a);
  else if (content)
    tile_raster_kernel<true, true, false, false, false>
        <<<grid, block, 0, st>>>(a);
  else if (surface_kinds)
    tile_raster_kernel<true, false, false, false, false>
        <<<grid, block, 0, st>>>(a);
  else
    tile_raster_kernel<false, false, false, false, false>
        <<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
