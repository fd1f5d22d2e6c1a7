// Tile-raster kernel for Hopper (sm_90a).
//
// Replaces webrender_tpu/ops/pallas/tile_raster.py::render_tiles_pallas_dense
// (its pl.pallas_call at :1175), every branch of it: KIND_SOLID; linear,
// radial and conic gradients (the conic angle through the shared
// polynomial atan2); KIND_CLEAR; KIND_BOX_SHADOW (sharp and blurred arms),
// KIND_BORDER and KIND_LINE_DEC (dotted, dashed, wavy); the translation fast path of KIND_GLYPH (alpha
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
// Design.  A block draws 8 rows of one 128x64 tile with 128x2 threads,
// four pixels a thread (rows threadIdx.y, +2, +4, +6), the accumulators in
// shared memory, so the tile never round-trips through device memory
// between records.  The tile's records reach the block in chunks of 16
// with the clip rows they name (16 a chunk), copied into shared memory by
// cp.async, so no pixel loads a record or a clip row from device memory (a
// record whose chain holds more than 16 clips, deeper than any page here
// nests them, reads its rows from the f32 buffer).  A prologue per chunk
// decodes each record once (its kind, op, flags, clip rows, the linear
// gradient's record-uniform terms) into the padding of its staged row,
// and tests each (record, run) pair: a run is the 32 pixels of one row
// that a warp draws, and a warp skips a record whose run no pixel of it
// can cover (run_may_draw: exact, so skipping changes no bit).  On the 4K
// pages about two thirds of the (pixel, record) pairs skip.  The inverse
// map divides only where w is not exactly 1.  The TPU kernel's DMA
// windows, lane rolls and one-hot MXU contractions are exact gathers of
// four texels; here they are direct loads of those texels, and a tap
// outside the atlas reads 0 (such pixels have zero coverage).  Measured on
// an H100 and dropped (kernel_ab.py): double-buffering the chunks (most
// tiles hold one chunk) and the zero-coverage test before the clip chain
// (a warp the culling keeps runs the chain for its covered lanes anyway).
//
// Eight instantiations.  The wrapper picks one from the dispatch's kinds,
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
// its code; a sixth (gl), with the filter build's, serves every dispatch of
// a frame built with gl_flavor (below); a seventh (border), with the filter
// build's, serves any other dispatch that holds KIND_BORDER (below), and
// the gl build holds it too.
//
// Borders.  KIND_BORDER is patterns.pattern_border: one whole normal border
// of one instance (ring coverage, the owning side by normalised depth, the
// two tones of groove and ridge, double's thirds, dotted and dashed
// layouts).  No frame builder emits it (borders become cached image
// segments), but the TPU kernel draws it and so does this one; a frame
// made by hand reaches it (scenes.border_frame).
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
// GL flavour.  A frame built with gl_flavor (the reftest lines whose
// reference images come from the GL renderer, llvmpipe) takes a seventh
// build, gl: the filter build plus kGl.  Under it blend ops 0, 1, 7 and 8
// compose as blend.compose_gl (src = color * (cov * mcov), packed round-
// half-even; the destination factor rint(d * (255 - a) * (1/255)), the
// result kept where cov > 0), every other op as before; the clip-mask chain
// is blend.gl_mask_combine, rint(c8 * m8 * (1/255)); and the image-mask
// and nine-patch clips sample in _sep_sample's llvm mode
// (patterns.sample_alpha_llvm: 8-bit fractions, llvmpipe's per-axis
// rounded integer lerp), in both clip chains.  The six other builds
// compile with kGl false and hold none of it.
//
// Bound.  At 4K a frame is ~8 M pixels x up to 128 records; the work is
// per-pixel f32 arithmetic plus texel loads that hit L1/L2, so the kernel
// is bound by issue rate, not device memory (ops/roofline.py counts both;
// its count charges every record's coverage at every pixel, more than this
// kernel computes).
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
#include <string.h>

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
constexpr int KIND_BORDER = 9;
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

__device__ __forceinline__ void inverse_map(const float* t, float px,
                                            float py, float& lx, float& ly) {
  float u = px * t[0] + py * t[3] + t[6];
  float v = px * t[1] + py * t[4] + t[7];
  float w = px * t[2] + py * t[5] + t[8];
  if (w == 1.0f) {  // u / 1 and v / 1 are u and v: no division
    lx = u;
    ly = v;
    return;
  }
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
  float dlx = t[0] - lx * t[2];
  float dly = t[1] - ly * t[2];
  if (w != 1.0f) {  // a quotient by 1 is the dividend
    dlx = dlx / w;
    dly = dly / w;
  }
  return fabsf(dlx) + fabsf(dly);
}

// the transform row's is_tx flag (bit 2 of t[11]): coverage by the
// distance in local pixels instead of the per-axis scales
__device__ __forceinline__ bool row_is_tx(const float* t) {
  // numpy's floor(t[11] / 4) % 2 >= 1, without fmodf: the floor is odd
  // (every float from 2^24 up is even; inf and NaN give NaN, not >= 1)
  const float f = floorf(t[11] * 0.25f);
  return fabsf(f) < 16777216.0f && (static_cast<int>(f) & 1) != 0;
}

// patterns.rect_coverage_auto, with the row's is_tx given
__device__ float rect_coverage_tx(const float* t, bool is_tx, float x0,
                                  float y0, float x1, float y1, float lx,
                                  float ly, float px, float py, int edge_aa) {
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

// patterns.rect_coverage_auto
__device__ __forceinline__ float rect_coverage_auto(const float* t, float x0,
                                                    float y0, float x1,
                                                    float y1, float lx,
                                                    float ly, float px,
                                                    float py, int edge_aa) {
  return rect_coverage_tx(t, row_is_tx(t), x0, y0, x1, y1, lx, ly, px, py,
                          edge_aa);
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
  const float* q = r;
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

// patterns.pattern_border's corner_zone: whether the pixel lies in the box
// of one rounded corner, and its distance from the corner's outer ellipse
// (first order, local units, positive outside)
__device__ __forceinline__ void border_corner_zone(float lx, float ly,
                                                   float cx, float cy,
                                                   float rx, float ry,
                                                   float sgx, float sgy,
                                                   bool& inside,
                                                   float& dist) {
  const bool act = (rx > 0.0f) && (ry > 0.0f);
  const float rxs = act ? rx : 1.0f;
  const float rys = act ? ry : 1.0f;
  const float dx = np_clip((cx - lx) * sgx, F(-1e6), F(1e6));
  const float dy = np_clip((cy - ly) * sgy, F(-1e6), F(1e6));
  inside = (dx > 0.0f) && (dy > 0.0f) && act;
  const float ex = np_clip(dx / rxs, F(-1e4), F(1e4));
  const float ey = np_clip(dy / rys, F(-1e4), F(1e4));
  const float g = sqrtf(ex * ex + ey * ey);
  const float gx = dx / (rxs * rxs);
  const float gy = dy / (rys * rys);
  float grad = sqrtf(gx * gx + gy * gy);
  grad = grad > F(1e-6) ? grad : F(1e-6);
  dist = (g - 1.0f) * g / grad;
}

// patterns.pattern_border (KIND_BORDER, tile_raster.py:381-382): one whole
// normal border.  [0:4] outer rect, [8:12] widths (top, right, bottom,
// left), [12:20] radii, [20:36] the outer halves' premultiplied colours by
// side, [36:52] the inner halves', [52:56] styles (0 none, 2 double, 3
// dotted, 4 dashed, 5 hidden; groove and ridge are the two halves' tones).
// The ring is the outer rounded rect less the inner one; the pixel belongs
// to the side of least normalised depth (radially from the outer ellipse
// inside a corner's box), and its colour is that side's: the plain version
// evaluates all four sides and keeps the owner's (xp.where), so only the
// owner's is evaluated here.
__device__ void border(const float* p, float lx, float ly, float sx,
                       float sy, float color[4]) {
  const float x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3];
  const float w_t = p[8], w_r = p[9], w_b = p[10], w_l = p[11];
  const float* rd = p + 12;
  const float eps = F(1e-6);
  const float big = F(1e9);
  const float outer = rounded_rect_coverage(p, rd, lx, ly, sx, sy);
  // the inner rounded rect, as patterns.rounded_rect_coverage computes it
  const float ix0 = x0 + w_l, iy0 = y0 + w_t;
  const float ix1 = x1 - w_r, iy1 = y1 - w_b;
  const float ir0 = np_max(rd[0] - w_l, 0.0f), ir1 = np_max(rd[1] - w_t, 0.0f);
  const float ir2 = np_max(rd[2] - w_r, 0.0f), ir3 = np_max(rd[3] - w_t, 0.0f);
  const float ir4 = np_max(rd[4] - w_r, 0.0f), ir5 = np_max(rd[5] - w_b, 0.0f);
  const float ir6 = np_max(rd[6] - w_l, 0.0f), ir7 = np_max(rd[7] - w_b, 0.0f);
  float inner;
  {
    const float dl = (lx - ix0) * sx;
    const float dr = (ix1 - lx) * sx;
    const float dt = (ly - iy0) * sy;
    const float db = (iy1 - ly) * sy;
    const float cov_x = np_clip(np_min(dl, 0.5f) + np_min(dr, 0.5f), 0.0f,
                                1.0f);
    const float cov_y = np_clip(np_min(dt, 0.5f) + np_min(db, 0.5f), 0.0f,
                                1.0f);
    const float scale = sqrtf(sx * sy);
    inner = cov_x * cov_y;
    inner = inner * corner_coverage(lx, ly, ix0 + ir0, iy0 + ir1, ir0, ir1,
                                    1.0f, 1.0f, scale);
    inner = inner * corner_coverage(lx, ly, ix1 - ir2, iy0 + ir3, ir2, ir3,
                                    -1.0f, 1.0f, scale);
    inner = inner * corner_coverage(lx, ly, ix1 - ir4, iy1 - ir5, ir4, ir5,
                                    -1.0f, -1.0f, scale);
    inner = inner * corner_coverage(lx, ly, ix0 + ir6, iy1 - ir7, ir6, ir7,
                                    1.0f, -1.0f, scale);
  }
  inner = (ix1 > ix0) && (iy1 > iy0) ? inner : 0.0f;
  const float ring = outer * (1.0f - inner);

  bool in_tl, in_tr, in_br, in_bl;
  float d_tl, d_tr, d_br, d_bl;
  border_corner_zone(lx, ly, x0 + rd[0], y0 + rd[1], rd[0], rd[1], 1.0f,
                     1.0f, in_tl, d_tl);
  border_corner_zone(lx, ly, x1 - rd[2], y0 + rd[3], rd[2], rd[3], -1.0f,
                     1.0f, in_tr, d_tr);
  border_corner_zone(lx, ly, x1 - rd[4], y1 - rd[5], rd[4], rd[5], -1.0f,
                     -1.0f, in_br, d_br);
  border_corner_zone(lx, ly, x0 + rd[6], y1 - rd[7], rd[6], rd[7], 1.0f,
                     -1.0f, in_bl, d_bl);
  const bool in_corner = in_tl || in_tr || in_br || in_bl;
  float corner_depth_u = np_min(np_min(in_tl ? -d_tl : big,
                                       in_tr ? -d_tr : big),
                                np_min(in_br ? -d_br : big,
                                       in_bl ? -d_bl : big));
  corner_depth_u = in_corner ? corner_depth_u : 0.0f;

  // each side's normalised depth; none and hidden sides own nothing, and
  // a corner's box belongs only to its two adjacent sides
  const float s_t = p[52], s_r = p[53], s_b = p[54], s_l = p[55];
  float d_t = (w_t > eps) && s_t != 0.0f && s_t != 5.0f
                  ? (ly - y0) / np_max(w_t, eps) : big;
  float d_r = (w_r > eps) && s_r != 0.0f && s_r != 5.0f
                  ? (x1 - lx) / np_max(w_r, eps) : big;
  float d_b = (w_b > eps) && s_b != 0.0f && s_b != 5.0f
                  ? (y1 - ly) / np_max(w_b, eps) : big;
  float d_l = (w_l > eps) && s_l != 0.0f && s_l != 5.0f
                  ? (lx - x0) / np_max(w_l, eps) : big;
  if ((in_br || in_bl) && !(in_tl || in_tr)) d_t = big;
  if ((in_tl || in_bl) && !(in_tr || in_br)) d_r = big;
  if ((in_tl || in_tr) && !(in_bl || in_br)) d_b = big;
  if ((in_tr || in_br) && !(in_tl || in_bl)) d_l = big;
  const float depth_raw = np_min(np_min(d_t, d_r), np_min(d_b, d_l));
  const bool any_owner = depth_raw < F(5e8);
  const int side = d_t <= depth_raw   ? 0
                   : d_r <= depth_raw ? 1
                   : d_b <= depth_raw ? 2
                                      : 3;
  const float depth = np_clip(depth_raw, 0.0f, 1.0f);

  // the corner-region extents (border.rs create_border_segments)
  const float ex_tl_w = np_max(rd[0], w_l), ex_tl_h = np_max(rd[1], w_t);
  const float ex_tr_w = np_max(rd[2], w_r), ex_tr_h = np_max(rd[3], w_t);
  const float ex_br_w = np_max(rd[4], w_r), ex_br_h = np_max(rd[5], w_b);
  const float ex_bl_w = np_max(rd[6], w_l), ex_bl_h = np_max(rd[7], w_b);

  // the first corner box (TL, TR, BR, BL) holding the pixel: its style
  // (its first side's: left, top, right, bottom), whether its radius
  // collapses (dotted: under half the widths; dashed: zero), and the dot
  // of every zero-radius dotted corner
  float cstyle = -1.0f;
  bool czero = false, czero_da = false;
  float corner_dot = 0.0f;
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    const bool left = ci == 0 || ci == 3;
    const bool top = ci < 2;
    const float cw = left ? w_l : w_r;
    const float ch = top ? w_t : w_b;
    const float crx = rd[2 * ci], cry = rd[2 * ci + 1];
    const float st0 = p[52 + ((ci + 3) & 3)];
    const bool in_x = left ? lx < x0 + (ci == 0 ? ex_tl_w : ex_bl_w)
                           : lx >= x1 - (ci == 1 ? ex_tr_w : ex_br_w);
    const bool in_y = top ? ly < y0 + (ci == 0 ? ex_tl_h : ex_tr_h)
                          : ly >= y1 - (ci == 2 ? ex_br_h : ex_bl_h);
    const float ccx = left ? x0 + 0.5f * w_l : x1 - 0.5f * w_r;
    const float ccy = top ? y0 + 0.5f * w_t : y1 - 0.5f * w_b;
    const bool m = in_x && in_y && cstyle < -0.5f;
    const bool zr = (crx < cw * 0.5f) && (cry < ch * 0.5f);
    if (m) cstyle = st0 + 0.0f;
    czero = czero || (m && zr);
    czero_da = czero_da || (m && crx < eps && cry < eps);
    const bool want = st0 == 3.0f && zr && cw + ch > eps;
    const float ccr = 0.25f * (cw + ch);
    const float ddx = lx - ccx, ddy = ly - ccy;
    const float dc = sqrtf(ddx * ddx + ddy * ddy) - ccr;
    const float cov_c = np_clip(0.5f - dc * (sx + sy) * 0.5f, 0.0f, 1.0f);
    corner_dot = np_max(corner_dot, want ? cov_c : 0.0f);
  }

  // the owner's side
  const float w_side = side == 0 ? w_t : side == 1 ? w_r : side == 2 ? w_b
                                                                     : w_l;
  const float style = p[52 + side];
  const float depth_s =
      in_corner ? np_clip(corner_depth_u / np_max(w_side, eps), 0.0f, 1.0f)
                : depth;
  const float* sc = p + (depth_s < 0.5f ? 20 : 36) + 4 * side;
  const float scale = (side == 0 || side == 3 ? sx : sy) * w_side;
  // double: the outer and inner thirds, where a third is a device pixel
  float third = np_clip((F(1.0 / 3.0) - depth_s) * scale + 0.5f, 0.0f, 1.0f) +
                np_clip((depth_s - F(2.0 / 3.0)) * scale + 0.5f, 0.0f, 1.0f);
  third = np_clip(third, 0.0f, 1.0f);
  const float dbl = (style == 2.0f) && (scale / 3.0f >= 1.0f) ? third : 1.0f;
  // dotted and dashed patterns repeat along the span between the corner
  // regions (border.rs get_edge_info)
  const bool horizontal = side == 0 || side == 2;
  const float along = horizontal ? lx : ly;
  const float base = side == 0   ? x0 + ex_tl_w
                     : side == 1 ? y0 + ex_tr_h
                     : side == 2 ? x0 + ex_bl_w
                                 : y0 + ex_tl_h;
  const float avail = np_max(
      side == 0   ? (x1 - x0) - ex_tl_w - ex_tr_w
      : side == 1 ? (y1 - y0) - ex_tr_h - ex_br_h
      : side == 2 ? (x1 - x0) - ex_bl_w - ex_br_w
                  : (y1 - y0) - ex_tl_h - ex_bl_h,
      0.0f);
  const float aa_dev = horizontal ? sx : sy;
  const float wse = np_max(w_side, eps);
  // dashed: half dashes at both ends, a whole number of periods
  float n0 = np_min(ceilf(avail / (1.5f * wse) - F(1e-4)), 16384.0f);
  n0 = np_max(n0, 1.0f);
  const float rem = n0 - floorf(n0 / 4.0f) * 4.0f;
  const float n4 = rem > 0.0f ? n0 + 4.0f - rem : n0;
  const float period_dash = np_max(4.0f * avail / n4, eps);
  const float t_dash = along - base;
  const float tm_dash = t_dash - floorf(t_dash / period_dash) * period_dash;
  const float hd = 0.25f * period_dash;
  float dcov = np_clip(0.5f + (hd - tm_dash) * aa_dev, 0.0f, 1.0f) +
               np_clip(0.5f + (tm_dash - 3.0f * hd) * aa_dev, 0.0f, 1.0f);
  dcov = np_clip(dcov, 0.0f, 1.0f);
  const bool dash_span = (along >= base) && (along < base + avail);
  // dotted: one dot of diameter w a period of 2w, the row centred
  const float das = 2.0f * wse;
  const float cnt = np_max(floorf(avail / das), 1.0f);
  const float used = cnt * das;
  const float doff = floorf((avail - used) * 0.5f + 0.5f);
  const float dot_a0 = base + doff;
  const float dot_a1 = avail < das * 0.75f ? dot_a0 : dot_a0 + used;
  const float t_dot = along - dot_a0;
  const float tm_dot = t_dot - floorf(t_dot / das) * das;
  const float across = (depth_s - 0.5f) * w_side;
  const float dd = tm_dot - 0.5f * das;
  const float dot_d = sqrtf(dd * dd + across * across) - 0.5f * w_side;
  const float dot_cov = np_clip(0.5f - dot_d * (sx + sy) * 0.5f, 0.0f, 1.0f);
  const bool dot_span = (along >= dot_a0) && (along < dot_a1);
  const float own_mod = style == 3.0f   ? (dot_span ? dot_cov : 0.0f)
                        : style == 4.0f ? (dash_span ? dcov : 0.0f)
                                        : 1.0f;
  const float corner_mod = cstyle == 3.0f   ? (czero ? corner_dot : dot_cov)
                           : cstyle == 4.0f ? (czero_da ? 1.0f : dcov)
                                            : 1.0f;
  const float mod = cstyle > -0.5f ? corner_mod : own_mod;
  const float visible = (style == 0.0f) || (style == 5.0f) ? 0.0f : 1.0f;
  float band = np_clip((1.0f - depth_s) * scale + 0.5f, 0.0f, 1.0f);
  band = depth_s >= 1.0f ? 0.0f : (depth_s <= F(0.999) ? 1.0f : band);
  const float k = dbl * mod * visible * band;
  const float cov = ring * (any_owner ? 1.0f : 0.0f);
  for (int c = 0; c < 4; ++c) color[c] = sc[c] * k * cov;
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
  float step;  // device pixels between two pixels of a tile
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

// _sep_sample (tile_raster.py:640) in its llvm mode, the gl_flavor mask
// path (patterns.sample_alpha_llvm): one plane; the first texel at
// floor(u - 0.5) clamped to [0, W-2] x [0, H-2] (round8's addressing,
// :664-673), 8-bit fractions rounded, and llvmpipe's per-axis rounded
// integer lerp, x then y, on exact integers below 2^24
__device__ float llvm_sample(const Atlas& at, float u, float v,
                             const float* uv) {
  float lo_u = uv[0] + 0.5f;
  float hi_u = np_max(uv[2] - 0.5f, lo_u);
  float lo_v = uv[1] + 0.5f;
  float hi_v = np_max(uv[3] - 0.5f, lo_v);
  u = np_clip(u, lo_u, hi_u);
  v = np_clip(v, lo_v, hi_v);
  const int H = at.h, W = at.w;
  const float ixf = np_clip(floorf(u - 0.5f), 0.0f,
                            static_cast<float>(W - 2 > 0 ? W - 2 : 0));
  const float iyf = np_clip(floorf(v - 0.5f), 0.0f,
                            static_cast<float>(H - 2 > 0 ? H - 2 : 0));
  const float fx = floorf((u - 0.5f - ixf) * 256.0f + 0.5f);
  const float fy = floorf((v - 0.5f - iyf) * 256.0f + 0.5f);
  const long long x0 = static_cast<long long>(ixf);
  const long long y0 = static_cast<long long>(iyf);
  const long long y1 = y0 + (iyf < static_cast<float>(H - 1) ? 1 : 0);
  const long long x1 = x0 + 1 < W - 1 ? x0 + 1 : W - 1;
  const float t00 = u8(tap(at.data, H, W, y0, x0));
  const float t10 = u8(tap(at.data, H, W, y0, x1));
  const float t01 = u8(tap(at.data, H, W, y1, x0));
  const float t11 = u8(tap(at.data, H, W, y1, x1));
  const float a =
      floorf((t00 * (256.0f - fx) + t10 * fx + 128.0f) * F(1.0 / 256.0));
  const float b =
      floorf((t01 * (256.0f - fx) + t11 * fx + 128.0f) * F(1.0 / 256.0));
  const float o =
      floorf((a * (256.0f - fy) + b * fy + 128.0f) * F(1.0 / 256.0));
  return o * F(1.0 / 255.0);
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
    n[k] = np_clip(row[0] * r + row[1] * g + row[2] * b + row[3] * a +
                       row[4],
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
// patterns.clip_coverage); cb = the record's [0:12].  kLlvm: the mask
// sampled in the llvm mode (gl_flavor)
template <bool kLlvm>
__device__ float mask_clip_coverage(const Args& a, const float* crec,
                                    const float* cb, float ckind, float lxr,
                                    float lyc, float rect_cov) {
  float uv[4];
  for (int k = 0; k < 4; ++k) uv[k] = crec[16 + k];
  float mu, mv;
  if (ckind < 2.5f) {
    float rw = np_max(cb[2] - cb[0], F(1e-6));
    float rh = np_max(cb[3] - cb[1], F(1e-6));
    mu = uv[0] + (lxr - cb[0]) / rw * (uv[2] - uv[0]);
    mv = uv[1] + (lyc - cb[1]) / rh * (uv[3] - uv[1]);
    float m;
    if (kLlvm)
      m = llvm_sample(a.color, mu, mv, uv);
    else
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
  if (kLlvm)
    texel = llvm_sample(a.color, mu, mv, uv);
  else
    sep_sample<1>(a.color, mu, mv, uv, 0.0f, &texel);
  const float mode = crec[15];  // 0 outset, 1 inset
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
        e[0] * px + e[1] * py + e[2] + 0.5f, 0.0f, 1.0f);
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
    if (r[37] > 0.5f) {
      const float scale = r[40];
      u = p[8] + lx * scale - r[38];
      v = p[9] + ly * scale - r[39];
    }
    float tex[4];
    sep_sample(a.surface, u, v, p + 8, 0.0f, tex);
    for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c];
    color_matrix<kLinear>(color, r + 16, r[36]);
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
  const float sy_ = yy - r[36];
  const float su_ = uu - r[37];
  const float sv_ = vv - r[38];
  for (int c = 0; c < 3; ++c) {
    const float* m = r + 27 + 3 * c;
    color[c] = np_clip(m[0] * sy_ + m[1] * su_ + m[2] * sv_, 0.0f, 1.0f);
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

// --- the block's record pipeline -------------------------------------------

// A block draws BLOCK_ROWS rows of one tile with TILE_W x ROWS threads, PIX
// pixels a thread (rows threadIdx.y + ROWS * k), the accumulators in shared
// memory.  The tile's records reach the block in chunks of at most CHUNK,
// with the clip rows they name (at most CLIP_CAP a chunk), copied into
// shared memory by cp.async.
constexpr int BLOCK_ROWS = 8;
constexpr int PIX = BLOCK_ROWS / ROWS;
constexpr int THREADS = TILE_W * ROWS;
constexpr int SEGS = TILE_W / 32;  // a warp's run of 32 pixels of one row
constexpr int REGIONS = BLOCK_ROWS * SEGS;
constexpr int CHUNK = 16;
constexpr int CLIP_CAP = 16;
// a staged record: the dense record's columns 0-95 (82-95 are padding),
// then what the chunk's prologue decodes (D_*)
constexpr int STAGED = 96;
constexpr int REC_S = 112;
static_assert(STAGED % 4 == 0 && REC_S % 4 == 0, "16-byte pieces");
static_assert((TILE_H % BLOCK_ROWS) == 0 && (BLOCK_ROWS % ROWS) == 0,
              "whole thread rows");
// the decoded record: ints, then the linear gradient's record-uniform terms
constexpr int D_KIND = 96;
constexpr int D_OP = 97;
constexpr int D_EDGE = 98;
constexpr int D_NCLIP = 99;
constexpr int D_CLIP_AT = 100;   // its first clip row in the chunk's, or -1
constexpr int D_CLIP_ROW = 101;  // its first row in the f32 buffer
constexpr int D_FLAGS = 102;     // DF_* below
constexpr int D_LG_BASE = 103;   // the stops' first f32 index
constexpr int D_LG_N = 104;      // the stop count
constexpr int D_LG = 105;        // sw + 1e-4, sh + 1e-4, perx, pery, dx,
                                 // dy, denom
static_assert(D_LG + 7 <= REC_S, "the decoded columns fit");
constexpr int DF_GENERAL = 1;
constexpr int DF_FLOAT_OP = 2;
constexpr int DF_IS_TX = 4;

// what thread 0 plans for a chunk: its records, and the f32 row of each
// clip row it stages
struct Plan {
  int n;
  int rows;
  int clip_at[CHUNK];
  int src[CLIP_CAP];
};

__device__ __forceinline__ void copy16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

// every copy this thread issued has landed
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// neither infinite nor NaN
__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= F(3.4028234663852886e38);
}

template <bool kGeneral>
__device__ __forceinline__ float pixel_pos(float origin, int i, float step) {
  return kGeneral ? origin + (static_cast<float>(i) + 0.5f) * step
                  : origin + static_cast<float>(i) + 0.5f;
}

// The records start .. start + CHUNK - 1 (below cnt) that fit the clip
// rows: each record's chain, if it has at most CLIP_CAP rows, is staged
// whole (a longer one stays in the f32 buffer, clip_at -1); the chunk ends
// before the first record whose rows would not fit.  Each clip row's index
// is clamped into the buffer as the kernel always did.
__device__ void plan_chunk(const Args& a, long long rec0, int start, int cnt,
                           long long n_rows, Plan& pl) {
  int nc[CHUNK], first[CHUNK];
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    nc[i] = 0;
    first[i] = 0;
    if (start + i < cnt) {
      const float* r = a.dense + (rec0 + start + i) * REC;
      nc[i] = static_cast<int>(__ldg(r + REC_CLIP_COUNT));
      first[i] = static_cast<int>(__ldg(r + REC_CLIP_ROW));
    }
  }
  int n = 0, rows = 0;
  bool open = true;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    if (open && start + i < cnt) {
      const bool staged = nc[i] <= CLIP_CAP;
      const int take = staged && nc[i] > 0 ? nc[i] : 0;
      if (rows + take > CLIP_CAP) {
        open = false;
      } else {
        pl.clip_at[i] = staged ? rows : -1;
        for (int j = 0; j < take; ++j) {
          long long cr = first[i] + j;
          cr = cr < 0 ? 0 : (cr >= n_rows ? n_rows - 1 : cr);
          pl.src[rows + j] = static_cast<int>(cr);
        }
        rows += take;
        ++n;
      }
    }
  }
  pl.n = n;
  pl.rows = rows;
}

// cp.async of a planned chunk: the records' columns 0-95, the clip rows
__device__ void stage_chunk(const Args& a, long long rec0, int start,
                            const Plan& pl, float (*rec)[REC_S],
                            float (*clip)[REC], int tid) {
  constexpr int kRecPieces = STAGED / 4;
  const float* src = a.dense + (rec0 + start) * REC;
  for (int q = tid; q < pl.n * kRecPieces; q += THREADS) {
    const int i = q / kRecPieces, k = q % kRecPieces;
    copy16(&rec[i][4 * k], src + static_cast<long long>(i) * REC + 4 * k);
  }
  for (int q = tid; q < pl.rows * (REC / 4); q += THREADS) {
    const int j = q / (REC / 4), k = q % (REC / 4);
    copy16(&clip[j][4 * k],
           a.f32 + static_cast<long long>(pl.src[j]) * REC + 4 * k);
  }
}

// Whether a run of 32 pixels of one row (tile columns c0 to c0 + 31) may
// hold a pixel where the record's coverage is above zero.  Coverage
// (rect_coverage_tx) needs each edge's term above -0.5: an axis's two terms
// are each at most 0.5, so one at or below -0.5 clips the axis to 0; under
// is_tx, the distance past each edge under half the local pixel width (or
// under 1/1024 without AA).  With an affine row (t[2] = t[5] = 0) each
// pixel computes w = t[8], and its lx and ly are monotone in px along the
// row: every rounded step is a product by a constant, a sum, a quotient by
// w, and px grows with the column.  So their extremes over the run are the
// values at its two end pixels, computed by the same operations, and each
// edge's term, monotone in lx or ly, is at its largest there.  A projective
// row, or a run whose ends are not finite, always draws; so does a
// float-domain op (the caller), which composites at zero coverage.  A clip
// only lowers coverage, so a run this test skips would draw nothing.
template <bool kGeneral>
__device__ bool run_may_draw(const float* r, float ox, float oy, int row,
                             int c0, float step) {
  const float* t = r + REC_TROW;
  if (!(t[2] == 0.0f && t[5] == 0.0f)) return true;
  const float pxa = pixel_pos<kGeneral>(ox, c0, step);
  const float pxb = pixel_pos<kGeneral>(ox, c0 + 31, step);
  const float py = pixel_pos<kGeneral>(oy, row, step);
  float lxa, lya, lxb, lyb;
  inverse_map(t, pxa, py, lxa, lya);
  inverse_map(t, pxb, py, lxb, lyb);
  if (!(finite(pxa) && finite(pxb) && finite(py) && pxa <= pxb &&
        finite(lxa) && finite(lya) && finite(lxb) && finite(lyb)))
    return true;
  const float lx_lo = fminf(lxa, lxb), lx_hi = fmaxf(lxa, lxb);
  const float ly_lo = fminf(lya, lyb), ly_hi = fmaxf(lya, lyb);
  const float x0 = r[4], y0 = r[5], x1 = r[6], y1 = r[7];
  if (!row_is_tx(t)) {
    const float sx = t[9], sy = t[10];
    if (sx > 0.0f &&
        ((lx_hi - x0) * sx <= -0.5f || (x1 - lx_lo) * sx <= -0.5f))
      return false;
    if (sy > 0.0f &&
        ((ly_hi - y0) * sy <= -0.5f || (y1 - ly_lo) * sy <= -0.5f))
      return false;
    return true;
  }
  if (static_cast<int>(r[REC_EDGE]) > 0) {
    // the local pixel width is the same at every pixel of an affine row
    const float fw = local_fwidth(t, lxa, lya, pxa, py);
    const float fw_safe = fw > F(1e-9) ? fw : F(1e-9);
    return !((x0 - lx_hi) / fw_safe >= 0.5f ||
             (lx_lo - x1) / fw_safe >= 0.5f ||
             (y0 - ly_hi) / fw_safe >= 0.5f ||
             (ly_lo - y1) / fw_safe >= 0.5f);
  }
  const float lim = F(1.0 / 1024.0);
  return !(x0 - lx_hi >= lim || lx_lo - x1 >= lim || y0 - ly_hi >= lim ||
           ly_lo - y1 >= lim);
}

// The chunk's prologue: each (record, run) pair's culling flag, and each
// record's uniform terms, written into its staged row once for the block.
template <bool kGeneral, bool kFilter>
__device__ void decode_chunk(const Args& a, float (*rec)[REC_S],
                             const Plan& pl,
                             unsigned char (*draw)[REGIONS], float ox,
                             float oy, int row0, int tid) {
  for (int q = tid; q < pl.n * REGIONS; q += THREADS) {
    const int i = q / REGIONS, reg = q % REGIONS;
    const float* r = rec[i];
    const bool float_op =
        kFilter && is_float_op(static_cast<int>(r[REC_BLEND]));
    draw[i][reg] = float_op || run_may_draw<kGeneral>(
                                   r, ox, oy, row0 + reg / SEGS,
                                   (reg % SEGS) * 32, a.step);
  }
  if (tid < pl.n) {
    float* r = rec[tid];
    int* ri = reinterpret_cast<int*>(r);
    const int kind = static_cast<int>(r[REC_KIND]);
    const int op = static_cast<int>(r[REC_BLEND]);
    const bool general = kGeneral && r[REC_GENERAL] > 0.5f;
    ri[D_KIND] = kind;
    ri[D_OP] = op;
    ri[D_EDGE] = static_cast<int>(r[REC_EDGE]);
    ri[D_NCLIP] = static_cast<int>(r[REC_CLIP_COUNT]);
    ri[D_CLIP_AT] = pl.clip_at[tid];
    ri[D_CLIP_ROW] = static_cast<int>(r[REC_CLIP_ROW]);
    ri[D_FLAGS] = (general ? DF_GENERAL : 0) |
                  (kFilter && is_float_op(op) ? DF_FLOAT_OP : 0) |
                  (row_is_tx(r + REC_TROW) ? DF_IS_TX : 0);
    if (kind == KIND_LINEAR_GRAD) {
      const float* p = r;
      const float sw = np_max(p[16], F(1e-6));
      const float sh = np_max(p[17], F(1e-6));
      float perx = sw + p[18];
      float pery = sh + p[19];
      perx = perx > F(1e-6) ? perx : F(1e6);
      pery = pery > F(1e-6) ? pery : F(1e6);
      const float dx = p[10] - p[8];
      const float dy = p[11] - p[9];
      float denom = dx * dx + dy * dy;
      denom = denom > F(1e-9) ? denom : F(1e-9);
      // stops: 8-float records from the row of p[12] (a general tile's
      // from p[12] itself), premultiplied
      ri[D_LG_BASE] = general ? static_cast<int>(p[12])
                              : (static_cast<int>(p[12]) / 128) * 128;
      ri[D_LG_N] = static_cast<int>(p[14]);
      float* g = r + D_LG;
      g[0] = sw + F(1e-4);
      g[1] = sh + F(1e-4);
      g[2] = perx;
      g[3] = pery;
      g[4] = dx;
      g[5] = dy;
      g[6] = denom;
    }
  }
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
// kGeneral): the float-domain blend ops and color-matrix flag 2.  kGl
// (only with kFilter): the GL flavour (see the top of this file).  kBorder
// (only with kFilter): KIND_BORDER, in the border build (the filter
// build's branches and the border) and in the gl build.
//
// Blocks an SM: four (64 registers) for the browsing and filter builds,
// two (up to 128) for the border build, three (80) for the others, each
// without a spill.  The border branch compiled into the content builds
// left them at 76 registers but spilled 8 bytes in the general build and
// 52 in the filter build (ptxas on an H100's toolchain), hence its own
// flag; the gl build holds it at 76 registers without a spill.  On an H100
// (kernel_ab.py) two blocks at 96-127 registers ran 10-30% slower than
// three; four ran 8% (browsing) and 14% (filter) faster than three, and
// spilled in the other builds.
template <bool kSurfaceKinds, bool kContent, bool kMedia, bool kGeneral,
          bool kFilter, bool kGl, bool kBorder>
__global__ void __launch_bounds__(THREADS,
                                  kBorder && !kGl ? 2
                                  : !kSurfaceKinds || (kFilter && !kGl) ? 4
                                                                        : 3)
tile_raster_kernel(Args a) {
  static_assert(kSurfaceKinds || !kContent, "content builds hold surfaces");
  static_assert(kContent || !kMedia, "the media build holds content");
  static_assert(kMedia || !kGeneral, "the general build holds the media");
  static_assert(kGeneral || !kFilter, "the filter build holds every branch");
  static_assert(kFilter || !kGl, "the gl build is the filter build's");
  static_assert(kFilter || !kBorder, "the border builds hold every branch");
  __shared__ __align__(16) float s_rec[CHUNK][REC_S];
  __shared__ __align__(16) float s_clip[CLIP_CAP][REC];
  __shared__ float s_acc[4][BLOCK_ROWS][TILE_W];
  __shared__ unsigned char s_draw[CHUNK][REGIONS];
  __shared__ Plan s_plan;

  const int groups = TILE_H / BLOCK_ROWS;
  const int tile = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * BLOCK_ROWS;
  const int col = threadIdx.x;
  const int tid = threadIdx.y * TILE_W + col;
  const int seg = col / 32;
  const float ox = __ldg(a.origins + 2 * tile);
  const float oy = __ldg(a.origins + 2 * tile + 1);
  const float px = pixel_pos<kGeneral>(ox, col, a.step);
  const long long tile_px = static_cast<long long>(tile) * 4 * TILE_H * TILE_W;
  for (int k = 0; k < PIX; ++k) {
    const int lrow = threadIdx.y + ROWS * k;
    for (int c = 0; c < 4; ++c)
      s_acc[c][lrow][col] =
          a.init != nullptr
              ? __ldg(a.init + tile_px + (c * TILE_H + row0 + lrow) * TILE_W +
                      col)
              : __ldg(a.clear + c);
  }
  const long long n_rows = a.n_f32 / REC;
  const int slots = kGeneral ? (a.slots & ~kNoMaskClips) : a.slots;
  const bool no_mask_clips = kGeneral && (a.slots & kNoMaskClips) != 0;
  const long long rec0 = static_cast<long long>(tile) * slots;

  // a tile's count never reads past its own slots
  const int cnt = min(max(__ldg(a.counts + tile), 0), slots);
  for (int start = 0; start < cnt;) {
    if (tid == 0) plan_chunk(a, rec0, start, cnt, n_rows, s_plan);
    // the plan is visible, and every thread is done with the last chunk
    __syncthreads();
    // read before thread 0 can plan the next chunk (past two barriers)
    const int n = s_plan.n;
    stage_chunk(a, rec0, start, s_plan, s_rec, s_clip, tid);
    copy_wait();
    __syncthreads();
    decode_chunk<kGeneral, kFilter>(a, s_rec, s_plan, s_draw, ox, oy, row0,
                                    tid);
    __syncthreads();

    for (int i = 0; i < n; ++i) {
      const float* r = s_rec[i];
      const int* ri = reinterpret_cast<const int*>(r);
      const float* p = r;  // the payload
      const float* tr = r + REC_TROW;
      const int kind = ri[D_KIND];
      const int op = ri[D_OP];
      const int edge_aa = ri[D_EDGE];
      const int n_clip = ri[D_NCLIP];
      const int clip_at = ri[D_CLIP_AT];
      const int dflags = ri[D_FLAGS];
      const bool general = kGeneral && (dflags & DF_GENERAL) != 0;
      const bool float_op = kFilter && (dflags & DF_FLOAT_OP) != 0;
      const bool is_tx = (dflags & DF_IS_TX) != 0;
#pragma unroll 1
      for (int k = 0; k < PIX; ++k) {
        const int lrow = threadIdx.y + ROWS * k;
        // the same for the whole warp: its 32 pixels of this row
        if (!s_draw[i][lrow * SEGS + seg]) continue;
        const int row = row0 + lrow;
        const float py = pixel_pos<kGeneral>(oy, row, a.step);

        float lx, ly;
        inverse_map(tr, px, py, lx, ly);
        float cov = rect_coverage_tx(tr, is_tx, p[4], p[5], p[6], p[7], lx,
                                     ly, px, py, edge_aa);
        // clip chain: rect clips join the span, others the u8 mask chain
        float m8 = 255.0f;
        for (int j = 0; j < n_clip; ++j) {
          const float* crec;
          if (clip_at >= 0) {
            crec = s_clip[clip_at + j];
          } else {
            long long cr = ri[D_CLIP_ROW] + j;
            cr = cr < 0 ? 0 : (cr >= n_rows ? n_rows - 1 : cr);
            crec = a.f32 + cr * REC;
          }
          const float* ct = crec + 96;  // its transform row
          const float* cb = crec;       // its rect, radii or nine-patch
          const float ckind = crec[14];
          const float invert = crec[12];
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
              // patterns.clip_coverage: the mask at this pixel's own
              // position; the nine-patch with the plain rect coverage
              if (ckind >= 3.5f)
                rect_cov = rect_coverage_aa(cb, clx, cly, ct[9], ct[10]);
              ccov = mask_clip_coverage<kGl>(a, crec, cb, ckind, clx, cly,
                                              rect_cov);
            } else {
              float lxr, lyc, dummy;
              inverse_map(ct, px, oy + 0.5f, lxr, dummy);
              inverse_map(ct, ox + 0.5f, py, dummy, lyc);
              ccov = mask_clip_coverage<kGl>(a, crec, cb, ckind, lxr, lyc,
                                              rect_cov);
            }
          } else {
            float fw = local_fwidth(ct, clx, cly, px, py);
            float aa_mul = 1.0f / (fw > F(1e-9) ? fw : F(1e-9));
            ccov = crec[15] > 0.5f ? rounded_fast(cb, cb[4], clx, cly, aa_mul)
                                   : rounded_sdf(cb, cb + 4, clx, cly, aa_mul);
          }
          if (invert > 0.5f) ccov = 1.0f - ccov;
          if (ckind < 0.5f && invert < 0.5f) {
            cov = cov * ccov;
          } else {
            float c8 = quantize_cov(ccov, 255.0f);
            // blend.gl_mask_combine under gl (llvmpipe's multiply blend
            // into the R8 clip target), else swgl's muldiv255
            m8 = kGl ? rintf(c8 * m8 * F(1.0 / 255.0))
                     : floorf((c8 * m8 + c8) * F(1.0 / 256.0));
          }
        }
        const float mcov = m8 * F(1.0 / 255.0);
        // fragments with zero geometric coverage are never rasterized, but
        // in the float domain, which composites color * 0 there
        if (!(cov > 0.0f) && !float_op) continue;

        float color[4];
        if (kind == KIND_SOLID) {
          for (int c = 0; c < 4; ++c) color[c] = p[8 + c];
        } else if (kind == KIND_LINEAR_GRAD) {
          // sw + 1e-4, sh + 1e-4, the periods and the axis from the
          // prologue (decode_chunk)
          const float* g = r + D_LG;
          float oxl = lx - p[0];
          float oyl = ly - p[1];
          const float perx = g[2];
          const float pery = g[3];
          float tx = oxl - floorf(oxl / perx) * perx;
          float ty = oyl - floorf(oyl / pery) * pery;
          bool in_tile = (tx < g[0]) && (ty < g[1]);
          float t = ((tx - p[8]) * g[4] + (ty - p[9]) * g[5]) / g[6];
          const long long base = ri[D_LG_BASE];
          const int n_stops = ri[D_LG_N];
          if (p[13] > 0.5f) t = t - floorf(t);
          for (int c = 0; c < 4; ++c) color[c] = f32_at(a, base + 1 + c);
          for (int s = 1; s < n_stops; ++s) {
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
        } else if (kBorder && kind == KIND_BORDER) {
          border(p, lx, ly, tr[9], tr[10], color);
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
          const Window win =
              make_window(static_cast<int>(np_clip(x0f, -lim, lim)),
                          static_cast<int>(np_clip(y0f, -lim, lim)), at.h,
                          at.w);
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
            color_matrix<kFilter>(color, r + 16, r[36]);
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
          tile_coords(p, lx, ly, np_max(p[18], F(1e-6)),
                      np_max(p[19], F(1e-6)), p[20], p[21], tx, ty, in_tile);
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
          if (r[37] > 0.5f) {
            float lx_row, ly_col, dummy;
            inverse_map(tr, px, oy + 0.5f, lx_row, dummy);
            inverse_map(tr, ox + 0.5f, py, dummy, ly_col);
            const float scale = r[40];
            u = p[8] + lx_row * scale - r[38];
            v = p[9] + ly_col * scale - r[39];
          }
          float tex[4];
          sep_sample(a.surface, u, v, p + 8, 0.0f, tex);
          for (int c = 0; c < 4; ++c) color[c] = tex[c] * p[12 + c];
          color_matrix<kFilter>(color, r + 16, r[36]);
        } else if (kMedia && kind == KIND_CLEAR) {
          // _pattern_math (tile_raster.py:377): ones; BLEND_CLEAR punches
          // the destination by the source's alpha
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
          // chroma), always bilinear (the TPU kernel does not read the
          // nearest flag [26]); less the zero points [36:39]; the 3x3 matrix
          // [27:36], each row summed left to right; clipped; alpha 1
          float lx_row, ly_col, dummy;
          inverse_map(tr, px, oy + 0.5f, lx_row, dummy);
          inverse_map(tr, ox + 0.5f, py, dummy, ly_col);
          float oxl = lx_row - p[0];
          float oyl = ly_col - p[1];
          float yy, uu, vv;
          sep_sample<1>(a.alpha, p[8] + oxl * p[22], p[9] + oyl * p[23], p + 8,
                        0.0f, &yy);
          sep_sample<1>(a.alpha, p[12] + oxl * p[24], p[13] + oyl * p[25],
                        p + 12, 0.0f, &uu);
          sep_sample<1>(a.alpha, p[16] + oxl * p[24], p[17] + oyl * p[25],
                        p + 16, 0.0f, &vv);
          float sy_ = yy - r[36];
          float su_ = uu - r[37];
          float sv_ = vv - r[38];
          for (int c = 0; c < 3; ++c) {
            const float* m = r + 27 + 3 * c;
            color[c] =
                np_clip(m[0] * sy_ + m[1] * su_ + m[2] * sv_, 0.0f, 1.0f);
          }
          color[3] = 1.0f;
        } else {
          // unported kinds never reach the kernel (the wrapper raises
          // first), and each kind reaches only a build that holds it
          continue;
        }

        float acc[4];
        for (int c = 0; c < 4; ++c) acc[c] = s_acc[c][lrow][col];
        if (float_op) {
          compose_float(op, color, cov, mcov, acc);
        } else if (kGl && (op == 0 || op == BLEND_CLEAR ||
                           op == BLEND_CH_CLEAR || op == BLEND_ADD)) {
          // blend.compose_gl: the shader's color times (cov * mcov), packed
          // round-half-even; the blend factor in 8-bit fixed point,
          // rounded; a saturating add.  Pixels with cov <= 0 were skipped
          // above.
          const float cm = cov * mcov;
          float s[4], d[4];
          for (int c = 0; c < 4; ++c) {
            s[c] = np_clip(rintf(color[c] * cm * 255.0f), 0.0f, 255.0f);
            d[c] = floorf(acc[c] * 255.0f + 0.5f);
          }
          for (int c = 0; c < 4; ++c) {
            float o;
            if (op == BLEND_ADD) {
              o = s[c] + d[c];
            } else if (op == BLEND_CH_CLEAR) {
              o = rintf(d[c] * (255.0f - s[c]) * F(1.0 / 255.0));
            } else if (op == BLEND_CLEAR) {
              o = rintf(d[c] * (255.0f - s[3]) * F(1.0 / 255.0));
            } else {  // BLEND_NORMAL
              o = s[c] + rintf(d[c] * (255.0f - s[3]) * F(1.0 / 255.0));
            }
            acc[c] = np_clip(o, 0.0f, 255.0f) * F(1.0 / 255.0);
          }
        } else {
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
                         (kContent && op == BLEND_MIX_BASE + 16)) {
                o[c] = s[c] + d[c];  // plus-lighter
              } else {  // BLEND_NORMAL (0), and mix-blend normal (16)
                o[c] = s[c] + d[c] -
                       floorf((d[c] * s[3] + d[c]) * F(1.0 / 256.0));
              }
            }
          }
          for (int c = 0; c < 4; ++c)
            acc[c] = np_clip(o[c], 0.0f, 255.0f) * F(1.0 / 255.0);
        }
        for (int c = 0; c < 4; ++c) s_acc[c][lrow][col] = acc[c];
      }
    }
    start += n;
  }
  float* out = a.out + tile_px;
  for (int k = 0; k < PIX; ++k) {
    const int lrow = threadIdx.y + ROWS * k;
    for (int c = 0; c < 4; ++c)
      out[(c * TILE_H + row0 + lrow) * TILE_W + col] = s_acc[c][lrow][col];
  }
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
                              int media, int general, int filter, int gl,
                              int border, float step, void* stream) {
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
  dim3 grid(static_cast<unsigned>(nt) * (TILE_H / BLOCK_ROWS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gl)  // the gl build holds the border (border is 1 with it)
    tile_raster_kernel<true, true, true, true, true, true, true>
        <<<grid, block, 0, st>>>(a);
  else if (border)
    tile_raster_kernel<true, true, true, true, true, false, true>
        <<<grid, block, 0, st>>>(a);
  else if (filter)
    tile_raster_kernel<true, true, true, true, true, false, false>
        <<<grid, block, 0, st>>>(a);
  else if (general)
    tile_raster_kernel<true, true, true, true, false, false, false>
        <<<grid, block, 0, st>>>(a);
  else if (media)
    tile_raster_kernel<true, true, true, false, false, false, false>
        <<<grid, block, 0, st>>>(a);
  else if (content)
    tile_raster_kernel<true, true, false, false, false, false, false>
        <<<grid, block, 0, st>>>(a);
  else if (surface_kinds)
    tile_raster_kernel<true, false, false, false, false, false, false>
        <<<grid, block, 0, st>>>(a);
  else
    tile_raster_kernel<false, false, false, false, false, false, false>
        <<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
