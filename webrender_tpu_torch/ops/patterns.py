"""Pattern + coverage kernels — the brush/clip shader suite.

Single-source kernels parameterized by the array module ``xp`` (numpy for
the CPU fidelity oracle, jax.numpy for the TPU path) — the glsl-to-cxx
"one shader source, two backends" role (SURVEY.md §2.5). Math follows the
reference's GLSL suite: AA distance coverage (`brush.glsl` init_transform_fs
/ SWGL span AA), rounded-rect SDF (`ellipse.glsl`, `cs_clip_rectangle.glsl`),
gradients (`cs_*_gradient.glsl` + gradient LUT), image sampling
(`brush_image.glsl`), box-shadow (`cs_clip_box_shadow` re-designed as the
closed-form separable gaussian of a box).

Conventions:
 * colors are channel-planar premultiplied f32: [4, H, W];
 * `p` is the instance payload vector (prefix [0:4] pattern rect,
   [4:8] coverage rect — layouts in frame/gpu.py);
 * (lx, ly) are local-space pixel coordinates [H, W]; (px, py) device.
"""
from __future__ import annotations

from . import blend as blend_mod

# payload slice length fetched per instance (see frame/gpu.py layouts)
PAYLOAD_LEN = 64


# ---------------------------------------------------------------------------
# basic math

def erf(xp, x):
    """Abramowitz & Stegun 7.1.26 polynomial erf (max err 1.5e-7) — shared
    exactly by oracle and TPU so box-shadow output is bit-comparable."""
    s = xp.sign(x)
    x = xp.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * xp.exp(-x * x)
    return s * y


def atan2_shared(xp, y, x):
    """Deterministic atan2: the same f32 op sequence on every backend
    (numpy / XLA / Pallas) so conic hard stops at exact angles never
    disagree (native pow/atan2 lowerings differ in the last ulp).
    Max error ~2e-7 rad (minimax atan polynomial + range reduction)."""
    ax = xp.abs(x)
    ay = xp.abs(y)
    hi = xp.maximum(ax, ay)
    lo = xp.minimum(ax, ay)
    z = lo / xp.where(hi > 0.0, hi, 1.0)
    z2 = z * z
    # 11th-order odd minimax polynomial for atan on [0, 1]
    p = ((((-0.0117212 * z2 + 0.05265332) * z2 - 0.11643287) * z2
          + 0.19354346) * z2 - 0.33262348) * z2
    a = z + z * p
    a = xp.where(ay > ax, 1.5707963267948966 - a, a)
    a = xp.where(x < 0.0, 3.141592653589793 - a, a)
    return xp.where(y < 0.0, -a, a)


def inverse_map(xp, trow, px, py):
    """Device px → local space via the palette row's inverse homography.
    w <= 0 marks device points BEHIND the projection plane (the forward
    map's near-plane clip, cs_clip w>0): they map far outside any local
    rect so every coverage/pattern evaluates to zero there."""
    u = px * trow[0] + py * trow[3] + trow[6]
    v = px * trow[1] + py * trow[4] + trow[7]
    w = px * trow[2] + py * trow[5] + trow[8]
    ok = w > 1e-9
    w = xp.where(ok, w, 1.0)
    return xp.where(ok, u / w, 1e8), xp.where(ok, v / w, 1e8)


# ---------------------------------------------------------------------------
# coverage

def _edge_term(xp, d, aa):
    """Per-edge coverage term; d = signed device-px distance inside-positive.
    AA edge: linear box-filter ramp. Non-AA edge: pixel-center test."""
    return xp.where(aa, xp.minimum(d, 0.5),
                    xp.where(d >= 0.0, 0.5, -1e3))


def rect_coverage(xp, x0, y0, x1, y1, lx, ly, sx, sy, edge_aa):
    """Exact box-filter coverage of an axis-aligned local rect; per-edge AA
    control via edge_aa bits (L=1, T=2, R=4, B=8)."""
    dl = (lx - x0) * sx
    dr = (x1 - lx) * sx
    dt = (ly - y0) * sy
    db = (y1 - ly) * sy
    tl = _edge_term(xp, dl, (edge_aa & 1) > 0)
    tr = _edge_term(xp, dr, (edge_aa & 4) > 0)
    tt = _edge_term(xp, dt, (edge_aa & 2) > 0)
    tb = _edge_term(xp, db, (edge_aa & 8) > 0)
    cov_x = xp.clip(tl + tr, 0.0, 1.0)
    cov_y = xp.clip(tt + tb, 0.0, 1.0)
    return cov_x * cov_y


def local_fwidth(xp, trow, lx, ly, px, py):
    """swgl's fwidth(local_pos) (glsl.h:765): |dFdx(lx)| + |dFdx(ly)| with
    the screen-X derivatives of the projective inverse map — the uniform
    AA filter width for transformed primitives."""
    w = px * trow[2] + py * trow[5] + trow[8]
    w = xp.where(xp.abs(w) > 1e-9, w, 1e-9)
    dlx = (trow[0] - lx * trow[2]) / w
    dly = (trow[1] - ly * trow[2]) / w
    return xp.abs(dlx) + xp.abs(dly)


def rect_coverage_tx(xp, x0, y0, x1, y1, lx, ly, fw):
    """Transformed-rect AA (transform.glsl rectangle_aa_fragment + SWGL
    distance_aa_xy): per-axis signed distances scaled by the uniform
    fwidth, straight-corner max() combine."""
    dx = xp.maximum(x0 - lx, lx - x1)
    dy = xp.maximum(y0 - ly, ly - y1)
    fw_safe = xp.where(fw > 1e-9, fw, 1e-9)
    d = xp.maximum(dx, dy) / fw_safe
    return xp.clip(0.5 - d, 0.0, 1.0)


def rect_coverage_auto(xp, trow, x0, y0, x1, y1, lx, ly, px, py, edge_aa):
    """Coverage of a local rect: axis-aligned prims use the per-edge
    box-filter ramp, transformed prims (palette flag bit 2) the
    fwidth-based transform path.  edge_aa == 0 on a transformed prim
    draws HARD edges (pixel-center inside test) — the ps_split_composite
    role: 3D plane seams are aliased in the reference."""
    sx, sy = trow[9], trow[10]
    aligned = rect_coverage(xp, x0, y0, x1, y1, lx, ly, sx, sy, edge_aa)
    fw = local_fwidth(xp, trow, lx, ly, px, py)
    tx = rect_coverage_tx(xp, x0, y0, x1, y1, lx, ly, fw)
    dx = xp.maximum(x0 - lx, lx - x1)
    dy = xp.maximum(y0 - ly, ly - y1)
    # hard (aliased) edges include the exact-on-edge pixel center with a
    # small inclusion bias: a plane edge that lands exactly on pixel
    # centers (backface-perspective) otherwise flips in/out per backend
    # with the division's last-ULP rounding (blend.py quantize_cov
    # rationale — XLA/Mosaic div differs from the host's)
    hard = xp.where(xp.maximum(dx, dy) < 1.0 / 1024.0, 1.0, 0.0)
    aa_any = (edge_aa & 0xF) > 0 if isinstance(edge_aa, int) \
        else (edge_aa > 0)
    tx = xp.where(aa_any, tx, hard)
    is_tx = xp.floor(trow[11] * 0.25) % 2.0 >= 1.0
    return xp.where(is_tx, tx, aligned)


def _corner_coverage(xp, lx, ly, cx, cy, rx, ry, sign_x, sign_y, scale):
    """AA coverage multiplier for one rounded corner (ellipse.rs first-order
    SDF: dist = (g - 1) * g / |∇g|)."""
    active = (rx > 0.0) & (ry > 0.0)
    rx_s = xp.where(active, rx, 1.0)
    ry_s = xp.where(active, ry, 1.0)
    # clamp: giant local coords (1e9 "unbounded" rects) would overflow f32
    # in the squares below; anything past a few radii is fully outside
    dx = xp.clip((cx - lx) * sign_x, -1e6, 1e6)
    dy = xp.clip((cy - ly) * sign_y, -1e6, 1e6)
    in_region = (dx > 0.0) & (dy > 0.0) & active
    ex = xp.clip(dx / rx_s, -1e4, 1e4)
    ey = xp.clip(dy / ry_s, -1e4, 1e4)
    g = xp.sqrt(ex * ex + ey * ey)
    grad = xp.sqrt((dx / (rx_s * rx_s)) ** 2 + (dy / (ry_s * ry_s)) ** 2)
    grad = xp.where(grad > 1e-6, grad, 1e-6)
    dist = (g - 1.0) * g / grad  # local units, positive outside the ellipse
    cov = xp.clip(0.5 - dist * scale, 0.0, 1.0)
    return xp.where(in_region, cov, 1.0)


def rounded_rect_sdf_coverage(xp, rect4, radii8, lx, ly, aa_mul):
    """cs_clip_rectangle's exact fragment math (ellipse.glsl
    distance_to_rounded_rect): select the corner via the diagonal
    half-space planes, Taubin first-order ellipse distance
    g/|∇g| (distance_to_ellipse_approx with scale=1), combined with the
    rect SDF via max(), one AA clamp with the reciprocal aa range
    `aa_mul` (compute_aa_range)."""
    x0, y0, x1, y1 = rect4[0], rect4[1], rect4[2], rect4[3]
    big = 1e-6
    pxc = lx
    pyc = ly
    # default corner: tiny point, unit radii → hugely negative distance
    cpx = xp.full_like(lx, big)
    cpy = xp.full_like(ly, big)
    civx = xp.ones_like(lx)
    civy = xp.ones_like(ly)
    corners = (
        # (rx, ry, nx, ny, plane point, corner-local p)
        (radii8[0], radii8[1], -radii8[1], -radii8[0],
         (x0, y0 + radii8[1]),
         lambda rx, ry: ((x0 + rx) - pxc, (y0 + ry) - pyc)),
        (radii8[2], radii8[3], radii8[3], -radii8[2],
         (x1 - radii8[2], y0),
         lambda rx, ry: (-((x1 - rx) - pxc), (y0 + ry) - pyc)),
        (radii8[4], radii8[5], radii8[5], radii8[4],
         (x1, y1 - radii8[5]),
         lambda rx, ry: (pxc - (x1 - rx), pyc - (y1 - ry))),
        (radii8[6], radii8[7], -radii8[7], radii8[6],
         (x0 + radii8[6], y1),
         lambda rx, ry: ((x0 + rx) - pxc, -((y1 - ry) - pyc))),
    )
    for rx, ry, nx, ny, (ppx, ppy), mk in corners:
        off = nx * ppx + ny * ppy
        sel = (nx * pxc + ny * pyc) > off
        cx, cy = mk(rx, ry)
        ivx = 1.0 / xp.maximum(rx * rx, 1e-6)
        ivy = 1.0 / xp.maximum(ry * ry, 1e-6)
        cpx = xp.where(sel, cx, cpx)
        cpy = xp.where(sel, cy, cpy)
        civx = xp.where(sel, ivx, civx)
        civy = xp.where(sel, ivy, civy)
    prx = cpx * civx
    pry = cpy * civy
    g = cpx * prx + cpy * pry - 1.0
    dgx = 2.0 * prx
    dgy = 2.0 * pry
    norm = xp.sqrt(dgx * dgx + dgy * dgy)
    ell = g / xp.where(norm > 1e-12, norm, 1e-12)
    rect = xp.maximum(xp.maximum(x0 - lx, lx - x1),
                      xp.maximum(y0 - ly, ly - y1))
    dist = xp.maximum(ell, rect)
    return xp.clip(0.5 - dist * aa_mul, 0.0, 1.0)


def rounded_rect_fast_coverage(xp, rect4, radius, lx, ly, aa_mul):
    """cs_clip_rectangle's WR_FEATURE_FAST_PATH (uniform corner radius):
    the exact Euclidean rounded-box SDF sd_rounded_box (:160-167), which
    the reference selects whenever `radius.is_uniform()`
    (render_target.rs:1215) — its corner AA differs measurably from the
    Taubin ellipse approximation of the general path."""
    cx = (rect4[0] + rect4[2]) * 0.5
    cy = (rect4[1] + rect4[3]) * 0.5
    hx = (rect4[2] - rect4[0]) * 0.5 - radius
    hy = (rect4[3] - rect4[1]) * 0.5 - radius
    dx = xp.abs(lx - cx) - hx
    dy = xp.abs(ly - cy) - hy
    outside = xp.sqrt(xp.maximum(dx, 0.0) ** 2 + xp.maximum(dy, 0.0) ** 2)
    inside = xp.minimum(xp.maximum(dx, dy), 0.0)
    dist = outside + inside - radius
    return xp.clip(0.5 - dist * aa_mul, 0.0, 1.0)


def uniform_radius(radii8):
    """BorderRadius::is_uniform(): one scalar radius for all corners
    (widths == heights), or None."""
    r = radii8[0]
    for v in radii8[1:]:
        if abs(float(v) - float(r)) > 1e-6:
            return None
    return float(r)


def rounded_rect_coverage_auto(xp, trow, rect4, radii8, lx, ly, px, py,
                               fast_flag=None):
    """Rounded-rect clip coverage — cs_clip_rectangle with the
    fwidth-based reciprocal AA range (uniform across axis-aligned and
    transformed prims, like the shader).  `fast_flag` (clip record [15])
    selects WR_FEATURE_FAST_PATH: when the radii are uniform the
    reference uses the exact Euclidean rounded-box SDF instead of the
    Taubin ellipse approximation (render_target.rs:1215
    radius.is_uniform) — the two differ by 1-2 u8 steps on shallow-angle
    arc pixels (e.g. gradient/conic-color-wheel's circle clip)."""
    fw = local_fwidth(xp, trow, lx, ly, px, py)
    aa_mul = 1.0 / xp.where(fw > 1e-9, fw, 1e-9)
    sdf = rounded_rect_sdf_coverage(xp, rect4, radii8, lx, ly, aa_mul)
    if fast_flag is None:
        return sdf
    fast = rounded_rect_fast_coverage(xp, rect4, radii8[0], lx, ly, aa_mul)
    return xp.where(fast_flag > 0.5, fast, sdf)


def rounded_rect_coverage(xp, rect4, radii8, lx, ly, sx, sy):
    """Coverage of a rounded rect (all edges AA'd)."""
    x0, y0, x1, y1 = rect4[0], rect4[1], rect4[2], rect4[3]
    cov = rect_coverage(xp, x0, y0, x1, y1, lx, ly, sx, sy, 0xF)
    scale = xp.sqrt(sx * sy)
    # top-left, top-right, bottom-right, bottom-left
    cov = cov * _corner_coverage(xp, lx, ly, x0 + radii8[0], y0 + radii8[1],
                                 radii8[0], radii8[1], 1.0, 1.0, scale)
    cov = cov * _corner_coverage(xp, lx, ly, x1 - radii8[2], y0 + radii8[3],
                                 radii8[2], radii8[3], -1.0, 1.0, scale)
    cov = cov * _corner_coverage(xp, lx, ly, x1 - radii8[4], y1 - radii8[5],
                                 radii8[4], radii8[5], -1.0, -1.0, scale)
    cov = cov * _corner_coverage(xp, lx, ly, x0 + radii8[6], y1 - radii8[7],
                                 radii8[6], radii8[7], 1.0, -1.0, scale)
    return cov


# ---------------------------------------------------------------------------
# texture sampling

def swgl_bilinear_coords(xp, u, v, W, H):
    """swgl's fixed-point bilinear addressing (`swgl/src/texture.h`:
    linearQuantize :428 + textureLinearPlanarRGBA8 :481): coordinates
    quantize to 7-bit fractions, the x fraction snaps to 0/128 at the
    row ends (computeFracX :465), and the second row collapses onto the
    first at the bottom edge (computeNextRowOffset :458).
    Returns (x0, y0, row1_off, fx, fy) with fx/fy in [0, 128]."""
    qu = xp.floor(u * 128.0 - 63.5)
    qv = xp.floor(v * 128.0 - 63.5)
    ix = xp.floor(qu / 128.0)
    iy = xp.floor(qv / 128.0)
    fx = qu - ix * 128.0
    fy = qv - iy * 128.0
    overread = ix > (W - 2)
    fx = xp.where(ix < 0, 0.0, fx)
    fx = xp.where(overread, 128.0, fx)
    x0 = xp.clip(ix, 0, W - 2)
    y0 = xp.clip(iy, 0, H - 1)
    row1 = xp.where((iy >= 0) & (iy < H - 1), 1.0, 0.0)
    return (x0.astype("int32"), y0.astype("int32"),
            row1.astype("int32"), fx, fy)


def _fixed_lerp(xp, a, b, frac):
    """swgl int16 lerp: a + ((b - a) * frac) >> 7 with arithmetic shift
    (floor division).  a/b are u8 texel values held in f32 (exact)."""
    return a + xp.floor((b - a) * frac * (1.0 / 128.0))


def sample_rgba(xp, atlas, u, v, u0, v0, u1, v1, nearest):
    """Bilinear/nearest sample of a planar [4, H, W] atlas, clamped to the
    half-texel inset of the uv rect (brush_image.glsl sample bounds).
    The bilinear path reproduces swgl's fixed-point filtering exactly:
    7-bit fractions, int16 lerps with truncating shifts
    (`swgl/src/texture.h` textureLinearPlanarRGBA8)."""
    H, W = atlas.shape[1], atlas.shape[2]
    lo_u = u0 + 0.5
    hi_u = xp.maximum(u1 - 0.5, lo_u)
    lo_v = v0 + 0.5
    hi_v = xp.maximum(v1 - 0.5, lo_v)
    u = xp.clip(u, lo_u, hi_u)
    v = xp.clip(v, lo_v, hi_v)
    # nearest snaps to texel centers, making the bilinear lerp degenerate
    un = xp.floor(u) + 0.5
    vn = xp.floor(v) + 0.5
    u = xp.where(nearest > 0.5, un, u)
    v = xp.where(nearest > 0.5, vn, v)
    x0i, y0i, row1, fx, fy = swgl_bilinear_coords(xp, u, v, W, H)
    fx = fx[None]
    fy = fy[None]
    y1i = y0i + row1
    x1i = xp.clip(x0i + 1, 0, W - 1)
    # flat 1D gathers: 2D advanced indexing under a tile vmap makes XLA
    # materialize a per-tile copy of the whole atlas (OOM at 4096²×96);
    # u8-ify the gathered taps only (atlas values sit on the u8 grid)
    flat = atlas.reshape(4, -1)
    t00 = xp.floor(flat[:, y0i * W + x0i] * 255.0 + 0.5)
    t10 = xp.floor(flat[:, y0i * W + x1i] * 255.0 + 0.5)
    t01 = xp.floor(flat[:, y1i * W + x0i] * 255.0 + 0.5)
    t11 = xp.floor(flat[:, y1i * W + x1i] * 255.0 + 0.5)
    a = _fixed_lerp(xp, t00, t01, fy)
    b = _fixed_lerp(xp, t10, t11, fy)
    return _fixed_lerp(xp, a, b, fx) * (1.0 / 255.0)


def sample_rgba_llvm(xp, atlas, u, v, u0, v0, u1, v1, nearest):
    """Planar-RGBA bilinear with llvmpipe's exact filtering (the linux CI
    renderer behind platform(linux,mac) PNG refs — see sample_alpha_llvm):
    8-bit ROUNDED weights, per-axis integer lerp `(a·(256−w)+b·w+128)>>8`,
    X first then Y.  uv-rect clamping matches sample_rgba."""
    H, W = atlas.shape[1], atlas.shape[2]
    lo_u = u0 + 0.5
    hi_u = xp.maximum(u1 - 0.5, lo_u)
    lo_v = v0 + 0.5
    hi_v = xp.maximum(v1 - 0.5, lo_v)
    u = xp.clip(u, lo_u, hi_u)
    v = xp.clip(v, lo_v, hi_v)
    un = xp.floor(u) + 0.5
    vn = xp.floor(v) + 0.5
    u = xp.where(nearest > 0.5, un, u)
    v = xp.where(nearest > 0.5, vn, v)
    x0 = xp.clip(xp.floor(u - 0.5), 0.0, max(W - 2, 0))
    y0 = xp.clip(xp.floor(v - 0.5), 0.0, max(H - 2, 0))
    fx = xp.floor((u - 0.5 - x0) * 256.0 + 0.5)[None]
    fy = xp.floor((v - 0.5 - y0) * 256.0 + 0.5)[None]
    x0 = x0.astype("int32")
    y0 = y0.astype("int32")
    x1 = xp.clip(x0 + 1, 0, W - 1)
    y1 = xp.clip(y0 + 1, 0, H - 1)
    flat = atlas.reshape(4, -1)
    t00 = xp.floor(flat[:, y0 * W + x0] * 255.0 + 0.5)
    t10 = xp.floor(flat[:, y0 * W + x1] * 255.0 + 0.5)
    t01 = xp.floor(flat[:, y1 * W + x0] * 255.0 + 0.5)
    t11 = xp.floor(flat[:, y1 * W + x1] * 255.0 + 0.5)
    a = xp.floor((t00 * (256.0 - fx) + t10 * fx + 128.0) * (1.0 / 256.0))
    b = xp.floor((t01 * (256.0 - fx) + t11 * fx + 128.0) * (1.0 / 256.0))
    out = xp.floor((a * (256.0 - fy) + b * fy + 128.0) * (1.0 / 256.0))
    return out * (1.0 / 255.0)


def sample_alpha8(xp, atlas, u, v, u0, v0, u1, v1):
    """Single-plane bilinear with GPU-style 8-bit fractions and a rounded
    result (vs swgl's truncating 7-bit path in sample_alpha): used where
    the reference samples with real GPU texture filtering (the cached
    box-shadow masks).  Exact integer arithmetic — all backends agree."""
    H, W = atlas.shape[0], atlas.shape[1]
    lo_u = u0 + 0.5
    hi_u = xp.maximum(u1 - 0.5, lo_u)
    lo_v = v0 + 0.5
    hi_v = xp.maximum(v1 - 0.5, lo_v)
    u = xp.clip(u, lo_u, hi_u)
    v = xp.clip(v, lo_v, hi_v)
    x0 = xp.clip(xp.floor(u - 0.5), 0.0, max(W - 2, 0))
    y0 = xp.clip(xp.floor(v - 0.5), 0.0, max(H - 2, 0))
    fx = xp.floor((u - 0.5 - x0) * 256.0 + 0.5)
    fy = xp.floor((v - 0.5 - y0) * 256.0 + 0.5)
    x0 = x0.astype("int32")
    y0 = y0.astype("int32")
    x1 = xp.clip(x0 + 1, 0, W - 1)
    y1 = xp.clip(y0 + 1, 0, H - 1)
    flat = atlas.reshape(-1)
    t00 = xp.floor(flat[y0 * W + x0] * 255.0 + 0.5)
    t10 = xp.floor(flat[y0 * W + x1] * 255.0 + 0.5)
    t01 = xp.floor(flat[y1 * W + x0] * 255.0 + 0.5)
    t11 = xp.floor(flat[y1 * W + x1] * 255.0 + 0.5)
    a = t00 * (256.0 - fx) + t10 * fx
    b = t01 * (256.0 - fx) + t11 * fx
    out = a * (256.0 - fy) + b * fy
    return xp.floor(out * (1.0 / 65536.0) + 0.5) * (1.0 / 255.0)


def sample_alpha_llvm(xp, atlas, u, v, u0, v0, u1, v1):
    """Single-plane bilinear with llvmpipe's exact filtering (the linux CI
    renderer — calibrated by tools/glprobe.py): 8-bit ROUNDED weights
    w = round(frac·256), per-axis integer lerp `(a·(256−w)+b·w+128)>>8`,
    X lerp first then Y.  Exact integer arithmetic — all backends agree;
    the result lies on the u8 grid (llvmpipe returns the quantized lerp
    to the shader)."""
    H, W = atlas.shape[0], atlas.shape[1]
    lo_u = u0 + 0.5
    hi_u = xp.maximum(u1 - 0.5, lo_u)
    lo_v = v0 + 0.5
    hi_v = xp.maximum(v1 - 0.5, lo_v)
    u = xp.clip(u, lo_u, hi_u)
    v = xp.clip(v, lo_v, hi_v)
    x0 = xp.clip(xp.floor(u - 0.5), 0.0, max(W - 2, 0))
    y0 = xp.clip(xp.floor(v - 0.5), 0.0, max(H - 2, 0))
    fx = xp.floor((u - 0.5 - x0) * 256.0 + 0.5)
    fy = xp.floor((v - 0.5 - y0) * 256.0 + 0.5)
    x0 = x0.astype("int32")
    y0 = y0.astype("int32")
    x1 = xp.clip(x0 + 1, 0, W - 1)
    y1 = xp.clip(y0 + 1, 0, H - 1)
    flat = atlas.reshape(-1)
    t00 = xp.floor(flat[y0 * W + x0] * 255.0 + 0.5)
    t10 = xp.floor(flat[y0 * W + x1] * 255.0 + 0.5)
    t01 = xp.floor(flat[y1 * W + x0] * 255.0 + 0.5)
    t11 = xp.floor(flat[y1 * W + x1] * 255.0 + 0.5)
    a = xp.floor((t00 * (256.0 - fx) + t10 * fx + 128.0) * (1.0 / 256.0))
    b = xp.floor((t01 * (256.0 - fx) + t11 * fx + 128.0) * (1.0 / 256.0))
    out = xp.floor((a * (256.0 - fy) + b * fy + 128.0) * (1.0 / 256.0))
    return out * (1.0 / 255.0)


def sample_alpha(xp, atlas, u, v, u0, v0, u1, v1):
    """Bilinear sample of an alpha [H, W] atlas with uv-rect clamping;
    swgl's fixed-point filtering (textureLinearUnpackedR8)."""
    H, W = atlas.shape
    u = xp.clip(u, u0 + 0.5, xp.maximum(u1 - 0.5, u0 + 0.5))
    v = xp.clip(v, v0 + 0.5, xp.maximum(v1 - 0.5, v0 + 0.5))
    x0i, y0i, row1, fx, fy = swgl_bilinear_coords(xp, u, v, W, H)
    y1i = y0i + row1
    x1i = xp.clip(x0i + 1, 0, W - 1)
    flat = atlas.reshape(-1)
    t00 = xp.floor(flat[y0i * W + x0i] * 255.0 + 0.5)
    t10 = xp.floor(flat[y0i * W + x1i] * 255.0 + 0.5)
    t01 = xp.floor(flat[y1i * W + x0i] * 255.0 + 0.5)
    t11 = xp.floor(flat[y1i * W + x1i] * 255.0 + 0.5)
    a = _fixed_lerp(xp, t00, t01, fy)
    b = _fixed_lerp(xp, t10, t11, fy)
    return _fixed_lerp(xp, a, b, fx) * (1.0 / 255.0)


# ---------------------------------------------------------------------------
# gradient stop evaluation

def eval_gradient_stops(xp, fori, f32_buf, addr, nstops, t, extend_repeat):
    """Evaluate normalized gradient stops directly (exact hard stops).

    The reference bakes stops into a 128-entry LUT (`gradient.glsl`
    sample_gradient); direct evaluation is exact for arbitrary stop
    positions and avoids LUT resolution fuzz. Stops are stored in the flat
    f32 buffer as 8-float records [offset, r·a, g·a, b·a, a, 0, 0, 0] —
    PREMULTIPLIED, matching the reference's PremultipliedColorF ramps
    (prim_store/gradient/mod.rs); interpolation happens directly in that
    space. `fori(lo, hi, body, init)` abstracts lax.fori_loop vs a python
    loop."""
    t = xp.where(extend_repeat > 0.5, t - xp.floor(t), t)
    c0 = xp.stack([f32_buf[addr + 1], f32_buf[addr + 2],
                   f32_buf[addr + 3], f32_buf[addr + 4]], 0)
    out0 = xp.broadcast_to(c0[:, None, None],
                           (4,) + t.shape) + xp.zeros((4,) + t.shape, "float32")

    def body(i, out):
        base = addr + i * 8
        o0 = f32_buf[base - 8]
        o1 = f32_buf[base]
        c1 = xp.stack([f32_buf[base + 1], f32_buf[base + 2],
                       f32_buf[base + 3], f32_buf[base + 4]], 0)
        denom = o1 - o0
        # hard stop (o1 == o0): step at the shared offset
        w = xp.where(denom > 1e-9,
                     xp.clip((t - o0) / xp.where(denom > 1e-9, denom, 1.0),
                             0.0, 1.0),
                     xp.where(t >= o1, 1.0, 0.0))
        return out + (c1[:, None, None] - out) * w[None]

    return fori(1, nstops, body, out0)


# ---------------------------------------------------------------------------
# patterns (premultiplied [4, H, W] results)

def _bcast4(xp, vals, shape):
    return xp.stack([xp.broadcast_to(vals[i], shape) for i in range(4)], 0)


def pattern_solid(xp, p, lx, ly):
    return _bcast4(xp, [p[8], p[9], p[10], p[11]], lx.shape)


def _tile_coords(xp, p, lx, ly, stretch_w, stretch_h, spacing_w, spacing_h):
    """Repeat-tiling of local coords (image_tiling.rs / repeating images).
    Returns in-tile coords + in-tile mask."""
    ox = lx - p[0]
    oy = ly - p[1]
    period_x = stretch_w + spacing_w
    period_y = stretch_h + spacing_h
    period_x = xp.where(period_x > 1e-6, period_x, 1e6)
    period_y = xp.where(period_y > 1e-6, period_y, 1e6)
    tx = ox - xp.floor(ox / period_x) * period_x
    ty = oy - xp.floor(oy / period_y) * period_y
    in_tile = (tx < stretch_w + 1e-4) & (ty < stretch_h + 1e-4)
    return tx, ty, in_tile


def pattern_image(xp, p, lx, ly, color_atlas, gl: bool = False):
    """brush_image.glsl: [8:12] atlas uv rect, [18:20] stretch size,
    [20:22] tile spacing, [22:24] image-px per local-px scale, [24:26]
    crop origin in image px (huge-image sub-rect residency).
    `gl` = llvmpipe bilinear (GL-pipeline reftest lines)."""
    u0, v0, u1, v1 = p[8], p[9], p[10], p[11]
    stretch_w = xp.maximum(p[18], 1e-6)
    stretch_h = xp.maximum(p[19], 1e-6)
    tx, ty, in_tile = _tile_coords(xp, p, lx, ly, stretch_w, stretch_h,
                                   p[20], p[21])
    u = u0 + tx * p[22] - p[24]
    v = v0 + ty * p[23] - p[25]
    # gl NOTE: PNG evidence (transforms suite, r5) shows the CI's
    # composite/image sampling lands CLOSER to swgl's truncating 7-bit
    # filter than to an llvmpipe 8-bit rounded lerp at our analytically-
    # derived uv coordinates — the residual is coordinate ULPs (llvmpipe
    # interpolates varyings by 4-wide accumulating plane stamps,
    # tools/glinterp_probe.py), not filter flavor.  Keep one sampler.
    del gl
    texel = sample_rgba(xp, color_atlas, u, v, u0, v0, u1, v1, p[16])
    mod = xp.stack([p[12], p[13], p[14], p[15]], 0)
    return texel * mod[:, None, None] * in_tile[None]


def pattern_yuv(xp, p, lx, ly, alpha_atlas):
    """In-kernel YUV (yuv.glsl sample_yuv + rgb_from_debiased_ycbcr,
    `webrender/res/yuv.glsl:82-150`): the three planes live in the ALPHA
    atlas (host splits NV12/interleaved into planar at upload — a u8
    copy, not a conversion), sampled with swgl fixed-point bilinear and
    converted with the color-space matrix per pixel.  Payload:
    [8:12] Y uv rect, [12:16] U rect, [16:20] V rect, [20:22] stretch,
    [22:24] luma texels per local px, [24:26] chroma texels per local px,
    [26] nearest, [27:36] rgb_from_debiased_ycbcr row-major,
    [36:39] ycbcr bias."""
    ox = lx - p[0]
    oy = ly - p[1]
    yy = sample_alpha(xp, alpha_atlas, p[8] + ox * p[22],
                      p[9] + oy * p[23], p[8], p[9], p[10], p[11])
    uu = sample_alpha(xp, alpha_atlas, p[12] + ox * p[24],
                      p[13] + oy * p[25], p[12], p[13], p[14], p[15])
    vv = sample_alpha(xp, alpha_atlas, p[16] + ox * p[24],
                      p[17] + oy * p[25], p[16], p[17], p[18], p[19])
    sy_ = yy - p[36]
    su_ = uu - p[37]
    sv_ = vv - p[38]
    r = p[27] * sy_ + p[28] * su_ + p[29] * sv_
    g = p[30] * sy_ + p[31] * su_ + p[32] * sv_
    b = p[33] * sy_ + p[34] * su_ + p[35] * sv_
    one = xp.ones_like(yy)
    return xp.clip(xp.stack([r, g, b, one], 0), 0.0, 1.0)


def pattern_glyph(xp, p, lx, ly, alpha_atlas):
    # rect→uv scaling: glyphs rasterized at device scale have uv rects
    # larger than their local rects (text under scaling transforms)
    su = (p[10] - p[8]) / xp.maximum(p[2] - p[0], 1e-6)
    sv = (p[11] - p[9]) / xp.maximum(p[3] - p[1], 1e-6)
    u = p[8] + (lx - p[0]) * su
    v = p[9] + (ly - p[1]) * sv
    a = sample_alpha(xp, alpha_atlas, u, v, p[8], p[9], p[10], p[11])
    col = xp.stack([p[12], p[13], p[14], p[15]], 0)
    return col[:, None, None] * a[None]


def pattern_subpx_glyph(xp, p, lx, ly, color_atlas):
    """Subpixel-AA glyph: the COLOR atlas holds per-channel (LCD) masks;
    the payload color mod carries either (a,a,a,a) for the punch instance
    or the premultiplied text color for the add instance
    (ps_text_run dual-source blending re-expressed as two blend ops)."""
    su = (p[10] - p[8]) / xp.maximum(p[2] - p[0], 1e-6)
    sv = (p[11] - p[9]) / xp.maximum(p[3] - p[1], 1e-6)
    u = p[8] + (lx - p[0]) * su
    v = p[9] + (ly - p[1]) * sv
    m = sample_rgba(xp, color_atlas, u, v, p[8], p[9], p[10], p[11], 0.0)
    m_avg = (m[0] + m[1] + m[2]) * (1.0 / 3.0)
    return xp.stack([m[0] * p[12], m[1] * p[13], m[2] * p[14],
                     m_avg * p[15]], 0)


def gradient_t_linear(xp, p, lx, ly):
    tx, ty, in_tile = _tile_coords(xp, p, lx, ly,
                                   xp.maximum(p[16], 1e-6),
                                   xp.maximum(p[17], 1e-6), p[18], p[19])
    dx = p[10] - p[8]
    dy = p[11] - p[9]
    denom = dx * dx + dy * dy
    denom = xp.where(denom > 1e-9, denom, 1e-9)
    t = ((tx - p[8]) * dx + (ty - p[9]) * dy) / denom
    return t, in_tile


def pattern_linear_gradient(xp, fori, p, lx, ly, f32_buf):
    """brush_linear_gradient.glsl / cs_linear_gradient.glsl."""
    t, in_tile = gradient_t_linear(xp, p, lx, ly)
    return _grad_task_quant(xp, p, _grad(xp, fori, p, f32_buf, t)) \
        * in_tile[None]


def _grad_task_quant(xp, p, c):
    """GL-CI gradients render through a CACHED u8 render task
    (cs_*_gradient → texture cache; prim_store/gradient/linear.rs:3395
    `cached`), so the ramp quantizes to the u8 grid (llvmpipe round-half-
    even target write) before compositing.  The swgl CI draws non-tiled
    gradients direct (is_software disables caching) — p[15] carries the
    per-frame flavor decision from the frame builder."""
    q = xp.clip(xp.rint(c * 255.0), 0.0, 255.0) * (1.0 / 255.0)
    return xp.where(p[15] > 0.5, q, c)


def _grad(xp, fori, p, f32_buf, t):
    # No pre-clamping: stop evaluation saturates naturally below the first /
    # above the last stop (gradient.glsl clamp_gradient_entry: offsets < 0
    # take the *first* color even when a hard stop sits exactly at 0).
    addr = p[12].astype("int32") if hasattr(p, "dtype") else int(p[12])
    n = p[14].astype("int32") if hasattr(p, "dtype") else int(p[14])
    return eval_gradient_stops(xp, fori, f32_buf, addr, n, t, p[13])


def gradient_t_radial(xp, p, lx, ly):
    tx, ty, in_tile = _tile_coords(xp, p, lx, ly,
                                   xp.maximum(p[18], 1e-6),
                                   xp.maximum(p[19], 1e-6), p[20], p[21])
    rx = xp.where(p[10] > 1e-6, p[10], 1e-6)
    ry = xp.where(p[11] > 1e-6, p[11], rx)
    dx = tx - p[8]
    dy = (ty - p[9]) * (rx / ry)
    d = xp.sqrt(dx * dx + dy * dy) / rx
    denom = p[17] - p[16]
    scale = xp.where(xp.abs(denom) > 1e-9, 1.0 / xp.where(
        xp.abs(denom) > 1e-9, denom, 1.0), 0.0)
    t = (d - p[16]) * scale
    return t, in_tile


def pattern_radial_gradient(xp, fori, p, lx, ly, f32_buf):
    """cs_radial_gradient.glsl: elliptical distance scaled by radius.x,
    then (d - start_offset) / (end_offset - start_offset)."""
    t, in_tile = gradient_t_radial(xp, p, lx, ly)
    return _grad_task_quant(xp, p, _grad(xp, fori, p, f32_buf, t)) \
        * in_tile[None]


def gradient_t_conic(xp, p, lx, ly):
    tx, ty, in_tile = _tile_coords(xp, p, lx, ly,
                                   xp.maximum(p[18], 1e-6),
                                   xp.maximum(p[19], 1e-6), p[20], p[21])
    dx = tx - p[8]
    dy = ty - p[9]
    theta = atan2_shared(xp, dy, dx) + (1.5707963267948966 - p[10])
    # `xp.divide`: on CUDA tensors torch turns `theta / 2pi` into a product
    # with the reciprocal, which rounds twice (blend.srgb_to_linear)
    tr = xp.divide(theta, 6.283185307179586)
    tr = tr - xp.floor(tr)
    denom = p[17] - p[16]
    scale = xp.where(xp.abs(denom) > 1e-9, 1.0 / xp.where(
        xp.abs(denom) > 1e-9, denom, 1.0), 0.0)
    t = (tr - p[16]) * scale
    return t, in_tile


def pattern_conic_gradient(xp, fori, p, lx, ly, f32_buf):
    """cs_conic_gradient.glsl: angle = atan(dy, dx) + (pi/2 - aAngle);
    offset = fract(angle / 2pi) / d - start/d."""
    t, in_tile = gradient_t_conic(xp, p, lx, ly)
    return _grad_task_quant(xp, p, _grad(xp, fori, p, f32_buf, t)) \
        * in_tile[None]


def _blurred_rect_coverage(xp, x0, y0, x1, y1, sigma, lx, ly):
    """Gaussian-blurred axis-aligned rect: exact separable product of 1D
    blurred-box profiles (box shadows; sigma = blur_radius / 2)."""
    s = xp.where(sigma > 1e-3, sigma, 1e-3) * 1.4142135623730951
    bx = 0.5 * (erf(xp, (lx - x0) / s) - erf(xp, (lx - x1) / s))
    by = 0.5 * (erf(xp, (ly - y0) / s) - erf(xp, (ly - y1) / s))
    return bx * by


def _blurred_rounded_rect_coverage(xp, rect, radii, sigma, lx, ly):
    """Gaussian blur of a rounded rect: analytic erf blur along x of each
    horizontal slice (the slice's x-interval accounts for the elliptical
    corner cuts), integrated along y by gaussian-weighted midpoint
    quadrature.  The reference blurs a rasterized rounded-rect task
    (box_shadow.rs + cs_blur); this closed-ish form avoids the task."""
    x0, y0, x1, y1 = rect[0], rect[1], rect[2], rect[3]
    sig = xp.where(sigma > 1e-3, sigma, 1e-3)
    s = sig * 1.4142135623730951
    # exact separable blur of the full rect, then subtract the blurred
    # corner cut regions (rect corner minus quarter ellipse), each
    # integrated over its EXACT y-extent so the quadrature never crosses
    # a discontinuity
    base = _blurred_rect_coverage(xp, x0, y0, x1, y1, sigma, lx, ly)
    invnorm = 1.0 / (sig * 2.5066282746310002)
    N = 8
    # (rx, ry, y edge, sign into rect, left?)
    corners = ((radii[0], radii[1], y0, 1.0, True),    # TL
               (radii[2], radii[3], y0, 1.0, False),   # TR
               (radii[4], radii[5], y1, -1.0, False),  # BR
               (radii[6], radii[7], y1, -1.0, True))   # BL
    for rx, ry, ye, sgn, left in corners:
        act = (rx > 1e-6) & (ry > 1e-6)
        ry_s = xp.where(ry > 1e-6, ry, 1.0)
        rx_s = xp.where(rx > 1e-6, rx, 1.0)
        # integrate only where the gaussian weight is non-negligible:
        # corner y-range ∩ [ly ± 4σ] — the step then scales with σ, so
        # radii ≫ σ stay resolved (box-shadow-huge-radius)
        c_lo = xp.minimum(ye, ye + sgn * ry_s)
        c_hi = xp.maximum(ye, ye + sgn * ry_s)
        lo = xp.clip(ly - 4.0 * sig, c_lo, c_hi)
        hi = xp.clip(ly + 4.0 * sig, c_lo, c_hi)
        step = xp.maximum(hi - lo, 0.0) / N
        corr = xp.zeros(lx.shape, "float32")
        for i in range(N):
            yp = lo + (i + 0.5) * step
            dy = xp.abs(yp - ye)            # distance from the flat edge
            dc = 1.0 - dy / ry_s            # 1 at the edge → 0 at center
            inset = rx_s * (1.0 - xp.sqrt(xp.clip(1.0 - dc * dc,
                                                  0.0, 1.0)))
            if left:
                covx = 0.5 * (erf(xp, (lx - x0) / s) -
                              erf(xp, (lx - (x0 + inset)) / s))
            else:
                covx = 0.5 * (erf(xp, (lx - (x1 - inset)) / s) -
                              erf(xp, (lx - x1) / s))
            w = xp.exp(-0.5 * ((yp - ly) / sig) ** 2) * invnorm * step
            corr = corr + w * covx
        base = base - xp.where(act, corr, 0.0)
    return xp.clip(base, 0.0, 1.0)


def pattern_box_shadow(xp, p, lx, ly, sx, sy):
    """Analytic box shadow (payload layout in frame/gpu.py); rounded
    corners blur via _blurred_rounded_rect_coverage."""
    sigma = p[20]
    inset = p[21]
    sharp = sigma <= 1e-3
    shadow_rect = p[8:12]
    shadow_radii = p[12:20]
    any_r = (p[12] + p[13] + p[14] + p[15] +
             p[16] + p[17] + p[18] + p[19]) > 1e-6
    blurred = xp.where(
        sharp,
        rounded_rect_coverage(xp, shadow_rect, shadow_radii, lx, ly, sx, sy),
        xp.where(
            any_r,
            _blurred_rounded_rect_coverage(xp, shadow_rect, shadow_radii,
                                           sigma, lx, ly),
            _blurred_rect_coverage(xp, p[8], p[9], p[10], p[11], sigma,
                                   lx, ly)))
    box_cov = rounded_rect_coverage(xp, p[22:26], p[26:34], lx, ly, sx, sy)
    cov = xp.where(inset > 0.5,
                   (1.0 - blurred) * box_cov,
                   blurred * (1.0 - box_cov))
    # u8-grid mask quantization with the tie nudge: the reference's box
    # shadow samples a CACHED u8 mask texture, so the mask is integer by
    # construction — snapping the analytic value both matches that and
    # makes the backends immune to TPU sqrt/exp ULP noise (blend.py
    # quantize_cov rationale)
    from . import __init__ as _  # noqa: F401 (keep import graph acyclic)
    from .blend import quantize_cov
    cov = quantize_cov(xp, cov, 255.0) * (1.0 / 255.0)
    # per-channel products (a (4,)->(4,1,1) broadcast trips Mosaic's
    # layout inference; stacking full planes lowers cleanly everywhere)
    return xp.stack([p[34] * cov, p[35] * cov, p[36] * cov,
                     p[37] * cov], 0)


def pattern_border(xp, p, lx, ly, sx, sy):
    """Full normal-border evaluation (cs_border_segment.glsl re-designed as
    one analytic kernel): ring coverage = outer rounded rect minus inner,
    mitered side assignment by normalized edge depth (argmin of depth/width
    — equivalent to the corner color line of border.rs), two-tone halves for
    groove/ridge, thirds for double, dot/dash modulation.

    Payload: [8:12] widths (t,r,b,l)  [12:20] radii  [20:36] outer-half
    premult colors (t,r,b,l)  [36:52] inner-half colors  [52:56] styles."""
    x0, y0, x1, y1 = p[0], p[1], p[2], p[3]
    w_t, w_r, w_b, w_l = p[8], p[9], p[10], p[11]
    radii = p[12:20]
    outer = rounded_rect_coverage(xp, p[0:4], radii, lx, ly, sx, sy)
    ix0 = x0 + w_l
    iy0 = y0 + w_t
    ix1 = x1 - w_r
    iy1 = y1 - w_b
    inner_rect = xp.stack([ix0, iy0, ix1, iy1], 0)
    inner_radii = xp.stack([
        xp.maximum(radii[0] - w_l, 0.0), xp.maximum(radii[1] - w_t, 0.0),
        xp.maximum(radii[2] - w_r, 0.0), xp.maximum(radii[3] - w_t, 0.0),
        xp.maximum(radii[4] - w_r, 0.0), xp.maximum(radii[5] - w_b, 0.0),
        xp.maximum(radii[6] - w_l, 0.0), xp.maximum(radii[7] - w_b, 0.0)], 0)
    valid_inner = (ix1 > ix0) & (iy1 > iy0)
    inner = rounded_rect_coverage(xp, inner_rect, inner_radii, lx, ly, sx, sy)
    inner = xp.where(valid_inner, inner, 0.0)
    ring = outer * (1.0 - inner)

    eps = 1e-6
    big = 1e9

    # corner regions: the straight-edge depth metric doesn't apply inside
    # a rounded corner's box (depth > 1 there even on the ring) — the ring
    # shape bounds those pixels and depth is measured RADIALLY from the
    # outer ellipse (cs_border_segment renders corners as separate
    # ellipse-clipped segments; border-suite.yaml)
    def corner_zone(cx, cy, rx, ry, sign_x, sign_y):
        act = (rx > 0.0) & (ry > 0.0)
        rx_s = xp.where(act, rx, 1.0)
        ry_s = xp.where(act, ry, 1.0)
        dx = xp.clip((cx - lx) * sign_x, -1e6, 1e6)
        dy = xp.clip((cy - ly) * sign_y, -1e6, 1e6)
        inside = (dx > 0.0) & (dy > 0.0) & act
        ex = xp.clip(dx / rx_s, -1e4, 1e4)
        ey = xp.clip(dy / ry_s, -1e4, 1e4)
        g = xp.sqrt(ex * ex + ey * ey)
        grad = xp.sqrt((dx / (rx_s * rx_s)) ** 2 +
                       (dy / (ry_s * ry_s)) ** 2)
        grad = xp.where(grad > 1e-6, grad, 1e-6)
        dist = (g - 1.0) * g / grad  # local units, + outside the ellipse
        return inside, dist

    c_tl = corner_zone(x0 + radii[0], y0 + radii[1], radii[0], radii[1],
                       1.0, 1.0)
    c_tr = corner_zone(x1 - radii[2], y0 + radii[3], radii[2], radii[3],
                       -1.0, 1.0)
    c_br = corner_zone(x1 - radii[4], y1 - radii[5], radii[4], radii[5],
                       -1.0, -1.0)
    c_bl = corner_zone(x0 + radii[6], y1 - radii[7], radii[6], radii[7],
                       1.0, -1.0)
    in_corner = c_tl[0] | c_tr[0] | c_br[0] | c_bl[0]
    # depth into the ring from the outer ellipse, in local units; where
    # giant radii overlap zones, the NEAREST containing outer edge wins
    # (the pixel belongs to both corner segments)
    big_d = 1e9
    corner_depth_u = xp.minimum(
        xp.minimum(xp.where(c_tl[0], -c_tl[1], big_d),
                   xp.where(c_tr[0], -c_tr[1], big_d)),
        xp.minimum(xp.where(c_br[0], -c_br[1], big_d),
                   xp.where(c_bl[0], -c_bl[1], big_d)))
    corner_depth_u = xp.where(in_corner, corner_depth_u, 0.0)


    def active(i):
        st = p[52 + i]
        return (st != 0.0) & (st != 5.0)  # none / hidden sides don't own
    d_t = xp.where((w_t > eps) & active(0), (ly - y0) / xp.maximum(w_t, eps), big)
    d_r = xp.where((w_r > eps) & active(1), (x1 - lx) / xp.maximum(w_r, eps), big)
    d_b = xp.where((w_b > eps) & active(2), (y1 - ly) / xp.maximum(w_b, eps), big)
    d_l = xp.where((w_l > eps) & active(3), (lx - x0) / xp.maximum(w_l, eps), big)
    # corner zones belong only to their two ADJACENT sides (the reference
    # builds per-corner segments clipped to the adjacent sides): an
    # invisible adjacent pair leaves the corner empty even when an
    # opposite side is active (border-invisible.yaml).  Where giant radii
    # make zones OVERLAP, a side stays eligible if any zone containing the
    # pixel is adjacent to it (border-overlapping-corner.yaml)
    d_t = xp.where((c_br[0] | c_bl[0]) & ~(c_tl[0] | c_tr[0]), big, d_t)
    d_r = xp.where((c_tl[0] | c_bl[0]) & ~(c_tr[0] | c_br[0]), big, d_r)
    d_b = xp.where((c_tl[0] | c_tr[0]) & ~(c_bl[0] | c_br[0]), big, d_b)
    d_l = xp.where((c_tr[0] | c_br[0]) & ~(c_tl[0] | c_bl[0]), big, d_l)
    # mitered side ownership: smallest normalized depth (explicit compare
    # chain — argmin lowers poorly on the TPU vector unit)
    depth_raw = xp.minimum(xp.minimum(d_t, d_r), xp.minimum(d_b, d_l))
    any_owner = depth_raw < big * 0.5
    owner = xp.where(d_t <= depth_raw, 0,
                     xp.where(d_r <= depth_raw, 1,
                              xp.where(d_b <= depth_raw, 2, 3)))
    depth = xp.clip(depth_raw, 0.0, 1.0)

    color = xp.zeros((4,) + lx.shape, "float32")

    # --- dotted / dashed layout (border.rs get_edge_info :615) ---
    # corner-region extents (create_border_segments :674): the edge
    # pattern spans the space between them; everything below derives
    # from payload scalars already present (radii, widths, styles)
    ex_tl_w = xp.maximum(radii[0], w_l)
    ex_tl_h = xp.maximum(radii[1], w_t)
    ex_tr_w = xp.maximum(radii[2], w_r)
    ex_tr_h = xp.maximum(radii[3], w_t)
    ex_br_w = xp.maximum(radii[4], w_r)
    ex_br_h = xp.maximum(radii[5], w_b)
    ex_bl_w = xp.maximum(radii[6], w_l)
    ex_bl_h = xp.maximum(radii[7], w_b)
    edge_base = (x0 + ex_tl_w, y0 + ex_tr_h, x0 + ex_bl_w, y0 + ex_tl_h)
    edge_avail = ((x1 - x0) - ex_tl_w - ex_tr_w,
                  (y1 - y0) - ex_tr_h - ex_br_h,
                  (x1 - x0) - ex_bl_w - ex_br_w,
                  (y1 - y0) - ex_tl_h - ex_bl_h)

    # per-pixel corner classification: which corner-extent box contains
    # the pixel, that corner's style (= its first side's — TL:left TR:top
    # BR:right BL:bottom, add_segment :949), whether its radius collapses
    # to zero (write_dotted_corner_instances :401), and the zero-radius
    # corner dot coverage (one dot of diameter lerp(w0, w1, 0.5) centered
    # on the corner square, :436-445)
    cstyle = xp.zeros(lx.shape, "float32") - 1.0
    czero = xp.zeros(lx.shape, "float32") > 1.0     # dotted collapse (< w/2)
    czero_da = xp.zeros(lx.shape, "float32") > 1.0  # dashed: radius == 0
    corner_dot = xp.zeros(lx.shape, "float32")
    for ci, (s0i, cw_, ch_, crx, cry, in_box, ccx, ccy) in enumerate((
            (3, w_l, w_t, radii[0], radii[1],
             (lx < x0 + ex_tl_w) & (ly < y0 + ex_tl_h),
             x0 + 0.5 * w_l, y0 + 0.5 * w_t),
            (0, w_r, w_t, radii[2], radii[3],
             (lx >= x1 - ex_tr_w) & (ly < y0 + ex_tr_h),
             x1 - 0.5 * w_r, y0 + 0.5 * w_t),
            (1, w_r, w_b, radii[4], radii[5],
             (lx >= x1 - ex_br_w) & (ly >= y1 - ex_br_h),
             x1 - 0.5 * w_r, y1 - 0.5 * w_b),
            (2, w_l, w_b, radii[6], radii[7],
             (lx < x0 + ex_bl_w) & (ly >= y1 - ex_bl_h),
             x0 + 0.5 * w_l, y1 - 0.5 * w_b))):
        m = in_box & (cstyle < -0.5)
        zr = (crx < cw_ * 0.5) & (cry < ch_ * 0.5)
        cstyle = xp.where(m, p[52 + s0i] + xp.zeros(lx.shape, "float32"),
                          cstyle)
        czero = czero | (m & zr)
        czero_da = czero_da | (m & (crx < eps) & (cry < eps))
        want = (p[52 + s0i] == 3.0) & zr & (cw_ + ch_ > eps)
        ccr = 0.25 * (cw_ + ch_)
        dc = xp.sqrt((lx - ccx) ** 2 + (ly - ccy) ** 2) - ccr
        cov_c = xp.clip(0.5 - dc * (sx + sy) * 0.5, 0.0, 1.0)
        corner_dot = xp.maximum(corner_dot, xp.where(want, cov_c, 0.0))
    for side in range(4):
        c_out = p[20 + side * 4: 24 + side * 4]
        c_in = p[36 + side * 4: 40 + side * 4]
        style = p[52 + side]
        w_side = (w_t, w_r, w_b, w_l)[side]
        # radial depth inside corner regions, straight-edge depth elsewhere
        depth_s = xp.where(
            in_corner,
            xp.clip(corner_depth_u / xp.maximum(w_side, eps), 0.0, 1.0),
            depth)
        sc = xp.where(depth_s < 0.5,
                      xp.stack([xp.broadcast_to(c_out[i], lx.shape)
                                for i in range(4)], 0),
                      xp.stack([xp.broadcast_to(c_in[i], lx.shape)
                                for i in range(4)], 0))
        # double: keep outer and inner thirds
        scale = (sx, sy, sy, sx)[side] * w_side  # device px per depth unit
        third = xp.clip((1.0 / 3.0 - depth_s) * scale + 0.5, 0.0, 1.0) +             xp.clip((depth_s - 2.0 / 3.0) * scale + 0.5, 0.0, 1.0)
        third = xp.clip(third, 0.0, 1.0)
        # cs_border_segment.glsl: the double gap only applies when the
        # device partial width (w/3) is at least one pixel
        dbl = xp.where((style == 2.0) & (scale / 3.0 >= 1.0), third, 1.0)
        # dotted / dashed edge layout: patterns repeat only inside the
        # edge span between the corner regions (get_edge_info).  Corner
        # regions follow the CORNER's style (its first side's, add_segment
        # :949): dashed → empty square / arc-dash approx when rounded,
        # dotted → centered dot / arc-dot approx, else the normal draw.
        along = lx if side in (0, 2) else ly
        base = edge_base[side]
        avail = xp.maximum(edge_avail[side], 0.0)
        aa_dev = (sx, sy, sx, sy)[side]
        wse = xp.maximum(w_side, eps)
        # dashed: half_dash = avail / (ceil(avail/(1.5w)) padded to %4);
        # period = 4·half_dash; ON in [0, p/4) ∪ (3p/4, p] so edges start
        # and end with half dashes (compute_half_dash :589)
        # -1e-4 guards the f32 tie when avail is an exact multiple of the
        # half dash (the f64 oracle and f32 device must agree on the count)
        n0 = xp.minimum(xp.ceil(avail / (1.5 * wse) - 1e-4), 16384.0)
        n0 = xp.maximum(n0, 1.0)
        rem = n0 - xp.floor(n0 / 4.0) * 4.0
        n4 = xp.where(rem > 0.0, n0 + 4.0 - rem, n0)
        period_dash = xp.maximum(4.0 * avail / n4, eps)
        t_dash = along - base
        tm_dash = t_dash - xp.floor(t_dash / period_dash) * period_dash
        hd = 0.25 * period_dash
        dcov = xp.clip(0.5 + (hd - tm_dash) * aa_dev, 0.0, 1.0) + \
            xp.clip(0.5 + (tm_dash - 3.0 * hd) * aa_dev, 0.0, 1.0)
        dcov = xp.clip(dcov, 0.0, 1.0)
        dash_span = (along >= base) & (along < base + avail)
        # dotted: period = 2w, one dot of diameter w centered per period,
        # the row centered in the span; edge empty when avail < 1.5w
        das = 2.0 * wse
        cnt = xp.maximum(xp.floor(avail / das), 1.0)
        used = cnt * das
        doff = xp.floor((avail - used) * 0.5 + 0.5)
        dot_a0 = base + doff
        dot_a1 = xp.where(avail < das * 0.75, dot_a0, dot_a0 + used)
        t_dot = along - dot_a0
        tm_dot = t_dot - xp.floor(t_dot / das) * das
        across = (depth_s - 0.5) * w_side
        dot_d = xp.sqrt((tm_dot - 0.5 * das) ** 2 + across * across) - \
            0.5 * w_side
        dot_cov = xp.clip(0.5 - dot_d * (sx + sy) * 0.5, 0.0, 1.0)
        dot_span = (along >= dot_a0) & (along < dot_a1)
        # edge modulation by the owning side's style
        own_mod = xp.where(style == 3.0, xp.where(dot_span, dot_cov, 0.0),
                           xp.where(style == 4.0,
                                    xp.where(dash_span, dcov, 0.0), 1.0))
        # corner modulation by the corner's style (cstyle/czero per pixel)
        # zero-radius dashed corners draw NORMALLY (write_dashed_corner
        # returns Err on zero arc length → the plain base instance)
        corner_mod = xp.where(
            cstyle == 3.0, xp.where(czero, corner_dot, dot_cov),
            xp.where(cstyle == 4.0,
                     xp.where(czero_da, xp.ones(lx.shape, "float32"),
                              dcov),
                     1.0))
        mod = xp.where(cstyle > -0.5, corner_mod, own_mod)
        visible = xp.where((style == 0.0) | (style == 5.0), 0.0, 1.0)
        # restrict to the owner's band: inactive neighbours leave their ring
        # area empty (border-none.yaml / border-invisible.yaml) — depth_s
        # is radial inside corner zones, so a zero-width neighbour's corner
        # culls while a real rounded corner survives
        band = xp.clip((1.0 - depth_s) * scale + 0.5, 0.0, 1.0)
        band = xp.where(depth_s >= 1.0, 0.0,
                        xp.where(depth_s <= 0.999, 1.0, band))
        contrib = sc * (dbl * mod * visible * band)[None]
        color = xp.where((owner == side)[None], contrib, color)
    return color * (ring * xp.where(any_owner, 1.0, 0.0))[None]


def pattern_line_dec(xp, p, lx, ly, sx, sy):
    """Line decorations (cs_line_decoration.glsl, sizes from
    prim_store/line_dec.rs:216): dotted / dashed / wavy underline patterns
    evaluated analytically in the prim's local space (the reference bakes
    one period into a cached task and repeats it; same math, no task).

    Payload: [8:12] premult color  [12] style (LineStyle: 0 solid,
    1 dotted, 2 dashed, 3 wavy)  [13] axis (0 horizontal, 1 vertical)
    [14] wavy line thickness."""
    x0, y0, x1, y1 = p[0], p[1], p[2], p[3]
    axis_v = p[13] > 0.5
    par = xp.where(axis_v, ly - y0, lx - x0)
    perp = xp.where(axis_v, lx - x0, ly - y0)
    hh = xp.where(axis_v, x1 - x0, y1 - y0)
    aa = xp.sqrt(sx * sy)
    style = p[12]

    # dotted: circle of diameter h at the start of each 2h period
    # (shader vParams: center = (radius, size.y/2))
    diameter = xp.clip(hh, 1.0, 64.0)
    period_dot = 2.0 * diameter
    pxd = par - xp.floor(par / period_dot) * period_dot
    pyd = perp - xp.floor(perp / diameter) * diameter
    r = diameter * 0.5
    dd = xp.sqrt((pxd - r) ** 2 + (pyd - r) ** 2) - r
    a_dot = xp.clip(0.5 - dd * aa, 0.0, 1.0)

    # dashed: on for floor(x+0.5) <= dash_len of each 2*dash_len period
    dash_len = xp.clip(3.0 * hh, 1.0, 64.0)
    period_dash = 2.0 * dash_len
    pxs = par - xp.floor(par / period_dash) * period_dash
    a_dash = xp.where(xp.floor(pxs + 0.5) <= dash_len, 1.0, 0.0)

    # wavy: two 45° slopes + two flats per period (gecko's
    # PaintDecorationLine, copied by the shader)
    lt = xp.maximum(p[14], 1.0)
    half_lt = lt * 0.5
    slope = hh - lt
    flat = xp.maximum((lt - 1.0) * 2.0, 1.0)
    half_period = slope + flat
    mid = hh * 0.5
    m2 = par - xp.floor(par / (2.0 * half_period)) * (2.0 * half_period)
    flip = xp.where(m2 <= half_period, -1.0, 1.0)
    peak_h = mid + (mid - half_lt) * flip
    pxm = par - xp.floor(par / half_period) * half_period
    inv_s2 = 0.7071067811865476

    def d2l(p0x, p0y, dx_, dy_, inv_len):
        # dot(normalize(dir), p0 - p)  (shared.glsl distance_to_line)
        return (dx_ * (p0x - pxm) + dy_ * (p0y - perp)) * inv_len
    dist1 = d2l(0.0, peak_h, 1.0, -flip, inv_s2)
    dist2 = d2l(0.0, peak_h, 0.0, -flip, 1.0)
    dist3 = d2l(flat, peak_h, -1.0, -flip, inv_s2)
    dist = xp.abs(xp.maximum(xp.maximum(dist1, dist2), dist3))
    a_wavy = xp.clip(0.5 - (dist - half_lt) * aa, 0.0, 1.0)
    # MAGIC_WAVY_LINE_AA_SNAP: thin lines disable AA
    a_wavy = xp.where(half_lt <= 1.0,
                      xp.where(a_wavy > 0.5, 1.0, 0.0), a_wavy)

    alpha = xp.where(style < 0.5, 1.0,
                     xp.where(style < 1.5, a_dot,
                              xp.where(style < 2.5, a_dash, a_wavy)))
    return xp.stack([p[8] * alpha, p[9] * alpha, p[10] * alpha,
                     p[11] * alpha], 0)


def apply_color_matrix(xp, color, m20, flag):
    """Straight-alpha 4x5 color matrix on premultiplied input (SVG
    feColorMatrix semantics; `m20` is the flattened matrix payload).
    flag: 0 = passthrough, 1 = apply, 2 = apply in linearRGB (the
    _CONVERTSRGB variants of cs_svg_filter_node.glsl)."""
    a = color[3]
    safe = xp.where(a > 1e-6, a, 1.0)
    r, g, b = color[0] / safe, color[1] / safe, color[2] / safe
    lin = flag > 1.5
    r = xp.where(lin, blend_mod.srgb_to_linear(xp, r), r)
    g = xp.where(lin, blend_mod.srgb_to_linear(xp, g), g)
    b = xp.where(lin, blend_mod.srgb_to_linear(xp, b), b)
    nr = m20[0] * r + m20[1] * g + m20[2] * b + m20[3] * a + m20[4]
    ng = m20[5] * r + m20[6] * g + m20[7] * b + m20[8] * a + m20[9]
    nb = m20[10] * r + m20[11] * g + m20[12] * b + m20[13] * a + m20[14]
    na = m20[15] * r + m20[16] * g + m20[17] * b + m20[18] * a + m20[19]
    nr = xp.clip(nr, 0.0, 1.0)
    ng = xp.clip(ng, 0.0, 1.0)
    nb = xp.clip(nb, 0.0, 1.0)
    na = xp.clip(na, 0.0, 1.0)
    nr = xp.where(lin, blend_mod.linear_to_srgb(xp, nr), nr)
    ng = xp.where(lin, blend_mod.linear_to_srgb(xp, ng), ng)
    nb = xp.where(lin, blend_mod.linear_to_srgb(xp, nb), nb)
    out = xp.stack([nr * na, ng * na, nb * na, na], 0)
    return xp.where(flag > 0.5, out, color)


def pattern_picture(xp, p, lx, ly, px, py, surface_atlas, gl: bool = False):
    """Composite a rendered surface region (the `composite.glsl` /
    ps_split_composite role): device-space mapping (1:1 or scaled when the
    surface was rendered through a downscale chain), optional color matrix.
    p[37] > 0.5 = raster-root mode: the surface was rasterized in the
    instance's LOCAL space at scale p[40] with raster origin p[38:40]
    (picture.rs raster roots / MAX_SURFACE_SIZE) — sample at local coords.
    `gl` = llvmpipe bilinear (GL-pipeline reftest lines)."""
    w = xp.maximum(p[2] - p[0], 1e-6)
    h = xp.maximum(p[3] - p[1], 1e-6)
    su = (p[10] - p[8]) / w
    sv = (p[11] - p[9]) / h
    u = p[8] + (px - p[0]) * su
    v = p[9] + (py - p[1]) * sv
    u = xp.where(p[37] > 0.5, p[8] + lx * p[40] - p[38], u)
    v = xp.where(p[37] > 0.5, p[9] + ly * p[40] - p[39], v)
    # gl NOTE: llvmpipe-flavored sampling measured FARTHER from the CI
    # PNGs here too (filters r5 experiment: max_diff 3 -> 6) — the chain-
    # level mismatch is structural, not filter flavor.  Keep one sampler.
    del gl
    texel = sample_rgba(xp, surface_atlas, u, v, p[8], p[9], p[10], p[11], 0.0)
    mod = xp.stack([p[12], p[13], p[14], p[15]], 0)
    texel = texel * mod[:, None, None]
    return apply_color_matrix(xp, texel, p[16:36], p[36])


# ---------------------------------------------------------------------------
# clips

def clip_coverage(xp, rec, transforms, px, py, mask_plane, gather_row,
                  gl: bool = False):
    """Coverage multiplier of one clip record (frame/gpu.py layout).
    `gather_row(transforms, idx)` fetches a palette row (backend-specific);
    `mask_plane` is the color atlas's RED plane [H, W]: image masks render
    via ps_quad_textured into an R8 mask target, so the premultiplied red
    channel is the mask value (renderer/mod.rs:2336).
    The mask rect maps the image onto rec[0:4] (scaled)."""
    spatial = rec[13].astype("int32") if hasattr(rec, "dtype") else int(rec[13])
    trow = gather_row(transforms, spatial)
    lx, ly = inverse_map(xp, trow, px, py)
    sx, sy = trow[9], trow[10]
    kind = rec[14]
    rect_cov = rect_coverage_auto(xp, trow, rec[0], rec[1], rec[2], rec[3],
                                  lx, ly, px, py, 0xF)
    # rec[15] is the fast-path flag only for kind 1 (rounded); the
    # `rounded` branch is only selected for that kind, so passing it
    # unconditionally is safe
    rounded = rounded_rect_coverage_auto(xp, trow, rec[0:4], rec[4:12],
                                         lx, ly, px, py, fast_flag=rec[15])
    rw = xp.maximum(rec[2] - rec[0], 1e-6)
    rh = xp.maximum(rec[3] - rec[1], 1e-6)
    mask_u = rec[16] + (lx - rec[0]) / rw * (rec[18] - rec[16])
    mask_v = rec[17] + (ly - rec[1]) / rh * (rec[19] - rec[17])
    samp = sample_alpha_llvm if gl else sample_alpha
    masked = samp(xp, mask_plane, mask_u, mask_v,
                  rec[16], rec[17], rec[18], rec[19]) * rect_cov
    poly = polygon_coverage(xp, rec, px, py)
    bshadow = box_shadow_ninepatch_coverage(xp, rec, lx, ly, sx, sy,
                                            mask_plane, gl=gl)
    cov = xp.where(kind < 0.5, rect_cov,
                   xp.where(kind < 1.5, rounded,
                            xp.where(kind < 2.5, masked,
                                     xp.where(kind < 3.5, poly, bshadow))))
    return xp.where(rec[12] > 0.5, 1.0 - cov, cov)


def box_shadow_ninepatch_coverage(xp, rec, lx, ly, sx, sy, mask_plane,
                                  gl: bool = False):
    """Kind-4 clip: box-shadow nine-patch (cs_clip_box_shadow.glsl).
    rec layout: [0:4] dest rect, [4:6] original alloc size (local units),
    [6:8] stretch modes (1 = Stretch / 0 = Simple), [15] clip mode
    (0 outset / 1 inset), [16:20] cached blurred-mask uv rect (color-atlas
    red plane).  The mask fraction mapping follows the shader's
    vEdge/vUv math; the sample is swgl's fixed-point bilinear."""
    dw = xp.maximum(rec[2] - rec[0], 1e-6)
    dh = xp.maximum(rec[3] - rec[1], 1e-6)
    aw = xp.maximum(rec[4], 1e-6)
    ah = xp.maximum(rec[5], 1e-6)
    u_lin = xp.where(rec[6] > 0.5, (lx - rec[0]) / aw, (lx - rec[0]) / dw)
    v_lin = xp.where(rec[7] > 0.5, (ly - rec[1]) / ah, (ly - rec[1]) / dh)
    e0x = xp.where(rec[6] > 0.5, 0.5, 1.0)
    e1x = xp.where(rec[6] > 0.5, dw / aw - 0.5, 1.0)
    e0y = xp.where(rec[7] > 0.5, 0.5, 1.0)
    e1y = xp.where(rec[7] > 0.5, dh / ah - 0.5, 1.0)
    uu = xp.clip(u_lin, 0.0, e0x) + xp.maximum(0.0, u_lin - e1x)
    vv = xp.clip(v_lin, 0.0, e0y) + xp.maximum(0.0, v_lin - e1y)
    mu = rec[16] + uu * (rec[18] - rec[16])
    mv = rec[17] + vv * (rec[19] - rec[17])
    samp = sample_alpha_llvm if gl else sample_alpha
    texel = samp(xp, mask_plane, mu, mv,
                 rec[16], rec[17], rec[18], rec[19])
    in_rect = rect_coverage(xp, rec[0], rec[1], rec[2], rec[3],
                            lx, ly, sx, sy, 0xF)
    mode = rec[15]
    alpha = texel * (1.0 - mode) + (1.0 - texel) * mode
    return mode * (1.0 - in_rect) + alpha * in_rect


def polygon_coverage(xp, rec, px, py):
    """Kind-3 clip: device-space convex polygon (preserve-3d BSP fragments,
    the ps_split_composite role). Up to 8 inward half-planes at
    rec[24 + 3i] = (a, b, c), unit-normalized; unused edges padded with
    (0, 0, big). Coverage = min over edges of the AA'd signed distance."""
    cov = None
    for i in range(8):
        a, b, c = rec[24 + 3 * i], rec[25 + 3 * i], rec[26 + 3 * i]
        e = xp.clip(a * px + b * py + c + 0.5, 0.0, 1.0)
        cov = e if cov is None else xp.minimum(cov, e)
    return cov
