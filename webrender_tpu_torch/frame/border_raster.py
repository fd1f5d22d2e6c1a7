"""Reference-exact normal-border segment generation and rasterization.

Port of the reference's border pipeline re-designed for host precompute:

* `create_border_segments` — carve a CSS border into 4 corner + 4 edge
  segments with cache keys and draw (brush) segments
  (`webrender/src/border.rs:654` create_border_segments,
  `:1044` add_corner_segment, `:1181` add_edge_segment).
* `build_border_instances` — per cached task, the list of border
  instances incl. per-dot / per-dash clip params placed along the corner
  ellipse arc (`border.rs:1245` build_border_instances, `:307`
  write_dashed_corner_instances, `:393` write_dotted_corner_instances,
  `webrender/src/ellipse.rs` arc-length math).
* `raster_border_segment` — evaluates `cs_border_segment.glsl`'s
  fragment program exactly (corner transition color line, Taubin ellipse
  distance from `ellipse.glsl`, dot/dash clips, double/groove/ridge
  styles) into a premultiplied RGBA8 texel array.

The rendered tasks are cached by content key (render_task_cache.rs role)
and drawn as image segments, so every backend (Pallas / XLA / numpy
oracle / C++) samples identical texels.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

f32 = np.float32

# BorderSegment (cs_border_segment.glsl:48)
SEG_TL, SEG_TR, SEG_BR, SEG_BL = 0, 1, 2, 3
SEG_LEFT, SEG_TOP, SEG_RIGHT, SEG_BOTTOM = 4, 5, 6, 7

# BorderClipKind (border.rs:277)
CLIP_NONE = 0
CLIP_DASH_CORNER = 1
CLIP_DASH_EDGE = 2
CLIP_DOT = 3

STYLE_NONE = 0
STYLE_SOLID = 1
STYLE_DOUBLE = 2
STYLE_DOTTED = 3
STYLE_DASHED = 4
STYLE_HIDDEN = 5
STYLE_GROOVE = 6
STYLE_RIDGE = 7
STYLE_INSET = 8
STYLE_OUTSET = 9

MAX_DASH_COUNT = 2048
MAX_BORDER_RESOLUTION = 2048
STEP_COUNT = 20  # ellipse.rs:11
FRAC_PI_2 = math.pi / 2.0


def _is_hidden(style: int) -> bool:
    return style in (STYLE_NONE, STYLE_HIDDEN)


# ---------------------------------------------------------------------------
# ellipse.rs — Simpson arc length + angle search (f32 semantics)

def get_simpson_length(theta: float, rx: float, ry: float) -> float:
    df = f32(theta) / f32(STEP_COUNT)
    total = f32(0.0)
    for i in range(STEP_COUNT + 1):
        ang = f32(i) * df
        a = f32(rx) * f32(np.sin(ang))
        b = f32(ry) * f32(np.cos(ang))
        y = f32(np.sqrt(f32(a * a + b * b)))
        if i == 0 or i == STEP_COUNT:
            q = f32(1.0)
        elif i % 2 == 0:
            q = f32(2.0)
        else:
            q = f32(4.0)
        total = f32(total + f32(q * y))
    return float(f32(f32(df / f32(3.0)) * total))


class Ellipse:
    """ellipse.rs Ellipse (first-quadrant arc parametrization)."""

    def __init__(self, rx: float, ry: float):
        self.rx = rx
        self.ry = ry
        self.total_arc_length = get_simpson_length(FRAC_PI_2, rx, ry)

    def find_angle_for_arc_length(self, arc_length: float) -> float:
        arc_length = max(0.0, min(arc_length, self.total_arc_length))
        epsilon = 0.01
        low = 0.0
        high = FRAC_PI_2
        theta = 0.0
        new_low, new_high = 0.0, FRAC_PI_2
        while low <= high:
            theta = 0.5 * (low + high)
            length = get_simpson_length(theta, self.rx, self.ry)
            if abs(length - arc_length) < epsilon:
                break
            elif length < arc_length:
                new_low = theta
            else:
                new_high = theta
            if new_low == low and new_high == high:
                break
            high = new_high
            low = new_low
        return theta

    def get_point_and_tangent(self, theta: float):
        s, c = math.sin(theta), math.cos(theta)
        return (self.rx * c, self.ry * s), (-self.rx * s, self.ry * c)


# ---------------------------------------------------------------------------
# border.rs layout helpers

def compute_half_dash(side_width: float,
                      total_size: float) -> Tuple[float, int]:
    """border.rs:589 — half-dash length and count (padded to %4)."""
    half_dash = side_width * 1.5
    n = min(math.ceil(total_size / half_dash), 16 * 1024)
    if n == 0:
        return 0.0, 0
    if n % 4 != 0:
        n = n + 4 - n % 4
    return total_size / n, n


def get_edge_info(style: int, side_width: float,
                  avail_size: float) -> Tuple[float, float, float]:
    """border.rs:615 — (local_offset, local_size, stretch_size)."""
    if side_width <= 0.0 or avail_size <= 0.0:
        return (0.0, 0.0, 0.0)
    if style == STYLE_DASHED:
        half_dash, _ = compute_half_dash(side_width, avail_size)
        return (0.0, avail_size, 2.0 * 2.0 * half_dash)
    if style == STYLE_DOTTED:
        dot_and_space = 2.0 * side_width
        if avail_size < dot_and_space * 0.75:
            return (0.0, 0.0, 0.0)
        dot_count = max(math.floor(avail_size / dot_and_space), 1.0)
        used = dot_count * dot_and_space
        offset = round((avail_size - used) * 0.5)
        return (offset, used, dot_and_space)
    return (0.0, avail_size, 8.0)


def _au(v: float) -> int:
    """Au quantization (60 units per px) for cache keys."""
    return int(round(v * 60.0))


def ensure_no_corner_overlap(radii: List[float], w: float,
                             h: float) -> List[float]:
    """border.rs:168 — [tl.w,tl.h,tr.w,tr.h,br.w,br.h,bl.w,bl.h]."""
    ratio = 1.0
    if w > 0.0:
        for s in (radii[0] + radii[2], radii[6] + radii[4]):
            if w < s:
                ratio = min(ratio, w / s)
    if h > 0.0:
        for s in (radii[1] + radii[7], radii[3] + radii[5]):
            if h < s:
                ratio = min(ratio, h / s)
    if ratio < 1.0:
        return [v * ratio for v in radii]
    return list(radii)


def border_color(color, style: int, is_inner_border: bool):
    """border.rs:247 BorderSideHelpers::border_color → (r,g,b,a) straight."""
    r, g, b, a = color
    if style == STYLE_INSET:
        lighter = is_inner_border
    elif style == STYLE_OUTSET:
        lighter = not is_inner_border
    else:
        return (r, g, b, a)
    if r != 0.0 or g != 0.0 or b != 0.0:
        s = 1.0 if lighter else 2.0 / 3.0
        return (r * s, g * s, b * s, a)
    black = 0.7 if lighter else 0.3
    return (black, black, black, a)


def _premult(c):
    return (c[0] * c[3], c[1] * c[3], c[2] * c[3], c[3])


def get_colors_for_side(pcolor, style: int):
    """cs_border_segment.glsl get_colors_for_side (on premultiplied)."""
    def mod_color(c, lighter):
        if c[0] == 0.0 and c[1] == 0.0 and c[2] == 0.0:
            v = 0.7 if lighter else 0.3
            return (v, v, v, c[3])
        s = 1.0 if lighter else 2.0 / 3.0
        return (c[0] * s, c[1] * s, c[2] * s, c[3])
    if style == STYLE_GROOVE:
        return (mod_color(pcolor, True), mod_color(pcolor, False))
    if style == STYLE_RIDGE:
        return (mod_color(pcolor, False), mod_color(pcolor, True))
    return (pcolor, pcolor)


# ---------------------------------------------------------------------------
# segment creation (border.rs create_border_segments:654)

def create_border_segments(size: Tuple[float, float], border: Dict,
                           widths: Tuple[float, float, float, float],
                           do_aa: bool = True):
    """border: dict with 'top'/'right'/'bottom'/'left' = (style, color
    straight rgba) and 'radius' = 8 floats (already overlap-clamped).
    widths = (top, right, bottom, left).  Returns (brush_segments,
    border_segments): brush segments are draw records; border segments
    carry the cache key + local task size."""
    W, H = size
    wt, wr, wb, wl = widths
    rad = border["radius"]
    brush: List[Dict] = []
    segs: List[Dict] = []

    overlap_w = max(wl + wr - W, 0.0)
    overlap_h = max(wt + wb - H, 0.0)
    now_t = wt - overlap_h / 2.0
    now_r = wr - overlap_w / 2.0
    now_b = wb - overlap_h / 2.0
    now_l = wl - overlap_w / 2.0

    local_tl = (max(rad[0], wl), max(rad[1], wt))
    local_tr = (max(rad[2], wr), max(rad[3], wt))
    local_br = (max(rad[4], wr), max(rad[5], wb))
    local_bl = (max(rad[6], wl), max(rad[7], wb))

    top_edge = get_edge_info(border["top"][0], wt,
                             W - local_tl[0] - local_tr[0])
    bottom_edge = get_edge_info(border["bottom"][0], wb,
                                W - local_bl[0] - local_br[0])
    left_edge = get_edge_info(border["left"][0], wl,
                              H - local_tl[1] - local_bl[1])
    right_edge = get_edge_info(border["right"][0], wr,
                               H - local_tr[1] - local_br[1])

    def add_edge(rect, edge_info, side, width, segment):
        style, color = side
        if color[3] <= 0.0 or _is_hidden(style):
            return
        if segment in (SEG_LEFT, SEG_RIGHT):
            task_size = (width, edge_info[2])
            repeat = "y"
        else:
            task_size = (edge_info[2], width)
            repeat = "x"
        if rect[2] - rect[0] <= 0.0 or rect[3] - rect[1] <= 0.0:
            return
        brush.append({"rect": rect, "repeat": repeat,
                      "task_index": len(segs)})
        segs.append({
            "local_task_size": task_size,
            "segment": segment,
            "key": ("edge", segment, do_aa, side_key(side), side_key(side),
                    _au(task_size[0]), _au(task_size[1])),
        })

    def side_key(side):
        style, c = side
        return (style, round(c[0] * 255), round(c[1] * 255),
                round(c[2] * 255), round(c[3] * 255))

    add_edge((0.0, local_tl[1] + left_edge[0], now_l,
              local_tl[1] + left_edge[0] + left_edge[1]),
             left_edge, border["left"], now_l, SEG_LEFT)
    add_edge((local_tl[0] + top_edge[0], 0.0,
              local_tl[0] + top_edge[0] + top_edge[1], now_t),
             top_edge, border["top"], now_t, SEG_TOP)
    add_edge((W - now_r, local_tr[1] + right_edge[0], W,
              local_tr[1] + right_edge[0] + right_edge[1]),
             right_edge, border["right"], now_r, SEG_RIGHT)
    add_edge((local_bl[0] + bottom_edge[0], H - now_b,
              local_bl[0] + bottom_edge[0] + bottom_edge[1], H),
             bottom_edge, border["bottom"], now_b, SEG_BOTTOM)

    def add_corner(image_rect, non_overlap, side0, side1, cw, ch, crx, cry,
                   segment, h_outer, h_rad, v_outer, v_rad):
        if side0[1][3] <= 0.0 and side1[1][3] <= 0.0:
            return
        if cw <= 0.0 and ch <= 0.0:
            return
        if _is_hidden(side0[0]) and _is_hidden(side1[0]):
            return
        ix0 = max(image_rect[0], non_overlap[0])
        iy0 = max(image_rect[1], non_overlap[1])
        ix1 = min(image_rect[2], non_overlap[2])
        iy1 = min(image_rect[3], non_overlap[3])
        if ix1 <= ix0 or iy1 <= iy0:
            return
        iw = image_rect[2] - image_rect[0]
        ih = image_rect[3] - image_rect[1]
        if iw <= 0.0 or ih <= 0.0:
            return
        texel = ((ix0 - image_rect[0]) / iw, (iy0 - image_rect[1]) / ih,
                 (ix1 - image_rect[0]) / iw, (iy1 - image_rect[1]) / ih)
        # de-correlate non-overlapping adjacent corners (border.rs:1097)
        if segment == SEG_TL:
            if not (h_outer[0] - h_rad[0] < image_rect[2]):
                h_outer, h_rad = (image_rect[2], image_rect[1]), (0.0, 0.0)
            if not (v_outer[1] - v_rad[1] < image_rect[3]):
                v_outer, v_rad = (image_rect[0], image_rect[3]), (0.0, 0.0)
        elif segment == SEG_TR:
            if not (h_outer[0] + h_rad[0] > image_rect[0]):
                h_outer, h_rad = (image_rect[0], image_rect[1]), (0.0, 0.0)
            if not (v_outer[1] - v_rad[1] < image_rect[3]):
                v_outer, v_rad = (image_rect[2], image_rect[3]), (0.0, 0.0)
        elif segment == SEG_BR:
            if not (h_outer[0] + h_rad[0] > image_rect[0]):
                h_outer, h_rad = (image_rect[0], image_rect[3]), (0.0, 0.0)
            if not (v_outer[1] + v_rad[1] > image_rect[1]):
                v_outer, v_rad = (image_rect[2], image_rect[1]), (0.0, 0.0)
        elif segment == SEG_BL:
            if not (h_outer[0] - h_rad[0] < image_rect[2]):
                h_outer, h_rad = (image_rect[2], image_rect[3]), (0.0, 0.0)
            if not (v_outer[1] + v_rad[1] > image_rect[1]):
                v_outer, v_rad = (image_rect[0], image_rect[1]), (0.0, 0.0)
        brush.append({"rect": (ix0, iy0, ix1, iy1), "repeat": None,
                      "texel": texel, "task_index": len(segs)})
        segs.append({
            "local_task_size": (iw, ih),
            "segment": segment,
            "key": ("corner", segment, do_aa, side_key(side0),
                    side_key(side1), _au(crx), _au(cry), _au(cw), _au(ch),
                    _au(h_outer[0] - image_rect[0]),
                    _au(h_outer[1] - image_rect[1]),
                    _au(h_rad[0]), _au(h_rad[1]),
                    _au(v_outer[0] - image_rect[0]),
                    _au(v_outer[1] - image_rect[1]),
                    _au(v_rad[0]), _au(v_rad[1])),
            "widths": (cw, ch),
            "radius": (crx, cry),
            "h_outer_rel": (h_outer[0] - image_rect[0],
                            h_outer[1] - image_rect[1]),
            "h_rad": h_rad,
            "v_outer_rel": (v_outer[0] - image_rect[0],
                            v_outer[1] - image_rect[1]),
            "v_rad": v_rad,
        })

    add_corner((0.0, 0.0, local_tl[0], local_tl[1]),
               (0.0, 0.0, W - now_r, H - now_b),
               border["left"], border["top"], wl, wt, rad[0], rad[1],
               SEG_TL, (W, 0.0), (rad[2], rad[3]), (0.0, H),
               (rad[6], rad[7]))
    add_corner((W - local_tr[0], 0.0, W, local_tr[1]),
               (now_l, 0.0, W, H - now_b),
               border["top"], border["right"], wr, wt, rad[2], rad[3],
               SEG_TR, (0.0, 0.0), (rad[0], rad[1]), (W, H),
               (rad[4], rad[5]))
    add_corner((W - local_br[0], H - local_br[1], W, H),
               (now_l, now_t, W, H),
               border["right"], border["bottom"], wr, wb, rad[4], rad[5],
               SEG_BR, (0.0, H), (rad[6], rad[7]), (W, 0.0),
               (rad[2], rad[3]))
    add_corner((0.0, H - local_bl[1], local_bl[0], H),
               (0.0, now_t, W - now_r, H),
               border["bottom"], border["left"], wl, wb, rad[6], rad[7],
               SEG_BL, (W, H), (rad[4], rad[5]), (0.0, 0.0),
               (rad[0], rad[1]))

    return brush, segs


# ---------------------------------------------------------------------------
# instance generation (border.rs build_border_instances:1245)

def _write_dashed_corner(radius, widths, segment, base, instances) -> bool:
    rx, ry = radius
    ell = Ellipse(rx, ry)
    avg_w = 0.5 * (widths[0] + widths[1])
    half_dash, n = compute_half_dash(avg_w, ell.total_arc_length)
    if n == 0:
        return False
    n = min(n, MAX_DASH_COUNT)
    outer, clip_sign = _outer_and_clip_sign(segment, radius)
    instance_count = n // 4 + 1
    half_arc = ell.total_arc_length / n
    dash_len = 2.0 * half_arc
    cur = 0.0
    for i in range(instance_count):
        a0 = cur
        cur += half_arc if i == 0 else dash_len
        a1 = cur
        cur += dash_len
        alpha = ell.find_angle_for_arc_length(a0)
        beta = ell.find_angle_for_arc_length(a1)
        (p0x, p0y), (t0x, t0y) = ell.get_point_and_tangent(alpha)
        (p1x, p1y), (t1x, t1y) = ell.get_point_and_tangent(beta)
        p0 = (outer[0] + clip_sign[0] * (rx - p0x),
              outer[1] + clip_sign[1] * (ry - p0y))
        t0 = (-t0x * clip_sign[0], -t0y * clip_sign[1])
        p1 = (outer[0] + clip_sign[0] * (rx - p1x),
              outer[1] + clip_sign[1] * (ry - p1y))
        t1 = (-t1x * clip_sign[0], -t1y * clip_sign[1])
        inst = dict(base)
        inst["clip_mode"] = CLIP_DASH_CORNER
        inst["clip_params"] = [p0[0], p0[1], t0[0], t0[1],
                               p1[0], p1[1], t1[0], t1[1]]
        instances.append(inst)
    return True


def _write_dotted_corner(radius, widths, segment, base, instances) -> bool:
    rx, ry = radius
    if rx < widths[0] / 2.0:
        rx = 0.0
    if ry < widths[1] / 2.0:
        ry = 0.0
    if rx == 0.0 and ry == 0.0:
        ell = Ellipse(rx, ry)
        max_dot_count = 1
    else:
        inner = (abs(rx - widths[0] * 0.5), abs(ry - widths[1] * 0.5))
        ell = Ellipse(inner[0], inner[1])
        min_d = min(widths[0], widths[1])
        max_dot_count = math.ceil(0.5 * ell.total_arc_length / min_d)
    if max_dot_count == 0:
        return False
    if max_dot_count == 1:
        dd = widths[0] + (widths[1] - widths[0]) * 0.5
        inst = dict(base)
        inst["clip_mode"] = CLIP_DOT
        inst["clip_params"] = [widths[0] / 2.0, widths[1] / 2.0,
                               0.5 * dd, 0, 0, 0, 0, 0]
        instances.append(inst)
        return True
    max_dot_count = min(max_dot_count, MAX_DASH_COUNT)
    forward = [(widths[0], widths[0])]            # (arc_pos, diameter)
    back = [(ell.total_arc_length - widths[1], widths[1])]
    leftover = 0.0
    outer, clip_sign = _outer_and_clip_sign(segment, (rx, ry))
    for dot_index in range(max_dot_count):
        pf = forward[-1]
        pb = back[-1]
        going_forward = (dot_index & 1) == 0
        if going_forward:
            next_pos = pf[0] + 2.0 * pf[1]
            lo = pb[0] - next_pos
        else:
            next_pos = pb[0] - 2.0 * pb[1]
            lo = next_pos - pf[0]
        t = next_pos / ell.total_arc_length
        dd = widths[0] + (widths[1] - widths[0]) * t
        if lo < dd:
            leftover = lo
            break
        if going_forward:
            forward.append((next_pos, dd))
        else:
            back.append((next_pos, dd))
    n_dots = len(forward) + len(back)
    extra = leftover / (n_dots - 1)

    def dot_data(arc_length, dot_radius):
        theta = ell.find_angle_for_arc_length(arc_length)
        (cx, cy), _ = ell.get_point_and_tangent(theta)
        center = (outer[0] + clip_sign[0] * (rx - cx),
                  outer[1] + clip_sign[1] * (ry - cy))
        return [center[0], center[1], dot_radius, 0, 0, 0, 0, 0]

    for i, (pos, dd) in enumerate(forward):
        inst = dict(base)
        inst["clip_mode"] = CLIP_DOT
        inst["clip_params"] = dot_data(pos + i * extra, 0.5 * dd)
        instances.append(inst)
    for i, (pos, dd) in enumerate(back):
        inst = dict(base)
        inst["clip_mode"] = CLIP_DOT
        inst["clip_params"] = dot_data(pos - i * extra, 0.5 * dd)
        instances.append(inst)
    return True


def _outer_and_clip_sign(segment, radius):
    scale = {SEG_TL: (0.0, 0.0), SEG_TR: (1.0, 0.0),
             SEG_BR: (1.0, 1.0), SEG_BL: (0.0, 1.0)}[segment]
    outer = (scale[0] * radius[0], scale[1] * radius[1])
    clip_sign = (1.0 - 2.0 * scale[0], 1.0 - 2.0 * scale[1])
    return outer, clip_sign


def build_border_instances(seg: Dict, cache_size: Tuple[int, int],
                           border: Dict, scale: float) -> List[Dict]:
    """border.rs:1245 — instances for one cached segment task."""
    segment = seg["segment"]
    side_of = {SEG_LEFT: ("left", "left", False, False),
               SEG_TOP: ("top", "top", False, False),
               SEG_RIGHT: ("right", "right", True, True),
               SEG_BOTTOM: ("bottom", "bottom", True, True),
               SEG_TL: ("left", "top", False, False),
               SEG_TR: ("top", "right", False, True),
               SEG_BR: ("right", "bottom", True, True),
               SEG_BL: ("bottom", "left", True, False)}[segment]
    s0 = border[side_of[0]]
    s1 = border[side_of[1]]
    style0 = s1[0] if _is_hidden(s0[0]) else s0[0]
    style1 = s0[0] if _is_hidden(s1[0]) else s1[0]
    color0 = _premult(border_color(s0[1], s0[0], side_of[2]))
    color1 = _premult(border_color(s1[1], s1[0], side_of[3]))
    if segment in (SEG_TL, SEG_TR, SEG_BR, SEG_BL):
        widths = (math.ceil(seg["widths"][0] * scale),
                  math.ceil(seg["widths"][1] * scale))
        radius = (math.ceil(seg["radius"][0] * scale),
                  math.ceil(seg["radius"][1] * scale))
        h_outer = (round(seg["h_outer_rel"][0] * scale),
                   round(seg["h_outer_rel"][1] * scale))
        v_outer = (round(seg["v_outer_rel"][0] * scale),
                   round(seg["v_outer_rel"][1] * scale))
    else:
        widths = (math.ceil(seg["local_task_size"][0] * scale),
                  math.ceil(seg["local_task_size"][1] * scale))
        radius = (0.0, 0.0)
        h_outer = v_outer = (0.0, 0.0)
    w, h = cache_size
    do_aa = bool(seg["key"][2])
    base = {"rect": (0.0, 0.0, float(w), float(h)),
            "segment": segment, "style0": style0, "style1": style1,
            "color0": color0, "color1": color1,
            "widths": widths, "radius": radius, "do_aa": do_aa,
            "clip_mode": CLIP_NONE, "clip_params": [0.0] * 8}
    instances: List[Dict] = []
    if segment in (SEG_TL, SEG_TR, SEG_BR, SEG_BL):
        h_rad = (math.ceil(seg["h_rad"][0] * scale),
                 math.ceil(seg["h_rad"][1] * scale))
        v_rad = (math.ceil(seg["v_rad"][0] * scale),
                 math.ceil(seg["v_rad"][1] * scale))
        done = False
        if style0 == STYLE_DASHED:
            done = _write_dashed_corner(radius, widths, segment, base,
                                        instances)
        elif style0 == STYLE_DOTTED:
            done = _write_dotted_corner(radius, widths, segment, base,
                                        instances)
        if not done:
            inst = dict(base)
            # adjacent-corner clip ellipses (border.rs add_segment:986,
            # consumed by cs_border_solid)
            inst["clip_params"] = [h_outer[0], h_outer[1],
                                   h_rad[0], h_rad[1],
                                   v_outer[0], v_outer[1],
                                   v_rad[0], v_rad[1]]
            instances.append(inst)
    else:
        is_vertical = segment in (SEG_LEFT, SEG_RIGHT)
        if style0 == STYLE_DASHED:
            if is_vertical:
                x, y = 0.0, h * 0.25
            else:
                x, y = w * 0.25, 0.0
            inst = dict(base)
            inst["clip_mode"] = CLIP_DASH_EDGE
            inst["clip_params"] = [x, y, 0, 0, 0, 0, 0, 0]
            instances.append(inst)
        elif style0 == STYLE_DOTTED:
            if is_vertical:
                x, y, r = widths[0] * 0.5, widths[0], widths[0] * 0.5
            else:
                x, y, r = widths[1], widths[1] * 0.5, widths[1] * 0.5
            inst = dict(base)
            inst["clip_mode"] = CLIP_DOT
            inst["clip_params"] = [x, y, r, 0, 0, 0, 0, 0]
            instances.append(inst)
        else:
            instances.append(base)
    return instances


# ---------------------------------------------------------------------------
# fragment evaluation (cs_border_segment.glsl main, f32 semantics)

def _distance_to_ellipse(px, py, rx, ry):
    """ellipse.glsl distance_to_ellipse_approx (Taubin first order)."""
    scale = np.where((rx > 0.0) & (ry > 0.0), f32(1.0), f32(0.0))
    inv_rx = f32(1.0) / np.maximum(f32(rx * rx), f32(1.0e-6))
    inv_ry = f32(1.0) / np.maximum(f32(ry * ry), f32(1.0e-6))
    prx = px * inv_rx
    pry = py * inv_ry
    g = px * prx + py * pry - scale
    dgx = (f32(1.0) + scale) * prx
    dgy = (f32(1.0) + scale) * pry
    return g / np.sqrt(np.maximum(dgx * dgx + dgy * dgy, f32(1e-30)))


def _distance_aa(d):
    return np.clip(f32(0.5) - d, f32(0.0), f32(1.0))


def _distance_to_line(p0x, p0y, dirx, diry, px, py):
    ln = np.float32(math.sqrt(dirx * dirx + diry * diry) or 1.0)
    nx, ny = f32(dirx / ln), f32(diry / ln)
    return nx * (f32(p0x) - px) + ny * (f32(p0y) - py)


def _pack_u8(frag):
    """swgl's unorm8 pack (glsl.h:715 roundeven via _mm_cvtps_epi32):
    round-half-even of the f32 product."""
    x = np.clip(frag, 0.0, 1.0).astype(f32) * f32(255.0)
    return np.rint(x).astype(np.float64)


def raster_border_segment(instances: List[Dict], w: int,
                          h: int) -> np.ndarray:
    """Render border instances into a premultiplied RGBA texel array
    (h, w, 4) float32 in [0,1] — the cached color task's content."""
    task8 = np.zeros((h, w, 4), np.float64)  # u8-domain accumulation
    ys, xs = np.mgrid[0:h, 0:w]
    PX = (xs + 0.5).astype(f32)
    PY = (ys + 0.5).astype(f32)
    for inst in instances:
        seg = inst["segment"]
        x0, y0, x1, y1 = inst["rect"]
        size = (f32(x1 - x0), f32(y1 - y0))
        aw = (f32(inst["widths"][0]), f32(inst["widths"][1]))
        ar = (f32(inst["radius"][0]), f32(inst["radius"][1]))
        cp1 = inst["clip_params"][0:4]
        cp2 = inst["clip_params"][4:8]
        clip_mode = inst["clip_mode"]
        outer_scale = {SEG_TL: (0.0, 0.0), SEG_TR: (1.0, 0.0),
                       SEG_BR: (1.0, 1.0), SEG_BL: (0.0, 1.0)}.get(
                           seg, (0.0, 0.0))
        outer = (f32(outer_scale[0] * size[0]),
                 f32(outer_scale[1] * size[1]))
        clip_sign = (f32(1.0 - 2.0 * outer_scale[0]),
                     f32(1.0 - 2.0 * outer_scale[1]))
        if seg == SEG_TL:
            edge_axis = (0, 1)
            edge_ref = outer
        elif seg == SEG_TR:
            edge_axis = (1, 0)
            edge_ref = (f32(outer[0] - aw[0]), outer[1])
        elif seg == SEG_BR:
            edge_axis = (0, 1)
            edge_ref = (f32(outer[0] - aw[0]), f32(outer[1] - aw[1]))
        elif seg == SEG_BL:
            edge_axis = (1, 0)
            edge_ref = (outer[0], f32(outer[1] - aw[1]))
        elif seg in (SEG_TOP, SEG_BOTTOM):
            edge_axis = (1, 1)
            edge_ref = (f32(0.0), f32(0.0))
        else:
            edge_axis = (0, 0)
            edge_ref = (f32(0.0), f32(0.0))
        pw13 = (f32(aw[0] / 3.0), f32(aw[1] / 3.0))
        pw12 = (f32(aw[0] / 2.0), f32(aw[1] / 2.0))
        clip_center = (f32(outer[0] + clip_sign[0] * ar[0]),
                       f32(outer[1] + clip_sign[1] * ar[1]))
        clip_radii = (ar[0], ar[1],
                      max(f32(ar[0] - aw[0]), f32(0.0)),
                      max(f32(ar[1] - aw[1]), f32(0.0)))
        color_line = (outer[0], outer[1],
                      f32(aw[1] * -clip_sign[1]), f32(aw[0] * clip_sign[0]))
        c00, c01 = get_colors_for_side(inst["color0"], inst["style0"])
        c10, c11 = get_colors_for_side(inst["color1"], inst["style1"])

        # rasterized quad region (vertex-shader vPos clamping for dots
        # and corner dashes)
        if clip_mode == CLIP_DOT:
            r = cp1[2]
            if r > 0.5:
                r += 2.0
            bx0 = min(max(cp1[0] - r, 0.0), float(size[0]))
            by0 = min(max(cp1[1] - r, 0.0), float(size[1]))
            bx1 = min(max(cp1[0] + r, 0.0), float(size[0]))
            by1 = min(max(cp1[1] + r, 0.0), float(size[1]))
        elif clip_mode == CLIP_DASH_CORNER:
            cx = (cp1[0] + cp2[0]) * 0.5
            cy = (cp1[1] + cp2[1]) * 0.5
            dl = math.hypot(cp1[0] - cp2[0], cp1[1] - cp2[1])
            wm = max(aw[0], aw[1])
            r = max(dl, wm) + 2.0
            bx0 = min(max(0.0, cx - r), float(size[0]))
            by0 = min(max(0.0, cy - r), float(size[1]))
            bx1 = min(max(0.0, cx + r), float(size[0]))
            by1 = min(max(0.0, cy + r), float(size[1]))
        else:
            bx0, by0, bx1, by1 = 0.0, 0.0, float(size[0]), float(size[1])
        # GL coverage: pixel centers strictly inside, top-left rule on ties
        ix0 = max(int(math.floor(bx0 + 0.5 - 1e-6)), 0)
        iy0 = max(int(math.floor(by0 + 0.5 - 1e-6)), 0)
        ix1 = min(int(math.ceil(bx1 - 0.5)), w)
        iy1 = min(int(math.ceil(by1 - 0.5)), h)
        if ix1 <= ix0 or iy1 <= iy0:
            continue
        px = PX[iy0:iy1, ix0:ix1]
        py = PY[iy0:iy1, ix0:ix1]

        # mix factor along the corner color transition line
        if edge_axis[0] != edge_axis[1]:
            d_line = _distance_to_line(color_line[0], color_line[1],
                                       color_line[2], color_line[3], px, py)
            mix_factor = _distance_aa(-d_line)
        else:
            mix_factor = np.zeros_like(px)

        relx = px - clip_center[0]
        rely = py - clip_center[1]
        in_clip = (clip_sign[0] * relx < 0.0) & (clip_sign[1] * rely < 0.0)

        d = np.full_like(px, f32(-1.0))
        if clip_mode == CLIP_DOT:
            d = np.sqrt((px - f32(cp1[0])) ** 2 +
                        (py - f32(cp1[1])) ** 2) - f32(cp1[2])
        elif clip_mode == CLIP_DASH_EDGE:
            is_vertical = cp1[0] == 0.0
            half_dash = f32(cp1[1] if is_vertical else cp1[0])
            pos = py if is_vertical else px
            # Varying interpolation along Y lands a hair below the exact
            # value when a pixel center sits on a dash boundary (reference
            # PNGs: a 10px vertical edge with half_dash=2.5 splits 3/5/2,
            # not 2/6/2, while horizontal edges compare exact) — bias the
            # comparison on vertical edges only to match.
            eps = f32(0.0)
            in_dash = (pos < half_dash + eps) | (pos > 3.0 * half_dash + eps)
            d = np.where(in_dash, d, f32(1.0))
        elif clip_mode == CLIP_DASH_CORNER:
            d0 = _distance_to_line(cp1[0], cp1[1], cp1[2], cp1[3], px, py)
            d1 = _distance_to_line(cp2[0], cp2[1], cp2[2], cp2[3], px, py)
            d = np.maximum(d0, -d1)

        d_radii_a = _distance_to_ellipse(relx, rely, clip_radii[0],
                                         clip_radii[1])
        d_radii_b = _distance_to_ellipse(relx, rely, clip_radii[2],
                                         clip_radii[3])
        d = np.where(in_clip,
                     np.maximum(d, np.maximum(d_radii_a, -d_radii_b)), d)

        # solid-on-both-sides instances route to cs_border_solid.glsl
        # (render_target.rs:38,809 STYLE_MASK partition): corner mix honors
        # do_aa (MIX_AA / MIX_NO_AA), clip_params carry the adjacent-corner
        # clip ellipses, and no-AA skips the coverage ramp entirely.
        if (inst["style0"] == STYLE_SOLID and inst["style1"] == STYLE_SOLID
                and clip_mode == CLIP_NONE):
            is_corner = seg in (SEG_TL, SEG_TR, SEG_BR, SEG_BL)
            do_aa_i = inst.get("do_aa", True)
            if is_corner:
                d_line = _distance_to_line(color_line[0], color_line[1],
                                           color_line[2], color_line[3],
                                           px, py)
                if do_aa_i:
                    mix_factor = _distance_aa(-d_line)
                else:
                    mix_factor = np.where(d_line + f32(1.0e-4) >= 0.0,
                                          f32(1.0), f32(0.0))
            else:
                mix_factor = np.zeros_like(px)
            # horizontally-adjacent corner clip
            h_sign = (f32(-clip_sign[0]), clip_sign[1])
            hcx = f32(cp1[0] + h_sign[0] * cp1[2])
            hcy = f32(cp1[1] + h_sign[1] * cp1[3])
            hrelx, hrely = px - hcx, py - hcy
            in_h = (h_sign[0] * hrelx < 0.0) & (h_sign[1] * hrely < 0.0)
            d = np.where(in_h, np.maximum(
                _distance_to_ellipse(hrelx, hrely, f32(cp1[2]),
                                     f32(cp1[3])), d), d)
            # vertically-adjacent corner clip
            v_sign = (clip_sign[0], f32(-clip_sign[1]))
            vcx = f32(cp2[0] + v_sign[0] * cp2[2])
            vcy = f32(cp2[1] + v_sign[1] * cp2[3])
            vrelx, vrely = px - vcx, py - vcy
            in_v = (v_sign[0] * vrelx < 0.0) & (v_sign[1] * vrely < 0.0)
            d = np.where(in_v, np.maximum(
                _distance_to_ellipse(vrelx, vrely, f32(cp2[2]),
                                     f32(cp2[3])), d), d)
            alpha = _distance_aa(d) if do_aa_i else np.ones_like(px)
            c0v = np.asarray(inst["color0"], f32).reshape(4, 1, 1)
            c1v = np.asarray(inst["color1"], f32).reshape(4, 1, 1)
            color = c0v + (c1v - c0v) * mix_factor[None]
            frag = color * alpha[None]
            src8 = _pack_u8(frag)
            dst8 = task8[iy0:iy1, ix0:ix1].transpose(2, 0, 1)
            sa = src8[3]
            out8 = src8 + dst8 - np.floor((dst8 * sa + dst8) / 256.0)
            task8[iy0:iy1, ix0:ix1] = np.clip(out8, 0,
                                              255).transpose(1, 2, 0)
            continue

        def corner_eval(style, ca, cb):
            ca_v = np.broadcast_to(np.asarray(ca, f32).reshape(4, 1, 1),
                                   (4,) + px.shape).astype(f32)
            if style == STYLE_DOUBLE:
                da = _distance_to_ellipse(relx, rely,
                                          f32(clip_radii[0] - pw13[0]),
                                          f32(clip_radii[1] - pw13[1]))
                db = _distance_to_ellipse(
                    relx, rely, f32(clip_radii[0] - 2.0 * pw13[0]),
                    f32(clip_radii[1] - 2.0 * pw13[1]))
                dd = np.minimum(-da, db)
                return ca_v * _distance_aa(dd)[None]
            if style in (STYLE_GROOVE, STYLE_RIDGE):
                dg = _distance_to_ellipse(relx, rely,
                                          f32(clip_radii[0] - pw12[0]),
                                          f32(clip_radii[1] - pw12[1]))
                alpha = _distance_aa(dg)
                swz = {SEG_TL: np.zeros_like(px),
                       SEG_TR: mix_factor,
                       SEG_BR: np.ones_like(px),
                       SEG_BL: 1.0 - mix_factor}.get(
                           seg, np.zeros_like(px))
                cb_v = np.broadcast_to(np.asarray(cb, f32).reshape(4, 1, 1),
                                       (4,) + px.shape).astype(f32)
                c0 = cb_v + (ca_v - cb_v) * swz[None]
                c1 = ca_v + (cb_v - ca_v) * swz[None]
                return c0 + (c1 - c0) * alpha[None]
            return ca_v

        def edge_eval(style, ca, cb, axis_id):
            ca_v = np.broadcast_to(np.asarray(ca, f32).reshape(4, 1, 1),
                                   (4,) + px.shape).astype(f32)
            pos = py if axis_id != 0 else px
            pw_e = pw13[1] if axis_id != 0 else pw13[0]
            er0 = edge_ref[1] if axis_id != 0 else edge_ref[0]
            aww = aw[1] if axis_id != 0 else aw[0]
            if style == STYLE_DOUBLE:
                if pw_e >= 1.0:
                    r0 = f32(er0 + pw_e)
                    r1 = f32(er0 + aww - pw_e)
                    dd = np.minimum(pos - r0, r1 - pos)
                else:
                    dd = np.full_like(px, f32(-1.0))
                return ca_v * _distance_aa(dd)[None]
            if style in (STYLE_GROOVE, STYLE_RIDGE):
                pw_h = pw12[1] if axis_id != 0 else pw12[0]
                ref = f32(er0 + pw_h)
                alpha = _distance_aa(pos - ref)
                cb_v = np.broadcast_to(np.asarray(cb, f32).reshape(4, 1, 1),
                                       (4,) + px.shape).astype(f32)
                return ca_v + (cb_v - ca_v) * alpha[None]
            return ca_v

        col0_c = corner_eval(inst["style0"], c00, c01)
        col1_c = corner_eval(inst["style1"], c10, c11)
        col0_e = edge_eval(inst["style0"], c00, c01, edge_axis[0])
        col1_e = edge_eval(inst["style1"], c10, c11, edge_axis[1])
        col0 = np.where(in_clip[None], col0_c, col0_e)
        col1 = np.where(in_clip[None], col1_c, col1_e)

        alpha = _distance_aa(d)
        color = col0 + (col1 - col0) * mix_factor[None]
        frag = color * alpha[None]          # premultiplied RGBA [4,hh,ww]

        # pack + integer src-over onto the accumulated task (swgl
        # round-half-even pack, blend.h integer normal blend)
        src8 = _pack_u8(frag)
        dst8 = task8[iy0:iy1, ix0:ix1].transpose(2, 0, 1)
        sa = src8[3]
        out8 = src8 + dst8 - np.floor((dst8 * sa + dst8) / 256.0)
        task8[iy0:iy1, ix0:ix1] = np.clip(out8, 0, 255).transpose(1, 2, 0)
    return (task8 / 255.0).astype(np.float32)
