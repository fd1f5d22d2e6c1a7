"""A solid square of one colour turned about its centre, with some of its
corners rounded, as one tile of MotionMark's Multiply: under a reference
frame of its own (the turn), a stacking context, a rounded-rect clip of
the square in the tile's own space with the class's radii, and its clip
chain, as Gecko sends such an element.

`params`: `centre` (x, y) in window pixels, `size` (the side, px),
`angle` (degrees, clockwise on the screen, as CSS's `rotate`) and
`radii` (top-left, top-right, bottom-right, bottom-left: circular radii
in px, after CSS's overlap scaling).  `place(item)` sets `item.rect` to
the device box of every pixel the tile can cover.

The reference follows the anti-aliasing rule that the configuration
states under `guarantees`: each device pixel centre p of the box maps
back to the tile's space, q = R(-angle)(p - centre) + centre, and with
fw = |cos(angle)| + |sin(angle)| (the screen-space rate of change of the
tile's coordinates, its filter width):

* the square's distance d = max(x0 - qx, qx - x1, y0 - qy, qy - y1)
  gives the edge coverage a = clamp(0.5 - d / fw, 0, 1);
* the clip takes, where q lies in a rounded corner's triangle
  (|qx - corner x| / r + |qy - corner y| / r < 1; the last such corner of
  top-left, top-right, bottom-right, bottom-left), the circle's
  first-order distance e = (|q - o|² - r²) / (2 |q - o|) about the
  corner's centre o, else no distance, and gives the clip coverage
  m = clamp(0.5 - max(e, d) / fw, 0, 1);
* the colour, premultiplied and rounded to 8 bits (half to even), is
  scaled as swgl scales a fragment: by A = floor(256 a + 0.5 + 1/1024)
  to floor(s A / 256), then by M = floor(255 m + 0.5 + 1/1024) to
  floor((s M + s) / 256).

At whole quarter turns q is exact, so the reference is exact by
construction there.
"""
import math

import numpy as np

# A frozen copy of the program's `ops/roofline.py` table as it stood
# when this kind was defined: the per-corner rounded-rect clip record
# (`CLIP_OPS["rounded_sdf"]`) over every pixel; the rotated rect's
# coverage and inverse map are in the work count's coverage already.
OPS = 125

# the rounding nudge of a coverage step: 1/1024 of a u8 step
TIE = 1.0 / 1024.0
# WebRender's NEARLY_ZERO: a shear below it leaves a transform axis-aligned
NEARLY_ZERO = 1.0 / 4096.0


def turn(params):
    """(cos, sin) of the tile's angle."""
    r = math.radians(params["angle"])
    return math.cos(r), math.sin(r)


def place(item):
    """Sets `item.rect` to the whole pixels whose centres can have
    coverage: the turned square grown by half a filter width."""
    p = item.params
    cx, cy = p["centre"]
    c, s = turn(p)
    fw = abs(c) + abs(s)
    reach = (p["size"] / 2 + 0.5 * fw) * fw
    item.rect = (math.floor(cx - reach), math.floor(cy - reach),
                 math.ceil(cx + reach), math.ceil(cy + reach))


def push(A, b, common, item):
    p = item.params
    cx, cy = p["centre"]
    half = p["size"] / 2
    turned = A.Transform.translation(-cx, -cy).then(
        A.Transform.rotation_z(p["angle"])).then(
        A.Transform.translation(cx, cy))
    frame = b.push_reference_frame(A.Point2D(0, 0), common.spatial_id,
                                   A.TransformStyle.FLAT, turned)
    b.push_stacking_context(A.Point2D(0, 0), frame)
    local = A.Rect(cx - half, cy - half, p["size"], p["size"])
    tl, tr, br, bl = (A.Size2D(r, r) for r in p["radii"])
    clip = b.define_clip_rounded_rect(frame, local, A.BorderRadius(
        top_left=tl, top_right=tr, bottom_left=bl, bottom_right=br))
    chain = b.define_clip_chain(None, [clip])
    b.push_rect(A.CommonItemProperties(local, frame, chain), local,
                A.ColorF(*item.color))
    b.pop_stacking_context()
    b.pop_reference_frame()


def world_offset(params):
    """The device offset (m12, m13) of the tile's transform, the turn
    about its centre, summed in the order the program's 4x4 product sums
    it (translate by -centre, turn, translate by centre)."""
    cx, cy = params["centre"]
    c, s = turn(params)
    return (-cx * c + cy * s) + cx, (-cx * s + -cy * c) + cy


def axis_aligned(params) -> bool:
    """Whether the program draws the tile as axis-aligned: the turn's
    shear terms (sin) below WebRender's NEARLY_ZERO, 1/4096 (0 and 180
    degrees, give or take 0.014)."""
    return abs(turn(params)[1]) < NEARLY_ZERO


def snapped(params):
    """The tile's square (x0, y0, x1, y1) in its own space, as the
    program snaps an axis-aligned rect: each edge v to
    (floor(v k + t + 0.5) - t) / k with k the turn's cos and t the
    device offset of its axis (the shear left out)."""
    cx, cy = params["centre"]
    half = params["size"] / 2
    c = turn(params)[0]
    tx, ty = world_offset(params)

    def snap(v, t):
        return (math.floor(v * c + t + 0.5) - t) / c
    return (snap(cx - half, tx), snap(cy - half, ty),
            snap(cx + half, tx), snap(cy + half, ty))


def _clip_radii(radii, rect):
    """`radii` scaled so that no side's two radii overlap on `rect`."""
    w, h = rect[2] - rect[0], rect[3] - rect[1]
    tl, tr, br, bl = radii
    ratio = min([1.0] + [w / v for v in (tl + tr, bl + br) if v > w] +
                [h / v for v in (tl + bl, tr + br) if v > h])
    return [r * ratio for r in radii]


def _edge(d, aa):
    """An axis-aligned edge's term: the box filter's ramp with AA, the
    pixel-centre test without."""
    return np.minimum(d, 0.5) if aa else np.where(d >= 0.0, 0.5, -1e3)


def coverage(item):
    """(a, m), each (h, w) float64 over `item.rect`: the edge coverage and
    the clip coverage of the stated rule."""
    p = item.params
    cx, cy = p["centre"]
    half = p["size"] / 2
    c, s = turn(p)
    fw = abs(c) + abs(s)
    x0, y0, x1, y1 = item.rect
    px = np.arange(x0, x1, dtype=np.float64)[None, :] + 0.5
    py = np.arange(y0, y1, dtype=np.float64)[:, None] + 0.5
    qx = (px - cx) * c + (py - cy) * s + cx      # the tile's own space
    qy = (py - cy) * c - (px - cx) * s + cy
    square = (cx - half, cy - half, cx + half, cy + half)
    clip = snapped(p) if axis_aligned(p) else square

    def outside(r):
        return np.maximum(np.maximum(r[0] - qx, qx - r[2]),
                          np.maximum(r[1] - qy, qy - r[3]))
    if axis_aligned(p):
        # the snapped square cut by the unsnapped one; an edge that the
        # cut moved is drawn without AA
        cut = (max(clip[0], square[0]), max(clip[1], square[1]),
               min(clip[2], square[2]), min(clip[3], square[3]))
        aa = (cut[0] <= clip[0], cut[1] <= clip[1], cut[2] >= clip[2],
              cut[3] >= clip[3])
        sx = math.hypot(c, s)
        a = (np.clip(_edge((qx - cut[0]) * sx, aa[0]) +
                     _edge((cut[2] - qx) * sx, aa[2]), 0.0, 1.0) *
             np.clip(_edge((qy - cut[1]) * sx, aa[1]) +
                     _edge((cut[3] - qy) * sx, aa[3]), 0.0, 1.0))
    else:
        a = np.clip(0.5 - outside(square) / fw, 0.0, 1.0)
    d = outside(clip)
    e = np.full(d.shape, -np.inf)
    cx0, cy0, cx1, cy1 = clip
    # (the corner, the way in along x and along y) for tl, tr, br, bl
    corners = ((cx0, cy0, 1, 1), (cx1, cy0, -1, 1), (cx1, cy1, -1, -1),
               (cx0, cy1, 1, -1))
    for (kx, ky, sx, sy), r in zip(corners, _clip_radii(p["radii"], clip)):
        if r <= 0:
            continue
        ux, uy = (qx - kx) * sx, (qy - ky) * sy   # distances in from it
        n = np.hypot(ux - r, uy - r)              # from the corner's centre
        dist = (n * n - r * r) / (2.0 * np.maximum(n, 1e-12))
        e = np.where(ux / r + uy / r < 1.0, dist, e)
    m = np.clip(0.5 - np.maximum(e, d) / fw, 0.0, 1.0)
    return a, m


def packed(color, quantize):
    """The colour premultiplied and rounded to 8 bits, half to even, as
    int64 (4,)."""
    col = np.asarray(quantize(np.asarray(color, np.float64)), np.float64)
    prem = np.concatenate([col[:3] * col[3], col[3:]])
    return np.clip(np.rint(prem * 255.0), 0, 255).astype(np.int64)


def source(item, state, quantize):
    a, m = coverage(item)
    s = packed(item.color, quantize)[None, None, :]
    big_a = np.floor(a * 256.0 + (0.5 + TIE)).astype(np.int64)[..., None]
    big_m = np.floor(m * 255.0 + (0.5 + TIE)).astype(np.int64)[..., None]
    s = (s * big_a) >> 8
    s = (s * big_m + s) >> 8
    return s.astype(np.int32)


def area(item):
    """The pixels the tile covers: its square less, per rounded corner of
    radius r, the r x r corner outside the quarter circle."""
    p = item.params
    cut = sum(r * r * (1.0 - math.pi / 4.0) for r in p["radii"])
    return float(p["size"] ** 2 - cut)
