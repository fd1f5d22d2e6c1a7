"""Typed geometric units for the display-list API.

Mirrors the *semantics* of `webrender_api/src/units.rs` (typed euclid spaces:
Layout/World/Device px). We keep one lightweight Rect/Point/Size family rather
than one per space; the space discipline in the reference is a compile-time
aid, not runtime behavior.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Point2D:
    x: float = 0.0
    y: float = 0.0

    def __add__(self, o: "Point2D") -> "Point2D":
        return Point2D(self.x + o.x, self.y + o.y)

    def __sub__(self, o: "Point2D") -> "Point2D":
        return Point2D(self.x - o.x, self.y - o.y)

    def __iter__(self):
        yield self.x
        yield self.y


@dataclass(frozen=True)
class Size2D:
    width: float = 0.0
    height: float = 0.0

    def __iter__(self):
        yield self.width
        yield self.height

    @property
    def is_empty(self) -> bool:
        return self.width <= 0 or self.height <= 0


@dataclass(frozen=True)
class SideOffsets:
    """Per-side offsets (top, right, bottom, left) — border widths, margins."""
    top: float = 0.0
    right: float = 0.0
    bottom: float = 0.0
    left: float = 0.0


@dataclass(frozen=True)
class Rect:
    """Axis-aligned rect, origin + size (like euclid's Rect).

    Stored as (x, y, w, h); `x1`/`y1` give the max corner.
    """
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0

    @staticmethod
    def from_origin_size(origin: Point2D, size: Size2D) -> "Rect":
        return Rect(origin.x, origin.y, size.width, size.height)

    @staticmethod
    def from_bounds(x0: float, y0: float, x1: float, y1: float) -> "Rect":
        return Rect(x0, y0, x1 - x0, y1 - y0)

    @staticmethod
    def from_seq(v: Sequence[float]) -> "Rect":
        x, y, w, h = v
        return Rect(float(x), float(y), float(w), float(h))

    @property
    def x0(self) -> float:
        return self.x

    @property
    def y0(self) -> float:
        return self.y

    @property
    def x1(self) -> float:
        return self.x + self.w

    @property
    def y1(self) -> float:
        return self.y + self.h

    @property
    def origin(self) -> Point2D:
        return Point2D(self.x, self.y)

    @property
    def size(self) -> Size2D:
        return Size2D(self.w, self.h)

    @property
    def center(self) -> Point2D:
        return Point2D(self.x + self.w * 0.5, self.y + self.h * 0.5)

    @property
    def is_empty(self) -> bool:
        return self.w <= 0 or self.h <= 0

    def translate(self, dx: float, dy: float) -> "Rect":
        return Rect(self.x + dx, self.y + dy, self.w, self.h)

    def inflate(self, dx: float, dy: float) -> "Rect":
        return Rect(self.x - dx, self.y - dy, self.w + 2 * dx, self.h + 2 * dy)

    def intersection(self, o: "Rect") -> Optional["Rect"]:
        x0 = max(self.x0, o.x0)
        y0 = max(self.y0, o.y0)
        x1 = min(self.x1, o.x1)
        y1 = min(self.y1, o.y1)
        if x1 <= x0 or y1 <= y0:
            return None
        return Rect.from_bounds(x0, y0, x1, y1)

    def intersects(self, o: "Rect") -> bool:
        return self.x0 < o.x1 and o.x0 < self.x1 and self.y0 < o.y1 and o.y0 < self.y1

    def union(self, o: "Rect") -> "Rect":
        if self.is_empty:
            return o
        if o.is_empty:
            return self
        x0 = min(self.x0, o.x0)
        y0 = min(self.y0, o.y0)
        x1 = max(self.x1, o.x1)
        y1 = max(self.y1, o.y1)
        return Rect.from_bounds(x0, y0, x1, y1)

    def contains(self, p: Point2D) -> bool:
        return self.x0 <= p.x < self.x1 and self.y0 <= p.y < self.y1

    def contains_rect(self, o: "Rect") -> bool:
        return o.is_empty or (
            self.x0 <= o.x0 and o.x1 <= self.x1 and self.y0 <= o.y0 and o.y1 <= self.y1
        )

    def round_out(self) -> "Rect":
        x0 = math.floor(self.x0)
        y0 = math.floor(self.y0)
        return Rect.from_bounds(x0, y0, math.ceil(self.x1), math.ceil(self.y1))

    def scale(self, sx: float, sy: float) -> "Rect":
        return Rect(self.x * sx, self.y * sy, self.w * sx, self.h * sy)

    def __iter__(self):
        yield self.x
        yield self.y
        yield self.w
        yield self.h


ZERO_RECT = Rect()
MAX_RECT = Rect(-1.0e9, -1.0e9, 2.0e9, 2.0e9)


class Transform:
    """Row-vector 4x4 transform, matching euclid's Transform3D semantics as
    used by the reference (`webrender_api` LayoutTransform): point * M.

    Stored column-major-compatible as m[row][col] with translation in the
    last row (m41..m43 in euclid naming), i.e. transforming (x, y, 0, 1)
    gives (x*m00 + y*m10 + m30, x*m01 + y*m11 + m31, ...).
    """

    __slots__ = ("m",)

    def __init__(self, m: Optional[Iterable[float]] = None):
        if m is None:
            self.m = [
                1.0, 0.0, 0.0, 0.0,
                0.0, 1.0, 0.0, 0.0,
                0.0, 0.0, 1.0, 0.0,
                0.0, 0.0, 0.0, 1.0,
            ]
        else:
            self.m = [float(v) for v in m]
            assert len(self.m) == 16

    # --- constructors -----------------------------------------------------
    @staticmethod
    def identity() -> "Transform":
        return Transform()

    @staticmethod
    def translation(tx: float, ty: float, tz: float = 0.0) -> "Transform":
        t = Transform()
        t.m[12], t.m[13], t.m[14] = tx, ty, tz
        return t

    @staticmethod
    def scale(sx: float, sy: float, sz: float = 1.0) -> "Transform":
        t = Transform()
        t.m[0], t.m[5], t.m[10] = sx, sy, sz
        return t

    @staticmethod
    def rotation_z(deg: float) -> "Transform":
        r = math.radians(deg)
        c, s = math.cos(r), math.sin(r)
        return Transform([c, s, 0, 0, -s, c, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1])

    @staticmethod
    def rotation_x(deg: float) -> "Transform":
        r = math.radians(deg)
        c, s = math.cos(r), math.sin(r)
        return Transform([1, 0, 0, 0, 0, c, s, 0, 0, -s, c, 0, 0, 0, 0, 1])

    @staticmethod
    def rotation_y(deg: float) -> "Transform":
        r = math.radians(deg)
        c, s = math.cos(r), math.sin(r)
        return Transform([c, 0, -s, 0, 0, 1, 0, 0, s, 0, c, 0, 0, 0, 0, 1])

    @staticmethod
    def perspective(d: float) -> "Transform":
        t = Transform()
        t.m[11] = -1.0 / d if d != 0 else 0.0
        return t

    @staticmethod
    def skew(ax_deg: float, ay_deg: float) -> "Transform":
        t = Transform()
        t.m[4] = math.tan(math.radians(ax_deg))
        t.m[1] = math.tan(math.radians(ay_deg))
        return t

    # --- ops --------------------------------------------------------------
    def then(self, other: "Transform") -> "Transform":
        """self followed by other (row-vector: result = self * other)."""
        a, b = self.m, other.m
        out = [0.0] * 16
        for i in range(4):
            for j in range(4):
                out[i * 4 + j] = sum(a[i * 4 + k] * b[k * 4 + j] for k in range(4))
        return Transform(out)

    def pre_translate(self, tx: float, ty: float, tz: float = 0.0) -> "Transform":
        return Transform.translation(tx, ty, tz).then(self)

    def post_translate(self, tx: float, ty: float, tz: float = 0.0) -> "Transform":
        return self.then(Transform.translation(tx, ty, tz))

    def transform_point(self, x: float, y: float) -> Tuple[float, float, float]:
        m = self.m
        tx = x * m[0] + y * m[4] + m[12]
        ty = x * m[1] + y * m[5] + m[13]
        tw = x * m[3] + y * m[7] + m[15]
        return tx, ty, tw

    def transform_rect_bounds(self, r: Rect) -> Rect:
        """Axis-aligned bounding box of the transformed rect (w-divided)."""
        pts = []
        for (x, y) in ((r.x0, r.y0), (r.x1, r.y0), (r.x0, r.y1), (r.x1, r.y1)):
            tx, ty, tw = self.transform_point(x, y)
            if tw <= 1e-6:
                tw = 1e-6
            pts.append((tx / tw, ty / tw))
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        return Rect.from_bounds(min(xs), min(ys), max(xs), max(ys))

    @property
    def is_identity(self) -> bool:
        return self.m == [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]

    @property
    def is_2d_axis_aligned(self) -> bool:
        """The SCREEN mapping is axis-aligned scale+translate (z outputs
        are irrelevant — util.rs preserves_2d_axis_alignment only inspects
        the 2D part, so a flattened rotate-x(45) still snaps:
        transforms/rotate-clip.yaml).  Shear terms compare against
        NEARLY_ZERO (util.rs:21, 1/4096) so composed exact rotations
        (two 180s) keep their fp residue from disabling snapping
        (text/rotate-snap-clip.yaml)."""
        m = self.m
        eps = 1.0 / 4096.0
        return (m[3] == 0 and m[7] == 0
                and abs(m[1]) < eps and abs(m[4]) < eps)

    @property
    def is_2d(self) -> bool:
        """Representable as a 2D affine (no z interaction / perspective)."""
        m = self.m
        return (
            m[2] == 0 and m[3] == 0 and m[6] == 0 and m[7] == 0
            and m[8] == 0 and m[9] == 0 and m[11] == 0 and m[14] == 0
        )

    def to_2d_affine(self) -> Tuple[float, float, float, float, float, float]:
        """(m00, m01, m10, m11, tx, ty) mapping (x,y) -> (x', y')."""
        m = self.m
        return (m[0], m[1], m[4], m[5], m[12], m[13])

    def determinant_2d(self) -> float:
        m = self.m
        return m[0] * m[5] - m[1] * m[4]

    def inverse(self) -> Optional["Transform"]:
        import numpy as np
        a = np.array(self.m, dtype=np.float64).reshape(4, 4)
        try:
            inv = np.linalg.inv(a)
        except np.linalg.LinAlgError:
            return None
        return Transform(inv.reshape(-1).tolist())

    def __repr__(self):
        return f"Transform({self.m})"


@dataclass(frozen=True)
class ScaleOffset:
    """Fast-path 2D transform: scale then offset (util.rs `ScaleOffset`)."""
    sx: float = 1.0
    sy: float = 1.0
    tx: float = 0.0
    ty: float = 0.0

    def to_transform(self) -> Transform:
        return Transform([self.sx, 0, 0, 0, 0, self.sy, 0, 0, 0, 0, 1, 0, self.tx, self.ty, 0, 1])
