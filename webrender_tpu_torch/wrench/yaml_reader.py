"""wrench YAML scene reader.

Re-implements `wrench/src/yaml_frame_reader.rs` (+ `yaml_helper.rs` parsing
semantics) against our DisplayListBuilder so the reference's reftest corpus
(`wrench/reftests/*.yaml`) replays through the TPU pipeline unchanged.
Parsing quirks (shorthand keys, color formats, transform chains, procedural
images, default fonts) follow the reference precisely — cited per function.

The port's copy of `webrender_tpu/wrench/yaml_reader.py` on the port's own
API.  It imports PyYAML, PIL and matplotlib only where a document needs
them: a `.json` document is read with the standard library (JSON is YAML,
so the JAX package's reader reads the same file), PIL opens image files,
and the font context (matplotlib's FreeType) is built at the first text
item.  A document that needs a package the machine lacks fails, naming it.
"""
from __future__ import annotations

import json
import math
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.color import ColorF, parse_color
from ..api.display_item import (AlphaType, BorderRadius, BorderSide,
                                BorderStyle, BoxShadowClipMode, ClipChainId,
                                ClipId, ClipMode, ColorDepth, ColorRange,
                                ConicGradient, ExtendMode, FilterOp,
                                FilterOpKind, Gradient, GradientStop,
                                ImageRendering, LineOrientation, LineStyle,
                                MixBlendMode, NinePatchBorder, NormalBorder,
                                PipelineId, PrimitiveFlags, RadialGradient,
                                RasterSpace, ReferenceFrameKind, RepeatMode,
                                Shadow, SpatialId, StackingContextFlags,
                                TransformStyle, YuvColorSpace,
                                CommonItemProperties, ROOT_CLIP_CHAIN)
from ..api.font import FontInstanceFlags, FontInstanceKey, FontKey
from ..api.image import (ImageData, ImageDescriptor, ImageDescriptorFlags,
                         ImageFormat)
from ..api.display_list import DisplayListBuilder
from ..api.transaction import Epoch, Transaction
from ..api.units import Point2D, Rect, SideOffsets, Size2D, Transform

BIG = 1.0e30
FULL_CLIP = Rect(-BIG / 2.0, -BIG / 2.0, BIG, BIG)

_FUNC_RE = re.compile(r"([a-zA-Z0-9_-]+)\(([^)]*)\)")


def parse_function(s: str):
    """wrench parse_function: 'name(a, b) rest' → (name, [args], rest).
    Handles nested parens/brackets — 'fuzzy-if(platform(swgl),1,2)' and
    'drop-shadow([x, y], r, c)' each parse as one function."""
    s = s.strip()
    m = re.match(r"([a-zA-Z0-9_-]+)\(", s)
    if m is None:
        return s, [], ""
    depth = 0
    end = len(s)
    for j in range(m.end() - 1, len(s)):
        if s[j] == "(":
            depth += 1
        elif s[j] == ")":
            depth -= 1
            if depth == 0:
                end = j
                break
    inner = s[m.end():end]
    # split args on top-level commas only (wrench parse_function:1701)
    args, depth, cur = [], 0, ""
    for ch in inner:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        args.append(cur.strip())
    rest = s[end + 1:].strip()
    return m.group(1), args, rest


# --- yaml_helper.rs scalar/geometry parsing --------------------------------

def _broadcast4(vals: List[int]) -> List[int]:
    """yaml_frame_reader.rs broadcast(:167): tile the list up to 4 items."""
    out: List[int] = []
    while len(out) < 4:
        out.extend(vals)
    return out[:4]


def as_f32(v) -> Optional[float]:
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def as_vec_f32(v) -> Optional[List[float]]:
    if v is None:
        return None
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return [float(v)]
    if isinstance(v, str):
        try:
            return [float(t) for t in v.split()]
        except ValueError:
            return None
    if isinstance(v, list):
        out = []
        for t in v:
            f = as_f32(t)
            if f is None:
                return None
            out.append(f)
        return out
    return None


def as_rect(v) -> Optional[Rect]:
    nums = as_vec_f32(v)
    if nums is None or len(nums) != 4:
        return None
    return Rect(nums[0], nums[1], nums[2], nums[3])


def as_size(v) -> Optional[Size2D]:
    nums = as_vec_f32(v)
    if nums is None or len(nums) != 2:
        return None
    return Size2D(nums[0], nums[1])


def as_point(v) -> Optional[Point2D]:
    nums = as_vec_f32(v)
    if nums is None or len(nums) != 2:
        return None
    return Point2D(nums[0], nums[1])


def as_colorf(v) -> Optional[ColorF]:
    return parse_color(v)


def as_border_radius_component(v) -> Size2D:
    if isinstance(v, int) and not isinstance(v, bool):
        return Size2D(float(v), float(v))
    s = as_size(v)
    return s if s is not None else Size2D(0, 0)


def as_border_radius(v) -> Optional[BorderRadius]:
    """yaml_helper.rs:462 — uniform number, [tl,tr,bl,br] array, or hash."""
    if v is None:
        return None
    s = as_size(v)
    if s is not None:
        return BorderRadius(s, s, s, s)
    if isinstance(v, (int, float, str)) and not isinstance(v, bool):
        f = as_f32(v)
        if f is not None:
            return BorderRadius.uniform(f)
    if isinstance(v, list) and len(v) == 4:
        return BorderRadius(
            top_left=as_border_radius_component(v[0]),
            top_right=as_border_radius_component(v[1]),
            bottom_left=as_border_radius_component(v[2]),
            bottom_right=as_border_radius_component(v[3]))
    if isinstance(v, dict):
        return BorderRadius(
            top_left=as_border_radius_component(v.get("top-left")),
            top_right=as_border_radius_component(v.get("top-right")),
            bottom_left=as_border_radius_component(v.get("bottom-left")),
            bottom_right=as_border_radius_component(v.get("bottom-right")))
    return None


def _rotation(origin: Point2D, deg: float, ax: float, ay: float, az: float
              ) -> Transform:
    """yaml_helper.rs make_rotation:173 — rotate about `axis` by `degrees`
    around the given origin; theta = 2π - radians(deg) in euclid's
    convention, which on y-down screen coordinates is a *clockwise* rotation
    for positive degrees."""
    theta = 2.0 * math.pi - math.radians(deg)
    c = math.cos(theta)
    s = math.sin(theta)
    t = 1.0 - c
    # normalized axis rotation matrix (euclid pre_rotate), row-vector form
    n = math.sqrt(ax * ax + ay * ay + az * az) or 1.0
    x, y, z = ax / n, ay / n, az / n
    rot = Transform([
        t * x * x + c, t * x * y + s * z, t * x * z - s * y, 0.0,
        t * x * y - s * z, t * y * y + c, t * y * z + s * x, 0.0,
        t * x * z + s * y, t * y * z - s * x, t * z * z + c, 0.0,
        0.0, 0.0, 0.0, 1.0,
    ])
    pre = Transform.translation(-origin.x, -origin.y)
    post = Transform.translation(origin.x, origin.y)
    return pre.then(rot).then(post)


def make_perspective(origin: Point2D, d: float) -> Transform:
    pre = Transform.translation(-origin.x, -origin.y)
    post = Transform.translation(origin.x, origin.y)
    return pre.then(Transform.perspective(d)).then(post)


def as_matrix4d(v) -> Optional[Transform]:
    nums = as_vec_f32(v)
    if nums is not None and len(nums) == 16:
        return Transform(nums)
    return None


def as_transform(v, origin: Point2D) -> Optional[Transform]:
    """yaml_helper.rs as_transform:327."""
    m = as_matrix4d(v)
    if m is not None:
        return m
    if isinstance(v, str):
        slice_ = v
        transform = Transform.identity()
        while slice_:
            func, args, rest = parse_function(slice_)
            slice_ = rest
            f = [float(a) for a in args] if args else []
            if func == "translate" and len(f) >= 2:
                mx = Transform.translation(f[0], f[1], f[2] if len(f) > 2 else 0.0)
            elif func in ("rotate", "rotate-z") and len(f) == 1:
                mx = _rotation(origin, f[0], 0, 0, 1)
            elif func == "rotate-x" and len(f) == 1:
                mx = _rotation(origin, f[0], 1, 0, 0)
            elif func == "rotate-y" and len(f) == 1:
                mx = _rotation(origin, f[0], 0, 1, 0)
            elif func == "scale" and f:
                mx = Transform.scale(f[0], f[1] if len(f) > 1 else f[0],
                                     f[2] if len(f) > 2 else 1.0)
            elif func == "scale-x" and len(f) == 1:
                mx = Transform.scale(f[0], 1.0, 1.0)
            elif func == "scale-y" and len(f) == 1:
                mx = Transform.scale(1.0, f[0], 1.0)
            elif func == "scale-z" and len(f) == 1:
                mx = Transform.scale(1.0, 1.0, f[0])
            elif func == "skew" and f:
                mx = Transform.skew(f[0], f[1] if len(f) > 1 else 0.0)
            elif func == "skew-x" and len(f) == 1:
                mx = Transform.skew(f[0], 0.0)
            elif func == "skew-y" and len(f) == 1:
                mx = Transform.skew(0.0, f[0])
            elif func == "perspective" and len(f) == 1:
                mx = Transform.perspective(f[0])
            else:
                break
            transform = transform.then(mx)
        return transform
    if isinstance(v, list):
        # array fold: each element's transform applied *before* the
        # accumulated one (yaml_helper.rs:399 — t.then(&u))
        acc = Transform.identity()
        for item in v:
            t = as_transform(item, origin)
            if t is not None:
                acc = t.then(acc)
        return acc
    return None


_MIX_BLEND = {
    "normal": MixBlendMode.NORMAL, "multiply": MixBlendMode.MULTIPLY,
    "screen": MixBlendMode.SCREEN, "overlay": MixBlendMode.OVERLAY,
    "darken": MixBlendMode.DARKEN, "lighten": MixBlendMode.LIGHTEN,
    "color-dodge": MixBlendMode.COLOR_DODGE,
    "color-burn": MixBlendMode.COLOR_BURN,
    "hard-light": MixBlendMode.HARD_LIGHT,
    "soft-light": MixBlendMode.SOFT_LIGHT,
    "difference": MixBlendMode.DIFFERENCE,
    "exclusion": MixBlendMode.EXCLUSION, "hue": MixBlendMode.HUE,
    "saturation": MixBlendMode.SATURATION, "color": MixBlendMode.COLOR,
    "luminosity": MixBlendMode.LUMINOSITY,
    "plus-lighter": MixBlendMode.PLUS_LIGHTER,
}

_BORDER_STYLE = {
    "none": BorderStyle.NONE, "solid": BorderStyle.SOLID,
    "double": BorderStyle.DOUBLE, "dotted": BorderStyle.DOTTED,
    "dashed": BorderStyle.DASHED, "hidden": BorderStyle.HIDDEN,
    "groove": BorderStyle.GROOVE, "ridge": BorderStyle.RIDGE,
    "inset": BorderStyle.INSET, "outset": BorderStyle.OUTSET,
}


def as_filter_op(v) -> Optional[FilterOp]:
    """yaml_helper.rs as_filter_op:540 — simple CSS filters + the SVGFE
    graph node set (:541-560)."""
    if isinstance(v, dict):
        if "svgfe" in v:
            name = str(v["svgfe"]).lower()
            node = {
                "op": name,
                "linear": bool(v.get("linear", True)),
                "subregion": as_rect(v.get("subregion"))
                or Rect(0, 0, 1024, 1024),
                "in1": v.get("in"),
                "in2": v.get("in2"),
                "value": as_f32(v.get("value")),
                "color": as_colorf(v.get("color")),
                "matrix": tuple(as_vec_f32(v.get("matrix")) or ()),
                "dx": as_f32(v.get("dx")) or 0.0,
                "dy": as_f32(v.get("dy")) or 0.0,
                "std_x": as_f32(v.get("std_deviation_x")) or 0.0,
                "std_y": as_f32(v.get("std_deviation_y")) or 0.0,
                "filter_data": as_filter_data(v.get("filter-data"))
                if v.get("filter-data") else None,
            }
            return FilterOp(FilterOpKind.SVG_GRAPH, svgfe=node)
        return None
    if not isinstance(v, str):
        return None
    func, args, _ = parse_function(v)
    if func == "identity":
        return FilterOp(FilterOpKind.IDENTITY)
    if func == "component-transfer":
        return FilterOp(FilterOpKind.COMPONENT_TRANSFER)
    if func == "blur" and len(args) == 2:
        return FilterOp(FilterOpKind.BLUR, float(args[0]), float(args[1]))
    if func == "brightness" and len(args) == 1:
        return FilterOp(FilterOpKind.BRIGHTNESS, float(args[0]))
    if func == "contrast" and len(args) == 1:
        return FilterOp(FilterOpKind.CONTRAST, float(args[0]))
    if func == "grayscale" and len(args) == 1:
        return FilterOp(FilterOpKind.GRAYSCALE, float(args[0]))
    if func == "hue-rotate" and len(args) == 1:
        return FilterOp(FilterOpKind.HUE_ROTATE, float(args[0]))
    if func == "invert" and len(args) == 1:
        return FilterOp(FilterOpKind.INVERT, float(args[0]))
    if func == "opacity" and len(args) == 1:
        return FilterOp(FilterOpKind.OPACITY, float(args[0]))
    if func == "saturate" and len(args) == 1:
        return FilterOp(FilterOpKind.SATURATE, float(args[0]))
    if func == "sepia" and len(args) == 1:
        return FilterOp(FilterOpKind.SEPIA, float(args[0]))
    if func == "srgb-to-linear":
        return FilterOp(FilterOpKind.SRGB_TO_LINEAR)
    if func == "linear-to-srgb":
        return FilterOp(FilterOpKind.LINEAR_TO_SRGB)
    if func == "drop-shadow" and len(args) == 3:
        off_src = args[0].strip().strip("[]")
        parts = [p for p in off_src.replace(",", " ").split() if p]
        off = Point2D(float(parts[0]), float(parts[1])) if len(parts) == 2 \
            else Point2D(0, 0)
        return FilterOp(FilterOpKind.DROP_SHADOW,
                        shadow=Shadow(off, as_colorf(args[2]) or ColorF.BLACK,
                                      float(args[1])))
    if func == "color-matrix" and len(args) == 20:
        return FilterOp(FilterOpKind.COLOR_MATRIX,
                        matrix=tuple(float(a) for a in args))
    if func == "flood" and len(args) == 1:
        return FilterOp(FilterOpKind.FLOOD,
                        shadow=Shadow(Point2D(0, 0),
                                      as_colorf(args[0]) or ColorF.BLACK, 0))
    return None


def as_filter_data(v):
    """yaml_helper.rs as_filter_data:935 — [func_types x4, values_r, values_g,
    values_b, values_a]."""
    from ..api.display_item import ComponentTransferFuncType as F, FilterData
    if not isinstance(v, list) or len(v) < 5:
        return None
    name_map = {"Identity": F.IDENTITY, "Table": F.TABLE,
                "Discrete": F.DISCRETE, "Linear": F.LINEAR, "Gamma": F.GAMMA}
    funcs = [name_map.get(str(t), F.IDENTITY) for t in v[0]]
    while len(funcs) < 4:
        funcs.append(F.IDENTITY)
    vals = [tuple(float(x) for x in (v[i] or [])) for i in range(1, 5)]
    return FilterData(funcs[0], funcs[1], funcs[2], funcs[3],
                      vals[0], vals[1], vals[2], vals[3])


def as_vec_filter_data(v):
    if v is None:
        return []
    out = []
    for item in (v if isinstance(v, list) else [v]):
        fd = as_filter_data(item)
        if fd is not None:
            out.append(fd)
    return out


_COMPOSITE_OP_NAMES = {
    "over": "compositeover", "in": "compositein", "out": "compositeout",
    "atop": "compositeatop", "xor": "compositexor",
    "lighter": "compositelighter", "arithmetic": "compositearithmetic",
}


def _filter_input(v):
    """yaml_helper.rs as_filter_input:975 — original/previous/index."""
    if v is None or v == "previous":
        return None
    if v == "original":
        return -1
    return int(v)


def as_vec_filter_primitives(v, filter_datas) -> List[FilterOp]:
    """yaml_helper.rs as_filter_primitive:1001 — the legacy FilterPrimitive
    graph API, lowered onto the SVGFE node evaluator (subregion=None means
    "the tight filter region" for flood / unclipped for everything else)."""
    if not v:
        return []
    out: List[FilterOp] = []
    fd_iter = iter(filter_datas or [])
    for p in v:
        if not isinstance(p, dict):
            continue
        t = p.get("type")
        node = {
            "op": None,
            "linear": p.get("color-space", "linear-rgb") != "srgb",
            "subregion": None,
            "in1": _filter_input(p.get("in", p.get("in1"))),
            "in2": _filter_input(p.get("in2")),
            "value": None, "color": as_colorf(p.get("color")),
            "matrix": tuple(as_vec_f32(p.get("matrix")) or ()),
            "dx": 0.0, "dy": 0.0, "std_x": 0.0, "std_y": 0.0,
            "filter_data": None, "k_values": None,
            # legacy graphs keep node outputs in their own color space
            # (render_task.rs get_task_input) and use the cs_svg_filter.glsl
            # arithmetic math (unpremultiplied inputs)
            "legacy": True,
        }
        if t == "identity":
            node["op"] = "identity"
        elif t == "blend":
            node["op"] = "blend" + \
                str(p.get("blend-mode", "normal")).replace("-", "")
        elif t == "flood":
            node["op"] = "flood"
        elif t == "blur":
            node["op"] = "gaussianblur"
            node["std_x"] = as_f32(p.get("width")) or 0.0
            node["std_y"] = as_f32(p.get("height")) or 0.0
        elif t == "opacity":
            node["op"] = "opacity"
            node["value"] = as_f32(p.get("opacity"))
        elif t == "color-matrix":
            node["op"] = "colormatrix"
        elif t == "drop-shadow":
            node["op"] = "dropshadow"
            off = as_point(p.get("offset")) or Point2D(0, 0)
            node["dx"], node["dy"] = off.x, off.y
            node["std_x"] = node["std_y"] = as_f32(p.get("radius")) or 0.0
        elif t == "component-transfer":
            node["op"] = "componenttransfer"
            node["filter_data"] = next(fd_iter, None)
        elif t == "offset":
            node["op"] = "offset"
            off = as_point(p.get("offset")) or Point2D(0, 0)
            node["dx"], node["dy"] = off.x, off.y
        elif t == "composite":
            node["op"] = _COMPOSITE_OP_NAMES.get(p.get("operator"),
                                                 "compositeover")
            node["k_values"] = tuple(as_vec_f32(p.get("k-values")) or ())
        else:
            continue
        out.append(FilterOp(FilterOpKind.SVG_GRAPH, svgfe=node))
    return out


def as_vec_filter_op(v) -> List[FilterOp]:
    if v is None:
        return []
    if isinstance(v, list):
        out = []
        for item in v:
            f = as_filter_op(item)
            if f is not None:
                out.append(f)
        return out
    f = as_filter_op(v)
    return [f] if f is not None else []


def as_gradient_stops(v) -> List[GradientStop]:
    stops = []
    assert isinstance(v, list), f"gradient stops must be a list: {v!r}"
    for i in range(0, len(v), 2):
        stops.append(GradientStop(float(as_f32(v[i])),
                                  as_colorf(v[i + 1])))
    return stops


# --- procedural images (yaml_frame_reader.rs:195-287) ----------------------

def generate_checkerboard_image(border, tsx, tsy, cx, cy, transparent):
    w = 2 * border + tsx * cx
    h = 2 * border + tsy * cy
    img = np.zeros((h, w, 4), np.uint8)
    img[:, :] = [0, 0, 255, 255]  # BGRA red border
    ys, xs = np.mgrid[0:h, 0:w]
    inner = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    xon = ((xs - border) % (2 * tsx)) < tsx
    yon = ((ys - border) % (2 * tsy)) < tsy
    on = xon ^ yon
    if transparent:
        val = np.where(on, 255, 0).astype(np.uint8)
        for c in range(4):
            img[..., c] = np.where(inner, val, img[..., c])
    else:
        val = np.where(on, 255, 0x7F).astype(np.uint8)
        for c in range(3):
            img[..., c] = np.where(inner, val, img[..., c])
        img[..., 3] = np.where(inner, 255, img[..., 3])
    flags = ImageDescriptorFlags.NONE if transparent else ImageDescriptorFlags.IS_OPAQUE
    return (ImageDescriptor(ImageFormat.BGRA8, w, h, flags=flags),
            ImageData(pixels=img))


def generate_solid_color_image(r, g, b, a, w, h):
    flags = ImageDescriptorFlags.IS_OPAQUE if a == 255 else ImageDescriptorFlags.NONE
    desc = ImageDescriptor(ImageFormat.BGRA8, w, h, flags=flags)
    if w * h > 1 << 22:
        # huge constant images stay symbolic (very-big.yaml is 100000x1000)
        return desc, ImageData(solid=(b, g, r, a))
    img = np.zeros((h, w, 4), np.uint8)
    img[:, :] = [b, g, r, a]
    return desc, ImageData(pixels=img)


def generate_xy_gradient_image(w, h):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    grid = np.where((xs % 100 < 3) | (ys % 100 < 3), 0.9, 1.0)
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 0] = (ys / h * 255.0 * grid).astype(np.uint8)  # B (BGRA order)
    img[..., 1] = 0
    img[..., 2] = (xs / w * 255.0 * grid).astype(np.uint8)  # R
    img[..., 3] = 255
    return (ImageDescriptor(ImageFormat.BGRA8, w, h,
                            flags=ImageDescriptorFlags.IS_OPAQUE),
            ImageData(pixels=img))


def load_image_file(path: Path):
    """PNG loading with wrench's conversions (yaml_frame_reader.rs:555-600):
    RGBA8 → premultiplied BGRA8; RGB8/L8 → opaque."""
    Image = _need("PIL.Image", path)
    img = Image.open(path)
    if img.mode == "L":
        arr = np.asarray(img, np.uint8)
        h, w = arr.shape
        return (ImageDescriptor(ImageFormat.R8, w, h), ImageData(pixels=arr))
    if img.mode == "P":
        img = img.convert("RGBA")
    if img.mode == "RGB":
        arr = np.asarray(img, np.uint8)
        h, w = arr.shape[:2]
        bgra = np.zeros((h, w, 4), np.uint8)
        bgra[..., 0] = arr[..., 2]
        bgra[..., 1] = arr[..., 1]
        bgra[..., 2] = arr[..., 0]
        bgra[..., 3] = 255
        return (ImageDescriptor(ImageFormat.BGRA8, w, h,
                                flags=ImageDescriptorFlags.IS_OPAQUE),
                ImageData(pixels=bgra))
    arr = np.asarray(img.convert("RGBA"), np.uint8)
    h, w = arr.shape[:2]
    # premultiply (wrench premultiply() on RGBA8 inputs)
    a = arr[..., 3:4].astype(np.uint32)
    rgb = (arr[..., :3].astype(np.uint32) * a + 128) // 255
    bgra = np.zeros((h, w, 4), np.uint8)
    bgra[..., 0] = rgb[..., 2]
    bgra[..., 1] = rgb[..., 1]
    bgra[..., 2] = rgb[..., 0]
    bgra[..., 3] = arr[..., 3]
    opaque = bool((arr[..., 3] == 255).all())
    flags = ImageDescriptorFlags.IS_OPAQUE if opaque else ImageDescriptorFlags.NONE
    return (ImageDescriptor(ImageFormat.BGRA8, w, h, flags=flags),
            ImageData(pixels=bgra))


def _need(module: str, path):
    """`module`, imported; a machine without it fails naming it and the
    document that needs it."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ModuleNotFoundError(
            f"reading {path} needs the Python package {module.split('.')[0]}"
            f" ({e})", name=e.name) from e


def load_document(path: Path) -> dict:
    """A wrench document: `.json` through the standard library, anything
    else through PyYAML (`yaml.safe_load`, as the reference reads YAML)."""
    with open(path) as f:
        if Path(path).suffix == ".json":
            return json.load(f)
        return _need("yaml", path).safe_load(f)


# ---------------------------------------------------------------------------


class YamlFrameReader:
    """yaml_frame_reader.rs YamlFrameReader. `build()` produces a Transaction
    stream against a RenderBackend."""

    def __init__(self, path: str, window_size=(1920, 1080),
                 font_render_mode=None):
        self.path = Path(path)
        self.aux_dir = self.path.parent
        self.window_size = window_size
        self.font_render_mode = font_render_mode
        self.scroll_offsets: Dict[int, Point2D] = {}
        self.image_map: Dict = {}
        self.font_map: Dict = {}
        self.font_instance_map: Dict = {}
        self.next_image_key = 1
        self.next_font_key = 1
        self.next_font_instance_key = 1
        self.next_external_scroll_id = 1000
        self.txn = Transaction()
        # per-pipeline user id maps
        self.user_clip_id_map: Dict[int, ClipId] = {}
        self.user_clip_chain_id_map: Dict[int, ClipChainId] = {}
        self.user_spatial_id_map: Dict[int, SpatialId] = {}
        self.spatial_id_stack: List[SpatialId] = []
        self._fonts = None

    @property
    def _font_ctx(self):
        """The font context, built at the first text item (matplotlib's
        FreeType)."""
        if self._fonts is None:
            _need("matplotlib.ft2font", self.path)
            from ..resources.resource_cache import FontContext
            self._fonts = FontContext()
        return self._fonts

    # -- resource helpers --------------------------------------------------
    def _rsrc_path(self, v) -> Path:
        return self.aux_dir / str(v)

    def _add_or_get_image(self, file: Path, tiling=None):
        key_t = (str(file), tiling)
        if key_t in self.image_map:
            return self.image_map[key_t]
        if file.exists():
            desc, data = load_image_file(file)
        else:
            name = file.name
            func, args, _ = parse_function(name)
            if func == "xy-gradient":
                desc, data = generate_xy_gradient_image(
                    int(args[0]) if args else 1000,
                    int(args[1]) if len(args) > 1 else 1000)
            elif func == "solid-color":
                a = [int(x) for x in args] + [255, 255, 255, 255, 1000, 1000]
                desc, data = generate_solid_color_image(a[0], a[1], a[2], a[3],
                                                        a[4], a[5])
            elif func in ("checkerboard", "transparent-checkerboard"):
                border = int(args[0]) if args else 4
                if len(args) == 3:
                    size, count = int(args[1]), int(args[2])
                    dims = (size, size, count, count)
                elif len(args) == 5:
                    dims = (int(args[1]), int(args[2]), int(args[3]),
                            int(args[4]))
                else:
                    dims = (32, 32, 8, 8)
                desc, data = generate_checkerboard_image(
                    border, *dims, transparent=func == "transparent-checkerboard")
            else:
                raise FileNotFoundError(f"image {file}")
        key = self.next_image_key
        self.next_image_key += 1
        self.txn.add_image(key, desc, data, tiling)
        val = (key, Size2D(float(desc.width), float(desc.height)))
        self.image_map[key_t] = val
        return val

    def _get_font(self, item) -> FontKey:
        if item.get("family") is not None:
            desc = ("family", item["family"])
        elif item.get("font") is not None:
            desc = ("path", str(self._rsrc_path(item["font"])),
                    int(item.get("font-index", 0)))
        else:
            desc = ("family", "default")
        if desc in self.font_map:
            return self.font_map[desc]
        key = FontKey(0, self.next_font_key)
        self.next_font_key += 1
        if desc[0] == "path":
            self.txn.add_native_font(key, desc[1], desc[2])
            self._font_ctx.add_font(key, None, desc[1], desc[2])
        else:
            fm = _need("matplotlib.font_manager", self.path)
            name = desc[1]
            if name in ("default", "sans-serif"):
                name = "DejaVu Sans"
            path = fm.findfont(name)
            self.txn.add_native_font(key, path)
            self._font_ctx.add_font(key, None, path)
        self.font_map[desc] = key
        return key

    def _get_font_instance(self, font_key: FontKey, size: float,
                           flags, synthetic_italics_deg: float = 0.0) -> int:
        from ..api.font import (FontInstanceOptions, FontRenderMode,
                                SyntheticItalics)
        if self.font_render_mode == "mono":
            render_mode = FontRenderMode.MONO
        elif self.font_render_mode == "alpha":
            render_mode = FontRenderMode.ALPHA
        else:
            # subpixel AA is the default (FontInstanceOptions default /
            # wrench without disable-subpixel)
            render_mode = FontRenderMode.SUBPIXEL
        k = (font_key, size, int(flags), synthetic_italics_deg, render_mode)
        if k in self.font_instance_map:
            return self.font_instance_map[k]
        key = self.next_font_instance_key
        self.next_font_instance_key += 1
        opts = FontInstanceOptions(
            render_mode=render_mode, flags=flags,
            synthetic_italics=SyntheticItalics(synthetic_italics_deg))
        self.txn.add_font_instance(FontInstanceKey(0, key), font_key, size,
                                   opts)
        self.font_instance_map[k] = key
        return key

    # -- id helpers ---------------------------------------------------------
    def _top_space(self) -> SpatialId:
        return self.spatial_id_stack[-1]

    def _to_spatial_id(self, v, pipeline_id) -> Optional[SpatialId]:
        if v is None:
            return None
        if isinstance(v, int):
            return self.user_spatial_id_map[v]
        if v == "root-reference-frame":
            return SpatialId.root_reference_frame(pipeline_id)
        if v == "root-scroll-node":
            return SpatialId.root_scroll_node(pipeline_id)
        return None

    def _to_clip_chain_id(self, v, dl: DisplayListBuilder
                          ) -> Optional[ClipChainId]:
        if isinstance(v, bool) or v is None:
            return None
        if isinstance(v, int):
            return self.user_clip_chain_id_map[v]
        if isinstance(v, list):
            clip_ids = [self.user_clip_id_map[i] for i in v]
            return dl.define_clip_chain(None, clip_ids)
        return None

    # -- main build ---------------------------------------------------------
    def build(self, backend) -> None:
        """Parse + send all pipelines to the backend (reader build :431)."""
        doc = load_document(self.path)
        root_pipeline = PipelineId(0, 1)
        self.txn = Transaction()
        for pipeline in doc.get("pipelines", []) or []:
            pid = pipeline.get("id")
            pid = PipelineId(int(pid[0]), int(pid[1])) if isinstance(pid, list) \
                else PipelineId(0, int(pid))
            self._build_pipeline(pid, pipeline)
        assert "root" in doc, f"{self.path} has no root"
        self._build_pipeline(root_pipeline, doc["root"])
        self.txn.set_root_pipeline(root_pipeline)
        self.txn.generate_frame()
        backend.send_transaction(self.txn)
        if self.scroll_offsets:
            backend.scroll_offsets.update(self.scroll_offsets)

    def _build_pipeline(self, pipeline_id: PipelineId, yaml_node) -> None:
        yaml_node = yaml_node or {}
        self.user_clip_id_map.clear()
        self.user_clip_chain_id_map.clear()
        self.user_spatial_id_map.clear()
        self.spatial_id_stack = [SpatialId.root_scroll_node(pipeline_id)]
        dl = DisplayListBuilder(pipeline_id)
        dl.begin()
        self._add_stacking_context(dl, yaml_node, is_root=True,
                                   info_flags=PrimitiveFlags.IS_BACKFACE_VISIBLE)
        _, built = dl.end()
        self.txn.set_display_list(Epoch(0), built)
        assert len(self.spatial_id_stack) == 1

    # -- items --------------------------------------------------------------
    SHORTHANDS = ["rect", "image", "text", "glyphs", "box-shadow", "border",
                  "gradient", "radial-gradient", "conic-gradient"]

    def _item_type(self, item: dict) -> str:
        for s in self.SHORTHANDS:
            if s in item:
                return s
        return item.get("type", "unknown")

    def _add_items(self, dl: DisplayListBuilder, items) -> None:
        for item in items or []:
            ty = self._item_type(item)
            spatial_id = self._to_spatial_id(item.get("spatial-id"),
                                             dl.pipeline_id)
            if spatial_id is not None:
                self.spatial_id_stack.append(spatial_id)

            clip_rect = as_rect(item.get("clip-rect")) or FULL_CLIP
            chain = self._to_clip_chain_id(item.get("clip-chain"), dl)
            flags = PrimitiveFlags.NONE
            if item.get("backface-visible", True):
                flags |= PrimitiveFlags.IS_BACKFACE_VISIBLE
            info = CommonItemProperties(
                clip_rect, self._top_space(),
                chain if chain is not None else ROOT_CLIP_CHAIN, flags)

            handler = {
                "rect": self._handle_rect,
                "clear-rect": self._handle_clear_rect,
                "hit-test": self._handle_hit_test,
                "line": self._handle_line,
                "image": self._handle_image,
                "yuv-image": self._handle_yuv_image,
                "text": self._handle_text,
                "glyphs": self._handle_text,
                "scroll-frame": self._handle_scroll_frame,
                "sticky-frame": self._handle_sticky_frame,
                "clip": self._handle_clip,
                "clip-chain": self._handle_clip_chain,
                "border": self._handle_border,
                "gradient": self._handle_gradient,
                "radial-gradient": self._handle_radial_gradient,
                "conic-gradient": self._handle_conic_gradient,
                "box-shadow": self._handle_box_shadow,
                "iframe": self._handle_iframe,
                "stacking-context": self._handle_stacking_context,
                "reference-frame": self._handle_reference_frame,
                "computed-frame": self._handle_computed_frame,
                "shadow": self._handle_push_shadow,
                "pop-all-shadows": lambda dl, i, info: dl.pop_all_shadows(),
                "backdrop-filter": self._handle_backdrop_filter,
            }.get(ty)
            if handler is not None:
                handler(dl, item, info)
            else:
                print(f"wrench-yaml: skipping unknown item type {ty!r}")

            if spatial_id is not None:
                self.spatial_id_stack.pop()

    def _bounds_key(self, item, shorthand: str) -> str:
        return shorthand if "type" not in item else "bounds"

    def _handle_rect(self, dl, item, info):
        bounds = as_rect(item[self._bounds_key(item, "rect")])
        color = as_colorf(item.get("color")) or ColorF.BLACK
        dl.push_rect(info, bounds, color)

    def _handle_clear_rect(self, dl, item, info):
        dl.push_clear_rect(info, as_rect(item["bounds"]))

    def _handle_hit_test(self, dl, item, info):
        bounds = as_rect(item["bounds"])
        tag = item.get("hit-testing-tag")
        if isinstance(tag, list) and len(tag) == 2:
            dl.push_hit_test(bounds, info.clip_chain_id, info.spatial_id,
                             info.flags, (int(tag[0]), int(tag[1])))

    def _handle_line(self, dl, item, info):
        color = as_colorf(item.get("color")) or ColorF.BLACK
        orientation = LineOrientation.HORIZONTAL \
            if item.get("orientation") == "horizontal" else LineOrientation.VERTICAL
        style = {"solid": LineStyle.SOLID, "dotted": LineStyle.DOTTED,
                 "dashed": LineStyle.DASHED, "wavy": LineStyle.WAVY}[
            item.get("style", "solid")]
        thickness = float(item.get("thickness", 0.0)) \
            if style == LineStyle.WAVY else 0.0
        if "baseline" in item:
            baseline = float(item["baseline"])
            start = float(item["start"])
            end = float(item["end"])
            width = float(item["width"])
            if orientation == LineOrientation.HORIZONTAL:
                area = Rect(start, baseline, end - start, width)
            else:
                area = Rect(baseline, start, width, end - start)
        else:
            area = as_rect(item[self._bounds_key(item, "rect")])
        dl.push_line(info, area, thickness, orientation, color, style)

    def _handle_image(self, dl, item, info):
        filename = item["image"] if "type" not in item else item["src"]
        tiling = item.get("tile-size")
        key, dims = self._add_or_get_image(self._rsrc_path(filename), tiling)
        raw = as_vec_f32(item["bounds"])
        if len(raw) == 2:
            bounds = Rect(raw[0], raw[1], dims.width, dims.height)
        else:
            bounds = Rect(raw[0], raw[1], raw[2], raw[3])
        rendering = {"auto": ImageRendering.AUTO,
                     "crisp-edges": ImageRendering.CROSP_EDGES,
                     "pixelated": ImageRendering.PIXELATED}[
            item.get("rendering", "auto")]
        alpha_type = AlphaType.ALPHA if item.get("alpha-type") == "alpha" \
            else AlphaType.PREMULTIPLIED_ALPHA
        color = as_colorf(item.get("color")) or ColorF.WHITE
        stretch = as_size(item.get("stretch-size"))
        spacing = as_size(item.get("tile-spacing"))
        if stretch is None and spacing is None:
            dl.push_image(info, bounds, rendering, alpha_type, key, color)
        else:
            dl.push_repeating_image(info, bounds, stretch or dims,
                                    spacing or Size2D(0, 0), rendering,
                                    alpha_type, key, color)

    def _handle_yuv_image(self, dl, item, info):
        fmt = item["format"]
        if fmt == "planar":
            keys = [self._add_or_get_image(self._rsrc_path(item[k]))[0]
                    for k in ("src-y", "src-u", "src-v")]
        elif fmt in ("nv12", "p010", "nv16"):
            keys = [self._add_or_get_image(self._rsrc_path(item[k]))[0]
                    for k in ("src-y", "src-uv")]
            fmt = "nv12"
        else:
            keys = [self._add_or_get_image(self._rsrc_path(item["src"]))[0]]
            fmt = "interleaved"
        bounds = as_rect(item["bounds"])
        dl.push_yuv_image(info, bounds, keys, fmt, ColorDepth.COLOR8,
                          YuvColorSpace.REC709, ColorRange.LIMITED,
                          ImageRendering.AUTO)

    def _handle_text(self, dl, item, info):
        # yaml sizes are in points: 1 pt = 16/12 px (yaml_helper as_pt_to_f32)
        size = float(item.get("size", 16.0)) * (16.0 / 12.0) \
            if item.get("size") is not None else 16.0
        color = as_colorf(item.get("color")) or ColorF.BLACK
        flags = FontInstanceFlags.NONE
        if item.get("synthetic-bold"):
            flags |= FontInstanceFlags.SYNTHETIC_BOLD
        if item.get("transpose"):
            flags |= FontInstanceFlags.TRANSPOSE
        if item.get("flip-x"):
            flags |= FontInstanceFlags.FLIP_X
        if item.get("flip-y"):
            flags |= FontInstanceFlags.FLIP_Y
        si = item.get("synthetic-italics")
        italics_deg = 0.0
        if isinstance(si, bool) and si:
            italics_deg = 14.0  # wr SyntheticItalics::enabled() default
        elif si is not None and not isinstance(si, bool):
            italics_deg = float(as_f32(si) or 0.0)
        font_key = self._get_font(item)
        fi_key = self._get_font_instance(font_key, size, flags, italics_deg)
        if "text" not in item:
            origin = as_point(item.get("origin")) or Point2D(0, 0)
            indices = [int(g) for g in item["glyphs"]]
            offsets = as_vec_f32(item["offsets"])
            glyphs = [(indices[i],
                       origin.x + offsets[i * 2],
                       origin.y + offsets[i * 2 + 1])
                      for i in range(len(indices))]
            rect = as_rect(item["bounds"])
        else:
            text = item["text"]
            origin = as_point(item["origin"])
            glyphs, rect = self._layout_simple_ascii(
                font_key, fi_key, text, size, origin, flags)
        dl.push_text(info, rect, glyphs, fi_key, color)

    def _layout_simple_ascii(self, font_key, fi_key, text, size, origin,
                             flags=FontInstanceFlags.NONE):
        """wrench.rs layout_simple_ascii:320 — metrics-driven pen advance;
        TRANSPOSE advances the pen along ±y, FLIP_X along -x (:344)."""
        ctx = self._font_ctx
        glyphs = []
        cursor_x, cursor_y = origin.x, origin.y
        if flags & FontInstanceFlags.TRANSPOSE:
            dir_x, dir_y = 0.0, (-1.0 if flags & FontInstanceFlags.FLIP_Y
                                 else 1.0)
        else:
            dir_x, dir_y = ((-1.0 if flags & FontInstanceFlags.FLIP_X
                             else 1.0), 0.0)
        bound = None
        for ch in text:
            gi = ctx.glyph_index(font_key, ch)
            if gi == 0:
                cursor_x += dir_x * size / 3.0
                cursor_y += dir_y * size / 3.0
                continue
            alpha, left, top, _adv = ctx.rasterize(font_key, size, gi)
            advance = ctx.linear_advance(font_key, size, gi)
            if advance <= 0:
                advance = size / 3.0
            glyphs.append((gi, cursor_x, cursor_y))
            if alpha.size:
                h, w = alpha.shape
                m = max(w, h) + 2
                r = Rect(cursor_x - m, cursor_y - m, 2 * m, 2 * m)
                bound = r if bound is None else bound.union(r)
            cursor_x += dir_x * advance
            cursor_y += dir_y * advance
        bound = (bound or Rect(origin.x, origin.y, 0, 0)).inflate(2, 2)
        return glyphs, bound

    def _handle_scroll_frame(self, dl, item, info):
        clip_rect = as_rect(item["bounds"])
        content_size = as_size(item.get("content-size")) or clip_rect.size
        content_rect = Rect(clip_rect.x, clip_rect.y,
                            content_size.width, content_size.height)
        ext_offset = as_point(item.get("external-scroll-offset")) or Point2D(0, 0)
        numeric_id = item.get("id")
        external_id = self.next_external_scroll_id
        self.next_external_scroll_id += 1
        if item.get("scroll-offset") is not None:
            self.scroll_offsets[external_id] = \
                [(as_point(item["scroll-offset"]), 0)]
        if item.get("scroll-offsets"):
            self.scroll_offsets[external_id] = [
                (as_point(e.get("offset")) or Point2D(0, 0),
                 int(e.get("generation", 0)))
                for e in item["scroll-offsets"]]
        clip_id = None
        if item.get("clip-to-frame", False):
            clip_id = dl.define_clip_rect(self._top_space(), clip_rect)
        sid = dl.define_scroll_frame(
            self._top_space(), external_id, content_rect, clip_rect,
            ext_offset, int(item.get("scroll-generation", 0)),
            bool(item.get("has-scroll-linked-effect", False)))
        if numeric_id is not None:
            self.user_spatial_id_map[numeric_id] = sid
            if clip_id is not None:
                self.user_clip_id_map[numeric_id] = clip_id
        if item.get("items"):
            self.spatial_id_stack.append(sid)
            self._add_items(dl, item["items"])
            self.spatial_id_stack.pop()

    def _handle_sticky_frame(self, dl, item, info):
        bounds = as_rect(item["bounds"])
        margins = tuple(
            as_f32(item.get(k)) for k in
            ("margin-top", "margin-right", "margin-bottom", "margin-left"))

        def bounds2(v):
            nums = as_vec_f32(v)
            return (nums[0], nums[1]) if nums and len(nums) == 2 else (0.0, 0.0)
        sid = dl.define_sticky_frame(
            self._top_space(), bounds, margins,
            bounds2(item.get("vertical-offset-bounds")),
            bounds2(item.get("horizontal-offset-bounds")),
            as_point(item.get("previously-applied-offset")) or Point2D(0, 0))
        if item.get("id") is not None:
            self.user_spatial_id_map[item["id"]] = sid
        if item.get("items"):
            self.spatial_id_stack.append(sid)
            self._add_items(dl, item["items"])
            self.spatial_id_stack.pop()

    def _handle_clip(self, dl, item, info):
        numeric_id = item.get("id")
        spatial_id = self._top_space()
        clip_id = None
        if item.get("bounds") is not None:
            clip_id = dl.define_clip_rect(spatial_id, as_rect(item["bounds"]))
        mask = item.get("image-mask")
        if isinstance(mask, dict):
            assert clip_id is None
            if mask.get("image") == "invalid":
                # ImageKey::DUMMY (yaml_frame_reader.rs:774): missing image,
                # mask resolves to nothing → clips everything out
                key, dims = -1, Size2D(100.0, 100.0)
            else:
                key, dims = self._add_or_get_image(
                    self._rsrc_path(mask["image"]), mask.get("tile-size"))
            rect = as_rect(mask.get("rect")) or Rect(0, 0, dims.width,
                                                     dims.height)
            clip_id = dl.define_clip_image_mask(spatial_id, rect, key)
        complex_clips = item.get("complex") or []
        if complex_clips:
            assert len(complex_clips) == 1 and clip_id is None
            c = complex_clips[0]
            if isinstance(c, dict):
                rect = as_rect(c["rect"])
                radius = as_border_radius(c.get("radius")) or BorderRadius()
                mode = ClipMode.CLIP_OUT if c.get("clip-mode") == "clip-out" \
                    else ClipMode.CLIP
            else:
                rect = as_rect(c)
                radius = BorderRadius()
                mode = ClipMode.CLIP
            clip_id = dl.define_clip_rounded_rect(spatial_id, rect, radius, mode)
        if clip_id is not None and numeric_id is not None:
            self.user_clip_id_map[numeric_id] = clip_id

    def _handle_clip_chain(self, dl, item, info):
        numeric_id = item["id"]
        clips = [self.user_clip_id_map[i] for i in item.get("clips", [])]
        parent = item.get("parent")
        parent_id = self.user_clip_chain_id_map[parent] \
            if parent is not None else None
        real = dl.define_clip_chain(parent_id, clips)
        self.user_clip_chain_id_map[numeric_id] = real

    def _handle_border(self, dl, item, info):
        bounds = as_rect(item[self._bounds_key(item, "border")])
        widths = as_vec_f32(item["width"])
        widths = (widths * 4)[:4]
        # yaml order [top, right/left?]: broadcast(w,4) then
        # SideOffsets::new(w[0], w[3], w[2], w[1]) = (top, right=w3, bottom=w2, left=w1)
        so = SideOffsets(widths[0], widths[3], widths[2], widths[1])
        btype = item.get("border-type", "normal")
        if btype != "normal":
            self._handle_nine_patch_border(dl, item, info, bounds, so, btype)
            return
        radius = as_border_radius(item.get("radius")) or BorderRadius()
        colors = item.get("color")
        styles = item.get("style")

        def bc(v):
            return [as_colorf(x) or ColorF.BLACK for x in
                    (v if isinstance(v, list) and
                     not (len(v) in (3, 4) and all(
                         isinstance(e, (int, float)) for e in v))
                     else [v])]

        def bs(v):
            return [_BORDER_STYLE.get(x, BorderStyle.SOLID) for x in
                    (v if isinstance(v, list) else [v])]
        cols = bc(colors)
        cols = (cols * 4)[:4]
        stys = bs(styles)
        stys = (stys * 4)[:4]
        # array order is [top, right, bottom, left] (handle_border :1043)
        border = NormalBorder(
            top=BorderSide(cols[0], stys[0]),
            right=BorderSide(cols[1], stys[1]),
            bottom=BorderSide(cols[2], stys[2]),
            left=BorderSide(cols[3], stys[3]),
            radius=radius,
            do_aa=bool(item.get("do_aa", True)))
        dl.push_border(info, bounds, so, details_normal=border)

    def _handle_nine_patch_border(self, dl, item, info, bounds, widths,
                                  btype):
        """Nine-patch borders (yaml_frame_reader.rs:1069-1136): image /
        gradient / radial-gradient / conic-gradient sources with
        image-width/height, slice, fill and repeat modes."""
        mode = ExtendMode.REPEAT if item.get("repeat") else ExtendMode.CLAMP
        iw = int(item.get("image-width", bounds.w))
        ih = int(item.get("image-height", bounds.h))
        fill = bool(item.get("fill", False))
        sl = item.get("slice")
        if sl is not None:
            sl = _broadcast4([int(v) for v in (sl if isinstance(sl, list)
                                               else [sl])])
            slice_so = SideOffsets(top=sl[0], right=sl[1],
                                   bottom=sl[2], left=sl[3])
        else:
            # the reference's default swaps left/right into the
            # (top, right, bottom, left) ctor (yaml_frame_reader.rs:1082)
            slice_so = SideOffsets(top=widths.top, right=widths.left,
                                   bottom=widths.bottom, left=widths.right)
        rep = {"stretch": RepeatMode.STRETCH, "repeat": RepeatMode.REPEAT,
               "round": RepeatMode.ROUND, "space": RepeatMode.SPACE}
        rep_h = rep[item.get("repeat-horizontal", "stretch")]
        rep_v = rep[item.get("repeat-vertical", "stretch")]
        common = dict(width=iw, height=ih, slice=slice_so, fill=fill,
                      repeat_horizontal=rep_h, repeat_vertical=rep_v)
        np_border = None
        if btype == "gradient":
            g, stops = dl.create_gradient(as_point(item["start"]),
                                          as_point(item["end"]),
                                          as_gradient_stops(item["stops"]),
                                          mode)
            np_border = NinePatchBorder(source_kind="gradient", gradient=g,
                                        stops=tuple(stops), **common)
        elif btype == "radial-gradient":
            g, stops = dl.create_radial_gradient(
                as_point(item["center"]), as_size(item["radius"]),
                as_gradient_stops(item["stops"]), mode)
            np_border = NinePatchBorder(source_kind="radial-gradient",
                                        radial_gradient=g,
                                        stops=tuple(stops), **common)
        elif btype == "conic-gradient":
            g, stops = dl.create_conic_gradient(
                as_point(item["center"]), float(as_f32(item["angle"])),
                as_gradient_stops(item["stops"]), mode)
            np_border = NinePatchBorder(source_kind="conic-gradient",
                                        conic_gradient=g,
                                        stops=tuple(stops), **common)
        elif btype == "image":
            key, dims = self._add_or_get_image(
                self._rsrc_path(item["image-source"]))
            np_border = NinePatchBorder(source_kind="image", image_key=key,
                                        **common)
        if np_border is not None:
            dl.push_border(info, bounds, widths,
                           details_nine_patch=np_border)

    def _handle_gradient(self, dl, item, info):
        bounds = as_rect(item[self._bounds_key(item, "gradient")])
        mode = ExtendMode.REPEAT if item.get("repeat") else ExtendMode.CLAMP
        g, stops = dl.create_gradient(as_point(item["start"]),
                                      as_point(item["end"]),
                                      as_gradient_stops(item["stops"]), mode)
        tile_size = as_size(item.get("tile-size")) or bounds.size
        tile_spacing = as_size(item.get("tile-spacing")) or Size2D(0, 0)
        dl.push_gradient(info, bounds, g, stops, tile_size, tile_spacing)

    def _handle_radial_gradient(self, dl, item, info):
        bounds = as_rect(item[self._bounds_key(item, "radial-gradient")])
        mode = ExtendMode.REPEAT if item.get("repeat") else ExtendMode.CLAMP
        g, stops = dl.create_radial_gradient(as_point(item["center"]),
                                             as_size(item["radius"]),
                                             as_gradient_stops(item["stops"]),
                                             mode)
        tile_size = as_size(item.get("tile-size")) or bounds.size
        tile_spacing = as_size(item.get("tile-spacing")) or Size2D(0, 0)
        dl.push_radial_gradient(info, bounds, g, stops, tile_size, tile_spacing)

    def _handle_conic_gradient(self, dl, item, info):
        bounds = as_rect(item[self._bounds_key(item, "conic-gradient")])
        mode = ExtendMode.REPEAT if item.get("repeat") else ExtendMode.CLAMP
        g, stops = dl.create_conic_gradient(
            as_point(item["center"]), float(as_f32(item["angle"])),
            as_gradient_stops(item["stops"]), mode)
        tile_size = as_size(item.get("tile-size")) or bounds.size
        tile_spacing = as_size(item.get("tile-spacing")) or Size2D(0, 0)
        dl.push_conic_gradient(info, bounds, g, stops, tile_size, tile_spacing)

    def _handle_box_shadow(self, dl, item, info):
        bounds = as_rect(item[self._bounds_key(item, "box-shadow")])
        box_bounds = as_rect(item.get("box-bounds")) or bounds
        offset = as_point(item.get("offset")) or Point2D(0, 0)
        color = as_colorf(item.get("color")) or ColorF(0, 0, 0, 1)
        blur_radius = float(as_f32(item.get("blur-radius")) or 0.0)
        spread_radius = float(as_f32(item.get("spread-radius")) or 0.0)
        border_radius = as_border_radius(item.get("border-radius")) or BorderRadius()
        clip_mode = BoxShadowClipMode.INSET \
            if item.get("clip-mode") == "inset" else BoxShadowClipMode.OUTSET
        dl.push_box_shadow(info, box_bounds, offset, color, blur_radius,
                           spread_radius, border_radius, clip_mode)

    def _handle_iframe(self, dl, item, info):
        bounds = as_rect(item["bounds"])
        pid = item["id"]
        pid = PipelineId(int(pid[0]), int(pid[1])) if isinstance(pid, list) \
            else PipelineId(0, int(pid))
        dl.push_iframe(bounds, info.clip_rect, info.spatial_id, pid,
                       item.get("ignore_missing_pipeline", True))

    def _push_reference_frame(self, dl, item, default_bounds: Rect) -> SpatialId:
        bounds = as_rect(item.get("bounds")) or default_bounds
        default_origin = Point2D(bounds.x + bounds.w * 0.5,
                                 bounds.y + bounds.h * 0.5)
        transform_style = TransformStyle.PRESERVE_3D \
            if item.get("transform-style") == "preserve-3d" else TransformStyle.FLAT
        t_origin = as_point(item.get("transform-origin")) or default_origin
        p_origin = as_point(item.get("perspective-origin")) or default_origin
        transform = as_transform(item.get("transform"), t_origin)
        perspective = None
        pval = item.get("perspective")
        if pval is not None:
            f = as_f32(pval)
            if f is not None and f != 0.0:
                perspective = make_perspective(p_origin, f)
            elif f is None:
                perspective = as_matrix4d(pval)
        kind = ReferenceFrameKind.PERSPECTIVE if pval is not None \
            else ReferenceFrameKind.TRANSFORM
        final = transform or perspective or Transform.identity()
        sid = dl.push_reference_frame(bounds.origin, self._top_space(),
                                      transform_style, final, kind)
        if item.get("id") is not None:
            self.user_spatial_id_map[item["id"]] = sid
        return sid

    def _handle_reference_frame(self, dl, item, info):
        default_bounds = Rect(0, 0, *self.window_size)
        sid = self._push_reference_frame(dl, item, default_bounds)
        self.spatial_id_stack.append(sid)
        self._add_items(dl, item.get("items"))
        self.spatial_id_stack.pop()
        dl.pop_reference_frame()

    def _handle_computed_frame(self, dl, item, info):
        """yaml_frame_reader.rs handle_computed_frame (:1952)."""
        from ..api.display_item import Rotation
        bounds = as_rect(item.get("bounds")) or Rect(0, 0, *self.window_size)
        sf = item.get("scale-from")
        scale_from = Size2D(as_f32(sf[0]), as_f32(sf[1])) \
            if sf is not None else None
        rotation = Rotation(int(item.get("rotation", 0)))
        sid = dl.push_computed_frame(
            bounds.origin, self._top_space(), scale_from,
            bool(item.get("vertical-flip", False)), rotation)
        if item.get("id") is not None:
            self.user_spatial_id_map[item["id"]] = sid
        self.spatial_id_stack.append(sid)
        self._add_items(dl, item.get("items"))
        self.spatial_id_stack.pop()
        dl.pop_reference_frame()

    def _handle_stacking_context(self, dl, item, info):
        self._add_stacking_context(dl, item, is_root=False,
                                   info_flags=info.flags)

    def _add_stacking_context(self, dl, item, is_root: bool, info_flags):
        default_bounds = Rect(0, 0, *self.window_size)
        bounds = as_rect(item.get("bounds")) or default_bounds
        pushed_rf = False
        if item.get("transform") is not None or item.get("perspective") is not None:
            sid = self._push_reference_frame(dl, item, default_bounds)
            self.spatial_id_stack.append(sid)
            bounds = Rect(0, 0, bounds.w, bounds.h)
            pushed_rf = True

        clip_chain_id = self._to_clip_chain_id(item.get("clip-chain"), dl)
        transform_style = TransformStyle.PRESERVE_3D \
            if item.get("transform-style") == "preserve-3d" else TransformStyle.FLAT
        mix_blend_mode = _MIX_BLEND.get(item.get("mix-blend-mode", "normal"),
                                        MixBlendMode.NORMAL)
        raster_space = RasterSpace.SCREEN
        flags = StackingContextFlags.NONE
        if item.get("blend-container", False):
            flags |= StackingContextFlags.IS_BLEND_CONTAINER
        if item.get("wraps-backdrop-filter", False):
            flags |= StackingContextFlags.WRAPS_BACKDROP_FILTER
        if is_root and item.get("scroll-offset") is not None:
            self.scroll_offsets[0] = [(as_point(item["scroll-offset"]), 0)]
        filters = as_vec_filter_op(item.get("filters"))
        filter_datas = as_vec_filter_data(item.get("filter-datas"))
        filters = filters + as_vec_filter_primitives(
            item.get("filter-primitives"), filter_datas)

        dl.push_stacking_context(
            bounds.origin, self._top_space(), info_flags, clip_chain_id,
            transform_style, mix_blend_mode, filters, filter_datas,
            raster_space, flags)
        self._add_items(dl, item.get("items"))
        dl.pop_stacking_context()
        if pushed_rf:
            self.spatial_id_stack.pop()
            dl.pop_reference_frame()

    def _handle_push_shadow(self, dl, item, info):
        blur_radius = float(as_f32(item.get("blur-radius")) or 0.0)
        offset = as_point(item.get("offset")) or Point2D(0, 0)
        color = as_colorf(item.get("color")) or ColorF.BLACK
        dl.push_shadow(info.spatial_id, info.clip_chain_id,
                       Shadow(offset, color, blur_radius))

    def _handle_backdrop_filter(self, dl, item, info):
        # bounds intersect into the clip rect (handle_backdrop_filter :2059)
        import dataclasses
        bounds = as_rect(item["bounds"])
        clip = bounds.intersection(info.clip_rect) or Rect(0, 0, 0, 0)
        info = dataclasses.replace(info, clip_rect=clip)
        filters = as_vec_filter_op(item.get("filters"))
        filter_datas = as_vec_filter_data(item.get("filter-datas"))
        dl.push_backdrop_filter(info, filters, filter_datas)

