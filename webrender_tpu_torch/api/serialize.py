"""Display-list binary serialization — the `peek-poke` crate's role
(`webrender_api/src/display_list.rs` serialization + `peek-poke/src/lib.rs`):
a compact self-describing binary codec for built display lists so they can
cross process/thread boundaries as flat byte buffers.

peek-poke derives per-type max-size encoders; here a reflection-based codec
walks the display-item dataclasses (they are plain trees of scalars, enums,
tuples and nested dataclasses). Floats encode as f64 so a round trip is
bit-exact; enums encode by value; item types by a stable tag table.
"""
from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any, List

from . import display_item as di
from .display_list import BuiltDisplayList
from .units import Point2D, Rect, SideOffsets, Size2D, Transform

MAGIC = b"WRDL"
VERSION = 1

# stable item-type tag table (order append-only)
_ITEM_TYPES: List[type] = [
    di.RectangleItem, di.ClearRectangleItem, di.HitTestItem, di.TextItem,
    di.LineItem, di.BorderItem, di.BoxShadowItem, di.PushShadowItem,
    di.PopAllShadowsItem, di.GradientItem, di.RadialGradientItem,
    di.ConicGradientItem, di.ImageItem, di.RepeatingImageItem,
    di.YuvImageItem, di.BackdropFilterItem, di.RectClipItem,
    di.RoundedRectClipItem, di.ImageMaskClipItem, di.ClipChainItem,
    di.IframeItem, di.PushReferenceFrameItem, di.PopReferenceFrameItem,
    di.PushStackingContextItem, di.PopStackingContextItem,
    di.ScrollFrameItem, di.StickyFrameItem,
]
_TAG_OF = {t: i for i, t in enumerate(_ITEM_TYPES)}

# value-kind tags for the recursive encoder
_K_NONE, _K_BOOL, _K_INT, _K_FLOAT, _K_STR, _K_BYTES = range(6)
_K_TUPLE, _K_LIST, _K_DATACLASS, _K_ENUM, _K_DICT = range(6, 11)

_DC_TYPES: List[type] = []
_DC_TAG: dict = {}


def _dc_tag(t: type) -> int:
    tag = _DC_TAG.get(t)
    if tag is None:
        tag = len(_DC_TYPES)
        _DC_TYPES.append(t)
        _DC_TAG[t] = tag
    return tag


def _encode(v: Any, out: bytearray) -> None:
    if v is None:
        out.append(_K_NONE)
    elif isinstance(v, bool):
        out.append(_K_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, enum.Enum):
        out.append(_K_ENUM)
        name = type(v).__name__.encode()
        out.append(len(name))
        out += name
        out += struct.pack("<q", int(v.value))
    elif isinstance(v, int):
        out.append(_K_INT)
        out += struct.pack("<q", v)
    elif isinstance(v, float):
        out.append(_K_FLOAT)
        out += struct.pack("<d", v)
    elif isinstance(v, str):
        b = v.encode()
        out.append(_K_STR)
        out += struct.pack("<I", len(b))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        out.append(_K_BYTES)
        out += struct.pack("<I", len(v))
        out += bytes(v)
    elif isinstance(v, tuple):
        out.append(_K_TUPLE)
        out += struct.pack("<I", len(v))
        for e in v:
            _encode(e, out)
    elif isinstance(v, list):
        out.append(_K_LIST)
        out += struct.pack("<I", len(v))
        for e in v:
            _encode(e, out)
    elif isinstance(v, dict):
        out.append(_K_DICT)
        out += struct.pack("<I", len(v))
        for k, e in v.items():
            _encode(k, out)
            _encode(e, out)
    elif dataclasses.is_dataclass(v):
        out.append(_K_DATACLASS)
        name = type(v).__name__.encode()
        out.append(len(name))
        out += name
        fields = dataclasses.fields(v)
        out += struct.pack("<I", len(fields))
        for f in fields:
            _encode(getattr(v, f.name), out)
    else:
        raise TypeError(f"unserializable display-list value: {type(v)}")


class _Reader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        v = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return v[0]


def _type_registry():
    reg = {}
    for mod in (di,):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type):
                reg[name] = obj
    for t in (Point2D, Rect, Size2D, SideOffsets, Transform):
        reg[t.__name__] = t
    from .color import ColorF
    from .font import (FontInstanceFlags, FontInstanceOptions,
                       SyntheticItalics)
    from .image import ImageData, ImageDescriptor
    for t in (ColorF, FontInstanceOptions, SyntheticItalics, ImageDescriptor,
              ImageData):
        reg[t.__name__] = t
    try:
        reg["FontInstanceFlags"] = FontInstanceFlags
    except Exception:
        pass
    return reg


_REGISTRY = None


def _decode(r: _Reader) -> Any:
    global _REGISTRY
    k = r.u8()
    if k == _K_NONE:
        return None
    if k == _K_BOOL:
        return bool(r.u8())
    if k == _K_INT:
        return r.unpack("<q")
    if k == _K_FLOAT:
        return r.unpack("<d")
    if k == _K_STR:
        return r.take(r.unpack("<I")).decode()
    if k == _K_BYTES:
        return r.take(r.unpack("<I"))
    if k == _K_TUPLE:
        return tuple(_decode(r) for _ in range(r.unpack("<I")))
    if k == _K_LIST:
        return [_decode(r) for _ in range(r.unpack("<I"))]
    if k == _K_DICT:
        n = r.unpack("<I")
        return {_decode(r): _decode(r) for _ in range(n)}
    if k == _K_ENUM:
        name = r.take(r.u8()).decode()
        value = r.unpack("<q")
        if _REGISTRY is None:
            _REGISTRY = _type_registry()
        t = _REGISTRY[name]
        return t(value)
    if k == _K_DATACLASS:
        name = r.take(r.u8()).decode()
        n = r.unpack("<I")
        vals = [_decode(r) for _ in range(n)]
        if _REGISTRY is None:
            _REGISTRY = _type_registry()
        t = _REGISTRY[name]
        return t(*vals)
    raise ValueError(f"bad tag {k} at {r.pos}")


def serialize_display_list(dl: BuiltDisplayList) -> bytes:
    """BuiltDisplayList → flat bytes (display_list.rs end() payload)."""
    out = bytearray()
    out += MAGIC
    out.append(VERSION)
    _encode((dl.pipeline_id.namespace, dl.pipeline_id.id), out)
    out += struct.pack("<I", len(dl.items))
    for item in dl.items:
        out.append(_TAG_OF[type(item)])
        fields = dataclasses.fields(item)
        out += struct.pack("<I", len(fields))
        for f in fields:
            _encode(getattr(item, f.name), out)
    return bytes(out)


def deserialize_display_list(buf: bytes) -> BuiltDisplayList:
    assert buf[:4] == MAGIC, "not a serialized display list"
    assert buf[4] == VERSION, f"display-list version {buf[4]}"
    r = _Reader(buf, 5)
    ns, pid = _decode(r)
    n = r.unpack("<I")
    items = []
    for _ in range(n):
        t = _ITEM_TYPES[r.u8()]
        nf = r.unpack("<I")
        vals = [_decode(r) for _ in range(nf)]
        items.append(t(*vals))
    return BuiltDisplayList(di.PipelineId(ns, pid), items)
