"""Colors. Mirrors `webrender_api/src/color.rs` (ColorF/ColorU) plus the
named-color table wrench uses (`wrench/src/yaml_helper.rs:55-90`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class ColorF:
    """Non-premultiplied float RGBA, components nominally in [0, 1]."""
    r: float = 0.0
    g: float = 0.0
    b: float = 0.0
    a: float = 1.0

    def premultiplied(self) -> Tuple[float, float, float, float]:
        return (self.r * self.a, self.g * self.a, self.b * self.a, self.a)

    def scale_alpha(self, f: float) -> "ColorF":
        return ColorF(self.r, self.g, self.b, self.a * f)

    @property
    def is_opaque(self) -> bool:
        return self.a >= 1.0

    def to_u8(self) -> Tuple[int, int, int, int]:
        def q(v):
            return max(0, min(255, int(round(v * 255.0))))
        return (q(self.r), q(self.g), q(self.b), q(self.a))

    def __iter__(self):
        yield self.r
        yield self.g
        yield self.b
        yield self.a


ColorF.WHITE = ColorF(1, 1, 1, 1)
ColorF.BLACK = ColorF(0, 0, 0, 1)
ColorF.TRANSPARENT = ColorF(0, 0, 0, 0)


# wrench named colors (yaml_helper.rs:55-66). Note "transparent" is
# white-with-zero-alpha in the reference.
NAMED_COLORS = {
    "red": ColorF(1, 0, 0, 1),
    "green": ColorF(0, 1, 0, 1),
    "blue": ColorF(0, 0, 1, 1),
    "white": ColorF(1, 1, 1, 1),
    "black": ColorF(0, 0, 0, 1),
    "yellow": ColorF(1, 1, 0, 1),
    "cyan": ColorF(0, 1, 1, 1),
    "magenta": ColorF(1, 0, 1, 1),
    "transparent": ColorF(1, 1, 1, 0),
}


def parse_color(v: Union[str, Sequence[float], None]) -> Optional[ColorF]:
    """Parse a wrench-style color: name, "r g b [a]" string (0-255 rgb,
    0-1 alpha), or a numeric sequence [r, g, b] / [r, g, b, a]."""
    if v is None:
        return None
    if isinstance(v, ColorF):
        return v
    if isinstance(v, str):
        named = NAMED_COLORS.get(v.strip())
        if named is not None:
            return named
        # accept "[r, g, b, a]" strings (nested function args in wrench yaml)
        items = [float(s) for s in
                 v.strip().strip("[]").replace(",", " ").split()]
    else:
        items = [float(x) for x in v]
    if len(items) == 3:
        return ColorF(items[0] / 255.0, items[1] / 255.0, items[2] / 255.0, 1.0)
    if len(items) == 4:
        return ColorF(items[0] / 255.0, items[1] / 255.0, items[2] / 255.0, items[3])
    return None
