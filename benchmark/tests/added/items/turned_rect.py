"""A solid rectangle of one colour turned by whole quarter turns about
its centre, under a reference frame and a stacking context of its own.

`params`: `centre` (x, y), `size` (width, height) before the turn and
`turns`, the quarter turns.  A quarter turn of a rect whose centre and
edges lie on whole pixels lands on whole pixels, so the reference draws
the colour over the turned box alone.
"""
import numpy as np

OPS = 0      # beyond the coverage and the compose

# (cos, sin) of 0, 1, 2 and 3 quarter turns, exact
QUARTERS = ((1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0))


def push(A, b, common, item):
    cx, cy = item.params["centre"]
    w, h = item.params["size"]
    c, s = QUARTERS[item.params["turns"]]
    turned = A.Transform.translation(-cx, -cy).then(A.Transform(
        [c, s, 0, 0, -s, c, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1])).then(
        A.Transform.translation(cx, cy))
    frame = b.push_reference_frame(A.Point2D(0, 0), common.spatial_id,
                                   A.TransformStyle.FLAT, turned)
    b.push_stacking_context(A.Point2D(0, 0), frame)
    local = A.Rect(cx - w // 2, cy - h // 2, w, h)
    b.push_rect(A.CommonItemProperties(local, frame), local,
                A.ColorF(*item.color))
    b.pop_stacking_context()
    b.pop_reference_frame()


def source(item, state, quantize):
    """The colour premultiplied and packed as `rect`'s, over the turned
    box, which the tile covers whole."""
    cx, cy = item.params["centre"]
    w, h = item.params["size"]
    if item.params["turns"] % 2:
        w, h = h, w
    x0, y0, x1, y1 = item.rect
    if (x0, y0, x1, y1) != (cx - w // 2, cy - h // 2, cx + w // 2,
                            cy + h // 2):
        raise ValueError(f"a {w}x{h} tile about {(cx, cy)} turned "
                         f"{item.params['turns']} times is not {item.rect}")
    c = np.asarray(quantize(np.asarray(item.color, np.float32)), np.float32)
    premul = np.concatenate([c[:3] * c[3], c[3:]]).astype(np.float32)
    px = np.clip(np.rint(premul * np.float32(255.0)), 0, 255)
    return np.broadcast_to(px.astype(np.int32), (y1 - y0, x1 - x0, 4))


def area(item):
    """The pixels the tile covers: its width times its height, turned or
    not."""
    w, h = item.params["size"]
    return float(w * h)
