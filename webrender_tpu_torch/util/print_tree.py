"""Hierarchical debug printer (print_tree.rs PrintTree/PrintTreePrinter)
plus tree dumps for the spatial tree and scene — the `print tree` debug
facility the reference threads through spatial_tree/picture printing."""
from __future__ import annotations

import io
from typing import Optional


class PrintTree:
    """print_tree.rs:10 — indented section printer.

    >>> pt = PrintTree("title")
    >>> pt.new_level("root"); pt.add_item("leaf"); pt.end_level()
    """

    def __init__(self, title: str, sink: Optional[io.TextIOBase] = None):
        self.level = 0
        self.queued_item: Optional[str] = None
        self.sink = sink if sink is not None else io.StringIO()
        self._print_line(f"┌ {title}")

    def _print_line(self, line: str) -> None:
        self.sink.write("  " * self.level + line + "\n")

    def new_level(self, title: str) -> None:
        self.flush_queued_item("├─")
        self._print_line(f"├─ {title}")
        self.level += 1

    def end_level(self) -> None:
        self.flush_queued_item("└─")
        self.level -= 1

    def add_item(self, text: str) -> None:
        self.flush_queued_item("├─")
        self.queued_item = text

    def flush_queued_item(self, prefix: str) -> None:
        if self.queued_item is not None:
            self._print_line(f"{prefix} {self.queued_item}")
            self.queued_item = None

    def text(self) -> str:
        self.flush_queued_item("└─")
        return self.sink.getvalue() if isinstance(self.sink, io.StringIO) \
            else ""


def print_spatial_tree(tree, resolved=None) -> str:
    """spatial_tree.rs print() — one line per node with kind/parent and,
    when frame-resolved state is supplied, the world transform row."""
    pt = PrintTree("spatial tree")
    for i, node in enumerate(tree.nodes):
        if node is None:
            continue
        desc = f"[{i}] {node.kind.name.lower()} parent={node.parent}"
        if resolved is not None and i < len(resolved):
            r = resolved[i]
            desc += f" axis_aligned={r.is_2d_axis_aligned}"
        pt.add_item(desc)
    return pt.text()


def print_scene(scene) -> str:
    """Recursive picture/prim dump (picture.rs print_info role)."""
    pt = PrintTree("scene")

    def walk(pic):
        comp = pic.composite
        bits = []
        if comp.needs_surface:
            bits.append("surface")
        if comp.preserve_3d:
            bits.append("3d")
        pt.new_level(f"picture spatial={pic.common.spatial_node} "
                     f"{' '.join(bits)}")
        for child in pic.children:
            if type(child).__name__ == "PicturePrim":
                walk(child)
            else:
                c = child.common
                r = c.local_rect
                pt.add_item(f"{type(child).__name__} "
                            f"({r.x0:.0f},{r.y0:.0f} {r.w:.0f}x{r.h:.0f}) "
                            f"spatial={c.spatial_node}")
        pt.end_level()

    walk(scene.root_picture if hasattr(scene, "root_picture")
         else scene.root)
    return pt.text()
