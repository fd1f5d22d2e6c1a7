"""Crash-report annotation hooks (webrender_api/src/lib.rs:775-815
CrashAnnotation / CrashAnnotator / CrashAnnotatorGuard).

The embedder registers an annotator; the renderer brackets kernel
compilation and pass execution with annotations so a crash report names
the kernel variant that was in flight."""
from __future__ import annotations

import enum
from typing import Optional


class CrashAnnotation(enum.Enum):
    COMPILE_SHADER = 0   # kernel specialization compile (shade.rs role)
    DRAW_SHADER = 1      # pass dispatch


class CrashAnnotator:
    """lib.rs:782 trait — override set/clear."""

    def set(self, annotation: CrashAnnotation, value: str) -> None:
        raise NotImplementedError

    def clear(self, annotation: CrashAnnotation) -> None:
        raise NotImplementedError


class CrashAnnotatorGuard:
    """lib.rs:795 — sets at creation, clears on exit."""

    def __init__(self, annotator: Optional[CrashAnnotator],
                 annotation: CrashAnnotation, value: str):
        self.annotator = annotator
        self.annotation = annotation
        if annotator is not None:
            annotator.set(annotation, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.annotator is not None:
            self.annotator.clear(self.annotation)
        return False
