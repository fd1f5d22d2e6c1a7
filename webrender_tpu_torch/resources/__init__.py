"""Resources layer — `resource_cache.rs` / `texture_cache.rs` equivalents."""
from .atlas import AtlasRegion, FrameAtlas, ShelfAllocator
from .fonts import RecordingFontContext, ReplayFontContext
from .resource_cache import (ATLAS_ALPHA, ATLAS_COLOR, ATLAS_SURFACE,
                             CachedGlyph, DeferredFontContext, FontContext,
                             ImageTemplate, PendingUpload, ResourceCache)
