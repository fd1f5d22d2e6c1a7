"""Scene building layer — the `scene_building.rs` / `scene.rs` equivalent."""
from .clip import ClipKind, ClipNode, ClipStore
from .prims import (
    BackdropFilterPrim, BoxShadowPrim, ClearPrim, CompositeOps,
    ConicGradientPrim, ImagePrim, LineDecorationPrim, LinearGradientPrim,
    NinePatchBorderPrim, NormalBorderPrim, PicturePrim, PrimCommon,
    RadialGradientPrim, RectanglePrim, TextRunPrim, YuvImagePrim,
)
from .scene import BuiltScene, Scene
from .scene_builder import SceneBuilder, build_scene
from .spatial_tree import SceneSpatialTree, SpatialNodeKind
