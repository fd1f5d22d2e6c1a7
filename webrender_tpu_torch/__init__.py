"""webrender_tpu_torch — the PyTorch/CUDA port of webrender_tpu.

The port carries its own host layers (display lists and transactions,
scene and frame building, resources, profiler), copied from the JAX
package with the same layout, and its own device side: the renderer
holds its atlases as torch tensors, rasters through a hand-written CUDA
tile kernel (`csrc/tile_raster.cu`) and runs the offscreen passes as
torch ops.  It imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"
