"""PyTorch + CUDA port of the Gaussian-splatting path tracer.

A second package beside the JAX reference ``pathtracer_gaussiansplatting_tpu``.
It keeps the reference's module layout and function names, so each
counterpart is found by path, and imports ``torch`` and numpy, never jax.
The hot per-tile compositing kernel is hand-written CUDA for Hopper
(``csrc/tile_composite_fwd.cu``), built at first use by ``csrc/build.py``.

Ported so far (slice A): the tile-binned primary render —
``render.tiled.prepare_tiles`` -> ``render.tiled.render_prepared`` ->
``render.pathtrace.accumulate`` — and the math it runs on.
"""

__version__ = "0.1.0"
