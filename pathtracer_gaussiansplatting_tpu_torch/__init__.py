"""PyTorch + CUDA port of the Gaussian-splatting path tracer.

A second package beside the JAX reference ``pathtracer_gaussiansplatting_tpu``.
It keeps the reference's module layout and function names, so each
counterpart is found by path, and imports ``torch`` and numpy, never jax.
The per-tile compositing kernels are hand-written CUDA for Hopper
(``csrc/tile_composite_fwd.cu`` and its backward
``csrc/tile_composite_bwd.cu``), built at first use by ``csrc/build.py``.

Ported so far: the tile-binned primary render (slice A) —
``render.tiled.prepare_tiles`` -> ``render.tiled.render_prepared`` ->
``render.pathtrace.accumulate`` — and the math it runs on; and training
through it (slice E, tiled path): ``parallel.train.fit_scene_tiled``.
"""

__version__ = "0.1.0"
