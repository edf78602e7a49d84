"""PyTorch + CUDA port of the Gaussian-splatting path tracer.

A second package beside the JAX reference ``pathtracer_gaussiansplatting_tpu``.
It keeps the reference's module layout and function names, so each
counterpart is found by path, and imports ``torch`` and numpy, never jax.
The per-tile compositing kernels are hand-written CUDA for Hopper
(``csrc/tile_composite_fwd.cu`` and its backward
``csrc/tile_composite_bwd.cu``), built at first use by ``csrc/build.py``.

Ported so far: the tile-binned primary render (slice A) —
``render.tiled.prepare_tiles`` -> ``render.tiled.render_prepared`` ->
``render.pathtrace.accumulate`` — and the math it runs on; training
through it (slice E, tiled path): ``parallel.train.fit_scene_tiled``; path
tracing on the dense and grid backends (slices B and C,
``render.pathtrace``, ``render.pipeline``); and the dataset capture
(slice D): ``data.capture.capture_scene_data`` and ``capture_panorama``
with the torus sensor, the sampling strategies and the PLY, transforms and
checkpoint files; and the command line with what it loads (slice G):
``python -m pathtracer_gaussiansplatting_tpu_torch.cli`` (render,
capture-dataset, panorama, fit, view-pointcloud, interact; ``--device``,
the card by default) over scene configs (``utils.config``,
``models.scene.load_scene_from_config``) of 3DGS checkpoints
(``data.ply``), glTF meshes with baked textures (``data.gltf``,
``data.textures``), builtin scenes, an rtbox and lights, with the dense
``parallel.train.fit_scene``, ``render.points`` and
``render.session``.
"""

__version__ = "0.1.0"
