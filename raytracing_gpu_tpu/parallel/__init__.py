"""Multi-device / multi-host scaling — the JAX replacement for the
reference's intra-host parallelism (4 pthreads over image quadrants,
cpu/raytracer.c:92-127; one CUDA thread per pixel, gpu/raytracer.cu:198-205).

Two mesh axes (SURVEY §2.5 / §5 "long-context" analog):

- ``tiles`` — data parallelism over rays/pixel tiles. Embarrassingly parallel
  forward; the only collective is the `psum` of scene-parameter gradients in
  the backward pass of the training step.
- ``scene`` — the model/sequence-parallel analog: the triangle arrays are
  sharded over devices (each owns a contiguous triangle range), nearest
  hits combine with an `all_gather` + first-occurrence argmin and shadow
  distances with a `pmin`. This is what lets scenes larger than one
  device's memory render at all — the reference has no equivalent (every
  CUDA thread reads the whole scene).
"""

from raytracing_gpu_tpu.parallel.mesh import make_mesh, default_mesh
from raytracing_gpu_tpu.parallel.render import render_scene_sharded, make_sharded_renderer
from raytracing_gpu_tpu.parallel.train import (
    TrainState,
    extract_params,
    insert_params,
    make_train_step,
    init_train_state,
)

__all__ = [
    "make_mesh",
    "default_mesh",
    "render_scene_sharded",
    "make_sharded_renderer",
    "TrainState",
    "extract_params",
    "insert_params",
    "make_train_step",
    "init_train_state",
]
