"""raytracing_gpu_tpu — a differentiable Whitted-style ray tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
blink97/raytracing-gpu (a CUDA/C triangle-mesh ray tracer):

- `.svati` scene parsing (camera + ambient/directional/point lights +
  triangle-soup objects with Phong materials), reference grammar and quirks
  reproduced exactly (see /root/reference/cpu/parser.c, cpu/parse_obj.c).
- Primary-ray generation, Möller–Trumbore intersection, Phong shading with
  hard shadows and mirror reflections — batched, mask-predicated, static-shape
  JAX programs that XLA compiles for the GPU (or the CPU).
- Acceleration structures (AABB / flat octree) built with scans, sorts and
  segment reductions instead of the reference's atomics + radix-sort kernels.
- A Pallas (Triton) sweep kernel for the intersection hot loop on the GPU.
- Differentiable rendering: pixel gradients flow to vertices, normals,
  materials and lights; `smooth` color mode avoids the reference's
  clamp-at-every-op quantization while `match` mode reproduces it bit-for-bit.
- Multi-device scaling via `jax.sharding.Mesh` + `shard_map` over a ray-tile
  axis, with scene replicated per device and `psum` for parameter gradients.
"""

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.scene import Scene, Camera, Lights, Geometry, Materials
from raytracing_gpu_tpu.models.parser import parse_scene, parse_scene_text
from raytracing_gpu_tpu.render import (
    SceneRenderer,
    render,
    render_image,
    render_scene,
)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "Camera",
    "Lights",
    "Geometry",
    "Materials",
    "parse_scene",
    "parse_scene_text",
    "render",
    "render_image",
    "render_scene",
    "SceneRenderer",
]
