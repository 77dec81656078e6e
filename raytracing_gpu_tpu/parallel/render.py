"""Sharded forward rendering: rays over the "tiles" axis, triangles over the
"scene" axis.

This is the JAX replacement for the reference's 4-pthread quadrant fan-out
(cpu/raytracer.c:92-127) and per-pixel CUDA grid (gpu/raytracer.cu:198-205).
The forward pass needs no collectives on the tiles axis at all (the final
image assembly is a reshard XLA handles); with scene sharding each bounce
combines per-shard nearest hits via a small `all_gather`
(ops/intersect.py:_combine_shard_hits).

Rays are sharded in contiguous blocks (horizontal image bands). Unlike the
reference's 4 fixed quadrants there is no per-thread recursion-depth
divergence to amplify stragglers: every device runs the same masked bounce
iterations, and the early-exit while_loop bounds the gap between light and
heavy bands to the longest surviving reflection path per band.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.scene import Geometry, Scene, scene_to_device
from raytracing_gpu_tpu.ops import camera as camera_ops
from raytracing_gpu_tpu.parallel.mesh import SCENE, TILES
from raytracing_gpu_tpu.render import (
    _trace_chunked,
    assemble_cpu_image,
    assemble_gpu_image,
    required_depth,
)


def split_scene(scene: Scene):
    """(geometry, scene-without-geometry) — lets `shard_map` in_specs place
    the triangle arrays with a single P(SCENE) prefix while the rest of the
    scene pytree is replicated with P()."""
    return scene.geometry, dataclasses.replace(scene, geometry=None)


def check_shardable(scene: Scene, mesh) -> None:
    n_scene = mesh.shape[SCENE]
    T = scene.geometry.vertices.shape[0]
    if T % n_scene:
        raise ValueError(
            f"padded triangle count {T} not divisible by scene axis {n_scene}; "
            f"raise RenderConfig.pad_triangles to a multiple of {n_scene}"
        )


@functools.lru_cache(maxsize=32)
def _build_tile_tracer(mesh, cfg: RenderConfig, depth: int, gpu_semantics: bool,
                       accel_sig: tuple):
    scene_axis = SCENE if mesh.shape[SCENE] > 1 else None
    unroll = cfg.resolve_unroll()
    has_aabb, has_node = accel_sig
    geo_spec = Geometry(
        vertices=P(SCENE), normals=P(SCENE), tri_obj=P(SCENE), valid=P(SCENE),
        obj_aabb=P() if has_aabb else None,
        # P() is a pytree-prefix: the whole NodeCull subtree is replicated
        octree=P() if has_node else None,
    )

    def tile_fn(geo, rest, coords):
        scene = dataclasses.replace(rest, geometry=geo)
        u, v, C = camera_ops.camera_basis(scene.camera)
        pos = jnp.asarray(scene.camera.position, jnp.float32)
        origins, dirs = camera_ops.make_rays(u, v, C, pos, coords)
        return _trace_chunked(scene, origins, dirs, cfg, depth, unroll,
                              scene_axis, gpu_semantics)

    return jax.shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=(geo_spec, P(), P(TILES)),
        out_specs=P(TILES),
        check_vma=False,
    )


@functools.partial(
    jax.jit, static_argnames=("mesh", "cfg", "depth", "width", "height")
)
def _render_sharded(geo, rest, coords, mesh, cfg, depth, width, height):
    n_tiles = mesh.shape[TILES]
    gpu = cfg.mode == "gpu"
    R = coords.shape[0]
    pad = (-R) % n_tiles
    if pad:
        coords = jnp.concatenate([coords, jnp.zeros((pad, 2), coords.dtype)])
    accel_sig = (geo.obj_aabb is not None, geo.octree is not None)
    colors = _build_tile_tracer(mesh, cfg, depth, gpu, accel_sig)(geo, rest, coords)[:R]
    if gpu:
        return assemble_gpu_image(colors, cfg, width, height)
    return assemble_cpu_image(colors, cfg, width, height)


def make_sharded_renderer(mesh, cfg: RenderConfig, depth: int, width: int, height: int):
    """A jitted (geo, rest, coords) -> (H,W,3) renderer bound to a mesh."""
    return functools.partial(
        _render_sharded, mesh=mesh, cfg=cfg, depth=depth, width=width, height=height
    )


def render_scene_sharded(scene_host: Scene, cfg: RenderConfig, mesh,
                         to_host: bool = True):
    """Multi-device `render_scene`: same semantics, sharded over `mesh`.

    to_host=False returns the (possibly non-addressable) global device
    array instead of a NumPy copy — required on multi-host meshes, where
    parallel.multihost gathers it across processes instead."""
    width, height = scene_host.camera.width, scene_host.camera.height
    scene = scene_to_device(scene_host)
    if cfg.partitioning != "none":
        from raytracing_gpu_tpu.partition.apply import with_accel

        scene, _ = with_accel(scene, cfg.partitioning)
    check_shardable(scene, mesh)
    max_nr = float(np.max(np.asarray(scene_host.materials.nr)))
    if cfg.mode == "cpu":
        cap = cfg.diff_max_depth if cfg.quantize == "smooth" else cfg.cpu_max_depth
        depth = required_depth(max_nr, cfg.reflect_cutoff, cap)
        coords = jnp.asarray(camera_ops.cpu_subpixel_coords(width, height)).reshape(-1, 2)
    else:
        depth = 0
        hw, hh = width * cfg.aliasing, height * cfg.aliasing
        # hi-res camera for the basis (gpu/rt.cpp:78-79) — see _render_gpu_mode
        scene = dataclasses.replace(
            scene, camera=dataclasses.replace(scene.camera, width=hw, height=hh)
        )
        coords = jnp.asarray(camera_ops.gpu_pixel_coords(hw, hh)).reshape(-1, 2)
    geo, rest = split_scene(scene)
    img = _render_sharded(geo, rest, coords, mesh, cfg, depth, width, height)
    return np.asarray(img) if to_host else img
