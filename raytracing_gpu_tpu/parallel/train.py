"""Differentiable inverse rendering: the framework's training step.

The reference is forward-only; the BASELINE north star adds the backward
pass: pixel gradients flowing to vertex positions, normals, material colors
and light parameters, with scene-parameter gradients all-reduced via `psum`
across the ray-tile mesh axis (the renderer analog of data-parallel gradient
sync). This module provides:

- `extract_params` / `insert_params`: the differentiable leaf set as a flat
  dict (vertices, normals, lights, Phong coefficients, camera).
- `make_train_step(mesh, cfg, ...)`: a jitted step
  (TrainState, coords, target) -> (TrainState, loss) where the loss/grad is
  computed under `shard_map` (rays over "tiles", triangles over "scene") and
  the optimizer update runs on the sharded grads (optax; vertex/normal grads
  stay sharded on their owning chip, replicated-param grads are psum'd over
  tiles and remain replicated).

Gradient correctness notes:
- total loss L = sum over tiles of L_tile; each device computes
  d(L_tile)/d(params) locally, then a single psum over "tiles" forms dL.
  Vertex/normal grads are per-scene-shard (each chip owns its triangle
  range); the transpose of the hit-combine all_gather routes their
  cotangents home automatically.
- The shadow `pmin` carries no gradient (occlusion is consumed as a
  boolean), matching the piecewise-constant nature of hard shadows.
- quantize="smooth" is required: "match" clamps at every op and zeroes
  gradients wherever any intermediate saturates (cpu/colors.c:3-22).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.scene import Camera, Scene
from raytracing_gpu_tpu.ops import camera as camera_ops
from raytracing_gpu_tpu.parallel.mesh import SCENE, TILES
from raytracing_gpu_tpu.render import (
    _trace_chunked,
    required_depth,
    resolve_backend,
)

# PartitionSpec per parameter: triangle-indexed leaves live on the scene
# axis, everything else is replicated.
PARAM_SPECS = {
    "vertices": P(SCENE),
    "normals": P(SCENE),
    "lights_rgb": P(),
    "lights_v": P(),
    "ka": P(),
    "kd": P(),
    "ks": P(),
    "ns": P(),
    "nr": P(),
    "cam_position": P(),
    "cam_u": P(),
    "cam_v": P(),
    "cam_fov": P(),
}


def extract_params(scene: Scene) -> dict:
    return {
        "vertices": scene.geometry.vertices,
        "normals": scene.geometry.normals,
        "lights_rgb": scene.lights.rgb,
        "lights_v": scene.lights.v,
        "ka": scene.materials.ka,
        "kd": scene.materials.kd,
        "ks": scene.materials.ks,
        "ns": scene.materials.ns,
        "nr": scene.materials.nr,
        "cam_position": jnp.asarray(scene.camera.position, jnp.float32),
        "cam_u": jnp.asarray(scene.camera.u, jnp.float32),
        "cam_v": jnp.asarray(scene.camera.v, jnp.float32),
        "cam_fov": jnp.asarray(scene.camera.fov, jnp.float32),
    }


def insert_params(scene: Scene, p: dict) -> Scene:
    return dataclasses.replace(
        scene,
        camera=dataclasses.replace(
            scene.camera,
            position=p["cam_position"],
            u=p["cam_u"],
            v=p["cam_v"],
            fov=p["cam_fov"],
        ),
        lights=dataclasses.replace(scene.lights, rgb=p["lights_rgb"], v=p["lights_v"]),
        geometry=dataclasses.replace(
            scene.geometry, vertices=p["vertices"], normals=p["normals"]
        ),
        materials=dataclasses.replace(
            scene.materials,
            ka=p["ka"], kd=p["kd"], ks=p["ks"], ns=p["ns"], nr=p["nr"],
        ),
    )


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: Any
    step: Any


jax.tree_util.register_pytree_node(
    TrainState,
    lambda s: ((s.params, s.opt_state, s.step), None),
    lambda _, c: TrainState(*c),
)


def predict_pixels(scene: Scene, cfg: RenderConfig, depth: int, coords,
                   scene_axis=None):
    """(R/4, 3) pixel colors in [0,1] — the EXACT prediction the training
    loss compares against its target (camera rays -> smooth trace ->
    2x2-subsample mean, no final clamp). Exposed so callers can build
    self-consistent targets: a target generated here at the true parameters
    makes the MSE's global minimum exactly the true parameters, which a
    finalize()-clamped render does not (saturated pixels clamp in the image
    but not in this prediction — measured as a 1.4e-2 loss floor on
    spheres)."""
    u, v, C = camera_ops.camera_basis(scene.camera)
    origins, dirs = camera_ops.make_rays(
        u, v, C, jnp.asarray(scene.camera.position, jnp.float32), coords)
    colors = _trace_chunked(scene, origins, dirs, cfg, depth, unroll=True,
                            scene_axis=scene_axis)
    return colors.reshape(-1, 4, 3).mean(axis=1)


def _blur_residual(err, n_pixels: int, sigma: float):
    """Separable gaussian blur of a per-pixel residual (n_pixels, 3) laid
    out as a row-major square image — an optional low-pass weighting of
    the image loss (de-emphasizes single-pixel residuals relative to
    broad-area shading error). Blur is linear, so blur(pred) -
    blur(target) == blur(pred - target) and the minimum stays exactly at
    residual == 0 (the true parameters for self targets).

    What it does NOT do (measured, round 5): restore gradients across hard
    visibility boundaries. The rendered image is itself piecewise-constant
    in silhouette/shadow-edge POSITION (hard winner selection), and
    blurring downstream of a discontinuous function cannot create a
    derivative that isn't there — vertex-position recovery on spheres
    diverges identically with and without blur. Boundary gradients need
    renderer-level softening (soft rasterization / edge sampling), which
    is out of scope for reference parity; see README "differentiability
    boundaries"."""
    import numpy as _np

    H = W = int(round(n_pixels ** 0.5))
    if H * W != n_pixels:
        raise ValueError("loss_blur needs a square image "
                         f"(n_pixels={n_pixels})")
    r = max(1, int(round(3.0 * sigma)))
    x = _np.arange(-r, r + 1, dtype=_np.float32)
    k = _np.exp(-0.5 * (x / sigma) ** 2)
    k = jnp.asarray(k / k.sum())
    img = err.reshape(H, W, 3)

    def conv(a, axis):
        pad = [(0, 0)] * 3
        pad[axis] = (r, r)
        ap = jnp.pad(a, pad, mode="edge")
        out = jnp.zeros_like(a)
        for i in range(2 * r + 1):  # static unroll, ~9 shifted adds
            sl = [slice(None)] * 3
            sl[axis] = slice(i, i + a.shape[axis])
            out = out + k[i] * ap[tuple(sl)]
        return out

    return conv(conv(img, 0), 1).reshape(-1, 3)


def _loss_and_grads_fn(mesh, cfg: RenderConfig, depth: int, n_pixels: int,
                       loss_blur: float = 0.0):
    """Per-device loss+grad under shard_map; psum over tiles inside."""
    scene_axis = SCENE if mesh.shape[SCENE] > 1 else None
    cfg = resolve_backend(cfg)
    if loss_blur > 0.0 and mesh.shape[TILES] > 1:
        raise ValueError("loss_blur requires tiles=1 (the blur window "
                         "would straddle tile-shard boundaries)")

    def device_fn(params, fixed_geo, fixed_rest, coords, target):
        def local_loss(params):
            fixed = dataclasses.replace(fixed_rest, geometry=fixed_geo)
            scene = insert_params(fixed, params)
            if cfg.partitioning != "none" and cfg.backend == "jnp":
                # rebuild the object-level accel from the CURRENT vertices
                # every step (the boxes would go stale as geometry moves);
                # stop_gradient: culling is a boolean, conservative pre-test
                # — no gradient flows through box coordinates. The kernel
                # backend needs nothing here: its pack (clustering +
                # tile AABBs + winner table) is rebuilt per step inside
                # _trace_chunked and the table IS differentiable.
                from raytracing_gpu_tpu.partition.apply import with_accel

                frozen = jax.tree_util.tree_map(jax.lax.stop_gradient,
                                                scene.geometry)
                acc, _ = with_accel(
                    dataclasses.replace(scene, geometry=frozen),
                    cfg.partitioning,
                )
                scene = dataclasses.replace(
                    scene,
                    geometry=dataclasses.replace(
                        scene.geometry,
                        obj_aabb=acc.geometry.obj_aabb,
                        octree=acc.geometry.octree,
                    ),
                )
            u, v, C = camera_ops.camera_basis(scene.camera)
            origins, dirs = camera_ops.make_rays(
                u, v, C, params["cam_position"], coords
            )
            colors = _trace_chunked(
                scene, origins, dirs, cfg, depth, unroll=True,
                scene_axis=scene_axis,
            )  # (r,3) in the smooth linear [0,1] domain (ops/colors.py)
            # 2x2 subsample box average -> pixels (r/4,3), like the CPU
            # writeout; target must be in the same [0,1] units
            pred = colors.reshape(-1, 4, 3).mean(axis=1)
            err = pred - target
            if loss_blur > 0.0:
                err = _blur_residual(err, n_pixels, loss_blur)
            return jnp.sum(err * err)

        loss, grads = jax.value_and_grad(local_loss)(params)
        # global loss & gradient: sum tile contributions (dp-style psum);
        # scene-sharded grads stay local to their owning shard
        loss = jax.lax.psum(loss, TILES) / (3.0 * n_pixels)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, TILES) / (3.0 * n_pixels), grads
        )
        return loss, grads

    return jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(PARAM_SPECS, P(SCENE), P(), P(TILES), P(TILES)),
        out_specs=(P(), PARAM_SPECS),
        check_vma=False,
    )


def _state_shardings(mesh, state):
    """NamedSharding pytree for a TrainState on `mesh`: leaves living inside
    a param dict (the params themselves and any optimizer slots mirroring
    them, e.g. adam's mu/nu) follow PARAM_SPECS; every other leaf (step,
    optimizer counters) is replicated — exactly the shardings step_fn's
    outputs carry (shard_map out_specs + elementwise optimizer update)."""
    from jax.tree_util import DictKey, tree_map_with_path

    shapes = {k: jnp.shape(v) for k, v in state.params.items()}

    def spec(path, leaf):
        for k in reversed(path):
            if isinstance(k, DictKey) and k.key in PARAM_SPECS:
                # shape must match the param: optimizer wrappers also nest
                # scalar counters under param-named label keys
                # (optax.multi_transform), which must stay replicated
                if jnp.shape(leaf) == shapes[k.key]:
                    return NamedSharding(mesh, PARAM_SPECS[k.key])
                break
        return NamedSharding(mesh, P())

    return tree_map_with_path(spec, state)


def make_train_step(mesh, cfg: RenderConfig, scene: Scene, optimizer=None,
                    learning_rate: float = 1e-2, loss_blur: float = 0.0):
    """Build (init_state, step_fn) for inverse rendering on `scene`'s
    structure.

    step_fn(state, fixed_geo, fixed_rest, coords, target) -> (state, loss)
      coords: (R,2) subpixel plane coords, R divisible by 4*n_tiles
      target: (R/4,3) target pixel colors in [0,1]
    """
    if cfg.quantize != "smooth":
        raise ValueError("training requires quantize='smooth' (match mode "
                         "clamps at every op and kills gradients)")
    optimizer = optimizer or optax.adam(learning_rate)
    import numpy as _np

    max_nr = float(_np.max(_np.asarray(scene.materials.nr)))
    depth = required_depth(max_nr, cfg.reflect_cutoff, cfg.diff_max_depth)

    def init_state(params):
        # Commit every leaf to the exact NamedSharding step_fn's outputs
        # carry. Without this the first step_fn call compiles against the
        # fresh state's uncommitted single-device placements and the SECOND
        # call (fed step 1's committed, sharding-annotated outputs) missed
        # the jit cache — a hidden full recompile (~50 s at 256²) every API
        # user paid silently (the round-3 bench even amortized it into its
        # reps, recording 6,354 ms/step for a ~175 ms step). With committed
        # inputs, calls 1..n share ONE compile
        # (tests/test_parallel.py::test_train_step_single_compile).
        state = TrainState(params=params, opt_state=optimizer.init(params),
                           step=jnp.zeros((), jnp.int32))
        return jax.device_put(state, _state_shardings(mesh, state))

    @functools.partial(jax.jit, static_argnames=("n_pixels",))
    def step_fn(state, fixed_geo, fixed_rest, coords, target, n_pixels):
        # any caller-attached accel is stripped (it cannot be sharded with
        # the triangle arrays and would go stale as vertices move); the
        # per-step rebuild inside device_fn replaces it
        fixed_geo = dataclasses.replace(fixed_geo, obj_aabb=None,
                                        octree=None)
        loss, grads = _loss_and_grads_fn(mesh, cfg, depth, n_pixels,
                                         loss_blur)(
            state.params, fixed_geo, fixed_rest, coords, target
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return init_state, step_fn


def init_train_state(scene: Scene, optimizer=None, learning_rate: float = 1e-2):
    optimizer = optimizer or optax.adam(learning_rate)
    params = extract_params(scene)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=jnp.zeros((), jnp.int32))
