"""Multi-chip sharding tests (8 virtual CPU devices via conftest).

The reference has no distributed tests (SURVEY §4 — nothing multi-node
exists); these validate that sharding is semantics-preserving: a render
sharded over (tiles, scene) must equal the single-device render bit-for-bit
(same reduction order per ray: each ray's triangle loop is just split into
contiguous shard ranges combined by first-occurrence argmin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.procedural import make_sphere_scene
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import camera as camera_ops
from raytracing_gpu_tpu.parallel import (
    extract_params,
    insert_params,
    make_mesh,
    make_train_step,
    render_scene_sharded,
)
from raytracing_gpu_tpu.parallel.render import split_scene
from raytracing_gpu_tpu.render import render_scene


@pytest.fixture(autouse=True)
def _eight_devices():
    # decided per test, not at import: every xdist worker must collect the
    # same tests (conftest gives the CPU 8 virtual devices)
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(width=16, height=16, n_lat=8, n_lon=12)


@pytest.mark.parametrize("tiles,shards", [(8, 1), (4, 2), (2, 4)])
def test_sharded_render_matches_single_device(scene, tiles, shards):
    cfg = RenderConfig(mode="cpu", quantize="match", ray_chunk=512)
    ref = render_scene(scene, cfg)
    mesh = make_mesh(tiles, shards)
    img = render_scene_sharded(scene, cfg, mesh)
    np.testing.assert_array_equal(np.trunc(ref), np.trunc(img))


@pytest.mark.parametrize("backend", ["pallas"])
@pytest.mark.parametrize("tiles,shards", [(8, 1), (4, 2)])
def test_sharded_render_kernel_backends(scene, backend, tiles, shards):
    """The Pallas kernel runs inside shard_map (per-device grids over
    the local ray block x local triangle shard) and must reproduce the
    single-device render of the SAME backend bit-for-bit: tile splitting is
    ray-axis chunking, scene splitting is the same first-occurrence argmin
    combine the jnp path uses."""
    cfg = RenderConfig(mode="cpu", quantize="match", ray_chunk=512,
                       backend=backend)
    ref = render_scene(scene, cfg)
    mesh = make_mesh(tiles, shards)
    img = render_scene_sharded(scene, cfg, mesh)
    np.testing.assert_array_equal(np.trunc(ref), np.trunc(img))


def test_sharded_gpu_mode_matches(scene):
    cfg = RenderConfig(mode="gpu", quantize="match", aliasing=2, ray_chunk=512)
    ref = render_scene(scene, cfg)
    mesh = make_mesh(4, 2)
    img = render_scene_sharded(scene, cfg, mesh)
    np.testing.assert_array_equal(np.trunc(ref), np.trunc(img))


def test_train_step_reduces_loss(scene):
    """Inverse rendering: recover a perturbed diffuse color with the other
    parameters frozen (optax.masked). Loss must drop and kd must move toward
    the true value."""
    import optax

    from raytracing_gpu_tpu.parallel.train import PARAM_SPECS

    W = H = 16
    cfg = RenderConfig(mode="cpu", quantize="smooth", ray_chunk=512,
                       diff_max_depth=2)
    dev = scene_to_device(scene)
    mesh = make_mesh(4, 2)

    # target = render of the TRUE scene in the smooth [0,1] domain
    target_img = render_scene(scene, dataclasses.replace(cfg)) / 255.0
    n_pixels = W * H
    coords = np.asarray(camera_ops.cpu_subpixel_coords(W, H)).reshape(-1, 2)
    target = np.asarray(target_img).reshape(-1, 3)

    # perturb: wrong diffuse on object 0
    params0 = extract_params(dev)
    params0["kd"] = params0["kd"].at[0].set(jnp.array([0.9, 0.9, 0.1]))

    # freeze everything but kd (masked passes unmasked grads through, so
    # zero them before the sgd scale)
    opt = optax.chain(
        optax.masked(optax.set_to_zero(), {k: k != "kd" for k in PARAM_SPECS}),
        optax.sgd(2.0),
    )
    init_state, step_fn = make_train_step(mesh, cfg, dev, optimizer=opt)
    state = init_state(params0)
    geo, rest = split_scene(dev)
    losses = []
    for _ in range(10):
        state, loss = step_fn(state, geo, rest, jnp.asarray(coords),
                              jnp.asarray(target), n_pixels)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 0.95, losses
    # kd moved toward the true value
    kd_err0 = float(jnp.abs(params0["kd"][0] - extract_params(dev)["kd"][0]).sum())
    kd_err1 = float(jnp.abs(state.params["kd"][0] - extract_params(dev)["kd"][0]).sum())
    assert kd_err1 < kd_err0


@pytest.mark.parametrize("backend,partitioning", [
    ("pallas", "octree"),  # kernel backend with hierarchical culling
    ("jnp", "octree"),     # jnp backend with per-step accel rebuild
])
def test_train_step_accelerated(scene, backend, partitioning):
    """Inverse rendering through ACCELERATED intersection paths: culling is
    conservative and the winner-table fetch is differentiable, so a train
    step with the pallas kernel + octree culling (and the jnp path with its
    per-step accel rebuild) must reduce the loss exactly like brute force."""
    import optax

    from raytracing_gpu_tpu.parallel.train import PARAM_SPECS

    W = H = 16
    cfg = RenderConfig(mode="cpu", quantize="smooth", ray_chunk=512,
                       diff_max_depth=2, backend=backend,
                       partitioning=partitioning)
    dev = scene_to_device(scene)
    mesh = make_mesh(4, 2)
    target_img = render_scene(scene, dataclasses.replace(cfg)) / 255.0
    coords = np.asarray(camera_ops.cpu_subpixel_coords(W, H)).reshape(-1, 2)
    target = np.asarray(target_img).reshape(-1, 3)

    params0 = extract_params(dev)
    params0["kd"] = params0["kd"].at[0].set(jnp.array([0.9, 0.9, 0.1]))
    opt = optax.chain(
        optax.masked(optax.set_to_zero(), {k: k != "kd" for k in PARAM_SPECS}),
        optax.sgd(2.0),
    )
    init_state, step_fn = make_train_step(mesh, cfg, dev, optimizer=opt)
    state = init_state(params0)
    geo, rest = split_scene(dev)
    losses = []
    for _ in range(6):
        state, loss = step_fn(state, geo, rest, jnp.asarray(coords),
                              jnp.asarray(target), W * H)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0] * 0.95, losses


def test_train_step_single_compile(scene):
    """init_state commits the fresh state to step_fn's output shardings, so
    the whole training loop compiles step_fn exactly ONCE: before the fix,
    call 2 (fed step 1's committed, sharding-annotated outputs) missed the
    jit cache and silently recompiled — ~50 s at 256² on the chip."""
    from jax._src import test_util as jtu

    W = H = 8
    cfg = RenderConfig(mode="cpu", quantize="smooth", ray_chunk=256,
                       diff_max_depth=2)
    dev = scene_to_device(scene)
    mesh = make_mesh(4, 2)
    coords = jnp.asarray(
        np.asarray(camera_ops.cpu_subpixel_coords(W, H)).reshape(-1, 2))
    target = jnp.zeros((W * H, 3), jnp.float32)
    init_state, step_fn = make_train_step(mesh, cfg, dev)
    state = init_state(extract_params(dev))
    geo, rest = split_scene(dev)
    # call 1 compiles step_fn (plus any eagerly-jitted helpers it calls);
    # every later call must add ZERO misses — before the fix, call 2 (fed
    # step 1's committed, sharding-annotated outputs) recompiled step_fn.
    misses = []
    for _ in range(3):
        with jtu.count_jit_compilation_cache_miss() as count:
            state, loss = step_fn(state, geo, rest, coords, target, W * H)
        misses.append(count())
    assert misses[0] >= 1, misses
    assert misses[1] == 0 and misses[2] == 0, misses
    assert np.isfinite(float(loss))


def test_vertex_grads_flow_through_scene_sharding(scene):
    """d(loss)/d(vertices) must be nonzero and finite with triangles sharded
    over the scene axis (exercises the all_gather transpose)."""
    W = H = 8
    s = make_sphere_scene(width=W, height=H, n_lat=6, n_lon=9)
    dev = scene_to_device(s)
    cfg = RenderConfig(mode="cpu", quantize="smooth", ray_chunk=256,
                       diff_max_depth=2)
    mesh = make_mesh(4, 2)
    coords = np.asarray(camera_ops.cpu_subpixel_coords(W, H)).reshape(-1, 2)
    target = np.zeros((W * H, 3), np.float32)

    init_state, step_fn = make_train_step(mesh, cfg, dev)
    state = init_state(extract_params(dev))
    geo, rest = split_scene(dev)
    state2, loss = step_fn(state, geo, rest, jnp.asarray(coords),
                           jnp.asarray(target), W * H)
    # Adam moves every param with nonzero grad; vertices should have moved
    dv = np.asarray(jnp.abs(state2.params["vertices"] - state.params["vertices"]).sum())
    assert np.isfinite(float(loss))
    assert dv > 0.0


def test_multihost_single_process_path(scene):
    """multihost wrappers degrade gracefully to single-process: initialize
    is a no-op, global_mesh covers the local devices, and the render equals
    the plain sharded render (true multi-host needs a pod; the program is
    identical by construction)."""
    from raytracing_gpu_tpu.parallel import multihost

    multihost.initialize()
    mesh = multihost.global_mesh(tiles=4, scene_shards=2)
    cfg = RenderConfig(mode="cpu", quantize="match", ray_chunk=512)
    img = multihost.render_scene_multihost(scene, cfg, mesh)
    ref = render_scene(scene, cfg)
    np.testing.assert_array_equal(np.trunc(ref), np.trunc(img))
