"""Worker process for the 2-process localhost multihost test.

Launched twice by tests/test_multihost.py with a shared coordinator address;
each process owns 2 virtual CPU devices (4 global). This executes the REAL
multi-process code path — jax.distributed.initialize forming the group and
render_scene_multihost's process_allgather branch — which single-process
tests can never reach. Usage:

    python _multihost_worker.py <coordinator> <process_id> <out_prefix> \
        [backend]

backend (default "jnp") selects the intersection backend for BOTH the
render and the training step: "pallas" runs the sweep kernel path
(per-ray-tile worklists + octree tile hierarchy) across the real process
boundary (shard_map + jax.distributed collectives + Pallas kernels).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    backend = sys.argv[4] if len(sys.argv) > 4 else "jnp"

    import jax
    import numpy as np

    from raytracing_gpu_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=coord, num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, f"process_count={jax.process_count()}"
    assert len(jax.devices()) == 4, f"devices={len(jax.devices())}"

    from raytracing_gpu_tpu.config import RenderConfig
    from raytracing_gpu_tpu.models.procedural import make_sphere_scene

    scene = make_sphere_scene(width=16, height=16, n_lat=8, n_lon=12)
    cfg = RenderConfig(mode="cpu", quantize="match", ray_chunk=512,
                       backend=backend)
    mesh = multihost.global_mesh(tiles=4, scene_shards=1)
    img = multihost.render_scene_multihost(scene, cfg, mesh)
    np.save(f"{out}.{pid}.npy", np.asarray(img))

    # --- train ACROSS the process boundary: the gradient psum over a real
    # 2-process group. Same recipe as
    # tests/test_parallel.py::test_train_step, but the tiles axis spans both
    # processes, so every grad psum crosses the coordinator-formed group.
    losses, kd = _train_on_mesh(scene, mesh, backend=backend)
    np.savez(f"{out}.train.{pid}.npz", losses=np.asarray(losses), kd=kd)
    jax.distributed.shutdown()


def _train_on_mesh(scene, mesh, backend="jnp"):
    """4 masked-SGD steps recovering a perturbed kd; returns (losses, kd).

    Deterministic given (scene, mesh shape): both processes — and the
    single-process comparator in test_multihost.py — must produce identical
    results.
    """
    import jax.numpy as jnp
    import numpy as np
    import optax

    from raytracing_gpu_tpu.config import RenderConfig
    from raytracing_gpu_tpu.models.scene import scene_to_device
    from raytracing_gpu_tpu.ops import camera as camera_ops
    from raytracing_gpu_tpu.parallel.render import split_scene
    from raytracing_gpu_tpu.parallel.train import (
        PARAM_SPECS,
        extract_params,
        make_train_step,
    )
    from raytracing_gpu_tpu.render import render_scene

    W = H = 16
    cfg = RenderConfig(mode="cpu", quantize="smooth", ray_chunk=512,
                       diff_max_depth=2, backend=backend)
    dev = scene_to_device(scene)
    target_img = render_scene(scene, cfg) / 255.0  # local render, identical
    # in every process (same scene, same single-device program)
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
    for _ in range(4):
        state, loss = step_fn(state, geo, rest, jnp.asarray(coords),
                              jnp.asarray(target), W * H)
        losses.append(float(loss))
    return losses, np.asarray(state.params["kd"])


if __name__ == "__main__":
    main()
