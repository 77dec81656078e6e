"""Multi-host rendering: the same sharded program over several hosts.

The reference has no distributed backend at all (SURVEY §2.5 — its only
transport is cudaMemcpy host↔device, gpu/scene.cu:239-318). Here: one
process per host, `jax.distributed.initialize` to form the process group, a
single global `Mesh` over every device of every host, and the identical
`shard_map` render program on each host — XLA hands the collectives to the
devices' own links within a host and the network across hosts. The forward
pass needs no
cross-host collectives (rays are data-parallel; the scene is replicated);
training `psum`s scene-parameter gradients exactly as on one host.

Usage (same script launched on every host):

    from raytracing_gpu_tpu.parallel import multihost
    multihost.initialize()                  # no-op on a single host
    mesh = multihost.global_mesh(tiles=-1)  # all devices of all hosts
    img = multihost.render_scene_multihost(scene, cfg, mesh)  # full image,
                                            # identical on every host
"""

from __future__ import annotations

import warnings

import numpy as np

import jax

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.scene import Scene
from raytracing_gpu_tpu.parallel.mesh import SCENE, TILES
from raytracing_gpu_tpu.parallel.render import render_scene_sharded


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Form the multi-host process group (jax.distributed.initialize).

    No-op when the group is already initialized or when running single-
    process (the common local case). Where no cluster environment tells
    JAX the group (a GPU host as a rule), pass coordinator_address,
    num_processes and process_id explicitly.

    Ordering: `jax.distributed.initialize` MUST run before anything that
    initializes the local backend (jax.devices/process_count/...), so this
    probes the coordination client directly instead of calling a backend-
    touching API first.
    """
    if _distributed_client_active():
        return  # process group already formed
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        if "already initialized" in str(e).lower():
            return
        if coordinator_address is not None or num_processes not in (None, 1):
            raise  # an explicit multi-process request must not degrade
        # No coordinator configured anywhere -> genuine single-process run.
        warnings.warn(
            f"multihost.initialize: no process group formed ({e}); "
            "continuing single-process with local devices only"
        )


def _distributed_client_active() -> bool:
    """True iff jax.distributed.initialize already ran in this process.

    Reads jax's distributed global state (no public API exists); never
    touches a backend-initializing call.
    """
    try:
        from jax._src import distributed as _distributed

        return _distributed.global_state.client is not None
    except Exception:
        return False


def global_mesh(tiles: int = -1, scene_shards: int = 1):
    """A (tiles, scene) Mesh over every device of every host.

    tiles=-1 uses all devices divided by scene_shards. Device order is
    jax.devices() — process-major, so contiguous tile blocks land on one
    host and the final image gather crosses hosts only once per host block.
    """
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    if tiles == -1:
        if len(devs) % scene_shards:
            raise ValueError(
                f"{len(devs)} devices not divisible by scene={scene_shards}"
            )
        tiles = len(devs) // scene_shards
    need = tiles * scene_shards
    if need > len(devs):
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(devs[:need].reshape(tiles, scene_shards), (TILES, SCENE))


def render_scene_multihost(scene_host: Scene, cfg: RenderConfig,
                           mesh) -> np.ndarray:
    """Render over a (possibly multi-host) mesh; every process returns the
    full image.

    Single-host meshes take the fully-addressable fast path. Multi-host,
    each process computes its addressable tile rows and the full image is
    assembled with `process_allgather` (one cross-host gather of the final
    pixels —
    the only cross-host traffic in the whole forward pass).
    """
    if jax.process_count() == 1:
        return render_scene_sharded(scene_host, cfg, mesh)
    from jax.experimental import multihost_utils

    img = render_scene_sharded(scene_host, cfg, mesh, to_host=False)
    return np.asarray(multihost_utils.process_allgather(img, tiled=True))
