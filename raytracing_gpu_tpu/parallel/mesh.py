"""Device mesh construction.

The mesh always has two named axes ("tiles", "scene"); either may have size 1.
On several hosts, `jax.distributed.initialize()` (called by the user or
launcher before anything else) makes `jax.devices()` span all hosts and the
same mesh code spans them. The axes follow the algorithm, not a network
shape: the cards of one host reach each other at the same rate. This
replaces the reference's only cross-device plumbing,
host<->device cudaMemcpy (gpu/scene.cu:239-318).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

TILES = "tiles"
SCENE = "scene"


def make_mesh(n_tiles: int, n_scene: int = 1, devices=None) -> Mesh:
    """Mesh of shape (n_tiles, n_scene) with axes ("tiles", "scene")."""
    devices = list(jax.devices()) if devices is None else list(devices)
    need = n_tiles * n_scene
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(n_tiles, n_scene)
    return Mesh(arr, (TILES, SCENE))


def default_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Factor n devices into (tiles, scene): scene gets 2 when n is even and
    >= 4 (so large scenes fit per-device memory while most devices do ray
    work),
    otherwise everything goes to the tiles axis."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices) if n_devices is None else n_devices
    n_scene = 2 if (n >= 4 and n % 2 == 0) else 1
    return make_mesh(n // n_scene, n_scene, devices[:n])
