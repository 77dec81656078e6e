"""Acceleration structures — the L3 ("partitioning") layer in XLA.

The reference's gpu/partitioning/ is ~1,290 LoC of CUDA: float atomics,
shared-memory Blelloch scans, a 2-bit LSD radix sort and a stackful octree
DFS (SURVEY §2.3). Here every one of those collapses into an XLA
primitive the compiler already knows how to tile:

| reference kernel                     | here                               |
|--------------------------------------|------------------------------------|
| object/triangle AABB + float atomics | `segment_min`/`segment_max`        |
| find_scene_scale_{basic,shared}      | `jnp.min`/`jnp.max` reductions     |
| position_object key packing          | vectorized bit twiddling           |
| parallel_radix_sort (sort.tuh)       | `jnp.argsort` (XLA stable sort)    |
| shared_prefix_sum (Blelloch)         | `jnp.cumsum`                       |
| nodes_difference + create_octree     | common-prefix compare + searchsorted|
| stackful DFS traversal (gpu/hit.cu)  | flat node/object mask tests        |

The octree is materialized as flat index tables (node_box, node_range,
node_children) — static-shape, mask-validated, fully jit-compatible.
"""

from raytracing_gpu_tpu.partition.aabb import (
    compute_object_aabbs,
    compute_scene_aabb,
    hit_aabb,
)
from raytracing_gpu_tpu.partition.octree import Octree, build_octree, position_keys

__all__ = [
    "compute_object_aabbs",
    "compute_scene_aabb",
    "hit_aabb",
    "Octree",
    "build_octree",
    "position_keys",
]
