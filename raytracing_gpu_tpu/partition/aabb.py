"""Axis-aligned bounding boxes.

Reference: gpu/partitioning/aabb.cu — per-object AABBs via either a
1-thread-per-object loop (aabb.cu:10-38) or a triangle-parallel pass with
shared-memory float atomics and a binary search for the owning object
(aabb.cu:76-145). Here both strategies are one `segment_min`/`segment_max`
over the triangle vertex array keyed by `tri_obj` — deterministic, no
atomics. The slab test (aabb.cu:202-243) becomes branch-free min/max
select chains that vectorize over (rays x boxes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The reference seeds per-object min/max at +/-1000 (aabb.cu:15-16), i.e. it
# assumes scenes fit in [-1000, 1000]^3. We seed at +/-inf instead (correct
# for any scene); padding objects end up with an empty (inf, -inf) box that
# can never be hit.
_INF = jnp.inf


def compute_object_aabbs(vertices, tri_obj, valid, n_objects: int):
    """Per-object AABBs from the triangle soup.

    vertices: (T,3,3); tri_obj: (T,) int32; valid: (T,) bool.
    Returns (O,2,3): [:,0] = min corner, [:,1] = max corner.
    """
    vmin = jnp.where(valid[:, None, None], vertices, _INF).min(axis=1)  # (T,3)
    vmax = jnp.where(valid[:, None, None], vertices, -_INF).max(axis=1)
    omin = jax.ops.segment_min(vmin, tri_obj, num_segments=n_objects)
    omax = jax.ops.segment_max(vmax, tri_obj, num_segments=n_objects)
    return jnp.stack([omin, omax], axis=1)


def compute_scene_aabb(obj_aabbs, obj_valid):
    """Global scene bounds — find_scene_scale (octree.cu:51-115) without the
    init race SURVEY §5 notes (thread 0's seed vs concurrent atomics)."""
    mins = jnp.where(obj_valid[:, None], obj_aabbs[:, 0], _INF).min(axis=0)
    maxs = jnp.where(obj_valid[:, None], obj_aabbs[:, 1], -_INF).max(axis=0)
    return jnp.stack([mins, maxs], axis=0)  # (2,3)


def hit_aabb(origins, dirs, boxes):
    """Branch-free slab test, batched (R rays) x (B boxes) -> (R,B) bool.

    Semantics of aabb.cu:202-243 (scratchapixel slab: swap per axis, overlap
    of [tmin,tmax] intervals; intersections behind the origin count as hits
    there too, so no t>0 clamp here). Conservative at degenerate axes:
    a zero direction component is nudged to 1e-30 so origin-on-plane rays
    produce hits instead of NaN-driven false culls.
    """
    d = dirs[:, None, :]  # (R,1,3)
    d = jnp.where(d == 0.0, 1e-30, d)
    inv = 1.0 / d
    o = origins[:, None, :]
    t1 = (boxes[None, :, 0, :] - o) * inv  # (R,B,3)
    t2 = (boxes[None, :, 1, :] - o) * inv
    tmin = jnp.minimum(t1, t2).max(axis=-1)
    tmax = jnp.maximum(t1, t2).min(axis=-1)
    return tmax >= tmin


def hit_aabb_forward(origins, dirs, boxes):
    """Slab test restricted to the forward half-line (t >= 0) — used for
    CULLING only, where it is strictly tighter than `hit_aabb` yet still
    conservative: every accepted triangle hit has t > 0 (dist > self-hit
    epsilon, cpu/hit.c:59), so a box whose ray interval lies entirely behind
    the origin cannot contain one. Boxes behind the ray are the common case
    for shadow and bounce rays leaving a surface."""
    d = dirs[:, None, :]  # (R,1,3)
    d = jnp.where(d == 0.0, 1e-30, d)
    inv = 1.0 / d
    o = origins[:, None, :]
    t1 = (boxes[None, :, 0, :] - o) * inv  # (R,B,3)
    t2 = (boxes[None, :, 1, :] - o) * inv
    tmin = jnp.minimum(t1, t2).max(axis=-1)
    tmax = jnp.maximum(t1, t2).min(axis=-1)
    return (tmax >= tmin) & (tmax >= 0.0)
