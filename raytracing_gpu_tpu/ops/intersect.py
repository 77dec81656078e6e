"""Batched Möller–Trumbore intersection and nearest-hit selection.

Batched recast of the reference's per-thread scalar loops:

- `ray_intersect` (cpu/hit.c:4-44, gpu/hit.cu:8-78): Möller–Trumbore with
  EPSILON=1e-7, returning hit point `origin + normalize(dir)*(t*|dir|)` and
  the barycentric-interpolated smooth normal over per-vertex-normalized
  normals (NOT renormalized after interpolation — downstream shading uses the
  unnormalized interpolated N, a load-bearing quirk).
- `triangle_collide`/`collide` (cpu/hit.c:46-91): nearest hit with strict
  `dist > 0.01` acceptance and first-strictly-smaller selection. Because the
  triangle arrays are stored object-major in the same iteration order as the
  reference, a flat first-occurrence argmin picks the identical winner.
- `collide_dist` (cpu/hit.c:93-109): nearest-hit distance only (shadow rays),
  returning 0.0 on miss (the reference's miss sentinel).

Instead of one CUDA thread per ray with an inner scalar triangle loop, every
(ray, triangle) pair is evaluated as rectangular [R, T] vector ops that XLA
fuses, and the winner is a masked argmin. Control flow (early-outs at
cpu/hit.c:21-31) becomes mask predication.

Known deviation (documented): the reference drops an *entire object* when its
nearest triangle's interpolated normal is exactly the zero vector
(vector3_is_zero test at cpu/hit.c:79); we drop only the individual triangle.
This requires an exact-zero interpolated normal to differ, which no corpus
scene triggers.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# plain float, NOT jnp.float32(...): a module-level jnp scalar would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize ordering in multi-process programs
INF = float("inf")


@dataclasses.dataclass
class Hit:
    """Nearest-hit result for a batch of R rays."""

    point: Any  # (R,3) hit point (garbage when ~mask)
    normal: Any  # (R,3) interpolated UNnormalized normal
    obj: Any  # (R,) int32 owning object index
    dist: Any  # (R,) distance |point - origin| (inf when ~mask)
    mask: Any  # (R,) bool — True if the ray hit anything
    mat: Any = None  # optional (R,11) [ka kd ks ns nr] of the winning
    # object, gathered with the winner row on the kernel backend


jax.tree_util.register_pytree_node(
    Hit,
    lambda h: ((h.point, h.normal, h.obj, h.dist, h.mask, h.mat), None),
    lambda _, c: Hit(*c),
)


def _cull_mask(origins, dirs, geometry):
    """(R,T) bool pair mask from the partitioning pre-tests, or None.

    AABB mode: slab test per object (gpu/hit.cu:96-101). Octree mode adds a
    top-down walk of the built node graph — breadth-first reachability
    through the parent links, the data-parallel recast of the stackful DFS
    at gpu/hit.cu:120-169 (see partition.octree.octree_object_reach).
    Conservative: culled objects cannot contain any accepted hit.
    """
    if geometry.obj_aabb is None:
        return None
    from raytracing_gpu_tpu.partition.aabb import hit_aabb

    ohit = hit_aabb(origins, dirs, geometry.obj_aabb)  # (R,O)
    if geometry.octree is not None:
        from raytracing_gpu_tpu.partition.octree import octree_object_reach

        ohit &= octree_object_reach(origins, dirs, geometry.octree)
    return ohit[:, geometry.tri_obj]  # (R,T)


def _mt_core(origins, dirs, vertices, normals, valid, mt_eps, self_hit_eps,
             pair_mask=None):
    """All-pairs Möller–Trumbore.

    origins/dirs: (R,3). vertices/normals: (T,3,3). valid: (T,) bool.
    pair_mask: optional (R,T) pre-cull mask (partitioning layer).
    Returns (dist[R,T], u[R,T], v[R,T], t[R,T], ok[R,T]) with dist=inf when
    not ok. Follows cpu/hit.c:4-70 arithmetic exactly.
    """
    # Componentwise with LEFT-ASSOCIATED dot products — the exact f32
    # rounding order of cpu/hit.c's vector3_dot ((x*x + y*y) + z*z).
    # jnp.cross/jnp.sum-based formulations let XLA pick the reduce
    # association, which under the catastrophic cancellation of near-seam
    # determinants shifted u by up to ~6e-4 relative (measured) and flipped
    # accept tests/winners on tessellation seams. Same layout as the Pallas
    # kernel (_mt_block): triangle components are (T,) columns, ray
    # components (R,1) rows, every intermediate an (R,T) plane.
    v0 = vertices[:, 0]  # (T,3)
    e1 = vertices[:, 1] - v0  # (T,3)
    e2 = vertices[:, 2] - v0
    v0x, v0y, v0z = v0[:, 0], v0[:, 1], v0[:, 2]  # (T,)
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    ox, oy, oz = origins[:, 0:1], origins[:, 1:2], origins[:, 2:3]  # (R,1)
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]

    # h = cross(d, e2)  (R,T)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = (e1x * hx + e1y * hy) + e1z * hz  # (R,T)
    ok = jnp.abs(a) >= mt_eps  # reject -eps < a < eps (cpu/hit.c:21-22)
    f = 1.0 / jnp.where(ok, a, 1.0)
    sx = ox - v0x  # (R,T)
    sy = oy - v0y
    sz = oz - v0z
    u = f * ((sx * hx + sy * hy) + sz * hz)
    ok &= (u >= 0.0) & (u <= 1.0)
    # q = cross(s, e1)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * ((dx * qx + dy * qy) + dz * qz)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * ((e2x * qx + e2y * qy) + e2z * qz)
    ok &= t > mt_eps  # cpu/hit.c:33

    # The reference computes out = origin + normalize(dir) * (t*|dir|)
    # (cpu/hit.c:36-38) and selects/accepts by dist = |out - origin|
    # (cpu/hit.c:57-59) — NOT by t*|dir|. The two differ by ~1 ulp, which
    # decides real winners: rays on a tessellation seam (e.g. the exact
    # center column of a left-right-symmetric scene) see the two adjacent
    # mirrored triangles at distances 0-1 ulp apart, and the reference's
    # formula frequently rounds them to an EXACT tie (first-occurrence then
    # picks the lower index). Selecting by t*|dir| instead produced a
    # systematic winner-flip stripe down the symmetry column (2-8 uint8
    # units, spheres 960x540 — tests/test_seam_tie.py).
    # So: reproduce the exact chain fl(o + nd*(t*|d|)) - o with left-
    # associated component sums, no shortcuts.
    # (zero-length dirs only occur on dead/masked ray lanes; guard keeps
    # them NaN-free so gradients can't be poisoned through jnp.where)
    dlen2 = (dx * dx + dy * dy) + dz * dz  # (R,1), left-assoc like the ref
    dlen = jnp.sqrt(jnp.where(dlen2 > 0.0, dlen2, 1.0))
    ndx, ndy, ndz = dx / dlen, dy / dlen, dz / dlen  # (R,1) f32 divides
    td = t * dlen  # (R,T)
    ddx = (ox + ndx * td) - ox
    ddy = (oy + ndy * td) - oy
    ddz = (oz + ndz * td) - oz
    dist = jnp.sqrt((ddx * ddx + ddy * ddy) + ddz * ddz)
    ok &= dist > self_hit_eps  # cpu/hit.c:59
    ok &= valid[None, :]
    if pair_mask is not None:
        ok &= pair_mask
    return jnp.where(ok, dist, INF), u, v, t, ok


def _pallas_nearest(origins, dirs, geometry, mt_eps, self_hit_eps,
                    pack=None, want_idx: bool = True,
                    partitioning: str = "octree"):
    """(wdist, win, pack) via the Pallas sweep kernel (+tile-level culling).

    want_idx=False runs the dist-only sweep (cheaper fold — the
    shadow/collide_dist path never consumes the winner index).
    partitioning selects the kernel-side culling structure (the runtime
    analog of the reference's PARTITIONING_* matrix on the GPU hot path):
    "none" = brute force, "aabb" = flat leaf-tile AABB tests, "octree" =
    coarse-to-fine morton-tile hierarchy (tile_cull_mask_hierarchical).

    AD barrier: the kernel only SELECTS (winner index + hit mask), both
    piecewise-constant in the inputs, so all inputs are stop_gradient'd
    here — reverse mode never differentiates through pallas_call. The
    differentiable values (u, v, t, dist, point, normal) are recomputed on
    the winner by the caller with plain jnp ops.
    """
    from raytracing_gpu_tpu.ops import pallas_intersect as pk

    origins = jax.lax.stop_gradient(origins)
    dirs = jax.lax.stop_gradient(dirs)

    # Spatial clustering: reorder triangles so each kernel tile is compact
    # and morton-ordered (the octree cell order the culling hierarchy is
    # built on). Computed once per render and passed in via `pack`; the
    # fallback here serves direct collide() calls.
    if pack is None:
        pack = pk.pack_geometry(geometry.vertices, geometry.valid,
                                geometry.normals, geometry.tri_obj)
    kpack = jax.tree.map(
        lambda x: None if x is None else jax.lax.stop_gradient(x), pack,
        is_leaf=lambda x: x is None,
    )
    op, dp, R = pk.pack_rays(origins, dirs)
    mask = pk.tile_cull_mask_hierarchical(op, dp, kpack, partitioning)
    if want_idx:
        dist, idx = pk.nearest_hit_pallas(op, dp, kpack.tri, mask,
                                          float(mt_eps), float(self_hit_eps))
    else:
        dist = pk.nearest_dist_pallas(op, dp, kpack.tri, mask, float(mt_eps),
                                      float(self_hit_eps))
        idx = None
    # idx is in CLUSTERED slot space (padded ray length); the caller gathers
    # winner data from pack.table (clustered too), so no perm remap is needed.
    # Named for the rematerialization policy (render.trace_rays): the sweep
    # is stop_gradient'd (selection only), so recomputing it in the backward
    # pass is pure waste — under jax.checkpoint with
    # save_only_these_names("sweep_dist", "sweep_idx") the small (R,)
    # outputs are saved and the pair sweep runs once per step, not twice.
    from jax.ad_checkpoint import checkpoint_name

    dist = checkpoint_name(dist, "sweep_dist")
    if idx is not None:
        idx = checkpoint_name(idx[:R], "sweep_idx")
    return dist[:R], idx, pack


def _winner_uvt_from(origins, dirs, v0, edge1, edge2, mt_eps):
    """Re-run Möller–Trumbore on each ray's winning triangle only (R x 1
    work) to recover (u, v, t) — componentwise with left-associated dots,
    the same rounding order as _mt_core/_mt_tile, so the values are
    bit-identical to what the full pass computed."""
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    e1x, e1y, e1z = edge1[:, 0], edge1[:, 1], edge1[:, 2]
    e2x, e2y, e2z = edge2[:, 0], edge2[:, 1], edge2[:, 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = (e1x * hx + e1y * hy) + e1z * hz
    f = 1.0 / jnp.where(jnp.abs(a) >= mt_eps, a, 1.0)
    sx = origins[:, 0] - v0[:, 0]
    sy = origins[:, 1] - v0[:, 1]
    sz = origins[:, 2] - v0[:, 2]
    u = f * ((sx * hx + sy * hy) + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * ((dx * qx + dy * qy) + dz * qz)
    t = f * ((e2x * qx + e2y * qy) + e2z * qz)
    return u, v, t


def _winner_uvt(origins, dirs, geometry, win, mt_eps):
    tri = geometry.vertices[win]  # (R,3,3)
    v0 = tri[:, 0]
    return _winner_uvt_from(origins, dirs, v0, tri[:, 1] - v0, tri[:, 2] - v0,
                            mt_eps)


def collide(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
            scene_axis: str | None = None, backend: str = "jnp",
            pack=None, partitioning: str = "octree") -> Hit:
    """Nearest hit over all triangles — `collide` (cpu/hit.c:72-91).

    Differentiable: the winner index is discrete (piecewise-constant) but the
    winning triangle's hit point / normal / distance carry gradients to the
    gathered geometry.

    scene_axis: when running under `shard_map` with the triangle arrays
    sharded over a mesh axis (scene/model parallel — each device owns a
    contiguous triangle range), pass that axis name: the local winner is
    combined across shards with an `all_gather` + first-occurrence argmin,
    which preserves the reference's lowest-triangle-index tie-break because
    shards hold contiguous ascending ranges. The gather is tiny
    ((S, R, 10) floats); its transpose routes hit-point/normal cotangents
    back to the owning shard automatically.
    """
    R = origins.shape[0]
    mat = None
    if backend == "pallas":
        if pack is not None and pack.table is None:
            pack = None  # caller built a dist-only pack; rebuild with table
        wdist, idx, pack = _pallas_nearest(origins, dirs, geometry, mt_eps,
                                           self_hit_eps, pack=pack,
                                           partitioning=partitioning)
        mask = jnp.isfinite(wdist)
        # Gather the winner's v0/e1/e2/normals/obj (and, on material tables,
        # the owning object's materials) from the clustered table. u/v/t/dist
        # are then recomputed with the same arithmetic as _mt_core —
        # differentiable w.r.t. the table (the gather's adjoint is a
        # scatter-add) and through it the geometry/materials, while the
        # sweep kernel itself stays behind its AD barrier; acceptance (mask)
        # still comes from the kernel.
        from raytracing_gpu_tpu.ops import pallas_intersect as pk

        rows = pack.table[idx]
        wv0 = rows[:, pk.COL_V0]
        we1 = rows[:, pk.COL_E1]
        we2 = rows[:, pk.COL_E2]
        tri_n = rows[:, pk.COL_N].reshape(R, 3, 3)
        obj = rows[:, pk.COL_OBJ].astype(jnp.int32)
        if rows.shape[1] == pk.TABLE_WIDTH_MAT and scene_axis is None:
            # Under scene sharding, materials must NOT ride the per-shard
            # winner row: material params are REPLICATED across the scene
            # axis, so their gradients must come from replicated
            # (post-combine) compute — each shard's gather would yield a
            # PARTIAL grad that out_specs P() cannot sum. Dropping mat here
            # makes shading fall back to material_rows(mats, combined obj),
            # which is bit-identical and gradient-correct. (Vertex/normal
            # grads may stay per-shard: those params ARE sharded, and the
            # combine's transpose routes cotangents to the owning shard.)
            mat = rows[:, pk.COL_MAT]
        wu, wv, wt = _winner_uvt_from(origins, dirs, wv0, we1, we2, mt_eps)
        # reference-exact distance |fl(o + nd*(t*|d|)) - o| (cpu/hit.c:36-38,
        # 57) — same chain as _mt_core / the sweep kernel; see the seam-tie
        # note in _mt_core
        dlen2_w = ((dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1])
                   + dirs[:, 2] * dirs[:, 2])
        dlen_w = jnp.sqrt(jnp.where(dlen2_w > 0.0, dlen2_w, 1.0))
        nd_w = dirs / dlen_w[:, None]
        td_w = wt * dlen_w
        px = (origins[:, 0] + nd_w[:, 0] * td_w) - origins[:, 0]
        py = (origins[:, 1] + nd_w[:, 1] * td_w) - origins[:, 1]
        pz = (origins[:, 2] + nd_w[:, 2] * td_w) - origins[:, 2]
        wdist = jnp.sqrt((px * px + py * py) + pz * pz)
    else:
        dist, u, v, t, ok = _mt_core(
            origins, dirs, geometry.vertices, geometry.normals, geometry.valid,
            mt_eps, self_hit_eps, _cull_mask(origins, dirs, geometry),
        )
        win = jnp.argmin(dist, axis=1)  # first occurrence == reference tie-break
        rix = jnp.arange(R)
        wdist = dist[rix, win]
        mask = jnp.isfinite(wdist)
        wu = u[rix, win]
        wv = v[rix, win]
        wt = t[rix, win]
        tri_n = geometry.normals[win]
        obj = geometry.tri_obj[win]

    # Hit point: origin + normalize(dir) * (t * |dir|)  (cpu/hit.c:36-38)
    # (left-assoc length like vector3_dot, see the seam note in _mt_core)
    dlen2 = ((dirs[:, 0] * dirs[:, 0] + dirs[:, 1] * dirs[:, 1])
             + dirs[:, 2] * dirs[:, 2])[:, None]
    dlen = jnp.sqrt(jnp.where(dlen2 > 0.0, dlen2, 1.0))
    ndir = dirs / dlen
    point = origins + ndir * (wt[:, None] * dlen)

    # Smooth normal: per-vertex normalize THEN barycentric interpolation,
    # never renormalized (cpu/hit.c:10-12, 38-40).
    nlen2 = ((tri_n[..., 0] * tri_n[..., 0] + tri_n[..., 1] * tri_n[..., 1])
             + tri_n[..., 2] * tri_n[..., 2])[..., None]
    nn = tri_n / jnp.sqrt(jnp.where(nlen2 > 0.0, nlen2, 1.0))
    normal = (
        nn[:, 0] * (1.0 - wu - wv)[:, None]
        + nn[:, 1] * wu[:, None]
        + nn[:, 2] * wv[:, None]
    )
    # Reference treats a zero interpolated normal as a miss
    # (vector3_is_zero at cpu/hit.c:79).
    nz = jnp.any(normal != 0.0, axis=-1)
    mask &= nz

    hit = Hit(
        point=point,
        normal=normal,
        obj=obj,
        dist=jnp.where(mask, wdist, INF),
        mask=mask,
        mat=mat,
    )
    if scene_axis is not None:
        hit = _combine_shard_hits(hit, scene_axis)
    return hit


def _combine_shard_hits(hit: Hit, axis_name: str) -> Hit:
    """Reduce per-shard nearest hits to the global nearest across a mesh axis.

    all_gather stacks shards in axis order (shard s holds triangles
    [s*T_local, (s+1)*T_local)), so a first-occurrence argmin over the shard
    axis reproduces the reference's linear-scan tie-break (cpu/hit.c:60:
    strictly-smaller wins, earlier index kept on ties).
    """
    g = jax.lax.all_gather(hit, axis_name)  # leaves gain leading (S,) axis
    win = jnp.argmin(g.dist, axis=0)  # (R,) first occurrence
    take = lambda a: jnp.take_along_axis(
        a, win.reshape((1,) + win.shape + (1,) * (a.ndim - 2)), axis=0
    )[0]
    return Hit(
        point=take(g.point),
        normal=take(g.normal),
        obj=take(g.obj[..., None])[..., 0],
        dist=take(g.dist[..., None])[..., 0],
        mask=take(g.mask[..., None])[..., 0],
        mat=None if hit.mat is None else take(g.mat),
    )


def collide_any(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
                scene_axis: str | None = None, backend: str = "jnp",
                pack=None, partitioning: str = "octree"):
    """(R,) bool — ANY accepted hit, the shadow consumer's true semantics.

    `has_direct_hit` (cpu/light.c:24-31) occludes on ANY hit: the nested
    `if (fdist < 1) if (fdist == 0)` makes its distance comparison dead
    code, so the shadow path never needs the nearest distance. Derived from
    collide_dist, whose 0.0-on-miss contract makes `!= 0.0` the identical
    boolean by construction.
    """
    fd = collide_dist(origins, dirs, geometry, mt_eps, self_hit_eps,
                      scene_axis, backend, pack, partitioning)
    return fd != 0.0


def collide_dist(origins, dirs, geometry, mt_eps=1e-7, self_hit_eps=0.01,
                 scene_axis: str | None = None, backend: str = "jnp",
                 pack=None, partitioning: str = "octree"):
    """Nearest-hit distance, 0.0 on miss — `collide_dist` (cpu/hit.c:93-109).

    Used for shadow rays; cheaper than `collide` (no winner gather). Under
    triangle sharding the per-shard minima combine with a `pmin` over the
    mesh axis (no gradient flows through this value: shadowing consumes it
    only via the boolean `!= 0` occlusion test).
    """
    if backend == "pallas":
        m, _, _ = _pallas_nearest(origins, dirs, geometry, mt_eps,
                                  self_hit_eps, pack=pack, want_idx=False,
                                  partitioning=partitioning)
    else:
        dist, _, _, _, _ = _mt_core(
            origins, dirs, geometry.vertices, geometry.normals, geometry.valid,
            mt_eps, self_hit_eps, _cull_mask(origins, dirs, geometry),
        )
        m = jnp.min(dist, axis=1)
    if scene_axis is not None:
        m = jax.lax.pmin(jax.lax.stop_gradient(m), scene_axis)
    return jnp.where(jnp.isfinite(m), m, 0.0)
