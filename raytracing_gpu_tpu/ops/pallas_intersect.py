"""Pallas kernels (Triton route) for the intersection hot loop.

The reference runs one CUDA thread per ray with a serial Möller–Trumbore
loop over the triangles of every object its octree walk reaches
(gpu/hit.cu:8-169). Here one Pallas program owns a tile of TILE_R rays and
walks its OWN worklist of triangle tiles — the tiles the culling hierarchy
could not rule out for any ray of the tile — evaluating (SUB_T, TILE_R)
Möller–Trumbore pair blocks in registers, keeping the running (min distance,
first-occurrence argmin) in registers, and storing once. Programs run in
parallel and in no order; nothing carries from one program to the next.

Tie-break: a worklist lists triangle tiles in ascending order, the blocks of
a tile are swept in ascending order, the fold across blocks is a strict `<`
and within a block the lowest row wins — so a ray's winner is the first
triangle (in clustered slot order) with a strictly smaller distance, the
reference's linear-scan rule (cpu/hit.c:60).

Layouts: triangles as (16, Tp) planes (rows v0, e1, e2 by component, then
zeros), so a block's component is one contiguous row slice; rays as
(16, Rp) planes (origin, direction, |d|, d/|d|, zeros) built once per call in
XLA. Triton wants power-of-two tensor sizes, so TILE_R, TILE_T and SUB_T are
powers of two.

Tile-level culling (the runtime PARTITIONING_{NONE,AABB,OCTREE} matrix,
gpu/CMakeLists.txt:12-15): tile_cull_mask_hierarchical builds an (nT, nR)
pair-tile mask (brute force / flat exact slab tests / coarse-to-fine
morton-tile hierarchy) and tile_worklist turns its transpose into the
per-ray-tile worklists, so the sweep executes only surviving pair tiles.

The winner's hit point, normal and materials are rebuilt outside the kernel
from a plain gather of its row in the clustered triangle table
(ops/intersect.py collide).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Chosen on an H100 from the sweep times of 65,536 primary rays against the
# 4.8k- and 96k-triangle procedural scenes (PERF.md): 64-ray tiles (one ray
# per thread of two warps) cull tighter and fill the card better than 128 or
# 256; 8-triangle blocks keep the pair block in registers.
TILE_R = 64  # rays per program and per culling ray tile
TILE_T = 256  # triangles per culling tile (one worklist entry)
SUB_T = 8  # triangles per register-resident pair block
NUM_WARPS = 2

_INF = float("inf")  # plain float: jnp scalars would be captured consts in-kernel
_ROWS = 16  # rows of the ray and triangle plane arrays (zero-padded)


def _interpret() -> bool:
    """Pallas interpreter on the CPU (the tests); the compiled kernel on the
    GPU. No other platform has a kernel."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise NotImplementedError(
        f"no intersection kernel for platform {platform!r}; use backend='jnp'")


def _mt_block(ray, tri, mt_eps, self_hit_eps, ref_dist):
    """Möller–Trumbore pair block -> dist (SUB_T, TILE_R), inf on reject.

    ray: ten (1, TILE_R) rows (o, d, |d|, d/|d|); tri: nine (SUB_T, 1)
    columns (v0, e1, e2). Arithmetic order matches cpu/hit.c:4-70 with
    left-associated dot products, like ops/intersect.py _mt_core.

    ref_dist=True computes the distance exactly as the reference does for
    winner selection, |fl(o + nd*(t*|d|)) - o| (cpu/hit.c:36-38,57), instead
    of t*|d|. The two differ by ~1 ulp, which decides real winners on
    tessellation seams (see ops/intersect.py _mt_core). The dist-only sweep
    keeps the cheap t*|d|: its result is consumed as a boolean any-hit
    (cpu/light.c:24-31).
    """
    ox, oy, oz, dx, dy, dz, dlen, ndx, ndy, ndz = ray
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    # h = cross(d, e2)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = (e1x * hx + e1y * hy) + e1z * hz
    ok = jnp.abs(a) >= mt_eps
    f = 1.0 / jnp.where(ok, a, 1.0)
    sx = ox - v0x
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
    ok &= t > mt_eps
    td = t * dlen
    if ref_dist:
        ddx = (ox + ndx * td) - ox
        ddy = (oy + ndy * td) - oy
        ddz = (oz + ndz * td) - oz
        dist = jnp.sqrt((ddx * ddx + ddy * ddy) + ddz * ddz)
    else:
        dist = td
    ok &= dist > self_hit_eps
    return jnp.where(ok, dist, _INF)


def _sweep_kernel(count_ref, order_ref, ray_ref, tri_ref, *out_refs, mt_eps,
                  self_hit_eps, want_idx):
    """One ray tile against its worklist of triangle tiles.

    count_ref (nr,) and order_ref (nr, nT) are the per-ray-tile worklists
    (tile_worklist of the transposed pair-tile mask); ray_ref (16, Rp) and
    tri_ref (16, Tp) the plane arrays. out_refs: the tile's (TILE_R,) min
    distance, and with want_idx its (TILE_R,) winner slot."""
    i = pl.program_id(0)
    rs = pl.ds(i * TILE_R, TILE_R)
    ray = [ray_ref[k, rs][None, :] for k in range(10)]

    def block(base, carry):
        cols = pl.ds(base, SUB_T)
        tri = [tri_ref[k, cols][:, None] for k in range(9)]
        dist = _mt_block(ray, tri, mt_eps, self_hit_eps, want_idx)
        bmin = jnp.min(dist, axis=0)  # (TILE_R,)
        if not want_idx:
            return jnp.minimum(carry, bmin)
        best, idx = carry
        rows = lax.broadcasted_iota(jnp.int32, dist.shape, 0)
        # first-occurrence argmin within the block: smallest row among minima
        barg = jnp.min(jnp.where(dist == bmin[None, :], rows, SUB_T), axis=0)
        better = bmin < best  # strict: earlier blocks win ties
        return jnp.where(better, bmin, best), jnp.where(better, base + barg, idx)

    def tile(l, carry):
        j = order_ref[i, l]
        return lax.fori_loop(
            0, TILE_T // SUB_T,
            lambda s, c: block(j * TILE_T + s * SUB_T, c), carry)

    best = jnp.full((TILE_R,), _INF, jnp.float32)
    init = (best, jnp.zeros((TILE_R,), jnp.int32)) if want_idx else best
    out = lax.fori_loop(0, count_ref[i], tile, init)
    for ref, val in zip(out_refs, out if want_idx else (out,)):
        ref[...] = val


def _sweep(ray, tri, tile_mask, mt_eps, self_hit_eps, want_idx):
    Rp = ray.shape[1]
    nr = Rp // TILE_R
    order, count = tile_worklist(tile_mask.T)
    kernel = functools.partial(
        _sweep_kernel, mt_eps=mt_eps, self_hit_eps=self_hit_eps,
        want_idx=want_idx)
    out_shape = [jax.ShapeDtypeStruct((Rp,), jnp.float32)]
    if want_idx:
        out_shape.append(jax.ShapeDtypeStruct((Rp,), jnp.int32))
    return pl.pallas_call(
        kernel,
        grid=(nr,),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=[pl.BlockSpec((TILE_R,), lambda i: (i,))] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=_interpret(),
        name="nearest_hit" if want_idx else "nearest_dist",
    )(count, order, ray, tri)


@functools.partial(jax.jit, static_argnames=("mt_eps", "self_hit_eps"))
def nearest_hit_pallas(op, dp, tri, tile_mask, mt_eps: float,
                       self_hit_eps: float):
    """Min distance + winner slot over the surviving (ray, triangle) pairs.

    op/dp: (3, Rp) packed rays (pack_rays), Rp % TILE_R == 0.
    tri: (16, Tp) triangle planes (pack_triangles), Tp % TILE_T == 0;
      invalid triangles are degenerate (e1 = e2 = 0 -> |a| < eps rejects).
    tile_mask: (nT, nR) int32 — 0 skips the pair tile (culling); ones for
      brute force.
    Returns (dist (Rp,), idx (Rp,)) with dist == +inf on miss.
    """
    dist, idx = _sweep(ray_planes(op, dp), tri, tile_mask, mt_eps,
                       self_hit_eps, True)
    return dist, idx


@functools.partial(jax.jit, static_argnames=("mt_eps", "self_hit_eps"))
def nearest_dist_pallas(op, dp, tri, tile_mask, mt_eps: float,
                        self_hit_eps: float):
    """Min distance only (no winner index) — the collide_dist hot path.
    Shadow rays consume only `dist != 0` (cpu/light.c:24-31) and
    collide_dist returns just the distance (cpu/hit.c:93-109)."""
    (dist,) = _sweep(ray_planes(op, dp), tri, tile_mask, mt_eps,
                     self_hit_eps, False)
    return dist


def ray_planes(op, dp):
    """(3, Rp) origin/direction planes -> (16, Rp) kernel ray planes:
    o, d, |d|, d/|d|, zeros. The per-ray length and normalized direction
    are computed here once, in XLA, with the same left-associated length as
    _mt_core; zero directions (parked rays) take |d| = 1."""
    dlen2 = (dp[0] * dp[0] + dp[1] * dp[1]) + dp[2] * dp[2]
    dlen = jnp.sqrt(jnp.where(dlen2 > 0.0, dlen2, 1.0))
    zeros = jnp.zeros((_ROWS - 10, op.shape[1]), op.dtype)
    return jnp.concatenate([op, dp, dlen[None], dp / dlen, zeros])


def pack_triangles(vertices, valid):
    """(T,3,3) triangle soup -> (16, Tp) planes (rows v0, e1, e2 by
    component, then zeros), padded to TILE_T with degenerate columns
    (e1 = e2 = 0, rejected by the determinant test)."""
    T = vertices.shape[0]
    v0 = vertices[:, 0]
    # invalid triangles -> zero edges (|a| < eps rejects them in-kernel)
    e1 = jnp.where(valid[:, None], vertices[:, 1] - v0, 0.0)
    e2 = jnp.where(valid[:, None], vertices[:, 2] - v0, 0.0)
    rows = jnp.concatenate([v0, e1, e2], axis=1).T  # (9, T)
    return jnp.pad(rows, ((0, _ROWS - 9), (0, (-T) % TILE_T)))


def pack_rays(origins, dirs):
    """(R,3) -> (3,Rp) planes padded to TILE_R; padded rays get dir=(0,0,1)
    and an origin far outside any scene so they miss everything."""
    R = origins.shape[0]
    pad = (-R) % TILE_R
    if pad:
        origins = jnp.concatenate(
            [origins, jnp.full((pad, 3), 1e30, origins.dtype)]
        )
        dirs = jnp.concatenate(
            [dirs, jnp.concatenate([jnp.zeros((pad, 2)), jnp.ones((pad, 1))], axis=1).astype(dirs.dtype)]
        )
    return origins.T, dirs.T, R


def cluster_triangles(vertices, valid):
    """Spatially cluster triangles into TILE_T-sized tiles (morton order).

    The file-order triangle tiles have no spatial coherence, so tile-level
    AABB culling at object granularity is weak. Reordering triangles by the
    morton key of their centroid (the same 8-bit/axis interleaved grid as
    the octree's position_object, octree.cu:126-196, but per TRIANGLE) makes
    each tile spatially compact, and its tight AABB culls most (ray-tile,
    tri-tile) pairs — a BVH-leaf analog.

    Returns (perm (Tp,) int32 — clustered slot -> original triangle index,
    with invalid/padding triangles sorted last; tile_aabb (nT,2,3) f32;
    tile_nonempty (nT,) bool). Pure jnp.

    Tie-break note: the kernel's argmin then prefers the first triangle in
    CLUSTERED order rather than file order. Exact f32 distance ties between
    distinct triangles are the only case where this changes the winner —
    the same measure-zero edge class the comparator already absorbs.
    """
    T = vertices.shape[0]
    centroid = vertices.mean(axis=1)  # (T,3)
    vmin = jnp.where(valid[:, None], jnp.min(
        jnp.where(valid[:, None, None], vertices, _INF), axis=1), _INF)
    vmax = jnp.where(valid[:, None], jnp.max(
        jnp.where(valid[:, None, None], vertices, -_INF), axis=1), -_INF)
    smin = vmin.min(axis=0)
    smax = vmax.max(axis=0)
    size = jnp.where(smax - smin > 0.0, smax - smin, 1.0)
    q = jnp.clip(jnp.floor((centroid - smin) / size * 256.0), 0, 255
                 ).astype(jnp.int32)
    morton = jnp.zeros((T,), jnp.uint32)
    for b in range(8):
        grp = (((q[:, 0] >> b) & 1) << 2) | (((q[:, 1] >> b) & 1) << 1) | (
            (q[:, 2] >> b) & 1)
        morton = morton | (grp.astype(jnp.uint32) << jnp.uint32(3 * b))
    keys = jnp.where(valid, morton, jnp.uint32(0xFFFFFFFF))
    perm = jnp.argsort(keys, stable=True).astype(jnp.int32)

    pad = (-T) % TILE_T
    nT = (T + pad) // TILE_T
    svmin = vmin[perm]
    svmax = vmax[perm]
    sval = valid[perm]
    if pad:
        svmin = jnp.concatenate([svmin, jnp.full((pad, 3), _INF)])
        svmax = jnp.concatenate([svmax, jnp.full((pad, 3), -_INF)])
        sval = jnp.concatenate([sval, jnp.zeros((pad,), bool)])
    tmin = svmin.reshape(nT, TILE_T, 3).min(axis=1)
    tmax = svmax.reshape(nT, TILE_T, 3).max(axis=1)
    tile_nonempty = sval.reshape(nT, TILE_T).any(axis=1)
    # empty tiles: replace the (inf,-inf) box with a point so the slab test
    # stays NaN-free; they are masked off via tile_nonempty anyway
    tmin = jnp.where(tile_nonempty[:, None], tmin, 0.0)
    tmax = jnp.where(tile_nonempty[:, None], tmax, 0.0)
    return perm, jnp.stack([tmin, tmax], axis=1), tile_nonempty


class KernelPack(NamedTuple):
    """Static per-scene packing for the kernel backend — computed ONCE per
    render (the analog of the reference's to_cuda-time octree build,
    gpu/scene.cu:224-352) instead of per collide call: clustering + triangle
    packing would otherwise re-run inside every lax.map chunk and bounce
    iteration, where XLA cannot hoist them out of the loop bodies."""

    perm: jax.Array           # (Tp,) clustered slot -> original tri index
    tile_aabb: jax.Array      # (nT, 2, 3) per-tile AABB (clustered order)
    tile_nonempty: jax.Array  # (nT,) bool
    tri: jax.Array            # (16, Tp) clustered + padded triangle planes
    table: jax.Array | None   # (Tp, 19|30) winner table (clustered):
                              # v0(3) e1(3) e2(3) n0/n1/n2(9) obj(1), then —
                              # with materials — ka(3) kd(3) ks(3) ns(1) nr(1)
                              # of the owning object. Gathered by the winner
                              # slot in collide. None when built without
                              # normals/tri_obj.


# table column layout (see KernelPack.table)
COL_V0 = slice(0, 3)
COL_E1 = slice(3, 6)
COL_E2 = slice(6, 9)
COL_N = slice(9, 18)
COL_OBJ = 18
COL_MAT = slice(19, 30)  # ka(3) kd(3) ks(3) ns(1) nr(1) — material tables only
TABLE_WIDTH_MAT = 30


def pack_geometry(vertices, valid, normals=None, tri_obj=None,
                  materials=None) -> KernelPack:
    """Cluster + pack a triangle soup for the sweep kernels.

    With normals/tri_obj the winner table is built too (required by
    collide; collide_dist-only callers may omit them). With `materials`
    (a Materials pytree) the owning object's ka/kd/ks/ns/nr are appended per
    triangle, so collide gets them from the same winner-row gather.
    Differentiable into vertices/normals/materials: the kernel itself only
    selects, but the winner's values are gathered from this pack's table,
    so the pack must NOT be built under stop_gradient when gradients are
    wanted.
    """
    perm, tile_aabb, tile_nonempty = cluster_triangles(vertices, valid)
    sv, svalid = vertices[perm], valid[perm]
    tri = pack_triangles(sv, svalid)
    table = None
    if normals is not None and tri_obj is not None:
        T = normals.shape[0]
        v0 = sv[:, 0]
        e1 = jnp.where(svalid[:, None], sv[:, 1] - v0, 0.0)
        e2 = jnp.where(svalid[:, None], sv[:, 2] - v0, 0.0)
        obj = tri_obj[perm]
        cols = [v0, e1, e2, normals[perm].reshape(T, 9),
                obj.astype(jnp.float32)[:, None]]  # small ints: f32-exact
        if materials is not None:
            mat = jnp.concatenate(
                [materials.ka, materials.kd, materials.ks,
                 materials.ns[:, None], materials.nr[:, None]], axis=1
            )  # (O, 11)
            cols.append(mat[obj])
        table = jnp.concatenate(cols, axis=1)
        table = jnp.pad(table, ((0, tri.shape[1] - T), (0, 0)))
    return KernelPack(perm, tile_aabb, tile_nonempty, tri, table)


def tile_cull_mask_packed(op, dp, tile_aabb, tile_nonempty):
    """(nT, nR) int32 pair-tile mask from packed (3, Rp) rays — EXACT
    per-ray slab tests, vectorized over boxes as one (nT, Rp) array."""
    nr = op.shape[1] // TILE_R
    hit = _slab_hits_packed(op, dp, tile_aabb)  # (nT, Rp)
    hit &= tile_nonempty[:, None]
    nT = tile_aabb.shape[0]
    return hit.reshape(nT, nr, TILE_R).any(axis=2).astype(jnp.int32)


def _slab_hits_packed(op, dp, boxes):
    """(nB, Rp) bool forward-only slab test of packed rays vs boxes.

    op/dp: (3, Rp); boxes: (nB, 2, 3). Branch-free; zero direction
    components use a tiny epsilon stand-in exactly like the original
    per-box builder (parked rays have origin 3e29 -> guaranteed miss).
    """
    dsafe = jnp.where(dp == 0.0, 1e-30, dp)
    inv = 1.0 / dsafe  # (3, Rp)
    tmin = jnp.full((boxes.shape[0], op.shape[1]), -_INF)
    tmax = jnp.full((boxes.shape[0], op.shape[1]), _INF)
    for k in range(3):  # static 3 axes
        t1 = (boxes[:, 0, k][:, None] - op[k][None, :]) * inv[k][None, :]
        t2 = (boxes[:, 1, k][:, None] - op[k][None, :]) * inv[k][None, :]
        tmin = jnp.maximum(tmin, jnp.minimum(t1, t2))
        tmax = jnp.minimum(tmax, jnp.maximum(t1, t2))
    return (tmax >= tmin) & (tmax >= 0.0)


def ray_tile_intervals(op, dp):
    """Per-ray-tile conservative bounds: ((3,nr) olo/ohi/dlo/dhi, (nr,) any_live).

    Parked/dead rays (|origin| >= 1e20 — see render.py ray parking) are
    excluded from the bounds; a tile of only parked rays reports
    any_live=False and culls everything.
    """
    nr = op.shape[1] // TILE_R
    o = op.reshape(3, nr, TILE_R)
    d = dp.reshape(3, nr, TILE_R)
    live = jnp.all(jnp.abs(o) < 1e20, axis=0)  # (nr, TILE_R)
    big = jnp.where(live[None], o, _INF)
    small = jnp.where(live[None], o, -_INF)
    olo, ohi = big.min(axis=2), small.max(axis=2)  # (3, nr)
    dbig = jnp.where(live[None], d, _INF)
    dsmall = jnp.where(live[None], d, -_INF)
    dlo, dhi = dbig.min(axis=2), dsmall.max(axis=2)
    return olo, ohi, dlo, dhi, live.any(axis=1)


def tile_cull_mask_interval(op, dp, boxes, nonempty):
    """(nB, nr) int32 conservative pair-tile mask via interval arithmetic.

    Each ray TILE is abstracted to an origin box x direction box (live rays
    only); a (tile, box) pair survives iff SOME ray in that shaft could hit
    the box — interval slab test with sound division (a direction interval
    spanning 0 leaves that axis unconstrained). O(nr * nB) work vs the
    exact builder's O(R * nB): TILE_R x less per level, at the price of
    conservative (never wrong, sometimes loose) culling.
    """
    olo, ohi, dlo, dhi, any_live = ray_tile_intervals(op, dp)
    nB = boxes.shape[0]
    nr = olo.shape[1]
    tlo = jnp.full((nB, nr), -_INF)
    thi = jnp.full((nB, nr), _INF)
    for k in range(3):
        spans0 = (dlo[k] <= 0.0) & (dhi[k] >= 0.0)  # (nr,)
        # inverse-direction interval (valid only when 0 not in [dlo, dhi])
        safe_lo = jnp.where(dlo[k] == 0.0, 1e-30, dlo[k])
        safe_hi = jnp.where(dhi[k] == 0.0, -1e-30, dhi[k])
        ilo = 1.0 / safe_hi
        ihi = 1.0 / safe_lo
        # numerator intervals for both slab planes: (nB, nr)
        nlo_a = boxes[:, 0, k][:, None] - ohi[k][None, :]
        nlo_b = boxes[:, 0, k][:, None] - olo[k][None, :]
        nhi_a = boxes[:, 1, k][:, None] - ohi[k][None, :]
        nhi_b = boxes[:, 1, k][:, None] - olo[k][None, :]
        cand = [n * i for n in (nlo_a, nlo_b, nhi_a, nhi_b)
                for i in (ilo[None, :], ihi[None, :])]
        lo_k = functools.reduce(jnp.minimum, cand)
        hi_k = functools.reduce(jnp.maximum, cand)
        # axis with a sign-spanning direction interval: unconstrained
        # (sound; a tighter bound would need the origin interval too)
        lo_k = jnp.where(spans0[None, :], -_INF, lo_k)
        hi_k = jnp.where(spans0[None, :], _INF, hi_k)
        tlo = jnp.maximum(tlo, lo_k)
        thi = jnp.minimum(thi, hi_k)
    hit = (thi >= tlo) & (thi >= 0.0)
    hit &= nonempty[:, None] & any_live[None, :]
    return hit.astype(jnp.int32)


def build_tile_levels(tile_aabb, tile_nonempty, branching: int = 8,
                      top_max: int = 64):
    """Union-box hierarchy over the morton-ordered leaf tiles.

    Consecutive morton tiles are spatial neighbours (children of the same
    octree cell), so unioning `branching` consecutive tile boxes recovers
    the parent-cell box — the flat-array analog of the reference octree's
    internal nodes (octree.cu:231-360). Returns [(boxes, nonempty), ...]
    coarse -> fine, EXCLUDING the leaf level; empty when nT <= top_max.
    """
    levels = []
    boxes, nonempty = tile_aabb, tile_nonempty
    while boxes.shape[0] > top_max:
        n = boxes.shape[0]
        pad = (-n) % branching
        if pad:
            empty = jnp.stack(
                [jnp.full((3,), _INF), jnp.full((3,), -_INF)]
            )  # (2,3) inverted box: union-neutral
            boxes = jnp.concatenate(
                [boxes, jnp.broadcast_to(empty, (pad, 2, 3))])
            nonempty = jnp.concatenate([nonempty, jnp.zeros((pad,), bool)])
        g = boxes.reshape(-1, branching, 2, 3)
        boxes = jnp.stack([g[:, :, 0].min(axis=1), g[:, :, 1].max(axis=1)],
                          axis=1)
        nonempty = nonempty.reshape(-1, branching).any(axis=1)
        boxes = jnp.where(nonempty[:, None, None], boxes, 0.0)
        levels.append((boxes, nonempty))
    return levels[::-1]  # coarse -> fine


def tile_cull_mask_hierarchical(op, dp, pack, partitioning: str):
    """(nT, nR) pair-tile mask per the runtime partitioning mode.

    - "none": all-ones — true brute force (PARTITIONING_NONE,
      gpu/CMakeLists.txt:12-15).
    - "aabb": flat exact per-ray slab tests against every leaf tile box
      (PARTITIONING_AABB analog at kernel-tile granularity).
    - "octree": coarse-to-fine traversal of the morton-tile hierarchy — the
      batched recast of the octree DFS (gpu/hit.cu:120-169). The TOP level
      (<= 64 union boxes) is tested EXACTLY per ray (this carries the
      dominant signal: a ray that misses a whole subtree is culled from all
      its leaves); every finer level uses the O(nr x nB) interval test at
      ray-tile granularity, AND-chained parent -> child. Total builder work
      is O(R * top + nr * nT) instead of O(R * nT), so the mask stays cheap
      at 100k+ triangles while the sweep kernel's worklist (the sparse
      phase of the traversal) executes only surviving pair tiles.
    """
    nT = pack.tile_aabb.shape[0]
    nr = op.shape[1] // TILE_R
    if partitioning == "none":
        return jnp.ones((nT, nr), jnp.int32)
    if partitioning == "aabb" or nT <= 64:
        # small scenes: the exact leaf test IS the whole hierarchy
        return tile_cull_mask_packed(op, dp, pack.tile_aabb,
                                     pack.tile_nonempty)
    levels = build_tile_levels(pack.tile_aabb, pack.tile_nonempty)
    top_boxes, top_nonempty = levels[0]
    mask = tile_cull_mask_packed(op, dp, top_boxes, top_nonempty)  # exact
    for boxes, nonempty in levels[1:]:
        child = tile_cull_mask_interval(op, dp, boxes, nonempty)
        nB = boxes.shape[0]
        parent = jnp.repeat(mask, 8, axis=0)[:nB]
        mask = child * parent
    leaf = tile_cull_mask_interval(op, dp, pack.tile_aabb,
                                   pack.tile_nonempty)
    parent = jnp.repeat(mask, 8, axis=0)[:nT]
    return leaf * parent


def tile_worklist(tile_mask):
    """(nA, nB) pair-tile mask -> (order (nA, nB) int32, count (nA,) int32).

    Row a lists the columns b with an active tile first, in ascending order
    (stable sort), and count[a] says how many there are; entries past the
    count are not read. The sweep passes the transposed (ray tile, triangle
    tile) mask, so each ray tile gets its triangle tiles in ascending order —
    the order the first-occurrence tie-break needs.
    """
    active = tile_mask > 0
    count = jnp.sum(active.astype(jnp.int32), axis=1)
    order = jnp.argsort(~active, axis=1, stable=True).astype(jnp.int32)
    return order, count
