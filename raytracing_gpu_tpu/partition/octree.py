"""Object-granularity octree as flat index tables.

Reference pipeline (gpu/partitioning/octree.cu, host orchestration at
octree.cu:362-411): per-object AABB -> global scene scale -> quantize each
object's box to an 8-level (256^3) grid and pack a 24-bit interleaved child
path + 8-bit level sort key (octree.cu:13-16,126-196; key format doc
octree.h:45-54) -> radix-sort objects by key -> count new nodes per key via
common-prefix levels (octree.cu:200-228) -> prefix-sum offsets -> a kernel
that materializes nodes with object ranges and child/parent pointer links
(octree.cu:245-360).

Here the same structure is built with `argsort` / `cumsum`-free vectorized
math and `searchsorted` range queries, and the pointer-linked node graph
becomes static-shape index tables (children indices, -1 for null) that a
Pallas/XLA traversal can walk without pointers. Candidate node rows are the
(object, level) grid — at most 9*O rows, masked to first occurrences — so
every shape is static and the whole build jits.

Key layout (ours, same information as octree.h:45-54): a node at depth d is
identified by the top 3d bits of the object's 24-bit interleaved cell path
("morton"); object sort key = morton * 256 + level (uint32), with path bits
below the object's level zeroed so parents sort immediately before their
subtree (pre-order).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

MAX_DEPTH = 8  # grid bits per axis — 256^3 cells (octree.cu:13-16)
_U32 = jnp.uint32
_SENTINEL = jnp.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class Octree:
    """Flat octree. N = 9*O candidate rows, invalid rows masked out.

    keys:        (O,) uint32 sorted object keys (morton*256+level)
    perm:        (O,) int32 — perm[i] = original object id at sorted slot i
    obj_node:    (O,) int32 — ORIGINAL object id -> node row index
    node_valid:  (N,) bool
    node_level:  (N,) int32 depth d (0 = root)
    node_box:    (N,2,3) f32 grid-cell AABB (octree.cu:231-243 get_aabb_box)
    node_start/node_end: (N,) int32 — sorted-object range OWNED by the node
                 (objects whose level == d and cell == this node)
    node_sub_start/node_sub_end: (N,) int32 — full subtree range
    node_children: (N,8) int32 node row of each child, -1 when absent
    node_parent: (N,) int32, -1 at root
    n_nodes:     () int32 — number of valid nodes
    """

    keys: Any
    perm: Any
    obj_node: Any
    node_valid: Any
    node_level: Any
    node_box: Any
    node_start: Any
    node_end: Any
    node_sub_start: Any
    node_sub_end: Any
    node_children: Any
    node_parent: Any
    n_nodes: Any


jax.tree_util.register_pytree_node(
    Octree,
    lambda t: (tuple(getattr(t, f.name) for f in dataclasses.fields(Octree)), None),
    lambda _, c: Octree(*c),
)


@dataclasses.dataclass
class NodeCull:
    """The node-graph slice the render hot path traverses (attached to
    Geometry.octree by partition.apply.with_accel). This is the production
    consumer of the octree link tables: ops.intersect's jnp cull walks it
    top-down per ray (octree_object_reach below) the way the reference's
    DFS walks its pointer graph (gpu/hit.cu:120-169)."""

    node_box: Any     # (N,2,3) grid-cell AABBs
    node_parent: Any  # (N,) parent row, -1 at roots
    node_level: Any   # (N,) depth, 0 = root
    node_valid: Any   # (N,) bool
    obj_node: Any     # (O,) original object id -> owning node row


jax.tree_util.register_pytree_node(
    NodeCull,
    lambda t: (tuple(getattr(t, f.name) for f in dataclasses.fields(NodeCull)), None),
    lambda _, c: NodeCull(*c),
)


def node_cull_tables(tree: "Octree") -> NodeCull:
    """Project a built Octree onto the fields the traversal consumes."""
    return NodeCull(
        node_box=tree.node_box,
        node_parent=tree.node_parent,
        node_level=tree.node_level,
        node_valid=tree.node_valid,
        obj_node=tree.obj_node,
    )


def octree_object_reach(origins, dirs, nc: NodeCull):
    """(R,O) bool — object reachable by the ray through the node graph.

    The batched, uniform recast of the reference's stackful DFS (gpu/hit.cu:
    120-169): instead of a 64-slot per-thread stack, reachability is a
    breadth-first frontier mask propagated top-down through the parent
    links — `reached[n] = hit_aabb(node n) AND reached[parent[n]]`, roots
    seeded by their own slab test. The parent-gather is the XLA transpose
    of pushing children onto the DFS stack (octree.cu's children[8] links
    record the same edges parent-ward); after MAX_DEPTH sweeps every level
    is settled (propagation is monotone False->True, one level per sweep).

    An object is then reachable iff its owning node is (node cells nest, so
    this implies every ancestor box was hit — the exact DFS descent
    condition). Conservative: a culled object cannot contain an accepted
    hit, so renders are bit-identical with culling on or off
    (tests/test_partition.py).
    """
    from raytracing_gpu_tpu.partition.aabb import hit_aabb

    nhit = hit_aabb(origins, dirs, nc.node_box) & nc.node_valid[None, :]  # (R,N)
    is_root = (nc.node_level == 0) & nc.node_valid
    has_parent = nc.node_parent >= 0
    pidx = jnp.clip(nc.node_parent, 0, None)
    reached = nhit & is_root[None, :]
    for _ in range(MAX_DEPTH):
        parent_reached = jnp.take(reached, pidx, axis=1)  # (R,N)
        reached = jnp.where(is_root[None, :], reached,
                            nhit & parent_reached & has_parent[None, :])
    # padding objects own no node; leave them uncullled (their triangles
    # are already invalid) so the mask stays conservative
    oreach = jnp.take(reached, jnp.clip(nc.obj_node, 0, None), axis=1)
    return oreach | (nc.obj_node < 0)[None, :]


def _bitlength8(x):
    """Position of highest set bit of an 8-bit value (0 for x==0)."""
    bl = jnp.zeros_like(x)
    for b in range(8):
        bl = jnp.where((x >> b) & 1 == 1, b + 1, bl)
    return bl


def position_keys(obj_aabbs, scene_aabb, obj_valid):
    """Quantize object AABBs to the grid and pack sort keys.

    position_object (octree.cu:126-196): normalize to the unit cube,
    quantize min/max corners to 8 bits/axis, level = min over axes of the
    number of leading grid bits the two corners share, then pack the
    interleaved 3-bit child path (24 bits) + level into a uint32.

    Returns (keys (O,) uint32, level (O,) int32, morton (O,) uint32).
    """
    smin = scene_aabb[0]
    size = scene_aabb[1] - scene_aabb[0]
    size = jnp.where(size > 0.0, size, 1.0)
    scale = 256.0 / size

    def quant(corner):
        q = jnp.floor((corner - smin) * scale).astype(jnp.int32)
        return jnp.clip(q, 0, 255)

    qmin = quant(obj_aabbs[:, 0])  # (O,3)
    qmax = quant(obj_aabbs[:, 1])
    agree = _bitlength8(qmin ^ qmax)  # differing-bit length per axis
    level = jnp.min(8 - agree, axis=-1).astype(jnp.int32)  # (O,)

    qx, qy, qz = qmin[:, 0], qmin[:, 1], qmin[:, 2]
    morton = jnp.zeros(qx.shape, _U32)
    for d in range(MAX_DEPTH):
        bx = (qx >> (7 - d)) & 1
        by = (qy >> (7 - d)) & 1
        bz = (qz >> (7 - d)) & 1
        child = (bx << 2) | (by << 1) | bz
        morton = morton | (child.astype(_U32) << _U32(3 * (7 - d)))
    # zero path bits below the object's level so the key is the canonical
    # cell id (and parents pre-order-sort before descendants)
    shift = (3 * (MAX_DEPTH - level)).astype(_U32)
    morton = jnp.where(level >= 8, morton, (morton >> shift) << shift)
    keys = (morton << _U32(8)) | level.astype(_U32)
    keys = jnp.where(obj_valid, keys, _SENTINEL)
    return keys, jnp.where(obj_valid, level, 0), morton


def build_octree(obj_aabbs, scene_aabb, obj_valid) -> Octree:
    """Full build: keys -> sort -> node enumeration -> ranges & links."""
    O = obj_aabbs.shape[0]
    keys, level, _ = position_keys(obj_aabbs, scene_aabb, obj_valid)

    # radix-sort analog: XLA stable sort co-sorting the object ids
    # (parallel_radix_sort co-sorts objects + AABBs, sort.tuh:137-220; we
    # carry the permutation instead of physically moving scene arrays)
    perm = jnp.argsort(keys, stable=True).astype(jnp.int32)
    skeys = keys[perm]
    slevel = level[perm]
    smorton = skeys >> _U32(8)

    # ---- candidate nodes: (object, depth) pairs, deduped by first occurrence
    d_grid = jnp.arange(MAX_DEPTH + 1, dtype=jnp.int32)  # (9,)
    valid_pair = (d_grid[None, :] <= slevel[:, None]) & (skeys != _SENTINEL)[:, None]
    shift = (3 * (MAX_DEPTH - d_grid)).astype(_U32)  # (9,)
    prefix = smorton[:, None] >> shift[None, :]  # (O,9) top 3d bits
    codes = (prefix << _U32(4)) | d_grid.astype(_U32)[None, :]
    codes = jnp.where(valid_pair, codes, _SENTINEL).reshape(-1)  # (9O,)
    codes = jnp.sort(codes)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), codes[1:] != codes[:-1]]
    )
    node_valid = first & (codes != _SENTINEL)
    n_nodes = node_valid.sum().astype(jnp.int32)

    node_level = (codes & _U32(15)).astype(jnp.int32)
    node_prefix = codes >> _U32(4)

    # ---- node grid-cell AABB (get_aabb_box, octree.cu:231-243)
    smin = scene_aabb[0]
    size = jnp.where(scene_aabb[1] - scene_aabb[0] > 0.0,
                     scene_aabb[1] - scene_aabb[0], 1.0)
    cx = jnp.zeros(codes.shape, jnp.int32)
    cy = jnp.zeros(codes.shape, jnp.int32)
    cz = jnp.zeros(codes.shape, jnp.int32)
    for b in range(MAX_DEPTH):  # de-interleave; bit b counts from path start
        grp = (node_prefix >> _U32(3 * b)).astype(jnp.int32) & 7
        take = b < node_level  # path has node_level 3-bit groups
        cx = cx | jnp.where(take, ((grp >> 2) & 1) << b, 0)
        cy = cy | jnp.where(take, ((grp >> 1) & 1) << b, 0)
        cz = cz | jnp.where(take, (grp & 1) << b, 0)
    cell = jnp.stack([cx, cy, cz], axis=-1).astype(jnp.float32)  # (N,3)
    side = size[None, :] / (2.0 ** node_level)[:, None].astype(jnp.float32)
    bmin = smin[None, :] + cell * side
    node_box = jnp.stack([bmin, bmin + side], axis=1)  # (N,2,3)

    # ---- owned object range: keys == canonical (cell path, level) key
    own_key = (node_prefix << (3 * (MAX_DEPTH - node_level)).astype(_U32) << _U32(8)) | node_level.astype(_U32)
    node_start = jnp.searchsorted(skeys, own_key, side="left").astype(jnp.int32)
    node_end = jnp.searchsorted(skeys, own_key, side="right").astype(jnp.int32)

    # ---- subtree range: all keys whose morton has this prefix
    lo = (node_prefix << (3 * (MAX_DEPTH - node_level)).astype(_U32)) << _U32(8)
    hi = ((node_prefix + 1) << (3 * (MAX_DEPTH - node_level)).astype(_U32)) << _U32(8)
    # root (and the last cell at any level, whose +1 wraps) upper-bound at
    # the sentinel: "everything below the first invalid key"
    last_cell = node_prefix == ((_U32(1) << (3 * node_level).astype(_U32)) - _U32(1))
    hi = jnp.where((node_level == 0) | last_cell, _SENTINEL, hi)
    node_sub_start = jnp.searchsorted(skeys, lo, side="left").astype(jnp.int32)
    node_sub_end = jnp.searchsorted(skeys, hi, side="left").astype(jnp.int32)

    # ---- children / parent links by code lookup (replaces the backward
    # parent-search walk at octree.cu:300-360)
    def code_to_row(c):
        row = jnp.searchsorted(codes, c, side="left").astype(jnp.int32)
        row = jnp.clip(row, 0, codes.shape[0] - 1)
        ok = (codes[row] == c) & (c != _SENTINEL)
        return jnp.where(ok, row, -1)

    kids = []
    for c in range(8):
        ccode = ((node_prefix << _U32(3)) | _U32(c)) << _U32(4)
        ccode = ccode | (node_level + 1).astype(_U32)
        ccode = jnp.where(node_level < MAX_DEPTH, ccode, _SENTINEL)
        kids.append(code_to_row(ccode))
    node_children = jnp.stack(kids, axis=-1)  # (N,8)

    pcode = ((node_prefix >> _U32(3)) << _U32(4)) | (node_level - 1).astype(_U32)
    pcode = jnp.where(node_level > 0, pcode, _SENTINEL)
    node_parent = code_to_row(pcode)

    # ---- original object id -> its node row
    own_code = ((smorton >> (3 * (MAX_DEPTH - slevel)).astype(_U32)) << _U32(4)) | slevel.astype(_U32)
    own_code = jnp.where(skeys != _SENTINEL, own_code, _SENTINEL)
    sorted_obj_node = code_to_row(own_code)  # (O,) rows for sorted slots
    obj_node = jnp.zeros((O,), jnp.int32).at[perm].set(sorted_obj_node)

    return Octree(
        keys=skeys,
        perm=perm,
        obj_node=obj_node,
        node_valid=node_valid,
        node_level=node_level,
        node_box=node_box,
        node_start=node_start,
        node_end=node_end,
        node_sub_start=node_sub_start,
        node_sub_end=node_sub_end,
        node_children=node_children,
        node_parent=node_parent,
        n_nodes=n_nodes,
    )
