"""Scene model: JAX pytrees of padded SoA arrays.

The reference keeps the scene as pointer-linked C structs (cpu/headers/scene.h,
gpu/headers/scene.h:119-170) with three compile-time triangle layouts
(FRAGMENTED / AOS / SOA, gpu/headers/scene.h:64-114) and a deep-copying
`to_cuda` that rewrites device pointers (gpu/scene.cu:224-352). In JAX none of
that machinery is needed: the scene is a pytree of index-based SoA device
arrays — the moral equivalent of LAYOUT_SOA, the reference's default and
fastest layout — padded to tile multiples so every downstream kernel sees
static, tile-aligned shapes. Placement/replication across devices is a
`jax.sharding` annotation instead of cudaMemcpy plumbing.

All geometry/material/light numeric fields are differentiable leaves.
Image width/height and element counts are static (hashable aux data) so a
renderer jitted for one scene shape is reused across scenes of the same
padded size.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

# Light type codes — order matches the reference's enum usage
# (cpu/headers/scene.h light types; dispatch switch at cpu/light.c:40-97).
AMBIENT = 0
DIRECTIONAL = 1
POINT = 2


def _pytree_dataclass(cls, static_fields=()):
    """Register a dataclass as a pytree with the given fields static."""
    fields = [f.name for f in dataclasses.fields(cls)]
    data_fields = [f for f in fields if f not in static_fields]

    def flatten(obj):
        return (
            tuple(getattr(obj, f) for f in data_fields),
            tuple(getattr(obj, f) for f in static_fields),
        )

    def unflatten(aux, children):
        kwargs = dict(zip(data_fields, children))
        kwargs.update(dict(zip(static_fields, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@dataclasses.dataclass
class Camera:
    """Camera: `camera w h pos(3) u(3) v(3) fov` (cpu/parser.c:5-21).

    width/height are static ints (they fix the output image shape); the
    geometric parameters are differentiable f32 arrays.
    """

    width: int
    height: int
    position: Any  # (3,) f32
    u: Any  # (3,) f32
    v: Any  # (3,) f32
    fov: Any  # () f32, degrees


_pytree_dataclass(Camera, static_fields=("width", "height"))


@dataclasses.dataclass
class Lights:
    """All lights as SoA arrays of static length L (no padding; L is tiny).

    kind: static tuple of ints in {AMBIENT, DIRECTIONAL, POINT} — the light
          *types* are scene structure, not differentiable parameters, so they
          stay static and the shading loop specializes per light (no dead
          branches, no shadow rays for ambient lights).
    rgb:  (L,3) f32 raw file values (the reference re-quantizes via
          init_color at use sites, cpu/light.c:47-48 etc.).
    v:    (L,3) f32 — direction for DIRECTIONAL, position for POINT,
          zeros for AMBIENT (field `v` of struct light).
    """

    kind: tuple
    rgb: Any
    v: Any

    @property
    def count(self) -> int:
        return len(self.kind)


_pytree_dataclass(Lights, static_fields=("kind",))


@dataclasses.dataclass
class Geometry:
    """Triangle soup, SoA, padded to `pad_triangles` with degenerate triangles.

    vertices: (T,3,3) f32 — T triangles x 3 vertices x xyz.
    normals:  (T,3,3) f32 — per-vertex normals (un-normalized file values; the
              reference normalizes per-vertex at intersection time,
              cpu/hit.c:10-12).
    tri_obj:  (T,) int32 — owning object index (flattened LAYOUT_SOA analog of
              gpu/headers/scene.h:96-114; replaces the per-object pointer
              indirection with an index column).
    valid:    (T,) bool — False on padding rows.

    Vertex order within each triangle reproduces the reference's LIFO stack
    pop (cpu/parse_obj.c:29-40): file triangle (a,b,c) is stored as (c,b,a)
    and file triangles appear in reverse order — so intermediate
    floating-point values match the oracle exactly.

    obj_aabb / octree: optional acceleration data filled by
    `partition.apply.with_accel` (None = brute force, the reference's
    PARTITIONING_NONE). obj_aabb (O,2,3) per-object bounds; octree a
    partition.octree.NodeCull pytree (node boxes + parent links + object->
    node rows) that the jnp cull walks top-down per ray — the data-parallel
    recast of the reference's stackful DFS (gpu/hit.cu:120-169).
    """

    vertices: Any
    normals: Any
    tri_obj: Any
    valid: Any
    obj_aabb: Any = None
    octree: Any = None

    @property
    def padded_count(self) -> int:
        return self.vertices.shape[0]


_pytree_dataclass(Geometry)


@dataclasses.dataclass
class Materials:
    """Per-object Phong materials, padded to `pad_objects`.

    Defaults per init_object (cpu/parse_obj.c:3-20): ka=kd=ks=0, ns=0, ni=1,
    nr=0, d=1. `ni` and `d` are parsed but unused by the reference renderer
    (gpu/headers/scene.h:130-133); kept for parity.
    """

    ka: Any  # (O,3)
    kd: Any  # (O,3)
    ks: Any  # (O,3)
    ns: Any  # (O,)
    ni: Any  # (O,)
    nr: Any  # (O,)
    d: Any  # (O,)

    @property
    def padded_count(self) -> int:
        return self.ns.shape[0]


_pytree_dataclass(Materials)


@dataclasses.dataclass
class Scene:
    """Full scene pytree.

    n_triangles / n_objects are the true (unpadded) counts, static.
    """

    camera: Camera
    lights: Lights
    geometry: Geometry
    materials: Materials
    n_triangles: int
    n_objects: int


_pytree_dataclass(Scene, static_fields=("n_triangles", "n_objects"))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if x > 0 else m


def build_scene(
    camera: Camera,
    light_list: list[tuple[int, np.ndarray, np.ndarray]],
    objects: list[dict],
    pad_triangles: int = 128,
    pad_objects: int = 8,
) -> Scene:
    """Assemble a Scene from parsed host data (NumPy), with padding.

    objects: list of dicts with keys
      'vertices' (t,3,3), 'normals' (t,3,3), 'ka','kd','ks' (3,),
      'ns','ni','nr','d' scalars.
    """
    n_objects = len(objects)
    tri_counts = [o["vertices"].shape[0] for o in objects]
    n_triangles = int(sum(tri_counts))
    T = _round_up(max(n_triangles, 1), pad_triangles)
    O = _round_up(max(n_objects, 1), pad_objects)

    vertices = np.zeros((T, 3, 3), np.float32)
    normals = np.zeros((T, 3, 3), np.float32)
    # Degenerate padding triangles (all-zero vertices) never produce a valid
    # hit, but the normals of padding rows are set to a unit vector so the
    # reference's per-vertex normalize (cpu/hit.c:10-12) stays finite.
    normals[:, :, 2] = 1.0
    tri_obj = np.zeros((T,), np.int32)
    valid = np.zeros((T,), bool)

    pos = 0
    for i, o in enumerate(objects):
        t = o["vertices"].shape[0]
        if t:
            vertices[pos : pos + t] = o["vertices"]
            normals[pos : pos + t] = o["normals"]
            tri_obj[pos : pos + t] = i
            valid[pos : pos + t] = True
            pos += t

    def mat_field(key, default, dim=None):
        if dim is None:
            arr = np.full((O,), default, np.float32)
            for i, o in enumerate(objects):
                arr[i] = o[key]
        else:
            arr = np.full((O, dim), default, np.float32)
            for i, o in enumerate(objects):
                arr[i] = o[key]
        return arr

    materials = Materials(
        ka=mat_field("ka", 0.0, 3),
        kd=mat_field("kd", 0.0, 3),
        ks=mat_field("ks", 0.0, 3),
        ns=mat_field("ns", 0.0),
        ni=mat_field("ni", 1.0),
        nr=mat_field("nr", 0.0),
        d=mat_field("d", 1.0),
    )

    L = max(len(light_list), 1)
    kind = [AMBIENT] * L
    rgb = np.zeros((L, 3), np.float32)
    lv = np.zeros((L, 3), np.float32)
    # If the scene declares no lights, keep one AMBIENT light with rgb=0
    # (contributes nothing) so array shapes stay non-empty.
    for i, (k, c, v) in enumerate(light_list):
        kind[i] = int(k)
        rgb[i] = c
        lv[i] = v

    return Scene(
        camera=camera,
        lights=Lights(kind=tuple(kind), rgb=rgb, v=lv),
        geometry=Geometry(vertices=vertices, normals=normals, tri_obj=tri_obj, valid=valid),
        materials=materials,
        n_triangles=n_triangles,
        n_objects=n_objects,
    )


def scene_to_device(scene: Scene) -> Scene:
    """Move all array leaves to the default device as jnp arrays.

    The JAX replacement for `to_cuda` (gpu/scene.cu:224-352): no deep
    copies or pointer rewriting — just pytree device placement.
    """
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, scene)
