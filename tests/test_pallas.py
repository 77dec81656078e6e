"""Pallas intersection kernel tests.

On the CPU these run the sweep kernel through the Pallas interpreter — the
same kernel code the GPU compiles through Triton. The check against the jnp
path at real size on the card is chip_smoke.py's phase 4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.procedural import make_sphere_scene
from raytracing_gpu_tpu.models.scene import scene_to_device
from raytracing_gpu_tpu.ops import pallas_intersect as pk
from raytracing_gpu_tpu.ops.intersect import collide
from raytracing_gpu_tpu.render import render_scene


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(width=12, height=12, n_lat=8, n_lon=12)


def test_kernel_matches_jnp_collide(scene):
    """Winner from the kernel == the jnp argmin path (to f32 fusion jitter).

    The two paths are separately compiled programs; XLA may fuse/FMA
    differently, so distances agree only to ~1 ulp and an exact tie can in
    principle flip a winner. Require identical hit masks, ulp-close
    distances, and identical winners everywhere.
    """
    dev = scene_to_device(scene)
    rng = np.random.RandomState(1)
    R = 64
    o = jnp.asarray(rng.rand(R, 3).astype(np.float32) * 6.0 - 3.0)
    d = jnp.asarray(rng.rand(R, 3).astype(np.float32) * 2.0 - 1.0)
    jhit = collide(o, d, dev.geometry)
    phit = collide(o, d, dev.geometry, backend="pallas")
    np.testing.assert_array_equal(np.asarray(jhit.mask), np.asarray(phit.mask))
    m = np.asarray(jhit.mask)
    np.testing.assert_array_equal(np.asarray(jhit.obj)[m], np.asarray(phit.obj)[m])
    np.testing.assert_allclose(
        np.asarray(jhit.dist)[m], np.asarray(phit.dist)[m], rtol=5e-7
    )
    np.testing.assert_allclose(
        np.asarray(jhit.point)[m], np.asarray(phit.point)[m], rtol=5e-6, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(jhit.normal)[m], np.asarray(phit.normal)[m], rtol=5e-6, atol=1e-5
    )


def test_render_pallas_matches_jnp(scene):
    """Backends are separately compiled f32 programs: 1-ulp distance jitter
    can flip the winning triangle exactly on geometry edges, so compare with
    the same edge-aware tolerance used against the C oracle."""
    from raytracing_gpu_tpu.utils.compare import assert_images_close

    ref = render_scene(scene, RenderConfig(mode="cpu", quantize="match"))
    pal = render_scene(
        scene, RenderConfig(mode="cpu", quantize="match", backend="pallas")
    )
    assert_images_close(
        np.trunc(pal).astype(np.uint8), np.trunc(ref).astype(np.uint8),
        tol=1, context="pallas-vs-jnp",
    )


@pytest.mark.parametrize("partitioning", ["none", "aabb", "octree"])
def test_render_pallas_partitioning_modes_identical(scene, partitioning):
    """The kernel-side culling modes (brute force / flat tile AABBs /
    hierarchical octree-tile traversal) are semantically invisible: every
    mode must produce the IDENTICAL image from the same backend — the
    runtime form of the reference's 'every build-matrix variant renders the
    same scenes' contract (gpu/CMakeLists.txt:4-15)."""
    ref = render_scene(
        scene, RenderConfig(mode="cpu", quantize="match", backend="pallas",
                            partitioning="none")
    )
    pal = render_scene(
        scene,
        RenderConfig(mode="cpu", quantize="match", backend="pallas",
                     partitioning=partitioning),
    )
    np.testing.assert_array_equal(ref, pal)


def test_partitioning_modes_actually_cull(scene):
    """Non-vacuity check: with culling on, the pair-tile mask has culled
    entries for real primary rays; 'none' is all ones (true brute force)."""
    dev = scene_to_device(scene)
    geo = dev.geometry
    pack = pk.pack_geometry(geo.vertices, geo.valid)
    rng = np.random.RandomState(3)
    R = 2 * pk.TILE_R
    o = jnp.broadcast_to(jnp.asarray([0.0, 2.0, -8.0], jnp.float32), (R, 3))
    d = jnp.asarray(rng.rand(R, 3).astype(np.float32) * 2.0 - 1.0)
    op, dp, _ = pk.pack_rays(o, d)
    none = np.asarray(pk.tile_cull_mask_hierarchical(op, dp, pack, "none"))
    aabb = np.asarray(pk.tile_cull_mask_hierarchical(op, dp, pack, "aabb"))
    octr = np.asarray(pk.tile_cull_mask_hierarchical(op, dp, pack, "octree"))
    assert none.all(), "partitioning='none' must be brute force"
    assert aabb.sum() < none.sum(), "aabb mode must cull some pair tiles"
    assert octr.sum() < none.sum(), "octree mode must cull some pair tiles"


def test_hierarchical_mask_conservative_large_scene():
    """Octree-mode culling on a >64-tile scene (interval levels engaged):
    no (ray tile, tri tile) pair holding a true winner may be culled."""
    from raytracing_gpu_tpu.models.procedural import make_sphere_grid_scene

    scene = make_sphere_grid_scene(nx=4, ny=4, nz=2, n_lat=16, n_lon=20)
    dev = scene_to_device(scene)
    geo = dev.geometry
    assert geo.vertices.shape[0] // pk.TILE_T > 64  # interval path engaged
    pack = pk.pack_geometry(geo.vertices, geo.valid)
    rng = np.random.RandomState(4)
    R = 2 * pk.TILE_R
    # tile 0: coherent primary rays (camera origin, narrow cone at one
    # sphere) — the case tile-granularity culling must pay off on;
    # tile 1: scattered rays everywhere — the adversarial case that must
    # stay conservative (intervals unconstrained -> nothing culled there)
    cam = np.asarray(scene.camera.position, np.float32)
    target = np.array([3.75, 3.75, 1.25], np.float32)  # corner sphere
    d_coh = (target + rng.rand(pk.TILE_R, 3).astype(np.float32) * 0.6 - cam)
    o = np.concatenate([np.broadcast_to(cam, (pk.TILE_R, 3)),
                        rng.rand(pk.TILE_R, 3).astype(np.float32) * 10 - 5])
    d = np.concatenate([d_coh,
                        rng.rand(pk.TILE_R, 3).astype(np.float32) * 2 - 1])
    o, d = jnp.asarray(o.astype(np.float32)), jnp.asarray(d.astype(np.float32))
    op, dp, _ = pk.pack_rays(o, d)
    mask = np.asarray(pk.tile_cull_mask_hierarchical(op, dp, pack, "octree"))
    from raytracing_gpu_tpu.ops.intersect import _mt_core

    dist, *_ = _mt_core(o, d, geo.vertices[pack.perm], geo.normals[pack.perm],
                        geo.valid[pack.perm], 1e-7, 0.01)
    dn = np.asarray(dist)
    win = dn.argmin(axis=1)
    missed_cull = [
        (r, int(win[r]) // pk.TILE_T)
        for r in range(R)
        if np.isfinite(dn[r, win[r]])
        and mask[win[r] // pk.TILE_T, r // pk.TILE_R] != 1
    ]
    assert not missed_cull, missed_cull
    # the coherent tile must actually cull most triangle tiles (the entire
    # point of the hierarchy); a handful survive around the target sphere
    coherent_active = int(mask[:, 0].sum())
    assert coherent_active < mask.shape[0] // 4, coherent_active


def test_cluster_perm_is_permutation(scene):
    """cluster_triangles returns a true permutation with invalid rows last."""
    dev = scene_to_device(scene)
    geo = dev.geometry
    perm, tile_aabb, tile_nonempty = jax.jit(pk.cluster_triangles)(
        geo.vertices, geo.valid
    )
    p = np.asarray(perm)
    T = geo.vertices.shape[0]
    assert sorted(p.tolist()) == list(range(T))
    val = np.asarray(geo.valid)
    n_valid = int(val.sum())
    assert val[p][:n_valid].all() and not val[p][n_valid:].any()
    # every valid triangle's vertices lie inside its tile AABB
    verts = np.asarray(geo.vertices)[p]
    boxes = np.asarray(tile_aabb)
    for j in range(boxes.shape[0]):
        sl = slice(j * pk.TILE_T, (j + 1) * pk.TILE_T)
        vv = verts[sl][val[p][sl]]
        if vv.size:
            assert bool(np.asarray(tile_nonempty)[j])
            assert (vv.reshape(-1, 3) >= boxes[j, 0] - 1e-6).all()
            assert (vv.reshape(-1, 3) <= boxes[j, 1] + 1e-6).all()


def test_cluster_cull_mask_conservative(scene):
    """No (ray tile, clustered tri tile) holding a true winner is culled
    by the exact per-ray leaf-tile mask (the 'aabb' partitioning mode)."""
    dev = scene_to_device(scene)
    geo = dev.geometry
    rng = np.random.RandomState(2)
    R = pk.TILE_R
    o = jnp.asarray(rng.rand(R, 3).astype(np.float32) * 6.0 - 3.0)
    d = jnp.asarray(rng.rand(R, 3).astype(np.float32) * 2.0 - 1.0)
    perm, tile_aabb, tile_nonempty = pk.cluster_triangles(geo.vertices, geo.valid)
    op, dp, _ = pk.pack_rays(o, d)
    mask = np.asarray(
        pk.tile_cull_mask_packed(op, dp, tile_aabb, tile_nonempty)
    )  # (nT, 1)
    from raytracing_gpu_tpu.ops.intersect import _mt_core

    verts_c = geo.vertices[perm]
    dist, *_ = _mt_core(o, d, verts_c, geo.normals[perm], geo.valid[perm],
                        1e-7, 0.01)
    dn = np.asarray(dist)
    win = dn.argmin(axis=1)
    for r in range(R):
        if np.isfinite(dn[r, win[r]]):
            assert mask[win[r] // pk.TILE_T, 0] == 1


def test_hit_aabb_forward_behind_ray():
    """Forward slab test: box behind the origin culled, ahead/containing hit."""
    from raytracing_gpu_tpu.partition.aabb import hit_aabb_forward

    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    boxes = jnp.asarray(
        [
            [[-1.0, -1.0, 2.0], [1.0, 1.0, 3.0]],    # ahead -> hit
            [[-1.0, -1.0, -3.0], [1.0, 1.0, -2.0]],  # behind -> miss
            [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]],   # contains origin -> hit
        ],
        jnp.float32,
    )
    got = np.asarray(hit_aabb_forward(o, d, boxes))[0]
    np.testing.assert_array_equal(got, [True, False, True])


def _rays(R, seed, parked_frac=0.0):
    rng = np.random.RandomState(seed)
    o = rng.rand(R, 3).astype(np.float32) * 6.0 - 3.0
    d = rng.rand(R, 3).astype(np.float32) * 2.0 - 1.0
    parked = rng.rand(R) < parked_frac
    o[parked] = 3e29  # dead rays, parked the way render.py parks them
    d[parked] = 0.0
    return jnp.asarray(o), jnp.asarray(d)


def _ref_dists(o, d, vertices, normals, valid):
    """(R, T) distances of the plain all-pairs path (inf on reject)."""
    from raytracing_gpu_tpu.ops.intersect import _mt_core

    return np.asarray(_mt_core(o, d, vertices, normals, valid, 1e-7, 0.01)[0])


def _check_winners(dist, idx, ref, o, max_flip_frac=0.02):
    """Kernel (dist, idx in original triangle order) against the plain
    path's (R, T) distances. Two compiled f32 programs may resolve a ray
    grazing a triangle edge differently (accept vs reject — the edge-flip
    class the image comparator absorbs), and on a grazing pair 1/a
    amplifies a contraction difference far beyond an ulp, so a small share
    of rays may disagree; every other ray must hit the plain path's nearest
    triangle at the same distance up to rounding, and the same triangle
    unless the two best distances are that close."""
    R = ref.shape[0]
    d1 = ref.min(axis=1)
    win = ref.argmin(axis=1)
    rest = ref.copy()
    rest[np.arange(R), win] = np.inf
    d2 = rest.min(axis=1)
    hit = np.isfinite(dist)
    kd = ref[np.arange(R), np.where(hit, idx, 0)]  # plain dist of kernel's pick
    agree = np.where(hit, _near(kd, d1, o) & _near(dist, kd, o),
                     ~np.isfinite(d1))
    assert (~agree).sum() <= max_flip_frac * R, (~agree).sum()
    ok = agree & hit
    assert ok.sum() > R // 4
    sure = ok & ~_near(d2, d1, o)
    np.testing.assert_array_equal(idx[sure], win[sure])


def _near(a, b, o):
    """|a - b| within 4 ulp of the larger of the distance and the ray
    origin's coordinates: the reference distance |fl(o + nd*t|d|) - o|
    cancels against the origin, so FMA-contraction differences between two
    compiled programs show up at the origin's ulp, not the distance's."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(np.abs(a), np.abs(np.asarray(o)).max(axis=1))
    with np.errstate(invalid="ignore"):  # inf - inf: not near
        return np.abs(a - b) <= 4 * 2.0 ** -23 * scale


@pytest.mark.parametrize("partitioning", ["none", "aabb", "octree"])
def test_sweep_matches_mt_core(partitioning):
    """The sweep kernel (interpret mode) against the plain all-pairs path,
    for every culling structure (see _check_winners). Octree mode needs > 64 triangle tiles to engage the
    interval levels, hence the grid scene."""
    from raytracing_gpu_tpu.models.procedural import make_sphere_grid_scene

    scene = make_sphere_grid_scene(width=8, height=8, nx=4, ny=4, nz=2,
                                   n_lat=16, n_lon=20)
    geo = scene_to_device(scene).geometry
    pack = pk.pack_geometry(geo.vertices, geo.valid)
    assert pack.tri.shape[1] // pk.TILE_T > 64
    cam = jnp.asarray(scene.camera.position, jnp.float32)
    o_rand, d_rand = _rays(2 * pk.TILE_R, seed=11, parked_frac=0.2)
    o = jnp.concatenate([jnp.broadcast_to(cam, (2 * pk.TILE_R, 3)),
                         o_rand * 3.0])
    d = jnp.concatenate([-cam + d_rand * 4.0, d_rand])  # at the grid, wild
    op, dp, R = pk.pack_rays(o, d)
    mask = pk.tile_cull_mask_hierarchical(op, dp, pack, partitioning)
    dist, idx = pk.nearest_hit_pallas(op, dp, pack.tri, mask, 1e-7, 0.01)
    dist, idx = np.asarray(dist)[:R], np.asarray(pack.perm)[np.asarray(idx)[:R]]
    ref = _ref_dists(o, d, geo.vertices, geo.normals, geo.valid)
    assert (~np.isfinite(ref.min(axis=1))).sum() > R // 8
    _check_winners(dist, idx, ref, o)


def test_dist_sweep_matches_collide_dist(scene):
    """The dist-only sweep (shadow rays) against the jnp collide_dist:
    the same rays hit, at distances that agree to f32 rounding (the
    dist-only sweep measures t*|d|, collide_dist the reference's
    |hit - origin| chain — ~1 ulp apart). Parked rays miss."""
    from raytracing_gpu_tpu.ops.intersect import collide_dist

    geo = scene_to_device(scene).geometry
    o, d = _rays(3 * pk.TILE_R + 5, seed=7, parked_frac=0.3)
    pack = pk.pack_geometry(geo.vertices, geo.valid)
    op, dp, R = pk.pack_rays(o, d)
    mask = pk.tile_cull_mask_hierarchical(op, dp, pack, "octree")
    got = np.asarray(pk.nearest_dist_pallas(op, dp, pack.tri, mask,
                                            1e-7, 0.01))[:R]
    ref = np.asarray(collide_dist(o, d, geo))  # 0.0 on miss
    np.testing.assert_array_equal(np.isfinite(got), ref != 0.0)
    assert (ref != 0.0).any() and (ref == 0.0).any()
    hit = ref != 0.0
    np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-6)
    assert not np.isfinite(got[np.asarray(o)[:, 0] > 1e20]).any()


def test_tile_worklist_ascending_exact_count():
    """Each row of the worklist lists exactly its active columns, in
    ascending order (the order the first-occurrence tie-break needs)."""
    rng = np.random.RandomState(5)
    mask = (rng.rand(7, 13) < 0.35).astype(np.int32)
    mask[3] = 0  # a row with nothing to do
    mask[4] = 1  # and one with everything
    order, count = pk.tile_worklist(jnp.asarray(mask))
    order, count = np.asarray(order), np.asarray(count)
    for a in range(mask.shape[0]):
        active = np.nonzero(mask[a])[0]
        assert count[a] == len(active)
        np.testing.assert_array_equal(order[a, :count[a]], active)


@pytest.mark.parametrize("n_rays,n_lat", [(pk.TILE_R + 3, 6), (5, 9)])
def test_sweep_padding_not_multiple_of_tile(n_rays, n_lat):
    """Ray and triangle counts that are not tile multiples: padded ray lanes
    and padded triangle slots never hit, and the real rays get the plain
    path's winners."""
    scene = make_sphere_scene(width=8, height=8, n_lat=n_lat, n_lon=9,
                              pad_triangles=8)
    geo = scene_to_device(scene).geometry
    T = geo.vertices.shape[0]
    assert T % pk.TILE_T and n_rays % pk.TILE_R
    o = jnp.broadcast_to(jnp.asarray([0.0, 2.0, -8.0], jnp.float32),
                         (n_rays, 3))
    d = jnp.asarray(np.random.RandomState(2).rand(n_rays, 3)
                    .astype(np.float32) * [0.6, 0.4, 0.2] + [-0.3, -0.3, 1.0])
    tri = pk.pack_triangles(geo.vertices, geo.valid)
    op, dp, R = pk.pack_rays(o, d)
    assert R == n_rays and tri.shape[1] % pk.TILE_T == 0
    mask = jnp.ones((tri.shape[1] // pk.TILE_T, op.shape[1] // pk.TILE_R),
                    jnp.int32)
    dist, idx = (np.asarray(a) for a in pk.nearest_hit_pallas(
        op, dp, tri, mask, 1e-7, 0.01))
    assert not np.isfinite(dist[R:]).any()
    assert (idx[:R][np.isfinite(dist[:R])] < T).all()
    ref = _ref_dists(o, d, geo.vertices, geo.normals, geo.valid)
    _check_winners(dist[:R], idx[:R], ref, o)


@pytest.mark.parametrize("second", [3, pk.SUB_T + 3, pk.TILE_T + 3],
                         ids=["same-block", "next-block", "next-tile"])
def test_coincident_triangles_lower_slot_wins(second):
    """Two coincident triangles give every ray an exact distance tie; the
    lower slot must win whether the copy sits in the same pair block, a
    later block of the tile, or a later triangle tile (the reference's
    first-strictly-smaller rule, cpu/hit.c:60)."""
    T = pk.TILE_T + 8
    far = np.array([[0.0, 0.0, 50.0], [1.0, 0.0, 50.0], [0.0, 1.0, 50.0]],
                   np.float32)
    verts = np.tile(far, (T, 1, 1)) + np.arange(T, dtype=np.float32)[:, None, None] * [3.0, 0, 0]
    tri0 = np.array([[-1.0, -1.0, 5.0], [3.0, -1.0, 5.0], [-1.0, 3.0, 5.0]],
                    np.float32)
    verts[1] = tri0
    verts[second] = tri0
    tri = pk.pack_triangles(jnp.asarray(verts), jnp.ones((T,), bool))
    rng = np.random.RandomState(9)
    R = pk.TILE_R
    o = np.zeros((R, 3), np.float32)
    d = np.concatenate([rng.rand(R, 2).astype(np.float32) * 0.4 - 0.2,
                        np.ones((R, 1), np.float32)], axis=1)
    op, dp, _ = pk.pack_rays(jnp.asarray(o), jnp.asarray(d))
    mask = jnp.ones((tri.shape[1] // pk.TILE_T, 1), jnp.int32)
    dist, idx = pk.nearest_hit_pallas(op, dp, tri, mask, 1e-7, 0.01)
    assert np.isfinite(np.asarray(dist)).all()
    np.testing.assert_array_equal(np.asarray(idx), 1)


def _onehot_rows(table, idx):
    oh = (np.asarray(idx)[:, None] == np.arange(table.shape[0])[None, :])
    return oh.astype(np.float32) @ np.asarray(table, np.float32)


def test_winner_rows_gather_matches_onehot(scene):
    """collide gathers the winner's row of the clustered table (geometry,
    normals, object id and materials); that equals the one-hot product
    (every element one 1.0*x term), and the gradient of a gathered value
    w.r.t. the materials is the scatter-add adjoint."""
    import dataclasses

    dev = scene_to_device(scene)
    geo, mats = dev.geometry, dev.materials
    pack = pk.pack_geometry(geo.vertices, geo.valid, geo.normals,
                            geo.tri_obj, mats)
    assert pack.table.shape[1] == pk.TABLE_WIDTH_MAT
    obj = np.asarray(geo.tri_obj)[np.asarray(pack.perm)]
    table_mat = np.concatenate([np.asarray(mats.ka), np.asarray(mats.kd),
                                np.asarray(mats.ks),
                                np.asarray(mats.ns)[:, None],
                                np.asarray(mats.nr)[:, None]], axis=1)
    T = obj.shape[0]
    np.testing.assert_array_equal(np.asarray(pack.table)[:T, pk.COL_MAT],
                                  _onehot_rows(table_mat, obj))
    o, d = _rays(pk.TILE_R, seed=1)
    hit = collide(o, d, geo, backend="pallas", pack=pack)
    m = np.asarray(hit.mask)
    assert m.any()
    np.testing.assert_array_equal(np.asarray(hit.mat)[m],
                                  _onehot_rows(table_mat, np.asarray(hit.obj))[m])

    w = jnp.asarray(np.random.RandomState(4).rand(o.shape[0]), jnp.float32)

    def loss(kd):
        mats2 = dataclasses.replace(mats, kd=kd)
        p = pk.pack_geometry(geo.vertices, geo.valid, geo.normals,
                             geo.tri_obj, mats2)
        h = collide(o, d, geo, backend="pallas", pack=p)
        return jnp.sum(jnp.where(h.mask, w, 0.0) * h.mat[:, 4])  # kd green

    g = np.asarray(jax.grad(loss)(mats.kd))
    expect = np.zeros(np.asarray(mats.kd).shape, np.float32)
    np.add.at(expect[:, 1], np.asarray(hit.obj)[m], np.asarray(w)[m])
    np.testing.assert_allclose(g, expect, rtol=1e-6)


def test_material_rows_gather_matches_onehot(scene):
    """material_rows is a plain gather: equal to the one-hot product, with
    the scatter-add adjoint as its gradient."""
    import dataclasses

    from raytracing_gpu_tpu.ops.shading import material_rows

    mats = scene_to_device(scene).materials
    O = np.asarray(mats.kd).shape[0]
    obj = jnp.asarray(np.random.RandomState(3).randint(0, O, 50), jnp.int32)
    table = np.concatenate([np.asarray(mats.ka), np.asarray(mats.kd),
                            np.asarray(mats.ks), np.asarray(mats.ns)[:, None],
                            np.asarray(mats.nr)[:, None]], axis=1)
    np.testing.assert_array_equal(np.asarray(material_rows(mats, obj)),
                                  _onehot_rows(table, obj))
    w = jnp.arange(50, dtype=jnp.float32)
    g = jax.grad(lambda nr: jnp.sum(
        w * material_rows(dataclasses.replace(mats, nr=nr), obj)[:, 10]))(
            mats.nr)
    expect = np.zeros(O, np.float32)
    np.add.at(expect, np.asarray(obj), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(g), expect)


@pytest.mark.parametrize("platform,expect", [("cpu", True), ("gpu", False),
                                             ("metal", None)])
def test_interpret_only_on_cpu(monkeypatch, platform, expect):
    """The Pallas interpreter runs only on the CPU (the tests); on the GPU
    the kernel compiles; any other platform has no kernel and raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expect is None:
        with pytest.raises(NotImplementedError):
            pk._interpret()
    else:
        assert pk._interpret() is expect
