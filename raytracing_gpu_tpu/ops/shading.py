"""Phong shading with hard shadows — `apply_light` semantics.

Reproduces cpu/light.c (and its GPU twin gpu/light.cu) including every quirk:

- AMBIENT: light_rgb (*) ka  (cpu/light.c:44-50).
- DIRECTIONAL (cpu/light.c:51-74): shadow ray from the hit point with
  direction -light.v; if unoccluded, diffuse = (light_rgb (*) kd) * dot(L, N)
  with L = -light.v and N the UNnormalized interpolated normal; then specular
  with an incident ray of direction light.v whose origin is offset by
  -10*direction from the hit point (cpu/light.c:62-66).
- POINT (cpu/light.c:69-97): QUIRK — L = -light.v, i.e. the light *position*
  negated, not a direction toward the light; N is flipped when dot(L,N) < 0;
  shadow ray direction = light.v - hit (unnormalized); diffuse scaled by
  dot(L,N) * 1/dist with dist = |light.v - hit|; specular incident direction
  = light.v - hit with the same -10 origin offset. The specular normal is the
  ORIGINAL unflipped N (the reference passes `point` by value).
- Shadow test `has_direct_hit` (cpu/light.c:24-31): the nested
  `if (fdist < 1) if (fdist == 0)` makes the distance check dead code — ANY
  hit occludes, regardless of distance to the light. Reproduced: occluded
  iff collide_dist != 0.
- Specular `apply_specular` (cpu/light.c:7-22): V = incident.origin - hit,
  R = incident.dir - 2*dot(N, incident.dir)*N, Ls = max(dot(R^,V^),0)^ns,
  contribution ks * Ls (with pow(0,0)=1, so ns=0 gives constant specular —
  another reproduced reference behavior).

Light *types* are static scene structure, so the light loop is specialized in
Python per light: ambient lights cost two vector ops; only directional/point
lights pay for a batched shadow `collide_dist`. Within each light the math is
mask-predicated over the whole ray batch (uniform batched control flow).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracing_gpu_tpu.models.scene import AMBIENT, DIRECTIONAL, POINT
from raytracing_gpu_tpu.ops.colors import ColorOps
from raytracing_gpu_tpu.ops.intersect import Hit, collide_any


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def material_rows(mats, obj):
    """(R, 11) [ka kd ks ns nr] of each hit object — one row gather from
    the stacked material table instead of one per field. Differentiable
    into the material tables (the gather's adjoint is a scatter-add)."""
    table = jnp.concatenate(
        [mats.ka, mats.kd, mats.ks, mats.ns[:, None], mats.nr[:, None]],
        axis=1,
    )  # (O, 11)
    return table[obj]


def _normalize(a):
    # exact when |a| > 0; guarded against 0/0 on dead/masked lanes so that
    # backward-mode cotangents stay NaN-free
    s = jnp.sum(a * a, axis=-1, keepdims=True)
    return a / jnp.sqrt(jnp.where(s > 0.0, s, 1.0))


def apply_specular(color, inc_origin, inc_dir, hit_point, normal, ks, ns, cops: ColorOps):
    """apply_specular (cpu/light.c:7-22). All args batched (..., R, 3) /
    (..., R): shade() batches a leading lights axis on top of the ray
    axis, so broadcasting uses [..., None] throughout — per-element
    arithmetic is unchanged (uint8-identical renders, measured on the
    full-res corpus)."""
    kcolor = cops.init(jnp.broadcast_to(ks, inc_dir.shape))
    V = inc_origin - hit_point
    R = inc_dir - normal * (2.0 * _dot(normal, inc_dir))[..., None]
    Rn = _normalize(R)
    Vn = _normalize(V)
    Ls = jnp.power(jnp.maximum(_dot(Rn, Vn), 0.0), ns)
    return cops.add(color, cops.mul(kcolor, Ls[..., None]))


def shade(scene, hit: Hit, cops: ColorOps, mt_eps=1e-7, self_hit_eps=0.01,
          scene_axis=None, backend="jnp", pack=None, partitioning="octree"):
    """apply_light (cpu/light.c:33-99) for a batch of hits.

    Returns (R,3) colors in the cops domain. Rays with hit.mask False get
    garbage (caller masks). Lights accumulate in declaration order with the
    reference's clamped accumulation.
    """
    R = hit.point.shape[0]
    lights = scene.lights
    mats = scene.materials
    # winning object's materials: already gathered with the winner row on
    # the kernel backend; one table gather otherwise
    mrows = hit.mat if hit.mat is not None else material_rows(mats, hit.obj)
    ka = mrows[:, 0:3]  # (R,3)
    kd = mrows[:, 3:6]
    ks = mrows[:, 6:9]
    ns = mrows[:, 9]
    N = hit.normal
    hp = hit.point

    # ---- one batched shadow pass for ALL non-ambient lights: the reference
    # traces one shadow ray per light per pixel serially (cpu/light.c:58,80);
    # here the K lights' shadow batches concatenate into a single (K*R)
    # intersection call — same rays, same math, 1/K the kernel launches.
    shadow_of = {}
    sdirs = []
    for li, kind in enumerate(lights.kind):
        if kind == DIRECTIONAL:
            shadow_of[li] = len(sdirs)
            sdirs.append(jnp.broadcast_to(-lights.v[li], (R, 3)))
        elif kind == POINT:
            shadow_of[li] = len(sdirs)
            sdirs.append(lights.v[li][None, :] - hp)  # cpu/light.c:80
    if sdirs:
        K = len(sdirs)
        # Missed rays' hit points are garbage; their shadow results are
        # discarded (caller masks on hit.mask), so park them as degenerate
        # rays (origin far outside every scene AABB, zero direction): the
        # kernel backends' forward slab test culls them instead of sweeping
        # garbage rays against all triangles (~86% of primary rays miss on
        # a typical mesh scene), and zero direction makes Möller–Trumbore
        # reject them (a == 0) wherever culling is off.
        hp_shadow = jnp.where(hit.mask[:, None], hp, 3e29)
        so = jnp.tile(hp_shadow, (K, 1))
        sd = jnp.concatenate(sdirs, axis=0)
        sd = jnp.where(jnp.tile(hit.mask, (K,))[:, None], sd, 0.0)
        # boolean ANY-hit (the has_direct_hit quirk: any hit occludes,
        # distance is dead code)
        occ = collide_any(so, sd, scene.geometry, mt_eps, self_hit_eps,
                          scene_axis, backend, pack, partitioning)
        occluded_all = occ.reshape(K, R)
    else:
        occluded_all = None

    # ---- same-kind lights BATCHED over a leading K axis: the per-light
    # Python loop emitted ~10 small (R,3) fusions per light; one (K,R,3)
    # pass does the identical per-element arithmetic in K-fold larger
    # kernels (renders uint8-identical). The per-light
    # CONTRIBUTIONS are still folded in declaration order below — the
    # reference's saturating accumulation order is untouched.
    contribs = {}
    d_ix = [li for li, k in enumerate(lights.kind) if k == DIRECTIONAL]
    p_ix = [li for li, k in enumerate(lights.kind) if k == POINT]
    if d_ix:
        Kd = len(d_ix)
        lv = jnp.stack([lights.v[li] for li in d_ix])     # (Kd,3)
        rgb = jnp.stack([lights.rgb[li] for li in d_ix])  # (Kd,3)
        lrgb = cops.init(jnp.broadcast_to(rgb[:, None, :], (Kd, R, 3)))
        Ldir = jnp.broadcast_to(-lv[:, None, :], (Kd, R, 3))
        kd_b = cops.init(jnp.broadcast_to(kd[None], (Kd, R, 3)))
        dif = cops.mul(cops.mul2(lrgb, kd_b), _dot(Ldir, N[None])[..., None])
        inc_dir = jnp.broadcast_to(lv[:, None, :], (Kd, R, 3))
        inc_org = hp[None] + inc_dir * -10.0
        con = apply_specular(dif, inc_org, inc_dir, hp[None], N[None],
                             ks[None], ns[None], cops)
        for j, li in enumerate(d_ix):
            occluded = occluded_all[shadow_of[li]]
            contribs[li] = jnp.where(occluded[:, None], 0.0, con[j])
    if p_ix:
        Kp = len(p_ix)
        lv = jnp.stack([lights.v[li] for li in p_ix])
        rgb = jnp.stack([lights.rgb[li] for li in p_ix])
        lrgb = cops.init(jnp.broadcast_to(rgb[:, None, :], (Kp, R, 3)))
        Lp = jnp.broadcast_to(-lv[:, None, :], (Kp, R, 3))
        flip = _dot(Lp, N[None]) < 0.0
        # N flipped toward the light per light; specular uses the ORIGINAL
        # unflipped N (the reference passes `point` by value)
        Np = jnp.where(flip[..., None], -N[None], N[None])
        dvec = lv[:, None, :] - hp[None]
        dist = jnp.sqrt(_dot(dvec, dvec))
        # guard: dist == 0 only when the hit point IS the light position
        # (the reference would divide by zero there too)
        safe_dist = jnp.where(dist > 0.0, dist, 1.0)
        kd_b = cops.init(jnp.broadcast_to(kd[None], (Kp, R, 3)))
        dif = cops.mul(cops.mul2(lrgb, kd_b),
                       (_dot(Lp, Np) * (1.0 / safe_dist))[..., None])
        inc_dir = dvec
        inc_org = hp[None] + inc_dir * -10.0
        con = apply_specular(dif, inc_org, inc_dir, hp[None], N[None],
                             ks[None], ns[None], cops)
        for j, li in enumerate(p_ix):
            occluded = occluded_all[shadow_of[li]]
            contribs[li] = jnp.where(occluded[:, None], 0.0, con[j])

    color = cops.zeros((R,))
    for li, kind in enumerate(lights.kind):  # declaration-order fold
        if kind == AMBIENT:
            lrgb = cops.init(jnp.broadcast_to(lights.rgb[li], (R, 3)))
            contrib = cops.mul2(lrgb, cops.init(ka))
        elif li in contribs:
            contrib = contribs[li]
        else:  # default: continue (cpu/light.c:94-96)
            continue
        color = cops.add(color, contrib)
    return color
