"""Bit-exact C-semantics mirror of the reference CPU renderer (numpy f32).

Reimplements cpu/raytracer.c `trace` + cpu/hit.c + cpu/light.c + cpu/colors.c
in numpy f32 with the reference's EXACT operation order and rounding
(left-assoc f32 dots, double sqrt/pow truncated to f32, no FMA — gcc -O2 on
baseline x86-64 emits plain SSE f32 ops), instrumented to log per-bounce
winners and shading terms. Used to root-cause the spheres center-column
stripe: compare mirror vs golden (must match exactly), then our pipeline vs
mirror to find the diverging operation (tests/test_seam_tie.py).

Usage: python tests/c_mirror.py [scene] [w] [h] [px_row px_col ...]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np

f32 = np.float32
f64 = np.float64


def fdot(a, b):
    """Left-associated f32 dot: ((ax*bx + ay*by) + az*bz). a, b: (...,3)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def flength(a):
    """vector3_length: f32 dot -> double sqrt -> f32 (cpu/vector3-extern.c)."""
    return np.sqrt(fdot(a, a).astype(f64) if np.ndim(a) > 1
                   else f64(fdot(a, a))).astype(f32)


def fnormalize(a):
    """vector3_normalize: componentwise f32 divide by f32 length."""
    root = flength(a)
    return a / np.asarray(root, f32)[..., None] if np.ndim(a) > 1 else a / root


def fcross(a, b):
    out = np.empty(np.broadcast(a, b).shape, f32)
    out[..., 0] = a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1]
    out[..., 1] = a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2]
    out[..., 2] = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return out


def init_color(rgb):
    """init_color: *255 then clamp [0,255] (cpu/colors.c:3-22)."""
    return np.clip(rgb * f32(255.0), f32(0.0), f32(255.0))


def color_add(a, b):
    """saturating add, per channel min(a+b, 255) (no lower clamp)."""
    return np.minimum(a + b, f32(255.0))


def color_mul(a, coef):
    return init_color(a / f32(255.0) * coef)


def color_mul2(a, b):
    return init_color((a / f32(255.0)) * (b / f32(255.0)))


class MirrorScene:
    """SoA f32 arrays in the reference's object/triangle iteration order."""

    def __init__(self, scene):
        g = scene.geometry
        valid = np.asarray(g.valid)
        self.tri_v = np.asarray(g.vertices, f32)[valid]  # (T,3,3)
        self.tri_n = np.asarray(g.normals, f32)[valid]
        self.tri_obj = np.asarray(g.tri_obj)[valid]
        m = scene.materials
        self.ka = np.asarray(m.ka, f32)
        self.kd = np.asarray(m.kd, f32)
        self.ks = np.asarray(m.ks, f32)
        self.ns = np.asarray(m.ns, f32)
        self.nr = np.asarray(m.nr, f32)
        li = scene.lights
        self.l_type = np.asarray(li.kind)  # 0 ambient, 1 directional, 2 point
        self.l_rgb = np.asarray(li.rgb, f32)
        self.l_v = np.asarray(li.v, f32)
        self.cam = scene.camera
        # precompute per-triangle normalized normals (ray_intersect does this
        # per call; values identical every call)
        self.nn = np.stack([fnormalize(self.tri_n[:, k]) for k in range(3)], 1)


def ray_intersect_all(sc: MirrorScene, origin, direction):
    """Vectorized cpu/hit.c:4-44 over all triangles.

    Returns (ok (T,), out (T,3), normal (T,3), dist (T,)) where dist is the
    REFERENCE's |out - origin| (recomputed from the rounded hit point,
    cpu/hit.c:57) and also returns t*|dir| for comparison.
    """
    EPS = f32(1e-7)
    v0 = sc.tri_v[:, 0]
    e1 = sc.tri_v[:, 1] - v0
    e2 = sc.tri_v[:, 2] - v0
    h = fcross(direction[None, :], e2)
    a = fdot(e1, h)
    ok = ~((a > -EPS) & (a < EPS))
    f = f32(1.0) / np.where(ok, a, f32(1.0))
    s = origin[None, :] - v0
    u = f * fdot(s, h)
    ok &= ~((u < 0.0) | (u > 1.0))
    q = fcross(s, e1)
    v = f * fdot(np.broadcast_to(direction, q.shape), q)
    ok &= ~((v < 0.0) | (u + v > 1.0))
    t = f * fdot(e2, q)
    ok &= t > EPS
    dlen = flength(direction)
    ndir = fnormalize(direction)
    t2 = ndir[None, :] * (t * dlen)[:, None]  # vector3_scale(ndir, t*|d|)
    out = origin[None, :] + t2
    normal = (sc.nn[:, 0] * (f32(1.0) - u - v)[:, None]
              + sc.nn[:, 1] * u[:, None]) + sc.nn[:, 2] * v[:, None]
    dist_ref = np.sqrt(fdot(out - origin[None, :],
                            out - origin[None, :]).astype(f64)).astype(f32)
    dist_t = t * dlen
    return ok, out, normal, dist_ref, dist_t


def collide(sc: MirrorScene, origin, direction, dist_mode="ref"):
    """cpu/hit.c:46-91 — returns (hit, out, normal, obj, dist, tri_idx).

    dist_mode: "ref" selects by |out-origin| (the reference); "t" selects by
    t*|dir| (our kernels) — for bisecting winner flips.
    """
    ok, out, normal, dist_ref, dist_t = ray_intersect_all(sc, origin, direction)
    d = dist_ref if dist_mode == "ref" else dist_t
    # sequential scan "(new < best || best == 0) && new > 0.01" ==
    # first-occurrence argmin over accepted triangles
    acc = ok & (d > f32(0.01))
    # the reference treats a zero interpolated NORMAL as a miss of that
    # OBJECT's triangle_collide result (vector3_is_zero, cpu/hit.c:79);
    # at object level; per-triangle zero-normal check is the documented
    # deviation — corpus never triggers it, keep flat here
    dd = np.where(acc, d, np.inf)
    if not acc.any():
        return False, None, None, None, f32(0.0), -1
    w = int(np.argmin(dd))
    return True, out[w], normal[w], int(sc.tri_obj[w]), d[w], w


def collide_dist(sc, origin, direction):
    hit, _, _, _, d, _ = collide(sc, origin, direction)
    return d if hit else f32(0.0)


def has_direct_hit(sc, origin, direction):
    fd = collide_dist(sc, origin, direction)
    return not (fd < 1 and fd == 0)


def apply_specular(sc, color, inc_o, inc_d, n_o, n_d, obj):
    kcolor = init_color(sc.ks[obj])
    V = inc_o - n_o
    R = inc_d - n_d * (f32(2.0) * fdot(n_d, inc_d))
    R = fnormalize(R)
    V = fnormalize(V)
    Ls = f32(np.power(f64(max(fdot(R, V), f32(0.0))), f64(sc.ns[obj])))
    kcolor = color_mul(kcolor, Ls)
    return color_add(color, kcolor)


def apply_light(sc: MirrorScene, obj, hit_o, hit_n, log=None):
    color = init_color(np.zeros(3, f32))
    for i in range(len(sc.l_type)):
        ty = int(sc.l_type[i])
        lrgb = sc.l_rgb[i]
        lv = sc.l_v[i]
        if ty == 0:  # AMBIENT
            tmp = color_mul2(init_color(lrgb), init_color(sc.ka[obj]))
            color = color_add(color, tmp)
        elif ty == 1:  # DIRECTIONAL
            sh_d = lv * f32(-1.0)
            occluded = has_direct_hit(sc, hit_o, sh_d)
            if log is not None:
                log.append(("dlight", i, occluded))
            if not occluded:
                L = lv * f32(-1.0)
                N = hit_n
                tmp = color_mul2(init_color(lrgb), init_color(sc.kd[obj]))
                tmp = color_mul(tmp, fdot(L, N))
                inc_d = lv
                inc_o = hit_o + inc_d * f32(-10.0)
                tmp = apply_specular(sc, tmp, inc_o, inc_d, hit_o, hit_n, obj)
                color = color_add(color, tmp)
        elif ty == 2:  # POINT
            L = lv * f32(-1.0)
            N = hit_n
            if fdot(L, N) < 0:
                N = N * f32(-1.0)
            sh_d = lv - hit_o
            dist = flength(lv - hit_o)
            occluded = has_direct_hit(sc, hit_o, sh_d)
            if log is not None:
                log.append(("plight", i, occluded))
            if not occluded:
                tmp = color_mul2(init_color(lrgb), init_color(sc.kd[obj]))
                tmp = color_mul(tmp, fdot(L, N) * f32(1.0) / dist)
                inc_d = lv - hit_o
                inc_o = hit_o + inc_d * f32(-10.0)
                tmp = apply_specular(sc, tmp, inc_o, inc_d, hit_o, hit_n, obj)
                color = color_add(color, tmp)
    return color


def trace(sc: MirrorScene, origin, direction, coef, log=None, depth=0,
          dist_mode="ref"):
    """cpu/raytracer.c:19-34 (recursive)."""
    if coef < 0.01:
        return init_color(np.zeros(3, f32))
    hit, out, normal, obj, dist, w = collide(sc, origin, direction, dist_mode)
    # vector3_is_zero(direction) on the returned ray == miss
    if not hit or not np.any(normal != 0.0):
        if log is not None:
            log.append((depth, "miss"))
        return init_color(np.zeros(3, f32))
    if log is not None:
        log.append((depth, "hit", w, obj, float(dist)))
    color = apply_light(sc, obj, out, normal, log)
    # ray_bounce(ray, new_ray): reflect INCOMING dir about hit normal
    refl_d = direction - normal * (f32(2.0) * fdot(normal, direction))
    refl = trace(sc, out, refl_d, f32(sc.nr[obj] * coef), log, depth + 1,
                 dist_mode)
    return color_add(refl, color_mul(color, coef))


def camera_rays(cam, w, h, prow, pcol):
    """The 4 (origin, direction) subsample rays of printed pixel (prow, pcol)
    — cpu/raytracer.c:50-68 & 82-86 arithmetic in f32 (L in double)."""
    u = fnormalize(np.asarray(cam.u, f32))
    v = fnormalize(np.asarray(cam.v, f32))
    wv = fcross(u, v)
    L = f32(w / (2 * np.tan(f64(cam.fov) * np.pi / 360.0)))
    pos = np.asarray(cam.position, f32)
    C = pos + wv * L
    halfw, halfh = w // 2, h // 2
    kbase = f32(w - halfw - pcol)
    lbase = f32(h - halfh - prow)
    rays = []
    for dk in (f32(0.0), f32(0.5)):
        for dl in (f32(0.0), f32(0.5)):
            k = kbase + dk
            l = lbase + dl
            point = (C + u * k) + v * l
            direction = fnormalize(pos - point)
            rays.append((point, direction, (float(k), float(l))))
    # reference subsample order: k outer, l inner -> (0,0),(0,.5),(.5,0),(.5,.5)
    return rays


def render_pixel(sc, w, h, prow, pcol, dist_mode="ref", verbose=False):
    acc = init_color(np.zeros(3, f32))
    for point, direction, kl in camera_rays(sc.cam, w, h, prow, pcol):
        log = [] if verbose else None
        c = trace(sc, point, direction, f32(1.0), log, dist_mode=dist_mode)
        if verbose:
            print(f"  sub k,l={kl}: color={c.tolist()}")
            for e in log:
                print("   ", e)
        acc = color_add(acc, color_mul(c, f32(0.25)))
    return acc


def main():
    from oracle import oracle_render, scene_text
    from raytracing_gpu_tpu.models.parser import parse_scene_text

    name = sys.argv[1] if len(sys.argv) > 1 else "spheres"
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 960
    h = int(sys.argv[3]) if len(sys.argv) > 3 else 540
    pix = [int(x) for x in sys.argv[4:]]
    pixels = list(zip(pix[0::2], pix[1::2])) or [(339, 480), (350, 480),
                                                 (454, 480), (100, 480),
                                                 (339, 400)]
    golden = oracle_render(name, w, h)
    scene = parse_scene_text(scene_text(name, w, h))
    sc = MirrorScene(scene)
    for (r, c) in pixels:
        mref = render_pixel(sc, w, h, r, c, "ref")
        mt = render_pixel(sc, w, h, r, c, "t")
        g = golden[r, c]
        mark_ref = "OK " if np.array_equal(np.trunc(mref).astype(np.uint8), g) else "DIFF"
        print(f"({r},{c}) golden={g.tolist()} mirror_ref={np.trunc(mref).tolist()} [{mark_ref}] "
              f"mirror_tdist={np.trunc(mt).tolist()}")


if __name__ == "__main__":
    main()
