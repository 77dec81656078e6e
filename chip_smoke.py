"""Smoke test of the renderer on one GPU, through the entry points a user calls.

    python chip_smoke.py                # phases 1-5 on one GPU
    python chip_smoke.py --four-cards   # only the sharded path, on four GPUs
    python chip_smoke.py --frames 10    # more timed frames per render

Phases (any failure raises and the script exits non-zero, printing no result):

1. Device: JAX's default backend must be a GPU; prints its kind and
   `nvidia-smi --query-gpu=name,power.limit`.
2. Final frames: a spheres.svati-sized scene (~4.8k triangles, two mirrors,
   ambient + directional + point lights) at 960x540 through SceneRenderer
   with the default RenderConfig, in mode="cpu" (2,073,600 primary rays)
   and mode="gpu" (aliasing 3, 4,665,600 primary rays): finite, in [0,255],
   not black; ms/frame and compile time.
3. Against the plain reference: the same scene at 240x135 rendered on the
   host CPU with the jnp backend, compared with the card's render
   (edge-aware, tol 1).
4. Sweep kernel vs XLA on the card at real size, on the phase-2 scene and a
   96,000-triangle sphere grid at 512x512 (cpu mode): on 65,536 primary rays
   the kernel's nearest distance agrees with the jnp path to 2 ulp and its
   winner is the same triangle unless the two best distances are within
   2 ulp; the whole frames agree (edge-aware, tol 1); median ms/frame of
   each backend.
5. Inverse rendering: 3 steps of make_train_step on a 1x1 mesh (smooth
   quantization, the phase-2 scene at 256x144, kd and light colours free):
   finite loss, the free parameters move, the frozen ones do not.
6. --four-cards, alone: render_scene_sharded on (4,1) and (2,2) meshes equal
   to the one-card render bit for bit, and a sharded train step whose loss
   matches the one-card loss (rtol 1e-5).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """A failed check ends the run (an exception, so no result line)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed_frames(fn, frames: int):
    """(first call seconds — compile + one frame, median ms of `frames`
    later calls); every call ends in block_until_ready."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(frames):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, float(np.median(ts)) * 1e3


def check_image(img, shape, what: str):
    import numpy as np

    img = np.asarray(img)
    require(img.shape == shape, f"{what}: shape {img.shape} != {shape}")
    require(np.isfinite(img).all(), f"{what}: non-finite pixels")
    require(img.min() >= 0.0 and img.max() <= 255.0,
            f"{what}: outside [0,255]")
    require(img.mean() > 1.0, f"{what}: black image (mean {img.mean():.3f})")


def phase_device():
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (default backend "
                         f"{backend!r})")
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(f"[1] device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    for line in smi.strip().splitlines():
        log(f"[1] nvidia-smi: {line.strip()}")
    return dev


def spheres(width, height):
    from raytracing_gpu_tpu.models.procedural import make_sphere_scene

    return make_sphere_scene(width=width, height=height, n_lat=28, n_lon=44)


def phase_final_frames(frames: int):
    from raytracing_gpu_tpu import RenderConfig, SceneRenderer

    scene = spheres(960, 540)
    log(f"[2] spheres 960x540: {scene.n_triangles} triangles")
    for mode in ("cpu", "gpu"):
        cfg = RenderConfig(mode=mode)
        r = SceneRenderer(scene, cfg)
        img, first, ms = timed_frames(r.render_device, frames)
        check_image(img, (540, 960, 3), f"spheres {mode}-mode")
        rays = 960 * 540 * (4 if mode == "cpu" else cfg.aliasing ** 2)
        log(f"[2] mode={mode}: {rays:,} primary rays, first call (compile + "
            f"frame) {first:.2f} s, median {ms:.2f} ms/frame over {frames}")


def phase_reference():
    import jax
    import numpy as np

    from raytracing_gpu_tpu import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu.utils.compare import (
        assert_images_close,
        edge_mask,
    )

    scene = spheres(240, 135)
    card = np.trunc(SceneRenderer(scene, RenderConfig()).render()).astype(
        np.uint8)
    with jax.default_device(jax.devices("cpu")[0]):
        host = np.trunc(SceneRenderer(
            scene, RenderConfig(backend="jnp")).render()).astype(np.uint8)
    check_image(host, (135, 240, 3), "cpu reference")
    # mirrors displace hit/shadow flips away from image-space edges: the
    # off-edge budget of the repo's mirror scenes (tests/test_render_match.py
    # FULLRES, spheres), with tol 1 and the magnitude and run caps unchanged
    stats = assert_images_close(card, host, tol=1, max_frac_off_edge=4e-4,
                                context="card-vs-cpu")
    diff = np.abs(card.astype(int) - host.astype(int)).max(axis=-1) > 1
    n_edge = int((diff & edge_mask(host)).sum())
    log(f"[3] 240x135 card vs host-CPU jnp: {stats}; {n_edge} edge pixels "
        f"differ by more than 1")


def _sweep_vs_xla(scene, n_rays: int):
    """Kernel sweep vs the plain path on `n_rays` primary rays from the
    middle of the frame: (max ulp, winner mismatches outside 2-ulp ties,
    hit-mask mismatches, hits)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracing_gpu_tpu.models.scene import scene_to_device
    from raytracing_gpu_tpu.ops import camera as camera_ops
    from raytracing_gpu_tpu.ops import pallas_intersect as pk
    from raytracing_gpu_tpu.ops.intersect import _mt_core

    dev = scene_to_device(scene)
    geo = dev.geometry
    w, h = scene.camera.width, scene.camera.height
    u, v, C = camera_ops.camera_basis(dev.camera)
    ids = jnp.arange(n_rays) + (w * h * 4 - n_rays) // 2
    o, d = camera_ops.make_rays(
        u, v, C, jnp.asarray(dev.camera.position, jnp.float32),
        camera_ops.cpu_subpixel_coords_traced(w, h, ids))

    @jax.jit
    def kernel(o, d):
        pack = pk.pack_geometry(geo.vertices, geo.valid)
        op, dp, R = pk.pack_rays(o, d)
        mask = pk.tile_cull_mask_hierarchical(op, dp, pack, "octree")
        dist, idx = pk.nearest_hit_pallas(op, dp, pack.tri, mask, 1e-7, 0.01)
        return dist[:R], pack.perm[idx[:R]]

    @jax.jit
    def plain(o, d):
        def chunk(od):
            dist = _mt_core(od[0], od[1], geo.vertices, geo.normals,
                            geo.valid, 1e-7, 0.01)[0]
            win = jnp.argmin(dist, axis=1)
            cols = jnp.arange(dist.shape[1])[None, :]
            second = jnp.min(jnp.where(cols == win[:, None], jnp.inf, dist),
                             axis=1)
            return jnp.min(dist, axis=1), win, second

        n = o.shape[0] // 2048
        out = jax.lax.map(chunk, (o.reshape(n, 2048, 3),
                                  d.reshape(n, 2048, 3)))
        return tuple(a.reshape(-1) for a in out)

    kd, kidx = (np.asarray(a) for a in kernel(o, d))
    d1, win, d2 = (np.asarray(a) for a in plain(o, d))

    def ulps(a, b):
        return np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))

    hit = np.isfinite(d1)
    mask_bad = int((np.isfinite(kd) != hit).sum())
    both = hit & np.isfinite(kd)
    max_ulp = int(ulps(kd[both], d1[both]).max()) if both.any() else 0
    tie = ulps(np.where(np.isfinite(d2), d2, 0), d1) <= 2
    idx_bad = int(((kidx != win) & both & ~tie).sum())
    return max_ulp, idx_bad, mask_bad, int(hit.sum())


def phase_kernel_vs_xla(frames: int):
    import numpy as np

    from raytracing_gpu_tpu import RenderConfig, SceneRenderer
    from raytracing_gpu_tpu.models.procedural import make_sphere_grid_scene
    from raytracing_gpu_tpu.utils.compare import assert_images_close

    cells = [
        ("spheres 960x540", spheres(960, 540), 65536),
        # the jnp path holds several (ray_chunk, T) f32 planes per chunk:
        # 8192 rays x 99,200 triangles is 3.25 GB a plane
        ("grid 512x512", make_sphere_grid_scene(width=512, height=512), 8192),
    ]
    for name, scene, jnp_chunk in cells:
        max_ulp, idx_bad, mask_bad, hits = _sweep_vs_xla(scene, 65536)
        log(f"[4] {name} ({scene.n_triangles} triangles), 65,536 primary "
            f"rays: {hits} hits, hit-mask mismatches {mask_bad}, max "
            f"{max_ulp} ulp, winner mismatches outside 2-ulp ties {idx_bad}")
        require(mask_bad == 0 and max_ulp <= 2 and idx_bad == 0,
                f"{name}: kernel vs XLA sweep")
        imgs = {}
        for backend, chunk in (("pallas", 65536), ("jnp", jnp_chunk)):
            cfg = RenderConfig(backend=backend, ray_chunk=chunk)
            r = SceneRenderer(scene, cfg)
            img, first, ms = timed_frames(r.render_device, frames)
            imgs[backend] = np.trunc(np.asarray(img)).astype(np.uint8)
            log(f"[4] {name} backend={backend} ray_chunk={chunk}: first call "
                f"{first:.2f} s, median {ms:.2f} ms/frame over {frames}")
        stats = assert_images_close(imgs["pallas"], imgs["jnp"], tol=1,
                                    max_frac_off_edge=4e-4,
                                    context=f"{name} pallas-vs-jnp")
        log(f"[4] {name} pallas vs jnp image: {stats}")


def _train(scene, mesh, steps: int):
    """`steps` masked-adam steps recovering perturbed kd and light colours;
    returns (losses, initial params, final params)."""
    import jax.numpy as jnp
    import numpy as np
    import optax

    from raytracing_gpu_tpu import RenderConfig
    from raytracing_gpu_tpu.models.scene import scene_to_device
    from raytracing_gpu_tpu.ops import camera as camera_ops
    from raytracing_gpu_tpu.parallel import (
        extract_params,
        make_train_step,
    )
    from raytracing_gpu_tpu.parallel.render import split_scene
    from raytracing_gpu_tpu.parallel.train import PARAM_SPECS, predict_pixels
    from raytracing_gpu_tpu.render import required_depth

    w, h = scene.camera.width, scene.camera.height
    cfg = RenderConfig(quantize="smooth", diff_max_depth=3)
    dev = scene_to_device(scene)
    coords = jnp.asarray(camera_ops.cpu_subpixel_coords(w, h)).reshape(-1, 2)
    depth = required_depth(float(np.max(np.asarray(scene.materials.nr))),
                           cfg.reflect_cutoff, cfg.diff_max_depth)
    target = predict_pixels(dev, cfg, depth, coords)
    free = ("kd", "lights_rgb")
    opt = optax.chain(
        optax.masked(optax.set_to_zero(),
                     {k: k not in free for k in PARAM_SPECS}),
        optax.adam(2e-2),
    )
    params0 = extract_params(dev)
    params0["kd"] = params0["kd"] * 0.6 + 0.2
    params0["lights_rgb"] = params0["lights_rgb"] * 0.8
    init_state, step_fn = make_train_step(mesh, cfg, dev, optimizer=opt)
    state = init_state(params0)
    geo, rest = split_scene(dev)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, geo, rest, coords, target, w * h)
        losses.append(float(loss))
    return losses, params0, state.params


def phase_train():
    import jax
    import numpy as np

    from raytracing_gpu_tpu.parallel import make_mesh

    t0 = time.perf_counter()
    losses, p0, p1 = _train(spheres(256, 144), make_mesh(1, 1), steps=3)
    log(f"[5] train 256x144 on a 1x1 mesh: losses {losses} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    for k in p0:
        moved = not np.array_equal(np.asarray(p0[k]), np.asarray(p1[k]))
        require(moved == (k in ("kd", "lights_rgb")), f"{k} moved: {moved}")
    jax.block_until_ready(p1)


def phase_four_cards():
    import jax
    import numpy as np

    from raytracing_gpu_tpu import RenderConfig, render_scene
    from raytracing_gpu_tpu.parallel import make_mesh, render_scene_sharded

    n = len(jax.devices())
    require(n >= 4, f"--four-cards needs 4 GPUs, JAX sees {n}")
    scene = spheres(480, 272)
    cfg = RenderConfig(quantize="match")
    ref = np.trunc(render_scene(scene, cfg))
    for tiles, shards in ((4, 1), (2, 2)):
        t0 = time.perf_counter()
        img = np.trunc(render_scene_sharded(scene, cfg,
                                            make_mesh(tiles, shards)))
        bad = int((img != ref).any(axis=-1).sum())
        log(f"[6] render_scene_sharded 480x272 on a ({tiles},{shards}) mesh: "
            f"{bad} pixels differ from the one-card render "
            f"({time.perf_counter() - t0:.1f} s incl. compile)")
        require(bad == 0, f"({tiles},{shards}) mesh: {bad} pixels differ")
    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(4)  # sharded train step loss vs one card, rtol 1e-5
    log(f"[6] sharded train step on 4 cards matches the one-card loss "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    ap.add_argument("--frames", type=int, default=3,
                    help="timed frames per render after the first call")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from raytracing_gpu_tpu.utils.compile_cache import enable_persistent_cache

    dev = phase_device()
    log(f"[1] compile cache: {enable_persistent_cache()}")
    if args.four_cards:
        phase_four_cards()
    else:
        phase_final_frames(args.frames)
        phase_reference()
        phase_kernel_vs_xla(args.frames)
        phase_train()
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
