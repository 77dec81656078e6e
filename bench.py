"""End-to-end benchmark: primary rays/sec/chip on susan.svati.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N}

- value: primary rays per second for a full CPU-semantics render of
  susan.svati (512x512, 2x2 supersampling -> 1,048,576 primary rays; the
  render also pays shadow rays per directional/point light and reflection
  bounces, so this is honest end-to-end throughput, not kernel-only).
- vs_baseline: speedup over the reference CPU renderer (cpu/raytracer.c,
  gcc -O2, 4 pthreads) measured on this host and cached. The reference
  publishes no numbers, so its own renderer is the baseline.

Env knobs: RGT_BENCH_SCENE, RGT_BENCH_RES (render at a reduced resolution,
rays/s is resolution-independent to first order), RGT_BENCH_REPEATS,
RGT_BENCH_MODE (cpu | gpu — the reference's two pipelines; gpu renders at
aliasing(3)x resolution, 9 rays/pixel, box downscale), RGT_BENCH_BACKEND
(auto | pallas | jnp), RGT_BENCH_CHUNK.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
CACHE = os.path.join(HERE, "tests", "_oracle_cache")
REF = os.environ.get("RGT_REFERENCE", "/root/reference")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def oracle_rays_per_sec(scene_name: str) -> float | None:
    """Reference CPU renderer throughput on this host (cached)."""
    cache_file = os.path.join(CACHE, f"baseline_rays_{scene_name}.json")
    if os.path.exists(cache_file):
        with open(cache_file) as f:
            return json.load(f)["rays_per_sec"]
    try:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import oracle as oracle_mod

        if not oracle_mod.oracle_available():
            return None
        binary = oracle_mod.build_oracle()
        # measure at 128x128 (rays/s is ~resolution independent); median of 3
        res = 128
        src = oracle_mod.scene_text(scene_name, res, res)
        spath = os.path.join(CACHE, f"_bench_{scene_name}.svati")
        with open(spath, "w") as f:
            f.write(src)
        out = os.path.join(CACHE, f"_bench_{scene_name}.ppm")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run([binary, spath, out], check=True,
                           capture_output=True, timeout=600)
            times.append(time.perf_counter() - t0)
        rays = res * res * 4
        rps = rays / sorted(times)[1]
        with open(cache_file, "w") as f:
            json.dump({"rays_per_sec": rps, "res": res, "times": times}, f)
        log(f"[bench] oracle baseline: {rps:,.0f} rays/s ({sorted(times)[1]:.2f}s @ {res}x{res})")
        return rps
    except Exception as e:  # baseline is best-effort
        log(f"[bench] oracle baseline unavailable: {e}")
        return None


def main():
    scene_name = os.environ.get("RGT_BENCH_SCENE", "susan")
    repeats = int(os.environ.get("RGT_BENCH_REPEATS", "5"))
    t_process = time.perf_counter()

    import jax
    import numpy as np

    from raytracing_gpu_tpu.config import RenderConfig
    from raytracing_gpu_tpu.models.parser import parse_scene_text
    from raytracing_gpu_tpu.models.scene import scene_to_device
    from raytracing_gpu_tpu.render import (
        _render_cpu_mode,
        _render_gpu_mode,
        required_depth,
    )
    from raytracing_gpu_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    dev = jax.devices()[0]
    platform = dev.platform
    if platform == "gpu":
        import subprocess as sp

        card = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
        log(f"[bench] {dev.device_kind} x{len(jax.devices())}: {card}")
    # Reduced resolution on CPU so local runs finish; full scene res on GPU.
    default_res = "0" if platform == "gpu" else "64"
    res = int(os.environ.get("RGT_BENCH_RES", default_res))

    path = os.path.join(REF, "tests", scene_name + ".svati")
    with open(path) as f:
        src = f.read()
    if res:
        src = re.sub(r"camera \d+ \d+", f"camera {res} {res}", src, count=1)
    scene_host = parse_scene_text(src)
    W, H = scene_host.camera.width, scene_host.camera.height
    # mode=cpu (default): 2x2 supersampling -> 4 rays/pixel. mode=gpu: the
    # reference's GPU pipeline renders at aliasing(3)x resolution, one ray
    # per hi-res pixel -> 9 rays/pixel (gpu/rt.cpp:67-79).
    mode = os.environ.get("RGT_BENCH_MODE", "cpu")
    backend = os.environ.get("RGT_BENCH_BACKEND", "auto")
    cfg = RenderConfig(
        mode=mode, quantize="match", backend=backend,
        ray_chunk=int(os.environ.get("RGT_BENCH_CHUNK", "65536")),
    )
    rays = W * H * (cfg.aliasing ** 2 if mode == "gpu" else 4)
    log(f"[bench] {scene_name}.svati {W}x{H} mode={mode} on {platform} "
        f"({scene_host.n_triangles} triangles, {rays:,} primary rays, "
        f"backend={backend})")

    scene = scene_to_device(scene_host)
    max_nr = float(np.max(np.asarray(scene_host.materials.nr)))
    depth = required_depth(max_nr, cfg.reflect_cutoff, cfg.cpu_max_depth)

    # Compile once (jit, persistent cache), then time.
    if mode == "gpu":
        _render = lambda: _render_gpu_mode(scene, cfg, W, H)
    else:
        _render = lambda: _render_cpu_mode(scene, cfg, depth, W, H)
    t0 = time.perf_counter()
    img = jax.block_until_ready(_render())
    t1 = time.perf_counter()
    log(f"[bench] compile + first render: {t1 - t0:.1f}s; "
        f"process start -> first pixels: {t1 - t_process:.1f}s")

    # single-frame latency (dispatch + render + sync)
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        img = jax.block_until_ready(_render())
        lat.append(time.perf_counter() - t0)
    log(f"[bench] single-frame latency: {[round(t, 4) for t in lat]}")

    # sustained throughput: N back-to-back renders, one sync at the end.
    # Renders serialize on the device, so total/N is the per-frame device
    # cost; dispatch latency overlaps (as it would in any real rendering or
    # training loop) instead of being double-counted per frame. This is the
    # primary metric.
    n = max(repeats, 30)
    t0 = time.perf_counter()
    for _ in range(n):
        img = _render()
    jax.block_until_ready(img)
    t_total = time.perf_counter() - t0
    rps = rays * n / t_total
    log(f"[bench] sustained: {n} frames in {t_total:.3f}s -> "
        f"{t_total / n * 1e3:.2f} ms/frame, {rps:,.0f} rays/s")

    base = oracle_rays_per_sec(scene_name)
    vs = rps / base if base else 0.0
    print(json.dumps({
        "metric": f"primary rays/sec/chip, {scene_name}.svati {W}x{H} ({platform} {dev.device_kind}, {cfg.backend}, mode={mode})",
        "value": round(rps, 1),
        "unit": "rays/s",
        "vs_baseline": round(vs, 3),
    }))


if __name__ == "__main__":
    main()
