"""CLI entry — the L0 layer.

Reference: `rt file.svati output.ppm` (cpu/rt.c:5-10) and
`rt file.svati output.png` (gpu/rt.cpp:54-97, which prints the active
layout banner, hard-codes aliasing=3 and writes RGBA8 PNG). The reference
fetched CLI11 but never wired it up (gpu/CMakeLists.txt:24-27 — SURVEY §5);
this is the flag system it never had: every compile-time define and
hard-coded literal is a runtime flag.

Usage:
    python -m raytracing_gpu_tpu scene.svati out.ppm [--mode cpu|gpu] ...
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracing_gpu_tpu",
        description="Differentiable Whitted ray tracer in JAX "
        "(re-implementation of blink97/raytracing-gpu).",
    )
    p.add_argument("input", help=".svati scene file")
    p.add_argument("output", help="output image (.ppm ASCII P3 or .png)")
    p.add_argument("--mode", choices=["cpu", "gpu"], default="cpu",
                   help="reference pipeline to reproduce: cpu = 2x2 "
                   "supersampling + recursion; gpu = aliasing-x upscale + "
                   "box downscale + bounce cap (default: cpu)")
    p.add_argument("--quantize", choices=["match", "smooth"], default="match",
                   help="match = clamp at every color op like cpu/colors.c; "
                   "smooth = linear f32, clamp once (differentiable)")
    p.add_argument("--partitioning", choices=["none", "aabb", "octree"],
                   default="octree",
                   help="acceleration structure (PARTITIONING_* analog; the "
                   "reference defaults to OCTREE, gpu/CMakeLists.txt:15)")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default="auto",
                   help="intersection implementation: jnp = pure XLA, "
                   "pallas = the Pallas sweep kernel (GPU), auto = pallas "
                   "on the GPU and jnp elsewhere (default)")
    p.add_argument("--aliasing", type=int, default=3,
                   help="gpu-mode supersampling factor (gpu/rt.cpp:67)")
    p.add_argument("--max-bounce", type=int, default=10,
                   help="gpu-mode bounce cap (gpu/raytracer.cu:113)")
    p.add_argument("--ray-chunk", type=int, default=8192,
                   help="rays per XLA program instance")
    p.add_argument("--unroll", choices=["auto", "while", "static"],
                   default="auto",
                   help="bounce-loop strategy: auto = while_loop unless "
                   "quantize=smooth; static = unrolled (differentiable)")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard rays over N devices (0 = single device)")
    p.add_argument("--scene-shards", type=int, default=1,
                   help="shard triangles over N devices (scene axis)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax.profiler trace to DIR")
    p.add_argument("--time", action="store_true", help="print render time")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from raytracing_gpu_tpu.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    import numpy as np

    from raytracing_gpu_tpu.config import RenderConfig
    from raytracing_gpu_tpu.models.parser import parse_scene
    from raytracing_gpu_tpu.render import render_scene
    from raytracing_gpu_tpu.utils import image as image_io

    cfg = RenderConfig(
        mode=args.mode,
        quantize=args.quantize,
        partitioning=args.partitioning,
        backend=args.backend,
        aliasing=args.aliasing,
        max_bounce=args.max_bounce,
        ray_chunk=args.ray_chunk,
        unroll=args.unroll,
    )
    scene = parse_scene(args.input)

    def run():
        if args.tiles:
            from raytracing_gpu_tpu.parallel import make_mesh, render_scene_sharded

            mesh = make_mesh(args.tiles, args.scene_shards)
            return render_scene_sharded(scene, cfg, mesh)
        return render_scene(scene, cfg)

    t0 = time.perf_counter()
    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            img = run()
    else:
        img = run()
    dt = time.perf_counter() - t0

    if args.output.endswith(".png"):
        image_io.write_png(args.output, np.trunc(img).astype(np.uint8))
    else:
        image_io.write_ppm(args.output, img)
    if args.time:
        w, h = scene.camera.width, scene.camera.height
        print(f"{w}x{h} in {dt:.3f}s ({w * h * 4 / dt:,.0f} rays/s)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
