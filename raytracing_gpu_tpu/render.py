"""Render orchestration — the batched `raytrace` / `render`.

The reference orchestrates with 4 pthreads over image quadrants on CPU
(cpu/raytracer.c:92-127) and one CUDA thread per hi-res pixel on GPU
(gpu/raytracer.cu:87-128). Here the whole image is a single batched XLA
program: rays are generated for every (pixel, subsample), traced in chunks
(static-shape `lax.map` over ray tiles — the memory-tiling analog of CUDA's
16x16 thread blocks), and the recursive `trace` (cpu/raytracer.c:19-34) is
unrolled to a static depth with per-ray live masks (uniform batched control
flow instead of CUDA thread divergence).

Recursion emulation: `trace(ray, coef)` contributes
`color_mul(shade(hit), coef)` at every level and recurses with
`coef' = nr * coef` until `coef < 0.01` (cpu/raytracer.c:21,29) or a miss.
Because `color_add` saturates at 255, association order matters: the
reference folds deepest-bounce-first; we record per-bounce contributions
forward and fold them in reverse, reproducing the exact clamp order.

The static unroll depth is derived per scene from max(nr): coef after b
bounces is at most max_nr^b, so depth = min(cap, smallest b with
max_nr^b < cutoff). Scenes with max_nr >= 1 would recurse forever on the
CPU reference (the GPU caps at MAX_BOUNCE=10, gpu/raytracer.cu:113); we cap
at config.cpu_max_depth.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.scene import Scene, scene_to_device
from raytracing_gpu_tpu.ops import camera as camera_ops
from raytracing_gpu_tpu.ops.colors import ColorOps
from raytracing_gpu_tpu.ops.intersect import collide
from raytracing_gpu_tpu.ops.shading import shade


# Rematerialization policy for the unrolled (differentiable) bounce loop:
# recompute everything EXCEPT the intersection sweeps' outputs. The sweep
# kernels are pure selection (stop_gradient'd, no VJP of their own), so
# re-executing them during the backward pass buys no memory worth having —
# their saved outputs are (R,)-sized while their cost dominates the step
# (ops/intersect.py _pallas_nearest tags the names).
_REMAT_POLICY = jax.checkpoint_policies.save_only_these_names(
    "sweep_dist", "sweep_idx")


def required_depth(max_nr: float, cutoff: float, cap: int) -> int:
    """Static recursion depth: smallest D with max_nr^D < cutoff.

    Level b in [0, D) contributes when coef = prod(nr) >= cutoff; coef at
    level b is at most max_nr^b, so levels >= D are always black.
    """
    if max_nr <= 0.0:
        return 1
    if max_nr >= 1.0:
        return cap
    d = int(math.ceil(math.log(cutoff) / math.log(max_nr)))
    return max(1, min(cap, d))


def resolve_backend(cfg: RenderConfig) -> RenderConfig:
    """`cfg` with backend="auto" replaced by the platform's intersection
    path: the Pallas sweep kernel on the GPU, plain XLA elsewhere."""
    if cfg.backend != "auto":
        return cfg
    import dataclasses

    backend = "pallas" if jax.default_backend() == "gpu" else "jnp"
    return dataclasses.replace(cfg, backend=backend)


def _winner_nr(scene, hit):
    """(R,) reflection coefficient of each ray's winning object — from the
    gathered winner row when present (kernel backend), else from the
    material table (ops.shading.material_rows)."""
    if hit.mat is not None:
        return hit.mat[:, 10]
    from raytracing_gpu_tpu.ops.shading import material_rows

    return material_rows(scene.materials, hit.obj)[:, 10]


def trace_rays(scene: Scene, origins, dirs, cfg: RenderConfig, depth: int,
               unroll: bool = False, scene_axis: str | None = None,
               pack=None):
    """Emulate the recursive trace() for a batch of rays; returns (R,3) colors
    in the ColorOps domain selected by cfg.quantize.

    Accumulation-order note: the reference folds contributions deepest-bounce
    first through the saturating color_add (cpu/raytracer.c:31). For
    non-negative terms, saturating addition is associative in real arithmetic
    (min(min(a+b,255)+c, 255) == min(a+b+c, 255)), so we accumulate FORWARD —
    only f32 rounding order differs, which the edge-aware comparator absorbs.
    Forward accumulation enables a `lax.while_loop` that exits as soon as
    every ray in the batch is dead (miss or coef < cutoff) — the batched
    analog of the reference's per-thread early recursion exit. Deep mirror
    scenes (Nr=1.0 in car-on-road) cost only as many iterations as the
    longest surviving path in the batch.

    unroll=True uses a statically unrolled loop instead (reverse-mode
    differentiable; lax.while_loop is not), with each bounce step
    jax.checkpoint-ed when cfg.remat so backward memory is O(1) in depth.
    """
    cfg = resolve_backend(cfg)
    cops = ColorOps(cfg.quantize)
    R = origins.shape[0]

    def step(o, d, coef, alive, color):
        hit = collide(o, d, scene.geometry, cfg.mt_eps, cfg.self_hit_eps,
                      scene_axis, cfg.backend, pack, cfg.partitioning)
        use = alive & (coef >= cfg.reflect_cutoff) & hit.mask
        local = shade(scene, hit, cops, cfg.mt_eps, cfg.self_hit_eps, scene_axis,
                      cfg.backend, pack, cfg.partitioning)
        color = cops.add(color, jnp.where(use[:, None], cops.mul(local, coef[:, None]), 0.0))
        # reflection: ray_bounce (cpu/ray.c:16-25) with UNnormalized normal
        n = hit.normal
        refl_dir = d - n * (2.0 * jnp.sum(n * d, axis=-1))[:, None]
        # dead rays become degenerate (far origin, zero direction): the
        # kernel backends' tile culling then skips them on later bounces
        # instead of re-intersecting stale rays; they can never contribute
        # again (use stays False once coef hits 0)
        o = jnp.where(use[:, None], hit.point, 3e29)
        d = jnp.where(use[:, None], refl_dir, 0.0)
        coef = jnp.where(use, _winner_nr(scene, hit) * coef, 0.0)
        return o, d, coef, use, color

    init = (
        origins,
        dirs,
        jnp.ones((R,), jnp.float32),
        jnp.ones((R,), bool),
        cops.zeros((R,)),
    )
    if unroll:
        fstep = jax.checkpoint(step, policy=_REMAT_POLICY) if cfg.remat else step
        state = init
        for _ in range(depth):
            state = fstep(*state)
        return state[4]

    def cond(s):
        b, (o, d, coef, alive, color) = s
        return (b < depth) & jnp.any(alive & (coef >= cfg.reflect_cutoff))

    def body(s):
        b, state = s
        return b + 1, step(*state)

    _, (_, _, _, _, color) = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
    return color


def trace_rays_gpu(scene: Scene, origins, dirs, cfg: RenderConfig,
                   scene_axis: str | None = None, pack=None,
                   unroll: bool = False):
    """GPU-reference iterative bounce loop for a batch of rays.

    `do { tmp = trace(); color += tmp*nr_acc; nr_acc *= hit.nr } while
    (nr_acc > 0.01 && MAX_BOUNCE-- > 0)` (gpu/raytracer.cu:107-122): entry is
    unconditional for the first bounce, accumulation is shallow-first
    saturating add.

    Default is a `lax.while_loop` that exits once every ray in the batch is
    dead — the batch analog of the reference's per-thread `nr_acc > 0.01`
    exit. On non-mirror scenes this runs 1 bounce instead of max_bounce+1,
    with a ~11x smaller traced program (1 step vs 11). Dead iterations would
    contribute exactly zero (masked accumulate), so the images are
    identical — asserted exactly by the unroll-vs-while parity test on a
    mirror scene (tests/test_gpu_mode.py). unroll=True statically
    unrolls max_bounce+1 iterations instead (reverse-mode differentiable;
    while_loop is not), each step jax.checkpoint-ed when cfg.remat.
    """
    cfg = resolve_backend(cfg)
    cops = ColorOps(cfg.quantize)
    R = origins.shape[0]

    def step(o, d, nr_acc, alive, color):
        hit = collide(o, d, scene.geometry, cfg.mt_eps, cfg.self_hit_eps,
                      scene_axis, cfg.backend, pack, cfg.partitioning)
        use = alive & hit.mask
        local = shade(scene, hit, cops, cfg.mt_eps, cfg.self_hit_eps, scene_axis,
                      cfg.backend, pack, cfg.partitioning)
        color = cops.add(color, jnp.where(use[:, None], cops.mul(local, nr_acc[:, None]), 0.0))
        n = hit.normal
        refl = d - n * (2.0 * jnp.sum(n * d, axis=-1))[:, None]
        o = jnp.where(use[:, None], hit.point, 3e29)  # park dead rays
        d = jnp.where(use[:, None], refl, 0.0)
        nr = jnp.where(use, _winner_nr(scene, hit), 0.0)
        nr_acc = nr_acc * nr
        alive = use & (nr_acc > cfg.reflect_cutoff)
        return o, d, nr_acc, alive, color

    init = (origins, dirs, jnp.ones((R,), jnp.float32),
            jnp.ones((R,), bool), cops.zeros((R,)))
    if unroll:
        fstep = jax.checkpoint(step, policy=_REMAT_POLICY) if cfg.remat else step
        state = init
        for _ in range(cfg.max_bounce + 1):
            state = fstep(*state)
        return state[4]

    def cond(s):
        b, (o, d, nr_acc, alive, color) = s
        return (b < cfg.max_bounce + 1) & jnp.any(alive)

    def body(s):
        b, state = s
        return b + 1, step(*state)

    _, (_, _, _, _, color) = jax.lax.while_loop(cond, body,
                                                (jnp.int32(0), init))
    return color


def _trace_chunked(scene, origins, dirs, cfg, depth, unroll=False,
                   scene_axis=None, gpu_semantics=False):
    """lax.map over ray chunks to bound the R x T working set."""
    cfg = resolve_backend(cfg)
    R = origins.shape[0]
    chunk = min(cfg.ray_chunk, R)
    pad = (-R) % chunk
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), origins.dtype)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), dirs.dtype)])
    oc = origins.reshape(-1, chunk, 3)
    dc = dirs.reshape(-1, chunk, 3)
    pack = _scene_pack(scene, cfg)
    if gpu_semantics:
        f = lambda od: trace_rays_gpu(scene, od[0], od[1], cfg, scene_axis,
                                      pack, unroll)
    else:
        f = lambda od: trace_rays(scene, od[0], od[1], cfg, depth, unroll,
                                  scene_axis, pack)
    colors = jax.lax.map(f, (oc, dc))
    return colors.reshape(-1, 3)[:R]


def _scene_pack(scene, cfg: RenderConfig):
    """Per-scene clustering/packing for the kernel backend, hoisted out of
    the chunk map and the bounce loops (the to_cuda-time analog,
    gpu/scene.cu:224-352); None on the jnp backend."""
    if cfg.backend != "pallas":
        return None
    from raytracing_gpu_tpu.ops import pallas_intersect as pk

    return pk.pack_geometry(
        scene.geometry.vertices, scene.geometry.valid,
        scene.geometry.normals, scene.geometry.tri_obj, scene.materials,
    )


def _pick_block(width: int, height: int):
    """(Bx, By) pixel-block dims for block-swizzled ray order, so one sweep
    tile of TILE_R rays (TILE_R/4 pixels of 4 subsamples) covers a compact
    2D block instead of a row strip: the squarest power-of-two pair with
    Bx*By = TILE_R/4 that divides the resolution, else the same for half as
    many pixels, down to 4. None when no candidate divides it."""
    from raytracing_gpu_tpu.ops.pallas_intersect import TILE_R

    n = TILE_R // 4
    while n >= 4:
        shapes = [(n // by, by) for by in (1 << k for k in range(n.bit_length()))
                  if n % by == 0]
        for bx, by in sorted(shapes, key=lambda s: (abs(s[0] - s[1]), -s[0])):
            if width % bx == 0 and height % by == 0:
                return bx, by
        n //= 2
    return None


def _swiz_ray_ids(r, width: int, bx: int, by: int):
    """Block-swizzled ray position -> original ray id (pure integer
    arithmetic — no lookup tables in the traced program). Swizzled pixel
    order is block-row-major over (H/by, W/bx) blocks, row-major within a
    block; the 4 subsamples of a pixel stay adjacent (fold4 contract)."""
    nbx = width // bx
    pix = r // 4
    s = r % 4
    blkid = pix // (bx * by)
    within = pix % (bx * by)
    y = (blkid // nbx) * by + within // bx
    x = (blkid % nbx) * bx + within % bx
    return (y * width + x) * 4 + s


def _trace_image(scene, cfg, depth, n_rays: int, coord_fn, unroll=False,
                 gpu_semantics=False, fold4=False, ray_id_map=None):
    """(n_rays, 3) colors via lax.map over chunk INDICES, generating each
    chunk's plane coords and rays in-body with `coord_fn(ray_ids)`.

    Materializing the full (n_rays, 2) coord plane and scanning over it made
    XLA compile time scale with pixel count (megapixel buffer plumbing);
    id-generated rays compile the identical math in a program whose size
    does not depend on the resolution. Tail ray ids are clamped to the last
    valid ray (its duplicated results are sliced away).

    fold4=True folds each chunk's 2x2 subsample colors into pixels INSIDE
    the map body (exact clamp order of assemble_cpu_image) and returns
    (n_rays//4, 3) pixel colors instead: the full subsample buffer is never
    written to device memory, and the chunk writeback shrinks 4x. Requires
    chunk % 4 == 0 (callers fall back otherwise);
    valid because ray id = pixel*4 + subsample, so subsamples of one pixel
    never straddle a chunk boundary.
    """
    chunk = min(cfg.ray_chunk, n_rays)
    nch = -(-n_rays // chunk)  # ceil: the tail partial chunk must render too
    pack = _scene_pack(scene, cfg)
    u, v, C = camera_ops.camera_basis(scene.camera)
    pos = jnp.asarray(scene.camera.position, jnp.float32)

    def body(ci):
        r = jnp.minimum(ci * chunk + jnp.arange(chunk), n_rays - 1)
        if ray_id_map is not None:
            r = ray_id_map(r)
        coords = coord_fn(r)
        origins, dirs = camera_ops.make_rays(u, v, C, pos, coords)
        if gpu_semantics:
            colors = trace_rays_gpu(scene, origins, dirs, cfg, None, pack,
                                    unroll)
        else:
            colors = trace_rays(scene, origins, dirs, cfg, depth, unroll,
                                None, pack)
        if fold4:
            return _fold_subsamples(colors, cfg)
        return colors

    colors = jax.lax.map(body, jnp.arange(nch))
    n_out = n_rays // 4 if fold4 else n_rays
    return colors.reshape(-1, 3)[:n_out]


def _fold_subsamples(colors, cfg: RenderConfig):
    """(4k,3) subsample colors -> (k,3) pixel colors, accumulated in the
    reference's subsample order with clamped ops (cpu/raytracer.c:55-68) —
    the arithmetic of assemble_cpu_image's fold, applied per chunk.
    `reshape(-1, 12)` + column slices: the reshape is layout-free (4
    row-major rows of 3 = 12 contiguous) and the slices fuse into the
    add/mul loop.
    """
    cops = ColorOps(cfg.quantize)
    x12 = colors.reshape(-1, 12)
    acc = cops.zeros((x12.shape[0],))
    for s in range(4):
        acc = cops.add(acc, cops.mul(x12[:, 3 * s:3 * s + 3], 0.25))
    return acc


@functools.partial(jax.jit, static_argnames=("cfg", "depth", "width", "height"))
def _render_cpu_mode(scene: Scene, cfg: RenderConfig, depth: int, width: int, height: int):
    """CPU-reference pipeline: 2x2 supersampling, 0.25 weights, clamp-order
    accumulation (cpu/raytracer.c:50-70)."""
    cfg = resolve_backend(cfg)
    unroll = cfg.resolve_unroll()  # static unroll = reverse-mode diff path
    coord_fn = functools.partial(
        camera_ops.cpu_subpixel_coords_traced, width, height)
    n_rays = width * height * 4
    fold4 = min(cfg.ray_chunk, n_rays) % 4 == 0
    # Block-swizzled ray order for the kernel backend: a sweep tile becomes
    # a compact 2D pixel block instead of a row strip, so the culling
    # hierarchy's ray-tile shafts are far tighter (fewer surviving pair
    # tiles at scale). Pure reordering: the per-ray arithmetic is untouched
    # and the unswizzle below is a reshape/transpose, so images are
    # bit-identical. cfg.block_rays="on"/"off" forces it — a static config
    # field, so it participates in the jit cache key; "auto" means on
    # whenever a block shape divides the resolution.
    blk = _pick_block(width, height) if fold4 else None
    swiz = blk is not None and cfg.backend == "pallas" and (
        cfg.block_rays in ("on", "auto"))
    ray_id_map = (functools.partial(_swiz_ray_ids, width=width,
                                    bx=blk[0], by=blk[1])
                  if swiz else None)
    colors = _trace_image(scene, cfg, depth, n_rays, coord_fn, unroll,
                          fold4=fold4, ray_id_map=ray_id_map)
    if fold4:  # (H*W,3) pixel colors — just finalize + reshape
        cops = ColorOps(cfg.quantize)
        out = cops.finalize(colors)
        if swiz:
            bx, by = blk
            return (out.reshape(height // by, width // bx, by, bx, 3)
                    .transpose(0, 2, 1, 3, 4).reshape(height, width, 3))
        return out.reshape(height, width, 3)
    return assemble_cpu_image(colors, cfg, width, height)


def assemble_cpu_image(colors, cfg: RenderConfig, width: int, height: int):
    """(H*W*4,3) subsample colors -> (H,W,3) image, accumulated in the
    reference's subsample order with clamped ops (cpu/raytracer.c:55-68).

    The fold runs in flat (H*W, 4, 3) space and reshapes to (H, W, 3) only
    at the end: folding in (H, W, 4, 3) made XLA materialize a relaid-out
    copy of the full subsample buffer; the flat fold is value-identical
    (row-major reshape) without the layout change.
    """
    cops = ColorOps(cfg.quantize)
    x12 = colors.reshape(-1, 12)  # layout-free; see _fold_subsamples
    acc = cops.zeros((x12.shape[0],))
    for s in range(4):
        acc = cops.add(acc, cops.mul(x12[:, 3 * s:3 * s + 3], 0.25))
    return cops.finalize(acc).reshape(height, width, 3)


@functools.partial(jax.jit, static_argnames=("cfg", "width", "height"))
def _render_gpu_mode(scene: Scene, cfg: RenderConfig, width: int, height: int):
    """GPU-reference pipeline: render at aliasing*dims with one ray per hi-res
    pixel, iterative bounce loop capped at max_bounce (gpu/raytracer.cu:107-122),
    then box-downscale (gpu/raytracer.cu:49-85).

    The GPU bounce loop is a do/while: `tmp = trace(); color += tmp*nr_acc;
    nr_acc *= hit.nr; while (nr_acc > 0.01 && MAX_BOUNCE-- > 0)`. Note it
    differs from the CPU recursion: accumulation is shallow-first saturating
    add (uint8 in the reference; we keep the cpu-colors float [0,255] clamp
    domain, matching cpu/colors.c rather than the uint8 roundtrip), and entry
    is unconditional for the first bounce.
    """
    import dataclasses as _dc

    hw, hh = width * cfg.aliasing, height * cfg.aliasing
    # gpu/rt.cpp:78-79 multiplies camera w/h by aliasing BEFORE render, so
    # the image-plane distance L = width/(2 tan(fov/2)) uses the HI-RES width
    scene_hi = _dc.replace(
        scene, camera=_dc.replace(scene.camera, width=hw, height=hh)
    )
    coord_fn = functools.partial(camera_ops.gpu_pixel_coords_traced, hw, hh)
    cfg = resolve_backend(cfg)
    unroll = cfg.resolve_unroll()  # static unroll = reverse-mode diff path
    colors = _trace_image(scene_hi, cfg, 0, hw * hh, coord_fn, unroll,
                          gpu_semantics=True)
    return assemble_gpu_image(colors, cfg, width, height)


def assemble_gpu_image(colors, cfg: RenderConfig, width: int, height: int):
    """(hh*hw,3) hi-res colors -> (H,W,3) via the reference's box downscale
    (gpu/raytracer.cu:49-85): sums uint8-quantized texels, /255/a^2, then
    init_color re-quantizes.

    Orientation: `raytrace` writes sample (px,py) to
    hi[hh-py-1][hw-px-1] (gpu/raytracer.cu:97,128); `downscale` reads
    hi[oh-h_py-1][ow-h_px-1] (un-flipping) but writes
    low[height-py-1][width-px-1] (gpu/raytracer.cu:67-84) — so the final
    image is the box average of the sample grid flipped on BOTH axes, the
    same k-decreasing-with-column orientation as the CPU writeout.
    """
    cops = ColorOps(cfg.quantize)
    a = cfg.aliasing
    hi = cops.finalize(colors.reshape(height * a, width * a, 3))
    t = jnp.trunc(hi)  # uint8 quantization of the hi-res buffer
    box = t.reshape(height, a, width, a, 3).sum(axis=(1, 3))
    lo = jnp.clip(box / (255.0 * a * a) * 255.0, 0.0, 255.0)
    return lo[::-1, ::-1]


class SceneRenderer:
    """Device-resident renderer for repeated frames of one scene.

    The one-shot `render_scene` pays host->device upload + accel build +
    (on the kernel backend, inside the program) geometry packing on EVERY
    call. This object does that work once in __init__ and `render()` only
    dispatches the jitted program, so a render/animation/training outer
    loop runs at the sustained per-frame cost:

        r = SceneRenderer(parse_scene(path), RenderConfig())
        for _ in range(n):  img = r.render()

    `render_device()` skips the device->host copy too (returns the jax
    array) for loops that keep consuming on-device.
    """

    def __init__(self, scene_host: Scene, cfg: RenderConfig = RenderConfig()):
        self.cfg = cfg
        self.width = scene_host.camera.width
        self.height = scene_host.camera.height
        scene = scene_to_device(scene_host)
        if cfg.partitioning != "none":
            from raytracing_gpu_tpu.partition.apply import with_accel

            scene, _ = with_accel(scene, cfg.partitioning)
        self.scene = jax.block_until_ready(scene)
        max_nr = float(np.max(np.asarray(scene_host.materials.nr)))
        self.depth = None
        if cfg.mode == "cpu":
            cap = (cfg.diff_max_depth if cfg.quantize == "smooth"
                   else cfg.cpu_max_depth)
            self.depth = required_depth(max_nr, cfg.reflect_cutoff, cap)

    def render_device(self):
        """One frame, left on device (H, W, 3) f32 in [0,255]."""
        w, h = self.width, self.height
        if self.cfg.mode == "cpu":
            return _render_cpu_mode(self.scene, self.cfg, self.depth, w, h)
        return _render_gpu_mode(self.scene, self.cfg, w, h)

    def render(self) -> np.ndarray:
        """One frame as host numpy (H, W, 3) f32 in [0,255]."""
        return np.asarray(self.render_device())


def render_scene(scene_host: Scene, cfg: RenderConfig = RenderConfig()) -> np.ndarray:
    """Render a host scene to an (H, W, 3) float image in [0,255].

    Truncate to uint8 (or write via utils.image.write_ppm) to match the
    reference's `print_color` int cast (cpu/printer.c:13-18).

    One-shot: includes scene upload + accel build + compile-or-cache-hit
    every call. For repeated frames of the same scene use `SceneRenderer`,
    which hoists all of that out of the loop.
    """
    return SceneRenderer(scene_host, cfg).render()


def render_image(scene: Scene, cfg: RenderConfig | None = None,
                 depth: int | None = None):
    """Pure jittable render: scene pytree -> (H, W, 3) f32 image in [0,255].

    Unlike `render_scene` (which returns host numpy and derives the
    recursion depth from the scene's materials), this stays inside JAX: it
    can be jit-compiled, vmapped, and — with cfg.quantize="smooth" (the
    default here) — reverse-mode differentiated end-to-end, so
    `jax.grad(lambda s: loss(render_image(s)))` yields gradients on every
    scene leaf (vertices, normals, materials, lights, camera). The recursion
    depth must be static: it defaults to cfg.diff_max_depth (smooth) /
    cfg.cpu_max_depth (match) rather than being derived from traced
    material values.
    """
    cfg = cfg or RenderConfig(quantize="smooth")
    width, height = scene.camera.width, scene.camera.height
    if depth is None:
        depth = cfg.diff_max_depth if cfg.quantize == "smooth" else cfg.cpu_max_depth
    if cfg.mode == "cpu":
        return _render_cpu_mode(scene, cfg, depth, width, height)
    return _render_gpu_mode(scene, cfg, width, height)


def render(input_path: str, output_path: str, cfg: RenderConfig = RenderConfig()) -> None:
    """CLI-equivalent entry: parse, render, write — `rt in.svati out.ppm`
    (cpu/rt.c:5-10) / `rt in.svati out.png` (gpu/rt.cpp:54-97)."""
    from raytracing_gpu_tpu.models.parser import parse_scene
    from raytracing_gpu_tpu.utils import image as image_io

    scene = parse_scene(input_path)
    img = render_scene(scene, cfg)
    if output_path.endswith(".png"):
        image_io.write_png(output_path, np.trunc(img).astype(np.uint8))
    else:
        image_io.write_ppm(output_path, img)
