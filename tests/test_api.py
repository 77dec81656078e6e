"""Public-API surface tests: one-shot vs device-resident renderer."""

import numpy as np

from raytracing_gpu_tpu import RenderConfig, SceneRenderer, render_scene
from raytracing_gpu_tpu.models.procedural import make_sphere_scene


def test_scene_renderer_matches_render_scene():
    """SceneRenderer (device-resident loop API) must produce exactly the
    one-shot render_scene image, frame after frame — it only hoists the
    upload/accel/compile out of the loop, never changes the program."""
    scene = make_sphere_scene(width=12, height=12)
    cfg = RenderConfig(mode="cpu", quantize="match")
    r = SceneRenderer(scene, cfg)
    a = r.render()
    b = r.render()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, render_scene(scene, cfg))
    assert a.shape == (12, 12, 3)


def test_scene_renderer_gpu_mode():
    scene = make_sphere_scene(width=12, height=12)
    cfg = RenderConfig(mode="gpu", aliasing=1, quantize="match")
    r = SceneRenderer(scene, cfg)
    np.testing.assert_array_equal(r.render(), render_scene(scene, cfg))


def test_ray_chunking_covers_partial_tail_chunk():
    """Ray counts that do not divide ray_chunk must still render every ray.

    Regression: _trace_image's chunk count used a broken ceil-div
    (`-(-n) // c` == floor) and silently dropped the tail chunk — every
    square corpus render divided evenly, so only non-square native
    resolutions (spheres/car-on-road/dark-night at 960x540) hit it, as a
    reshape error deep in image assembly. A 20x12 cpu-mode render is 960
    rays; ray_chunk=256 leaves a 192-ray tail. Both mode pipelines must
    equal the single-chunk image exactly.
    """
    scene = make_sphere_scene(width=20, height=12)
    for mode in ("cpu", "gpu"):
        one = render_scene(scene, RenderConfig(mode=mode, aliasing=1,
                                               quantize="match"))
        chunked = render_scene(scene, RenderConfig(mode=mode, aliasing=1,
                                                   quantize="match",
                                                   ray_chunk=256))
        np.testing.assert_array_equal(one, chunked)
        assert one.shape == (12, 20, 3)


def test_block_swizzled_rays_bit_identical():
    """Block-swizzled ray order (compact 2D pixel blocks per sweep tile —
    the big-scene culling lever) is pure reordering: per-ray arithmetic is
    untouched and the unswizzle is a reshape/transpose, so the rendered
    image must be BIT-IDENTICAL to row-major order on the kernel backend."""
    import dataclasses

    scene = make_sphere_scene(width=16, height=16, n_lat=8, n_lon=12)
    cfg = RenderConfig(mode="cpu", quantize="match", backend="pallas",
                       block_rays="off")
    base = render_scene(scene, cfg)
    # block_rays is a static config field: flipping it reaches a DIFFERENT
    # cached executable, no cache clearing needed
    swiz = render_scene(scene, dataclasses.replace(cfg, block_rays="on"))
    np.testing.assert_array_equal(base, swiz)


def test_block_swizzle_non_square_resolution():
    """Swizzle must stay bit-identical at non-square, non-8-divisible
    resolutions (20x12 divides only the 4x4 and smaller block shapes)."""
    import dataclasses

    scene = make_sphere_scene(width=20, height=12, n_lat=8, n_lon=12)
    cfg = RenderConfig(mode="cpu", quantize="match", backend="pallas",
                       block_rays="off")
    base = render_scene(scene, cfg)
    swiz = render_scene(scene, dataclasses.replace(cfg, block_rays="on"))
    np.testing.assert_array_equal(base, swiz)
    assert base.shape == (12, 20, 3)
