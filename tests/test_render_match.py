"""End-to-end render tests vs the CPU-reference oracle.

The full 20-scene corpus (tests/*.svati — the reference's de-facto test
suite, SURVEY §4) is asserted against golden renders from the compiled C
reference under EVERY backend: jnp (pure XLA) and pallas (the sweep kernel,
interpret mode on CPU — the same kernel code the GPU compiles). This is the
runtime form of the reference's implicit
'every build-matrix variant renders the same scenes' contract
(gpu/CMakeLists.txt:4-15), which the reference itself never automated.

The comparator tolerates off-by-one uint8 differences on a small fraction of
pixels (f32 reassociation between gcc scalar code and XLA vector code around
truncation boundaries); any structural mismatch fails loudly. Kernel
backends run at reduced resolution to bound interpreter time; the slow-
marked full-resolution test below reproduces the 512x512 claim in-repo.
"""


import numpy as np
import pytest

from raytracing_gpu_tpu.config import RenderConfig
from raytracing_gpu_tpu.models.parser import parse_scene_text
from raytracing_gpu_tpu.render import render_scene
from raytracing_gpu_tpu.utils.compare import assert_images_close

from oracle import oracle_available, oracle_render, scene_text

pytestmark = pytest.mark.skipif(not oracle_available(), reason="reference not mounted")

# (scene, resolution) — resolutions chosen so the O(pixels x triangles)
# oracle and the virtual-CPU XLA render both stay fast; island_smooth is the
# reference's own octree stress scene (gpu/bench.cu:14)
CORPUS = [
    ("triangle", 64),
    ("triangle-ambient", 64),
    ("triangle-left-ambient", 64),
    ("cube", 64),
    ("cube-ambient", 64),
    ("point-light", 64),
    ("dir-light-shadows", 64),
    ("lighthouse", 48),
    ("susan", 48),
    ("spheres", 32),          # Nr 0.85/0.45 mirrors, 6 lights, 4812 tris
    ("car-on-road", 32),      # Nr=1.0 (unbounded reference recursion)
    ("sphere-spec", 32),
    ("car", 32),
    ("dark-night", 32),       # 29 objects, 1457 triangles
    ("island_smooth", 32),    # 50 objects — octree stress scene
    ("secret", 24),
    ("secret2", 24),
    ("sphere-spec_smooth", 32),
    ("sphere-specular", 24),
    ("susans_smooth", 32),
]


def run_match(name, w, h, backend="jnp", **cmp_kwargs):
    golden = oracle_render(name, w, h)
    scene = parse_scene_text(scene_text(name, w, h))
    img = render_scene(
        scene, RenderConfig(mode="cpu", quantize="match", backend=backend)
    )
    ours = np.trunc(img).astype(np.uint8)
    return assert_images_close(ours, golden, context=f"{name}-{backend}",
                               **cmp_kwargs)


@pytest.mark.parametrize("name,res", CORPUS, ids=[c[0] for c in CORPUS])
def test_corpus_jnp(name, res):
    run_match(name, res, res)


@pytest.mark.parametrize("name,res", CORPUS, ids=[c[0] for c in CORPUS])
def test_corpus_pallas(name, res):
    """Every corpus scene through the flagship Pallas kernel vs the C
    oracle.

    Half resolution (min 24px): the Pallas interpreter executes each grid
    cell sequentially on CPU, so full-res corpus sweeps would dominate the
    suite. Winner flips on geometry edges (separately-compiled f32 programs)
    are absorbed by the edge-aware comparator exactly as for jnp.
    """
    r = max(24, res // 2)
    run_match(name, r, r, backend="pallas")


def test_smooth_close_to_oracle():
    """smooth (differentiable) mode is allclose to the oracle on a scene
    without saturating colors."""
    golden = oracle_render("triangle", 64, 64)
    scene = parse_scene_text(scene_text("triangle", 64, 64))
    img = render_scene(scene, RenderConfig(mode="cpu", quantize="smooth"))
    ours = np.trunc(img).astype(np.uint8)
    # smooth mode skips intermediate clamping: allow ±2 off-edge
    assert_images_close(ours, golden, tol=2, context="triangle-smooth")


# Native-resolution corpus for the card: every behavior class at
# the resolution the scene files declare (camera line 1 of each .svati) —
# point lights + shadows (cube), smooth normals (susan), 6 lights + Nr=0.85
# mirrors (spheres), Nr=1.0 depth-capped mirrors (car-on-road), 29-object
# scene (dark-night), so the "matches the reference" claim is held at
# advertised resolution across the behavior space, not one mesh.
# (name, w, h, max_frac_off_edge): the off-edge budget is the comparator
# default except for specular/reflective scenes, where mirrors and specular
# pows displace FP-boundary flips away from image-space edges. Non-default
# budgets are the off-edge flip count measured by an earlier build's
# full-res sweep plus ~2x margin; every tolerated outlier is additionally
# magnitude-capped (assert_images_close max_off_edge_mag). The flip class
# is root-caused — compiler FP-contraction resolving ulp-tied seam/shadow
# candidates the other way (tests/test_seam_tie.py, c_mirror) — measured:
# secret 54, sphere-spec_smooth 15, sphere-specular 57 (31 on the u=0
# column), car 30, spheres 116 (32 on the u=0 column), susans_smooth 52.
FULLRES = [
    ("triangle", 512, 512, None),
    ("triangle-ambient", 512, 512, None),
    ("triangle-left-ambient", 512, 512, None),
    ("cube", 512, 512, None),
    ("cube-ambient", 512, 512, None),
    ("susan", 512, 512, None),
    ("secret", 512, 512, 4e-4),        # specular sphere pair (54 measured)
    ("secret2", 512, 512, None),
    ("sphere-spec", 512, 512, None),
    ("sphere-spec_smooth", 512, 512, 1e-4),
    ("sphere-specular", 512, 512, 4e-4),  # u=0 seam column (57 measured)
    ("point-light", 960, 540, None),
    ("dir-light-shadows", 960, 540, None),
    ("lighthouse", 960, 540, None),
    ("car", 960, 540, 1e-4),           # 30 measured, magnitudes to 64
    ("spheres", 960, 540, 4e-4),       # 6 lights (4 point), Nr=0.85 mirrors
    ("car-on-road", 960, 540, None),
    ("dark-night", 960, 540, None),
    ("island_smooth", 960, 540, None), # 50 objects — the reference's octree
                                       # stress scene (gpu/bench.cu:14)
    ("susans_smooth", 960, 540, 2e-4), # 1,940-tri smooth mesh, Nr mirrors
                                       # (52 measured; was 4e-4 in round 3)
]


@pytest.mark.slow
@pytest.mark.gpu
@pytest.mark.parametrize("name,w,h,off_edge", FULLRES,
                         ids=[c[0] for c in FULLRES])
def test_full_resolution_on_card(gpu, name, w, h, off_edge):
    """The advertised claim, reproducible in-repo: each scene at its native
    resolution through the sweep kernel on the card matches the C oracle under
    the edge-aware policy (>=99.9% of pixels within ±1 off-edge; larger
    diffs on geometry/shadow edges, plus at most 0.005% isolated off-edge
    shadow-boundary flips — see assert_images_close)."""
    golden = oracle_render(name, w, h)
    scene = parse_scene_text(scene_text(name, w, h))
    img = render_scene(
        scene, RenderConfig(mode="cpu", quantize="match", backend="pallas")
    )
    ours = np.trunc(img).astype(np.uint8)
    kw = {} if off_edge is None else {"max_frac_off_edge": off_edge}
    stats = assert_images_close(ours, golden,
                                context=f"{name}-{w}x{h}-pallas", **kw)
    if stats is not None:
        print(f"{name} {w}x{h}:", stats)
