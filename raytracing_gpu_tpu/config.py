"""Runtime configuration.

The reference hides every knob behind compile-time defines or hard-coded
literals (gpu/CMakeLists.txt:4-15 layout/partitioning defines; aliasing=3 at
gpu/rt.cpp:67; MAX_BOUNCE=10 at gpu/raytracer.cu:113; reflection cutoff 0.01 at
cpu/raytracer.c:21; self-hit epsilon 0.01 at cpu/hit.c:59; Möller–Trumbore
EPSILON=1e-7 at cpu/hit.c:4). Here they are a single runtime dataclass; the
reference's 3x3 compile-time LAYOUT x PARTITIONING build matrix becomes the
runtime `partitioning` / `backend` fields (this build has exactly one memory
layout — padded SoA device arrays, the analog of LAYOUT_SOA, which the
reference itself defaults to at gpu/CMakeLists.txt:7).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All runtime knobs for a render.

    Attributes:
      mode: "cpu" reproduces the CPU reference pipeline (2x2 supersampling with
        0.25 weights, cpu/raytracer.c:55-68; recursion until attenuation
        coef < 0.01, cpu/raytracer.c:19-34). "gpu" reproduces the GPU pipeline
        (render at `aliasing`x resolution with one ray per hi-res pixel, then
        box-downscale, gpu/rt.cpp:67-96 + gpu/raytracer.cu:49-128; iterative
        bounce loop capped at MAX_BOUNCE).
      quantize: "match" clamps to [0,255] at every color op exactly like
        cpu/colors.c (bit-matching the oracle, but non-differentiable);
        "smooth" computes shading in linear f32 and clamps once at the end
        (differentiable; allclose to the oracle away from clamp boundaries).
      partitioning: "none" | "aabb" | "octree" — runtime analog of the
        reference's PARTITIONING_* compile-time matrix (gpu/CMakeLists.txt:12-15),
        defaulting to octree exactly like the reference build (line 15). On
        the jnp backend this selects object-level AABB / octree-node-box
        pre-culling; on the kernel backends it selects the pair-tile mask
        structure (none = brute force, aabb = flat leaf-tile slab tests,
        octree = coarse-to-fine morton-tile hierarchy). Culling is
        conservative in every mode: renders are bit-identical across modes.
      backend: intersection path. "jnp" is the plain-XLA all-pairs path
        (the reference every other path is tested against); "pallas" is
        the Pallas sweep kernel (Triton route, ops/pallas_intersect.py),
        which skips culled (ray-tile, triangle-tile) pairs — compiled on
        the GPU, run by the Pallas interpreter on the CPU (tests only);
        "auto" (default) picks "pallas" on the GPU and "jnp" elsewhere
        (render.resolve_backend).
      max_bounce: bounce cap for "gpu" mode (gpu/raytracer.cu:113).
      cpu_max_depth: safety cap on the emulated recursion depth in "cpu" mode
        (the reference recursion terminates via coef < cutoff, which never
        happens for Nr>=1 materials; the while_loop early-exits on all-miss,
        so a high cap costs nothing on typical scenes).
      diff_max_depth: recursion cap for the unrolled differentiable path
        (quantize="smooth"), bounding compile time and grad memory.
      reflect_cutoff: attenuation cutoff (cpu/raytracer.c:21, gpu/raytracer.cu:122).
      self_hit_eps: minimum accepted hit distance (cpu/hit.c:59).
      mt_eps: Möller–Trumbore determinant/t epsilon (cpu/hit.c:4).
      aliasing: supersampling factor for "gpu" mode (gpu/rt.cpp:67).
      ray_chunk: rays processed per XLA program instance (memory tiling of the
        R x T intersection problem; small renders are unaffected, the chunk
        clamps to R). On the jnp path a chunk holds several (ray_chunk, T)
        f32 planes, so large scenes need a smaller chunk; deriving the
        default from the triangle count is open work (ROADMAP).
      pad_triangles: pad triangle count to a multiple of this (keeps the
        padded shapes, and with them the compiled programs, few).
      pad_objects: pad object count to a multiple of this.
      unroll: bounce-loop strategy. "auto" (default) statically unrolls when
        quantize="smooth" (reverse-mode AD needs a static loop;
        lax.while_loop is not reverse-differentiable) and uses the
        early-exiting lax.while_loop otherwise. "while" / "static" force one
        strategy — e.g. unroll="static" makes a quantize="match" render
        differentiable, at the compile/memory cost of the full unroll. The
        two strategies produce identical images (dead iterations accumulate
        exactly zero; parity-tested on a mirror scene in
        tests/test_gpu_mode.py). Caveat: a match-mode GPU-pipeline render is
        grad-computable with unroll="static" but its gradient is exactly
        zero — the downscale's uint8 trunc (gpu/raytracer.cu:68-80) has zero
        derivative; use quantize="smooth" (or mode="cpu") for real gradients.
      remat: apply jax.checkpoint to each statically-unrolled bounce step so
        backward-pass memory stays O(1) in depth instead of O(depth)
        (activations are recomputed bounce-by-bounce on the backward sweep).
        No effect on the while_loop path or on forward-only renders.
      block_rays: block-swizzled ray order on the kernel backend ("auto" |
        "on" | "off"): each sweep tile covers a compact 2D pixel block
        instead of a row strip, tightening the culling hierarchy's ray-tile
        shafts. Pure reordering — images are bit-identical
        (tests/test_api.py). "auto" == on whenever a block shape divides
        the resolution; "off" restores row-major order.

    Every field participates in the jit cache key (the dataclass is
    frozen/hashable and passed static).
    """

    mode: str = "cpu"
    quantize: str = "match"
    partitioning: str = "octree"
    backend: str = "auto"
    max_bounce: int = 10
    cpu_max_depth: int = 64
    diff_max_depth: int = 6
    reflect_cutoff: float = 0.01
    self_hit_eps: float = 0.01
    mt_eps: float = 1e-7
    aliasing: int = 3
    ray_chunk: int = 65536
    pad_triangles: int = 128
    pad_objects: int = 8
    unroll: str = "auto"
    remat: bool = True
    block_rays: str = "auto"

    def resolve_unroll(self) -> bool:
        """True when the bounce loops should statically unroll (the
        reverse-differentiable strategy); see the `unroll` attribute."""
        if self.unroll == "auto":
            return self.quantize == "smooth"
        return self.unroll == "static"

    def __post_init__(self):
        if self.mode not in ("cpu", "gpu"):
            raise ValueError(f"mode must be 'cpu' or 'gpu', got {self.mode!r}")
        if self.quantize not in ("match", "smooth"):
            raise ValueError(f"quantize must be 'match' or 'smooth', got {self.quantize!r}")
        if self.partitioning not in ("none", "aabb", "octree"):
            raise ValueError(f"bad partitioning {self.partitioning!r}")
        if self.backend not in ("auto", "jnp", "pallas"):
            raise ValueError(f"bad backend {self.backend!r}")
        if self.unroll not in ("auto", "while", "static"):
            raise ValueError(f"bad unroll {self.unroll!r}")
        if self.block_rays not in ("auto", "on", "off"):
            raise ValueError(f"bad block_rays {self.block_rays!r}")
