"""Image comparison / regression reporting.

The reference had no golden-image tests at all (validation was visual —
SURVEY §4); this module is the oracle comparator the reference never had.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImageDiff:
    max_abs: int
    mean_abs: float
    n_diff: int  # pixels differing at all
    n_bad: int  # pixels differing by more than `tol`
    total: int
    tol: int

    @property
    def frac_diff(self) -> float:
        return self.n_diff / max(self.total, 1)

    @property
    def frac_bad(self) -> float:
        return self.n_bad / max(self.total, 1)

    def __str__(self) -> str:
        return (
            f"max|d|={self.max_abs} mean|d|={self.mean_abs:.4f} "
            f"diff={self.n_diff}/{self.total} ({100 * self.frac_diff:.2f}%) "
            f">{self.tol}: {self.n_bad} ({100 * self.frac_bad:.3f}%)"
        )


def diff_images(a: np.ndarray, b: np.ndarray, tol: int = 1) -> ImageDiff:
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = np.abs(a - b)
    per_pix = d.max(axis=-1)
    return ImageDiff(
        max_abs=int(d.max()) if d.size else 0,
        mean_abs=float(d.mean()) if d.size else 0.0,
        n_diff=int((per_pix > 0).sum()),
        n_bad=int((per_pix > tol).sum()),
        total=int(per_pix.size),
        tol=tol,
    )


def edge_mask(img: np.ndarray, thresh: int = 8, dilate: int = 1) -> np.ndarray:
    """Boolean (H,W) mask of pixels at/near discontinuities of `img`.

    A pixel is an edge pixel if any channel differs by more than `thresh`
    from any 4-neighbor; the mask is then dilated `dilate` steps (8-conn).
    """
    g = np.asarray(img, np.int32)
    h, w = g.shape[:2]
    m = np.zeros((h, w), bool)
    d = np.abs(g[1:] - g[:-1]).max(axis=-1) > thresh
    m[1:] |= d
    m[:-1] |= d
    d = np.abs(g[:, 1:] - g[:, :-1]).max(axis=-1) > thresh
    m[:, 1:] |= d
    m[:, :-1] |= d
    for _ in range(dilate):
        m2 = m.copy()
        m2[1:] |= m[:-1]
        m2[:-1] |= m[1:]
        m2[:, 1:] |= m[:, :-1]
        m2[:, :-1] |= m[:, 1:]
        m = m2
    return m


def max_outlier_run(mask: np.ndarray) -> int:
    """Longest run of consecutive True pixels along any single column or row
    of a boolean (H, W) mask.

    The structure detector for the comparator: tolerated off-edge outliers
    are ulp-tie decision flips, which land as ISOLATED pixels (measured
    across the 20-scene full-res corpus: max run 2; even the u=0 seam
    columns of spheres / sphere-specular scatter their flips down the
    column). A contiguous stripe — the signature of a systematic winner or
    addressing bug — forms a long run even when its count and magnitude fit
    the scalar budgets.
    """
    m = np.asarray(mask, bool)
    if m.ndim != 2 or not m.any():
        return int(m.any())
    best = 0
    for arr in (m, m.T):  # runs down columns, then along rows
        run = np.zeros(arr.shape[1], np.int32)
        for row in arr:
            run = (run + 1) * row
            best = max(best, int(run.max()))
    return best


def assert_images_close(
    a: np.ndarray,
    b: np.ndarray,
    tol: int = 1,
    max_frac_diff: float = 0.05,
    max_mean_abs: float = 1.0,
    edge_thresh: int = 8,
    max_frac_off_edge: float = 5e-5,
    max_off_edge_mag: int = 80,
    max_off_edge_run: int = 4,
    run_mag_floor: int = 8,
    context: str = "",
) -> ImageDiff:
    """Assert `a` matches golden `b` up to FP-boundary effects.

    Rationale: the oracle is scalar gcc C; the XLA program evaluates the
    same f32 formulas with different contraction (FMA) and association.
    Exactly-on-boundary subsamples (a barycentric coordinate of 0.0, a shadow
    grazing a silhouette) can flip hit/miss — but such flips can only change
    pixels at *discontinuities of the image*. So:

    - off-edge pixels (per `edge_mask(b)`) must match within `tol` (1 uint8
      step absorbs truncation jitter);
    - edge pixels may differ, bounded by `max_frac_diff` of all pixels and
      `max_mean_abs` overall mean error.
    """
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d = diff_images(a, b, tol=tol)
    em = edge_mask(b, thresh=edge_thresh)
    per_pix = np.abs(a - b).max(axis=-1)
    off_edge_bad = (per_pix > tol) & ~em
    # The edge mask is contrast-thresholded, so a shadow silhouette in a
    # DARK region (contrast <= edge_thresh by construction: the flip itself
    # is the contrast) escapes it — measured on susan 512x512: exactly one
    # pixel whose channels scale uniformly (one light's shadow ray flipping
    # at an f32 boundary). Such flips are isolated; a real shading/logic bug
    # moves contiguous regions. Allow a tiny count of off-edge outliers
    # (default 0.005% = 13 pixels at 512x512) instead of zero. Specular /
    # reflective / multi-point-light scenes need a larger budget (callers
    # pass the per-scene MEASURED value + margin, tests/test_render_match.py
    # FULLRES): mirrors and specular pows DISPLACE hit/shadow flip
    # discontinuities away from image-space edges. The residual flip class
    # is fully root-caused (round 4, tests/test_seam_tie.py + c_mirror):
    # with the winner-distance formula and dot association matched to the
    # reference bit-for-bit (eager execution reproduces every seam winner
    # exactly), the remaining flips are COMPILER FP-CONTRACTION on ulp-tied
    # candidates — jit fusion contracts mul+add chains into FMAs that gcc
    # -O2/x86-64 does not emit, shifting distances 1 ulp and resolving
    # seam ties the other way (the reference itself flips these pixels if
    # rebuilt with -mfma). Irreducible without optimization barriers on
    # the hot path; bounded here in count AND magnitude instead.
    max_off_edge = int(max_frac_off_edge * per_pix.size)
    # Tolerated off-edge outliers are bounded in MAGNITUDE too: a hit/
    # shadow decision flip swaps a pixel between two legitimate shading
    # values (measured max 64 across the 20-scene full-res corpus); a
    # localized rendering artifact of arbitrary brightness must not hide
    # inside the count budget.
    off_edge_mag = int(per_pix[off_edge_bad].max()) if off_edge_bad.any() else 0
    # ... and in STRUCTURE: a contiguous column/row stripe of outliers is a
    # systematic artifact even when count and magnitude fit the budgets.
    # Only outliers ABOVE run_mag_floor count toward a run: a displaced
    # silhouette in a mirror reflection (two separately compiled backends
    # shift a reflected edge by one pixel) produces short contiguous
    # strings of |d| <= ~4 that are legitimate FP-flip fallout — measured
    # run 6 of mag <= 3 on spheres gpu-mode pallas-vs-jnp — while a real
    # addressing/winner bug paints full-contrast pixels. The VERDICT r4
    # scenario (a 30-pixel column stripe of magnitude 10) still fails.
    off_edge_run = max_outlier_run(off_edge_bad
                                   & (per_pix > max(tol, run_mag_floor)))
    # frac limit applies to pixels beyond tol (all necessarily on edges);
    # within-tol truncation jitter is unbounded in count by design
    ok = (
        int(off_edge_bad.sum()) <= max_off_edge
        and off_edge_mag <= max_off_edge_mag
        and off_edge_run <= max_off_edge_run
        and d.frac_bad <= max_frac_diff
        and d.mean_abs <= max_mean_abs
    )
    if not ok:
        ys, xs = np.nonzero(off_edge_bad)
        detail = ""
        if len(ys):
            y, x = ys[0], xs[0]
            detail = (
                f"; {len(ys)} off-edge pixels differ (max|d|={off_edge_mag}, "
                f"run={off_edge_run}, budget {max_off_edge}@<="
                f"{max_off_edge_mag} run<={max_off_edge_run}), e.g. ({y},{x}) "
                f"ours={a[y, x].tolist()} golden={b[y, x].tolist()}"
            )
        raise AssertionError(
            f"images differ{' (' + context + ')' if context else ''}: {d}{detail}"
        )
    return d
