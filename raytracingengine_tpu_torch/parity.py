"""Comparison budgets shared by the tests and chip_smoke.py.

Closest-hit seam ties: a ray that grazes an edge or a plane seam can pick
a different winner when two implementations round a distance differently
(FMA contraction on the GPU, fp32 vs fp64 against the reference). Such a
pixel differs by a whole shading level, so it is counted against a pixel
budget instead of loosening the elementwise tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SeamReport:
    """Elementwise HDR comparison under the seam budget: at most
    max(4, 1e-3 * pixels) pixels may exceed `atol`."""

    pixels: int
    flips: int  # pixels with some channel off by more than atol
    budget: int
    max_abs: float
    atol: float

    @property
    def ok(self) -> bool:
        return self.flips <= self.budget

    def __str__(self) -> str:
        return (f"max|diff|={self.max_abs:.3e} seam-flip pixels={self.flips}"
                f"/{self.pixels} (budget {self.budget}, atol {self.atol:g})")


def seam_budget(ours, ref, atol: float = 1e-4) -> SeamReport:
    """Compare two HDR images/ray blocks [..., 3] under the seam budget."""
    a = np.asarray(ours, np.float64).reshape(-1, 3)
    b = np.asarray(ref, np.float64).reshape(-1, 3)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    diff = np.abs(a - b).max(axis=1)
    diff = np.where(np.isfinite(a).all(axis=1) & np.isfinite(b).all(axis=1), diff, np.inf)
    pixels = a.shape[0]
    return SeamReport(
        pixels=pixels,
        flips=int((diff > atol).sum()),
        budget=max(4, int(1e-3 * pixels)),
        max_abs=float(diff.max()) if pixels else 0.0,
        atol=atol,
    )


def golden_ldr_mismatches(ours: np.ndarray, gold: np.ndarray) -> list[str]:
    """LDR [H,W,3] uint8 against a pinned golden at the budget of the JAX
    package's tests/test_golden_artifacts.py: pixels more than 1 step off
    are at most max(4, 1e-3 * pixels), each reproduces a golden
    4-neighbour exactly and sits on an edge, and > 95% of bytes are exact.
    Returns the list of violations (empty when within budget)."""
    if ours.shape != gold.shape:
        return [f"shape {ours.shape} != golden {gold.shape}"]
    h, w = gold.shape[:2]
    diff = np.abs(ours.astype(int) - gold.astype(int))
    seam_ys, seam_xs = np.nonzero(diff.max(axis=2) > 1)
    errors = []
    if len(seam_ys) > max(4, int(1e-3 * h * w)):
        errors.append(f"{len(seam_ys)} pixels beyond 1 LDR step")
    for y, x in zip(seam_ys, seam_xs):
        neighbors = [
            gold[yy, xx]
            for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1))
            if 0 <= yy < h and 0 <= xx < w
        ]
        if not any(np.array_equal(ours[y, x], n) for n in neighbors):
            errors.append(f"pixel ({y},{x}) ours={ours[y, x]} gold={gold[y, x]} "
                          "matches no golden neighbour")
        elif not any(np.abs(n.astype(int) - gold[y, x].astype(int)).max() > 1
                     for n in neighbors):
            errors.append(f"pixel ({y},{x}) diverges in a flat region")
    frac_exact = float((diff == 0).mean())
    if frac_exact <= 0.95:
        errors.append(f"only {frac_exact:.1%} bytes exact")
    return errors


def reference_frame_stats(img, ref) -> tuple[float, float]:
    """HDR frame against a real-engine fp64 frame (refbuild/*.hdr64):
    -> (p99.9 of |HDR diff|, fraction of LDR subpixels more than 1 byte
    off), the two numbers tests/test_reference_parity.py budgets."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if img.shape != ref.shape:
        raise ValueError(f"shape mismatch {img.shape} vs {ref.shape}")
    p999 = float(np.percentile(np.abs(img - ref), 99.9))
    ldr = lambda x: (np.clip(x, 0.0, 1.0) * 255.0).astype(np.int32)
    bad_frac = float((np.abs(ldr(img) - ldr(ref)) > 1).mean())
    return p999, bad_frac
