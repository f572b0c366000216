"""Comparison budgets shared by the tests and chip_smoke.py.

Closest-hit seam ties: a ray that grazes an edge or a plane seam can pick
a different winner when two implementations round a distance differently
(FMA contraction on the GPU, fp32 vs fp64 against the reference). Such a
pixel differs by a whole shading level, so it is counted against a pixel
budget instead of loosening the elementwise tolerance.

Gradient budgets (the JAX package's tests/test_chain_grad.py:35-57,
86-101): fp32 sums of many per-ray terms in different orders, so each
scene leaf gets rtol 2e-3 and an atol of 2e-4 plus 1e-3 of the leaf's
largest reference entry. Ray-direction cotangents are compared on their
part tangential to the ray: the adjoint's sky term skips sky_color's
normalize of the already-unit direction, which changes only the radial
part, and the camera's own normalize removes that. The adjoint kernel's
table cotangents are held to its plain version row by row
(`table_cot_rows`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracingengine_tpu_torch.kernels import chain_grad as cg


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


def grad_leaf_mismatches(
    ours: dict[str, np.ndarray], ref: dict[str, np.ndarray], rtol: float = 2e-3, atol: float = 2e-4
) -> list[str]:
    """Leaf-by-leaf gradient comparison -> list of violations (empty when
    every leaf of `ref` is within rtol and atol + 1e-3 * max|ref leaf|)."""
    errors = []
    if sorted(ours) != sorted(ref):
        return [f"keys differ: {sorted(set(ours) ^ set(ref))}"]
    for k in sorted(ref):
        a = np.asarray(ours[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        if a.shape != b.shape:
            errors.append(f"{k}: shape {a.shape} != {b.shape}")
            continue
        if b.size == 0:
            continue
        tol = atol + 1e-3 * (np.abs(b).max() + 1e-6) + rtol * np.abs(b)
        bad = ~(np.abs(a - b) <= tol)
        if bad.any():
            i = np.unravel_index(np.argmax(np.where(bad, np.abs(a - b), -1.0)), a.shape)
            errors.append(f"{k}: {int(bad.sum())} entries off, worst {a[i]:.6g} vs {b[i]:.6g}")
    return errors


def origin_cot_ok(ours, ref) -> tuple[bool, float, float]:
    """Ray-origin cotangents [R,3]: max|diff| <= 1e-4 * max|ref| ->
    (ok, max|diff|, bound)."""
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    bound = 1e-4 * (float(np.abs(b).max()) + 1e-6)
    return err <= bound, err, bound


def direction_cot_ok(ours, ref, d) -> tuple[bool, float, float, float]:
    """Ray-direction cotangents [R,3], tangential parts against unit
    directions d: p99 < 2e-3 * scale and max < 2e-2 * scale, scale =
    max|tangential ref| -> (ok, p99, max, scale)."""
    dn = np.asarray(d, np.float64)
    proj = lambda g: np.asarray(g, np.float64) - dn * np.sum(np.asarray(g, np.float64) * dn, 1, keepdims=True)  # noqa: E731
    ta, tb = proj(ours), proj(ref)
    scale = float(np.abs(tb).max()) + 1e-6
    err = np.abs(ta - tb)
    p99, mx = float(np.quantile(err, 0.99)), float(err.max())
    return p99 < 2e-3 * scale and mx < 2e-2 * scale, p99, mx, scale


def ray_cot_seam_budget(ours, ref) -> SeamReport:
    """Adjoint kernel vs its plain version, ray cotangents [R,3]: the seam
    budget at atol 1e-3 of the largest plain entry (a flipped pixel's rays
    took another path, so its cotangents differ as a whole)."""
    b = np.asarray(ref, np.float64)
    return seam_budget(ours, b, atol=1e-3 * float(np.abs(b).max()) if b.size else 0.0)


#: Row names of the scene tables (kernels/chain_trace.py::SceneTables).
TABLE_ROWS = {
    "sph": ("center.x", "center.y", "center.z", "r^2"),
    "pl": ("normal.x", "normal.y", "normal.z", "p.n"),
    "tri": tuple(f"{v}.{c}" for v in ("v0", "e1", "e2", "normal") for c in "xyz"),
    "mat": ("albedo.r", "albedo.g", "albedo.b", "specular", "shininess", "transparency", "ior"),
    "light": ("position.x", "position.y", "position.z", "emission.r", "emission.g",
              "emission.b", "active"),
}


@dataclasses.dataclass(frozen=True)
class RowReport:
    """One table row's cotangent against its plain version, at the entry
    nearest to (or furthest past) its bound."""

    table: str
    row: str
    err: float  # |diff| at that entry (inf where ours is not finite)
    bound: float  # that entry's bound
    row_max: float  # max|plain row|

    @property
    def ok(self) -> bool:
        return self.err <= self.bound

    def __str__(self) -> str:
        return (f"{self.table}.{self.row}: |diff| {self.err:.3e} <= {self.bound:.3e} "
                f"(max|plain row| {self.row_max:.3e})")


def _entry_bounds(ref) -> np.ndarray:
    """table_cot_rows' bound of each entry of a table's plain cotangents."""
    table_max = float(np.abs(ref).max())  # a table has at least one column
    row_max = np.abs(ref).max(axis=1, keepdims=True)
    return 1e-3 * row_max + 2e-3 * np.abs(ref) + 1e-6 * table_max


def table_cot_rows(table: str, ours, ref, slack=None) -> list[RowReport]:
    """Adjoint kernel vs its plain version, one table's cotangent [rows,
    cols] (each entry a sum over all rays), row by row: every entry within
    1e-3 * max|plain row| + 2e-3 * |plain entry| + 1e-6 * max|plain table|.

    The form is grad_leaf_mismatches'. The rows of a table differ in scale
    (albedo and shininess, position and emission), so each row is held to
    its own largest entry: a sign or factor error in any row that carries a
    cotangent fails it. fp32 sums of ~10^6 rays in another order, and the
    flipped pixels' rays, each one ray's share of a sum over ~10^5 rays,
    stay far inside. The last term holds a row that is zero in the plain
    version (ior: the chain traces no refraction) to fp32 noise at the
    table's scale. `slack` ([rows, cols], optional) widens each entry's
    bound by that much (`table_cot_rows_vs_f64`)."""
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if a.shape != b.shape or a.shape[0] != len(TABLE_ROWS[table]):
        raise ValueError(f"table {table}: shape {a.shape} vs plain {b.shape}")
    bounds = _entry_bounds(b)
    if slack is not None:
        bounds = bounds + np.asarray(slack, np.float64)
    reports = []
    for r, row in enumerate(TABLE_ROWS[table]):
        diff = np.where(np.isfinite(a[r]), np.abs(a[r] - b[r]), np.inf)
        j = int(np.argmax(diff - bounds[r]))
        reports.append(RowReport(table, row, float(diff[j]), float(bounds[r, j]),
                                 float(np.abs(b[r]).max())))
    return reports


#: How far an adjoint kernel's table cotangents may lie from a float64
#: reference in `table_cot_rows_vs_f64`: table_cot_rows' bound plus this
#: many times the float32 plain version's own distance. Set from the stress
#: scene's sphere rows (PERF.md §6, PR 9), where no float32 sum comes within
#: table_cot_rows' bound of float64. Per entry the kernel's and the plain
#: version's rounding are independent, so an entry where the plain version
#: lands close by chance needs a factor above 1: the worst entries of seeds
#: 7, 8 and 9 needed 1.81, 1.08 and 2.42 (`f64_factors_needed`; seed 7, the
#: one chip_smoke.py holds, read the same in four runs). A sign or factor
#: error in the pullback moves the entries it touches by their own size, up
#: to the row's largest (~8e-4 there): two orders over this bound.
F64_PLAIN_FACTOR = 3.0


def table_cot_rows_vs_f64(table: str, ours, plain32, plain64) -> list[RowReport]:
    """An adjoint kernel's table cotangents against a float64 reference
    (its plain version run in float64 on the same inputs), row by row:
    every entry within table_cot_rows' bound against the float64 entry plus
    F64_PLAIN_FACTOR times the float32 plain version's own distance from it.

    Where float32 itself cannot come within table_cot_rows' bound of the
    float64 sums (the sphere columns of a scene of hundreds of overlapping
    spheres, each summing near-silhouette rays whose roots lose the last
    bits of the discriminant), this holds the kernel to be as close to them
    as the float32 plain version, up to the factor."""
    a, b, c = (np.asarray(x, np.float64) for x in (ours, plain32, plain64))
    return table_cot_rows(table, a, c, slack=F64_PLAIN_FACTOR * np.abs(b - c))


def f64_factors_needed(table: str, ours, plain32, plain64) -> list[float]:
    """Per row of `table_cot_rows_vs_f64`, the least factor in place of
    F64_PLAIN_FACTOR with which every entry would pass: 0 where
    table_cot_rows' bound alone holds the row, inf where an entry is off
    and the float32 plain version sits on float64 there."""
    a, b, c = (np.asarray(x, np.float64) for x in (ours, plain32, plain64))
    over = np.where(np.isfinite(a), np.abs(a - c), np.inf) - _entry_bounds(c)
    with np.errstate(divide="ignore", invalid="ignore"):
        need = np.where(over > 0, over / np.abs(b - c), 0.0)
    return [float(x) for x in need.max(axis=1)]


def sphere_rows_vs_f64(tables, o, d, g, cfg, ours, ref, **kw):
    """chain_grad's sphere rows against a float64 reference
    (chain_grad_plain on the same tables, rays and g in float64), with g
    zeroed on the rays whose ray cotangents flip: the kernel's against the
    float32 plain version (`ours`, `ref`: chain_grad's and
    chain_grad_plain's outputs on these inputs, held elsewhere under the
    seam budget) and the float32 plain version's against float64 (where
    float32 takes another closest hit). `kw` goes to chain_grad (its map
    width and tape). -> ([kernel, float32 plain, float64] sphere rows as
    float64 arrays, the kernel's flipped rays, the float32 plain version's
    flipped rays against float64), for `table_cot_rows_vs_f64`."""

    def flips(a, b):  # d_o or d_d off by more than 1e-3 of b's largest entry
        return torch.stack([((x.to(y.dtype) - y).abs() > 1e-3 * y.abs().max()).any(1)
                            for x, y in ((a[1], b[1]), (a[2], b[2]))]).any(0)

    wide = dataclasses.replace(tables, **{k: getattr(tables, k).double()
                                          for k in ("sph", "pl", "tri", "mat", "light")})
    o64, d64 = o.double(), d.double()
    seam, seam64 = flips(ours, ref), flips(ref, cg.chain_grad_plain(wide, o64, d64, g.double(), cfg))
    g_off = g.masked_fill((seam | seam64)[:, None], 0.0)
    rows = [out[0][0].double().cpu().numpy() for out in (
        cg.chain_grad(tables, o, d, g_off, cfg, **kw),
        cg.chain_grad_plain(tables, o, d, g_off, cfg),
        cg.chain_grad_plain(wide, o64, d64, g_off.double(), cfg))]
    return rows, seam, seam64
