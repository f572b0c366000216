"""Plain reference of the upstream engine's full Whitted recursion: the
refraction, Fresnel and total internal reflection of `Scene::TraceRay`
(Scene.h:131-198) and the transmittance march of `computeTransmittance`
(Scene.h:35-77), with the work counts the glass rooflines divide by.

It imports torch and numpy, and its sibling `whitted` (rtbench.reference.
whitted) for what the two references share: the scene's leaves, the primitive tests, the sky,
camera rays, Philox jitter and ACES. Nothing of the system under test.

Semantics (the upstream engine's, SURVEY.md rows 13-16):

* closest hit over spheres, planes, triangles in that order, the first
  minimum winning a tie (whitted's tests); the normal (sphere
  normalize(p - c), plane n, triangle normalize(e1 x e2)) is flipped to
  face the ray unless n.d < 0, and the ray is then "outside";
* Schlick Fresnel F = F0 + (1 - F0)(1 - cos)^5, cos = max(0, n.(-d)),
  F0 = ((eta_t - eta_i) / (eta_t + eta_i))^2 with the material's index
  and the outside's 1 (symmetric, so the same inside and out);
* tau = clamp(transparency, 0, 1); the local light is weighted 1 - tau;
  where tau > 0 the refraction ray (Snell with eta = 1/ior outside, ior
  inside; a refracted vector of length <= bias is total internal
  reflection) starts at p + r bias 1e2 with the weight tau (1 - F), and on
  TIR F := 1; the reflection ray starts at p + r bias with the weight F
  where tau > 0, else the material's specular, and is traced where that
  weight is > bias;
* local light, per light: dist = |L - p|, l = (L - p) / dist, lit where
  dist > bias and n.l > 0; the shadow ray leaves p + n bias towards the
  light over dist - bias and its transmittance T comes from the march;
  where T > bias, diffuse E n.l T / dist^2 and, only where tau <= 0 and
  specular > 0, Blinn-Phong E max(0, n.h)^shininess T / dist^2 with
  h = normalize(l - d); local = albedo diffuse + specular spec;
* the march (`transmittance`): from the shadow origin, up to 64 steps of
  a closest hit along l; no hit ends it; a hit at t <= 0 steps by bias, at
  0 < t <= bias steps past it (t + bias) unattenuated, at or beyond the
  light ends it; otherwise T *= clamp(transparency, 0, 1) and the march
  steps t + bias past the surface. It ends when T <= 1e-4 or the distance
  travelled reaches the light's;
* a miss adds the sky lerp(1, (0.5, 0.7, 1), (d_y + 1) / 2) times the
  node's weight; a node deeper than max_depth adds the sky untraced.

Departures from upstream, each a setting of the benchmark or an order:

* the tree is traced breadth first, every node of a depth in one wave,
  with no stack limit: the same nodes as upstream's depth-first
  recursion, summed in another order (float32 rounding apart, the same
  sum);
* a child whose path weight falls below `min_weight` (the configuration's
  `program.min_weight`) is not traced: upstream traces every child;
* the closest hit culls by boxes before it tests triangles: the mesh's
  triangles are split (median cuts along the longest axis) into clusters
  of `CLUSTER` whose boxes, widened by PAD, every segment is tested
  against first; a triangle whose cluster's box the ray misses cannot be
  hit, so the hits are the all-pairs hits (`whitted._all_t`), the first
  minimum by scan order included. It only makes the 1080p frame fit the
  card's time.

Work counted (`Counts`), a lower bound for any scan that culls triangles
by axis-aligned boxes, and the same whatever implements it: a traced
segment is a tree node's ray up to its closest hit (unbounded on a miss),
and each march step's ray up to the next surface or the light; each
segment tests every sphere and plane, and every triangle whose own
axis-aligned box meets the segment. Every box that encloses such a
triangle meets the segment too, so no box-culled scan can skip those
tests; boxes' own tests are not counted.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import whitted as W
from .whitted import (  # noqa: F401  (the judge's interface)
    EPS,
    KINDS,
    OPS,
    _cross,
    _dot,
    _normalize,
    aces_uint8,
    camera_rays,
    philox_uniform2,
    scene_leaves,
    sky,
)

#: The march's limits (Scene.h:39, :42).
SHADOW_STEPS = 64
SHADOW_MIN_T = 1e-4
#: The refraction ray's offset, in multiples of bias (Scene.h:175-187).
REFRACT_OFFSET = 1e2
#: Triangles per culling cluster, and the relative widening of a cluster's
#: box (times 1 + its largest |coordinate|; in a coarser dtype 8 of its
#: epsilons) that keeps the culling conservative: a test that rounds a hit
#: onto a triangle's edge is within this of the triangle.
CLUSTER = 64
PAD = 1e-3
#: Camera rays per block (their trees' waves fit the card at once), rays
#: per closest-hit pass, and (ray, cluster) pairs per triangle pass.
BLOCK = 1 << 18
RAY_CHUNK = 1 << 18
PAIR_CHUNK = 1 << 16
#: Bytes of a primitive as the scene states it (float32): geometry and the
#: material the glass trace reads (albedo 3, specular, shininess,
#: transparency, refractive index).
PRIM_FLOATS = {"sphere": 4 + 7, "plane": 6 + 7, "triangle": 9 + 7}


@dataclasses.dataclass
class Prims:
    """whitted's tensors, the materials' transparency and index in scan
    order, and the triangles by culling cluster: [C, CLUSTER] of vertex and
    edges (zero past a cluster's end, which no test hits), the triangle's
    index (-1 past the end), its own box and the cluster's widened box
    (float32)."""

    base: W.Prims
    tau: torch.Tensor
    ior: torch.Tensor
    cv0: torch.Tensor
    ce1: torch.Tensor
    ce2: torch.Tensor
    cid: torch.Tensor
    tlo: torch.Tensor
    thi: torch.Tensor
    clo: torch.Tensor
    chi: torch.Tensor

    @property
    def counts(self) -> tuple[int, int, int]:
        return self.base.counts


def _clusters(centroids: np.ndarray) -> list[np.ndarray]:
    """Median cuts along the longest axis of the centroids' extent, at a
    multiple of CLUSTER, down to clusters of at most CLUSTER triangles."""
    out = []

    def split(ids):
        if len(ids) <= CLUSTER:
            out.append(ids)
            return
        pts = centroids[ids]
        axis = int(np.argmax(pts.max(0) - pts.min(0)))
        order = ids[np.argsort(pts[:, axis], kind="stable")]
        k = -(-len(ids) // (2 * CLUSTER)) * CLUSTER
        split(order[:k])
        split(order[k:])

    if len(centroids):
        split(np.arange(len(centroids)))
    return out


def prims(leaves: dict[str, torch.Tensor]) -> Prims:
    base = W.prims(leaves)
    L = leaves
    cat = lambda k: torch.cat([L[f"{f}.materials.{k}"] for f in ("spheres", "planes", "triangles")])  # noqa: E731
    v0, v1, v2 = L["triangles.v0"], L["triangles.v1"], L["triangles.v2"]
    dev, dt = v0.device, v0.dtype
    tri = torch.stack([v0, v1, v2], 1).detach().float()  # [T,3,3]
    groups = _clusters(tri.mean(1).double().cpu().numpy())
    C = max(1, len(groups))
    cid = torch.full((C, CLUSTER), -1, dtype=torch.long)
    for c, ids in enumerate(groups):
        cid[c, :len(ids)] = torch.as_tensor(ids)
    cid = cid.to(dev)
    real = cid >= 0
    take = cid.clamp_min(0)

    def gather(x, fill):
        return torch.where(real[..., None], x[take] if x.shape[0] else
                           torch.zeros((C, CLUSTER, 3), dtype=x.dtype, device=dev),
                           torch.full((), fill, dtype=x.dtype, device=dev))

    tlo = gather(tri.amin(1), math.inf)
    thi = gather(tri.amax(1), -math.inf)
    big = torch.where(real[..., None], torch.maximum(tlo.abs(), thi.abs()), 0.0).amax((1, 2))
    pad = (max(PAD, 8 * torch.finfo(dt).eps) * (1.0 + big))[:, None]
    clo = torch.where(real[..., None], tlo, math.inf).amin(1) - pad
    chi = torch.where(real[..., None], thi, -math.inf).amax(1) + pad
    return Prims(base=base, tau=cat("transparency"), ior=cat("refractive_index"),
                 cv0=gather(base.v0, 0.0), ce1=gather(base.e1, 0.0),
                 ce2=gather(base.e2, 0.0), cid=cid, tlo=tlo, thi=thi, clo=clo, chi=chi)


def scene_bytes(P: Prims) -> int:
    return 4 * (sum(n * PRIM_FLOATS[k] for n, k in zip(P.counts, KINDS))
                + len(P.base.lit) * W.LIGHT_FLOATS)


# ---------------------------------------------------------------------------
# Work counts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Counts:
    """Tests by kind (sphere, plane, triangle) on the tree's segments
    (`closest`) and the march's (`shadow`), the tree's traced nodes
    (`queries`), the march's steps (`steps`), and the camera rays (`rays`)."""

    closest: list[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])
    shadow: list[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])
    rays: int = 0
    queries: int = 0
    steps: int = 0

    def trace_ops(self) -> int:
        return sum((c + s) * OPS[k] for c, s, k in zip(self.closest, self.shadow, KINDS))


# ---------------------------------------------------------------------------
# Closest hit
# ---------------------------------------------------------------------------


def _slab(o, inv, lo, hi):
    """Ray-box slab test (float32) -> (entry t, exit t); an axis the ray
    runs along inside its slab (0 times inf) bounds nothing."""
    a = (lo - o) * inv
    b = (hi - o) * inv
    near = torch.nan_to_num(torch.fmin(a, b), nan=-math.inf).amax(-1)
    far = torch.nan_to_num(torch.fmax(a, b), nan=math.inf).amin(-1)
    return near, far


def _tri_pairs(P: Prims, o, d):
    """The (ray, cluster) pairs whose widened box the ray meets ahead."""
    near, far = _slab(o.float()[:, None], 1.0 / d.float()[:, None], P.clo[None], P.chi[None])
    return ((near <= far) & (far >= 0)).nonzero(as_tuple=True)


def _tri_closest(P: Prims, o, d, ri, ci):
    """-> (t [R] float32, +inf where no triangle is hit; the lowest index
    among the triangles at that t)."""
    R, n_tri = o.shape[0], P.counts[2]
    t_best = torch.full((R,), math.inf, device=o.device)
    j_best = torch.full((R,), n_tri, dtype=torch.long, device=o.device)
    if ri.numel() == 0:
        return t_best, j_best
    t_pair, j_pair = [], []
    for lo in range(0, ri.numel(), PAIR_CHUNK):
        r, c = ri[lo:lo + PAIR_CHUNK], ci[lo:lo + PAIR_CHUNK]
        oo, dd = o[r][:, None, :], d[r][:, None, :].expand(-1, CLUSTER, -1)
        e1, e2 = P.ce1[c], P.ce2[c]
        # whitted.tri_t's Moller-Trumbore, operation for operation
        h = _cross(dd, e2)
        a = _dot(e1, h)
        ok = a.abs() > EPS
        f = 1.0 / torch.where(ok, a, torch.ones_like(a))
        s = oo - P.cv0[c]
        u = f * _dot(s, h)
        q = _cross(s, e1)
        v = f * _dot(dd, q)
        t = f * _dot(e2, q)
        hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
        t = torch.where(hit, t, torch.full_like(t, math.inf)).float()
        tmin = t.amin(1)
        t_pair.append(tmin)
        j_pair.append(torch.where(t == tmin[:, None], P.cid[c], n_tri).amin(1))
    t_pair, j_pair = torch.cat(t_pair), torch.cat(j_pair)
    t_best.scatter_reduce_(0, ri, t_pair, "amin")
    win = torch.isfinite(t_pair) & (t_pair == t_best[ri])
    j_best.scatter_reduce_(0, ri[win], j_pair[win], "amin")
    return t_best, j_best


def _tri_boxes_met(P: Prims, o, d, ri, ci, t_end) -> int:
    """Triangles whose own box meets their pair's ray over [0, t_end]."""
    n = 0
    for lo in range(0, ri.numel(), PAIR_CHUNK):
        r, c = ri[lo:lo + PAIR_CHUNK], ci[lo:lo + PAIR_CHUNK]
        near, far = _slab(o[r].float()[:, None], 1.0 / d[r].float()[:, None], P.tlo[c], P.thi[c])
        met = (P.cid[c] >= 0) & (near <= far) & (far >= 0) & (near <= t_end[r][:, None])
        n += int(met.sum())
    return n


def closest(P: Prims, o, d, counts: list[int] | None = None, seg_max=None):
    """Rays [R,3] -> (t [R], +inf on a miss; j [R], the hit's index in scan
    order). `counts` ([sphere, plane, triangle]) gains the segments' tests,
    each segment ending at its hit or, where shorter, at `seg_max` [R]."""
    R = o.shape[0]
    S, Pn, T = P.counts
    t_out = torch.full((R,), math.inf, dtype=o.dtype, device=o.device)
    j_out = torch.zeros((R,), dtype=torch.long, device=o.device)
    for lo in range(0, R, RAY_CHUNK):
        oc, dc = o[lo:lo + RAY_CHUNK], d[lo:lo + RAY_CHUNK]
        cols = []
        for test, n in ((W.sphere_t, S), (W.plane_t, Pn)):
            if n:
                t, hit = test(P.base, oc, dc)
                cols.append(torch.where(hit, t, torch.full_like(t, math.inf)))
        if T:
            ri, ci = _tri_pairs(P, oc, dc)
            t_tri, j_tri = _tri_closest(P, oc, dc, ri, ci)
            cols.append(t_tri.to(o.dtype)[:, None])
        t_all = torch.cat(cols, 1)
        k = torch.argmin(t_all, 1)
        t = t_all.gather(1, k[:, None])[:, 0]
        j = k if not T else torch.where(k == S + Pn, S + Pn + j_tri.clamp_max(T - 1), k)
        t_out[lo:lo + RAY_CHUNK], j_out[lo:lo + RAY_CHUNK] = t, j
        if counts is not None:
            r = oc.shape[0]
            counts[0] += r * S
            counts[1] += r * Pn
            if T:
                t_end = t.float()
                if seg_max is not None:
                    t_end = torch.minimum(t_end, seg_max[lo:lo + RAY_CHUNK].float())
                counts[2] += _tri_boxes_met(P, oc, dc, ri, ci, t_end)
    return t_out, j_out


# ---------------------------------------------------------------------------
# The march and the local light
# ---------------------------------------------------------------------------


def transmittance(P: Prims, o, d, max_dist, active, cfg, counts: Counts | None = None):
    """computeTransmittance for shadow rays [B,3] over `max_dist` [B] ->
    T [B] in [0, 1] (1 where not `active`)."""
    bias = cfg["bias"]
    o = o.clone()
    T = torch.ones_like(max_dist)
    traveled = torch.zeros_like(max_dist)
    live = active & (max_dist > 0)
    for _ in range(SHADOW_STEPS):
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        if counts is not None:
            counts.steps += idx.numel()
        t, j = closest(P, o[idx], d[idx], None if counts is None else counts.shadow,
                       seg_max=(max_dist - traveled)[idx].clamp_min(0))
        valid = torch.isfinite(t)
        t = torch.where(valid, t, torch.zeros_like(t))
        tr, Ti = traveled[idx], T[idx]
        c_zero = valid & (t <= 0)
        c_near = valid & (t > 0) & (t <= bias)
        c_beyond = valid & (t > bias) & (tr + t >= max_dist[idx])
        c_pass = valid & (t > bias) & (tr + t < max_dist[idx])
        step = torch.where(c_zero, torch.full_like(t, bias),
                           torch.where(c_near | c_pass, t + bias, torch.zeros_like(t)))
        Ti = torch.where(c_pass, Ti * P.tau[j].clamp(0.0, 1.0), Ti)
        o[idx] = o[idx] + d[idx] * step[:, None]
        tr = tr + step
        traveled[idx], T[idx] = tr, Ti
        live[idx] = valid & ~c_beyond & (Ti > SHADOW_MIN_T) & (tr < max_dist[idx])
    return T.clamp(0.0, 1.0)


def local_light(P: Prims, p, n, d, j, tau, cfg, counts: Counts | None = None):
    """directLightning at hits p [H,3] with the ray-facing normals n, the
    incoming directions d and the primitives j -> [H,3]."""
    bias = cfg["bias"]
    B = P.base
    spec_mat, shin = B.spec[j], B.shin[j]
    spec_on = (tau <= 0) & (spec_mat > 0)
    diff = torch.zeros_like(p)
    spc = torch.zeros_like(p)
    so = p + n * bias
    for li in B.lit:
        vec = B.lpos[li][None] - p
        dist = torch.sqrt(_dot(vec, vec))
        ldir = vec / dist[:, None]
        ndotl = _dot(n, ldir).clamp_min(0)
        ok = (dist > bias) & (ndotl > 0)
        T = transmittance(P, so, ldir, dist - bias, ok, cfg, counts)
        vis = ok & (T > bias)
        inv_d2 = 1.0 / (dist * dist)
        e = B.lemit[li][None]
        diff = diff + torch.where(vis[:, None], e * (ndotl * inv_d2 * T)[:, None], 0.0)
        ndoth = _dot(n, _normalize(ldir - d)).clamp_min(0)
        s_ok = vis & spec_on & (ndoth > 0)
        base = torch.where(s_ok, ndoth, torch.ones_like(ndoth))
        spc = spc + torch.where(s_ok[:, None], e * (base ** shin * inv_d2 * T)[:, None], 0.0)
    return B.albedo[j] * diff + spc * spec_mat[:, None]


def _refract(d, n, eta):
    """Snell (Math.h): d and n unit, n facing d, eta = eta_i / eta_t; the
    zero vector on total internal reflection."""
    cosi = _dot(d, n).clamp(-1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    out = d * eta[:, None] - n * (eta * cosi + torch.sqrt(k.clamp_min(0)))[:, None]
    return torch.where((k < 0)[:, None], torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# The tree
# ---------------------------------------------------------------------------


def trace(P: Prims, o, d, cfg: dict, counts: Counts | None = None) -> torch.Tensor:
    """Rays [R,3] -> HDR [R,3]: each ray's tree, breadth first."""
    bias, min_w, depth_max = cfg["bias"], cfg["min_weight"], cfg["max_depth"]
    B = P.base
    S, Pn, _ = P.counts
    R = o.shape[0]
    acc = torch.zeros((R, 3), dtype=o.dtype, device=o.device)
    pix = torch.arange(R, device=o.device)
    w = torch.ones(R, dtype=o.dtype, device=o.device)
    if counts is not None:
        counts.rays += R
    for depth in range(depth_max + 1):
        if pix.numel() == 0:
            break
        if depth == depth_max:  # past max_depth: the sky, untraced
            acc.index_add_(0, pix, w[:, None] * sky(d))
            break
        if counts is not None:
            counts.queries += pix.numel()
        t, j = closest(P, o, d, None if counts is None else counts.closest)
        hit = torch.isfinite(t)
        miss = ~hit
        acc.index_add_(0, pix[miss], w[miss, None] * sky(d[miss]))
        pix, o, d, w, j, t = pix[hit], o[hit], d[hit], w[hit], j[hit], t[hit]
        if pix.numel() == 0:
            break
        kind = W._kind_of(j, B)
        p = o + d * t[:, None]
        n = torch.zeros_like(p)
        if S:
            n = torch.where((kind == 0)[:, None], _normalize(p - B.sc[j.clamp(max=S - 1)]), n)
        if Pn:
            n = torch.where((kind == 1)[:, None], B.pn[(j - S).clamp(0, Pn - 1)], n)
        if P.counts[2]:
            n = torch.where((kind == 2)[:, None], B.tn[(j - S - Pn).clamp(min=0)], n)
        front = _dot(n, d) < 0
        n = torch.where(front[:, None], n, -n)
        tau = P.tau[j].clamp(0.0, 1.0)
        ior = P.ior[j]
        local = local_light(P, p, n, d, j, tau, cfg, counts)
        acc.index_add_(0, pix, w[:, None] * (local * (1.0 - tau)[:, None]))
        cos = _dot(n, -d).clamp_min(0)
        f0 = ((ior - 1.0) / (ior + 1.0)) ** 2
        fres = f0 + (1.0 - f0) * (1.0 - cos) ** 5
        refr = _refract(d, n, torch.where(front, 1.0 / ior, ior))
        refr_len = torch.sqrt(_dot(refr, refr))
        glass = tau > 0
        tir = glass & (refr_len <= bias)
        w_refr = w * tau * (1.0 - fres)
        go_refr = glass & ~tir & (w_refr >= min_w)
        refl_w = torch.where(glass, torch.where(tir, torch.ones_like(fres), fres), B.spec[j])
        w_refl = w * refl_w
        go_refl = (refl_w > bias) & (w_refl >= min_w)
        r_dir = _normalize(refr)
        l_dir = _normalize(d - n * (2.0 * _dot(d, n))[:, None])
        o = torch.cat([(p + r_dir * (bias * REFRACT_OFFSET))[go_refr], (p + l_dir * bias)[go_refl]])
        d = torch.cat([r_dir[go_refr], l_dir[go_refl]])
        w = torch.cat([w_refr[go_refr], w_refl[go_refl]])
        pix = torch.cat([pix[go_refr], pix[go_refl]])
    return acc


def render(P: Prims, cam: dict, width: int, height: int, spp: int, seed: int, cfg: dict,
           counts: Counts | None = None, block: int | None = None, shift=(0.0, 0.0),
           pid: torch.Tensor | None = None, dtype=torch.float32) -> torch.Tensor:
    """HDR [R,3] of the pixels `pid` (the whole frame by default): the mean
    of `spp` samples, sample 0 the centre ray (whitted's camera)."""
    dev = P.base.albedo.device
    if pid is None:
        pid = torch.arange(width * height, device=dev)
    block = block or BLOCK
    out = []
    for lo in range(0, pid.numel(), block):
        b = pid[lo:lo + block]
        acc = None
        for s in range(spp):
            jit = None if s == 0 else philox_uniform2(seed, b, s)
            o, d = camera_rays(cam, width, height, b, jit, dtype, shift)
            c = trace(P, o, d, cfg, counts)
            acc = c if acc is None else acc + c
        out.append(acc / spp)
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=dtype, device=dev)
