"""Plain reference of the opaque Whitted chain, written from the upstream
engine's formulas (RaytracingEngine's Shape.h, Scene.h, Math.h), with the
work counts the benchmark's rooflines divide by.

It imports torch and numpy only: nothing of the system under test. It
reads the scene description the benchmark made (`scene_leaves`), builds
its own rays and jitter, and traces them in the dtype it is given
(float32 for the comparison, bfloat16 for the control). Every function is
vectorised over rays, all pairs of rays and primitives at once per family,
in blocks of rays so that it fits.

Semantics (the upstream engine's, as the system under test states them):

* camera ray of pixel (px, py), jitter (jx, jy): screen point
  (px - W/2 + jx, H/2 - py + jy), direction normalize(screen - position)
  with the focal length (pixels) as its z; sample 0 is unjittered and
  sample s >= 1 takes Philox4x32-10 of counter (pixel id, s, 0, 0) and key
  (seed, 0), the first two words as uniform [0, 1) by the mantissa trick;
* closest hit over spheres, planes, triangles in that order, the first
  minimum winning a tie; sphere: the near root if >= 1e-6, else the far
  one, hit if >= 1e-6; plane: |d.n| > 1e-6 and t >= 0; triangle:
  Moller-Trumbore, u in [0, 1], v >= 0, u + v <= 1, t > 1e-6;
* the normal (sphere normalize(p - c); plane n as stored; triangle
  normalize(e1 x e2)) flipped to face the ray unless n.d < 0;
* per light: dist = |L - p|, l = (L - p) / dist, lit where dist > bias and
  n.l > 0 and no primitive lies at bias < t < dist - bias along the shadow
  ray from p + n bias; diffuse E n.l / dist^2, Blinn-Phong
  E max(0, n.h)^shininess / dist^2 with h = normalize(l - d) where the
  material's specular is > 0; local = albedo * diffuse + specular * spec;
* a miss adds the sky lerp(1, (0.5, 0.7, 1), (d_y + 1) / 2); a hit with
  specular > bias whose path weight times specular stays >= min_weight
  reflects from p + r bias with the weight times specular; a chain still
  live after max_depth bounces adds the sky.

Work counted (`Counts`), the least any implementation does on these rays:
every closest-hit test against the real primitives of each live ray; per
lit light (active, emitting, n.l > 0, dist > bias) one shadow ray that
tests every real primitive when unoccluded and one test (of the first
occluder in scan order) when occluded. Each test costs the fixed fp32
operation count of its kind in `OPS`, a fused multiply-add counted as two.
The adjoint's least operations: the pullback (`ADJOINT_FACTOR` times the
forward's operations: the forward recomputed, then its pullback) of each
bounce's winning test, of each hit's combination and reflection
(`HIT_OPS`), and of each lit light's term at each hit it lights
(`SHADE_OPS`). It also needs each bounce's hit state, by the cheaper of
two ways: all the closest-hit and shadow tests again (`trace_ops`), or a
least hit record read back (`record_bytes`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EPS = 1e-6

#: fp32 operations of one test, the least a kernel needs whatever form it
#: computes, every add and multiply counted (an FMA is two): sphere, with a
#: unit d and half of b: oc 3, b = oc.d 5, c = oc.oc - r^2 6, disc 2,
#: sqrt 1, two roots 2 -> 19; plane: d.n 5, o.n 5, (p.n - o.n) / d.n 2 ->
#: 12; triangle (Moller-Trumbore, e1 and e2 stored): h = d x e2 9, a 5,
#: 1/a 1, s 3, u 6, q = s x e1 9, v 6, t 6 -> 45.
OPS = {"sphere": 19, "plane": 12, "triangle": 45}
#: The adjoint's pullback of a term, in multiples of its forward operations.
ADJOINT_FACTOR = 2
#: fp32 operations of a hit, past its test: p = o + t d 6; local = albedo
#: diffuse + specular spec 9, acc += w local 6; r = d - 2 (d.n) n 12 and its
#: normalisation 10 -> 43.
HIT_OPS = 43
#: fp32 operations of one light's term at a hit it lights: "diffuse", with
#: v = L - p 3, |v|^2 5, sqrt 1, 1/dist 1, l 3, n.l 5, 1/dist^2 1, n.l/dist^2
#: 1, E times it 3, the sum 3 -> 26; "specular" (where the material has it
#: and n.h > 0), with h = l - d 3, |h|^2 5, sqrt 1, reciprocal 1, h 3, n.h 5,
#: pow as exp2(shininess log2) 3, /dist^2 1, E times it 3, the sum 3 -> 28.
SHADE_OPS = {"diffuse": 26, "specular": 28}
#: Bytes of a primitive as the scene states it (float32): geometry and the
#: material the chain reads (albedo 3, specular, shininess).
PRIM_FLOATS = {"sphere": 4 + 5, "plane": 6 + 5, "triangle": 9 + 5}
LIGHT_FLOATS = 6
KINDS = ("sphere", "plane", "triangle")

#: Philox4x32 multipliers and Weyl increments (Salmon et al., SC'11).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------


def scene_leaves(desc: dict, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Scene description -> float leaves by dotted path, as a training step
    names them ("spheres.centers", "planes.materials.color", ...). Values
    are formed in float64 on the host (plane normals normalised, mesh
    vertices translated) and then cast, as a scene builder does."""
    f64 = lambda rows, width=3: np.asarray(rows, np.float64).reshape(-1, width)  # noqa: E731
    sph = desc.get("spheres", [])
    pl = desc.get("planes", [])
    tris, tri_mats = [], []
    for m in desc.get("meshes", []):
        v = f64(m["vertices"]) + np.asarray(m.get("translation", (0, 0, 0)), np.float64)
        idx = np.asarray(m["indices"], np.int64).reshape(-1, 3)
        tris.append(v[idx])
        tri_mats += [m["material"]] * len(idx)
    tri = np.concatenate(tris) if tris else np.zeros((0, 3, 3))
    lights = desc.get("lights", [])
    out = {}

    def mats(prefix, ms):
        out[f"{prefix}.materials.color"] = f64([m["color"] for m in ms])
        for k, default in (("shininess", 128.0), ("specular", 0.0), ("transparency", 0.0),
                           ("refractive_index", 1.0)):
            out[f"{prefix}.materials.{k}"] = np.asarray([m.get(k, default) for m in ms],
                                                        np.float64)

    out["spheres.centers"] = f64([s["center"] for s in sph])
    out["spheres.radii"] = np.asarray([s["radius"] for s in sph], np.float64)
    mats("spheres", [s["material"] for s in sph])
    normals = f64([p["normal"] for p in pl])
    if len(normals):
        normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
    out["planes.points"] = f64([p["point"] for p in pl])
    out["planes.normals"] = normals
    mats("planes", [p["material"] for p in pl])
    out["triangles.v0"], out["triangles.v1"], out["triangles.v2"] = (
        np.ascontiguousarray(tri[:, k]) for k in range(3))
    mats("triangles", tri_mats)
    out["lights.positions"] = f64([li["position"] for li in lights])
    out["lights.colors"] = f64([li["color"] for li in lights])
    out["lights.intensities"] = np.asarray([li["intensity"] for li in lights], np.float64)
    return {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in out.items()}


@dataclasses.dataclass
class Prims:
    """The derived per-render tensors (differentiable in the leaves)."""

    sc: torch.Tensor
    sr2: torch.Tensor
    pp: torch.Tensor
    pn: torch.Tensor
    ppn: torch.Tensor
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    tn: torch.Tensor
    albedo: torch.Tensor  # [N,3] in scan order
    spec: torch.Tensor
    shin: torch.Tensor
    lpos: torch.Tensor
    lemit: torch.Tensor
    lit: list[int]  # lights that emit

    @property
    def counts(self) -> tuple[int, int, int]:
        return self.sc.shape[0], self.pp.shape[0], self.v0.shape[0]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                          + v[..., 2:3] * v[..., 2:3])


def prims(leaves: dict[str, torch.Tensor]) -> Prims:
    L = leaves
    e1 = L["triangles.v1"] - L["triangles.v0"]
    e2 = L["triangles.v2"] - L["triangles.v0"]
    cat = lambda k: torch.cat([L[f"{f}.materials.{k}"] for f in ("spheres", "planes", "triangles")])  # noqa: E731
    emit = L["lights.colors"] * L["lights.intensities"][:, None]
    lit = [i for i in range(emit.shape[0]) if bool((emit[i].detach() != 0).any())]
    return Prims(
        sc=L["spheres.centers"], sr2=L["spheres.radii"] ** 2,
        pp=L["planes.points"], pn=L["planes.normals"],
        ppn=_dot(L["planes.points"], L["planes.normals"]),
        v0=L["triangles.v0"], e1=e1, e2=e2, tn=_normalize(_cross(e1, e2)),
        albedo=cat("color"), spec=cat("specular"), shin=cat("shininess"),
        lpos=L["lights.positions"], lemit=emit, lit=lit,
    )


# ---------------------------------------------------------------------------
# Tests, all pairs: rays [R] x primitives [K] -> t [R,K], hit [R,K]
# ---------------------------------------------------------------------------


def _dot(a, b):
    """a.b over the last axis, x + y then + z, each product rounded on its
    own: the order the upstream formulas are written in. A grazing ray's
    sphere test is decided by the rounding of b^2 - ac, so the order is
    part of what the test computes in float32."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def sphere_t(P: Prims, o, d):
    """Shape.h's quadratic: a = d.d, b = 2 oc.d, c = oc.oc - r^2,
    disc = b b - (4 a) c, roots (-b -+ sqrt(disc)) (0.5 / a)."""
    oc = o[:, None, :] - P.sc[None]
    dd = d[:, None, :]
    a = _dot(d, d)[:, None]
    b = 2.0 * _dot(oc, dd)
    c = _dot(oc, oc) - P.sr2[None]
    disc = b * b - (4.0 * a) * c
    ok = disc >= 0
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = torch.where(t0 >= EPS, t0, t1)
    return t, ok & (t >= EPS)


def plane_t(P: Prims, o, d):
    den = _dot(d[:, None, :], P.pn[None])
    ok = den.abs() > EPS
    on = _dot(o[:, None, :], P.pn[None])
    t = (P.ppn[None] - on) / torch.where(ok, den, torch.ones_like(den))
    return t, ok & (t >= 0)


def tri_t(P: Prims, o, d):
    dd = d[:, None, :].expand(-1, P.e2.shape[0], -1)
    h = _cross(dd, P.e2[None].expand_as(dd))
    a = _dot(P.e1[None], h)
    ok = a.abs() > EPS
    f = 1.0 / torch.where(ok, a, torch.ones_like(a))
    s = o[:, None, :] - P.v0[None]
    u = f * _dot(s, h)
    q = _cross(s, P.e1[None].expand_as(s))
    v = f * _dot(dd, q)
    t = f * _dot(P.e2[None], q)
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return t, hit


_TESTS = (sphere_t, plane_t, tri_t)


def _all_t(P: Prims, o, d):
    """-> t [R,N] (+inf where missed) in scan order."""
    ts = []
    for test, n in zip(_TESTS, P.counts):
        if n:
            t, hit = test(P, o, d)
            ts.append(torch.where(hit, t, torch.full_like(t, math.inf)))
    return torch.cat(ts, dim=1)


def _kind_of(j: torch.Tensor, P: Prims) -> torch.Tensor:
    s, p, _ = P.counts
    return (j >= s).long() + (j >= s + p).long()


# ---------------------------------------------------------------------------
# Work counts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Counts:
    """Tests by kind of one trace call (closest-hit and shadow), the
    winning tests by kind, the closest-hit queries (live rays a bounce),
    and the lights' terms at the hits they light (the adjoint's)."""

    closest: list[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])
    shadow: list[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])
    winners: list[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])
    rays: int = 0
    queries: int = 0
    diffuse: int = 0
    specular: int = 0
    lights: int = 0  # lit lights of the scene

    def trace_ops(self) -> int:
        return sum((c + s) * OPS[k] for c, s, k in zip(self.closest, self.shadow, KINDS))

    def adjoint_ops(self) -> int:
        forward = (sum(w * OPS[k] for w, k in zip(self.winners, KINDS))
                   + sum(self.winners) * HIT_OPS + self.diffuse * SHADE_OPS["diffuse"]
                   + self.specular * SHADE_OPS["specular"])
        return ADJOINT_FACTOR * forward

    def record_bytes(self) -> int:
        """A least hit record: the primitive's id (or a miss) of every
        closest-hit query, and t and one bit per lit light (its shadow
        ray's outcome) of every hit; the normal follows from them."""
        return 4 * self.queries + (4 + -(-self.lights // 8)) * sum(self.winners)


def scene_bytes(P: Prims) -> int:
    return 4 * (sum(n * PRIM_FLOATS[k] for n, k in zip(P.counts, KINDS))
                + len(P.lit) * LIGHT_FLOATS)


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


def sky(d: torch.Tensor) -> torch.Tensor:
    t = 0.5 * (_normalize(d)[:, 1] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - t)[:, None] + blue[None] * t[:, None]


def _occluded(P: Prims, o, d, lo: float, hi, counts: Counts | None):
    """Any primitive with lo < t < hi (no gradient), and the counts."""
    with torch.no_grad():
        t = _all_t(P, o, d)
        blk = (t > lo) & (t < hi[:, None])
        occ = blk.any(1)
        if counts is not None:
            n_free = int((~occ).sum())
            for k, n in enumerate(P.counts):
                counts.shadow[k] += n_free * n
            first = _kind_of(blk.float().argmax(1)[occ], P)
            for k in range(3):
                counts.shadow[k] += int((first == k).sum())
    return occ


def trace(P: Prims, o, d, cfg: dict, counts: Counts | None = None) -> torch.Tensor:
    """Rays [R,3] -> HDR [R,3] (differentiable in P's tensors)."""
    bias, min_w, depth = cfg["bias"], cfg["min_weight"], cfg["max_depth"]
    R = o.shape[0]
    acc = torch.zeros((R, 3), dtype=o.dtype, device=o.device)
    idx = torch.arange(R, device=o.device)
    w = torch.ones(R, dtype=o.dtype, device=o.device)
    if counts is not None:
        counts.rays += R
        counts.lights = len(P.lit)
    for _ in range(depth):
        if idx.numel() == 0:
            return acc
        if counts is not None:
            counts.queries += idx.numel()
            for k, n in enumerate(P.counts):
                counts.closest[k] += idx.numel() * n
        t_all = _all_t(P, o, d)
        j = torch.argmin(t_all, dim=1)
        t = t_all.gather(1, j[:, None])[:, 0]
        hit = torch.isfinite(t)
        miss = ~hit
        acc = acc.index_add(0, idx[miss], w[miss, None] * sky(d[miss]))
        idx, o, d, w, j, t = idx[hit], o[hit], d[hit], w[hit], j[hit], t[hit]
        if idx.numel() == 0:
            return acc
        kind = _kind_of(j, P)
        if counts is not None:
            for k in range(3):
                counts.winners[k] += int((kind == k).sum())
        p = o + d * t[:, None]
        s, pn_, _ = P.counts
        n = torch.zeros_like(p)
        if s:
            js = j.clamp(max=s - 1)
            n = torch.where((kind == 0)[:, None], _normalize(p - P.sc[js]), n)
        if pn_:
            jp = (j - s).clamp(0, pn_ - 1)
            n = torch.where((kind == 1)[:, None], P.pn[jp], n)
        if P.counts[2]:
            jt = (j - s - pn_).clamp(min=0)
            n = torch.where((kind == 2)[:, None], P.tn[jt], n)
        n = torch.where((_dot(n, d) < 0)[:, None], n, -n)
        albedo, spec, shin = P.albedo[j], P.spec[j], P.shin[j]
        diff = torch.zeros_like(p)
        spc = torch.zeros_like(p)
        so = p + n * bias
        for li in P.lit:
            vec = P.lpos[li][None] - p
            dist = torch.sqrt(_dot(vec, vec))
            ldir = vec / dist[:, None]
            ndotl = _dot(n, ldir).clamp_min(0)
            ok = (dist > bias) & (ndotl > 0)
            vis = ok.clone()
            if bool(ok.any()):
                vis[ok] = ~_occluded(P, so[ok], ldir[ok], bias, (dist - bias)[ok], counts)
            inv_d2 = 1.0 / (dist * dist)
            e = P.lemit[li][None]
            diff = diff + torch.where(vis[:, None], e * (ndotl * inv_d2)[:, None], 0.0)
            hv = _normalize(ldir - d)
            ndoth = _dot(n, hv).clamp_min(0)
            s_ok = vis & (spec > 0) & (ndoth > 0)
            base = torch.where(s_ok, ndoth, torch.ones_like(ndoth))
            sf = base ** shin * inv_d2
            spc = spc + torch.where(s_ok[:, None], e * sf[:, None], 0.0)
            if counts is not None:
                counts.diffuse += int(vis.sum())
                counts.specular += int(s_ok.sum())
        local = albedo * diff + spc * spec[:, None]
        acc = acc.index_add(0, idx, w[:, None] * local)
        cont = (spec > bias) & (w * spec >= min_w)
        r = _normalize(d - 2.0 * _dot(d, n)[:, None] * n)
        idx, w = idx[cont], (w * spec)[cont]
        o, d = (p + r * bias)[cont], r[cont]
    if idx.numel():
        acc = acc.index_add(0, idx, w[:, None] * sky(d))
    return acc


# ---------------------------------------------------------------------------
# Camera rays and jitter
# ---------------------------------------------------------------------------


def philox_words(seed: int, c0: torch.Tensor, c1: torch.Tensor):
    """Philox4x32-10 on counter (c0, c1, 0, 0), key (seed, 0) -> its first
    two output words (uint32 held in int64)."""
    c0 = c0.to(torch.int64) & _U32
    c1 = c1.to(torch.int64) & _U32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = seed & _U32, 0
    for _ in range(10):
        p0 = c0 * _PHILOX_M[0]
        p1 = c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1


def philox_uniform2(seed: int, pid: torch.Tensor, sample: int) -> torch.Tensor:
    """Jitter [R,2] in [0, 1) of `sample` for pixels `pid`: the words of
    counter (pid, sample) by the mantissa trick (the top 23 bits under
    exponent 0x3F8 give [1, 2), minus 1)."""
    w0, w1 = philox_words(seed, pid, torch.full_like(pid, sample))

    def u01(x):
        return ((x >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0

    return torch.stack([u01(w0), u01(w1)], dim=-1)


def camera_rays(cam: dict, width: int, height: int, pid: torch.Tensor, jitter=None,
                dtype=torch.float32, shift=(0.0, 0.0)):
    """Pixels `pid` (row-major ids) -> (o, d) [R,3]; `jitter` [R,2] or None
    for the centre ray; `shift` moves every screen point by that many
    pixels (the comparison's stability probes)."""
    pos = torch.as_tensor(cam["position"], dtype=dtype, device=pid.device)
    px = (pid % width).to(dtype)
    py = (pid // width).to(dtype)
    sx = px - width / 2.0 + shift[0]
    sy = height / 2.0 - py + shift[1]
    if jitter is not None:
        sx = sx + jitter[:, 0].to(dtype)
        sy = sy + jitter[:, 1].to(dtype)
    v = torch.stack([sx - pos[0], sy - pos[1],
                     torch.full_like(sx, float(cam["focal"]))], dim=-1)
    return pos.expand_as(v), _normalize(v)


def ray_block(P: Prims) -> int:
    """Rays per block: about 2^24 ray-primitive pairs at once."""
    return max(1 << 12, (1 << 24) // max(1, sum(P.counts)))


def render(P: Prims, cam: dict, width: int, height: int, spp: int, seed: int, cfg: dict,
           counts: Counts | None = None, block: int | None = None, shift=(0.0, 0.0),
           pid: torch.Tensor | None = None, dtype=torch.float32) -> torch.Tensor:
    """HDR [R,3] of the pixels `pid` (the whole frame by default): the mean
    of `spp` samples, sample 0 the centre ray."""
    dev = P.albedo.device
    if pid is None:
        pid = torch.arange(width * height, device=dev)
    block = block or ray_block(P)
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


# ---------------------------------------------------------------------------
# Tonemap (the upstream ACES fit and toColor)
# ---------------------------------------------------------------------------


def aces_uint8(hdr: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES (v *= 0.6; (v(2.51v + 0.03)) / (v(2.43v + 0.59) + 0.14),
    clamped) then toColor: clamp01, * 255, truncate."""
    f = lambda x: float(np.float32(x))  # noqa: E731  the engine's float literals
    v = hdr.float() * f(0.6)
    m = (v * (f(2.51) * v + f(0.03))) / (v * (f(2.43) * v + f(0.59)) + f(0.14))
    return (m.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Training: L2 loss, gradients by autograd, Adam
# ---------------------------------------------------------------------------


def loss_and_grads(leaves, target, cam, width, height, spp, seed, cfg, trainable,
                   block: int | None = None, counts: Counts | None = None):
    """mean((render - target)^2) over the frame and its gradient by leaf of
    `trainable` (a set of paths), accumulated over blocks of pixels (the
    loss is a sum over them)."""
    req = {k: v.detach().clone().requires_grad_(k in trainable and v.numel() > 0)
           for k, v in leaves.items()}
    total = 0.0
    n = target.numel()
    dev = target.device
    block = block or max(1, (1 << 20) // spp)  # pixels whose graphs are held at once
    for lo in range(0, width * height, block):
        pid = torch.arange(lo, min(lo + block, width * height), device=dev)
        P = prims(req)
        img = render(P, cam, width, height, spp, seed, cfg, counts, block=block, pid=pid,
                     dtype=target.dtype)
        part = ((img - target.reshape(-1, 3)[lo:lo + pid.numel()]) ** 2).sum() / n
        part.backward()
        total += float(part.detach().double())
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).detach()
             for k, v in req.items() if k in trainable}
    return total, grads


def adam_step(leaves, grads, state, step: int, lr: float, betas=(0.9, 0.999), eps=1e-8):
    """One Adam update (Kingma and Ba, with bias correction) of the leaves
    in `grads` -> new leaves."""
    b1, b2 = betas
    out = dict(leaves)
    for k, g in grads.items():
        p = leaves[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        denom = (v / (1 - b2 ** step)).sqrt() + eps
        out[k] = p - lr * (m / (1 - b1 ** step)) / denom
    return out
