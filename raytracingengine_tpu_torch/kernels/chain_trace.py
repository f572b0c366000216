"""The opaque Whitted chain: scene tables, plain version and CUDA kernel.

One call traces [R,3] origins and directions to [R,3] HDR radiance. Each
bounce finds the closest hit over the sphere/plane/triangle tables
(linear scan in authoring order, strict < first-wins, as the reference's
Scene.h:218-257), tests binary shadows per light with an any-hit scan,
shades with Blinn-Phong and 1/d^2 lights, returns the sky on a miss and
follows the Schlick reflection chain (opaque: reflectiveness = specular)
to `max_depth`, pruned by `min_weight`.

  * `pack_scene_tables` turns a FlatScene into the [rows, prims] float32
    tables both versions read. Padded slots hold primitives that can never
    hit: sphere r^2 = -1, plane n = 0, triangle e1 = e2 = 0; padded lights
    sit at 1e7 with emission 0. An empty family is one all-zero column.
  * `trace_chain_plain` is the plain PyTorch version, vectorised over rays
    with Python loops over primitives, lights and depth.
  * `chain_trace` is the wrapper: for CPU tensors it calls the plain
    version; for CUDA tensors it launches csrc/chain_trace.cu and counts
    the launch in `chain_trace.launches`.

It replaces raytracingengine_tpu/kernels/chain_trace.py::chain_trace_pallas
(its per-ray body `_trace_tile`, `_closest_hit` with tie_gi=False and
`_any_hit`). The TPU kernel's triangle block culling only skips work and
its reorder is undone by its tie-break, so the authoring-order scan gives
the same result for every triangle count.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import EPS, FlatScene
from raytracingengine_tpu_torch.kernels import _build

#: Miss sentinel for the closest-hit distance.
_INF = 3.0e38


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Float32 tables, one column per primitive (rows as in the JAX
    package's pack_scene_tables):

    sph [4, S]: center xyz, r^2        pl [4, P]: unit normal xyz, p.n
    tri [12, T]: v0, e1, e2, unit normal
    mat [7, N]: albedo rgb, specular, shininess, transparency, ior
    light [7, L]: position xyz, emission rgb, active flag
    """

    sph: torch.Tensor
    pl: torch.Tensor
    tri: torch.Tensor
    mat: torch.Tensor
    light: torch.Tensor
    n_spheres: int
    n_planes: int
    n_triangles: int
    n_lights: int

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_planes + self.n_triangles

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.sph, self.pl, self.tri, self.mat, self.light)


def pack_scene_tables(flat: FlatScene) -> SceneTables:
    """FlatScene -> SceneTables (degenerate values in padded slots)."""
    dt = torch.float32
    dev = flat.sph_centers.device
    empty = lambda rows: torch.zeros((rows, 1), dtype=dt, device=dev)

    def masked(act, v, fill):
        return torch.where(act, v, torch.full_like(v, fill))

    s_act = flat.sph_active
    sph = torch.stack(
        [
            masked(s_act, flat.sph_centers[:, 0], 0.0),
            masked(s_act, flat.sph_centers[:, 1], 0.0),
            masked(s_act, flat.sph_centers[:, 2], 0.0),
            masked(s_act, flat.sph_radii**2, -1.0),  # disc < 0 => miss
        ]
    ).to(dt) if flat.n_spheres else empty(4)

    p_act = flat.pl_active
    pn = vm.dot(flat.pl_points, flat.pl_normals)
    pl = torch.stack(
        [
            masked(p_act, flat.pl_normals[:, 0], 0.0),  # n = 0 => miss
            masked(p_act, flat.pl_normals[:, 1], 0.0),
            masked(p_act, flat.pl_normals[:, 2], 0.0),
            masked(p_act, pn, 0.0),
        ]
    ).to(dt) if flat.n_planes else empty(4)

    t_act = flat.tri_active
    tri = torch.stack(
        [
            masked(t_act, v[:, c], 0.0)  # e1 = e2 = 0 => a = 0 => miss
            for v in (flat.tri_v0, flat.tri_e1, flat.tri_e2, flat.tri_nunit)
            for c in range(3)
        ]
    ).to(dt) if flat.n_triangles else empty(12)

    mat = torch.stack(
        [
            flat.albedo[:, 0], flat.albedo[:, 1], flat.albedo[:, 2],
            flat.specular, flat.shininess, flat.transparency,
            flat.refractive_index,
        ]
    ).to(dt) if flat.n_primitives else empty(7)

    l_act = flat.light_active
    emit = flat.light_colors * flat.light_intensities[:, None]
    far = 1.0e7
    light = torch.stack(
        [
            masked(l_act, flat.light_positions[:, 0], far),
            masked(l_act, flat.light_positions[:, 1], far),
            masked(l_act, flat.light_positions[:, 2], far),
            masked(l_act, emit[:, 0], 0.0),
            masked(l_act, emit[:, 1], 0.0),
            masked(l_act, emit[:, 2], 0.0),
            l_act.to(dt),
        ]
    ).to(dt) if flat.n_lights else empty(7)
    return SceneTables(
        sph=sph, pl=pl, tri=tri, mat=mat, light=light,
        n_spheres=flat.n_spheres, n_planes=flat.n_planes,
        n_triangles=flat.n_triangles, n_lights=flat.n_lights,
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


class _HostTables:
    """The tables as Python floats: one device-to-host copy per trace, so
    the primitive loops read scalars without a sync each. float32 values
    are exact as Python floats and round back exactly in tensor ops."""

    def __init__(self, t: SceneTables):
        self.sph, self.pl, self.tri, self.mat, self.light = (
            x.detach().cpu().tolist() for x in t.tensors()
        )
        self.ns, self.np, self.nt, self.nl = (
            t.n_spheres, t.n_planes, t.n_triangles, t.n_lights,
        )
        self.mat_t = t.mat  # gathered per hit on the ray device


def _sky(dy):
    """Scene.h:30-33 on unit directions."""
    t = 0.5 * (dy + 1.0)
    return (
        1.0 * (1.0 - t) + 0.5 * t,
        1.0 * (1.0 - t) + 0.7 * t,
        1.0 * (1.0 - t) + 1.0 * t,
    )


def _sphere_t(sph, i, a_coef, ox, oy, oz, dx, dy, dz):
    """Sphere quadratic with a = d.d, near root if >= EPS (Shape.h:72-98)."""
    cx, cy, cz, r2 = sph[0][i], sph[1][i], sph[2][i], sph[3][i]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b * b - 4.0 * a_coef * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc.clamp_min(0.0), 0.0))
    inv2a = 0.5 / a_coef
    tt0 = (-b - sq) * inv2a
    tt1 = (-b + sq) * inv2a
    t_new = torch.where(tt0 >= EPS, tt0, tt1)
    return t_new, ok & (t_new >= EPS)


def _plane_t(pl, i, ox, oy, oz, dx, dy, dz):
    """|denom| > EPS and t >= 0 (Shape.h:149-159)."""
    nx_, ny_, nz_, pn = pl[0][i], pl[1][i], pl[2][i], pl[3][i]
    denom = dx * nx_ + dy * ny_ + dz * nz_
    ok = denom.abs() > EPS
    on = ox * nx_ + oy * ny_ + oz * nz_
    t_new = (pn - on) / torch.where(ok, denom, 1.0)
    return t_new, ok & (t_new >= 0.0)


def _tri_t(tri, i, ox, oy, oz, dx, dy, dz):
    """Moller-Trumbore, EPSILON = 1e-6 (Shape.h:202-220)."""
    v0x, v0y, v0z = tri[0][i], tri[1][i], tri[2][i]
    e1x, e1y, e1z = tri[3][i], tri[4][i], tri[5][i]
    e2x, e2y, e2z = tri[6][i], tri[7][i], tri[8][i]
    hx = dy * e2z - dz * e2y  # h = d x e2
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    ok = a.abs() > EPS
    f = 1.0 / torch.where(ok, a, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t_new = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = (
        ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t_new > EPS)
    )
    return t_new, hit


def _closest_scan(T: _HostTables, ox, oy, oz, dx, dy, dz):
    """Linear scan -> (t, nx, ny, nz, gi); t >= _INF means miss, gi is the
    winner's global index (spheres, planes, triangles). Every hit field
    updates under ONE `closer` predicate, so an exact edge hit cannot
    update t without its normal and material."""
    t = torch.full_like(ox, _INF)
    nx, ny, nz = torch.zeros_like(ox), torch.zeros_like(ox), torch.zeros_like(ox)
    gi = torch.zeros(ox.shape, dtype=torch.long, device=ox.device)
    a_coef = dx * dx + dy * dy + dz * dz  # d.d (Shape.h:75)

    def upd(t_new, hit, n3, g):
        nonlocal t, nx, ny, nz, gi
        closer = hit & (t_new < t)
        t = torch.where(closer, t_new, t)
        nx = torch.where(closer, n3[0], nx)
        ny = torch.where(closer, n3[1], ny)
        nz = torch.where(closer, n3[2], nz)
        gi = torch.where(closer, g, gi)

    for i in range(T.ns):
        t_new, hit = _sphere_t(T.sph, i, a_coef, ox, oy, oz, dx, dy, dz)
        gx = ox + dx * t_new - T.sph[0][i]
        gy = oy + dy * t_new - T.sph[1][i]
        gz = oz + dz * t_new - T.sph[2][i]
        inv = torch.rsqrt((gx * gx + gy * gy + gz * gz).clamp_min(1e-24))
        upd(t_new, hit, (gx * inv, gy * inv, gz * inv), i)
    for i in range(T.np):
        t_new, hit = _plane_t(T.pl, i, ox, oy, oz, dx, dy, dz)
        upd(t_new, hit, (T.pl[0][i], T.pl[1][i], T.pl[2][i]), T.ns + i)
    for i in range(T.nt):
        t_new, hit = _tri_t(T.tri, i, ox, oy, oz, dx, dy, dz)
        upd(t_new, hit, (T.tri[9][i], T.tri[10][i], T.tri[11][i]), T.ns + T.np + i)
    return t, nx, ny, nz, gi


def _closest_hit(T: _HostTables, ox, oy, oz, dx, dy, dz):
    """Linear scan -> (t, nx, ny, nz, ar, ag, ab, spec, shin); t >= _INF
    means miss."""
    t, nx, ny, nz, gi = _closest_scan(T, ox, oy, oz, dx, dy, dz)
    m = T.mat_t[:, gi]  # [7, R]; miss lanes read column 0 and are masked
    return t, nx, ny, nz, m[0], m[1], m[2], m[3], m[4]


def _any_hit(T: _HostTables, ox, oy, oz, dx, dy, dz, lo, hi):
    """Binary occlusion: any primitive with lo < t < hi (per lane)."""
    occ = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    a_coef = dx * dx + dy * dy + dz * dz
    scans = (
        (T.ns, lambda i: _sphere_t(T.sph, i, a_coef, ox, oy, oz, dx, dy, dz)),
        (T.np, lambda i: _plane_t(T.pl, i, ox, oy, oz, dx, dy, dz)),
        (T.nt, lambda i: _tri_t(T.tri, i, ox, oy, oz, dx, dy, dz)),
    )
    for n, prim_t in scans:
        for i in range(n):
            t_new, hit = prim_t(i)
            occ = occ | (hit & (t_new > lo) & (t_new < hi))
    return occ


def trace_chain_plain(
    tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg
) -> torch.Tensor:
    """[R,3] origins/directions -> [R,3] HDR radiance, in plain PyTorch.

    A line-by-line mirror of the TPU kernel's `_trace_tile`: dead lanes
    are identity maps, and the depth loop stops once no lane is live."""
    T = _HostTables(tables)
    bias, min_weight = cfg.bias, cfg.min_weight
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    zero = torch.zeros_like(ox)
    weight = torch.ones_like(ox)
    live = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    acc_r, acc_g, acc_b = zero, zero, zero

    for _ in range(cfg.max_depth):
        if not bool(live.any()):
            break
        skr, skg, skb = _sky(dy)
        t, nx, ny, nz, ar, ag, ab, spec, shin = _closest_hit(T, ox, oy, oz, dx, dy, dz)
        hit = t < _INF
        miss = live & ~hit
        acc_r = acc_r + torch.where(miss, weight * skr, 0.0)
        acc_g = acc_g + torch.where(miss, weight * skg, 0.0)
        acc_b = acc_b + torch.where(miss, weight * skb, 0.0)
        shade = live & hit

        # Front-face flip (Scene.h:145-146)
        ndotd = nx * dx + ny * dy + nz * dz
        flip = torch.where(ndotd < 0.0, 1.0, -1.0)
        nx, ny, nz = nx * flip, ny * flip, nz * flip

        t_safe = torch.where(hit, t, 0.0)
        px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe

        # Direct lighting, binary shadows (Scene.h:79-129)
        diff_r, diff_g, diff_b = zero, zero, zero
        spec_r, spec_g, spec_b = zero, zero, zero
        sox, soy, soz = px + nx * bias, py + ny * bias, pz + nz * bias
        spec_on = spec > 0.0
        for li in range(T.nl):
            lx, ly, lz = T.light[0][li], T.light[1][li], T.light[2][li]
            er, eg, eb = T.light[3][li], T.light[4][li], T.light[5][li]
            vx, vy, vz = lx - px, ly - py, lz - pz
            dist2 = vx * vx + vy * vy + vz * vz
            dist = torch.sqrt(dist2.clamp_min(1e-30))
            inv_d = 1.0 / dist
            ldx, ldy, ldz = vx * inv_d, vy * inv_d, vz * inv_d
            ndotl = (nx * ldx + ny * ldy + nz * ldz).clamp_min(0.0)
            ok = shade & (dist > bias) & (ndotl > 0.0)
            if bool(ok.any()):
                occ = _any_hit(
                    T, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias
                )
            else:
                occ = torch.ones_like(ok)
            vis = ok & ~occ
            inv_d2 = inv_d * inv_d
            contrib = inv_d2 * ndotl
            diff_r = diff_r + torch.where(vis, er * contrib, 0.0)
            diff_g = diff_g + torch.where(vis, eg * contrib, 0.0)
            diff_b = diff_b + torch.where(vis, eb * contrib, 0.0)
            # Blinn-Phong (Scene.h:115-123)
            hx_, hy_, hz_ = ldx - dx, ldy - dy, ldz - dz
            h2 = hx_ * hx_ + hy_ * hy_ + hz_ * hz_
            invh = torch.rsqrt(h2.clamp_min(1e-24))
            ndoth = ((nx * hx_ + ny * hy_ + nz * hz_) * invh).clamp_min(0.0)
            s_ok = vis & spec_on & (ndoth > 0.0)
            ndoth_s = torch.where(s_ok, ndoth, 1.0)
            sf = torch.exp(shin * torch.log(ndoth_s)) * inv_d2
            spec_r = spec_r + torch.where(s_ok, er * sf, 0.0)
            spec_g = spec_g + torch.where(s_ok, eg * sf, 0.0)
            spec_b = spec_b + torch.where(s_ok, eb * sf, 0.0)
        local_r = ar * diff_r + spec_r * spec
        local_g = ag * diff_g + spec_g * spec
        local_b = ab * diff_b + spec_b * spec
        acc_r = acc_r + torch.where(shade, weight * local_r, 0.0)
        acc_g = acc_g + torch.where(shade, weight * local_g, 0.0)
        acc_b = acc_b + torch.where(shade, weight * local_b, 0.0)

        # Reflection chain (Scene.h:189-195), pruned by min_weight.
        cont = shade & (spec > bias) & (weight * spec >= min_weight)
        ddn = dx * nx + dy * ny + dz * nz
        rx = dx - 2.0 * ddn * nx
        ry = dy - 2.0 * ddn * ny
        rz = dz - 2.0 * ddn * nz
        invr = torch.rsqrt((rx * rx + ry * ry + rz * rz).clamp_min(1e-24))
        rx, ry, rz = rx * invr, ry * invr, rz * invr
        ox = torch.where(cont, px + rx * bias, ox)
        oy = torch.where(cont, py + ry * bias, oy)
        oz = torch.where(cont, pz + rz * bias, oz)
        dx = torch.where(cont, rx, dx)
        dy = torch.where(cont, ry, dy)
        dz = torch.where(cont, rz, dz)
        weight = torch.where(cont, weight * spec, weight)
        live = cont

    # Depth exhaustion -> sky (Scene.h:132-134)
    skr, skg, skb = _sky(dy)
    acc_r = acc_r + torch.where(live, weight * skr, 0.0)
    acc_g = acc_g + torch.where(live, weight * skg, 0.0)
    acc_b = acc_b + torch.where(live, weight * skb, 0.0)
    return torch.stack([acc_r, acc_g, acc_b], dim=-1)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def check_tables(tables: SceneTables, device: torch.device) -> None:
    """Raise unless every table is a contiguous float32 [rows, >=1] tensor
    on `device` with at least as many columns as its primitive count."""
    rows = (4, 4, 12, 7, 7)
    counts = (
        tables.n_spheres, tables.n_planes, tables.n_triangles,
        tables.n_primitives, tables.n_lights,
    )
    for name, t, r, n in zip(("sph", "pl", "tri", "mat", "light"), tables.tensors(), rows, counts):
        if t.device != device:
            raise ValueError(f"table {name} is on {t.device}, rays on {device}")
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != r:
            raise ValueError(f"table {name}: expected float32 [{r}, n], got {t.dtype} {tuple(t.shape)}")
        if t.shape[1] < max(n, 1) or not t.is_contiguous():
            raise ValueError(f"table {name}: {tuple(t.shape)} for {n} primitives, contiguous={t.is_contiguous()}")


def pallas_applicable(cfg, mode: str) -> bool:
    """Does a trace kernel cover (config, mode)? Chain mode: the chain
    kernels, with binary shadows only (on the opaque scenes chain mode is
    chosen for, the march is binary; a caller forcing chain mode on a
    transparent scene keeps the march on the integrator). Wavefront mode:
    the wavefront kernels (kernels/wavefront_trace.py), with binary or
    march shadows. The JAX package's primitive ceiling is its TPU's SMEM
    size; these kernels read the tables from device memory and have none."""
    if mode == "chain":
        return cfg.shadow_mode == "binary"
    if mode == "wavefront":
        return cfg.shadow_mode in ("binary", "march")
    return False


def check_no_grad(*tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA trace kernels are forward-only: a CUDA input requires "
            "grad; differentiate through kernels.chain_grad.chain_trace_fused "
            "(spp=1), whose backward is the adjoint kernel"
        )


def _check_rays(o: torch.Tensor, d: torch.Tensor) -> None:
    for name, t in (("o", o), ("d", d)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: expected float32 [R, 3], got {t.dtype} {tuple(t.shape)}")
    if o.shape != d.shape or o.device != d.device:
        raise ValueError(f"o {tuple(o.shape)} on {o.device} vs d {tuple(d.shape)} on {d.device}")


def chain_trace(
    tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg
) -> torch.Tensor:
    """[R,3] origins/directions -> [R,3] HDR radiance.

    CPU tensors run `trace_chain_plain`; CUDA tensors launch the CUDA
    kernel (csrc/chain_trace.cu) on the current stream."""
    _check_rays(o, d)
    check_tables(tables, o.device)
    if o.device.type == "cpu":
        return trace_chain_plain(tables, o, d, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"chain_trace: unsupported device {o.device}")
    check_no_grad(o, d, *tables.tensors())
    if not (o.is_contiguous() and d.is_contiguous()):
        raise ValueError("chain_trace: o and d must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(o)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_chain_trace(
            *_build.table_args(tables),
            o.data_ptr(), d.data_ptr(), out.data_ptr(), o.shape[0],
            cfg.max_depth, cfg.bias, cfg.min_weight, stream,
        )
    _build.check(lib, err, "chain_trace")
    chain_trace.launches += 1
    return out


#: Kernel launches since the last reset (the CPU path does not count).
chain_trace.launches = 0
