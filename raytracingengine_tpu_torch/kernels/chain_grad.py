"""The chain trace's backward pass: checkpointed adjoints, and the autograd
Function that joins them to the forward kernel.

What one adjoint call computes: given the scene tables, the rays o, d
[R,3] and g = dL/d(rgb) [R,3] of `chain_trace`'s output, the cotangent of
every table tensor (in that tensor's shape, summed over rays) and of each
ray's origin and direction. Per ray:

  1. a state-only forward (closest hit and the reflection update, no
     lighting) saves the ray state (o, d, weight) before each bounce, until
     the ray dies or reaches max_depth;
  2. the VJP of the depth-exhaustion sky term (`final_sky`) seeds the
     state cotangent;
  3. from the last bounce back to the first, the full bounce (closest hit,
     binary shadows, Blinn-Phong, reflection) is re-run from its saved
     state and its VJP taken: the state cotangent moves one bounce back and
     the table cotangents accumulate. (The CUDA kernels save each bounce's
     winner in step 1 and rebuild the hit from it, so their only
     closest-hit scan is the checkpoint's; the head-box kernel's step 1 is
     the forward's own, below.)

Shadow occlusion is a boolean decision, so it carries no cotangent: the
VJP treats it as a constant, which is the exact adjoint of the bounce.

Two adjoints, as the JAX package has (kernels/chain_grad.py):

  * `chain_grad` (<= MAX_PRIMS primitives, tables that are not culled):
    `bounce_plain` differentiates the closest hit over every primitive.
    CPU tensors run `chain_grad_plain`, CUDA tensors csrc/chain_grad.cu,
    which takes its step 1 from the tape of the forward's taping kernel
    (`chain_trace(..., tape=True)`) and runs no closest-hit scan; its
    shadow scans read the tables staged in shared memory or in place, as
    csrc/trace_common.cuh::grad_route decides (counted in
    `chain_grad.routes`). It replaces chain_grad_pallas.
  * `chain_grad_dense` (culled tables, or more than MAX_PRIMS primitives):
    `bounce_dense_plain` finds the closest hit without gradient, with the
    forward's scan (kernels/chain_trace.py), then recomputes (t, n) on the
    winner's gathered columns only (`winner_hit`) and differentiates the
    shading given that hit (`shade_hit`). CPU tensors run
    `chain_grad_dense_plain`, CUDA tensors csrc/chain_grad_dense.cu. It
    replaces chain_grad_pallas_blocked and chain_grad_pallas_streamed.

The plain pieces are written from the JAX package's `_make_bounce`,
`_make_state_bounce`, `_final_sky`, `_make_shade_hit` and `_*_tn_prim`,
with their NaN guards: every reciprocal square root is
`where(ok, rsqrt(where(ok, x, 1)), 0)`. The transparency clip and the
maximum(0, .) keep JAX's subgradient of 0.5 at a tie. A triangle's
distance is found without gradient and differentiated in the plane form
(`_tri_t_plane`), as the kernels' `tri_pullback` does: the gradient of
autodiff of the Moller-Trumbore formula, at the forward's hit point.

`ChainTraceFused` / `chain_trace_fused`: forward `chain_trace` (on the
card, its taping kernel where the backward is `chain_grad`), backward the
adjoint `adjoint_route` picks; autograd carries the table cotangents
back through `pack_forward_tables_perm` (the reorder is an index),
`pack_scene_tables` and `flatten_scene` to the scene leaves, and the ray
cotangents to the camera. `chain_grad_dense` serves any count: its triangle
cotangents live in device memory, and past one block's shared memory
(`dense_sink`) the sphere and plane ones do too.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import EPS
from raytracingengine_tpu_torch.kernels import _build
from raytracingengine_tpu_torch.kernels.chain_trace import (
    _INF,
    ROUTES,
    SceneTables,
    _any_hit,
    _check_rays,
    _closest_scan_pos,
    _HostTables,
    chain_trace,
    check_tables,
    map_ctas,
)
from raytracingengine_tpu_torch.utils.profiling import spanned

#: Primitive ceiling of `chain_grad` (the JAX package's _MAX_PRIMS_UNROLL):
#: its kernel keeps one block's table cotangents in shared memory.
MAX_PRIMS = 512
#: The kernel's block size (csrc/chain_grad.cu) and its shared memory cap.
THREADS = 128
MAX_SMEM_BYTES = 227 * 1024
#: Shared memory of the culled scan's staging (csrc/trace_common.cuh::Stage:
#: two blocks of 13 rows of 128 floats and two sets of four warp votes),
#: beside the dense adjoint's accumulator.
STAGE_BYTES = 2 * 13 * 128 * 4 + 2 * 4 * 8
#: Floats the dense adjoint saves per bounce and ray: o, d, w and the
#: closest hit's t, winner and tri column (csrc/trace_common.cuh kStateRows).
STATE_ROWS = 10


def _rsqrt_where(x: torch.Tensor, floor: float) -> torch.Tensor:
    """rsqrt(x) where x > floor, else 0, with a finite gradient everywhere."""
    ok = x > floor
    return torch.where(ok, torch.rsqrt(torch.where(ok, x, torch.ones_like(x))), torch.zeros_like(x))


def _closest_hit(tables: SceneTables, mat_rows, ox, oy, oz, dx, dy, dz):
    """Linear scan in authoring order, strict < first-wins, every field
    under one `closer` predicate -> (t, nx, ny, nz, *mat[mat_rows, winner]);
    t = _INF on a miss. The sphere normal is normalize(p - c)."""
    sph, pl, tri, mat = tables.sph, tables.pl, tables.tri, tables.mat
    zero, one = torch.zeros_like(ox), torch.ones_like(ox)
    fields = [torch.full_like(ox, _INF)] + [zero] * (3 + len(mat_rows))
    a_coef = dx * dx + dy * dy + dz * dz

    def upd(t_new, hit, n3, gi):
        closer = hit & (t_new < fields[0])
        new = (t_new, *n3, *(mat[r, gi] for r in mat_rows))
        for k, v in enumerate(new):
            fields[k] = torch.where(closer, v, fields[k])

    for i in range(tables.n_spheres):
        cx, cy, cz, r2 = sph[0, i], sph[1, i], sph[2, i], sph[3, i]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = b * b - 4.0 * a_coef * c
        ok = disc >= 0.0
        sq = vm.sqrt_grad_safe(torch.where(ok, torch.maximum(disc, zero), one))
        inv2a = 0.5 / a_coef
        tt0 = (-b - sq) * inv2a
        tt1 = (-b + sq) * inv2a
        t_new = torch.where(tt0 >= EPS, tt0, tt1)
        gx, gy, gz = ox + dx * t_new - cx, oy + dy * t_new - cy, oz + dz * t_new - cz
        inv = _rsqrt_where(gx * gx + gy * gy + gz * gz, 1e-16)
        upd(t_new, ok & (t_new >= EPS), (gx * inv, gy * inv, gz * inv), i)

    for i in range(tables.n_planes):
        nx_, ny_, nz_, pn = pl[0, i], pl[1, i], pl[2, i], pl[3, i]
        denom = dx * nx_ + dy * ny_ + dz * nz_
        ok = denom.abs() > EPS
        on = ox * nx_ + oy * ny_ + oz * nz_
        t_new = (pn - on) / torch.where(ok, denom, one)
        upd(t_new, ok & (t_new >= 0.0), (nx_, ny_, nz_), tables.n_spheres + i)

    base = tables.n_spheres + tables.n_planes
    for i in range(tables.n_triangles):
        with torch.no_grad():
            v0x, v0y, v0z = tri[0, i], tri[1, i], tri[2, i]
            e1x, e1y, e1z = tri[3, i], tri[4, i], tri[5, i]
            e2x, e2y, e2z = tri[6, i], tri[7, i], tri[8, i]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = e1x * hx + e1y * hy + e1z * hz
            ok = a.abs() > EPS
            f = 1.0 / torch.where(ok, a, one)
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            u = f * (sx * hx + sy * hy + sz * hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = f * (dx * qx + dy * qy + dz * qz)
            t0 = f * (e2x * qx + e2y * qy + e2z * qz)
            hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t0 > EPS)
        t_new = _tri_t_plane(torch.where(hit, t0, zero), tri[0:3, i], tri[3:6, i], tri[6:9, i],
                             ox, oy, oz, dx, dy, dz)
        upd(t_new, hit, (tri[9, i], tri[10, i], tri[11, i]), base + i)
    return fields


def _reflect(state, t, nx, ny, nz, spec, shade, cfg):
    """Front-face flip, hit point and the reflection update (Scene.h:145-146,
    189-195) -> (new state, flipped normal, hit point)."""
    ox, oy, oz, dx, dy, dz, w, _ = state
    flip = torch.where(nx * dx + ny * dy + nz * dz < 0.0, 1.0, -1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    t_safe = torch.where(t < _INF, t, torch.zeros_like(t))
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    cont = shade & (spec > cfg.bias) & (w * spec >= cfg.min_weight)
    ddn = dx * nx + dy * ny + dz * nz
    rx = dx - 2.0 * ddn * nx
    ry = dy - 2.0 * ddn * ny
    rz = dz - 2.0 * ddn * nz
    invr = _rsqrt_where(rx * rx + ry * ry + rz * rz, 1e-16)
    rx, ry, rz = rx * invr, ry * invr, rz * invr
    bias = cfg.bias
    new_state = (
        torch.where(cont, px + rx * bias, ox),
        torch.where(cont, py + ry * bias, oy),
        torch.where(cont, pz + rz * bias, oz),
        torch.where(cont, rx, dx),
        torch.where(cont, ry, dy),
        torch.where(cont, rz, dz),
        torch.where(cont, w * spec, w),
        cont.to(w.dtype),
    )
    return new_state, (nx, ny, nz), (px, py, pz)


def state_bounce_plain(state, tables: SceneTables, cfg):
    """The ray-state update of one bounce, without the lighting: the state
    sequence does not depend on radiance, and the lighting (one any-hit scan
    per light and Blinn-Phong) is most of a bounce's cost."""
    ox, oy, oz, dx, dy, dz, _, live_f = state
    t, nx, ny, nz, spec = _closest_hit(tables, (3,), ox, oy, oz, dx, dy, dz)
    shade = (live_f > 0.0) & (t < _INF)
    return _reflect(state, t, nx, ny, nz, spec, shade, cfg)[0]


def final_sky(state):
    """Depth-exhaustion sky term (Scene.h:132-134) -> (cr, cg, cb)."""
    _, _, _, dx, dy, _, w, live_f = state
    live = live_f > 0.0
    t_sky = 0.5 * (dy + 1.0)
    zero = torch.zeros_like(w)
    return (
        torch.where(live, w * (1.0 - 0.5 * t_sky), zero),
        torch.where(live, w * (1.0 - 0.3 * t_sky), zero),
        torch.where(live, w * torch.ones_like(dx), zero),
    )


def shade_hit(state, hitf, tables: SceneTables, cfg, host: _HostTables):
    """One Whitted bounce with binary shadows given its closest hit
    hitf = (t, nx, ny, nz, albedo rgb, specular, shininess, transparency)
    -> (new state, (cr, cg, cb)), differentiable in the state, the hit and
    the light table (`_make_shade_hit`). Dead lanes (live = 0) are identity
    maps with zero radiance. The shadow scans read `host` (no gradient)."""
    ox, oy, oz, dx, dy, dz, w, live_f = state
    bias = cfg.bias
    live = live_f > 0.0
    zero, one = torch.zeros_like(ox), torch.ones_like(ox)

    t_sky = 0.5 * (dy + 1.0)
    sky = (1.0 - 0.5 * t_sky, 1.0 - 0.3 * t_sky, one)
    t, nx, ny, nz, ar, ag, ab, spec, shin, tau_raw = hitf
    tau = vm.clip(tau_raw, 0.0, 1.0)
    hit = t < _INF
    miss = live & ~hit
    shade = live & hit
    new_state, (nx, ny, nz), (px, py, pz) = _reflect(state, t, nx, ny, nz, spec, shade, cfg)

    sox, soy, soz = px + nx * bias, py + ny * bias, pz + nz * bias
    spec_on = spec > 0.0
    diff = [zero, zero, zero]
    spec_acc = [zero, zero, zero]
    light = tables.light
    for li in range(tables.n_lights):
        lx, ly, lz = light[0, li], light[1, li], light[2, li]
        emit = (light[3, li], light[4, li], light[5, li])
        vx, vy, vz = lx - px, ly - py, lz - pz
        dist2 = vx * vx + vy * vy + vz * vz
        d_ok = dist2 > 1e-20
        dist = torch.sqrt(torch.where(d_ok, dist2, one))
        inv_d = torch.where(d_ok, 1.0 / dist, zero)
        ldx, ldy, ldz = vx * inv_d, vy * inv_d, vz * inv_d
        ndotl = torch.maximum(zero, nx * ldx + ny * ldy + nz * ldz)
        ok = shade & (dist > bias) & (ndotl > 0.0)
        if not bool(ok.any()):
            continue
        with torch.no_grad():  # boolean: no cotangent
            occ = _any_hit(host, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias, ok)
        vis = ok & ~occ
        inv_d2 = inv_d * inv_d
        contrib = inv_d2 * ndotl
        hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
        invh = _rsqrt_where(hx * hx + hy * hy + hz * hz, 1e-16)
        ndoth = torch.maximum(zero, (nx * hx + ny * hy + nz * hz) * invh)
        s_ok = vis & spec_on & (ndoth > 0.0)
        sf = torch.exp(shin * torch.log(torch.where(s_ok, ndoth, one))) * inv_d2
        for c in range(3):
            diff[c] = diff[c] + torch.where(vis, emit[c] * contrib, zero)
            spec_acc[c] = spec_acc[c] + torch.where(s_ok, emit[c] * sf, zero)

    one_m_tau = 1.0 - tau
    albedo = (ar, ag, ab)
    rgb = tuple(
        torch.where(miss, w * sky[c], zero)
        + torch.where(shade, w * one_m_tau * (albedo[c] * diff[c] + spec_acc[c] * spec), zero)
        for c in range(3)
    )
    return new_state, rgb


def bounce_plain(state, tables: SceneTables, cfg, host: _HostTables | None = None):
    """One Whitted bounce with binary shadows: (state, tables) -> (new
    state, (cr, cg, cb)), differentiable in the state and the tables, the
    closest hit over every primitive included. `host` holds the tables as
    Python floats for the shadow scans (made here if omitted)."""
    host = _HostTables(tables) if host is None else host
    hitf = _closest_hit(tables, (0, 1, 2, 3, 4, 5), *state[:6])
    return shade_hit(state, hitf, tables, cfg, host)


# ---------------------------------------------------------------------------
# The dense adjoint's bounce: the hit found without gradient, (t, n)
# recomputed on the winner's columns
# ---------------------------------------------------------------------------


def _sphere_tn(c, ox, oy, oz, dx, dy, dz):
    """(t, n) of the sphere columns c [4, R] (`_sphere_tn_prim`)."""
    cx, cy, cz, r2 = c
    zero, one = torch.zeros_like(ox), torch.ones_like(ox)
    a_coef = dx * dx + dy * dy + dz * dz
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b * b - 4.0 * a_coef * cc
    ok = disc >= 0.0
    sq = vm.sqrt_grad_safe(torch.where(ok, torch.maximum(disc, zero), one))
    inv2a = 0.5 / a_coef
    tt0 = (-b - sq) * inv2a
    tt1 = (-b + sq) * inv2a
    t = torch.where(tt0 >= EPS, tt0, tt1)
    gx, gy, gz = ox + dx * t - cx, oy + dy * t - cy, oz + dz * t - cz
    inv = _rsqrt_where(gx * gx + gy * gy + gz * gz, 1e-16)
    return t, (gx * inv, gy * inv, gz * inv)


def _plane_tn(c, ox, oy, oz, dx, dy, dz):
    """(t, n) of the plane columns c [4, R] (`_plane_tn_prim`)."""
    nx_, ny_, nz_, pn = c
    denom = dx * nx_ + dy * ny_ + dz * nz_
    ok = denom.abs() > EPS
    on = ox * nx_ + oy * ny_ + oz * nz_
    return (pn - on) / torch.where(ok, denom, torch.ones_like(denom)), (nx_, ny_, nz_)


def _tri_t_plane(t0, v0, e1, e2, ox, oy, oz, dx, dy, dz):
    """A triangle's distance t0 (found without gradient; 0 where it is
    not hit) with the gradient of the plane through v0 with normal
    N = e1 x e2 met at p = o + d t:

        dt = f [N . (ds + t dd) + dN . (p - v0)],  s = o - v0,

    f = 1 / (e1 . (d x e2)), the guarded Moller-Trumbore factor. The
    expanded gradient of t = f (e2 . (s x e1)) is the same in exact
    arithmetic, but it finds p - v0 as a difference of two terms ~|s| /
    |p - v0| times larger, through its own f and that product; on a grazing
    ray both are cancellations, so each implementation's rounding of them
    (FMA contraction in the kernels, none here) moves the e1 and e2 rows by
    percents. Here p - v0 = s + t d takes the forward's t, which the kernels
    and the plain versions share. csrc/adjoint_common.cuh::tri_pullback
    computes this form."""
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z) = v0, e1, e2
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    with torch.no_grad():
        hx = dy * e2z - dz * e2y
        hy = dz * e2x - dx * e2z
        hz = dx * e2y - dy * e2x
        a = e1x * hx + e1y * hy + e1z * hz
        f = 1.0 / torch.where(a.abs() > EPS, a, torch.ones_like(a))
        wx, wy, wz = sx + dx * t0, sy + dy * t0, sz + dz * t0  # p - v0
        n0x, n0y, n0z = nx.detach(), ny.detach(), nz.detach()
    lin = f * (nx * wx + ny * wy + nz * wz
               + n0x * (sx + dx * t0) + n0y * (sy + dy * t0) + n0z * (sz + dz * t0))
    return t0 + (lin - lin.detach())


def _tri_tn(c, t0, ox, oy, oz, dx, dy, dz):
    """(t, n) of the triangle columns c [>= 12, R] (`_tri_tn_prim`) hit at
    the scan's t0: `_tri_t_plane` and the stored unit normal."""
    t = _tri_t_plane(t0, c[0:3], c[3:6], c[6:9], ox, oy, oz, dx, dy, dz)
    return t, (c[9], c[10], c[11])


def winner_hit(tables: SceneTables, mat_rows, hit, t, gi, pos, ox, oy, oz, dx, dy, dz):
    """The hit fields (t, nx, ny, nz, *mat[mat_rows, gi]) of each lane's
    winner at the scan's distance t, differentiable in the rays and the
    tables: the winner's table columns are gathered (global index gi, tri
    table column pos) and its (t, n) recomputed on them alone (a
    triangle's t keeps the scan's value); t = _INF where `hit` is false.
    Each family's formula runs on every lane with a clamped index, and its
    guards keep the adjoints of the lanes it does not win finite."""
    ns, np_ = tables.n_spheres, tables.n_planes
    t_tri = torch.where(hit & (gi >= ns + np_), t, torch.zeros_like(t))
    t = torch.full_like(ox, _INF)
    n = [torch.zeros_like(ox)] * 3
    rays = (ox, oy, oz, dx, dy, dz)
    families = (
        (ns, hit & (gi < ns), lambda: _sphere_tn(tables.sph[:, gi.clamp(0, ns - 1)], *rays)),
        (np_, hit & (gi >= ns) & (gi < ns + np_),
         lambda: _plane_tn(tables.pl[:, (gi - ns).clamp(0, np_ - 1)], *rays)),
        (tables.n_triangles, hit & (gi >= ns + np_),
         lambda: _tri_tn(tables.tri[:, pos], t_tri, *rays)),
    )
    for count, mine, tn in families:
        if count:
            tf, nf = tn()
            t = torch.where(mine, tf, t)
            n = [torch.where(mine, a, b) for a, b in zip(nf, n)]
    return (t, *n, *(tables.mat[r, gi] for r in mat_rows))


def _scan(host: _HostTables, state):
    """The forward's closest-hit scan of the live lanes, without gradient."""
    with torch.no_grad():
        return _closest_scan_pos(host, *(x.detach() for x in state[:6]), state[7] > 0.0)


def state_bounce_dense(state, host: _HostTables, cfg):
    """`state_bounce_plain` with the forward's scan (culled tables scanned
    block by block)."""
    t, nx, ny, nz, gi, _ = _scan(host, state)
    shade = (state[7] > 0.0) & (t < _INF)
    return _reflect(state, t, nx, ny, nz, host.mat_t[3, gi], shade, cfg)[0]


def bounce_dense_plain(state, tables: SceneTables, cfg, host: _HostTables):
    """`bounce_plain` as the dense adjoint splits it: the closest hit of the
    forward's scan, then `winner_hit` and `shade_hit` under autograd."""
    t, _, _, _, gi, pos = _scan(host, state)
    hitf = winner_hit(tables, (0, 1, 2, 3, 4, 5), t < _INF, t, gi, pos, *state[:6])
    return shade_hit(state, hitf, tables, cfg, host)


def _grads_or_zeros(outputs, grad_outputs, inputs):
    """torch.autograd.grad over the outputs that depend on the inputs; an
    input that no output reaches gets zeros."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    grads = torch.autograd.grad(
        [o for o, _ in pairs], inputs, [g for _, g in pairs], allow_unused=True
    ) if pairs else (None,) * len(inputs)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


def _adjoint_plain(tables: SceneTables, o, d, gbar, cfg, state_bounce, bounce):
    """Steps 1-3 of the module docstring in plain PyTorch -> (table
    cotangents, d_o [R,3], d_d [R,3]), with `torch.autograd.grad` of
    `bounce(state, tables, cfg, host)` re-run from each saved state."""
    o, d, gbar = o.detach(), d.detach(), gbar.detach()
    leaves = [t.detach().requires_grad_(True) for t in tables.tensors()]
    T = dataclasses.replace(
        tables, sph=leaves[0], pl=leaves[1], tri=leaves[2], mat=leaves[3], light=leaves[4]
    )
    host = _HostTables(T)
    one = torch.ones_like(o[:, 0])
    state = (*o.unbind(-1), *d.unbind(-1), one, one)
    saved = []
    with torch.no_grad():
        for _ in range(cfg.max_depth):
            if not bool((state[7] > 0.0).any()):  # live
                break
            saved.append(state)
            state = state_bounce(state, T, host, cfg)
    g = list(gbar.unbind(-1))
    with torch.enable_grad():
        st = [x.clone().requires_grad_(True) for x in state[:7]]
        cot = _grads_or_zeros(final_sky((*st, state[7])), g, st)
        table_cot = [torch.zeros_like(t) for t in leaves]
        for s in reversed(saved):
            st = [x.clone().requires_grad_(True) for x in s[:7]]
            new, rgb = bounce((*st, s[7]), T, cfg, host)
            grads = _grads_or_zeros([*new[:7], *rgb], [*cot, *g], st + leaves)
            cot = grads[:7]
            table_cot = [a + b for a, b in zip(table_cot, grads[7:])]
    return tuple(table_cot), torch.stack(cot[0:3], -1), torch.stack(cot[3:6], -1)


def chain_grad_plain(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
                     gbar: torch.Tensor, cfg):
    """The adjoint in plain PyTorch -> (table cotangents, d_o [R,3], d_d [R,3]).

    The same structure as the kernel: a state-only forward saving each
    bounce's state, the sky term's VJP, then per depth, from the last,
    `torch.autograd.grad` of `bounce_plain` re-run from the saved state."""
    return _adjoint_plain(tables, o, d, gbar, cfg,
                          lambda st, T, host, cfg: state_bounce_plain(st, T, cfg), bounce_plain)


def chain_grad_dense_plain(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
                           gbar: torch.Tensor, cfg):
    """The dense adjoint in plain PyTorch -> (table cotangents in the
    tables' shapes, d_o [R,3], d_d [R,3]); culled tables or not. The
    structure of `chain_grad_plain`, with `state_bounce_dense` and
    `bounce_dense_plain`: every hit decision is the forward's scan, and
    autograd sees only the winner's columns."""
    return _adjoint_plain(tables, o, d, gbar, cfg,
                          lambda st, T, host, cfg: state_bounce_dense(st, host, cfg),
                          bounce_dense_plain)


# ---------------------------------------------------------------------------
# Kernel wrappers and routing
# ---------------------------------------------------------------------------


def adjoint_route(tables: SceneTables) -> str:
    """The backward of `chain_trace_fused` for these tables:
    "chain_grad_dense" for culled tables or more than MAX_PRIMS primitives;
    else "chain_grad"."""
    if tables.culled or tables.n_primitives > MAX_PRIMS:
        return "chain_grad_dense"
    return "chain_grad"


def _check_scope(tables: SceneTables) -> None:
    if adjoint_route(tables) != "chain_grad":
        raise NotImplementedError(
            f"chain_grad covers tables that are not culled and at most {MAX_PRIMS} "
            f"primitives ({tables.n_primitives} here); use chain_grad_dense"
        )


def check_gbar(gbar: torch.Tensor, o: torch.Tensor) -> None:
    if gbar.shape != o.shape or gbar.dtype != torch.float32 or gbar.device != o.device:
        raise ValueError(f"gbar: expected float32 {tuple(o.shape)} on {o.device}, "
                         f"got {gbar.dtype} {tuple(gbar.shape)} on {gbar.device}")


def table_entries(tables: SceneTables, name: str) -> int:
    """Floats of the table cotangents, one per table entry. The adjoint
    kernels keep them all in one block's shared memory; raise if they do
    not fit."""
    total = sum(t.numel() for t in tables.tensors())
    if 4 * total > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"{name}: {4 * total} bytes of table cotangents exceed one "
            f"block's {MAX_SMEM_BYTES} bytes of shared memory"
        )
    return total


def split_table_cots(flat: torch.Tensor, shapes) -> tuple[torch.Tensor, ...]:
    """The kernels' flat cotangent buffer (tables in order, row-major) ->
    one view per table of `shapes` (tensors or sizes), in that shape."""
    cots, start = [], 0
    for shape in shapes:
        shape = tuple(shape.shape) if torch.is_tensor(shape) else tuple(shape)
        n = math.prod(shape)
        cots.append(flat[start:start + n].view(shape))
        start += n
    return tuple(cots)


def check_width(width: int) -> None:
    if not isinstance(width, int) or width < 0:
        raise ValueError(f"width: expected an int >= 0 (0 for the identity map), got {width!r}")


@spanned("rte.launch.chain_grad")
def chain_grad(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
               gbar: torch.Tensor, cfg, width: int = 0, tape: torch.Tensor | None = None):
    """Adjoint of `chain_trace` -> (table cotangents in the tables' shapes,
    d_o [R,3], d_d [R,3]).

    CPU tensors run `chain_grad_plain`, which checkpoints itself (`tape`
    None). CUDA tensors launch the CUDA adjoint (csrc/chain_grad.cu) and its
    fixed-order reduction of the per-block table cotangents, on the current
    stream: `tape` is the one `chain_trace(tables, o, d, cfg, tape=True)`
    wrote at this cfg, whose bounces the adjoint differentiates; the route
    of its shadow scans is counted in `chain_grad.routes`. `width` is the
    image width of the ray block's rows, for the kernel's 32x4 pixel-tile
    CTAs (kernels/chain_trace.py::thread_rays), or 0 for the identity map;
    it changes no result."""
    _check_rays(o, d)
    check_width(width)
    check_gbar(gbar, o)
    _check_scope(tables)
    check_tables(tables, o.device)
    if o.device.type == "cpu":
        if tape is not None:
            raise ValueError("chain_grad: the tape is the CUDA kernels'; the plain "
                             "adjoint checkpoints itself")
        return chain_grad_plain(tables, o, d, gbar, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"chain_grad: unsupported device {o.device}")
    if not all(t.is_contiguous() for t in (o, d, gbar)):
        raise ValueError("chain_grad: o, d and gbar must be contiguous")
    total = table_entries(tables, "chain_grad")
    r = o.shape[0]
    lib = _build.load_library()
    n_tape = lib.rte_chain_tape_floats(cfg.max_depth, r)
    if (tape is None or tape.dtype != torch.float32 or tape.device != o.device
            or tape.shape != (n_tape,) or not tape.is_contiguous()):
        raise ValueError(
            "chain_grad: expected the tape of chain_trace(tables, o, d, cfg, tape=True), "
            f"float32 [{n_tape}] on {o.device}, got "
            + ("None" if tape is None else f"{tape.dtype} {tuple(tape.shape)} on {tape.device}")
        )
    if r == 0:
        return tuple(torch.zeros_like(t) for t in tables.tensors()), o.clone(), d.clone()
    flat = torch.empty(total, dtype=torch.float32, device=o.device)
    go, gd = torch.empty_like(o), torch.empty_like(d)
    n_blocks = map_ctas(r, width)
    partials = torch.empty((total, n_blocks), dtype=torch.float32, device=o.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_chain_grad(
            *_build.table_args(tables), tape.data_ptr(), gbar.data_ptr(), go.data_ptr(),
            gd.data_ptr(), r, width, partials.data_ptr(), total, n_blocks, ctypes.byref(route),
            cfg.max_depth, cfg.bias, cfg.min_weight, stream,
        )
        _build.check(lib, err, "chain_grad")
        err = lib.rte_chain_grad_reduce(partials.data_ptr(), total, n_blocks,
                                        flat.data_ptr(), stream)
        _build.check(lib, err, "chain_grad reduce")
    chain_grad.launches += 1
    chain_grad.routes[ROUTES[route.value]] += 1
    return split_table_cots(flat, tables.tensors()), go, gd


#: Kernel launches since the last reset (the CPU path does not count), in
#: all and per route of the shadow scans (kernels/chain_trace.py::ROUTES:
#: "staged" or "in_place").
chain_grad.launches = 0
chain_grad.routes = dict.fromkeys(ROUTES, 0)


def small_table_shapes(tables: SceneTables) -> tuple[tuple[int, int], ...]:
    """Shapes of the dense adjoint's shared-memory accumulator on its shared
    sink: sph, pl, the material columns of spheres and planes, light."""
    nsp = tables.n_spheres + tables.n_planes
    return ((4, tables.sph.shape[1]), (4, tables.pl.shape[1]), (7, nsp), (7, tables.light.shape[1]))


#: chain_grad_dense's sinks for the sphere, plane, light and sphere/plane
#: material cotangents, in csrc/chain_grad_dense.cu's order (its `Sink`).
DENSE_SINKS = ("shared", "global")


def dense_sink(tables: SceneTables) -> str:
    """Where chain_grad_dense sums the sphere, plane, light and sphere/plane
    material cotangents, the one place that decides it, by bytes: "shared"
    (one block's shared-memory accumulator, `small_table_shapes`, summed
    through per-block partials) where they fit one block's shared memory
    beside the culled scan's STAGE_BYTES of staging, for culled tables;
    else "global": the lights alone in shared memory and the rest in
    device memory by atomics, as the triangles' cotangents always are.
    Monotone in every count: one more primitive or light never moves a
    scene from "global" back to "shared". With one light and no culling
    5,281 spheres and planes fit and 5,282 do not."""
    total = sum(r * c for r, c in small_table_shapes(tables))
    room = MAX_SMEM_BYTES - (STAGE_BYTES if tables.culled else 0)
    return "shared" if 4 * total <= room else "global"


@spanned("rte.launch.chain_grad_dense")
def chain_grad_dense(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
                     gbar: torch.Tensor, cfg, sink: str | None = None):
    """The dense adjoint of `chain_trace` -> (table cotangents in the
    tables' shapes, d_o [R,3], d_d [R,3]), for culled tables or not, with
    no ceiling on any count but the lights' shared accumulator (7 floats a
    light slot).

    CPU tensors run `chain_grad_dense_plain`; CUDA tensors launch
    csrc/chain_grad_dense.cu on `sink`, or where it is None on the sink
    `dense_sink` picks, counted in `chain_grad_dense.routes` (a "shared"
    accumulator that does not fit raises): on "shared" the sphere, plane
    and light cotangents go through per-block partials and the fixed-order
    reduction; on "global" only the lights' do, and the sphere and plane
    rows and every material column go to device memory with atomics. The
    triangle rows and the triangles' material columns go straight to
    device memory with atomics on both."""
    _check_rays(o, d)
    check_gbar(gbar, o)
    check_tables(tables, o.device, culled_ok=True)
    if o.device.type == "cpu":
        return chain_grad_dense_plain(tables, o, d, gbar, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"chain_grad_dense: unsupported device {o.device}")
    if not all(t.is_contiguous() for t in (o, d, gbar)):
        raise ValueError("chain_grad_dense: o, d and gbar must be contiguous")
    r = o.shape[0]
    if r == 0:
        return tuple(torch.zeros_like(t) for t in tables.tensors()), o.clone(), d.clone()
    lib = _build.load_library()
    sink = dense_sink(tables) if sink is None else sink
    if sink not in DENSE_SINKS:
        raise ValueError(f"chain_grad_dense: unknown sink {sink!r}")
    shapes = small_table_shapes(tables)
    if sink == "global":  # the lights alone; the sphere and plane rows in device memory
        shapes, gsp = shapes[-1:], torch.zeros(4 * (tables.sph.shape[1] + tables.pl.shape[1]),
                                               dtype=torch.float32, device=o.device)
    total = sum(a * b for a, b in shapes)
    small = torch.empty(total, dtype=torch.float32, device=o.device)
    gtri, gmat = torch.zeros_like(tables.tri), torch.zeros_like(tables.mat)
    go, gd = torch.empty_like(o), torch.empty_like(d)
    n_blocks = max(1, math.ceil(r / THREADS))
    states = torch.empty((max(cfg.max_depth, 1), STATE_ROWS, r), dtype=torch.float32, device=o.device)
    partials = torch.empty((total, n_blocks), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_chain_grad_dense(
            *_build.table_args(tables), *_build.culling_args(tables), o.data_ptr(),
            d.data_ptr(), gbar.data_ptr(), go.data_ptr(), gd.data_ptr(), r,
            states.data_ptr(), partials.data_ptr(), total, gtri.data_ptr(), gmat.data_ptr(),
            gsp.data_ptr() if sink == "global" else None, DENSE_SINKS.index(sink),
            cfg.max_depth, cfg.bias, cfg.min_weight, stream,
        )
        _build.check(lib, err, "chain_grad_dense")
        err = lib.rte_chain_grad_reduce(partials.data_ptr(), total, n_blocks,
                                        small.data_ptr(), stream)
        _build.check(lib, err, "chain_grad_dense reduce")
    chain_grad_dense.launches += 1
    chain_grad_dense.routes[sink] += 1
    if sink == "global":
        gsph, gpl = split_table_cots(gsp, (tables.sph, tables.pl))
        return (gsph, gpl, gtri, gmat, small.view(tables.light.shape)), go, gd
    gsph, gpl, gmat_sp, glight = split_table_cots(small, shapes)
    gmat[:, :gmat_sp.shape[1]] = gmat_sp  # the kernel adds only triangle columns there
    return (gsph, gpl, gtri, gmat, glight), go, gd


#: Kernel launches since the last reset (the CPU path does not count), in
#: all and per sink (DENSE_SINKS).
chain_grad_dense.launches = 0
chain_grad_dense.routes = dict.fromkeys(DENSE_SINKS, 0)


class ChainTraceFused(torch.autograd.Function):
    """Forward `chain_trace`, backward `chain_grad` or `chain_grad_dense`
    (by `adjoint_route`), on the tables' five tensors and the rays. The
    culling tables ride along as values. The forward runs on detached
    tensors, so the forward-only wrappers keep refusing inputs that require
    grad. On the card, where the backward is `chain_grad`, the forward is
    chain_trace's taping kernel, and its tape is saved for the backward
    (csrc/trace_common.cuh::ChainTape: 40 bytes per ray and depth, and 16):
    held from the forward to the backward, freed after it unless the graph
    is retained, as every saved tensor is."""

    @staticmethod
    @spanned("rte.autograd")
    def forward(ctx, counts, culling, cfg, width, o, d, sph, pl, tri, mat, light):
        ctx.counts, ctx.culling, ctx.cfg, ctx.width = counts, culling, cfg, width
        tables = SceneTables(sph.detach(), pl.detach(), tri.detach(), mat.detach(),
                             light.detach(), *counts, *culling)
        rays = (o.detach().contiguous(), d.detach().contiguous())
        tape = None
        if o.device.type == "cuda" and adjoint_route(tables) == "chain_grad":
            img, tape = chain_trace(tables, *rays, cfg, tape=True)
        else:
            img = chain_trace(tables, *rays, cfg)
        ctx.save_for_backward(tape, o, d, sph, pl, tri, mat, light)
        return img

    @staticmethod
    @spanned("rte.autograd")
    def backward(ctx, g):
        tape, o, d, *tabs = ctx.saved_tensors
        tables = SceneTables(*(t.detach() for t in tabs), *ctx.counts, *ctx.culling)
        rays = (o.detach().contiguous(), d.detach().contiguous(), g.contiguous())
        if adjoint_route(tables) == "chain_grad":
            table_cots, go, gd = chain_grad(tables, *rays, ctx.cfg, ctx.width, tape=tape)
        else:
            table_cots, go, gd = chain_grad_dense(tables, *rays, ctx.cfg)
        return (None, None, None, None, go, gd, *table_cots)


def chain_trace_fused(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg,
                      width: int = 0) -> torch.Tensor:
    """[R,3] origins/directions -> [R,3] HDR radiance, differentiable in the
    rays and the table tensors (so, through the packing and flatten_scene,
    in every float scene leaf and the camera). `width` is the image width of
    the rays' rows, or 0: the head-box adjoint `chain_grad` takes it
    (its pixel-tile CTAs); the other kernels ignore it.

    Without gradients it is `chain_trace`. With them the backward is the
    adjoint `adjoint_route` picks, at any primitive count."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (o, d, *tables.tensors())
    )
    if not needs_grad:
        return chain_trace(tables, o.contiguous(), d.contiguous(), cfg)
    counts = (tables.n_spheres, tables.n_planes, tables.n_triangles, tables.n_lights)
    return ChainTraceFused.apply(counts, (tables.taabb, tables.perm), cfg, width, o, d,
                                 *tables.tensors())
