"""The chain trace's backward pass: a checkpointed adjoint, and the
autograd Function that joins it to the forward kernel.

What one adjoint call computes: given the scene tables, the rays o, d
[R,3] and g = dL/d(rgb) [R,3] of `chain_trace`'s output, the cotangent of
every table tensor (in that tensor's shape, summed over rays) and of each
ray's origin and direction. Per ray:

  1. a state-only forward (`state_bounce_plain`: closest hit and the
     reflection update, no lighting) saves the ray state (o, d, weight)
     before each bounce, until the ray dies or reaches max_depth;
  2. the VJP of the depth-exhaustion sky term (`final_sky`) seeds the
     state cotangent;
  3. from the last bounce back to the first, the full bounce
     (`bounce_plain`: closest hit, binary shadows, Blinn-Phong, reflection)
     is re-run from its saved state and its VJP taken: the state cotangent
     moves one bounce back and the table cotangents accumulate.

Shadow occlusion is a boolean decision, so it carries no cotangent: the
VJP treats it as a constant, which is the exact adjoint of the bounce.

  * `bounce_plain`, `state_bounce_plain` and `final_sky` are plain
    PyTorch with the tables as tensors, written from the JAX package's
    kernels/chain_grad.py (`_make_bounce`, `_make_state_bounce`,
    `_final_sky`) with its NaN guards: every reciprocal square root is
    `where(ok, rsqrt(where(ok, x, 1)), 0)`. The transparency clip and the
    maximum(0, .) keep JAX's subgradient of 0.5 at a tie.
  * `chain_grad_plain` runs steps 1-3 with `torch.autograd.grad` of
    `bounce_plain` for each depth.
  * `chain_grad` is the wrapper: CPU tensors run `chain_grad_plain`, CUDA
    tensors launch csrc/chain_grad.cu (the hand-derived adjoint) and count
    the launch in `chain_grad.launches`.
  * `ChainTraceFused` / `chain_trace_fused`: forward `chain_trace`,
    backward `chain_grad`; autograd carries the table cotangents back
    through `pack_scene_tables` and `flatten_scene` to the scene leaves,
    and the ray cotangents to the camera.

It replaces raytracingengine_tpu/kernels/chain_grad.py::chain_grad_pallas
and the custom_vjp `chain_trace_fused` (at most 512 primitives; the
blocked and streamed adjoints for larger scenes are not ported yet).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import EPS
from raytracingengine_tpu_torch.kernels import _build
from raytracingengine_tpu_torch.kernels.chain_trace import (
    _INF,
    SceneTables,
    _any_hit,
    _check_rays,
    _HostTables,
    chain_trace,
    check_tables,
)

#: Primitive ceiling of the adjoint (the JAX package's _MAX_PRIMS_UNROLL):
#: the kernel keeps one block's table cotangents in shared memory.
MAX_PRIMS = 512
#: The kernel's block size (csrc/chain_grad.cu) and its shared memory cap.
THREADS = 128
MAX_SMEM_BYTES = 227 * 1024


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
        t_new = f * (e2x * qx + e2y * qy + e2z * qz)
        hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t_new > EPS)
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


def bounce_plain(state, tables: SceneTables, cfg, host: _HostTables | None = None):
    """One Whitted bounce with binary shadows: (state, tables) -> (new
    state, (cr, cg, cb)), differentiable in the state and the tables. Dead
    lanes (live = 0) are identity maps with zero radiance. `host` holds the
    tables as Python floats for the shadow scans (made here if omitted)."""
    ox, oy, oz, dx, dy, dz, w, live_f = state
    bias = cfg.bias
    live = live_f > 0.0
    zero, one = torch.zeros_like(ox), torch.ones_like(ox)
    host = _HostTables(tables) if host is None else host

    t_sky = 0.5 * (dy + 1.0)
    sky = (1.0 - 0.5 * t_sky, 1.0 - 0.3 * t_sky, one)
    t, nx, ny, nz, ar, ag, ab, spec, shin, tau_raw = _closest_hit(
        tables, (0, 1, 2, 3, 4, 5), ox, oy, oz, dx, dy, dz
    )
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
            occ = _any_hit(host, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias)
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


def _grads_or_zeros(outputs, grad_outputs, inputs):
    """torch.autograd.grad over the outputs that depend on the inputs; an
    input that no output reaches gets zeros."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    grads = torch.autograd.grad(
        [o for o, _ in pairs], inputs, [g for _, g in pairs], allow_unused=True
    ) if pairs else (None,) * len(inputs)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


def chain_grad_plain(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
                     gbar: torch.Tensor, cfg):
    """The adjoint in plain PyTorch -> (table cotangents, d_o [R,3], d_d [R,3]).

    The same structure as the kernel: a state-only forward saving each
    bounce's state, the sky term's VJP, then per depth, from the last,
    `torch.autograd.grad` of `bounce_plain` re-run from the saved state."""
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
            state = state_bounce_plain(state, T, cfg)
    g = list(gbar.unbind(-1))
    with torch.enable_grad():
        st = [x.clone().requires_grad_(True) for x in state[:7]]
        cot = _grads_or_zeros(final_sky((*st, state[7])), g, st)
        table_cot = [torch.zeros_like(t) for t in leaves]
        for s in reversed(saved):
            st = [x.clone().requires_grad_(True) for x in s[:7]]
            new, rgb = bounce_plain((*st, s[7]), T, cfg, host)
            grads = _grads_or_zeros([*new[:7], *rgb], [*cot, *g], st + leaves)
            cot = grads[:7]
            table_cot = [a + b for a, b in zip(table_cot, grads[7:])]
    return tuple(table_cot), torch.stack(cot[0:3], -1), torch.stack(cot[3:6], -1)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check_scope(tables: SceneTables) -> None:
    if tables.n_primitives > MAX_PRIMS:
        raise NotImplementedError(
            f"not ported yet: the adjoint for {tables.n_primitives} > {MAX_PRIMS} "
            "primitives (chain_grad_pallas_blocked, ROADMAP queue 2 item 7)"
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


def split_table_cots(flat: torch.Tensor, tables: SceneTables) -> tuple[torch.Tensor, ...]:
    """The kernels' flat cotangent buffer (tables in order, row-major) ->
    one view per table, in its shape."""
    cots, start = [], 0
    for t in tables.tensors():
        cots.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return tuple(cots)


def chain_grad(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
               gbar: torch.Tensor, cfg):
    """Adjoint of `chain_trace` -> (table cotangents in the tables' shapes,
    d_o [R,3], d_d [R,3]).

    CPU tensors run `chain_grad_plain`; CUDA tensors launch the CUDA adjoint
    (csrc/chain_grad.cu) and its fixed-order reduction of the per-block
    table cotangents, on the current stream."""
    _check_rays(o, d)
    check_gbar(gbar, o)
    check_tables(tables, o.device)
    _check_scope(tables)
    if o.device.type == "cpu":
        return chain_grad_plain(tables, o, d, gbar, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"chain_grad: unsupported device {o.device}")
    if not all(t.is_contiguous() for t in (o, d, gbar)):
        raise ValueError("chain_grad: o, d and gbar must be contiguous")
    total = table_entries(tables, "chain_grad")
    r = o.shape[0]
    if r == 0:
        return tuple(torch.zeros_like(t) for t in tables.tensors()), o.clone(), d.clone()
    lib = _build.load_library()
    flat = torch.empty(total, dtype=torch.float32, device=o.device)
    go, gd = torch.empty_like(o), torch.empty_like(d)
    n_blocks = max(1, math.ceil(r / THREADS))
    # Saved ray state, [depth][7][ray]: each thread writes and reads its own
    # column, neighbouring threads on neighbouring addresses.
    states = torch.empty((max(cfg.max_depth, 1), 7, r), dtype=torch.float32, device=o.device)
    partials = torch.empty((total, n_blocks), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_chain_grad(
            *_build.table_args(tables), o.data_ptr(), d.data_ptr(), gbar.data_ptr(),
            go.data_ptr(), gd.data_ptr(), r, states.data_ptr(), partials.data_ptr(),
            total, cfg.max_depth, cfg.bias, cfg.min_weight, stream,
        )
        _build.check(lib, err, "chain_grad")
        err = lib.rte_chain_grad_reduce(partials.data_ptr(), total, n_blocks,
                                        flat.data_ptr(), stream)
        _build.check(lib, err, "chain_grad reduce")
    chain_grad.launches += 1
    return split_table_cots(flat, tables), go, gd


#: Kernel launches since the last reset (the CPU path does not count).
chain_grad.launches = 0


class ChainTraceFused(torch.autograd.Function):
    """Forward `chain_trace`, backward `chain_grad`, on the tables' five
    tensors and the rays. The forward runs on detached tensors, so the
    forward-only wrappers keep refusing inputs that require grad."""

    @staticmethod
    def forward(ctx, counts, cfg, o, d, sph, pl, tri, mat, light):
        ctx.counts, ctx.cfg = counts, cfg
        ctx.save_for_backward(o, d, sph, pl, tri, mat, light)
        tables = SceneTables(sph.detach(), pl.detach(), tri.detach(), mat.detach(),
                             light.detach(), *counts)
        return chain_trace(tables, o.detach().contiguous(), d.detach().contiguous(), cfg)

    @staticmethod
    def backward(ctx, g):
        o, d, *tabs = ctx.saved_tensors
        tables = SceneTables(*(t.detach() for t in tabs), *ctx.counts)
        table_cots, go, gd = chain_grad(
            tables, o.detach().contiguous(), d.detach().contiguous(), g.contiguous(), ctx.cfg
        )
        return (None, None, go, gd, *table_cots)


def chain_trace_fused(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg) -> torch.Tensor:
    """[R,3] origins/directions -> [R,3] HDR radiance, differentiable in the
    rays and the table tensors (so, through pack_scene_tables and
    flatten_scene, in every float scene leaf and the camera).

    Without gradients it is `chain_trace`. With them the backward is the
    adjoint for at most MAX_PRIMS primitives; a larger scene raises."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (o, d, *tables.tensors())
    )
    if not needs_grad:
        return chain_trace(tables, o.contiguous(), d.contiguous(), cfg)
    _check_scope(tables)
    counts = (tables.n_spheres, tables.n_planes, tables.n_triangles, tables.n_lights)
    return ChainTraceFused.apply(counts, cfg, o, d, *tables.tensors())
