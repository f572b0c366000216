"""The wavefront (glass) trace's backward pass: a taped-DFS adjoint, and the
autograd Function that joins it to the forward kernel.

What one adjoint call computes: given the scene tables, the rays o, d
[R,3] and g = dL/d(rgb) [R,3] of `wavefront_trace`'s output, the cotangent
of every table tensor (in that tensor's shape, summed over rays) and of
each ray's origin and direction. Radiance is a sum over the nodes of each
ray's recursion tree (Scene.h:131-198), so per ray:

  1. a replay of the DFS without lighting (`replay`, the forward's
     closest hit and child construction) tapes each popped node (o, d,
     weight, depth) and which children it pushed;
  2. the tape is swept from the last pop back. The reverse of a stack
     execution is itself one: a cotangent stack that mirrors the ray stack
     hands each node the state cotangents of the children it pushed
     (refraction on top, it was pushed last). Each node's shading and child
     construction (`pop_shade`) is re-run and its VJP taken with those and
     g; the node pushes its own state cotangent. Nodes never popped (the
     budget) start as zero cotangents. The primary ray's ends in slot 0;
  3. each light's shadow transmittance T enters `pop_shade` as an input.
     T = clip(prod_i clip(tau_i, 0, 1)) over the crossed surfaces, and all
     else about it is piecewise constant, so wherever cot_T != 0 the march
     is replayed (`march_tau_row`) and each crossing adds cot_T * T /
     tau_i to that surface's transparency, times the clips' subgradients.

  * `node_children_rgb` and `pop_shade` are plain PyTorch with the tables
    as tensors, written from the JAX package's kernels/wavefront_grad.py
    (`_node_children_rgb`, `_make_pop_shade`) with its NaN guards: every
    square root and reciprocal square root is taken on `where`-guarded
    operands. Clips and maxima keep JAX's subgradient of 0.5 at a tie.
    The closest hit is kernels/chain_grad.py::_closest_hit with every
    material row.
  * `wavefront_grad_plain` runs steps 1-3 on [R] lanes in lockstep, with
    `torch.autograd.grad` of `pop_shade` per reverse iteration.
  * `wavefront_grad` is the wrapper: CPU tensors run `wavefront_grad_plain`,
    CUDA tensors launch csrc/wavefront_grad.cu (the hand-derived adjoint)
    and count the launch in `wavefront_grad.launches`. On the card its
    tape is sized by the forward's counting kernel (`wavefront_trace(...,
    count=True)`: per warp of 32 rays, the most nodes one of its rays
    popped), each warp's stretch placed by `tape_slots`; the kernel lays
    the nodes out within it (csrc/wavefront_grad.cu::TapeSlots).
  * `WavefrontTraceFused` / `wavefront_trace_fused`: forward
    `wavefront_trace` (on the card, its counting kernel), backward
    `wavefront_grad`; autograd carries the table cotangents back through
    `pack_scene_tables` and `flatten_scene` to the scene leaves, and the
    ray cotangents to the camera. Given culled tables (above 128
    triangles), the forward scans them as values and the adjoint takes
    their linear, authoring-order tables (kernels/chain_trace.py::
    linear_tables, a gather that autograd carries back through the
    packing), as the JAX package's adjoint does; each ray's tree, and so
    each warp's pop count, is the linear scan's.

The march's clip rule follows jax.grad of the JAX package's XLA march
(render/shading.py::transmittance_hard, the reference of the tests): a
subgradient of 0.5 where a crossed transparency, or T itself, sits at 1.
The TPU kernel's march adjoint passes the full gradient on the closed
interval instead.

It replaces raytracingengine_tpu/kernels/wavefront_grad.py::
wavefront_grad_pallas and the custom_vjp of kernels/wavefront_trace.py::
wavefront_trace (at most 512 primitives). Past 512 the JAX package
differentiates its XLA integrator instead; so does the port, in
render/pipeline.py (`WavefrontReplay`), where the flat scene is at hand.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.kernels import _build
from raytracingengine_tpu_torch.kernels.chain_grad import (
    MAX_PRIMS,
    THREADS,
    _closest_hit,
    _grads_or_zeros,
    _rsqrt_where,
    check_gbar,
    split_table_cots,
    table_entries,
)
from raytracingengine_tpu_torch.kernels.chain_trace import (
    _INF,
    SceneTables,
    _check_rays,
    _closest_scan,
    _HostTables,
    _sky,
    check_tables,
    linear_tables,
)
from raytracingengine_tpu_torch.kernels.wavefront_trace import (
    _check_cfg,
    _dropped_counter,
    _march_T,
    _wavefront_args,
    light_ray,
    node_children,
    push_child,
    surface,
    transmittance,
    wavefront_trace,
)
from raytracingengine_tpu_torch.utils.profiling import spanned


def clip01_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, 0, 1) / dx with jnp.clip's subgradient: 0.5 at either bound."""
    inside = (x > 0.0) & (x < 1.0)
    return torch.where(inside, 1.0, torch.where((x == 0.0) | (x == 1.0), 0.5, 0.0))


def node_children_rgb(hitf, state, lights, Ts, masks, cfg):
    """One DFS node's math given its hit: the local light weighted by
    (1 - tau) and the sky of a miss or of depth exhaustion, then the two
    children (Scene.h:131-198) -> (refl7, refr7, (cr, cg, cb), (push_refl,
    push_refr)). Child states are zero where not pushed.

    `hitf` = (t, n, the winner's 7 material rows), `lights[li]` the 7 rows
    of light li, `Ts[li]` its shadow transmittance (an input, so its
    cotangent comes out), `masks` = (live, at_max)."""
    ox, oy, oz, dx, dy, dz, weight = state
    t, nx, ny, nz, ar, ag, ab, spec, shin, tau_raw, eta_t = hitf
    live, at_max = masks
    bias = cfg.bias
    zero, one = torch.zeros_like(ox), torch.ones_like(ox)

    shadeable = live & ~at_max
    hit = t < _INF
    shade = shadeable & hit
    sky_lanes = (live & at_max) | (shadeable & ~hit)
    sky = _sky(dy)  # the stored direction, as the kernels take it
    rgb = [torch.where(sky_lanes, weight * s, zero) for s in sky]

    # Front-face flip (Scene.h:145-146)
    front = nx * dx + ny * dy + nz * dz < 0.0
    flip = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    t_safe = torch.where(hit, t, zero)
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    tau = vm.clip(tau_raw, 0.0, 1.0)
    spec_on = (tau_raw <= 0.0) & (spec > 0.0)  # Scene.h:115

    diff = [zero, zero, zero]
    spec_acc = [zero, zero, zero]
    for (lx, ly, lz, er, eg, eb, l_act), T in zip(lights, Ts):
        vx, vy, vz = lx - px, ly - py, lz - pz
        dist2 = vx * vx + vy * vy + vz * vz
        d_ok = dist2 > 1e-20
        dist = torch.sqrt(torch.where(d_ok, dist2, one))
        inv_d = torch.where(d_ok, 1.0 / dist, zero)
        ldx, ldy, ldz = vx * inv_d, vy * inv_d, vz * inv_d
        ndotl = torch.maximum(zero, nx * ldx + ny * ldy + nz * ldz)
        vis = shade & (l_act > 0.0) & (dist > bias) & (ndotl > 0.0) & (T > bias)
        inv_d2 = inv_d * inv_d
        contrib = inv_d2 * ndotl * T
        hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
        invh = _rsqrt_where(hx * hx + hy * hy + hz * hz, 1e-16)
        ndoth = torch.maximum(zero, (nx * hx + ny * hy + nz * hz) * invh)
        s_ok = vis & spec_on & (ndoth > 0.0)
        sf = torch.exp(shin * torch.log(torch.where(s_ok, ndoth, one))) * inv_d2 * T
        for c, e in enumerate((er, eg, eb)):
            diff[c] = diff[c] + torch.where(vis, e * contrib, zero)
            spec_acc[c] = spec_acc[c] + torch.where(s_ok, e * sf, zero)
    one_m_tau = 1.0 - tau  # Scene.h:171-173
    for c, a in enumerate((ar, ag, ab)):
        rgb[c] = rgb[c] + torch.where(shade, weight * one_m_tau * (a * diff[c] + spec_acc[c] * spec), zero)

    # Schlick Fresnel (Scene.h:161-168)
    ddn = dx * nx + dy * ny + dz * nz
    cos_theta = torch.maximum(zero, -ddn)
    f0r = (eta_t - 1.0) / (eta_t + 1.0)
    f0 = f0r * f0r
    omc = 1.0 - cos_theta
    omc2 = omc * omc
    fresnel = f0 + (1.0 - f0) * omc2 * omc2 * omc

    # Refraction (Scene.h:175-187)
    eta = torch.where(front, 1.0 / eta_t, eta_t)
    cosi = vm.clip(ddn, -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir_k = k < 0.0
    k_ok = k > 0.0
    coef = eta * cosi + torch.where(k_ok, torch.sqrt(torch.where(k_ok, k, one)), zero)
    rfx = torch.where(tir_k, zero, dx * eta - nx * coef)
    rfy = torch.where(tir_k, zero, dy * eta - ny * coef)
    rfz = torch.where(tir_k, zero, dz * eta - nz * coef)
    rf2 = rfx * rfx + rfy * rfy + rfz * rfz
    rf_ok = rf2 > 1e-24
    rflen = torch.where(rf_ok, torch.sqrt(torch.where(rf_ok, rf2, one)), zero)
    wants_refr = shade & (tau > 0.0)
    has_refr = wants_refr & (rflen > bias)
    tir = wants_refr & (rflen <= bias)
    inv_rf = _rsqrt_where(rf2, 1e-24)
    rfx, rfy, rfz = rfx * inv_rf, rfy * inv_rf, rfz * inv_rf
    refr_w = weight * tau * (1.0 - fresnel)  # F before TIR (Scene.h:182)

    # Reflection (Scene.h:189-195): F on transparent hits (1 under TIR),
    # the specular on opaque ones.
    reflectiveness = torch.where(tau > 0.0, torch.where(tir, one, fresnel), spec)
    rlx = dx - 2.0 * ddn * nx
    rly = dy - 2.0 * ddn * ny
    rlz = dz - 2.0 * ddn * nz
    inv_rl = _rsqrt_where(rlx * rlx + rly * rly + rlz * rlz, 1e-24)
    rlx, rly, rlz = rlx * inv_rl, rly * inv_rl, rlz * inv_rl
    refl_w = weight * reflectiveness

    push_refl = shade & (reflectiveness > bias) & (refl_w >= cfg.min_weight)
    push_refr = has_refr & (refr_w >= cfg.min_weight)
    b100 = bias * 1e2  # Scene.h:180
    refl = tuple(torch.where(push_refl, v, zero) for v in (
        px + rlx * bias, py + rly * bias, pz + rlz * bias, rlx, rly, rlz, refl_w))
    refr = tuple(torch.where(push_refr, v, zero) for v in (
        px + rfx * b100, py + rfy * b100, pz + rfz * b100, rfx, rfy, rfz, refr_w))
    return refl, refr, tuple(rgb), (push_refl, push_refr)


def pop_shade(state, tables: SceneTables, Ts, masks, cfg):
    """(state7, tables, Ts, masks) -> node_children_rgb's outputs, with the
    closest hit scanned inside, so autograd reaches every table tensor."""
    ox, oy, oz, dx, dy, dz, _ = state
    hitf = _closest_hit(tables, tuple(range(7)), ox, oy, oz, dx, dy, dz)
    lights = [tuple(tables.light[r, li] for r in range(7)) for li in range(tables.n_lights)]
    return node_children_rgb(hitf, state, lights, Ts, masks, cfg)


@torch.no_grad()
def march_tau_row(T: _HostTables, cfg, so, ld, dist, ok, T_total, cot_T, n_cols: int):
    """Replay the march of the shadow rays from `so` along `ld` (the lanes
    of `ok` with cot_T != 0) -> the [n_cols] cotangent of the material
    transparency row: each crossing of surface i adds
    cot_T * clip'(T) * T / tau_i * clip'(tau_raw_i), tau_i = clip(tau_raw_i)
    > 1e-12 (clip' = clip01_grad)."""
    acc = torch.zeros(n_cols, dtype=torch.float32, device=T_total.device)
    scale = cot_T * T_total * clip01_grad(T_total)

    def on_cross(mask, gi, tau_raw):
        tau = vm.clip(tau_raw, 0.0, 1.0)
        ok_tau = mask & (tau > 1e-12)
        val = scale * clip01_grad(tau_raw) / torch.where(ok_tau, tau, 1.0)
        acc.index_add_(0, gi, torch.where(ok_tau, val, 0.0))

    _march_T(T, cfg, *so, *ld, dist - cfg.bias, ok & (cot_T != 0.0), on_cross=on_cross)
    return acc


def wavefront_grad_plain(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
                         gbar: torch.Tensor, cfg):
    """The adjoint in plain PyTorch -> (table cotangents, d_o [R,3], d_d [R,3]).

    The kernel's three phases on [R] lanes in lockstep: the replay tapes one
    [R, 8] node per iteration (a lane whose stack is empty re-reads slot 0
    and is masked); the reverse sweep keeps the cotangent stack as a
    [cap, R, 7] tensor indexed per lane, and takes `torch.autograd.grad`
    of `pop_shade` per iteration."""
    o, d, gbar = o.detach(), d.detach(), gbar.detach()
    leaves = [t.detach().requires_grad_(True) for t in tables.tensors()]
    TL = dataclasses.replace(
        tables, sph=leaves[0], pl=leaves[1], tri=leaves[2], mat=leaves[3], light=leaves[4]
    )
    T = _HostTables(TL)
    bias, max_depth = cfg.bias, cfg.max_depth
    cap = max_depth + 2
    r = o.shape[0]
    lanes = torch.arange(r, device=o.device)
    one = torch.ones(r, dtype=torch.float32, device=o.device)

    # 1. the replay: the forward's closest hit and children, no lighting
    stack = torch.zeros((cap, r, 8), dtype=torch.float32, device=o.device)
    stack[0] = torch.stack([*o.unbind(-1), *d.unbind(-1), one, 0.0 * one], dim=-1)
    sp = torch.ones(r, dtype=torch.long, device=o.device)
    tape = []
    with torch.no_grad():
        for _ in range(cfg.budget()):
            live = sp > 0
            if not bool(live.any()):
                break
            node = stack[(sp - 1).clamp_min(0), lanes]
            sp = torch.where(live, sp - 1, sp)
            ox, oy, oz, dx, dy, dz, weight, depth = node.unbind(-1)
            t, nx, ny, nz, gi = _closest_scan(T, ox, oy, oz, dx, dy, dz)
            _, _, _, spec, _, tau_raw, eta_t = T.mat_t[:, gi]
            shade = live & (depth < max_depth) & (t < _INF)
            front, n, p = surface(t, nx, ny, nz, ox, oy, oz, dx, dy, dz)
            pushed = []
            for mask, fields in node_children(node.unbind(-1)[:7], depth, front, n, p, spec,
                                              vm.clip(tau_raw, 0.0, 1.0), eta_t, shade, cfg):
                sp, did = push_child(stack, sp, mask, fields)
                pushed.append(did)
            tape.append((node, live, *pushed))

    # 2. the reverse sweep (3. the march adjoint inside it)
    g = list(gbar.unbind(-1))
    table_cot = [torch.zeros_like(t) for t in leaves]
    cot = torch.zeros((cap, r, 7), dtype=torch.float32, device=o.device)
    rsp = sp  # nodes never popped hold zero cotangents
    for node, live, p_refl, p_refr in reversed(tape):
        ox, oy, oz, dx, dy, dz, weight, depth = node.unbind(-1)
        at_max = depth >= max_depth
        with torch.no_grad():  # each light's T, on the forward's shadow rays
            t, nx, ny, nz, _ = _closest_scan(T, ox, oy, oz, dx, dy, dz)
            shade = live & ~at_max & (t < _INF)
            _, n, p = surface(t, nx, ny, nz, ox, oy, oz, dx, dy, dz)
            so = tuple(pc + nc * bias for pc, nc in zip(p, n))
            rays = [light_ray(T, li, p, n, shade, bias) for li in range(T.nl)]
            Ts = [transmittance(T, cfg, so, ld, dist, ok) for _, ld, _, dist, ok in rays]
        with torch.enable_grad():
            st = [x.clone().requires_grad_(True) for x in (ox, oy, oz, dx, dy, dz, weight)]
            tg = [x.clone().requires_grad_(True) for x in Ts]
            refl, refr, rgb, _ = pop_shade(st, TL, tg, (live, at_max), cfg)
            # the children's cotangents: refraction was pushed last, on top
            c1 = cot[(rsp - 1).clamp_min(0), lanes]
            c2 = cot[(rsp - 2).clamp_min(0), lanes]
            refr_c = torch.where(p_refr[:, None], c1, 0.0)
            refl_c = torch.where((p_refl & p_refr)[:, None], c2, torch.where(p_refl[:, None], c1, 0.0))
            rsp = rsp - p_refl.long() - p_refr.long()
            grads = _grads_or_zeros(
                [*refl, *refr, *rgb], [*refl_c.unbind(-1), *refr_c.unbind(-1), *g], st + leaves + tg
            )
        table_cot = [a + b for a, b in zip(table_cot, grads[7:12])]
        if cfg.shadow_mode == "march":
            for (_, ld, _, dist, ok), tr, cot_T in zip(rays, Ts, grads[12:]):
                if bool((ok & (cot_T != 0.0)).any()):
                    table_cot[3][5] += march_tau_row(T, cfg, so, ld, dist, ok, tr, cot_T,
                                                     leaves[3].shape[1])
        slot = rsp.clamp_max(cap - 1)
        cot[slot, lanes] = torch.where(live[:, None], torch.stack(grads[:7], -1), cot[slot, lanes])
        rsp = rsp + live.long()
    return tuple(table_cot), cot[0, :, 0:3].contiguous(), cot[0, :, 3:6].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check_scope(tables: SceneTables) -> None:
    if tables.n_primitives > MAX_PRIMS:
        raise ValueError(
            f"the glass adjoint covers at most {MAX_PRIMS} primitives ({tables.n_primitives} "
            "here); past that render/pipeline.py differentiates the integrator's replay "
            "(render/pipeline.py::WavefrontReplay)"
        )


def tape_slots(warp_pops: torch.Tensor, n_rays: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The glass adjoint's tape stretches from the forward's per-warp counts
    (int32 [ceil(n_rays / 32)]: the most nodes one of the warp's 32 rays
    popped; a ragged last warp counts its rays only) -> (int64 first slot
    of each warp, int64 [] slots in all). Warp w owns slots starts[w] ..
    starts[w] + warp_pops[w] - 1, a slot holding one node of each of its 32
    lanes (csrc/wavefront_grad.cu::TapeSlots lays them out); a warp that
    popped nothing owns none. Both stay on the device."""
    n_warps = (n_rays + 31) // 32
    if warp_pops.dtype != torch.int32 or warp_pops.shape != (n_warps,):
        raise ValueError(f"warp_pops: expected int32 [{n_warps}] (the counting forward's, "
                         f"{n_rays} rays), got {warp_pops.dtype} {tuple(warp_pops.shape)}")
    ends = warp_pops.to(torch.int64).cumsum(0)
    total = ends[-1] if n_warps else torch.zeros((), dtype=torch.int64, device=warp_pops.device)
    return ends - warp_pops, total


def _raise_on_overruns(overruns: torch.Tensor) -> None:
    """Raise if the glass adjoint kernel counted lanes whose replay popped
    more nodes than the forward counted for their warp (a host sync)."""
    overran = int(overruns.item())
    if overran:
        raise RuntimeError(f"wavefront_grad: {overran} lanes popped more nodes than the forward "
                           "counted for their warp (warp_pops); their cotangents are NaN")


@spanned("rte.launch.wavefront_grad")
def wavefront_grad(tables: SceneTables, o: torch.Tensor, d: torch.Tensor,
                   gbar: torch.Tensor, cfg, warp_pops: torch.Tensor | None = None,
                   defer_check: bool = False):
    """Adjoint of `wavefront_trace` -> (table cotangents in the tables'
    shapes, d_o [R,3], d_d [R,3]).

    CPU tensors run `wavefront_grad_plain` (`warp_pops` None: it tapes its
    own lockstep replay). CUDA tensors launch the CUDA adjoint
    (csrc/wavefront_grad.cu) on the current stream: `warp_pops` are the
    counts of `wavefront_trace(tables, o, d, cfg, count=True)`; the tape is
    sized by them (`tape_slots`, one host sync), then the taped replay and
    reverse sweep, and the fixed-order reduction of the per-block table
    cotangents. A second host sync reads the lanes whose replay popped more
    nodes than the forward counted for their warp (their tape was cut
    short and their cotangents are NaN): if there are any, it raises
    before the cotangents are returned. With `defer_check`, which only a
    backward pass may ask for, that check runs when the backward pass ends
    instead (an autograd final callback), so that the host launches the
    rest of the backward first; it still raises before backward()
    returns, and so before an optimizer takes the cotangents."""
    _check_rays(o, d)
    check_gbar(gbar, o)
    check_tables(tables, o.device)
    _check_cfg(cfg, o.device)
    _check_scope(tables)
    if o.device.type == "cpu":
        if warp_pops is not None:
            raise ValueError("wavefront_grad: the per-warp counts are the CUDA kernels'; the "
                             "plain adjoint tapes itself")
        return wavefront_grad_plain(tables, o, d, gbar, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"wavefront_grad: unsupported device {o.device}")
    if not all(t.is_contiguous() for t in (o, d, gbar)):
        raise ValueError("wavefront_grad: o, d and gbar must be contiguous")
    if warp_pops is None or warp_pops.device != o.device or not warp_pops.is_contiguous():
        raise ValueError("wavefront_grad: expected the counts of wavefront_trace(tables, o, d, "
                         f"cfg, count=True) on {o.device}")
    total = table_entries(tables, "wavefront_grad")
    r = o.shape[0]
    starts, n_slots = tape_slots(warp_pops, r)
    if r == 0:
        return tuple(torch.zeros_like(t) for t in tables.tensors()), o.clone(), d.clone()
    lib = _build.load_library()
    n_slots = int(n_slots)  # the first host sync: the tape's size
    overruns = torch.zeros(1, dtype=torch.int32, device=o.device)
    tape = torch.empty(lib.rte_wavefront_tape_floats(n_slots), dtype=torch.float32,
                       device=o.device)
    n_blocks = max(1, math.ceil(r / THREADS))
    partials = torch.empty((total, n_blocks), dtype=torch.float32, device=o.device)
    flat = torch.empty(total, dtype=torch.float32, device=o.device)
    go, gd = torch.empty_like(o), torch.empty_like(d)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_wavefront_grad(
            *_build.table_args(tables), o.data_ptr(), d.data_ptr(), gbar.data_ptr(),
            go.data_ptr(), gd.data_ptr(), r, warp_pops.data_ptr(), starts.data_ptr(),
            tape.data_ptr(), n_slots, overruns.data_ptr(), partials.data_ptr(), flat.data_ptr(),
            total, *_wavefront_args(cfg, _dropped_counter(o.device)), stream,
        )
        _build.check(lib, err, "wavefront_grad")
    wavefront_grad.launches += 1
    if defer_check:
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: _raise_on_overruns(overruns))
    else:
        _raise_on_overruns(overruns)
    return split_table_cots(flat, tables.tensors()), go, gd


#: Kernel launches since the last reset (the CPU path does not count).
wavefront_grad.launches = 0


class WavefrontTraceFused(torch.autograd.Function):
    """Forward `wavefront_trace`, backward `wavefront_grad`, on the linear
    tables' five tensors and the rays. The forward runs on detached tensors,
    so the forward-only wrappers keep refusing inputs that require grad; it
    scans `culled` (the same scene's culled tables, values only) where
    given, else the linear tables. On the card the forward is the counting
    kernel, whose per-warp counts wait in ctx for the backward's tape; the
    backward checks the tape for overruns when the backward pass ends
    (`wavefront_grad`'s `defer_check`)."""

    @staticmethod
    @spanned("rte.autograd")
    def forward(ctx, counts, cfg, culled, o, d, sph, pl, tri, mat, light):
        ctx.counts, ctx.cfg = counts, cfg
        ctx.save_for_backward(o, d, sph, pl, tri, mat, light)
        tables = culled if culled is not None else SceneTables(
            sph.detach(), pl.detach(), tri.detach(), mat.detach(), light.detach(), *counts)
        rays = (o.detach().contiguous(), d.detach().contiguous())
        ctx.warp_pops = None
        if o.device.type == "cuda":
            img, ctx.warp_pops = wavefront_trace(tables, *rays, cfg, count=True)
            return img
        return wavefront_trace(tables, *rays, cfg)

    @staticmethod
    @spanned("rte.autograd")
    def backward(ctx, g):
        o, d, *tabs = ctx.saved_tensors
        tables = SceneTables(*(t.detach() for t in tabs), *ctx.counts)
        table_cots, go, gd = wavefront_grad(
            tables, o.detach().contiguous(), d.detach().contiguous(), g.contiguous(), ctx.cfg,
            warp_pops=ctx.warp_pops, defer_check=o.device.type == "cuda",
        )
        return (None, None, None, go, gd, *table_cots)


def wavefront_trace_fused(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg) -> torch.Tensor:
    """[R,3] origins/directions -> [R,3] HDR radiance through the full
    recursion, differentiable in the rays and the table tensors (so, through
    pack_scene_tables and flatten_scene, in every float scene leaf and the
    camera).

    Without gradients it is `wavefront_trace`. With them the backward is the
    glass adjoint, for at most MAX_PRIMS primitives: a larger scene raises
    ValueError here (render/pipeline.py routes it to `WavefrontReplay`).
    Culled tables go to the forward as values; the adjoint and autograd take
    their `linear_tables`."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (o, d, *tables.tensors())
    )
    if not needs_grad:
        return wavefront_trace(tables, o.contiguous(), d.contiguous(), cfg)
    _check_scope(tables)
    counts = (tables.n_spheres, tables.n_planes, tables.n_triangles, tables.n_lights)
    culled = None
    if tables.culled:
        culled = dataclasses.replace(tables, **{n: getattr(tables, n).detach()
                                                for n in ("sph", "pl", "tri", "mat", "light")})
        tables = linear_tables(tables)
    return WavefrontTraceFused.apply(counts, cfg, culled, o, d, *tables.tensors())
