"""The full Whitted recursion (glass): plain versions and CUDA kernels.

One call traces [R,3] origins and directions to [R,3] HDR radiance through
the reference's binary recursion tree (Scene.h:131-198): at each hit the
local light weighted by (1 - transparency), a reflection child weighted by
the Schlick Fresnel term F (transparent; TIR forces F = 1) or by the
specular (opaque), and a refraction child weighted transparency * (1 - F).
A per-lane LIFO stack of (o, d, weight, depth) with cap = max_depth + 2
slots holds the children; each iteration pops one node per live lane, and
a lane's trace ends when its stack is empty or after `cfg.budget()` pops.
Shadows are the reference's transmittance march (`shadow_mode="march"`)
or one any-hit scan (`"binary"`).

  * `trace_wavefront_plain` is the plain PyTorch version, a line-by-line
    mirror of the TPU kernel body `_dfs_trace_tile` on [R] lanes, reading
    the tables as Python floats (`_HostTables`). It carries no gradient.
  * `wavefront_spp_trace_plain` is its AA loop: sample 0 unjittered,
    samples 1.. with the Philox jitter of kernels/spp_trace.py.
  * `wavefront_trace` and `wavefront_spp_trace` are the wrappers: for CPU
    tensors they call the plain versions; for CUDA tensors they launch
    csrc/wavefront_trace.cu and csrc/wavefront_spp_trace.cu and count the
    launch in `.launches`, and per route in `.routes` (ROUTES). Both are
    forward-only on either device: the gradient of `wavefront_trace` is
    kernels/wavefront_grad.py's adjoint.
    `wavefront_trace(..., count=True)` (CUDA tensors) runs the counting
    kernel, which also returns, per warp of 32 rays, the most nodes one of
    its rays popped: the glass adjoint sizes its tape by them.
  * Both take linear tables or, above TRI_BLOCK triangles, the culled
    tables of kernels/chain_trace.py::pack_forward_tables_perm (route
    "culled"): the kernels' warps then walk the group and block boxes
    together, sharing each met block's tests among their lanes
    (csrc/trace_common.cuh::WarpCulledTris), and the plain versions scan the
    culled triangles by runs of whole blocks with the lexicographic (t,
    original index) winner; either way the frame is the linear tables' bit
    for bit.

They replace raytracingengine_tpu/kernels/wavefront_trace.py::
wavefront_trace_pallas and wavefront_spp_trace_pallas, the culled scan
`_tri_scan_blocked` of their `_dfs_trace_tile` included.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.kernels import _build
from raytracingengine_tpu_torch.kernels.chain_trace import (
    _INF,
    SceneTables,
    _any_hit,
    _check_rays,
    _closest_scan,
    _HostTables,
    _sky,
    check_tables,
)
from raytracingengine_tpu_torch.kernels.spp_trace import check_pixels, mean_over_samples
from raytracingengine_tpu_torch.utils.profiling import spanned

#: Largest stack the CUDA kernels compile (csrc/trace_common.cuh kMaxCap):
#: max_depth + 2 <= MAX_CAP.
MAX_CAP = 32
#: The kernels' scans, by the tables: linear, or culled (WarpCulledTris).
ROUTES = ("linear", "culled")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _nearest_t_tau(T: _HostTables, ox, oy, oz, dx, dy, dz):
    """The march's scan -> (t, transparency of the winner, winner): the
    closest-hit scan's t and winner (the kernel's reduced scan skips the
    normal)."""
    t, _, _, _, gi = _closest_scan(T, ox, oy, oz, dx, dy, dz)
    return t, T.mat_t[5, gi], gi  # miss lanes read column 0 and are masked


def _march_T(T: _HostTables, cfg, ox, oy, oz, ldx, ldy, ldz, max_dist, active, observer=None,
             on_cross=None):
    """computeTransmittance (Scene.h:35-77) for a lane batch -> T [R]: the
    TPU kernel's `_march_T`, a masked loop that steps every live lane until
    none is left or after shadow_max_steps steps. `on_cross(mask, gi,
    tau_raw)`, if given, is told at each step which lanes multiplied T by
    the transparency of surface gi."""
    bias = cfg.bias
    live = active & (max_dist > 0.0)
    traveled = torch.zeros_like(ox)
    tr = torch.ones_like(ox)
    for _ in range(cfg.shadow_max_steps):
        if not bool(live.any()):
            break
        if observer is not None:
            observer.march_step(ox, oy, oz, ldx, ldy, ldz, live)
        t, tau_raw, gi = _nearest_t_tau(T, ox, oy, oz, ldx, ldy, ldz)
        valid = t < _INF
        t = torch.where(valid, t, 0.0)
        c_zero = valid & (t <= 0.0)
        c_near = valid & (t > 0.0) & (t <= bias)
        c_beyond = valid & (t > bias) & (traveled + t >= max_dist)
        c_pass = valid & (t > bias) & (traveled + t < max_dist)
        if on_cross is not None:
            on_cross(live & c_pass, gi, tau_raw)
        step = torch.where(c_zero, bias, torch.where(c_near | c_pass, t + bias, 0.0))
        n_tr = torch.where(c_pass, tr * vm.clip(tau_raw, 0.0, 1.0), tr)
        ox = torch.where(live, ox + ldx * step, ox)
        oy = torch.where(live, oy + ldy * step, oy)
        oz = torch.where(live, oz + ldz * step, oz)
        traveled = torch.where(live, traveled + step, traveled)
        tr = torch.where(live, n_tr, tr)
        live = live & valid & ~c_beyond & (tr > cfg.shadow_min_t) & (traveled < max_dist)
    return vm.clip(tr, 0.0, 1.0)


def surface(t, nx, ny, nz, ox, oy, oz, dx, dy, dz):
    """Front-face flip (Scene.h:145-146) and hit point of a closest hit ->
    (front, flipped normal, point); a miss lane's point is its origin."""
    front = nx * dx + ny * dy + nz * dz < 0.0
    flip = torch.where(front, 1.0, -1.0)
    t_safe = torch.where(t < _INF, t, 0.0)
    return (front, (nx * flip, ny * flip, nz * flip),
            (ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe))


def light_ray(T: _HostTables, li: int, p, n, shade, bias):
    """The shadow ray of light li (Scene.h:79-100) -> (inverse distance,
    unit direction, n.l clamped at 0, distance, whether the light counts)."""
    (px, py, pz), (nx, ny, nz) = p, n
    vx, vy, vz = T.light[0][li] - px, T.light[1][li] - py, T.light[2][li] - pz
    dist = torch.sqrt((vx * vx + vy * vy + vz * vz).clamp_min(1e-30))
    inv_d = 1.0 / dist
    ldx, ldy, ldz = vx * inv_d, vy * inv_d, vz * inv_d
    ndotl = (nx * ldx + ny * ldy + nz * ldz).clamp_min(0.0)
    ok = shade & (T.light[6][li] > 0.0) & (dist > bias) & (ndotl > 0.0)
    return inv_d, (ldx, ldy, ldz), ndotl, dist, ok


def transmittance(T: _HostTables, cfg, so, ld, dist, ok, observer=None, on_cross=None):
    """Shadow transmittance of the shadow rays from so along ld -> T [R]:
    the march, or 0/1 from one any-hit scan."""
    if cfg.shadow_mode == "march":
        return _march_T(T, cfg, *so, *ld, dist - cfg.bias, ok, observer, on_cross)
    if observer is not None:
        observer.any_hit(*so, *ld, ok, cfg.bias, dist - cfg.bias)
    occ = (_any_hit(T, *so, *ld, cfg.bias, dist - cfg.bias)
           if bool(ok.any()) else torch.ones_like(ok))
    return torch.where(occ, 0.0, 1.0)


def node_children(state, depth, front, n, p, spec, tau, eta_t, shade, cfg):
    """The children of the shaded lanes (Scene.h:161-195) -> ((push_refl,
    refl), (push_refr, refr)), each child the 8 stack fields (o, d, weight,
    depth). Reflection comes first: pushed in this order, refraction pops
    first, as the reference's recursion visits it."""
    ox, oy, oz, dx, dy, dz, weight = state
    (nx, ny, nz), (px, py, pz) = n, p
    bias = cfg.bias
    # Schlick Fresnel (Scene.h:161-168)
    ddn = dx * nx + dy * ny + dz * nz
    cos_theta = (-ddn).clamp_min(0.0)
    f0r = (eta_t - 1.0) / (eta_t + 1.0)
    f0 = f0r * f0r
    omc = 1.0 - cos_theta
    omc2 = omc * omc
    fresnel = f0 + (1.0 - f0) * omc2 * omc2 * omc

    # Refraction (Scene.h:175-187): d, n unit, cosi = d.n, TIR -> 0.
    eta = torch.where(front, 1.0 / eta_t, eta_t)
    cosi = vm.clip(ddn, -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir_k = k < 0.0
    coef = eta * cosi + torch.sqrt(k.clamp_min(0.0))
    rfx = torch.where(tir_k, 0.0, dx * eta - nx * coef)
    rfy = torch.where(tir_k, 0.0, dy * eta - ny * coef)
    rfz = torch.where(tir_k, 0.0, dz * eta - nz * coef)
    rf2 = rfx * rfx + rfy * rfy + rfz * rfz
    rflen = torch.sqrt(rf2)
    wants_refr = shade & (tau > 0.0)
    has_refr = wants_refr & (rflen > bias)
    tir = wants_refr & ~(rflen > bias)
    inv_rf = torch.rsqrt(rf2.clamp_min(1e-24))
    rfx, rfy, rfz = rfx * inv_rf, rfy * inv_rf, rfz * inv_rf
    refr_w = weight * tau * (1.0 - fresnel)  # F before TIR (Scene.h:182)

    # Reflection (Scene.h:189-195)
    reflectiveness = torch.where(tau > 0.0, torch.where(tir, 1.0, fresnel), spec)
    rlx = dx - 2.0 * ddn * nx
    rly = dy - 2.0 * ddn * ny
    rlz = dz - 2.0 * ddn * nz
    inv_rl = torch.rsqrt((rlx * rlx + rly * rly + rlz * rlz).clamp_min(1e-24))
    rlx, rly, rlz = rlx * inv_rl, rly * inv_rl, rlz * inv_rl
    refl_w = weight * reflectiveness

    child = depth + 1.0
    b100 = bias * 1e2  # Scene.h:180
    return (
        (shade & (reflectiveness > bias) & (refl_w >= cfg.min_weight),
         (px + rlx * bias, py + rly * bias, pz + rlz * bias, rlx, rly, rlz, refl_w, child)),
        (has_refr & (refr_w >= cfg.min_weight),
         (px + rfx * b100, py + rfy * b100, pz + rfz * b100, rfx, rfy, rfz, refr_w, child)),
    )


def push_child(stack: torch.Tensor, sp: torch.Tensor, mask, fields):
    """Write `fields` into the [cap, R, 8] stack at each masked lane's sp
    while sp < cap -> (new sp, the lanes that pushed)."""
    cap, r = stack.shape[:2]
    lanes = torch.arange(r, device=stack.device)
    mask = mask & (sp < cap)
    slot = sp.clamp_max(cap - 1)
    new = torch.stack(fields, dim=-1)
    stack[slot, lanes] = torch.where(mask[:, None], new, stack[slot, lanes])
    return sp + mask.long(), mask


def trace_wavefront_plain(
    tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg, observer=None
) -> torch.Tensor:
    """[R,3] origins/directions -> [R,3] HDR radiance, in plain PyTorch.

    A line-by-line mirror of the TPU kernel's `_dfs_trace_tile`. The stack
    is a [cap, R, 8] tensor (o, d, weight, depth per slot) indexed per lane
    by sp; a dead lane pops slot 0 and is masked. `observer`, if given, is
    told of every pop, closest-hit scan, node shaded, shadow ray, light
    added, march step and any-hit scan (roofline.wavefront_work counts the
    work with it)."""
    T = _HostTables(tables)
    bias, max_depth = cfg.bias, cfg.max_depth
    cap = max_depth + 2
    r = o.shape[0]
    lanes = torch.arange(r, device=o.device)
    zero = torch.zeros(r, dtype=torch.float32, device=o.device)
    one = torch.ones_like(zero)
    stack = torch.zeros((cap, r, 8), dtype=torch.float32, device=o.device)
    stack[0] = torch.stack([*o.unbind(-1), *d.unbind(-1), one, zero], dim=-1)
    sp = torch.ones(r, dtype=torch.long, device=o.device)
    acc_r, acc_g, acc_b = zero, zero, zero

    for _ in range(cfg.budget()):
        live = sp > 0
        if not bool(live.any()):
            break
        if observer is not None:
            observer.pop(live)
        node = stack[(sp - 1).clamp_min(0), lanes]
        ox, oy, oz, dx, dy, dz, weight, depth = node.unbind(-1)
        sp = torch.where(live, sp - 1, sp)

        at_max = depth >= max_depth
        if_max_sky = live & at_max
        shadeable = live & ~at_max
        skr, skg, skb = _sky(dy)
        if observer is not None:
            observer.closest(ox, oy, oz, dx, dy, dz, shadeable)
        t, nx, ny, nz, gi = _closest_scan(T, ox, oy, oz, dx, dy, dz)
        ar, ag, ab, spec, shin, tau_raw, eta_t = T.mat_t[:, gi]
        hit = t < _INF
        miss = shadeable & ~hit
        shade = shadeable & hit
        sky_lanes = if_max_sky | miss
        acc_r = acc_r + torch.where(sky_lanes, weight * skr, 0.0)
        acc_g = acc_g + torch.where(sky_lanes, weight * skg, 0.0)
        acc_b = acc_b + torch.where(sky_lanes, weight * skb, 0.0)

        front, n, p = surface(t, nx, ny, nz, ox, oy, oz, dx, dy, dz)
        (nx, ny, nz), (px, py, pz) = n, p
        tau = vm.clip(tau_raw, 0.0, 1.0)
        if observer is not None:  # the kernels run node_children where it can push a child
            observer.shade(sky_lanes, shade, shade & (gi < T.ns), shade & ((tau > 0.0) | (spec > bias)))

        # Direct lighting (Scene.h:79-129)
        so = (px + nx * bias, py + ny * bias, pz + nz * bias)
        spec_on = (tau_raw <= 0.0) & (spec > 0.0)  # Scene.h:115
        dr, dg, db, sr, sg, sb = zero, zero, zero, zero, zero, zero
        for li in range(T.nl):
            er, eg, eb = T.light[3][li], T.light[4][li], T.light[5][li]
            inv_d, (ldx, ldy, ldz), ndotl, dist, ok = light_ray(T, li, p, n, shade, bias)
            if observer is not None:
                observer.shadow(ok)
            tr = transmittance(T, cfg, so, (ldx, ldy, ldz), dist, ok, observer)
            vis = ok & (tr > bias)
            inv_d2 = inv_d * inv_d
            contrib = inv_d2 * ndotl * tr
            dr = dr + torch.where(vis, er * contrib, 0.0)
            dg = dg + torch.where(vis, eg * contrib, 0.0)
            db = db + torch.where(vis, eb * contrib, 0.0)
            hx_, hy_, hz_ = ldx - dx, ldy - dy, ldz - dz
            invh = torch.rsqrt((hx_ * hx_ + hy_ * hy_ + hz_ * hz_).clamp_min(1e-24))
            ndoth = ((nx * hx_ + ny * hy_ + nz * hz_) * invh).clamp_min(0.0)
            s_ok = vis & spec_on & (ndoth > 0.0)
            ndoth_s = torch.where(s_ok, ndoth, 1.0)
            sf = torch.exp(shin * torch.log(ndoth_s)) * inv_d2 * tr
            sr = sr + torch.where(s_ok, er * sf, 0.0)
            sg = sg + torch.where(s_ok, eg * sf, 0.0)
            sb = sb + torch.where(s_ok, eb * sf, 0.0)
            if observer is not None:
                observer.light(shade & (T.light[6][li] > 0.0), vis, s_ok)
        wl = weight * (1.0 - tau)  # Scene.h:171-173
        acc_r = acc_r + torch.where(shade, wl * (ar * dr + sr * spec), 0.0)
        acc_g = acc_g + torch.where(shade, wl * (ag * dg + sg * spec), 0.0)
        acc_b = acc_b + torch.where(shade, wl * (ab * db + sb * spec), 0.0)

        state = (ox, oy, oz, dx, dy, dz, weight)
        for mask, fields in node_children(state, depth, front, n, p, spec, tau, eta_t, shade, cfg):
            sp, _ = push_child(stack, sp, mask, fields)
    return torch.stack([acc_r, acc_g, acc_b], dim=-1)


def wavefront_spp_trace_plain(
    tables: SceneTables,
    camera,
    px: torch.Tensor,
    py: torch.Tensor,
    cfg,
    *,
    seed: int = 0,
    jitter: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pixels px/py [R] -> mean HDR [R, 3] over `camera.spp` samples, each
    traced by `trace_wavefront_plain`. `jitter` [spp, R, 2] replaces the
    generator, as in kernels/spp_trace.py::spp_trace_plain."""
    trace = lambda o, d: trace_wavefront_plain(tables, o, d, cfg)  # noqa: E731
    return mean_over_samples(trace, camera, px, py, seed=seed, jitter=jitter)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def check_no_grad(*tensors: torch.Tensor) -> None:
    """The wavefront kernels and their plain versions are forward-only; the
    plain versions read the tables as Python floats, so a gradient through
    them would be silently zero."""
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the wavefront trace kernels are forward-only: differentiate through "
            "kernels.wavefront_grad.wavefront_trace_fused, whose backward is the glass "
            "adjoint kernel (render_hdr's per-sample loop at spp > 1)"
        )


def _check_cfg(cfg, device: torch.device) -> None:
    """Raise for a config the wrappers do not take on `device`: shadows
    other than binary or march anywhere; on a CUDA device a stack past the
    kernels' MAX_CAP (the plain versions size theirs as max_depth + 2 and
    take any depth)."""
    if cfg.shadow_mode not in ("binary", "march"):
        raise ValueError(f"wavefront trace: shadow_mode {cfg.shadow_mode!r} is not binary or march")
    if cfg.max_depth < 0 or (device.type == "cuda" and cfg.max_depth > MAX_CAP - 2):
        raise ValueError(
            f"wavefront trace: max_depth {cfg.max_depth} outside [0, {MAX_CAP - 2}] "
            f"(the kernels compile a stack of {MAX_CAP} nodes)"
        )


#: device -> int32 [1] count of pushes the kernels dropped on a full stack.
_DROPPED: dict[torch.device, torch.Tensor] = {}


def _dropped_counter(device: torch.device) -> torch.Tensor:
    if device not in _DROPPED:
        _DROPPED[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _DROPPED[device]


def dropped_pushes() -> int:
    """Pushes the CUDA kernels dropped on a full stack since the first
    launch, over all devices (0 unless cap = max_depth + 2 fails to bound
    the DFS)."""
    return sum(int(c.item()) for c in _DROPPED.values())


def _wavefront_args(cfg, dropped: torch.Tensor) -> list:
    return [
        cfg.max_depth, cfg.bias, cfg.min_weight, int(cfg.shadow_mode == "march"),
        cfg.shadow_max_steps, cfg.shadow_min_t, cfg.budget(), dropped.data_ptr(),
    ]


@spanned("rte.launch.wavefront_trace")
def wavefront_trace(
    tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg, count: bool = False
):
    """[R,3] origins/directions -> [R,3] HDR radiance; with `count`, ->
    (radiance, int32 [ceil(R / 32)] most nodes popped per warp).

    CPU tensors run `trace_wavefront_plain`; CUDA tensors launch the CUDA
    kernel (csrc/wavefront_trace.cu) on the current stream, its counting
    instantiation with `count` (CUDA tensors only: the plain adjoint tapes
    its own lockstep replay)."""
    _check_rays(o, d)
    check_tables(tables, o.device, culled_ok=True)
    _check_cfg(cfg, o.device)
    check_no_grad(o, d, *tables.tensors())
    if count and o.device.type != "cuda":
        raise ValueError("wavefront_trace: the per-warp counts are the CUDA kernel's (the "
                         "glass adjoint kernel's tape); the plain adjoint tapes itself")
    if o.device.type == "cpu":
        return trace_wavefront_plain(tables, o, d, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"wavefront_trace: unsupported device {o.device}")
    if not (o.is_contiguous() and d.is_contiguous()):
        raise ValueError("wavefront_trace: o and d must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(o)
    warp_pops = None
    if count:
        warp_pops = torch.empty((o.shape[0] + 31) // 32, dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_wavefront_trace(
            *_build.table_args(tables), *_build.culling_args(tables),
            o.data_ptr(), d.data_ptr(), out.data_ptr(), o.shape[0],
            *_wavefront_args(cfg, _dropped_counter(o.device)),
            None if warp_pops is None else warp_pops.data_ptr(), stream,
        )
    _build.check(lib, err, "wavefront_trace")
    route = ROUTES[tables.culled]
    wavefront_trace.launches += 1
    wavefront_trace.routes[route] += 1
    if count:
        wavefront_trace.count_launches += 1
        wavefront_trace.count_routes[route] += 1
        return out, warp_pops
    return out


@spanned("rte.launch.wavefront_spp_trace")
def wavefront_spp_trace(
    tables: SceneTables,
    camera,
    px: torch.Tensor,
    py: torch.Tensor,
    cfg,
    *,
    seed: int = 0,
) -> torch.Tensor:
    """Pixels px/py (int32 [R]) -> mean HDR [R, 3] over `camera.spp`.

    CPU tensors run `wavefront_spp_trace_plain`; CUDA tensors launch the
    CUDA kernel (csrc/wavefront_spp_trace.cu) on the current stream."""
    check_pixels(tables, camera, px, py, culled_ok=True)
    _check_cfg(cfg, px.device)
    check_no_grad(camera.position, camera.focal, *tables.tensors())
    if px.device.type == "cpu":
        return wavefront_spp_trace_plain(tables, camera, px, py, cfg, seed=seed)
    if px.device.type != "cuda":
        raise ValueError(f"wavefront_spp_trace: unsupported device {px.device}")
    lib = _build.load_library()
    cam = torch.stack([camera.position[0], camera.position[1], camera.position[2],
                       camera.focal]).to(torch.float32).contiguous()
    out = torch.empty((px.shape[0], 3), dtype=torch.float32, device=px.device)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_wavefront_spp_trace(
            *_build.table_args(tables), *_build.culling_args(tables),
            cam.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            px.shape[0], camera.width, camera.height, camera.spp, seed & 0xFFFFFFFF,
            *_wavefront_args(cfg, _dropped_counter(px.device)), stream,
        )
    _build.check(lib, err, "wavefront_spp_trace")
    wavefront_spp_trace.launches += 1
    wavefront_spp_trace.routes[ROUTES[tables.culled]] += 1
    return out


def new_route_counts() -> dict[str, int]:
    """Launches per route (ROUTES), all 0."""
    return dict.fromkeys(ROUTES, 0)


#: Kernel launches since the last reset (the CPU path does not count), in
#: all and per route.
wavefront_trace.launches = 0
wavefront_trace.routes = new_route_counts()
wavefront_spp_trace.launches = 0
wavefront_spp_trace.routes = new_route_counts()
#: Of wavefront_trace's launches, those of the counting kernel (`count=True`),
#: in all and per route.
wavefront_trace.count_launches = 0
wavefront_trace.count_routes = new_route_counts()
