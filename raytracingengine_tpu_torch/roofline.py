"""Work counts of the trace kernels on given inputs, and their roofline bound.

The bound of a kernel call is the least time an H100 SXM could take for
it: the larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and the fp32 operations it must do over
67 TFLOP/s (NVIDIA's H100 SXM data sheet; both assume the 700 W limit).

The operations are counted on this call's data, by replaying the trace in
plain PyTorch: which rays are live at each bounce (chain) or which nodes
each ray pops (wavefront), which lights each hit point sends a shadow ray
to, where each any-hit scan meets its first blocker and how many steps each
shadow march takes. Only the ray-primitive tests are counted, each to its
first early exit, at the fp32 operation counts of csrc/trace_common.cuh
below. The shading, the Fresnel and child-ray arithmetic, the stack and the
adjoint's own arithmetic are left out, so the count is a lower bound and so
is the time.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracingengine_tpu_torch.geometry.intersect import EPS
from raytracingengine_tpu_torch.kernels.chain_grad import state_bounce_plain
from raytracingengine_tpu_torch.kernels.wavefront_trace import trace_wavefront_plain
from raytracingengine_tpu_torch.kernels.chain_trace import (
    _INF,
    SceneTables,
    _closest_hit,
    _HostTables,
    _plane_t,
    _sphere_t,
    _tri_t,
)

H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12

# fp32 operations (add, sub, mul, div, sqrt, rsqrt) of one test in
# csrc/trace_common.cuh, to its first early exit:
#: a = d.d and inv2a = 0.5 / a, once per scan
SCAN_SETUP = 6
#: sphere_t: oc 3, b 6, c 6, disc 4 -> exit on disc < 0; else sqrt 1, -b 1,
#: the two roots 4
SPHERE_MISS, SPHERE_FULL = 19, 25
#: plane_t: denom 5 -> exit on |denom| <= eps; else o.n 5, (pn - on) / denom 2
PLANE_PARALLEL, PLANE_FULL = 5, 12
#: tri_t: h 9, a 5 -> exit on |a| <= eps; else f 1, s 3, u 6, q 9, v 6, t 6
TRI_PARALLEL, TRI_FULL = 14, 45


@dataclasses.dataclass
class ChainWork:
    """Counts of one chain trace over a ray block."""

    rays: int
    bounces: int = 0  # live bounces, summed over rays
    shadow_rays: int = 0
    closest_ops: float = 0.0  # closest-hit scans, all bounces
    shadow_ops: float = 0.0  # any-hit scans to the first blocker

    def __iadd__(self, other: "ChainWork") -> "ChainWork":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self


def _past_exit(T: _HostTables, a_coef, ox, oy, oz, dx, dy, dz):
    """Per family, i -> whether each ray's test of primitive i gets past its
    first early exit: disc >= 0 for a sphere, |d.n| > EPS for a plane,
    |e1.(d x e2)| > EPS for a triangle."""

    def sphere(i):
        ocx, ocy, ocz = ox - T.sph[0][i], oy - T.sph[1][i], oz - T.sph[2][i]
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        c = ocx * ocx + ocy * ocy + ocz * ocz - T.sph[3][i]
        return b * b - 4.0 * a_coef * c >= 0.0

    def plane(i):
        return (dx * T.pl[0][i] + dy * T.pl[1][i] + dz * T.pl[2][i]).abs() > EPS

    def tri(i):
        e1x, e1y, e1z, e2x, e2y, e2z = (T.tri[k][i] for k in range(3, 9))
        hx, hy, hz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        return (e1x * hx + e1y * hy + e1z * hz).abs() > EPS

    return sphere, plane, tri


def _test_ops(T: _HostTables, ox, oy, oz, dx, dy, dz, active, lo=None, hi=None):
    """fp32 operations of one scan for each ray of `active` [R] bool, with the
    plain version's tests. With lo/hi it is an any-hit scan, which stops at
    the first primitive with lo < t < hi; else a closest-hit scan of every
    primitive."""
    scanning = active.clone()
    ops = torch.where(active, float(SCAN_SETUP), 0.0)
    a_coef = dx * dx + dy * dy + dz * dz
    exits = _past_exit(T, a_coef, ox, oy, oz, dx, dy, dz)
    scans = (
        (T.ns, lambda i: _sphere_t(T.sph, i, a_coef, ox, oy, oz, dx, dy, dz), SPHERE_MISS, SPHERE_FULL),
        (T.np, lambda i: _plane_t(T.pl, i, ox, oy, oz, dx, dy, dz), PLANE_PARALLEL, PLANE_FULL),
        (T.nt, lambda i: _tri_t(T.tri, i, ox, oy, oz, dx, dy, dz), TRI_PARALLEL, TRI_FULL),
    )
    for (n, test, short, full), past_exit in zip(scans, exits):
        for i in range(n):
            cost = torch.where(past_exit(i), float(full), float(short))
            ops = ops + torch.where(scanning, cost, 0.0)
            if lo is not None:
                t_new, hit = test(i)
                scanning = scanning & ~(hit & (t_new > lo) & (t_new < hi))
    return float(ops.to(torch.float64).sum())


@torch.no_grad()
def chain_work(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg) -> ChainWork:
    """Replay the opaque chain (the kernels' per-ray control flow) on these
    rays and count its scans and their operations."""
    T = _HostTables(tables)
    one = torch.ones_like(o[:, 0])
    state = (*o.unbind(-1), *d.unbind(-1), one, one)
    work = ChainWork(rays=o.shape[0])
    bias = cfg.bias
    for _ in range(cfg.max_depth):
        live = state[7] > 0.0
        if not bool(live.any()):
            break
        ox, oy, oz, dx, dy, dz = state[:6]
        work.bounces += int(live.sum())
        work.closest_ops += _test_ops(T, ox, oy, oz, dx, dy, dz, live)
        t, nx, ny, nz = _closest_hit(T, ox, oy, oz, dx, dy, dz)[:4]
        shade = live & (t < _INF)
        flip = torch.where(nx * dx + ny * dy + nz * dz < 0.0, 1.0, -1.0)
        nx, ny, nz = nx * flip, ny * flip, nz * flip
        ts = torch.where(shade, t, 0.0)
        px, py, pz = ox + dx * ts, oy + dy * ts, oz + dz * ts
        for li in range(T.nl):
            vx, vy, vz = T.light[0][li] - px, T.light[1][li] - py, T.light[2][li] - pz
            dist = torch.sqrt((vx * vx + vy * vy + vz * vz).clamp_min(1e-30))
            ldx, ldy, ldz = vx / dist, vy / dist, vz / dist
            ok = shade & (dist > bias) & (nx * ldx + ny * ldy + nz * ldz > 0.0)
            work.shadow_rays += int(ok.sum())
            work.shadow_ops += _test_ops(
                T, px + nx * bias, py + ny * bias, pz + nz * bias, ldx, ldy, ldz, ok,
                lo=bias, hi=dist - bias,
            )
        state = state_bounce_plain(state, tables, cfg)
    return work


@dataclasses.dataclass
class WavefrontWork:
    """Counts of one wavefront trace over a ray block."""

    rays: int
    pops: int = 0  # nodes popped, summed over rays
    max_pops: int = 0  # the most nodes any one ray popped
    closest_ops: float = 0.0  # closest-hit scans of the nodes shaded
    shadow_rays: int = 0  # shadow rays marched or scanned
    march_steps: int = 0  # march scans, summed over shadow rays (march)
    shadow_ops: float = 0.0  # march scans, or any-hit scans to the first blocker

    def __iadd__(self, other: "WavefrontWork") -> "WavefrontWork":
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            setattr(self, f.name, max(a, b) if f.name == "max_pops" else a + b)
        return self


class _WavefrontCounter:
    """The observer of trace_wavefront_plain that fills a WavefrontWork."""

    def __init__(self, tables: SceneTables, o: torch.Tensor):
        self.T = _HostTables(tables)
        self.work = WavefrontWork(rays=o.shape[0])
        self.pops = torch.zeros(o.shape[0], dtype=torch.long, device=o.device)

    def pop(self, live):
        self.pops += live.long()

    def closest(self, ox, oy, oz, dx, dy, dz, active):
        self.work.closest_ops += _test_ops(self.T, ox, oy, oz, dx, dy, dz, active)

    def shadow(self, ok):
        self.work.shadow_rays += int(ok.sum())

    def march_step(self, ox, oy, oz, dx, dy, dz, live):
        self.work.march_steps += int(live.sum())
        self.work.shadow_ops += _test_ops(self.T, ox, oy, oz, dx, dy, dz, live)

    def any_hit(self, ox, oy, oz, dx, dy, dz, ok, lo, hi):
        self.work.shadow_ops += _test_ops(self.T, ox, oy, oz, dx, dy, dz, ok, lo=lo, hi=hi)


@torch.no_grad()
def wavefront_work(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg) -> WavefrontWork:
    """Replay the wavefront DFS (the kernels' per-ray control flow) on these
    rays and count its pops, scans, march steps and their operations."""
    counter = _WavefrontCounter(tables, o)
    trace_wavefront_plain(tables, o, d, cfg, observer=counter)
    counter.work.pops = int(counter.pops.sum())
    counter.work.max_pops = int(counter.pops.max()) if o.shape[0] else 0
    return counter.work


def table_bytes(tables: SceneTables) -> int:
    return 4 * sum(t.numel() for t in tables.tensors())


def trace_bytes(rays: int, tables: SceneTables, in_per_ray: int = 24) -> int:
    """Bytes a trace kernel must move: per ray its input (o and d, 24
    bytes; pixel coordinates, 8) and its HDR output (12), and the tables
    once."""
    return rays * (in_per_ray + 12) + table_bytes(tables)


def adjoint_bytes(rays: int, tables: SceneTables) -> int:
    """Bytes an adjoint kernel must move: per ray o, d and g in (36 bytes)
    and d_o, d_d out (24), the tables read and their cotangents written."""
    return rays * (36 + 24) + 2 * table_bytes(tables)


def work_ops(work: ChainWork | WavefrontWork) -> float:
    """The fp32 operations a call needs: its closest-hit scans and its
    shadow scans (any-hit or march). An adjoint needs the same scans as its
    forward; its own replays are choices of design and are not counted."""
    return work.closest_ops + work.shadow_ops


def bound_ms(ops: float, n_bytes: float) -> tuple[float, str]:
    """-> (least time in ms on an H100 SXM at 700 W, "operations" or "bytes")."""
    t_ops, t_bytes = ops / H100_FP32_OPS_PER_S, n_bytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
