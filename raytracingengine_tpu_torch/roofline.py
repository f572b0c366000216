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

On culled tables (above 128 triangles) the triangles' count is that of a
traversal of the two-level hierarchy that knew the answer: the slab tests
of every group box, of the block boxes of each group whose box the ray's
segment meets, and the triangle tests (to their first exit) of each block
whose box it meets. The segment is [0, t of the final hit] (the whole ray
on a miss) for a closest-hit scan and [0, hi] for a shadow ray, the bounds
the kernel's box tests use. Any traversal of this hierarchy must do at
least that much, so it is a lower bound for the culled kernels; counting
every triangle, as a linear scan does, would put the bound far above what
they need. (For a shadow ray it counts every block its segment meets, where
a scan that stops at the first blocker may test fewer.)

The glass kernels' work (`wavefront_work`) also counts what the tests
leave out, so that their bound names the node's arithmetic: each popped
node's shading in csrc/trace_common.cuh::trace_wavefront_ray (a sky
node's sky term; a shaded node's surface and direct light, and
node_children where it can push a child; per light the shadow ray's
set-up, and where it is lit the diffuse and Blinn-Phong terms), each
march step's bookkeeping, and for the AA kernel
each sample's camera ray (trace_common.cuh::camera_dir) and Philox jitter.
Their fp32 adds and multiplies are counted against the fp32 peak, the
special-function operations (sqrt, rsqrt, reciprocal, exp, log: one MUFU
instruction each, with their refinement left out) against the MUFU peak,
and the jitter's integer operations against the INT32 peak, each on its
own pipe: `wavefront_bound_ms` takes the largest of those times and the
bytes'. Branches taken only by some rays (the refraction child past TIR,
the specular term) count where the replay takes them; node_children's
refraction square root, taken only off TIR, is left out, so this count too
is a lower bound. The constants below are counted by hand from the CUDA
source of csrc/trace_common.cuh: trace_wavefront_ray, sky, surface,
node_children, march_T's step, camera_dir, philox_xy and uniform01. An edit
to any of those functions must recount them; nothing checks them against
the compiled kernels.

On culled tables the glass kernels' scans (closest hit, march step,
any-hit) count as the chain kernels' do: the slab tests of the group
boxes and of the block boxes of each group the segment meets, and the
tests of the blocks it meets, on the oracle's segments. `wavefront_work`
also counts, in blocks of 128 tests, for each scan of the replay (a warp
is 32 consecutive rays):
  * per lane, the blocks those segments meet (`lane_blocks`);
  * 32 times the most blocks one lane of a warp meets (`warp_blocks`): the
    tests a warp issues where each lane loops over its own ray's blocks,
    as many turns as its busiest lane's;
  * per lane, the blocks the kernels' traversal visits (`visit_blocks`,
    `_visit_blocks`: the chain kernels' windows and bounds), and per warp
    the blocks of the OR of its lanes' window masks (`vote_blocks`). The
    warp-cooperative scan (csrc/trace_common.cuh::WarpCulledTris) takes
    one warp turn of 128 tests for each block a lane visits and one vote
    turn for each block of the OR: `coop_blocks`, their sum.
`closest_tris` counts the real triangles (padding left out) the closest-hit
and march scans test, per lane, on either route: all of them per scan on
linear tables, those of the met blocks on culled ones.

Beside the operations, `chain_work` counts the culled scans' blocks, each
128 triangle tests:
  * per lane, the blocks of the oracle's segments above (`lane_blocks`);
  * per lane, the blocks the kernels' own traversal visits
    (`visit_blocks`): windows of 64 blocks in table order, each tested
    against the best t at the window's start, each block re-tested against
    the running best t (csrc/trace_common.cuh::CtaCulledTris); a shadow
    ray stops after the block of its first blocker;
  * per warp of a thread-to-ray map (kernels/chain_trace.py::thread_rays),
    32 lanes times the union of the blocks its lanes meet
    (`warp_blocks[width]`, `warp_visit_blocks[width]`): the tests a warp
    issues where each lane tests its own ray against a block while any lane
    needs it. Their ratio to the per-lane count is the share of issued
    tests that a lane uses;
  * per CTA of the map, the union of its rays' visited blocks
    (`staged_blocks[width]`): the blocks the CTA copies into shared memory.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracingengine_tpu_torch.geometry.intersect import EPS
from raytracingengine_tpu_torch.kernels.chain_grad import state_bounce_dense
from raytracingengine_tpu_torch.kernels.chain_trace import (
    _INF,
    CTA_THREADS,
    TRI_BLOCK,
    TRI_GROUP,
    SceneTables,
    _block_rows,
    _closest_hit,
    _HostTables,
    _plane_t,
    _sphere_t,
    _tri_t,
    block_rows,
    culled_runs,
    first_min,
    prim_blocks,
    thread_rays,
)
from raytracingengine_tpu_torch.kernels.wavefront_trace import trace_wavefront_plain

H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
#: MUFU (special-function) and INT32 peaks of the same part: 16 and 64
#: results per SM per clock against fp32's 128 (FMA counted as 2), 132 SMs
#: at the 1.98 GHz behind the fp32 peak (NVIDIA's Hopper white paper).
H100_MUFU_OPS_PER_S = H100_FP32_OPS_PER_S / 16
H100_INT32_OPS_PER_S = H100_FP32_OPS_PER_S / 4

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
#: make_slab: three reciprocals, once per culled scan; box_hit: 6 sub, 6 mul,
#: 6 min/max of the slabs, 4 min/max for tmin and tmax
SLAB_SETUP, SLAB_TEST = 3, 22
# fp32 operations (add, sub, mul, min, max) and MUFU operations of the glass
# kernels' shading (csrc/trace_common.cuh::trace_wavefront_ray), beside
# their tests:
#: a sky node (depth exhaustion or a miss): sky(dy) 9, acc += w * sky 6
SKY_NODE = 15
#: a shaded node: surface 14, clip01(tau) 2, the shadow origin 6, the local
#: term 2 + 15
SHADE_NODE = 39
#: node_children, on a hit that can push a child (transparent, or specular
#: past bias): Fresnel 16, eta, cosi and k 7, the refraction direction's
#: length and normalisation 9, its weight 3, the reflection direction 16,
#: its weight 1, the children's origins 13. MUFU: the two divisions (f0,
#: eta), sqrt and rsqrt of the refraction, rsqrt of the reflection
CHILDREN, CHILDREN_MUFU = 65, 5
#: the winner's normal where a sphere wins: g 9, |g|^2 5, max 1, 3 products;
#: rsqrt
SPHERE_NORMAL, SPHERE_NORMAL_MUFU = 18, 1
#: per shaded node and light that emits: to the light 3, dist^2 5, max 1,
#: the unit direction 3, n.l 6; sqrt and 1 / dist
LIGHT_SETUP, LIGHT_SETUP_MUFU = 18, 2
#: a light that reaches the point: 1/d^2 n.l T 3, the diffuse sums 6, the
#: half vector 3, |h|^2 5, max 1, n.h 7; rsqrt
LIGHT_LIT, LIGHT_LIT_MUFU = 25, 1
#: its specular term: shin * log 1, * 1/d^2 * T 2, the sums 6; log and exp
LIGHT_SPEC, LIGHT_SPEC_MUFU = 9, 2
#: a march step beside its scan: the origin 6, the distance 1, t + bias 1
MARCH_STEP = 8
#: a sample's camera ray: minus the camera 2, |dd|^2 5, 3 products, the
#: sample's sum 3; rsqrt. Once per pixel (counted with sample 0): the
#: screen point 4
CAMERA, CAMERA_MUFU, CAMERA_PIXEL = 13, 1, 4
#: a jittered sample (1..): the two uniforms' - 1 (fp32); and integer,
#: Philox4x32-10's rounds, each two wide multiplies (one IMAD.WIDE.U32 gives
#: a product's high and low words), two three-way xors (LOP3) and k0's add
#: (k1 starts at 0 and rises by constants: folded), round 0 one multiply
#: and one xor (the zero counter words fold the rest) and no add: 2 + 9 x 5;
#: the uniforms' shifts and ors 4. The pixel id (one IMAD per pixel) is
#: left out
JITTER, PHILOX_INT = 2, 51

#: Blocks of culled tables per vote of the kernels' traversal
#: (csrc/trace_common.cuh::kWindow).
WINDOW = 64


@dataclasses.dataclass
class ChainWork:
    """Counts of one chain trace over a ray block."""

    rays: int
    bounces: int = 0  # live bounces, summed over rays
    shadow_rays: int = 0
    closest_ops: float = 0.0  # closest-hit scans, all bounces
    shadow_ops: float = 0.0  # any-hit scans to the first blocker
    # culled tables only, in blocks of TRI_BLOCK triangle tests, all scans:
    lane_blocks: float = 0.0  # per lane, the oracle's segments
    visit_blocks: float = 0.0  # per lane, the kernels' traversal
    closest_lane_blocks: float = 0.0  # the closest-hit scans' share of each
    closest_visit_blocks: float = 0.0
    # width of the thread-to-ray map -> 32 x the union over each warp
    warp_blocks: dict = dataclasses.field(default_factory=dict)
    warp_visit_blocks: dict = dataclasses.field(default_factory=dict)
    # width -> the blocks staged: the union over each CTA, summed
    staged_blocks: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, other: "ChainWork") -> "ChainWork":
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, dict):
                setattr(self, f.name, {k: a.get(k, 0.0) + b.get(k, 0.0) for k in {*a, *b}})
            else:
                setattr(self, f.name, a + b)
        return self


def _tri_past_exit(T: _HostTables, dx, dy, dz):
    """i -> whether each ray's test of triangle i of tables that are not
    culled gets past its first early exit, |e1.(d x e2)| > EPS."""

    def tri(i):
        e1x, e1y, e1z, e2x, e2y, e2z = (T.tri[k][i] for k in range(3, 9))
        hx, hy, hz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        return (e1x * hx + e1y * hy + e1z * hz).abs() > EPS

    return tri


def _families(T: _HostTables, ox, oy, oz, dx, dy, dz):
    """The spheres' and planes' blocked tests on these rays: per family
    (table, count, rows -> (t [R, b], hit), rows -> past its first early
    exit [R, b] (disc >= 0 for a sphere, |d.n| > EPS for a plane), the
    operations of a test that exits there, those of a full test)."""
    a_coef = (dx * dx + dy * dy + dz * dz)[:, None]
    rays = tuple(x[:, None] for x in (ox, oy, oz, dx, dy, dz))

    def sphere_exit(rows):
        ocx, ocy, ocz = rays[0] - rows[0], rays[1] - rows[1], rays[2] - rows[2]
        b = 2.0 * (ocx * rays[3] + ocy * rays[4] + ocz * rays[5])
        c = ocx * ocx + ocy * ocy + ocz * ocz - rows[3]
        return b * b - 4.0 * a_coef * c >= 0.0

    return (
        (T.sph_t, T.ns, lambda rows: _sphere_t(rows, slice(None), a_coef, *rays), sphere_exit,
         SPHERE_MISS, SPHERE_FULL),
        (T.pl_t, T.np, lambda rows: _plane_t(rows, slice(None), *rays),
         lambda rows: (rays[3] * rows[0] + rays[4] * rows[1] + rays[5] * rows[2]).abs() > EPS,
         PLANE_PARALLEL, PLANE_FULL),
    )


def _box_meets(taabb: torch.Tensor, ox, oy, oz, dx, dy, dz, t_hi) -> torch.Tensor:
    """[R, boxes] bool: does each ray's segment [0, t_hi] meet each box?
    (csrc/trace_common.cuh::box_hit, fp32 as there.)"""
    inv = lambda x: 1.0 / torch.where(x.abs() < 1e-12, torch.where(x < 0.0, -1e-12, 1e-12), x)  # noqa: E731
    t1, t2 = [], []
    for k, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        i = inv(d)[:, None]
        t1.append((taabb[k][None] - o[:, None]) * i)
        t2.append((taabb[k + 3][None] - o[:, None]) * i)
    tmin = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]), torch.minimum(t1[1], t2[1])),
                         torch.minimum(t1[2], t2[2]))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]), torch.maximum(t1[1], t2[1])),
                         torch.maximum(t1[2], t2[2]))
    return (tmax >= tmin) & (tmax >= 0.0) & (tmin <= t_hi[:, None])


def _culled_ops(T: _HostTables, taabb, ox, oy, oz, dx, dy, dz, active, t_hi) -> torch.Tensor:
    """Per ray, the fp32 operations of the culled triangle scan that knew
    its segment [0, t_hi]: its slab tests, and the tests of the triangles
    in the blocks whose box the segment meets, each to its first exit."""
    nb, ng = T.n_blocks, T.n_blocks // TRI_GROUP
    ops = torch.zeros_like(ox)
    if not bool(active.any()):
        return ops
    idx = active.nonzero().squeeze(1)
    chunk = 1 << 16  # rays per [chunk, boxes] test, to bound the memory
    for s in range(0, idx.shape[0], chunk):
        j = idx[s:s + chunk]
        rays = tuple(x[j] for x in (ox, oy, oz, dx, dy, dz))
        meets = _box_meets(taabb, *rays, t_hi[j])
        groups = meets[:, nb:]
        blocks = meets[:, :nb] & groups.repeat_interleave(TRI_GROUP, 1)
        cost = SLAB_SETUP + SLAB_TEST * (ng + TRI_GROUP * groups.sum(1).to(ox.dtype))
        bd = rays[3:]
        for b, n in culled_runs(nb, j.shape[0]):  # the rays that meet a block of the run
            met = blocks[:, b:b + n]
            k = met.any(1).nonzero().squeeze(1)
            if k.numel() == 0:
                continue
            r = _block_rows(T, b, n)
            dx_, dy_, dz_ = (x[k][:, None] for x in bd)
            hx, hy, hz = dy_ * r[8] - dz_ * r[7], dz_ * r[6] - dx_ * r[8], dx_ * r[7] - dy_ * r[6]
            past = (r[3] * hx + r[4] * hy + r[5] * hz).abs() > EPS
            tests = torch.where(past, float(TRI_FULL), float(TRI_PARALLEL))
            cost[k] += torch.where(met[k].repeat_interleave(TRI_BLOCK, 1), tests, 0.0).sum(1)
        ops[j] = cost
    return ops


def _oracle_blocks(taabb, nb: int, rays, t_hi) -> torch.Tensor:
    """[n, nb] bool: the blocks whose box and group box each ray's segment
    [0, t_hi] meets."""
    meets = _box_meets(taabb, *rays, t_hi)
    return meets[:, :nb] & meets[:, nb:].repeat_interleave(TRI_GROUP, 1)


def _visit_blocks(T: _HostTables, taabb, rays, t0, lo=None, hi=None):
    """-> ([n, nb] bool: the blocks the kernels' culled traversal tests for
    each ray, [n, nb] bool: the blocks of each ray's window masks, which its
    lane votes for). The traversal (csrc/trace_common.cuh::CtaCulledTris,
    WarpCulledTris) takes windows of WINDOW blocks, each block voted
    against the best t at the window's start (group box, then block box)
    and re-tested against the running best t. A closest-hit scan starts at
    t0 (the spheres' and planes' best) and lowers its bound at every
    block's nearest hit; an any-hit scan (lo, hi) keeps [0, hi] and stops
    after the block of its first blocker."""
    nb = T.n_blocks
    n = rays[0].shape[0]
    seen = torch.zeros((n, nb), dtype=torch.bool, device=rays[0].device)
    voted = torch.zeros_like(seen)
    t = (t0 if lo is None else hi).clone()  # the bound of the box tests
    scanning = torch.ones(n, dtype=torch.bool, device=t.device)
    col = lambda x: x[:, None] if torch.is_tensor(x) and x.dim() else x  # noqa: E731
    for w0 in range(0, nb, WINDOW):
        w1 = min(w0 + WINDOW, nb)
        boxes = torch.cat([taabb[:, w0:w1], taabb[:, nb + w0 // TRI_GROUP:nb + w1 // TRI_GROUP]], 1)
        meets = _box_meets(boxes, *rays, t)
        wm = meets[:, :w1 - w0] & meets[:, w1 - w0:].repeat_interleave(TRI_GROUP, 1) & scanning[:, None]
        voted[:, w0:w1] = wm
        for b in (w0 + wm.any(0).nonzero().squeeze(1)).tolist():  # the blocks some ray voted for
            k = wm[:, b - w0].nonzero().squeeze(1)
            ro = [x[k] for x in rays]
            if lo is None:
                met = _box_meets(taabb[:, b:b + 1], *ro, t[k])[:, 0]
                k, ro = k[met], [x[met] for x in ro]
                if k.numel() == 0:
                    continue
            seen[k, b] = True
            r = _block_rows(T, b)
            t_new, hit = _tri_t(r, slice(None), *(col(x) for x in ro))
            if lo is None:
                t[k] = torch.minimum(t[k], torch.where(hit, t_new, _INF).amin(1))
            else:
                blocked = (hit & (t_new > col(lo[k])) & (t_new < col(hi[k]))).any(1)
                scanning[k[blocked]] = False
    return seen, voted


def _union(sets: torch.Tensor, group: torch.Tensor, n_groups: int) -> float:
    """The number of blocks in the union of each group's rows of `sets`
    ([n, nb] bool; `group` [n], each row's warp or CTA), summed over
    groups."""
    acc = torch.zeros((n_groups, sets.shape[1]), dtype=torch.int32, device=sets.device)
    acc.index_add_(0, group, sets.to(torch.int32))
    return float((acc > 0).sum())


def _block_counts(work: "ChainWork", T: _HostTables, taabb, rays, active, warps: dict,
                  t_hi=None, t0=None, lo=None, hi=None) -> None:
    """Add one culled scan's block counts to `work`: a closest-hit scan
    (t_hi: the final hit's t, t0: the spheres' and planes' best) or an
    any-hit one (lo, hi). `warps`: map width -> (warp of each ray, warps)."""
    idx = active.nonzero().squeeze(1)
    if idx.numel() == 0:
        return
    ra = tuple(x[idx] for x in rays)
    closest = lo is None
    oracle = _oracle_blocks(taabb, T.n_blocks, ra, (t_hi if closest else hi)[idx])
    visit = (_visit_blocks(T, taabb, ra, t0[idx]) if closest
             else _visit_blocks(T, taabb, ra, None, lo[idx], hi[idx]))[0]
    n_o, n_v = float(oracle.sum()), float(visit.sum())
    work.lane_blocks += n_o
    work.visit_blocks += n_v
    if closest:
        work.closest_lane_blocks += n_o
        work.closest_visit_blocks += n_v
    for width, (warp, n_warps) in warps.items():
        w, c = warp[idx], warp[idx] // (CTA_THREADS // 32)
        add = lambda d, v: d.__setitem__(width, d.get(width, 0.0) + v)  # noqa: E731
        add(work.warp_blocks, 32.0 * _union(oracle, w, n_warps))
        add(work.warp_visit_blocks, 32.0 * _union(visit, w, n_warps))
        add(work.staged_blocks, _union(visit, c, n_warps // (CTA_THREADS // 32)))


def _sphere_plane(T: _HostTables, ox, oy, oz, dx, dy, dz, lo=None, hi=None):
    """The spheres' and planes' part of a scan: their best t (closest hit),
    or whether one blocks (lo, hi)."""
    best = torch.full_like(ox, _INF)
    occ = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    for table, n, test, *_ in _families(T, ox, oy, oz, dx, dy, dz):
        for b_lo, b_hi in prim_blocks(n, ox.shape[0]):
            t_new, hit = test(block_rows(table, b_lo, b_hi))
            if lo is None:
                tb = first_min(t_new, hit)[0]
                best = torch.where(tb < best, tb, best)
            else:
                occ = occ | (hit & (t_new > lo[:, None]) & (t_new < hi[:, None])).any(1)
    return best if lo is None else occ


def _test_ops(T: _HostTables, ox, oy, oz, dx, dy, dz, active, lo=None, hi=None,
              taabb=None, t_hit=None):
    """fp32 operations of one scan for each ray of `active` [R] bool, with the
    plain version's tests. With lo/hi it is an any-hit scan, which stops at
    the first primitive with lo < t < hi; else a closest-hit scan of every
    primitive. On culled tables (`taabb`) the triangles count as
    `_culled_ops` on [0, hi], or on [0, t_hit] for a closest-hit scan.
    Only the active rays are tested, the spheres and planes in blocks
    (each primitive's operations counted as the per-primitive scan counts
    them: integers, summed exactly)."""
    idx = active.nonzero().squeeze(1)
    if idx.numel() == 0:
        return 0.0
    sub = lambda x: x[idx] if torch.is_tensor(x) and x.dim() else x  # noqa: E731
    ox, oy, oz, dx, dy, dz, lo, hi, t_hit = map(sub, (ox, oy, oz, dx, dy, dz, lo, hi, t_hit))
    col = lambda x: x[:, None] if torch.is_tensor(x) and x.dim() else x  # noqa: E731
    scanning = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    ops = torch.full_like(ox, float(SCAN_SETUP))
    for table, n, test, past_exit, short, full in _families(T, ox, oy, oz, dx, dy, dz):
        for b_lo, b_hi in prim_blocks(n, ox.shape[0]):
            rows = block_rows(table, b_lo, b_hi)
            cost = torch.where(past_exit(rows), float(full), float(short))
            if lo is None:
                ops = ops + cost.sum(1)
                continue
            t_new, hit = test(rows)
            stop = hit & (t_new > col(lo)) & (t_new < col(hi))
            earlier = (stop.to(torch.int32).cumsum(1) - stop.to(torch.int32)) > 0
            ops = ops + torch.where(scanning[:, None] & ~earlier, cost, 0.0).sum(1)
            scanning = scanning & ~stop.any(1)
    if taabb is None:
        past_exit = _tri_past_exit(T, dx, dy, dz)
        for i in range(T.nt):
            ops = ops + torch.where(scanning, torch.where(past_exit(i), float(TRI_FULL),
                                                          float(TRI_PARALLEL)), 0.0)
            if lo is not None:
                t_new, hit = _tri_t(T.tri, i, ox, oy, oz, dx, dy, dz)
                scanning = scanning & ~(hit & (t_new > lo) & (t_new < hi))
    else:
        seg = hi if lo is not None else t_hit
        ops = ops + _culled_ops(T, taabb, ox, oy, oz, dx, dy, dz, scanning, seg)
    return float(ops.to(torch.float64).sum())


def warps_of_rays(n_rays: int, width: int, device=None) -> tuple[torch.Tensor, int]:
    """-> (the warp of each ray under the thread-to-ray map of `width`, the
    number of warps)."""
    threads = thread_rays(n_rays, width, device)
    warp = torch.empty(n_rays, dtype=torch.int64, device=device)
    valid = threads >= 0
    warp[threads[valid]] = valid.nonzero().squeeze(1) // 32
    return warp, threads.shape[0] // 32


@torch.no_grad()
def chain_work(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg,
               widths: tuple[int, ...] = ()) -> ChainWork:
    """Replay the opaque chain (the kernels' per-ray control flow) on these
    rays and count its scans and their operations, culled or linear as the
    tables are; on culled tables also the blocks per lane and, for each
    thread-to-ray map width in `widths`, per warp. A padded light slot
    (`active` 0: no emission, parked at 1e7) sends no shadow ray here:
    nothing the scene's gradient or frame reads depends on it, though the
    chain kernels still scan to it."""
    T = _HostTables(tables)
    one = torch.ones_like(o[:, 0])
    state = (*o.unbind(-1), *d.unbind(-1), one, one)
    work = ChainWork(rays=o.shape[0])
    bias = cfg.bias
    taabb = tables.taabb
    warps = {w: warps_of_rays(o.shape[0], w, o.device) for w in widths}
    for _ in range(cfg.max_depth):
        live = state[7] > 0.0
        if not bool(live.any()):
            break
        ox, oy, oz, dx, dy, dz = state[:6]
        work.bounces += int(live.sum())
        t, nx, ny, nz = _closest_hit(T, ox, oy, oz, dx, dy, dz, live)[:4]
        work.closest_ops += _test_ops(T, ox, oy, oz, dx, dy, dz, live, taabb=taabb, t_hit=t)
        if taabb is not None:
            _block_counts(work, T, taabb, state[:6], live, warps, t_hi=t,
                          t0=_sphere_plane(T, *state[:6]))
        shade = live & (t < _INF)
        flip = torch.where(nx * dx + ny * dy + nz * dz < 0.0, 1.0, -1.0)
        nx, ny, nz = nx * flip, ny * flip, nz * flip
        ts = torch.where(shade, t, 0.0)
        px, py, pz = ox + dx * ts, oy + dy * ts, oz + dz * ts
        for li in range(T.nl):
            if not T.light[6][li] > 0.0:
                continue
            vx, vy, vz = T.light[0][li] - px, T.light[1][li] - py, T.light[2][li] - pz
            dist = torch.sqrt((vx * vx + vy * vy + vz * vz).clamp_min(1e-30))
            ldx, ldy, ldz = vx / dist, vy / dist, vz / dist
            ok = shade & (dist > bias) & (nx * ldx + ny * ldy + nz * ldz > 0.0)
            work.shadow_rays += int(ok.sum())
            so = (px + nx * bias, py + ny * bias, pz + nz * bias, ldx, ldy, ldz)
            work.shadow_ops += _test_ops(T, *so, ok, lo=bias, hi=dist - bias, taabb=taabb)
            if taabb is not None:
                lo = torch.full_like(dist, bias)
                hi = dist - bias
                blocked = _sphere_plane(T, *so, lo=lo, hi=hi)
                _block_counts(work, T, taabb, so, ok & ~blocked, warps, lo=lo, hi=hi)
        state = state_bounce_dense(state, T, cfg)
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
    # beyond the tests (the module docstring):
    shade_ops: float = 0.0  # fp32: shading, light loop, node_children, march steps, camera
    mufu_ops: float = 0.0  # their sqrt, rsqrt, reciprocal, exp and log
    int_ops: float = 0.0  # the AA kernel's Philox jitter
    closest_scans: int = 0  # closest-hit and march scans, summed over rays
    closest_tris: float = 0.0  # real triangles those scans test, per lane
    # culled tables only, in blocks of TRI_BLOCK triangle tests, all scans:
    lane_blocks: float = 0.0  # per lane, the oracle's segments
    warp_blocks: float = 0.0  # 32 x the most blocks a lane of each warp of 32 rays meets, per scan
    visit_blocks: float = 0.0  # per lane, the kernels' traversal
    vote_blocks: float = 0.0  # per warp, the OR of its lanes' window masks, per scan

    def __iadd__(self, other: "WavefrontWork") -> "WavefrontWork":
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            setattr(self, f.name, max(a, b) if f.name == "max_pops" else a + b)
        return self

    @property
    def coop_blocks(self) -> float:
        """The warp-cooperative scan's turns: a turn of 128 tests for each
        block a lane visits, and a vote for each block of its warp's OR."""
        return self.visit_blocks + self.vote_blocks


class _WavefrontCounter:
    """The observer of trace_wavefront_plain that fills a WavefrontWork."""

    def __init__(self, tables: SceneTables, o: torch.Tensor):
        self.T = _HostTables(tables)
        self.taabb = tables.taabb
        self.work = WavefrontWork(rays=o.shape[0])
        self.pops = torch.zeros(o.shape[0], dtype=torch.long, device=o.device)
        self.n_warps = -(-o.shape[0] // 32)
        if tables.culled:  # real triangles per block
            self.block_tris = (tables.perm >= 0).reshape(-1, TRI_BLOCK).sum(1).to(torch.float64)

    def pop(self, live):
        self.pops += live.long()

    def _scan(self, rays, active, lo=None, hi=None, tris_active=None) -> float:
        """One scan's operations; on culled tables also its blocks per lane
        and per warp, for the rays of `tris_active` (default `active`: an
        any-hit scan's triangles go only for the rays no sphere or plane
        blocks). Adds a closest-hit scan's (lo None) real triangle tests to
        closest_tris."""
        if lo is None:
            self.work.closest_scans += int(active.sum())
        if self.taabb is None:
            if lo is None:
                self.work.closest_tris += float(self.T.nt * int(active.sum()))
            return _test_ops(self.T, *rays, active, lo=lo, hi=hi)
        t_hit = _closest_hit(self.T, *rays, active)[0] if lo is None else None
        ops = _test_ops(self.T, *rays, active, lo=lo, hi=hi, taabb=self.taabb, t_hit=t_hit)
        seg = t_hit if lo is None else hi
        idx = (active if tris_active is None else tris_active).nonzero().squeeze(1)
        votes = torch.zeros((self.n_warps, self.T.n_blocks), dtype=torch.int32, device=idx.device)
        chunk = 1 << 16  # rays per [chunk, boxes] test, to bound the memory
        for s in range(0, idx.shape[0], chunk):
            j = idx[s:s + chunk]
            ra = tuple(x[j] for x in rays)
            blocks = _oracle_blocks(self.taabb, self.T.n_blocks, ra, seg[j])
            per_lane = blocks.sum(1).to(torch.float64)
            busiest = torch.zeros(self.n_warps, dtype=torch.float64, device=per_lane.device)
            busiest.scatter_reduce_(0, j // 32, per_lane, "amax")
            self.work.lane_blocks += float(per_lane.sum())
            self.work.warp_blocks += 32.0 * float(busiest.sum())
            if lo is None:
                self.work.closest_tris += float((blocks.to(torch.float64) @ self.block_tris).sum())
                visit, voted = _visit_blocks(self.T, self.taabb, ra, _sphere_plane(self.T, *ra))
            else:
                visit, voted = _visit_blocks(self.T, self.taabb, ra, None, torch.full_like(ra[0], lo), hi[j])
            self.work.visit_blocks += float(visit.sum())
            votes.index_add_(0, j // 32, voted.to(torch.int32))
        self.work.vote_blocks += float((votes > 0).sum())
        return ops

    def closest(self, ox, oy, oz, dx, dy, dz, active):
        self.work.closest_ops += self._scan((ox, oy, oz, dx, dy, dz), active)

    def shade(self, sky, shade, sphere, children):
        n_sphere, n_children = int(sphere.sum()), int(children.sum())
        self.work.shade_ops += (SKY_NODE * int(sky.sum()) + SHADE_NODE * int(shade.sum())
                                + SPHERE_NORMAL * n_sphere + CHILDREN * n_children)
        self.work.mufu_ops += SPHERE_NORMAL_MUFU * n_sphere + CHILDREN_MUFU * n_children

    def shadow(self, ok):
        self.work.shadow_rays += int(ok.sum())

    def light(self, setup, lit, spec):
        n_setup, n_lit, n_spec = int(setup.sum()), int(lit.sum()), int(spec.sum())
        self.work.shade_ops += LIGHT_SETUP * n_setup + LIGHT_LIT * n_lit + LIGHT_SPEC * n_spec
        self.work.mufu_ops += LIGHT_SETUP_MUFU * n_setup + LIGHT_LIT_MUFU * n_lit + LIGHT_SPEC_MUFU * n_spec

    def march_step(self, ox, oy, oz, dx, dy, dz, live):
        n = int(live.sum())
        self.work.march_steps += n
        self.work.shadow_ops += self._scan((ox, oy, oz, dx, dy, dz), live)
        self.work.shade_ops += MARCH_STEP * n

    def any_hit(self, ox, oy, oz, dx, dy, dz, ok, lo, hi):
        rays = (ox, oy, oz, dx, dy, dz)
        tris_active = None
        if self.taabb is not None:
            blocked = _sphere_plane(self.T, *rays, lo=torch.full_like(ox, lo), hi=hi)
            tris_active = ok & ~blocked
        self.work.shadow_ops += self._scan(rays, ok, lo, hi, tris_active)


@torch.no_grad()
def wavefront_work(tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg,
                   camera_sample: int | None = None) -> WavefrontWork:
    """Replay the wavefront DFS (the kernels' per-ray control flow) on these
    rays and count its pops, scans, march steps, shading and their
    operations. With `camera_sample` the rays are that sample of the AA
    kernel, which builds each camera ray itself (and jitters samples past
    0): its operations count too, the per-pixel ones with sample 0."""
    counter = _WavefrontCounter(tables, o)
    trace_wavefront_plain(tables, o, d, cfg, observer=counter)
    work = counter.work
    work.pops = int(counter.pops.sum())
    work.max_pops = int(counter.pops.max()) if o.shape[0] else 0
    if camera_sample is not None:
        jittered = camera_sample > 0
        work.shade_ops += (CAMERA + CAMERA_PIXEL * (not jittered) + JITTER * jittered) * work.rays
        work.mufu_ops += CAMERA_MUFU * work.rays
        work.int_ops += PHILOX_INT * jittered * work.rays
    return work


def table_bytes(tables: SceneTables) -> int:
    """The tables' bytes, culling boxes included."""
    boxes = tables.taabb.numel() if tables.culled else 0
    return 4 * (sum(t.numel() for t in tables.tensors()) + boxes)


def trace_bytes(rays: int, tables: SceneTables, in_per_ray: int = 24) -> int:
    """Bytes a trace kernel must move: per ray its input (o and d, 24
    bytes; pixel coordinates, 8) and its HDR output (12), and the tables
    once."""
    return rays * (in_per_ray + 12) + table_bytes(tables)


def adjoint_bytes(rays: int, tables: SceneTables) -> int:
    """Bytes an adjoint kernel must move: per ray o, d and g in (36 bytes)
    and d_o, d_d out (24), the tables read and their cotangents written."""
    return rays * (36 + 24) + 2 * table_bytes(tables)


#: Bytes of the chain tape per bounce a ray takes and per ray
#: (csrc/trace_common.cuh::ChainTape: kStateRows and kTailRows floats).
TAPE_BOUNCE_BYTES, TAPE_RAY_BYTES = 40, 16


def chain_tape_bytes(work: ChainWork) -> int:
    """Bytes of the chain tape the taping forward writes for these rays
    (one entry per bounce taken, and each ray's end) and the head-box
    adjoint reads."""
    return TAPE_BOUNCE_BYTES * work.bounces + TAPE_RAY_BYTES * work.rays


def taped_adjoint_bytes(work: ChainWork, tables: SceneTables) -> int:
    """Bytes the head-box adjoint must move, fed from the forward's tape:
    per ray g in (12 bytes) and d_o, d_d out (24), the tape read, the
    tables read and their cotangents written. Its operations are the
    shadow scans alone (`work.shadow_ops`): the closest hits are the
    tape's."""
    return work.rays * (12 + 24) + chain_tape_bytes(work) + 2 * table_bytes(tables)


def work_ops(work: ChainWork | WavefrontWork) -> float:
    """The fp32 operations a call needs: its closest-hit scans and its
    shadow scans (any-hit or march). An adjoint needs the same scans as its
    forward; its own replays are choices of design and are not counted."""
    return work.closest_ops + work.shadow_ops


def wavefront_bound_ms(work: WavefrontWork, n_bytes: float) -> tuple[float, str]:
    """-> (least time in ms on an H100 SXM at 700 W for the glass kernels'
    counted work: their tests and shading on the fp32 pipe, their MUFU and
    integer operations on theirs, or their bytes; what sets it)."""
    times = {
        "fp32 operations": (work_ops(work) + work.shade_ops) / H100_FP32_OPS_PER_S,
        "MUFU operations": work.mufu_ops / H100_MUFU_OPS_PER_S,
        "integer operations": work.int_ops / H100_INT32_OPS_PER_S,
        "bytes": n_bytes / H100_BYTES_PER_S,
    }
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def bound_ms(ops: float, n_bytes: float) -> tuple[float, str]:
    """-> (least time in ms on an H100 SXM at 700 W, "operations" or "bytes")."""
    t_ops, t_bytes = ops / H100_FP32_OPS_PER_S, n_bytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
