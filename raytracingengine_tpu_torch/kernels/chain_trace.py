"""The opaque Whitted chain: scene tables, culling tables, plain version
and CUDA kernel.

One call traces [R,3] origins and directions to [R,3] HDR radiance. Each
bounce finds the closest hit over the sphere/plane/triangle tables, tests
binary shadows per light with an any-hit scan, shades with Blinn-Phong and
1/d^2 lights, returns the sky on a miss and follows the Schlick reflection
chain (opaque: reflectiveness = specular) to `max_depth`, pruned by
`min_weight`.

  * `pack_scene_tables` turns a FlatScene into the [rows, prims] float32
    tables both versions read. Padded slots hold primitives that can never
    hit: sphere r^2 = -1, plane n = 0, triangle e1 = e2 = 0; padded lights
    sit at 1e7 with emission 0 and active 0. An empty family is one
    all-zero column.
  * `pack_forward_tables_perm` adds the culling tables above TRI_BLOCK
    triangles: the triangles reordered into spatially compact blocks of
    TRI_BLOCK (the tightest of authoring, Morton and median-split order by
    summed block surface area), one AABB per block and per group of
    TRI_GROUP blocks, optionally ordered front to back along the mean ray
    direction, and row 12 = each triangle's original global index. The
    order and block boxes of the last mesh packed are kept with the bits of
    its geometry (`_culled_order`), so the frames of an unchanged mesh
    skip the candidate orders.
  * `trace_chain_plain` is the plain PyTorch version, vectorised over rays
    with Python loops over primitives, lights and depth. On culled tables
    it scans the packed triangles by runs of whole blocks of TRI_BLOCK
    (`culled_runs`: one block at a time for many rays) as [R, run]
    tensors, with no culling, and takes the lexicographic minimum of
    (t, original index): the same winner as a scan in authoring order with
    strict < (Scene.h:218-257), whatever the visit order.
  * `chain_trace` is the wrapper: for CPU tensors it calls the plain
    version; for CUDA tensors it launches csrc/chain_trace.cu and counts
    the launch in `chain_trace.launches`. On culled tables the kernel's
    CTAs traverse the boxes together and stage the blocks their rays meet
    in shared memory; each ray skips every group and block whose box its
    segment misses (csrc/trace_common.cuh), which changes no result.
  * The trace kernels choose their scan by the tables
    (csrc/trace_common.cuh::trace_route) and report it: "culled" for
    culled tables; for linear ones "staged" where their 16-byte stage fits
    the kernels' limit, the CTA copying them into shared memory once and
    each thread tracing a packet of rays (neighbouring rays in
    chain_trace, samples of one pixel in spp_trace), else "in_place", one
    ray per thread reading the tables where they lie. The wrappers count
    launches per route in `routes` (names: ROUTES). The staged scans stop
    each family at its last live slot, so padded slots past it cost no
    test; `stage_extents` reads those extents back (tests, chip scripts).
  * `chain_trace(..., tape=True)` (CUDA tensors, linear tables) runs the
    route's taping kernel, which also writes each ray's bounces to the
    chain tape (csrc/trace_common.cuh::ChainTape, sized by the library) for
    the head-box adjoint kernels/chain_grad.py::chain_grad; the frame is the
    same. The plain adjoint checkpoints itself, so the CPU has no tape.
  * `thread_rays` mirrors the chain kernels' thread-to-ray map: the
    identity (width 0), or, for the head-box adjoint given the ray block's
    image width, 32x4 pixel tiles, one row of 32 per warp.

It replaces raytracingengine_tpu/kernels/chain_trace.py::chain_trace_pallas
(its per-ray body `_trace_tile`, `_closest_hit` and `_any_hit`, culled above
TRI_BLOCK triangles) and chain_trace_streamed_pallas, the same scan with
the triangles read from HBM past the TPU's SMEM: here every table is read
from device memory at every size, so one kernel does both.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import EPS, FlatScene
from raytracingengine_tpu_torch.kernels import _build
from raytracingengine_tpu_torch.utils.profiling import spanned

#: Miss sentinel for the closest-hit distance.
_INF = 3.0e38

#: Triangles per culling block, and blocks per group (the scan's two levels).
TRI_BLOCK = 128
TRI_GROUP = 8
#: Row 12 of culled tables holds each triangle's global index as float32,
#: exact below 2^24: the tie-break and the material lookup need it exact.
MAX_INDEX = 2**24
#: The box of an empty block or group: a far point that no segment reaches.
_FAR = 2.0e38
#: Row 12 of a padded triangle column: loses every tie.
_PAD_INDEX = float(2**30)
#: Threads of a chain kernel's CTA, and a CTA's pixel tile (width x height)
#: under the tile map (`thread_rays`; csrc/chain_grad.cu kTileW, kTileH).
CTA_THREADS = 128
CTA_TILE = (32, 4)
#: The trace kernels' scans by the code their entry points report
#: (csrc/trace_common.cuh::Route).
ROUTES = ("in_place", "culled", "staged")


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Float32 tables, one column per primitive (rows as in the JAX
    package's pack_scene_tables):

    sph [4, S]: center xyz, r^2        pl [4, P]: unit normal xyz, p.n
    tri [12, T]: v0, e1, e2, unit normal
    mat [7, N]: albedo rgb, specular, shininess, transparency, ior
    light [7, L]: position xyz, emission rgb, active flag

    Culled tables (`pack_forward_tables_perm`) also carry
    tri [13, NT_pad]: the columns in scan order, row 12 the original
    global index (float32), padded columns degenerate with index 2^30;
    taabb [6, n_blocks + n_groups]: lo xyz, hi xyz of each block, then of
    each group; perm [NT_pad] int64: the authoring triangle of each scan
    column, -1 on padding. taabb and perm are values only (no gradient).
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
    taabb: torch.Tensor | None = None
    perm: torch.Tensor | None = None

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_planes + self.n_triangles

    @property
    def culled(self) -> bool:
        return self.taabb is not None

    @property
    def n_blocks(self) -> int:
        """Culling blocks of the tri table (0 for tables that are not culled)."""
        return n_culling_blocks(self.n_triangles) if self.culled else 0

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
# Culling tables
# ---------------------------------------------------------------------------


def n_culling_blocks(nt: int) -> int:
    """Culling blocks for nt triangles, padded to whole groups: the width
    contract between the packing (degenerate triangles, far-point blocks)
    and the kernel's group and block loops."""
    nb = -(-nt // TRI_BLOCK)
    return -(-nb // TRI_GROUP) * TRI_GROUP


def pack_tri_aabbs(flat: FlatScene, perm=None) -> torch.Tensor:
    """Per-block triangle AABBs [6, ceil(nt / TRI_BLOCK)] (lo xyz, hi xyz) of
    the triangles in `perm` order. Inactive and padded triangles add
    nothing; boxes are inflated by 1e-5 of their extent plus 1e-5, so the
    slab test's fp32 rounding cannot exclude a grazing hit; an empty block
    is a far-point box (2e38), which every ray misses."""
    dev = flat.tri_v0.device
    nt = flat.n_triangles
    if nt == 0:
        return torch.zeros((6, 1), dtype=torch.float32, device=dev)
    v0 = flat.tri_v0.detach()
    v1 = v0 + flat.tri_e1.detach()
    v2 = v0 + flat.tri_e2.detach()
    act = flat.tri_active[:, None]
    if perm is not None:
        v0, v1, v2, act = v0[perm], v1[perm], v2[perm], act[perm]
    los = torch.where(act, torch.minimum(torch.minimum(v0, v1), v2), _INF)
    his = torch.where(act, torch.maximum(torch.maximum(v0, v1), v2), -_INF)
    n_blocks = -(-nt // TRI_BLOCK)
    pad = n_blocks * TRI_BLOCK - nt
    los = F.pad(los, (0, 0, 0, pad), value=_INF)
    his = F.pad(his, (0, 0, 0, pad), value=-_INF)
    lo = los.reshape(n_blocks, TRI_BLOCK, 3).amin(1)
    hi = his.reshape(n_blocks, TRI_BLOCK, 3).amax(1)
    eps = (hi - lo).clamp_min(0.0) * 1e-5 + 1e-5
    lo, hi = lo - eps, hi + eps
    empty = (lo > hi).any(1, keepdim=True)
    lo = torch.where(empty, _FAR, lo)
    hi = torch.where(empty, _FAR, hi)
    return torch.cat([lo.T, hi.T], 0).to(torch.float32)


def pack_group_aabbs(taabb: torch.Tensor) -> torch.Tensor:
    """Group AABBs [6, n_groups] over runs of TRI_GROUP block boxes. Empty
    (far-point) blocks never widen a group box; an all-empty group is a
    far-point box itself."""
    lo, hi = taabb[:3], taabb[3:]
    empty = (lo > hi).any(0) | (lo[0] >= 1.0e38)
    lo_m = torch.where(empty[None], _INF, lo)
    hi_m = torch.where(empty[None], -_INF, hi)
    n_blocks = taabb.shape[1]
    n_groups = -(-n_blocks // TRI_GROUP)
    pad = n_groups * TRI_GROUP - n_blocks
    lo_m = F.pad(lo_m, (0, pad), value=_INF)
    hi_m = F.pad(hi_m, (0, pad), value=-_INF)
    glo = lo_m.reshape(3, n_groups, TRI_GROUP).amin(2)
    ghi = hi_m.reshape(3, n_groups, TRI_GROUP).amax(2)
    gempty = (glo > ghi).any(0, keepdim=True)
    glo = torch.where(gempty, _FAR, glo)
    ghi = torch.where(gempty, _FAR, ghi)
    return torch.cat([glo, ghi], 0)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x three apart (Morton code)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _centroids(flat: FlatScene) -> torch.Tensor:
    return flat.tri_v0.detach() + (flat.tri_e1.detach() + flat.tri_e2.detach()) / 3.0


def triangle_morton_perm(flat: FlatScene) -> torch.Tensor:
    """Triangle order by the 30-bit Morton code of the quantised centroid
    (stable: equal cells keep authoring order; inactive triangles last)."""
    c = _centroids(flat)
    act = flat.tri_active
    lo = torch.where(act[:, None], c, _INF).amin(0)
    hi = torch.where(act[:, None], c, -_INF).amax(0)
    span = (hi - lo).clamp_min(1e-20)
    q = ((c - lo) / span * 1023.0).clamp(0.0, 1023.0).to(torch.int32)
    code = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    key = torch.where(act, code, 0x40000000)
    return torch.argsort(key, stable=True)


def triangle_split_perm(flat: FlatScene) -> torch.Tensor:
    """Triangle order of a recursive median split: ceil(log2(blocks)) + 1
    levels, each splitting every group at the median of its widest centroid
    axis; inactive triangles last. `scatter_reduce` and `bincount` stand for
    the JAX package's segment reductions."""
    nt = flat.n_triangles
    c = _centroids(flat)
    act = flat.tri_active
    dev = c.device
    n_blocks = -(-nt // TRI_BLOCK)
    levels = max(1, int(math.ceil(math.log2(max(n_blocks, 1)))) + 1)
    big = 3.0e38
    order = torch.arange(nt, device=dev)
    g = torch.zeros(nt, dtype=torch.int64, device=dev)
    cm = torch.where(act[:, None], c, big)
    cM = torch.where(act[:, None], c, -big)
    for lvl in range(levels):
        ng = 1 << lvl
        idx = g[:, None].expand(-1, 3)
        lo = torch.full((ng, 3), math.inf, device=dev).scatter_reduce(0, idx, cm, "amin")
        hi = torch.full((ng, 3), -math.inf, device=dev).scatter_reduce(0, idx, cM, "amax")
        ext = torch.where(hi >= lo, hi - lo, 0.0)
        axis = torch.argmax(ext, dim=1)  # widest axis per group, first on a tie
        v = c.gather(1, axis[g][:, None])[:, 0]
        v = torch.where(act, v, big)
        ordv = torch.argsort(v, stable=True)
        order = ordv[torch.argsort(g[ordv], stable=True)]  # by (group, v)
        gs = g[order]
        counts = torch.bincount(g, minlength=ng)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(nt, device=dev) - starts[gs]
        child = (rank >= (counts[gs] + 1) // 2).to(torch.int64)
        g = torch.empty_like(g)
        g[order] = gs * 2 + child
    inactive_last = 1 - act[order].to(torch.int64)
    return order[torch.argsort(inactive_last, stable=True)]


def _block_sa_sum(taabb: torch.Tensor) -> torch.Tensor:
    """Summed surface area of the block boxes (a ray meets a box with a
    chance ~ its area); far-point boxes have none."""
    e = (taabb[3:] - taabb[:3]).clamp_min(0.0)
    return (2.0 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2])).sum()


#: The last geometry `_culled_order` ordered: (its key, order, block boxes).
_LAST_ORDER: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _geometry_key(flat: FlatScene) -> torch.Tensor:
    """The bits of everything the culled order reads: each triangle's v0,
    e1, e2 and active flag."""
    v = torch.cat([flat.tri_v0.detach(), flat.tri_e1.detach(), flat.tri_e2.detach()], 1)
    bits = v.view(_BITS[v.element_size()])
    return torch.cat([bits, flat.tri_active[:, None].to(bits.dtype)], 1)


def _culled_order(flat: FlatScene) -> tuple[torch.Tensor, torch.Tensor]:
    """(the triangle order of least summed block surface area among
    authoring, Morton and median-split order, its block boxes
    [6, ceil(nt / TRI_BLOCK)]). The last result is kept with the bits of
    its geometry: frames of an unchanged mesh take it back after one
    comparison instead of the candidates' few hundred small operators."""
    key = _geometry_key(flat)
    if _LAST_ORDER:
        k, order0, taabb = _LAST_ORDER[0]
        if k.shape == key.shape and k.dtype == key.dtype and k.device == key.device \
                and torch.equal(k, key):
            return order0, taabb
    cands = torch.stack([
        torch.arange(flat.n_triangles, device=key.device), triangle_morton_perm(flat),
        triangle_split_perm(flat),
    ])
    aabbs = torch.stack([pack_tri_aabbs(flat, perm=p) for p in cands])
    best = torch.argmin(torch.stack([_block_sa_sum(a) for a in aabbs]))
    order0, taabb = cands[best], aabbs[best]
    _LAST_ORDER[:] = [(key, order0, taabb)]
    return order0, taabb


def pack_forward_tables_perm(flat: FlatScene, dmean: torch.Tensor | None = None) -> SceneTables:
    """FlatScene -> the culled tables of the forward kernels and the dense
    adjoint (`SceneTables` with tri [13, NT_pad], taabb and perm); at most
    TRI_BLOCK triangles, the plain `pack_scene_tables`, which the kernels
    scan linearly.

    The triangles take whichever of authoring, Morton and median-split
    order gives the smallest summed block surface area, are padded to whole
    groups (n_culling_blocks), and, with `dmean` (the unit mean ray
    direction), are ordered front to back along it: groups by their nearest
    block, and blocks within each group likewise, so the group boxes keep
    their members; far-point blocks last. The result does not depend on
    the order: the closest hit takes the lexicographic minimum of (t,
    original index). The reordered triangle rows are `tri[:, perm]` of the
    differentiable tables, so autograd carries their cotangents back to
    authoring order; taabb, perm, row 12 and dmean are values only."""
    tables = pack_scene_tables(flat)
    nt = flat.n_triangles
    if nt <= TRI_BLOCK:
        return tables
    if flat.n_spheres + flat.n_planes + nt > MAX_INDEX:
        raise NotImplementedError(
            f"culled tables index primitives in float32, exact up to {MAX_INDEX}; "
            f"{flat.n_spheres + flat.n_planes + nt} here"
        )
    dev = tables.tri.device
    with torch.no_grad():
        order0, taabb = _culled_order(flat)
        n_blocks = n_culling_blocks(nt)
        taabb = F.pad(taabb, (0, n_blocks - taabb.shape[1]), value=_FAR)
        pad = n_blocks * TRI_BLOCK - nt
        base = flat.n_spheres + flat.n_planes
        gi = F.pad((base + order0).to(torch.float32), (0, pad), value=_PAD_INDEX)
        perm = F.pad(order0, (0, pad), value=-1)
        blk = None
        if dmean is not None:
            dm = dmean.detach().to(torch.float32)
            c = (taabb[:3] + taabb[3:]) * 0.5
            key = dm[0] * c[0] + dm[1] * c[1] + dm[2] * c[2]
            key = torch.where(taabb[0] >= 1.0e38, 3.0e38, key)
            ng = n_blocks // TRI_GROUP
            kg = key.reshape(ng, TRI_GROUP)
            within = torch.argsort(kg, dim=1, stable=True)
            go = torch.argsort(kg.amin(1), stable=True)
            order = (torch.arange(ng, device=dev)[:, None] * TRI_GROUP + within)[go].reshape(-1)
            taabb = taabb[:, order]
            blk = (order[:, None] * TRI_BLOCK + torch.arange(TRI_BLOCK, device=dev)[None, :]).reshape(-1)
            gi, perm = gi[blk], perm[blk]
        taabb = torch.cat([taabb, pack_group_aabbs(taabb)], 1)
    tri = F.pad(tables.tri[:, order0], (0, pad))
    if blk is not None:
        tri = tri[:, blk]
    tri = torch.cat([tri, gi[None]], 0)
    return dataclasses.replace(tables, tri=tri, taabb=taabb, perm=perm)


def linear_tables(tables: SceneTables) -> SceneTables:
    """The linear tables of culled ones: the tri rows back in authoring
    order, `pack_scene_tables`' values bit for bit. It is a gather of the
    culled tri rows, so autograd carries cotangents of the result back
    through `pack_forward_tables_perm` (the glass adjoint, which scans in
    authoring order, takes these while the forward scans the culled
    tables)."""
    if not tables.culled:
        return tables
    scan = torch.nonzero(tables.perm >= 0).squeeze(1)
    col = torch.empty_like(scan)
    col[tables.perm[scan]] = scan  # the scan column of each authoring triangle
    return dataclasses.replace(tables, tri=tables.tri[:12, col], taabb=None, perm=None)


# ---------------------------------------------------------------------------
# The chain kernels' thread-to-ray map
# ---------------------------------------------------------------------------


def map_ctas(n_rays: int, width: int) -> int:
    """CTAs of a chain kernel's launch over n_rays rays (csrc/chain_grad.cu::
    map_ctas): one per CTA_THREADS rays for width 0, else one per CTA_TILE
    tile of the rows of `width` rays that hold them."""
    if width <= 0:
        return -(-n_rays // CTA_THREADS)
    rows = -(-n_rays // width)
    return -(-width // CTA_TILE[0]) * -(-rows // CTA_TILE[1])


def thread_rays(n_rays: int, width: int, device=None) -> torch.Tensor:
    """int64 [map_ctas * CTA_THREADS]: the ray each thread of a chain kernel
    traces, in (CTA, thread) order, -1 for a thread with none. Width 0
    (every chain kernel; csrc/trace_common.cuh::ray_of_thread): thread t of
    CTA c takes ray CTA_THREADS c + t; on chain_trace's staged route each
    thread takes the next rays in the same order, as a packet
    (csrc/chain_trace.cu::kChainPacket). Else (the head-box adjoint;
    csrc/chain_grad.cu::ray_of_tile_thread) the rays are rows of `width`
    pixels, cut into CTA_TILE tiles in row-major order; thread t of a CTA
    takes the pixel (t % CTA_TILE[0], t // CTA_TILE[0]) of its tile, and
    the ray is row * width + column; a pixel past the width or past the
    last ray has none. Each ray is taken by exactly one thread, so warps of
    32 consecutive entries are the kernel's warps."""
    n_ctas = map_ctas(n_rays, width)
    t = torch.arange(n_ctas * CTA_THREADS, dtype=torch.int64, device=device)
    if width <= 0:
        return torch.where(t < n_rays, t, -1)
    c, k = t // CTA_THREADS, t % CTA_THREADS
    tiles_x = -(-width // CTA_TILE[0])
    x = (c % tiles_x) * CTA_TILE[0] + k % CTA_TILE[0]
    y = (c // tiles_x) * CTA_TILE[1] + k // CTA_TILE[0]
    i = y * width + x
    return torch.where((x < width) & (i < n_rays), i, -1)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


class _HostTables:
    """The tables for the plain scans. The light table and a tri table that
    is not culled as Python floats (one device-to-host copy per trace, so
    their per-primitive loops read scalars without a sync each; float32
    values are exact as Python floats and round back exactly in tensor
    ops); the sphere and plane tables (`sph_t`, `pl_t`, scanned in blocks of
    columns) and a culled tri table (`tri_t`, block by block over [R,
    TRI_BLOCK] tensors) stay tensors on the ray device."""

    def __init__(self, t: SceneTables):
        self.light = t.light.detach().cpu().tolist()
        self.sph_t, self.pl_t = t.sph.detach(), t.pl.detach()
        self.culled = t.culled
        self.tri = None if t.culled else t.tri.detach().cpu().tolist()
        self.tri_t = t.tri.detach()
        self.n_blocks = t.n_blocks
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


def _block_rows(T: _HostTables, b: int, n: int = 1) -> list[torch.Tensor]:
    """Rows [1, n * TRI_BLOCK] of the culling blocks b .. b + n - 1 of the
    tri table."""
    cols = slice(b * TRI_BLOCK, (b + n) * TRI_BLOCK)
    return [T.tri_t[r, cols][None, :] for r in range(13)]


#: Ray-primitive pairs per tensor of the plain scans' blocked sphere and
#: plane tests ([R, b] tensors of b <= 128 columns; fewer columns for many
#: rays), so a scene of thousands of spheres scans in few tensor ops.
_SCAN_PAIRS = 1 << 24


def prim_blocks(n: int, rays: int) -> list[tuple[int, int]]:
    """Column ranges [lo, hi) covering n primitives, in order, in blocks of
    at most 128 and of at most _SCAN_PAIRS // rays."""
    b = max(1, min(TRI_BLOCK, _SCAN_PAIRS // max(rays, 1)))
    return [(lo, min(lo + b, n)) for lo in range(0, n, b)]


def culled_runs(n_blocks: int, rays: int) -> list[tuple[int, int]]:
    """(first block, blocks) runs covering a culled tri table in order, each
    at most max(1, _SCAN_PAIRS // (rays * TRI_BLOCK)) whole blocks: the
    plain scans' tensors of [rays, blocks * TRI_BLOCK]."""
    k = max(1, _SCAN_PAIRS // (max(rays, 1) * TRI_BLOCK))
    return [(b, min(k, n_blocks - b)) for b in range(0, n_blocks, k)]


def block_rows(table: torch.Tensor, lo: int, hi: int) -> list[torch.Tensor]:
    """Rows [1, hi - lo] of the columns lo .. hi - 1 of a table: the
    per-primitive tests of _sphere_t and _plane_t take them with i = all
    columns and [R, 1] rays, elementwise the same arithmetic."""
    return [table[r, lo:hi][None, :] for r in range(table.shape[0])]


def first_min(t_new: torch.Tensor, hit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, b] distances and hits -> (each ray's smallest hit distance, _INF
    on none; its column, the first of a tie): the per-primitive strict <
    scan's winner within a block."""
    tb = torch.where(hit, t_new, _INF)
    j = tb.argmin(1)
    return tb.gather(1, j[:, None])[:, 0], j


def _compact(active, *xs):
    """-> (indices of the active lanes, each x at them); all lanes when
    `active` is None."""
    if active is None:
        return None, xs
    idx = active.nonzero().squeeze(1)
    return idx, tuple(x[idx] if torch.is_tensor(x) and x.dim() else x for x in xs)


def _closest_scan_pos(T: _HostTables, ox, oy, oz, dx, dy, dz, active=None):
    """Closest hit -> (t, nx, ny, nz, gi, pos); t >= _INF means miss, gi is
    the winner's global index (spheres, planes, triangles in authoring
    order) and pos the tri table column of a winning triangle (else 0).
    Every hit field updates under ONE `closer` predicate, so an exact edge
    hit cannot update t without its normal and material.

    Spheres and planes go in blocks of columns (`prim_blocks`), each
    block's first smallest hit against the best so far, strict < first-wins:
    the per-primitive scan's winner. The triangles of plain tables go one
    primitive at a time, the same rule. Culled triangles go a run of whole
    blocks at a time (`culled_runs`), each lane taking the run's
    lexicographic minimum of (t, original index) against its best so far,
    so the winner is the authoring-order scan's. Only the lanes of `active`
    scan them (the others keep their sphere and plane hits, which the
    caller masks)."""
    t = torch.full_like(ox, _INF)
    nx, ny, nz = torch.zeros_like(ox), torch.zeros_like(ox), torch.zeros_like(ox)
    gi = torch.zeros(ox.shape, dtype=torch.long, device=ox.device)
    pos = torch.zeros_like(gi)
    a_coef = dx * dx + dy * dy + dz * dz  # d.d (Shape.h:75)

    def upd(t_new, hit, n3, g, p=0):
        nonlocal t, nx, ny, nz, gi, pos
        closer = hit & (t_new < t)
        t = torch.where(closer, t_new, t)
        nx = torch.where(closer, n3[0], nx)
        ny = torch.where(closer, n3[1], ny)
        nz = torch.where(closer, n3[2], nz)
        gi = torch.where(closer, g, gi)
        pos = torch.where(closer, p, pos)

    rays = tuple(x[:, None] for x in (ox, oy, oz, dx, dy, dz))
    for lo, hi in prim_blocks(T.ns, ox.shape[0]):
        t_new, j = first_min(*_sphere_t(block_rows(T.sph_t, lo, hi), slice(None), a_coef[:, None], *rays))
        c = T.sph_t[:3, lo + j]  # the block winners' centres
        gx = ox + dx * t_new - c[0]
        gy = oy + dy * t_new - c[1]
        gz = oz + dz * t_new - c[2]
        inv = torch.rsqrt((gx * gx + gy * gy + gz * gz).clamp_min(1e-24))
        upd(t_new, t_new < _INF, (gx * inv, gy * inv, gz * inv), lo + j)
    for lo, hi in prim_blocks(T.np, ox.shape[0]):
        t_new, j = first_min(*_plane_t(block_rows(T.pl_t, lo, hi), slice(None), *rays))
        n = T.pl_t[:3, lo + j]
        upd(t_new, t_new < _INF, (n[0], n[1], n[2]), T.ns + lo + j)
    if not T.culled:
        for i in range(T.nt):
            t_new, hit = _tri_t(T.tri, i, ox, oy, oz, dx, dy, dz)
            upd(t_new, hit, (T.tri[9][i], T.tri[10][i], T.tri[11][i]), T.ns + T.np + i, i)
        return t, nx, ny, nz, gi, pos
    idx, (bt, bnx, bny, bnz, bgi, box, boy, boz, bdx, bdy, bdz) = _compact(
        active, t, nx, ny, nz, gi, ox, oy, oz, dx, dy, dz)
    bg = bgi.to(torch.float32)  # the original index of the best so far
    bpos = torch.zeros_like(bgi)
    col = lambda x: x[:, None]  # noqa: E731
    for b, n in culled_runs(T.n_blocks, box.shape[0]):
        rows = _block_rows(T, b, n)
        t_new, hit = _tri_t(rows, slice(None), col(box), col(boy), col(boz), col(bdx), col(bdy), col(bdz))
        tb = torch.where(hit, t_new, _INF)
        tmin = tb.amin(1)
        cand = hit & (tb == col(tmin))
        gmin = torch.where(cand, rows[12], _INF).amin(1)
        j = (cand & (rows[12] == col(gmin))).to(torch.int8).argmax(1) + b * TRI_BLOCK
        closer = cand.any(1) & ((tmin < bt) | ((tmin == bt) & (gmin < bg)))
        bt = torch.where(closer, tmin, bt)
        bnx = torch.where(closer, T.tri_t[9][j], bnx)
        bny = torch.where(closer, T.tri_t[10][j], bny)
        bnz = torch.where(closer, T.tri_t[11][j], bnz)
        bg = torch.where(closer, gmin, bg)
        bpos = torch.where(closer, j, bpos)
    bgi = bg.to(torch.long)
    if idx is None:
        return bt, bnx, bny, bnz, bgi, bpos
    out = [x.clone() for x in (t, nx, ny, nz, gi, pos)]
    for x, v in zip(out, (bt, bnx, bny, bnz, bgi, bpos)):
        x[idx] = v
    return tuple(out)


def _closest_scan(T: _HostTables, ox, oy, oz, dx, dy, dz):
    """`_closest_scan_pos` without the column -> (t, nx, ny, nz, gi)."""
    return _closest_scan_pos(T, ox, oy, oz, dx, dy, dz)[:5]


def _closest_hit(T: _HostTables, ox, oy, oz, dx, dy, dz, active=None):
    """Closest hit -> (t, nx, ny, nz, ar, ag, ab, spec, shin); t >= _INF
    means miss."""
    t, nx, ny, nz, gi, _ = _closest_scan_pos(T, ox, oy, oz, dx, dy, dz, active)
    m = T.mat_t[:, gi]  # [7, R]; miss lanes read column 0 and are masked
    return t, nx, ny, nz, m[0], m[1], m[2], m[3], m[4]


def _any_hit(T: _HostTables, ox, oy, oz, dx, dy, dz, lo, hi, active=None):
    """Binary occlusion: any primitive with lo < t < hi (per lane). On
    culled tables the triangles go by runs of whole blocks (`culled_runs`)
    as [R, blocks * TRI_BLOCK] tensors, for the lanes of `active` only."""
    occ = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    a_coef = dx * dx + dy * dy + dz * dz
    rays = tuple(x[:, None] for x in (ox, oy, oz, dx, dy, dz))
    col = lambda x: x[:, None] if torch.is_tensor(x) and x.dim() else x  # noqa: E731
    for table, test in ((T.sph_t, lambda rows: _sphere_t(rows, slice(None), a_coef[:, None], *rays)),
                        (T.pl_t, lambda rows: _plane_t(rows, slice(None), *rays))):
        n = T.ns if table is T.sph_t else T.np
        for b_lo, b_hi in prim_blocks(n, ox.shape[0]):
            t_new, hit = test(block_rows(table, b_lo, b_hi))
            occ = occ | (hit & (t_new > col(lo)) & (t_new < col(hi))).any(1)
    if not T.culled:
        for i in range(T.nt):
            t_new, hit = _tri_t(T.tri, i, ox, oy, oz, dx, dy, dz)
            occ = occ | (hit & (t_new > lo) & (t_new < hi))
    if not T.culled:
        return occ
    idx, (box, boy, boz, bdx, bdy, bdz, blo, bhi) = _compact(active, ox, oy, oz, dx, dy, dz, lo, hi)
    bocc = torch.zeros(box.shape, dtype=torch.bool, device=ox.device)
    for b, n in culled_runs(T.n_blocks, box.shape[0]):
        t_new, hit = _tri_t(_block_rows(T, b, n), slice(None), col(box), col(boy), col(boz),
                            col(bdx), col(bdy), col(bdz))
        bocc = bocc | (hit & (t_new > col(blo)) & (t_new < col(bhi))).any(1)
    if idx is None:
        return occ | bocc
    occ = occ.clone()
    occ[idx] |= bocc
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
        t, nx, ny, nz, ar, ag, ab, spec, shin = _closest_hit(T, ox, oy, oz, dx, dy, dz, live)
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
                    T, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias, ok
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


def check_tables(tables: SceneTables, device: torch.device, culled_ok: bool = False) -> None:
    """Raise unless every table is a contiguous float32 [rows, >=1] tensor
    on `device` with at least as many columns as its primitive count, and,
    for culled tables (only where `culled_ok`), the tri table is [13,
    n_culling_blocks * TRI_BLOCK] and taabb [6, n_blocks + n_groups]."""
    if tables.culled and not culled_ok:
        raise ValueError("culled tables (pack_forward_tables_perm) reach only the trace kernels "
                         "(chain_trace, spp_trace, wavefront_trace, wavefront_spp_trace) and "
                         "chain_grad_dense; the other adjoints take linear_tables(tables)")
    nb = tables.n_blocks
    rows = (4, 4, 13 if tables.culled else 12, 7, 7)
    counts = (
        tables.n_spheres, tables.n_planes, max(tables.n_triangles, nb * TRI_BLOCK),
        tables.n_primitives, tables.n_lights,
    )
    for name, t, r, n in zip(("sph", "pl", "tri", "mat", "light"), tables.tensors(), rows, counts):
        if t.device != device:
            raise ValueError(f"table {name} is on {t.device}, rays on {device}")
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != r:
            raise ValueError(f"table {name}: expected float32 [{r}, n], got {t.dtype} {tuple(t.shape)}")
        if t.shape[1] < max(n, 1) or not t.is_contiguous():
            raise ValueError(f"table {name}: {tuple(t.shape)} for {n} primitives, contiguous={t.is_contiguous()}")
    if tables.culled:
        a = tables.taabb
        want = (6, nb + nb // TRI_GROUP)
        if tables.tri.shape[1] != nb * TRI_BLOCK or a.device != device or a.dtype != torch.float32 \
                or tuple(a.shape) != want or not a.is_contiguous():
            raise ValueError(f"culled tables: tri {tuple(tables.tri.shape)}, taabb {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}; expected [13, {nb * TRI_BLOCK}] "
                             f"and contiguous float32 {want}")


def pallas_applicable(cfg, mode: str) -> bool:
    """Does a trace kernel cover (config, mode)? Chain mode: the chain
    kernels, with binary shadows only (on the opaque scenes chain mode is
    chosen for, the march is binary; a caller forcing chain mode on a
    transparent scene keeps the march on the integrator). Wavefront mode:
    the wavefront kernels (kernels/wavefront_trace.py), with binary or
    march shadows and a stack of max_depth + 2 nodes within the MAX_CAP
    they compile; deeper trees go to the integrator, as the JAX package
    routes past its own ceilings. The JAX package's primitive ceiling is
    its TPU's SMEM size; these kernels read the tables from device memory
    and have none."""
    if mode == "chain":
        return cfg.shadow_mode == "binary"
    if mode == "wavefront":
        from raytracingengine_tpu_torch.kernels.wavefront_trace import MAX_CAP

        return cfg.shadow_mode in ("binary", "march") and cfg.max_depth + 2 <= MAX_CAP
    return False


def check_no_grad(*tensors: torch.Tensor) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA trace kernels are forward-only: a CUDA input requires "
            "grad; differentiate through kernels.chain_grad.chain_trace_fused "
            "(render_hdr's per-sample loop at spp > 1), whose backward is the adjoint kernel"
        )


def _check_rays(o: torch.Tensor, d: torch.Tensor) -> None:
    for name, t in (("o", o), ("d", d)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: expected float32 [R, 3], got {t.dtype} {tuple(t.shape)}")
    if o.shape != d.shape or o.device != d.device:
        raise ValueError(f"o {tuple(o.shape)} on {o.device} vs d {tuple(d.shape)} on {d.device}")


def check_width(width: int) -> None:
    if not isinstance(width, int) or width < 0:
        raise ValueError(f"width: expected an int >= 0 (0 for the identity map), got {width!r}")


@spanned("rte.launch.chain_trace")
def chain_trace(
    tables: SceneTables, o: torch.Tensor, d: torch.Tensor, cfg, tape: bool = False
):
    """[R,3] origins/directions -> [R,3] HDR radiance; with `tape`, ->
    (radiance, chain tape) for chain_grad.

    CPU tensors run `trace_chain_plain`; CUDA tensors launch the CUDA
    kernel (csrc/chain_trace.cu) on the current stream and counts the scan
    it reports in `chain_trace.routes`. `tape` (CUDA tensors, linear
    tables) takes the route's taping kernel, which fills a float32 tape of
    the library's size (csrc/trace_common.cuh::ChainTape)."""
    _check_rays(o, d)
    check_tables(tables, o.device, culled_ok=True)
    if tape and (o.device.type != "cuda" or tables.culled):
        raise ValueError("chain_trace: the tape is the CUDA kernels' on linear tables "
                         "(chain_grad's); the plain adjoint checkpoints itself")
    if o.device.type == "cpu":
        return trace_chain_plain(tables, o, d, cfg)
    if o.device.type != "cuda":
        raise ValueError(f"chain_trace: unsupported device {o.device}")
    check_no_grad(o, d, *tables.tensors())
    if not (o.is_contiguous() and d.is_contiguous()):
        raise ValueError("chain_trace: o and d must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(o)
    tp = None
    if tape:
        n = lib.rte_chain_tape_floats(cfg.max_depth, o.shape[0])
        tp = torch.empty(n, dtype=torch.float32, device=o.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_chain_trace(
            *_build.table_args(tables), *_build.culling_args(tables),
            o.data_ptr(), d.data_ptr(), out.data_ptr(), o.shape[0], ctypes.byref(route),
            None if tp is None else tp.data_ptr(), cfg.max_depth, cfg.bias, cfg.min_weight,
            stream,
        )
    _build.check(lib, err, "chain_trace")
    chain_trace.launches += 1
    chain_trace.routes[ROUTES[route.value]] += 1
    if tape:
        chain_trace.tape_launches += 1
        return out, tp
    return out


#: The table families in `stage_extents`' order (csrc/chain_trace.cu).
FAMILIES = ("spheres", "planes", "triangles", "lights")


def stage_extents(tables: SceneTables) -> dict[str, tuple[int, int]]:
    """Each family's (live extent, slots) as the staged scans find them
    (csrc/trace_common.cuh::StagedScan): the live extent is one past the
    last slot that can hit (or, for lights, is active); the scans skip the
    slots past it. CUDA tables on the staged route only; one launch of a
    single CTA and a host sync, for tests and chip_kernel_times.py."""
    check_tables(tables, tables.sph.device)
    if tables.sph.device.type != "cuda":
        raise ValueError("stage_extents: the staged scan is the CUDA kernels'; "
                         f"got tables on {tables.sph.device}")
    lib = _build.load_library()
    out = torch.zeros(4, dtype=torch.int32, device=tables.sph.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(out.device):
        err = lib.rte_stage_extents(*_build.table_args(tables), out.data_ptr(),
                                    ctypes.byref(route), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "stage_extents")
    if ROUTES[route.value] != "staged":
        raise ValueError(f"stage_extents: these tables take the {ROUTES[route.value]} route")
    slots = (tables.n_spheres, tables.n_planes, tables.n_triangles, tables.n_lights)
    return {f: (int(x), n) for f, x, n in zip(FAMILIES, out.tolist(), slots)}


def new_route_counts() -> dict[str, int]:
    """Launches per route (ROUTES), all 0."""
    return dict.fromkeys(ROUTES, 0)


#: Kernel launches since the last reset (the CPU path does not count), in
#: all and per route.
chain_trace.launches = 0
chain_trace.routes = new_route_counts()
#: Of those, the launches of a taping kernel (`tape=True`).
chain_trace.tape_launches = 0
