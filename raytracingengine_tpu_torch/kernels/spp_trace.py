"""In-kernel anti-aliasing: the reference's AA loop inside one kernel.

The reference traces `antiAliasingAmount` jittered rays per pixel
(Scene.h:283-309, Math.h:103-116): sample 0 is the unjittered center ray,
samples 1.. add uniform [0,1)-pixel jitter to the screen coordinates, and
the pixel is the mean. Here one CUDA thread per pixel builds its camera
rays, runs the whole sample loop through the chain trace and writes the
mean once (csrc/spp_trace.cu).

It replaces raytracingengine_tpu/kernels/spp_trace.py::spp_trace_pallas.
The TPU kernel draws its jitter from the TPU's hardware generator, which
has no counterpart here. The jitter is a counter-based generator instead,
Philox4x32-10 keyed by the seed and counting (row-major pixel id, sample
index): sample s of pixel p takes the first two output words as (jx, jy).
`pixel_jitter` computes the same bits in int64 PyTorch arithmetic as the
kernel does in uint32, so kernel and plain version draw identical jitter,
and the jitter of a pixel does not depend on how the frame is chunked.
"""

from __future__ import annotations

import ctypes

import torch

from raytracingengine_tpu_torch.kernels import _build
from raytracingengine_tpu_torch.kernels.chain_trace import (
    ROUTES,
    SceneTables,
    check_no_grad,
    check_tables,
    new_route_counts,
    trace_chain_plain,
)
from raytracingengine_tpu_torch.utils.profiling import spanned

_MASK = 0xFFFFFFFF
#: Philox4x32 multipliers and Weyl key increments (Salmon et al., SC'11).
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def philox4x32(counter: tuple, key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 words.

    The 32x32-bit products wrap in int64; `>> 32` and `& 0xFFFFFFFF` then
    take their high and low words exactly as __umulhi and a uint32
    product do in CUDA."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(PHILOX_ROUNDS):
        p0 = c0 * PHILOX_M0
        p1 = c2 * PHILOX_M1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & _MASK, (k1 + PHILOX_W1) & _MASK
    return c0, c1, c2, c3


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 in [0, 1) by the mantissa trick:
    the top 23 bits under exponent 0x3F8 give [1, 2), minus 1."""
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one_to_two - 1.0


def pixel_jitter(seed: int, pids: torch.Tensor, sample: int) -> torch.Tensor:
    """Jitter [R, 2] in [0, 1) for `sample` of the pixels `pids` (row-major
    flat ids); sample 0 is the unjittered center ray, all zeros."""
    if sample == 0:
        return torch.zeros((pids.shape[0], 2), dtype=torch.float32, device=pids.device)
    c0 = pids.to(torch.int64) & _MASK
    c1 = torch.full_like(c0, sample & _MASK)
    zero = torch.zeros_like(c0)
    x0, x1, _, _ = philox4x32((c0, c1, zero, zero), (seed & _MASK, 0))
    return torch.stack([uniform01(x0), uniform01(x1)], dim=-1)


def mean_over_samples(
    trace, camera, px: torch.Tensor, py: torch.Tensor, *, seed: int = 0,
    jitter: torch.Tensor | None = None,
) -> torch.Tensor:
    """The AA loop of the plain versions: pixels px/py [R] -> the mean of
    `trace(o, d)` [R, 3] over `camera.spp` camera rays per pixel, built as
    the kernels build them (csrc/trace_common.cuh::camera_dir). `jitter`
    [spp, R, 2] replaces the generator (tests feed the same numbers to the
    JAX reference); by default sample s draws `pixel_jitter(seed, pids, s)`."""
    spp = camera.spp
    sx0 = px.to(torch.float32) - camera.width / 2.0
    sy0 = camera.height / 2.0 - py.to(torch.float32)
    pids = py.to(torch.int64) * camera.width + px.to(torch.int64)
    cx, cy = camera.position[0], camera.position[1]
    acc = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=px.device)
    for s in range(spp):
        j = jitter[s] if jitter is not None else pixel_jitter(seed, pids, s)
        # dir = normalize(screenPoint - position) (Math.h:118-120)
        ddx = (sx0 + j[:, 0]) - cx
        ddy = (sy0 + j[:, 1]) - cy
        ddz = camera.focal.expand(ddx.shape)
        inv = torch.rsqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        d = torch.stack([ddx * inv, ddy * inv, ddz * inv], dim=-1)
        acc = acc + trace(camera.position.expand(d.shape), d)
    return acc * (1.0 / spp)


def spp_trace_plain(
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
    traced by `trace_chain_plain` (`mean_over_samples`)."""
    trace = lambda o, d: trace_chain_plain(tables, o, d, cfg)  # noqa: E731
    return mean_over_samples(trace, camera, px, py, seed=seed, jitter=jitter)


def check_pixels(tables: SceneTables, camera, px: torch.Tensor, py: torch.Tensor,
                 culled_ok: bool = False) -> None:
    """Raise unless px/py are int32 [R] on one device with the tables and
    the camera, and spp >= 1 (a CUDA launch also needs them contiguous)."""
    for name, t in (("px", px), ("py", py)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: expected int32 [R], got {t.dtype} {tuple(t.shape)}")
    if px.shape != py.shape or px.device != py.device:
        raise ValueError("px and py must have one shape and one device")
    check_tables(tables, px.device, culled_ok)
    if camera.position.device != px.device:
        raise ValueError(f"camera on {camera.position.device}, pixels on {px.device}")
    if camera.spp < 1:
        raise ValueError(f"spp must be >= 1, got {camera.spp}")
    if px.device.type == "cuda" and not (px.is_contiguous() and py.is_contiguous()):
        raise ValueError("px and py must be contiguous")


@spanned("rte.launch.spp_trace")
def spp_trace(
    tables: SceneTables,
    camera,
    px: torch.Tensor,
    py: torch.Tensor,
    cfg,
    *,
    seed: int = 0,
) -> torch.Tensor:
    """Pixels px/py (int32 [R]) -> mean HDR [R, 3] over `camera.spp`.

    CPU tensors run `spp_trace_plain`; CUDA tensors launch the CUDA
    kernel (csrc/spp_trace.cu) on the current stream and counts the scan
    it reports in `spp_trace.routes`. Culled tables
    (`pack_forward_tables_perm`) are scanned with culling by the kernel and
    without by the plain version."""
    check_pixels(tables, camera, px, py, culled_ok=True)
    if px.device.type == "cpu":
        return spp_trace_plain(tables, camera, px, py, cfg, seed=seed)
    if px.device.type != "cuda":
        raise ValueError(f"spp_trace: unsupported device {px.device}")
    check_no_grad(camera.position, camera.focal, *tables.tensors())
    lib = _build.load_library()
    cam = torch.stack([camera.position[0], camera.position[1], camera.position[2],
                       camera.focal]).to(torch.float32).contiguous()
    out = torch.empty((px.shape[0], 3), dtype=torch.float32, device=px.device)
    route = ctypes.c_int(-1)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rte_spp_trace(
            *_build.table_args(tables), *_build.culling_args(tables),
            cam.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            px.shape[0], camera.width, camera.height, camera.spp, seed & _MASK,
            ctypes.byref(route), cfg.max_depth, cfg.bias, cfg.min_weight, stream,
        )
    _build.check(lib, err, "spp_trace")
    spp_trace.launches += 1
    spp_trace.routes[ROUTES[route.value]] += 1
    return out


#: Kernel launches since the last reset (the CPU path does not count), in
#: all and per route (kernels/chain_trace.py::ROUTES).
spp_trace.launches = 0
spp_trace.routes = new_route_counts()
