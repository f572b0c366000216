"""PyTorch port, the trace kernels' routes on linear tables.

chain_trace and spp_trace take linear tables whose 16-byte stage fits the
kernels' limit through the staged scan (the CTA copies the tables into
shared memory once, each thread traces a packet of rays), and larger ones
through the in-place scan; the entry points choose
(csrc/trace_common.cuh::trace_route) and report the route, and the
wrappers count it. On the CPU: a CPU tensor counts no launch on any route,
and the plain versions' frames do not change when the tables are padded
(padded slots never hit, their lights emit 0: the head box and a 5-sphere
stress scene, each padded to 16 slots), which the checks on the card rely
on. The tests marked `gpu` need a CUDA card: they hold each route's
kernels to their plain versions under the seam budget (the head box at
64x48 with spp 1, 3 and 8, so that spp is not always a multiple of the
packet, and at max_depth 1; baseline spheres; the stress scene with 337
spheres, one short of the limit, and with 338, past it), check which route
each launch took, and require the head box's staged frames to equal those
of the head box padded past the limit (in place), and so the ray
cotangents of the head-box adjoint, whose shadow scans take the same two
routes (csrc/trace_common.cuh::grad_route). The staged scans stop at each
family's last live slot (`stage_extents` reads the extents back): the
stress scene padded to 128 slots per family gives the unpadded scene's
frames bit for bit (chain_trace, taping or not, and spp_trace), and the
head box padded to 16 slots the adjoint's ray cotangents. They skip on a
host without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytracingengine_tpu_torch.kernels.chain_grad as cg
import raytracingengine_tpu_torch.kernels.chain_trace as ct
import raytracingengine_tpu_torch.kernels.spp_trace as st
from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.parity import seam_budget
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.scenes import builders

torch.set_num_threads(2)

CFG = RenderConfig(shadow_mode="binary", use_pallas=True)
DEPTH1 = dataclasses.replace(CFG, max_depth=1)

#: name -> (builder, keyword arguments, the route its kernels take)
SCENES = {
    "head_box": (builders.head_box_scene, {}, "staged"),
    "spheres": (builders.baseline_sphere_scene, dict(n_lights=2), "staged"),
    # unpadded, with one sphere less and one more than the stage holds
    # (16 bytes per sphere and plane, 32 per light and per material)
    "stress_337": (builders.stress_scene, dict(n_spheres=337, pad_multiple=None), "staged"),
    "stress_338": (builders.stress_scene, dict(n_spheres=338, pad_multiple=None), "in_place"),
    # planes, triangles and lights padded to 16 and to 128 slots (past the limit)
    "head_box_pad16": (builders.head_box_scene, dict(pad_multiple=16), "staged"),
    "head_box_pad128": (builders.head_box_scene, dict(pad_multiple=128), "in_place"),
    # BASELINE #5's stress scene as the benchmark runs it (128 slots a family,
    # the largest stage) and unpadded; 5 spheres padded to 16 for the CPU
    "stress64": (builders.stress_scene, {}, "staged"),
    "stress64_unpadded": (builders.stress_scene, dict(pad_multiple=None), "staged"),
    "stress_5": (builders.stress_scene, dict(n_spheres=5, pad_multiple=None), "staged"),
    "stress_5_pad16": (builders.stress_scene, dict(n_spheres=5, pad_multiple=16), "staged"),
}


def scene_tables(name, width, height, spp, device):
    fn, kw, _ = SCENES[name]
    scene, cam = fn(width=width, height=height, spp=spp, device=device, **kw)
    return cam, ct.pack_scene_tables(flatten_scene(scene))


def trace_pair(tables, cam, cfg, spp_seed=11):
    """(chain_trace of the camera's pixel rays, spp_trace of its pixels)."""
    px, py = cam.pixel_grid()
    o, d = cam.rays_for_pixels(px, py)
    return (ct.chain_trace(tables, o.contiguous(), d, cfg),
            st.spp_trace(tables, cam, px, py, cfg, seed=spp_seed))


def test_cpu_tensors_count_no_route():
    cam, tables = scene_tables("head_box", 8, 6, 3, "cpu")
    routes = (dict(ct.chain_trace.routes), dict(st.spp_trace.routes))
    trace_pair(tables, cam, CFG)
    assert (ct.chain_trace.routes, st.spp_trace.routes) == routes


@pytest.mark.parametrize("scene,padded", [("head_box", "head_box_pad16"),
                                          ("stress_5", "stress_5_pad16")])
def test_plain_frames_ignore_padded_slots(scene, padded):
    """A scene and the same scene padded to 16 slots per family give equal
    frames through the plain versions (chain_trace's and spp_trace's at spp
    3, on a ragged 13x7 image, at the default depth and at max_depth 1):
    the premise of the card's staged-vs-in-place check and of its padded-
    vs-unpadded checks of the live extents."""
    for cfg in (CFG, DEPTH1):
        frames = [trace_pair(tables, cam, cfg) for cam, tables in (
            scene_tables(scene, 13, 7, 3, "cpu"), scene_tables(padded, 13, 7, 3, "cpu"))]
        for name, a, b in zip(("chain_trace", "spp_trace"), *frames):
            assert torch.equal(a, b), (name, cfg.max_depth)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def run_route(name, spp, device, cfg=CFG, width=64, height=48, plain=True):
    """The kernel of `name` at spp (chain_trace at 1, else spp_trace) and,
    with `plain`, its plain version -> (kernel output, plain output or
    None); asserts one launch on the scene's route."""
    cam, tables = scene_tables(name, width, height, spp, device)
    route = SCENES[name][2]
    case = (name, spp, cfg.max_depth)
    if spp == 1:
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        o = o.contiguous()
        before = ct.chain_trace.routes[route]
        ours = ct.chain_trace(tables, o, d, cfg)
        assert ct.chain_trace.routes[route] == before + 1, (case, ct.chain_trace.routes)
        ref = ct.trace_chain_plain(tables, o, d, cfg) if plain else None
    else:
        px, py = cam.pixel_grid()
        before = st.spp_trace.routes[route]
        ours = st.spp_trace(tables, cam, px, py, cfg, seed=11)
        assert st.spp_trace.routes[route] == before + 1, (case, st.spp_trace.routes)
        ref = st.spp_trace_plain(tables, cam, px, py, cfg, seed=11) if plain else None
    torch.cuda.synchronize()
    return ours, ref


#: (scene, spp, config) of the gpu checks against the plain versions
ROUTE_CASES = [("head_box", 1, CFG), ("head_box", 3, CFG), ("head_box", 8, CFG),
               ("head_box", 1, DEPTH1), ("head_box", 3, DEPTH1),
               ("spheres", 1, CFG), ("spheres", 3, CFG),
               ("stress_337", 1, CFG), ("stress_337", 3, CFG),
               ("stress_338", 1, CFG), ("stress_338", 3, CFG)]


def cuda_route_matches_plain(cuda_device):
    for name, spp, cfg in ROUTE_CASES:
        ours, ref = run_route(name, spp, cuda_device, cfg)
        report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
        print(f"{name} spp={spp} max_depth={cfg.max_depth}: {report}")
        assert np.isfinite(ours.cpu().numpy()).all() and report.ok, (name, spp, cfg.max_depth, report)


def cuda_routes_agree_on_padded_tables(cuda_device):
    """The head box on the staged route and padded past the stage limit on
    the in-place one, at spp 1 and 3, at the default depth and at max_depth
    1: padded slots never hit, their lights emit 0, and each ray's
    arithmetic is the same on both routes, so the frames are equal; a ragged
    pixel count (37x11) leaves a packet part empty. At spp 1 the head-box
    adjoint, fed from each route's taping forward, takes the same two routes
    for its shadow scans, and its ray cotangents are equal bit for bit."""
    for cfg in (CFG, DEPTH1):
        frames = {}
        for spp in (1, 3):
            staged, _ = run_route("head_box", spp, cuda_device, cfg, 37, 11, plain=False)
            in_place, _ = run_route("head_box_pad128", spp, cuda_device, cfg, 37, 11, plain=False)
            report = seam_budget(staged.cpu().numpy(), in_place.cpu().numpy())
            print(f"spp={spp} max_depth={cfg.max_depth}: staged vs in place {report}")
            assert torch.equal(staged, in_place), (spp, cfg.max_depth, report)
            frames[spp] = staged
        g = (2.0 * frames[1] / frames[1].numel()).contiguous()
        cots = {}
        for name in ("head_box", "head_box_pad128"):
            cam, tables = scene_tables(name, 37, 11, 1, cuda_device)
            o, d = cam.rays_for_pixels(*cam.pixel_grid())
            o = o.contiguous()
            img, tape = ct.chain_trace(tables, o, d, cfg, tape=True)
            assert torch.equal(img, frames[1]), (name, cfg.max_depth)
            route = SCENES[name][2]
            before = cg.chain_grad.routes[route]
            cots[name] = cg.chain_grad(tables, o, d, g, cfg, width=37, tape=tape)
            assert cg.chain_grad.routes[route] == before + 1, (name, cg.chain_grad.routes)
        torch.cuda.synchronize()
        for i, cot in ((1, "d_o"), (2, "d_d")):
            a, b = cots["head_box"][i], cots["head_box_pad128"][i]
            assert torch.equal(a, b), (cot, cfg.max_depth, float((a - b).abs().max()))


def cuda_live_extents_skip_padding(cuda_device):
    """The stress scene padded to 128 slots per family (stage_extents: 64,
    1, 0 and 4 live) against the unpadded one, both on the staged route:
    chain_trace at spp 1, taping or not, and spp_trace at spp 3, at the
    default depth and at max_depth 1, equal bit for bit on a ragged 96x54
    image and on a 4K frame's horizon row. The head box padded to 16
    slots: its live extents are the unpadded slot counts, and the head-box
    adjoint's ray cotangents, whose staged shadow scans stop at them, equal
    the unpadded head box's."""
    ext = {name: ct.stage_extents(scene_tables(name, 8, 6, 1, cuda_device)[1])
           for name in ("stress64", "head_box", "head_box_pad16")}
    print(f"stage_extents: {ext}")
    assert ext["stress64"] == {"spheres": (64, 128), "planes": (1, 128), "triangles": (0, 0),
                               "lights": (4, 128)}, ext["stress64"]
    assert all(live == slots for live, slots in ext["head_box"].values()), ext["head_box"]
    assert {f: live for f, (live, _) in ext["head_box_pad16"].items()} == \
        {f: slots for f, (_, slots) in ext["head_box"].items()}, ext
    # The 4K frame's horizon row from one of the benchmark's poses: floor
    # points ~44,000 away, whose shadow rays pass the padded spheres' centre
    # where r^2 = -1 is lost to rounding, so that a scan of every slot takes
    # them as blockers (7 of these rays); the live extents leave them lit.
    cam = Camera.create((0.7492647558910754, 1.3540495315269423, -25.91139156842343),
                        focal=1920.0, width=3840, height=2160, near=0.0, far=200.0, spp=1,
                        device=cuda_device)
    px = torch.arange(3840, dtype=torch.int32, device=cuda_device)
    o, d = cam.rays_for_pixels(px, torch.full_like(px, 1079))
    horizon = [ct.chain_trace(scene_tables(name, 8, 6, 1, cuda_device)[1], o.contiguous(), d, CFG)
               for name in ("stress64", "stress64_unpadded")]
    assert torch.equal(*horizon), int((horizon[0] != horizon[1]).any(dim=1).sum())
    for cfg in (CFG, DEPTH1):
        for spp in (1, 3):
            padded, _ = run_route("stress64", spp, cuda_device, cfg, 96, 54, plain=False)
            unpadded, _ = run_route("stress64_unpadded", spp, cuda_device, cfg, 96, 54, plain=False)
            assert torch.equal(padded, unpadded), (spp, cfg.max_depth)
            if spp == 1:
                for name in ("stress64", "stress64_unpadded"):
                    cam, tables = scene_tables(name, 96, 54, 1, cuda_device)
                    o, d = cam.rays_for_pixels(*cam.pixel_grid())
                    img, _ = ct.chain_trace(tables, o.contiguous(), d, cfg, tape=True)
                    assert torch.equal(img, padded), (name, cfg.max_depth)
        g = None
        cots = {}
        for name in ("head_box", "head_box_pad16"):
            cam, tables = scene_tables(name, 37, 11, 1, cuda_device)
            o, d = cam.rays_for_pixels(*cam.pixel_grid())
            o = o.contiguous()
            img, tape = ct.chain_trace(tables, o, d, cfg, tape=True)
            if g is None:
                g = (2.0 * img / img.numel()).contiguous()
            before = cg.chain_grad.routes["staged"]
            cots[name] = cg.chain_grad(tables, o, d, g, cfg, width=37, tape=tape)
            assert cg.chain_grad.routes["staged"] == before + 1, (name, cg.chain_grad.routes)
        torch.cuda.synchronize()
        for i, cot in ((1, "d_o"), (2, "d_d")):
            a, b = cots["head_box"][i], cots["head_box_pad16"][i]
            assert torch.equal(a, b), (cot, cfg.max_depth, float((a - b).abs().max()))


@pytest.mark.gpu
def test_cuda_routes_match_plain(cuda_device):
    """Every check of this file on the card, one after another: one test item,
    since off the card it skips (chip_smoke.py covers each on the main paths' shapes)."""
    cuda_route_matches_plain(cuda_device)
    cuda_routes_agree_on_padded_tables(cuda_device)
    cuda_live_extents_skip_padding(cuda_device)
