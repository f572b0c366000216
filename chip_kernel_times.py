#!/usr/bin/env python3
"""Time the kernels of the checkout this script sits in, on one CUDA card,
as render_hdr and the training steps call them:

  head box 1920x1080   chain_trace, chain_grad (with the frame width where
                       its wrapper takes one), spp_trace at spp=8; spp_trace
                       at 1000x1000 spp=32
  adjoints (head box   chain_trace without and with its tape, chain_grad
  and glass sphere,    fed by the taping forward where the checkout has one,
  1920x1080)           chain_grad_dense on the head box's tables;
                       wavefront_trace without and with its counts and
                       wavefront_grad (march and binary shadows); the
                       head-box and glass training steps (8-step warm-up;
                       the head box's at the whole frame and at
                       render_hdr's default chunk_size):
                       wall time with the host running ahead and with a
                       synchronise after every step, device time under
                       torch.profiler, and peak device memory
  dense_mesh_scene     culled chain_trace and chain_grad_dense (tables
  512x512, 6,016 and   ordered along the mean ray), culled spp_trace at
  50,800 triangles     spp=8 (tables in no order)

  glass sphere         wavefront_trace (march and binary shadows, without
  1920x1080 (--glass)  and with its counts), wavefront_spp_trace at spp=8,
                       wavefront_grad fed from the counting forward (march
                       and binary), and the glass training step as
                       --adjoints times it
  glass mesh           the same scene with dense_mesh_scene's 6,016-triangle
  1920x1080 (--glass)  mesh made transparent: wavefront_trace (march and
                       binary, without and with its counts) and
                       wavefront_spp_trace at spp=8, and in scrambled order
                       wavefront_trace at march, on its linear tables and,
                       where this checkout's glass wrappers take them, on
                       its culled tables, with each output's hash (the two
                       routes' frames must be equal); culled wavefront_trace
                       at march with the 50,800-triangle mesh; the
                       crossover, culled and linear wavefront_trace at march
                       in turns with meshes of 132 and 320 triangles and
                       chip_smoke.py phase 21's 560
  (--glass-culled)     the glass mesh's culled kernels alone (6,016 and
                       50,800 triangles), for timing variants of the culled
                       scan in turns
  stress scene         BASELINE #5 as rtbench's stress64.render_4k renders
  3840x2160            it (rtbench/configs/stress64.json, 128 slots a
  (--stress64)         family, the traffic's four poses): chain_trace alone
                       on the first pose's rays, render_hdr's frame of each
                       pose with its hash, and, where the checkout has
                       stage_extents, the staged scan's live extents

It also prints ptxas' register report of the build and, for each trace
kernel function, its SASS instruction count and opcode mix (cuobjdump): the
loads (LDG, LDS, LDC, ULDC), the local-memory loads and stores (LDL, STL:
a stack or spills), the fp32 arithmetic (FMUL, FADD, FFMA), MUFU and
branches, over the function and over each innermost loop of at least
30 fp32 instructions (the triangle tests' loops), so that two versions'
code can be told apart beside their times. Beside each head-box time it
prints a hash of the kernel's output (the adjoints: of d_o and d_d, the
dense meshes' chain_grad_dense too; the counting wavefront_trace: of its
frame and its counts), so
that two versions' outputs can be seen to be bit-identical.

The script uses only the package's public wrappers, so it runs the same in
two checkouts: copy it into each (unpacked from `git archive`) and run them
in turns on one card, parent, change, change, parent, to compare two
versions. CUDA events around repeated calls after one warm-up call; the last
line is one JSON object of ms per kernel and shape.

Run on a machine with one CUDA card:
    python3 chip_kernel_times.py              # every kernel above
    python3 chip_kernel_times.py --head-box   # the head-box kernels only
    python3 chip_kernel_times.py --glass      # the glass kernels and step only
    python3 chip_kernel_times.py --glass-culled  # the glass mesh's culled kernels only
    python3 chip_kernel_times.py --adjoints   # the adjoints, their forwards, the steps
    python3 chip_kernel_times.py --chain-grad # chain_trace and chain_grad only, no reports
    python3 chip_kernel_times.py --glass-step # the glass training step only, no reports
    python3 chip_kernel_times.py --dense-sinks # chain_grad_dense's two sinks in turns
    python3 chip_kernel_times.py --stress64   # the stress scene's 4K frames only
    python3 chip_kernel_times.py --sphere-rows 7,8,9  # no timing: the stress
                                              # scene's sphere rows vs float64
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W1080, H1080, SIZE = 1920, 1080, 512


#: SASS opcodes counted, by class (the opcode before its first '.').
SASS_CLASSES = {
    "loads": ("LDG", "LDS", "LDC", "ULDC"),
    "local": ("LDL", "STL"),
    "fp32": ("FMUL", "FADD", "FFMA"),
    "other": ("MUFU", "BRA"),
}
SASS_OPS = tuple(op for ops in SASS_CLASSES.values() for op in ops)


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str, int | None, str]]]:
    """Kernel function -> its SASS as (address, opcode, branch target or
    None, the whole instruction), by `cuobjdump -sass` (an empty dict where
    cuobjdump is missing)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    funcs: dict[str, list] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if name and m:
            op = m.group(2).split(".")[0]
            t = re.search(r"0x([0-9a-f]+)", m.group(3)) if op == "BRA" else None
            funcs[name].append((int(m.group(1), 16), op, int(t.group(1), 16) if t else None,
                                m.group(0)))
    return funcs


def opcode_mix(instrs) -> str:
    c = Counter(x[1] for x in instrs)
    return f"{len(instrs)} instructions, " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS)


def sass_hash(instrs) -> str:
    """A hash of the whole instruction stream (operands included): equal
    hashes, the same code."""
    return hashlib.sha1("\n".join(x[3] for x in instrs).encode()).hexdigest()[:12]


def hot_loops(instrs, min_fp32: int = 30):
    """The innermost loops (a backward branch's span holding no other) with
    at least `min_fp32` fp32 instructions -> [(start, end, instructions)]."""
    spans = [(t, a) for a, op, t, _ in instrs if op == "BRA" and t is not None and t <= a]
    inner = [(s, e) for s, e in spans
             if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e for s2, e2 in spans)]
    loops = []
    for s, e in sorted(set(inner)):
        body = [x for x in instrs if s <= x[0] <= e]
        if sum(x[1] in SASS_CLASSES["fp32"] for x in body) >= min_fp32:
            loops.append((s, e, body))
    return loops


def out_hash(t) -> str:
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:12]


def takes(fn, name: str) -> bool:
    """Does the wrapper `fn` take the keyword `name` (this checkout's API)?"""
    return name in inspect.signature(fn).parameters


def time_adjoints(dev, show, time_ms, glass_step_only: bool = False) -> None:
    """The adjoints and their forwards at 1080p, then the two training steps
    (see the module docstring); with `glass_step_only`, the glass training
    step alone. A checkout whose chain_trace takes `tape` (wavefront_trace
    `count`) feeds its adjoint from the taping (counting) forward; an older
    one calls the adjoint on the rays alone."""
    import dataclasses

    import torch

    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.kernels import chain_grad as cg
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.kernels import wavefront_grad as wg
    from raytracingengine_tpu_torch.kernels import wavefront_trace as wt
    from raytracingengine_tpu_torch.parity import ray_cot_seam_budget
    from raytracingengine_tpu_torch.render.config import RenderConfig
    from raytracingengine_tpu_torch.scenes import (
        baseline_sphere_scene,
        glass_sphere_scene,
        head_box_scene,
    )

    def flips(label: str, out, ref) -> None:
        """The ray cotangents' seam-flip pixels against the plain version
        (chip_smoke.py's PARENT_FLIPS take these of a parent checkout)."""
        reports = [ray_cot_seam_budget(a.cpu().numpy(), b.cpu().numpy())
                   for a, b in ((out[1], ref[1]), (out[2], ref[2]))]
        print(f"  {label}: seam-flip pixels against the plain version d_o {reports[0].flips}, "
              f"d_d {reports[1].flips} (in budget: {all(r.ok for r in reports)})", flush=True)

    sync = torch.cuda.synchronize
    mean_sq = lambda img, _target: (img * img).mean()  # noqa: E731
    steps = (
        ("head-box training step 1080p", head_box_scene,
         RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=W1080 * H1080)),
        ("glass training step 1080p", glass_sphere_scene,
         RenderConfig(use_pallas=True, chunk_size=W1080 * H1080)),
        # render_hdr's default chunk: 127 chunks of 16,384 rays, each chunk's
        # tape (where there is one) held until the backward
        (f"head-box training step 1080p, chunk_size {RenderConfig().chunk_size}", head_box_scene,
         RenderConfig(shadow_mode="binary", use_pallas=True)),
    )
    if glass_step_only:
        time_steps(dev, show, time_ms, mean_sq, steps[1:2])
        return
    rays = lambda cam: [x.contiguous() for x in cam.rays_for_pixels(*cam.pixel_grid())]  # noqa: E731
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=W1080 * H1080)
    scene, cam = head_box_scene(width=W1080, height=H1080, spp=1, device=dev)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    o, d = rays(cam)
    img = ct.chain_trace(tables, o, d, cfg)
    g = (2.0 * img / img.numel()).contiguous()
    show("chain_trace head box 1080p", time_ms(lambda: ct.chain_trace(tables, o, d, cfg), 20), img)
    kw = {"width": W1080} if takes(cg.chain_grad, "width") else {}
    if takes(ct.chain_trace, "tape"):
        img_t, kw["tape"] = ct.chain_trace(tables, o, d, cfg, tape=True)
        show("chain_trace taping head box 1080p",
             time_ms(lambda: ct.chain_trace(tables, o, d, cfg, tape=True), 20), img_t)
    out = cg.chain_grad(tables, o, d, g, cfg, **kw)
    show("chain_grad head box 1080p", time_ms(lambda: cg.chain_grad(tables, o, d, g, cfg, **kw), 10),
         out[1], out[2])
    flips("chain_grad head box 1080p", out, cg.chain_grad_plain(tables, o, d, g, cfg))
    out = cg.chain_grad_dense(tables, o, d, g, cfg)
    show("chain_grad_dense head box 1080p",
         time_ms(lambda: cg.chain_grad_dense(tables, o, d, g, cfg), 10), out[1], out[2])
    # baseline spheres (2 lights): the sphere pullback, flips only
    b_scene, b_cam = baseline_sphere_scene(W1080, H1080, spp=1, n_lights=2, device=dev)
    b_tables = ct.pack_scene_tables(flatten_scene(b_scene))
    b_o, b_d = rays(b_cam)
    b_img = ct.chain_trace(b_tables, b_o, b_d, cfg)
    b_g = (2.0 * b_img / b_img.numel()).contiguous()
    if "tape" in kw:
        kw["tape"] = ct.chain_trace(b_tables, b_o, b_d, cfg, tape=True)[1]
    flips("chain_grad spheres 1080p", cg.chain_grad(b_tables, b_o, b_d, b_g, cfg, **kw),
          cg.chain_grad_plain(b_tables, b_o, b_d, b_g, cfg))
    del out, kw, img, g, o, d, b_o, b_d, b_img, b_g

    glass, gcam = glass_sphere_scene(W1080, H1080, spp=1, device=dev)
    g_tables = ct.pack_scene_tables(flatten_scene(glass))
    go, gd = rays(gcam)
    glass_cfg = RenderConfig(use_pallas=True, chunk_size=W1080 * H1080)
    for mode, gcfg in (("march", glass_cfg),
                       ("binary", dataclasses.replace(glass_cfg, shadow_mode="binary")),
                       # the JAX package's deep-TIR adjoint test's config
                       ("deep TIR", dataclasses.replace(glass_cfg, max_depth=6, wavefront_budget=100))):
        img = wt.wavefront_trace(g_tables, go, gd, gcfg)
        show(f"wavefront_trace glass 1080p {mode}",
             time_ms(lambda: wt.wavefront_trace(g_tables, go, gd, gcfg), 20), img)
        kw = {}
        if takes(wt.wavefront_trace, "count"):
            img_c, kw["warp_pops"] = wt.wavefront_trace(g_tables, go, gd, gcfg, count=True)
            show(f"wavefront_trace counting glass 1080p {mode}",
                 time_ms(lambda: wt.wavefront_trace(g_tables, go, gd, gcfg, count=True), 20), img_c)
        gg = (2.0 * img / img.numel()).contiguous()
        out = wg.wavefront_grad(g_tables, go, gd, gg, gcfg, **kw)
        show(f"wavefront_grad glass 1080p {mode}",
             time_ms(lambda: wg.wavefront_grad(g_tables, go, gd, gg, gcfg, **kw), 10), out[1], out[2])
        flips(f"wavefront_grad glass 1080p {mode}", out,
              wg.wavefront_grad_plain(g_tables, go, gd, gg, gcfg))
    del out, img, gg, kw, go, gd

    time_steps(dev, show, time_ms, mean_sq, steps)


def glass_mesh_scene(width: int, height: int, spp: int, device, **mesh_kw):
    """glass_sphere_scene's three primitives and light with dense_mesh_scene's
    bumpy mesh (6,016 triangles at its default ni, nj; `scramble` shuffles
    them) made transparent (transparency 0.7, refractive index 1.3), seen by
    the glass sphere's camera -> (scene, camera)."""
    import dataclasses

    import torch

    from raytracingengine_tpu_torch.scenes import dense_mesh_scene, glass_sphere_scene

    glass, cam = glass_sphere_scene(width, height, spp=spp, device=device)
    mesh = dense_mesh_scene(width, height, spp=spp, device=device, **mesh_kw)[0].triangles
    m = mesh.materials
    mats = dataclasses.replace(m, transparency=torch.full_like(m.transparency, 0.7),
                               refractive_index=torch.full_like(m.refractive_index, 1.3))
    return dataclasses.replace(glass, triangles=dataclasses.replace(mesh, materials=mats)), cam


def phase21_mesh_scene(width: int, height: int, device):
    """chip_smoke.py phase 21's scene: the glass sphere scene and a
    transparent bumpy mesh of 560 triangles in front of it -> (scene,
    camera)."""
    from raytracingengine_tpu_torch.geometry.materials import Material
    from raytracingengine_tpu_torch.scene import SceneBuilder
    from raytracingengine_tpu_torch.scenes import glass_sphere_scene
    from raytracingengine_tpu_torch.scenes.assets import bumpy_sphere_mesh

    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 5.0), 1.5, Material(color=(1, 1, 1), transparency=0.9, refractive_index=1.5))
    b.add_sphere((1.5, -0.8, 9.0), 1.0, Material(color=(0.9, 0.4, 0.1)))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), Material(color=(0.8, 0.8, 0.8)))
    verts, idx = bumpy_sphere_mesh(radius=1.2, ni=8, nj=40)
    b.add_model(verts, idx, Material(color=(0.6, 0.9, 0.7), transparency=0.7, refractive_index=1.3),
                translation=(-0.3, 0.2, 3.0))
    b.add_light((-3.0, 5.0, -1.0), (1, 1, 1), 60.0)
    return b.build(device=device), glass_sphere_scene(width, height, device=device)[1]


def time_glass(dev, show, time_ms, culled_only: bool = False) -> None:
    """The glass kernels at 1080p on the glass sphere with the main path's
    camera, each with its output hash; on the glass mesh, linear and culled;
    the crossover; then the glass training step. With `culled_only`, the
    glass mesh's culled kernels alone."""
    import dataclasses

    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.kernels import wavefront_grad as wg
    from raytracingengine_tpu_torch.kernels import wavefront_trace as wt
    from raytracingengine_tpu_torch.render.config import RenderConfig
    from raytracingengine_tpu_torch.scenes import glass_sphere_scene

    glass, cam = glass_sphere_scene(W1080, H1080, spp=1, device=dev)
    tables = ct.pack_scene_tables(flatten_scene(glass))
    px, py = cam.pixel_grid()
    o, d = (x.contiguous() for x in cam.rays_for_pixels(px, py))
    march = RenderConfig(use_pallas=True, chunk_size=W1080 * H1080)
    for mode, cfg in (("march", march), ("binary", dataclasses.replace(march, shadow_mode="binary")))[
            :0 if culled_only else 2]:
        show(f"wavefront_trace glass 1080p {mode}",
             time_ms(lambda: wt.wavefront_trace(tables, o, d, cfg), 20), wt.wavefront_trace(tables, o, d, cfg))
        img, pops = wt.wavefront_trace(tables, o, d, cfg, count=True)
        show(f"wavefront_trace counting glass 1080p {mode}",
             time_ms(lambda: wt.wavefront_trace(tables, o, d, cfg, count=True), 20), img, pops)
        g = (2.0 * img / img.numel()).contiguous()
        out = wg.wavefront_grad(tables, o, d, g, cfg, warp_pops=pops)
        show(f"wavefront_grad glass 1080p {mode}",
             time_ms(lambda: wg.wavefront_grad(tables, o, d, g, cfg, warp_pops=pops), 10), out[1], out[2])
    _, cam8 = glass_sphere_scene(W1080, H1080, spp=8, device=dev)
    if not culled_only:
        show("wavefront_spp_trace glass 1080p spp=8",
             time_ms(lambda: wt.wavefront_spp_trace(tables, cam8, px, py, march, seed=1234), 10),
             wt.wavefront_spp_trace(tables, cam8, px, py, march, seed=1234))
    # The glass mesh: the linear route scans 6,016 triangles per test (few
    # calls), the culled one the blocks each ray meets.
    # (~2 s a call at march, ~15 s at spp=8): every kernel in authoring
    # order, wavefront_trace at march in scrambled order.
    binary = dataclasses.replace(march, shadow_mode="binary")
    for order, kw in (("", {}), (" scrambled", {"scramble": 5})):
        m_scene, _ = glass_mesh_scene(W1080, H1080, 1, dev, **kw)
        flat = flatten_scene(m_scene)
        routes = {"linear": (ct.pack_scene_tables(flat), 1), "culled": (ct.pack_forward_tables_perm(flat), 5)}
        if culled_only:
            del routes["linear"]
        for route, (tb, iters) in routes.items():
            name = f"glass mesh{order} 1080p, {route}"
            try:
                wt.wavefront_trace(tb, o, d, march)
            except ValueError as e:  # a checkout whose glass wrappers refuse culled tables
                print(f"  wavefront_trace {name}: not in this checkout ({e})", flush=True)
                continue
            for mode, cfg in (("march", march), ("binary", binary))[:2 if not order else 1]:
                show(f"wavefront_trace {name} {mode}", time_ms(lambda: wt.wavefront_trace(tb, o, d, cfg), iters),
                     wt.wavefront_trace(tb, o, d, cfg))
                if order:
                    continue
                show(f"wavefront_trace counting {name} {mode}",
                     time_ms(lambda: wt.wavefront_trace(tb, o, d, cfg, count=True), iters),
                     *wt.wavefront_trace(tb, o, d, cfg, count=True))
            if not order:
                show(f"wavefront_spp_trace {name} spp=8",
                     time_ms(lambda: wt.wavefront_spp_trace(tb, cam8, px, py, march, seed=1234), 1),
                     wt.wavefront_spp_trace(tb, cam8, px, py, march, seed=1234))
    # 50,800 triangles, culled (the linear route takes ~15 s a call there)
    m_scene, _ = glass_mesh_scene(W1080, H1080, 1, dev, ni=128, nj=200)
    tb = ct.pack_forward_tables_perm(flatten_scene(m_scene))
    show("wavefront_trace glass mesh 50800 triangles 1080p, culled march",
         time_ms(lambda: wt.wavefront_trace(tb, o, d, march), 3), wt.wavefront_trace(tb, o, d, march))
    del m_scene, tb
    if culled_only:
        return
    # the crossover near TRI_BLOCK: culled and linear in turns (linear,
    # culled, culled, linear), as chip_smoke.py phase 23 times it
    for label, make in (("132 triangles", lambda: glass_mesh_scene(W1080, H1080, 1, dev, ni=3, nj=33)[0]),
                        ("320 triangles", lambda: glass_mesh_scene(W1080, H1080, 1, dev, ni=6, nj=32)[0]),
                        ("560 triangles", lambda: phase21_mesh_scene(W1080, H1080, dev)[0])):
        flat = flatten_scene(make())
        lin, cul = ct.pack_scene_tables(flat), ct.pack_forward_tables_perm(flat)
        runs = {"linear": [], "culled": []}
        for route in ("linear", "culled", "culled", "linear"):
            tb = lin if route == "linear" else cul
            runs[route].append(time_ms(lambda: wt.wavefront_trace(tb, o, d, march), 5))
        for route, ms in runs.items():
            tb = lin if route == "linear" else cul
            show(f"wavefront_trace crossover {label} 1080p, {route} march", sum(ms) / 2,
                 wt.wavefront_trace(tb, o, d, march))
    time_steps(dev, show, time_ms, lambda img, _target: (img * img).mean(),
               (("glass training step 1080p", glass_sphere_scene, march),))


def sphere_rows(dev, seeds) -> None:
    """The stress scene's adjoint sphere rows against float64, as
    chip_smoke.py's phase 18 holds them (parity.sphere_rows_vs_f64), on
    stress_scene with 337 spheres at 320x180 for each seed: per row
    |diff| / bound at parity.F64_PLAIN_FACTOR of the entry with the least
    room and the factor its worst entry needs, the flips whose g is zeroed,
    and the sphere rows' summed |diff| of the kernel and the float32 plain
    version. A seed given twice reads the run-to-run spread (the adjoints'
    atomics)."""
    import numpy as np

    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.kernels import chain_grad as cg
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.parity import (
        F64_PLAIN_FACTOR,
        f64_factors_needed,
        sphere_rows_vs_f64,
        table_cot_rows_vs_f64,
    )
    from raytracingengine_tpu_torch.render.config import RenderConfig
    from raytracingengine_tpu_torch.scenes import stress_scene

    width, height = 320, 180
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=width * height)
    for seed in seeds:
        scene, cam = stress_scene(337, width=width, height=height, spp=1, seed=seed, pad_multiple=None,
                                  device=dev)
        tables = ct.pack_scene_tables(flatten_scene(scene))
        o, d = (x.contiguous() for x in cam.rays_for_pixels(*cam.pixel_grid()))
        img, tape = ct.chain_trace(tables, o, d, cfg, tape=True)
        g = (2.0 * img / img.numel()).contiguous()
        ours = cg.chain_grad(tables, o, d, g, cfg, width=width, tape=tape)
        ref = cg.chain_grad_plain(tables, o, d, g, cfg)
        rows, seam, seam64 = sphere_rows_vs_f64(tables, o, d, g, cfg, ours, ref, width=width, tape=tape)
        summed = [np.abs(x - rows[2]).sum(1) for x in rows[:2]]
        print(f"  stress_scene seed {seed}, 337 spheres {width}x{height}: g zeroed on "
              f"{int((seam | seam64).sum())} rays (kernel flips {int(seam.sum())}, float32 plain flips "
              f"against float64 {int(seam64.sum())}); sphere rows' summed |diff| vs float64 kernel / "
              f"float32 plain " + ", ".join(f"{a:.4e} / {b:.4e}" for a, b in zip(*summed)), flush=True)
        for row, need in zip(table_cot_rows_vs_f64("sph", *rows), f64_factors_needed("sph", *rows)):
            print(f"    seed {seed} {row}: |diff| / bound at factor {F64_PLAIN_FACTOR:g} "
                  f"{row.err / row.bound:.4f}; factor needed {need:.4f}", flush=True)


def time_dense_sinks(dev, show, time_ms, turns: int = 3) -> None:
    """chain_grad_dense on each of its two sinks (kernels/chain_grad.py::
    DENSE_SINKS), in turns (shared, global, global, shared, `turns` times)
    on the scenes the dense adjoint takes and on the head box: per scene
    the CTAs per SM each sink's kernel keeps with its accumulator, each
    sink's median ms and its spread, which sink dense_sink picks, whether
    the two sinks' d_o and d_d are bit for bit equal, and the largest
    difference between their table cotangents over that table's largest
    entry (the atomics' order)."""
    import statistics

    import torch

    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.kernels import _build
    from raytracingengine_tpu_torch.kernels import chain_grad as cg
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.render.config import RenderConfig
    from raytracingengine_tpu_torch.render.pipeline import mean_direction
    from raytracingengine_tpu_torch.scenes import (
        dense_mesh_scene,
        head_box_scene,
        mixed_dense_scene,
        stress_scene,
    )

    lib = _build.load_library()

    def scenes():
        yield "head box 1920x1080", head_box_scene(width=W1080, height=H1080, device=dev), W1080 * H1080
        for label, kw in (("6016 triangles", {}), ("50800 triangles", dict(ni=128, nj=200))):
            yield f"dense mesh {label} 512x512", dense_mesh_scene(SIZE, SIZE, device=dev, **kw), SIZE * SIZE
        yield "mixed dense 512x512", mixed_dense_scene(SIZE, SIZE, device=dev), SIZE * SIZE
        for n in (250, 500, 1000, 1500, 2000, 3000, 4000, 5281):
            yield (f"stress_scene {n} spheres, one light, 512x512",
                   stress_scene(n, n_lights=1, width=SIZE, height=SIZE, pad_multiple=None, device=dev),
                   SIZE * SIZE)

    for label, (scene, cam), chunk in scenes():
        cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=chunk)
        flat = flatten_scene(scene)
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        o = o.contiguous()
        tables = (ct.pack_forward_tables_perm(flat, mean_direction(d)) if flat.n_triangles > 128
                  else ct.pack_scene_tables(flat))
        g = (2.0 * ct.chain_trace(tables, o, d, cfg) / (3 * o.shape[0])).contiguous()
        shared_bytes = 4 * sum(a * b for a, b in cg.small_table_shapes(tables))
        occ = {"shared": lib.rte_chain_grad_dense_occupancy(int(tables.culled), shared_bytes, 0),
               "global": lib.rte_chain_grad_dense_occupancy(int(tables.culled), 4 * tables.light.numel(), 1)}
        outs = {k: cg.chain_grad_dense(tables, o, d, g, cfg, sink=k) for k in cg.DENSE_SINKS}
        rays_equal = all(torch.equal(a, b) for a, b in zip(outs["shared"][1:], outs["global"][1:]))
        table_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                        for a, b in zip(outs["global"][0], outs["shared"][0]) if b.numel())
        del outs
        runs = {k: [] for k in cg.DENSE_SINKS}
        for _ in range(turns):
            for k in ("shared", "global", "global", "shared"):
                runs[k].append(time_ms(lambda: cg.chain_grad_dense(tables, o, d, g, cfg, sink=k), 3))
        print(f"  {label}: {tables.n_spheres} spheres, {tables.n_planes} planes, {tables.n_triangles} "
              f"triangles, culled {tables.culled}; shared accumulator {shared_bytes} bytes; CTAs per SM "
              f"{occ}; dense_sink picks {cg.dense_sink(tables)}; d_o, d_d bit for bit equal {rays_equal}; "
              f"table cotangents' largest |global - shared| / max|shared| {table_rel:.3e}", flush=True)
        for k, ms in runs.items():
            show(f"chain_grad_dense {k} sink, {label}", statistics.median(ms))
            print(f"    {k} sink turns {', '.join(f'{x:.3f}' for x in ms)} ms", flush=True)
        del scene, cam, flat, o, d, tables, g


def time_stress64(dev, show, time_ms) -> None:
    """The stress64.render_4k cell's scene, poses and settings, built by
    rtbench's harness from its files: chain_trace alone on the 4K tables,
    and each pose's render_hdr frame (ms and hash), in the order of the
    poses' positions."""
    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.render.pipeline import render_hdr
    from rtbench.harness import program

    config = json.loads((ROOT / "rtbench" / "configs" / "stress64.json").read_text())
    traffic = json.loads((ROOT / "rtbench" / "traffic" / "render_4k.json").read_text())
    w, h = traffic["width"], traffic["height"]
    scene = program.build_scene(config["scene"], config["program"], dev)
    cfg = program.render_config(config["program"], traffic)
    poses = sorted(program.camera_path(config["camera"], traffic, 0),
                   key=lambda c: tuple(c["position"]))
    cams = [program.build_camera(p, w, h, traffic["spp"], dev) for p in poses]
    tables = ct.pack_scene_tables(flatten_scene(scene))
    if hasattr(ct, "stage_extents"):
        ext = ct.stage_extents(tables)
        live = sum(x for f, (x, _) in ext.items() if f != "lights")
        slots = sum(n for f, (_, n) in ext.items() if f != "lights")
        print(f"  stage_extents {ext}: primitive slots skipped {1 - live / slots:.4f}, "
              f"light slots skipped {1 - ext['lights'][0] / ext['lights'][1]:.4f}")
    o, d = cams[0].rays_for_pixels(*cams[0].pixel_grid())
    o = o.contiguous()
    show(f"chain_trace stress64 {w}x{h}", time_ms(lambda: ct.chain_trace(tables, o, d, cfg), 5),
         ct.chain_trace(tables, o, d, cfg))
    del o, d
    for k, (p, cam) in enumerate(zip(poses, cams)):
        show(f"render_hdr stress64 {w}x{h} pose {k} at {p['position']}",
             time_ms(lambda: render_hdr(scene, cam, cfg), 3), render_hdr(scene, cam, cfg))


def time_steps(dev, show, time_ms, loss_fn, steps) -> None:
    """Each training step of `steps` ((label, scene builder, config)) at
    1080p after an 8-step warm-up: wall time with the host running ahead
    and synchronised after every step, device time under the profiler,
    and peak device memory."""
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracingengine_tpu_torch.inverse import make_train_step, partition

    sync = torch.cuda.synchronize
    for label, make, step_cfg in steps:
        s_scene, s_cam = make(width=W1080, height=H1080, spp=1, device=dev)
        params, static = partition(s_scene)
        focal = s_cam.focal.clone().requires_grad_(True)
        s_cam = dataclasses.replace(s_cam, focal=focal)
        opt = torch.optim.SGD([*params.values(), focal], lr=1e-6)
        train = make_train_step(s_cam, step_cfg, opt, loss_fn=loss_fn)
        step = lambda: train(params, static, None)  # noqa: E731
        for _ in range(8):  # the glass trees grow over the first steps
            step()
        show(f"{label}, host running ahead (CUDA events)", time_ms(step, 10))
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
            sync()
        show(f"{label}, synchronised after every step (host clock)",
             (time.perf_counter() - t0) * 1e3 / 10)
        torch.cuda.reset_peak_memory_stats()
        step()
        sync()
        peak = torch.cuda.max_memory_allocated() / 2**20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            sync()
        kernel_ms = {e.key: getattr(e, "device_time_total", 0.0) / 3e3 for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")}
        show(f"{label}, device time under the profiler", sum(kernel_ms.values()))
        ours = {}  # the repo's kernels by name (a template's instantiations together)
        for k, v in kernel_ms.items():
            m = re.search(r"(chain|wavefront|partials)_\w*kernel", k)
            if m:
                ours[m.group(0)] = ours.get(m.group(0), 0.0) + v
        print(f"  {label}: device ms per step by kernel " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(ours.items())), flush=True)
        print(f"  {label}: peak device memory {peak:.1f} MiB", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head-box", action="store_true", help="time the head-box kernels only")
    parser.add_argument("--adjoints", action="store_true",
                        help="time the adjoints, their forwards and the training steps only")
    parser.add_argument("--glass", action="store_true",
                        help="time the glass kernels and the glass training step only")
    parser.add_argument("--glass-culled", action="store_true",
                        help="time the glass mesh's culled kernels only (variants of the culled scan)")
    parser.add_argument("--glass-step", action="store_true",
                        help="time the glass training step only, without the build and SASS "
                             "reports (for many runs in turns)")
    parser.add_argument("--chain-grad", action="store_true",
                        help="time chain_trace and chain_grad on the head box only, without the "
                             "build and SASS reports (for many runs in turns)")
    parser.add_argument("--dense-sinks", action="store_true",
                        help="time chain_grad_dense's shared and global sinks in turns only")
    parser.add_argument("--stress64", action="store_true",
                        help="time the stress64.render_4k cell's chain_trace and frames only")
    parser.add_argument("--sphere-rows", metavar="SEEDS",
                        help="no timing: the stress scene's adjoint sphere rows against float64 for "
                             "these comma-separated seeds (chip_smoke.py phase 18's check)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this script needs a CUDA card")
        return 2
    sys.path.insert(0, str(ROOT))
    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.kernels import _build
    from raytracingengine_tpu_torch.kernels import chain_grad as cg
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.kernels import spp_trace as st
    from raytracingengine_tpu_torch.render.config import RenderConfig
    from raytracingengine_tpu_torch.render.pipeline import mean_direction
    from raytracingengine_tpu_torch.scenes import dense_mesh_scene, head_box_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    lib_path, log = _build.build()
    quiet = args.chain_grad or args.glass_step or args.sphere_rows or args.dense_sinks
    for line in log.splitlines() if not quiet else ():
        if "Compiling entry function" in line or "registers" in line or "stack frame" in line:
            print("  ptxas " + line.strip())
    kinds = ("wavefront",) if args.glass or args.glass_culled else ("chain_trace", "spp_trace", "chain_grad", "wavefront")
    for fn, instrs in sorted(sass_functions(lib_path).items()) if not quiet else ():
        if any(k in fn for k in kinds):
            print(f"  sass {fn}: {opcode_mix(instrs)}; code sha1 {sass_hash(instrs)}")
            if "trace" in fn:
                for start, end, body in hot_loops(instrs):
                    print(f"    loop {start:#x}-{end:#x}: {opcode_mix(body)}")
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    def time_ms(fn, iters: int) -> float:
        fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    times = {}

    def show(name: str, ms: float, *outs) -> None:
        times[name] = ms
        digest = f", output sha1 {' '.join(out_hash(x) for x in outs)}" if outs else ""
        print(f"  {name}: {ms:.3f} ms{digest} [{card}]", flush=True)

    if args.sphere_rows:
        sphere_rows(dev, [int(x) for x in args.sphere_rows.split(",")])
        print(card)
        return 0
    if args.dense_sinks:
        time_dense_sinks(dev, show, time_ms)
        print(card)
        print(json.dumps({"ms": times, "card": card}))
        return 0
    if args.stress64:
        time_stress64(dev, show, time_ms)
        print(card)
        print(json.dumps({"ms": times, "card": card}))
        return 0
    if args.glass or args.glass_culled:
        time_glass(dev, show, time_ms, culled_only=args.glass_culled)
        print(card)
        print(json.dumps({"ms": times, "card": card}))
        return 0
    if args.adjoints or args.glass_step:
        time_adjoints(dev, show, time_ms, glass_step_only=args.glass_step)
        print(card)
        print(json.dumps({"ms": times, "card": card}))
        return 0

    # the head box, linear tables
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=W1080 * H1080)
    scene, cam = head_box_scene(width=W1080, height=H1080, spp=1, device=dev)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    px, py = cam.pixel_grid()
    o, d = cam.rays_for_pixels(px, py)
    o = o.contiguous()
    img = ct.chain_trace(tables, o, d, cfg)
    g = (2.0 * img / img.numel()).contiguous()
    grad_kw = {"width": W1080} if takes(cg.chain_grad, "width") else {}
    if takes(ct.chain_trace, "tape"):
        grad_kw["tape"] = ct.chain_trace(tables, o, d, cfg, tape=True)[1]
    _, cam8 = head_box_scene(width=W1080, height=H1080, spp=8, device=dev)
    _, cam32 = head_box_scene(width=1000, height=1000, spp=32, device=dev)
    px32, py32 = cam32.pixel_grid()
    show("chain_trace head box 1080p", time_ms(lambda: ct.chain_trace(tables, o, d, cfg), 20), img)
    show("chain_grad head box 1080p",
         time_ms(lambda: cg.chain_grad(tables, o, d, g, cfg, **grad_kw), 10),
         *cg.chain_grad(tables, o, d, g, cfg, **grad_kw)[1:])
    if args.chain_grad:
        print(card)
        print(json.dumps({"ms": times, "card": card}))
        return 0
    show("spp_trace head box 1080p spp=8",
         time_ms(lambda: st.spp_trace(tables, cam8, px, py, cfg, seed=1234), 10),
         st.spp_trace(tables, cam8, px, py, cfg, seed=1234))
    show("spp_trace head box 1000x1000 spp=32",
         time_ms(lambda: st.spp_trace(tables, cam32, px32, py32, cfg, seed=7), 5),
         st.spp_trace(tables, cam32, px32, py32, cfg, seed=7))
    del o, d, img, g, grad_kw
    if args.head_box:
        print(card)
        print(json.dumps({"ms": times, "card": card}))
        return 0

    # dense meshes, culled tables
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=SIZE * SIZE)
    for label, kw in (("6016", {}), ("50800", dict(ni=128, nj=200))):
        scene, cam = dense_mesh_scene(SIZE, SIZE, spp=1, device=dev, **kw)
        flat = flatten_scene(scene)
        o, d = cam.rays_for_pixels(*cam.pixel_grid())
        o = o.contiguous()
        tables = ct.pack_forward_tables_perm(flat, mean_direction(d))
        img = ct.chain_trace(tables, o, d, cfg)
        g = (2.0 * img / img.numel()).contiguous()
        _, cam8 = dense_mesh_scene(SIZE, SIZE, spp=8, device=dev, **kw)
        px, py = cam8.pixel_grid()
        tables8 = ct.pack_forward_tables_perm(flat)
        show(f"chain_trace {label} triangles 512x512",
             time_ms(lambda: ct.chain_trace(tables, o, d, cfg), 10))
        show(f"chain_grad_dense {label} triangles 512x512",
             time_ms(lambda: cg.chain_grad_dense(tables, o, d, g, cfg), 5),
             *cg.chain_grad_dense(tables, o, d, g, cfg)[1:])
        show(f"spp_trace {label} triangles 512x512 spp=8",
             time_ms(lambda: st.spp_trace(tables8, cam8, px, py, cfg, seed=1234), 3))
    print(card)
    print(json.dumps({"ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
