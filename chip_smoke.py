#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (raytracingengine_tpu_torch).

Builds the CUDA kernels from csrc/, checks each against its plain PyTorch
version on the card, checks the rendered frames against the real C++
engine's dump and the pinned goldens, drives the main render path and the
training step at full resolution, and times kernels against plain versions:

  1. device     nvidia-smi name and power limit; exits non-zero without CUDA
  2. build      nvcc build of csrc/*.cu (sm_90a) and g++ of native_bridge's
                host library (timed), with ptxas' register report
                and the trace kernels' CTAs per SM on each route, the taping
                chain_trace's and the counting wavefront_trace's too, and the
                glass kernels' culled instantiations' (occupancy calculator)
  3. chain      chain_trace vs trace_chain_plain, head box 1920x1080 spp=1 rays
                (the staged route: linear tables in shared memory, packets of
                rays)
  4. AA         spp_trace vs spp_trace_plain, head box 1920x1080 spp=8, same seed
  5. engine     baseline spheres 256^2 vs refbuild/baseline_spheres_256.hdr64
  6. goldens    head box 128^2 -> aces/simple -> uint8 vs goldens/*.ppm
  7. main path  render_hdr at 1080p spp=1, 1080p spp=8 and 1000^2 spp=32, with
                the launch counters (in all and per route) reset before and
                read after; PNGs to out/
  8. timing     CUDA events after warm-up, kernel and plain version in turns;
                the taping chain_trace and the counting wavefront_trace; the
                training steps (phase 19's spp=4 steps too) with the host
                running ahead and synchronised after every step, and their
                peak device memory; each step's device time by kernel
                (utils/profiling.py::profile_step) (the glass step runs
                no counting kernel of its own); each kernel's roofline bound
                from this run's work counts; chain_grad_dense on the head
                box's tables (not culled) held to chain_grad and timed beside
                it; chain_grad under the identity thread-to-ray map beside the
                main path's 32x4 pixel tiles; the fill probe
                (50,800 triangles at 1024^2 against 512^2); the adjoints' CTAs
                per SM; the culled scans' blocks per lane, per warp and per CTA
                (roofline.py)
  9. grad       chain_grad, fed from the taping chain_trace (whose frame must
                equal chain_trace's), vs chain_grad_plain, head box 1920x1080
                with the main path's camera, g = d mean(img^2) / d img;
                run-to-run spread (<= 1e-4 of each output's largest entry);
                the ray cotangents' flips beside the parent's; under the
                main path's 32x4 pixel-tile map and the identity map (width
                0, render_hdr's where a chunk is not whole rows); its shadow
                scans on the staged route; then the same on baseline spheres
                (2 lights), whose sphere rows the head box has none of
 10. train      the training step of bench.py:95-124 through the entry points:
                head box 1920x1080, partition -> make_train_step with
                torch.optim.SGD(lr=1e-6) on mean(img^2), 8 steps, the launch
                counters reset before and read after: 8 taping chain_trace
                launches and 8 of chain_grad on the staged route; then its
                time per step
 11. glass      wavefront_trace vs trace_wavefront_plain (march and binary
                shadows) and wavefront_spp_trace vs its plain version (spp=8,
                same seed) on glass_sphere_scene 1920x1080 with the main path's
                camera, and wavefront_trace with the opaque sphere made a
                mirror (specular 0.5: reflection children off opaque hits);
                dropped pushes, the largest pop count of any ray
 12. glass path render_hdr of glass_sphere_scene at 1080p spp=1 and spp=8 with
                RenderConfig(use_pallas=True, chunk_size=whole frame), as
                bench.py:160-193 calls it, the launch counters reset before and
                read after; the spp=1 frame equals phase 11's kernel output
 13. glass grad wavefront_grad, fed from the counting wavefront_trace (whose
                frame must equal wavefront_trace's), vs wavefront_grad_plain
                on glass_sphere_scene 1920x1080 with the main path's camera,
                g = d mean(img^2) / d img, march and binary shadows, the
                deep-TIR config (max_depth 6, budget 100) and phase 11's
                mirror: ray cotangents, table rows, run-to-run spread
                (<= 1e-4), flips beside phase 11's and the parent's,
                dropped pushes; a tape overrun raises
                in the call that made it, or in the backward pass that made
                it (counts one short in one warp must raise, both ways)
 14. glass train the glass training step of bench.py:195-231 through the entry
                points: glass sphere at 256x256 and 1920x1080, partition ->
                make_train_step with SGD(lr=1e-6) on mean(img^2), the camera
                focal trained too, 8 steps per size, the launch counters reset
                before and read after each size: 8 counting wavefront_trace
                launches and 8 of wavefront_grad, none of them raising on a
                tape overrun on the trained scene
 15. dense      the culled chain_trace vs trace_chain_plain on the culled tables
                (which scans without culling) on dense_mesh_scene at 512x512,
                6,016 and 50,800 triangles; the culled spp_trace vs its plain
                version at 512x512 spp=8; render_hdr's frames against the C++
                engine's refbuild/dense_mesh_512.hdr64 and the full
                refbuild/dense_mesh_streamed_256.hdr64; the scrambled mesh's
                kernel time beside the unscrambled one
 16. dense grad chain_grad_dense vs chain_grad_dense_plain, g = d mean(img^2) /
                d img, at 512x512 as the training steps run it: dense_mesh_scene
                with 6,016 and 50,800 triangles on phase 15's tables and rays,
                and mixed_dense_scene; ray cotangents, table rows, run-to-run
                spread (global atomics), flips beside phase 15's
 17. dense train the dense training steps of bench.py:272-296 and :359-383
                through the entry points: 512x512, 6,016 and 50,800 triangles,
                SGD(lr=1e-6) on mean(img^2), the camera focal trained too, 8
                steps per size, the launch counters reset before and read
                after each size: 8 launches each of chain_trace and
                chain_grad_dense, none of chain_grad
 18. routes     the linear tables' two routes (csrc/trace_common.cuh::
                trace_route) at 320x180: chain_trace and spp_trace (spp=5) vs
                their plain versions on stress_scene with 337 spheres, one
                short of the stage limit (staged), and 338, past it (in
                place), the route counters read after each; the frames of
                the head box padded to 128 slots per family (in place) must
                equal the head box's (staged), at the default depth and at
                max_depth 1: padded slots never hit, their lights emit 0, and
                each ray's arithmetic is the same on both routes. Then the
                head-box adjoint's two routes (csrc/trace_common.cuh::
                grad_route), chain_grad fed from the taping chain_trace: the
                staged one vs chain_grad_plain on stress_scene with 337
                spheres (the ray cotangents and every table row but the
                spheres'), and its sphere rows vs chain_grad_plain in float64
                with g zeroed on both versions' flips, each entry within
                table_cot_rows' bound plus parity.F64_PLAIN_FACTOR times the
                float32 plain version's own distance from float64 (each row
                prints the factor it needs); the head box's and the
                padded head box's d_o and d_d (staged, in place), and the
                stress scene's and its padded copy's, must be equal bit for
                bit, at the default depth and at max_depth 1
 19. sample loop render_hdr's per-sample loop at spp=4 with
                RenderConfig(use_pallas=True, differentiable=True), training
                through make_train_step with SGD(lr=1e-6) on mean(img^2), one
                seed per step, the launch counters reset before and read after
                each: the head box at 1920x1080 (8 steps: 32 taping
                chain_trace, 32 chain_grad, no spp_trace), the glass sphere at
                256x256 (8 steps: 32 counting wavefront_trace, 32
                wavefront_grad) and dense_mesh_scene at 512x512 (2 steps: 8
                chain_trace, 8 chain_grad_dense, the culled tables packed once
                per chunk); the loop's 1080p frame vs spp_trace at the same
                seed; its gradient at 320x180 vs the integrators'
                (use_pallas=False); the CLI in-process (render --use-pallas at
                1080p spp=8, render at its defaults, aov, fit --steps 8, a JSON
                scene with refbuild/box.obj; files to out/cli_*); soft shadows
                and soft primary at 512x512 spp=2, one training step each, and
                soft shadows on stress_scene (64 spheres) with its peak memory;
                the loop's flipped pixels against spp_trace pinned
                (LOOP_AA_FLIPS)
 20. past smem  chain_grad_dense past one block's shared memory, its global
                sink (kernels/chain_grad.py::dense_sink): 3 training steps on
                stress_scene with 6,000 spheres (4 lights, 128 slots a family)
                at 512x512 through the entry points, the launch counters reset
                before and read after (3 linear chain_trace in place, 3
                chain_grad_dense on the global sink, no chain_grad); the
                kernel vs chain_grad_dense_plain on those tables and on the
                same spheres with dense_mesh_scene's mesh (culled), on 16,384
                of the rays at max_depth 2: ray cotangents, table rows (the
                sphere rows with g zeroed on the flipped rays), run-to-run
                spread (<= 1e-4); its time on the whole frame beside its bound
                (the work of those rays, scaled); its time at 5,281 spheres
                (one light, the shared sink's last count) and 5,282 (the
                global sink's first)
 21. glass >512 the glass sphere and a transparent mesh (563 primitives) at
                256x256: 3 training steps through the entry points, the
                forward on the culled wavefront_trace (one launch per chunk and
                step, no counting kernel, no wavefront_grad), the backward autograd of
                integrate_wavefront's replay with its warning; step time and
                peak memory; the gradient at 16x16 vs the CPU port's
 22. sharded    a one-rank NCCL group: render_hdr_sharded at 1080p spp=1 and
                spp=8 equal to render_hdr bit for bit; one make_sharded_loss
                step on the head box at 1080p vs the one-process step;
                render_hdr_faulttolerant at 1080p with an injected fault (a
                retry, render_hdr's frame); cli render --mesh; the kernel
                frames of the head box and the glass sphere at 32x24 vs the
                float64 oracle (golden/) at rtol 2e-3 / atol 3e-3
 23. glass culled the glass sphere scene with dense_mesh_scene's 6,016-triangle
                mesh made transparent (0.7, ior 1.3): render_hdr at 1080p
                spp=1 and spp=8 (march) and spp=1 (binary), and on the
                scrambled mesh, the launch counters reset before and read
                after (the culled instantiations only; the tables packed once
                per frame); the culled wavefront_trace (march, binary,
                counting) and wavefront_spp_trace (spp=8) against the linear
                kernels on whole frames, bit for bit (the counting kernel's
                pops per warp too; and at 61x47, whose last warp has lanes
                past the end), and against their plain versions on 4,096
                of the rays, 128 warps of neighbouring pixels (1,024 pixels
                at spp=8), under the seam budget;
                culled and linear kernel times in turns, the packing's and the
                frames' times; the crossover at 132, 320 and 560 triangles; 3
                training steps at 256x256 with a 320-triangle mesh (the
                counting culled forward, wavefront_grad on the linear tables);
                bounds from the subset's work (roofline.py), scaled, with the
                culled scans' blocks per lane, per warp and the warp-
                cooperative scan's turns
 24. native I/O native_bridge's host library (native/src, g++ and zlib; built in
                phase 2, before any writer) loaded and used with
                backend="native"; dense_mesh_scene's 50,800-triangle mesh
                and a 999,698-triangle grid written as OBJ and parsed natively
                and in Python: the same arrays, dtypes too, each parse's host
                time the median of 3; a JSON scene of that mesh, a floor and
                two lights through load_scene_json (equal to dense_mesh_scene's
                leaf for leaf), rendered by render_hdr at 512x512 spp=1 with
                the launch counters reset before and read after (one culled
                chain_trace), the frame vs trace_chain_plain on 4,096 of its
                rays; write_ppm (the same bytes) and write_png (the same
                pixels) on both backends; cli render of the JSON scene

Kernel-vs-plain comparisons use the seam budget: elementwise HDR atol 1e-4,
except at most max(4, 1e-3 * pixels) closest-hit seam-tie pixels (nvcc
contracts a*b+c into FMAs, plain PyTorch does not, so a ray that grazes an
edge can pick the other primitive). The adjoint's ray cotangents take the
same pixel budget at atol 1e-3 of the largest plain entry; each table row's
cotangents lie within 1e-3 of the row's largest plain entry plus 2e-3 of
their own (parity.table_cot_rows: fp32 sums over 2M rays in another order,
shared-memory atomics, and the rays of the flipped pixels, each one ray's
share of a sum over ~10^5 rays).

The glass kernels are held to their plain versions under the same seam
budget; a flip there is a shadow or refraction ray that grazes a sphere and
takes the other branch. The glass adjoint is held to its plain version as
chain_grad is (ray cotangents and table rows). The dense kernels take the
same budgets; their plain versions scan every triangle, so they check the
kernels' culling too. The frames against the C++ engine: p99.9 of the HDR
difference below 5e-5 and at most 2e-5 of the LDR subpixels more than one
byte off (tests/test_reference_parity.py).

Run with no arguments on a machine with one CUDA card:  python3 chip_smoke.py
Any failed phase raises and the script exits non-zero. It prints its total
time before the card's line. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel's launch
count on the main path, error against its plain version, and times.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
W1080, H1080 = 1920, 1080
#: The ray-cotangent seam-flip pixels (d_o, d_d) of the adjoints against
#: their plain versions at phases 9 and 13's shapes, as the tree before the
#: adjoints took the forward's tape and counts measured them
#: (chip_kernel_times.py --adjoints on that tree, NVIDIA H100 80GB HBM3,
#: 700 W; PERF.md §6).
PARENT_FLIPS = {"head box": (12, 12), "spheres": (0, 0), "glass march": (0, 0),
                "glass binary": (0, 0), "glass deep TIR": (0, 0)}
#: Phase 19's flipped pixels of the per-sample loop's 1080p spp=4 frame
#: against spp_trace at seed 77 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
#: the camera divides by a square root where the kernel multiplies by rsqrt,
#: so seam rays fall either side. A rise past it fails the phase.
LOOP_AA_FLIPS = 210


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card")
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
    from raytracingengine_tpu_torch.imageio import read_hdr64, read_png, read_ppm, write_png
    from raytracingengine_tpu_torch.inverse import combine, make_train_step, partition
    from raytracingengine_tpu_torch.kernels import _build
    from raytracingengine_tpu_torch.kernels import chain_grad as cg
    from raytracingengine_tpu_torch.kernels import chain_trace as ct
    from raytracingengine_tpu_torch.kernels import spp_trace as st
    from raytracingengine_tpu_torch.kernels import wavefront_grad as wg
    from raytracingengine_tpu_torch.kernels import wavefront_trace as wt
    from raytracingengine_tpu_torch.parity import (
        F64_PLAIN_FACTOR,
        TABLE_ROWS,
        f64_factors_needed,
        golden_ldr_mismatches,
        grad_leaf_mismatches,
        ray_cot_seam_budget,
        reference_frame_stats,
        seam_budget,
        sphere_rows_vs_f64,
        table_cot_rows,
        table_cot_rows_vs_f64,
    )
    from raytracingengine_tpu_torch.render import pipeline
    from raytracingengine_tpu_torch.render.config import RenderConfig
    from raytracingengine_tpu_torch.render.pipeline import mean_direction, render_hdr
    from raytracingengine_tpu_torch.roofline import (
        ChainWork,
        WavefrontWork,
        adjoint_bytes,
        bound_ms,
        chain_tape_bytes,
        chain_work,
        trace_bytes,
        taped_adjoint_bytes,
        wavefront_bound_ms,
        wavefront_work,
        work_ops,
    )
    from raytracingengine_tpu_torch.scenes import (
        baseline_sphere_scene,
        dense_mesh_scene,
        glass_sphere_scene,
        head_box_scene,
        mixed_dense_scene,
        stress_scene,
    )
    from raytracingengine_tpu_torch.tonemap import to_uint8, tonemap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load_library()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {lib_path.relative_to(ROOT)}", flush=True)
    # the native I/O library, before any writer uses it (phase 24 checks it)
    from raytracingengine_tpu_torch import native_bridge

    t0 = time.perf_counter()
    nb_path = native_bridge.build()
    nb_build_s = time.perf_counter() - t0
    print(f"  native I/O: {native_bridge.CXX} {' '.join(native_bridge.CXX_FLAGS)} native/src/"
          f"{{{','.join(native_bridge.SOURCES)}}} {' '.join(native_bridge.LIBS)} -> "
          f"{nb_path.relative_to(ROOT)} in {nb_build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")
    lib = _build.load_library()
    print("  CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, 128 threads): chain_trace "
          f"in place {lib.rte_chain_trace_occupancy(0, 0)}, culled {lib.rte_chain_trace_occupancy(1, 0)}, "
          f"staged {lib.rte_chain_trace_occupancy(2, 0)}; its taping kernels in place "
          f"{lib.rte_chain_trace_occupancy(0, 1)}, staged {lib.rte_chain_trace_occupancy(2, 1)}; "
          f"spp_trace in place {lib.rte_spp_trace_occupancy(0)}, culled "
          f"{lib.rte_spp_trace_occupancy(1)}, staged {lib.rte_spp_trace_occupancy(2)} (staged: at "
          "the largest stage, csrc/trace_common.cuh::kStageMaxBytes); wavefront_trace "
          f"{lib.rte_wavefront_trace_occupancy(0, 0)}, its counting kernel "
          f"{lib.rte_wavefront_trace_occupancy(1, 0)}, wavefront_spp_trace "
          f"{lib.rte_wavefront_spp_trace_occupancy(0)}; culled (WarpCulledTris): wavefront_trace "
          f"{lib.rte_wavefront_trace_occupancy(0, 1)}, counting {lib.rte_wavefront_trace_occupancy(1, 1)}, "
          f"wavefront_spp_trace {lib.rte_wavefront_spp_trace_occupancy(1)}", flush=True)

    def cfg_for(width: int, height: int) -> RenderConfig:
        return RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=width * height)

    def budget(name: str, ours: torch.Tensor, ref: torch.Tensor):
        report = seam_budget(ours.cpu().numpy(), ref.cpu().numpy())
        ok = report.ok and bool(torch.isfinite(ours).all())
        print(f"  {'PASS' if ok else 'FAIL'} {name}: {report}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: {report}")
        return report

    # 3. chain kernel vs plain at the main path's shapes
    scene, cam = head_box_scene(width=W1080, height=H1080, spp=1, device=dev)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    cfg = cfg_for(W1080, H1080)
    px, py = cam.pixel_grid()
    o, d = cam.rays_for_pixels(px, py)
    o = o.contiguous()
    ct.chain_trace.routes = ct.new_route_counts()
    chain_out = ct.chain_trace(tables, o, d, cfg)
    sync()
    chain_ref = ct.trace_chain_plain(tables, o, d, cfg)
    sync()
    print(f"[3 chain] head box 1920x1080 spp=1, launches per route {ct.chain_trace.routes}",
          flush=True)
    chain_report = budget("chain_trace vs trace_chain_plain", chain_out, chain_ref)
    del chain_ref

    # 4. AA kernel vs plain, same seed -> same jitter bits
    _, cam8 = head_box_scene(width=W1080, height=H1080, spp=8, device=dev)
    spp_out = st.spp_trace(tables, cam8, px, py, cfg, seed=1234)
    sync()
    spp_ref = st.spp_trace_plain(tables, cam8, px, py, cfg, seed=1234)
    sync()
    print("[4 AA] head box 1920x1080 spp=8 seed=1234", flush=True)
    spp_report = budget("spp_trace vs spp_trace_plain", spp_out, spp_ref)
    del spp_ref

    # 5. the real C++ engine's frame
    ref = read_hdr64(str(ROOT / "refbuild" / "baseline_spheres_256.hdr64"))
    s_scene, s_cam = baseline_sphere_scene(256, 256, spp=1, device=dev)
    img = render_hdr(s_scene, s_cam, cfg_for(256, 256))
    sync()
    p999, bad_frac = reference_frame_stats(img.cpu().numpy(), ref)
    ok = p999 < 5e-5 and bad_frac == 0.0
    print(f"[5 engine] baseline_spheres_256 vs C++ engine: p99.9 HDR diff {p999:.3e} "
          f"(< 5e-5), LDR subpixels >1 byte off {bad_frac:.3e} (0) -> "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("baseline_spheres_256 outside the reference-parity budget")

    # 6. golden bytes through the kernel
    g_scene, g_cam = head_box_scene(width=128, height=128, spp=1, device=dev)
    g_hdr = render_hdr(g_scene, g_cam, cfg_for(128, 128))
    sync()
    for op in ("aces", "simple"):
        gold = read_ppm(str(ROOT / "goldens" / f"head_box_128_{op}.ppm"))
        ours = to_uint8(tonemap(g_hdr, op)).cpu().numpy()
        errors = golden_ldr_mismatches(ours, gold)
        n_seam = int((np.abs(ours.astype(int) - gold.astype(int)).max(axis=2) > 1).sum())
        print(f"[6 goldens] head_box_128_{op}: {n_seam} seam-tie pixels -> "
              f"{'PASS' if not errors else 'FAIL ' + '; '.join(errors[:5])}", flush=True)
        if errors:
            raise AssertionError(f"head_box_128_{op}: {errors}")

    # 7. the main path, as a user calls it
    main_cells = [(W1080, H1080, 1), (W1080, H1080, 8), (1000, 1000, 32)]
    out_dir = ROOT / "out"
    out_dir.mkdir(exist_ok=True)
    sync()
    ct.chain_trace.launches = 0
    st.spp_trace.launches = 0
    ct.chain_trace.routes = ct.new_route_counts()
    st.spp_trace.routes = ct.new_route_counts()
    frames = {}
    for w, h, spp in main_cells:
        m_scene, m_cam = head_box_scene(width=w, height=h, spp=spp, device=dev)
        t0 = time.perf_counter()
        hdr = render_hdr(m_scene, m_cam, cfg_for(w, h), seed=2024)
        sync()
        frames[(w, h, spp)] = (hdr, time.perf_counter() - t0)
    launches = {"chain_trace": ct.chain_trace.launches, "spp_trace": st.spp_trace.launches}
    main_routes = {"chain_trace": dict(ct.chain_trace.routes), "spp_trace": dict(st.spp_trace.routes)}
    print(f"[7 main path] launches {launches}, per route {main_routes}", flush=True)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if any(r["staged"] != launches[k] for k, r in main_routes.items()):
        raise AssertionError(f"the head box left the staged route: {main_routes}")
    for (w, h, spp), (hdr, secs) in frames.items():
        ldr = to_uint8(tonemap(hdr, "aces")).cpu().numpy()
        # The box fills the center (blue); the top edge's center is the white
        # ceiling (grey) at every aspect ratio, where a corner at 16:9 is a
        # colored side wall.
        center, top = ldr[h // 2, w // 2].astype(int), ldr[2, w // 2].astype(int)
        finite = bool(torch.isfinite(hdr).all())
        blue = center[2] > max(center[0], center[1]) + 20
        grey = top.max() - top.min() <= 4 and top.min() > 32
        path = out_dir / f"head_box_{w}x{h}_spp{spp}.png"
        write_png(str(path), ldr)
        ok = finite and blue and grey and hdr.shape == (h, w, 3)
        print(f"  {'PASS' if ok else 'FAIL'} head box {w}x{h} spp={spp}: first call "
              f"{secs * 1e3:.1f} ms, finite={finite}, mean {float(hdr.mean()):.4f}, "
              f"center {center.tolist()} (blue), top {top.tolist()} (grey) "
              f"-> {path.relative_to(ROOT)}", flush=True)
        if not ok:
            raise AssertionError(f"main path render {w}x{h} spp={spp} failed its checks")
    del frames, hdr

    # 9. the adjoint kernel vs its plain version, at the main path's camera
    plain_call_ms = {}  # label -> CUDA-event ms of check_grad's plain call

    def check_grad(label: str, kernel, plain, tables, o, d, g, cfg, spread_rtol=None, skip_rows=(),
                   keep=None, **kw):
        """An adjoint kernel vs its plain version -> (ray-cotangent seam
        reports, max|diff| over every output); holds each table row to its
        bound, except the rows of the tables in `skip_rows`, which it prints
        only; prints the run-to-run spread of two kernel calls, and with
        `spread_rtol` holds each output's spread to that share of its
        largest entry (the run-to-run tolerance of the kernels' atomics).
        `keep`, a list, gets (kernel's outputs, plain's outputs). `kw` goes
        to the kernel (chain_grad's map width and tape, wavefront_grad's
        counts)."""
        name = kernel.__name__
        ours = kernel(tables, o, d, g, cfg, **kw)
        sync()
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = plain(tables, o, d, g, cfg)
        end.record()
        end.synchronize()
        plain_call_ms[label] = start.elapsed_time(end)
        print(f"  {label}: {plain.__name__} first call {time.perf_counter() - t0:.2f} s", flush=True)
        rerun = kernel(tables, o, d, g, cfg, **kw)
        sync()
        reports = {}
        for cot, a, b in (("d_o", ours[1], ref[1]), ("d_d", ours[2], ref[2])):
            report = ray_cot_seam_budget(a.cpu().numpy(), b.cpu().numpy())
            ok = report.ok and bool(torch.isfinite(a).all())
            print(f"  {'PASS' if ok else 'FAIL'} {label} {name} {cot} vs plain: {report}", flush=True)
            if not ok:
                raise AssertionError(f"{label} {name} {cot}: {report}")
            reports[cot] = report
        bad = []
        for table, a, b in zip(("sph", "pl", "tri", "mat", "light"), ours[0], ref[0]):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if table == "tri" and a.shape[0] == 13:  # culled: row 12, the original index, has none
                bad += ["tri row 12 carries a cotangent"] if a[12].any() or b[12].any() else []
                a, b = a[:12], b[:12]
            for row in table_cot_rows(table, a, b):
                held = table not in skip_rows
                verdict = ("PASS" if row.ok else "FAIL") if held else "not held:"
                print(f"  {verdict} {label} table {row}", flush=True)
                bad += [] if row.ok or not held else [str(row)]
        if bad:
            raise AssertionError(f"{label} {name} table rows out of budget: {bad}")
        outs = lambda r: (*r[0], r[1], r[2])  # noqa: E731
        err = max(float((a - b).abs().max()) for a, b in zip(outs(ours), outs(ref)))
        spread = max(float((a - b).abs().max()) for a, b in zip(outs(ours), outs(rerun)))
        rel = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                  for a, b in zip(outs(ours), outs(rerun)))
        atomics = "global and shared-memory" if kernel is cg.chain_grad_dense else "shared-memory"
        print(f"  {label}: max|diff| vs plain over all outputs {err:.3e}; run-to-run max|diff| "
              f"of two {name} calls ({atomics} atomics) {spread:.3e}, {rel:.3e} of the output's "
              "largest entry" + (f" (<= {spread_rtol:g})" if spread_rtol is not None else ""), flush=True)
        if spread_rtol is not None and not rel <= spread_rtol:
            raise AssertionError(f"{label} {name}: run-to-run spread {rel:.3e} > {spread_rtol:g}")
        if keep is not None:
            keep.append((ours, ref))
        return reports, err

    def flips_line(label: str, reports) -> str:
        """The ray-cotangent flips beside the parent's (PARENT_FLIPS)."""
        parent = PARENT_FLIPS.get(label)
        return (f"{label}: seam-flip pixels d_o {reports['d_o'].flips}, d_d {reports['d_d'].flips} "
                + (f"(the parent's: {parent[0]}, {parent[1]})" if parent else "(the parent's: not measured)"))

    print("[9 grad] head box 1920x1080 spp=1, g = d mean(img^2) / d img; chain_grad fed from the "
          "taping chain_trace", flush=True)
    g = (2.0 * chain_out / chain_out.numel()).contiguous()
    taped_out, tape = ct.chain_trace(tables, o, d, cfg, tape=True)
    sync()
    if not torch.equal(taped_out, chain_out):
        raise AssertionError("the taping chain_trace's frame differs from chain_trace's")
    cg.chain_grad.routes = dict.fromkeys(ct.ROUTES, 0)
    cot_reports, grad_err = check_grad("head box", cg.chain_grad, cg.chain_grad_plain, tables, o, d, g, cfg,
                                       spread_rtol=1e-4, width=W1080, tape=tape)
    print(f"  {flips_line('head box', cot_reports)}; the taping forward's frame equals "
          "chain_trace's bit for bit", flush=True)
    # render_hdr takes the identity thread-to-ray map (width 0) wherever a
    # chunk is not whole rows of the image; it groups other rays in a warp
    id_reports, id_err = check_grad("head box, identity map", cg.chain_grad, cg.chain_grad_plain, tables,
                                    o, d, g, cfg, spread_rtol=1e-4, width=0, tape=tape)
    print(f"  {flips_line('head box, identity map', id_reports)}; chain_grad per route "
          f"{cg.chain_grad.routes} (staged)", flush=True)
    if cg.chain_grad.routes["staged"] != cg.chain_grad.launches or not cg.chain_grad.launches:
        raise AssertionError(f"the head-box adjoint left the staged route: {cg.chain_grad.routes}")
    grad_err = max(grad_err, id_err)
    del taped_out
    print("[9 grad] baseline spheres (2 lights) 1920x1080 spp=1, g = d mean(img^2) / d img",
          flush=True)
    b_scene, b_cam = baseline_sphere_scene(W1080, H1080, spp=1, n_lights=2, device=dev)
    b_tables = ct.pack_scene_tables(flatten_scene(b_scene))
    b_o, b_d = b_cam.rays_for_pixels(*b_cam.pixel_grid())
    b_o = b_o.contiguous()
    b_img, b_tape = ct.chain_trace(b_tables, b_o, b_d, cfg, tape=True)
    for label, width in (("spheres", W1080), ("spheres, identity map", 0)):
        b_reports, b_err = check_grad(label, cg.chain_grad, cg.chain_grad_plain, b_tables, b_o, b_d,
                                      (2.0 * b_img / b_img.numel()).contiguous(), cfg, spread_rtol=1e-4,
                                      width=width, tape=b_tape)
        print(f"  {flips_line(label, b_reports)}", flush=True)
        grad_err = max(grad_err, b_err)
    del b_scene, b_cam, b_tables, b_o, b_d, b_img, b_tape

    # 10. the training step, as a user calls it (bench.py:95-124)
    print("[10 train] head box 1920x1080 spp=1, SGD(lr=1e-6) on mean(img^2), 8 steps", flush=True)
    t_scene, t_cam = head_box_scene(width=W1080, height=H1080, spp=1, device=dev)
    params, static = partition(t_scene)
    focal = t_cam.focal.clone().requires_grad_(True)  # the camera trains too
    t_cam = dataclasses.replace(t_cam, focal=focal)
    opt = torch.optim.SGD([*params.values(), focal], lr=1e-6)
    mean_sq = lambda img, _target: (img * img).mean()  # noqa: E731
    train_step = make_train_step(t_cam, cfg, opt, loss_fn=mean_sq)
    sync()
    ct.chain_trace.launches = 0
    ct.chain_trace.tape_launches = 0
    ct.chain_trace.routes = ct.new_route_counts()
    cg.chain_grad.launches = 0
    cg.chain_grad.routes = dict.fromkeys(ct.ROUTES, 0)
    losses, grads = [], {}
    for _ in range(8):
        loss, grads = train_step(params, static, None)
        losses.append(loss)
        grads = {**grads, "camera.focal": focal.grad}
    sync()
    train_launches = {"chain_trace": ct.chain_trace.launches, "chain_grad": cg.chain_grad.launches}
    train_tapes = ct.chain_trace.tape_launches
    losses = [float(x) for x in losses]
    # a leaf that never reaches the loss (an empty sphere family) has no grad
    finite = all(np.isfinite(losses)) and all(
        v is None or bool(torch.isfinite(v).all()) for v in grads.values())
    groups = {
        "geometry": ("spheres.centers", "spheres.radii", "triangles.v0", "triangles.v1",
                     "triangles.v2"),
        "materials": tuple(k for k in grads if ".materials." in k),
        "lights": tuple(k for k in grads if k.startswith("lights.")),
        "camera focal": ("camera.focal",),
    }
    nonzero = {name: any(grads.get(k) is not None and bool((grads[k] != 0).any()) for k in keys)
               for name, keys in groups.items()}
    print(f"  launches {train_launches} (8 each; chain_trace per route {ct.chain_trace.routes}, "
          f"{train_tapes} of them taping; chain_grad per route {cg.chain_grad.routes}); "
          f"losses {losses[0]:.6f} -> {losses[-1]:.6f}; finite={finite}; non-zero grads {nonzero}",
          flush=True)
    if (train_launches != {"chain_trace": 8, "chain_grad": 8} or ct.chain_trace.routes["staged"] != 8
            or train_tapes != 8 or cg.chain_grad.routes["staged"] != 8):
        raise AssertionError(f"the training step did not run through the taping chain_trace and the "
                             f"staged chain_grad: {train_launches}, {ct.chain_trace.routes}, "
                             f"{train_tapes} taping, {cg.chain_grad.routes}")
    if not finite or not all(nonzero.values()):
        raise AssertionError(f"training step: finite={finite}, non-zero gradients {nonzero}")

    # 11. the glass kernels vs their plain versions at the main path's shapes
    print("[11 glass] glass_sphere_scene 1920x1080, main path camera", flush=True)
    glass, gcam = glass_sphere_scene(W1080, H1080, spp=1, device=dev)
    g_tables = ct.pack_scene_tables(flatten_scene(glass))
    g_o, g_d = gcam.rays_for_pixels(px, py)
    g_o = g_o.contiguous()
    glass_cfg = RenderConfig(use_pallas=True, chunk_size=W1080 * H1080)  # march shadows
    glass_reports, glass_out, g_work = {}, {}, {}
    for mode in ("march", "binary"):
        gcfg = dataclasses.replace(glass_cfg, shadow_mode=mode)
        glass_out[mode] = wt.wavefront_trace(g_tables, g_o, g_d, gcfg)
        sync()
        t0 = time.perf_counter()
        ref = wt.trace_wavefront_plain(g_tables, g_o, g_d, gcfg)
        sync()
        print(f"  {mode}: trace_wavefront_plain first call {time.perf_counter() - t0:.2f} s", flush=True)
        glass_reports[mode] = budget(f"wavefront_trace vs trace_wavefront_plain, {mode} shadows",
                                     glass_out[mode], ref)
        g_work[mode] = wavefront_work(g_tables, g_o, g_d, gcfg)
        del ref
    # The opaque sphere made a mirror (specular 0.5, transparency 0): its
    # hits push a reflection child, the other arm of the kernels' test for
    # whether a hit can push a child (the glass scene's opaque surfaces
    # have specular 0). Phase 13 sizes the adjoint's tape by its counts.
    mirror_mat = g_tables.mat.clone()
    mirror_mat[TABLE_ROWS["mat"].index("specular"), 1] = 0.5  # sphere 1, the opaque one
    m_tables = dataclasses.replace(g_tables, mat=mirror_mat)
    glass_out["mirror"] = wt.wavefront_trace(m_tables, g_o, g_d, glass_cfg)
    glass_reports["mirror"] = budget("wavefront_trace vs trace_wavefront_plain, march shadows, the opaque "
                                     "sphere a mirror", glass_out["mirror"],
                                     wt.trace_wavefront_plain(m_tables, g_o, g_d, glass_cfg))
    g_work["mirror"] = wavefront_work(m_tables, g_o, g_d, glass_cfg)
    print(f"  the mirror: nodes popped {g_work['mirror'].pops} against the glass scene's "
          f"{g_work['march'].pops} (its reflections)", flush=True)
    if not g_work["mirror"].pops > g_work["march"].pops:
        raise AssertionError("the mirror scene pushed no reflection child")
    _, gcam8 = glass_sphere_scene(W1080, H1080, spp=8, device=dev)
    g_spp_out = wt.wavefront_spp_trace(g_tables, gcam8, px, py, glass_cfg, seed=1234)
    sync()
    t0 = time.perf_counter()
    g_spp_ref = wt.wavefront_spp_trace_plain(g_tables, gcam8, px, py, glass_cfg, seed=1234)
    sync()
    print(f"  wavefront_spp_trace_plain first call {time.perf_counter() - t0:.2f} s", flush=True)
    g_spp_report = budget("wavefront_spp_trace vs plain, spp=8 seed=1234", g_spp_out, g_spp_ref)
    del g_spp_ref
    print(f"  the glass forward kernels: one thread per ray (pixel), node_children only on hits that can "
          f"push a child; CTAs per SM wavefront_trace {lib.rte_wavefront_trace_occupancy(0, 0)}, its counting "
          f"kernel {lib.rte_wavefront_trace_occupancy(1, 0)}, wavefront_spp_trace "
          f"{lib.rte_wavefront_spp_trace_occupancy(0)} (phase 2: their registers; phase 8: their times against "
          "the plain versions and their bounds)", flush=True)
    dropped = wt.dropped_pushes()
    w = g_work["march"]
    print(f"  dropped pushes {dropped} (0); nodes popped per ray {w.pops / w.rays:.3f}, the most "
          f"by one ray {w.max_pops} (budget {glass_cfg.budget()}); shadow rays per ray "
          f"{w.shadow_rays / w.rays:.3f}, march steps per shadow ray "
          f"{w.march_steps / max(w.shadow_rays, 1):.3f}", flush=True)
    if dropped:
        raise AssertionError(f"the wavefront kernels dropped {dropped} pushes on a full stack")

    # 12. the glass path, as a user calls it (bench.py:160-193)
    glass_cells = [(W1080, H1080, 1), (W1080, H1080, 8)]
    sync()
    wt.wavefront_trace.launches = 0
    wt.wavefront_spp_trace.launches = 0
    glass_frames = {}
    for w_, h_, spp in glass_cells:
        m_scene, m_cam = glass_sphere_scene(w_, h_, spp=spp, device=dev)
        t0 = time.perf_counter()
        hdr = render_hdr(m_scene, m_cam, RenderConfig(use_pallas=True, chunk_size=w_ * h_), seed=2024)
        sync()
        glass_frames[spp] = (hdr, time.perf_counter() - t0)
    glass_launches = {"wavefront_trace": wt.wavefront_trace.launches,
                      "wavefront_spp_trace": wt.wavefront_spp_trace.launches}
    print(f"[12 glass path] launches {glass_launches}", flush=True)
    if min(glass_launches.values()) < 1:
        raise AssertionError(f"a kernel of the glass path never launched: {glass_launches}")
    for spp, (hdr, secs) in glass_frames.items():
        finite = bool(torch.isfinite(hdr).all())
        ok = finite and hdr.shape == (H1080, W1080, 3)
        if spp == 1:  # the same camera rays as phase 11
            same = float((hdr.reshape(-1, 3) - glass_out["march"]).abs().max())
            ok = ok and same <= 1e-6
        path = out_dir / f"glass_sphere_{W1080}x{H1080}_spp{spp}.png"
        write_png(str(path), to_uint8(tonemap(hdr, "aces")).cpu().numpy())
        print(f"  {'PASS' if ok else 'FAIL'} glass 1080p spp={spp}: first call {secs * 1e3:.1f} ms, "
              f"finite={finite}, mean {float(hdr.mean()):.4f}"
              + (f", max|diff| vs phase 11 kernel {same:.3e} (<= 1e-6)" if spp == 1 else "")
              + f" -> {path.relative_to(ROOT)}", flush=True)
        if not ok:
            raise AssertionError(f"glass path render spp={spp} failed its checks")
    del glass_frames, hdr

    # 13. the glass adjoint kernel vs its plain version, at the main path's camera
    print("[13 glass grad] glass_sphere_scene 1920x1080 spp=1, main path camera, "
          "g = d mean(img^2) / d img; wavefront_grad fed from the counting wavefront_trace", flush=True)
    wg_reports, wg_g, wg_err, wg_pops = {}, {}, 0.0, {}
    # march and binary shadows at the main path's config; then the deep-TIR
    # config of the JAX package's adjoint tests (max_depth 6, budget 100:
    # trees the budget cuts, with nodes left on the stack); then phase 11's
    # mirror, whose reflection children the counts must cover
    deep_cfg = dataclasses.replace(glass_cfg, max_depth=6, wavefront_budget=100)
    for mode, gcfg, w_tables in (("march", glass_cfg, g_tables),
                                 ("binary", dataclasses.replace(glass_cfg, shadow_mode="binary"), g_tables),
                                 ("deep TIR", deep_cfg, g_tables), ("mirror", glass_cfg, m_tables)):
        img_c, wg_pops[mode] = wt.wavefront_trace(w_tables, g_o, g_d, gcfg, count=True)
        sync()
        if mode in glass_out and not torch.equal(img_c, glass_out[mode]):
            raise AssertionError(f"the counting wavefront_trace's {mode} frame differs from wavefront_trace's")
        wg_g[mode] = (2.0 * img_c / img_c.numel()).contiguous()
        wg_reports[mode], err = check_grad(f"glass {mode}", wg.wavefront_grad, wg.wavefront_grad_plain,
                                           w_tables, g_o, g_d, wg_g[mode], gcfg, spread_rtol=1e-4,
                                           warp_pops=wg_pops[mode])
        pops = wg_pops[mode].to(torch.int64)
        print(f"  {flips_line(f'glass {mode}', wg_reports[mode])}; tape slots of 32 nodes "
              f"{int(pops.sum())} for {g_o.shape[0]} rays ({32 * float(pops.sum()) / g_o.shape[0]:.3f} "
              f"node slots per ray, the most in one warp {int(pops.max())}); no tape overrun "
              "(wavefront_grad raises on one)", flush=True)
        wg_err = max(wg_err, err)
        del img_c
    # A tape overrun raises in the call that made it: the counts of the
    # warp that popped the most, one short.
    short = wg_pops["march"].clone()
    short[int(short.argmax())] -= 1
    try:
        wg.wavefront_grad(g_tables, g_o, g_d, wg_g["march"], glass_cfg, warp_pops=short)
    except RuntimeError as e:
        if "popped more nodes" not in str(e):
            raise
        print(f"  PASS counts one short in one warp: wavefront_grad raised in the same call: {e}",
              flush=True)
    else:
        raise AssertionError("wavefront_grad did not raise on counts one short of the forward's")

    def adjoint_in_backward(grad):  # as WavefrontTraceFused.backward calls it
        wg.wavefront_grad(g_tables, g_o, g_d, wg_g["march"], glass_cfg, warp_pops=short, defer_check=True)
        return grad

    probe = torch.zeros(1, device=dev, requires_grad=True)
    probe_out = probe * 1.0
    probe_out.register_hook(adjoint_in_backward)
    try:
        probe_out.sum().backward()
    except RuntimeError as e:
        if "popped more nodes" not in str(e):
            raise
        print(f"  PASS the same, the check deferred to the end of the backward pass: backward() raised: {e}",
              flush=True)
    else:
        raise AssertionError("the backward pass did not raise on counts one short of the forward's")
    dropped = wt.dropped_pushes()
    print("  seam-flip pixels of the adjoint (d_o, d_d): " + ", ".join(
        f"{m} {r['d_o'].flips}, {r['d_d'].flips}" for m, r in wg_reports.items())
        + "; of the forward (phase 11): " + ", ".join(f"{m} {r.flips}" for m, r in glass_reports.items())
        + f"; dropped pushes {dropped} (0)", flush=True)
    if dropped:
        raise AssertionError(f"the glass kernels dropped {dropped} pushes on a full stack")

    # 14. the glass training step, as a user calls it (bench.py:195-231)
    print("[14 glass train] glass sphere, SGD(lr=1e-6) on mean(img^2), camera focal trained too, "
          "8 steps per size", flush=True)
    glass_steps, glass_train_launches = {}, {}
    for w_, h_ in ((256, 256), (W1080, H1080)):
        gs, gc = glass_sphere_scene(w_, h_, spp=1, device=dev)
        gp, gst = partition(gs)
        gfocal = gc.focal.clone().requires_grad_(True)
        gc = dataclasses.replace(gc, focal=gfocal)
        gopt = torch.optim.SGD([*gp.values(), gfocal], lr=1e-6)
        gstep = make_train_step(gc, RenderConfig(use_pallas=True, chunk_size=w_ * h_), gopt,
                                loss_fn=mean_sq)
        sync()
        wt.wavefront_trace.launches = 0
        wt.wavefront_trace.count_launches = 0
        wg.wavefront_grad.launches = 0
        g_losses, g_grads = [], {}
        for _ in range(8):
            loss, g_grads = gstep(gp, gst, None)
            g_losses.append(loss)
        sync()
        launches_g = {"wavefront_trace": wt.wavefront_trace.launches,
                      "wavefront_grad": wg.wavefront_grad.launches}
        counting = wt.wavefront_trace.count_launches
        g_grads = {**g_grads, "camera.focal": gfocal.grad}
        g_losses = [float(x) for x in g_losses]
        finite = all(np.isfinite(g_losses)) and all(
            v is None or bool(torch.isfinite(v).all()) for v in g_grads.values())
        nz = lambda k: g_grads.get(k) is not None and bool((g_grads[k] != 0).any())  # noqa: E731
        nonzero = {
            "geometry": any(nz(k) for k in ("spheres.centers", "spheres.radii", "planes.points",
                                            "planes.normals")),
            "materials": any(nz(k) for k in g_grads if ".materials." in k),
            "glass transparency": bool(g_grads["spheres.materials.transparency"][0] != 0),
            "glass ior": bool(g_grads["spheres.materials.refractive_index"][0] != 0),
            "lights": any(nz(k) for k in g_grads if k.startswith("lights.")),
            "camera focal": nz("camera.focal"),
        }
        # After one step the opaque surfaces' transparency leaves 0 by lr * g,
        # and Scene.h makes such a surface a Fresnel reflector with a
        # refraction child: the trees grow.
        with torch.no_grad():
            t_work = wavefront_work(ct.pack_scene_tables(flatten_scene(combine(gp, gst))),
                                    *(x.contiguous() for x in gc.rays_for_pixels(*gc.pixel_grid())),
                                    RenderConfig(use_pallas=True))
        top = max((k for k in g_grads if g_grads[k] is not None and g_grads[k].numel()),
                  key=lambda k: float(g_grads[k].abs().max()))
        print(f"  {w_}x{h_}: launches {launches_g} (8 each, {counting} of wavefront_trace's counting; "
              f"no counting kernel of the adjoint's own); losses {g_losses[0]:.6f} -> "
              f"{g_losses[-1]:.6f}; finite={finite}; non-zero grads {nonzero}; largest |grad| "
              f"{top} {float(g_grads[top].abs().max()):.3e}; after 8 steps "
              f"{t_work.pops / t_work.rays:.3f} nodes per ray (at most {t_work.max_pops}); no adjoint "
              "tape overrun (wavefront_grad raises on one)", flush=True)
        if launches_g != {"wavefront_trace": 8, "wavefront_grad": 8} or counting != 8:
            raise AssertionError(f"the glass training step did not run through the counting "
                                 f"wavefront_trace and wavefront_grad: {launches_g}, {counting} counting")
        if not finite or not all(nonzero.values()):
            raise AssertionError(f"glass training step {w_}x{h_}: finite={finite}, non-zero {nonzero}")
        glass_steps[(w_, h_)] = (gstep, gp, gst)
        glass_train_launches[(w_, h_)] = launches_g

    def time_ms(fn, iters: int) -> float:
        """CUDA events around `iters` calls after one warm-up call."""
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def once_ms(fn):
        """-> (fn's result, CUDA-event ms of this one call). The dense plain
        versions take seconds, so their time is that of their checking call."""
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def in_turns(kernel, plain, k_iters: int, p_iters: int):
        """plain, kernel, kernel, plain -> (kernel ms, plain ms), each the
        mean of its two turns."""
        p1 = time_ms(plain, p_iters)
        k1 = time_ms(kernel, k_iters)
        k2 = time_ms(kernel, k_iters)
        p2 = time_ms(plain, p_iters)
        return (k1 + k2) / 2, (p1 + p2) / 2

    def report(label: str, ms: float, rays: int) -> None:
        print(f"  {label}: {ms:.3f} ms, {rays / ms / 1e3:.1f} Mrays/s [{card}]", flush=True)

    # 15. the dense forward: the culled kernels vs their plain versions
    print("[15 dense] dense_mesh_scene 512x512, culled tables ordered along the mean ray", flush=True)
    W512 = 512
    dense = {}  # label -> (tables, o, d, kernel frame)
    dense_reports, dense_plain_ms = {}, {}
    for label, kw in (("6016", {}), ("50800", dict(ni=128, nj=200))):
        t0 = time.perf_counter()
        d_scene, d_cam = dense_mesh_scene(W512, W512, spp=1, device=dev, **kw)
        d_flat = flatten_scene(d_scene)
        build_s = time.perf_counter() - t0
        d_o, d_d = d_cam.rays_for_pixels(*d_cam.pixel_grid())
        d_o = d_o.contiguous()
        d_tables, pack_ms = once_ms(lambda: ct.pack_forward_tables_perm(d_flat, mean_direction(d_d)))
        out = ct.chain_trace(d_tables, d_o, d_d, cfg)
        ref, dense_plain_ms[label] = once_ms(lambda: ct.trace_chain_plain(d_tables, d_o, d_d, cfg))
        print(f"  {d_flat.n_triangles} triangles: scene built in {build_s:.2f} s, tables packed in "
              f"{pack_ms:.1f} ms ({d_tables.n_blocks} blocks); trace_chain_plain "
              f"{dense_plain_ms[label] / 1e3:.2f} s", flush=True)
        dense_reports[label] = budget(f"culled chain_trace vs trace_chain_plain, {label} triangles",
                                      out, ref)
        dense[label] = (d_tables, d_o, d_d, out)
        del ref, d_scene, d_flat
    tables6, d_o6, d_d6, frame6 = dense["6016"]
    d_scene8, d_cam8 = dense_mesh_scene(W512, W512, spp=8, device=dev)
    spp_tables6 = ct.pack_forward_tables_perm(flatten_scene(d_scene8))  # no order at spp > 1
    dpx, dpy = d_cam8.pixel_grid()
    d_spp_out = st.spp_trace(spp_tables6, d_cam8, dpx, dpy, cfg, seed=1234)
    d_spp_ref, d_spp_plain_ms = once_ms(
        lambda: st.spp_trace_plain(spp_tables6, d_cam8, dpx, dpy, cfg, seed=1234))
    d_spp_report = budget("culled spp_trace vs spp_trace_plain, 6016 triangles 512x512 spp=8 seed=1234",
                          d_spp_out, d_spp_ref)
    del d_spp_ref
    for name, kw, size in (("dense_mesh_512", {}, 512),
                           ("dense_mesh_streamed_256", dict(ni=128, nj=200), 256)):
        r_scene, r_cam = dense_mesh_scene(size, size, spp=1, device=dev, **kw)
        img = render_hdr(r_scene, r_cam, cfg_for(size, size))
        sync()
        ref = read_hdr64(str(ROOT / "refbuild" / f"{name}.hdr64"))
        p999, bad_frac = reference_frame_stats(img.cpu().numpy(), ref)
        ok = p999 < 5e-5 and bad_frac <= 2e-5 and bool(torch.isfinite(img).all())
        path = out_dir / f"{name}.png"
        write_png(str(path), to_uint8(tonemap(img, "aces")).cpu().numpy())
        print(f"  {'PASS' if ok else 'FAIL'} {name} vs C++ engine: p99.9 HDR diff {p999:.3e} (< 5e-5), "
              f"LDR subpixels >1 byte off {bad_frac:.3e} (<= 2e-5) -> {path.relative_to(ROOT)}", flush=True)
        if not ok:
            raise AssertionError(f"{name} outside the reference-parity budget")
    scr_scene, _ = dense_mesh_scene(W512, W512, spp=1, scramble=7, device=dev)
    scr_tables = ct.pack_forward_tables_perm(flatten_scene(scr_scene), mean_direction(d_d6))
    scr_report = seam_budget(ct.chain_trace(scr_tables, d_o6, d_d6, cfg).cpu().numpy(), frame6.cpu().numpy())
    scr_ms = time_ms(lambda: ct.chain_trace(scr_tables, d_o6, d_d6, cfg), 10)
    unscr_ms = time_ms(lambda: ct.chain_trace(tables6, d_o6, d_d6, cfg), 10)
    print(f"  scrambled triangle order (scramble=7): chain_trace {scr_ms:.3f} ms vs {unscr_ms:.3f} ms "
          f"in authoring order [{card}]; the frames differ at {scr_report.flips} pixels (seam ties "
          "follow the authoring order; a number, not a gate)", flush=True)
    del scr_scene, scr_tables

    # 16. the dense adjoint vs its plain version
    print("[16 dense grad] g = d mean(img^2) / d img", flush=True)
    m_scene, m_cam = mixed_dense_scene(W512, W512, device=dev)
    m_o, m_d = m_cam.rays_for_pixels(*m_cam.pixel_grid())
    m_tables = ct.pack_forward_tables_perm(flatten_scene(m_scene), mean_direction(m_d))
    dense_grad = {}  # label -> (tables, o, d, g, ray-cotangent reports, max|diff|, plain ms)
    for label, (tb, to, td) in (
        ("6016 512x512", (tables6, d_o6, d_d6)),
        (f"mixed {m_tables.n_primitives} primitives 512x512", (m_tables, m_o.contiguous(), m_d)),
        ("50800 512x512", dense["50800"][:3]),
    ):
        img = ct.chain_trace(tb, to, td, cfg)
        gg = (2.0 * img / img.numel()).contiguous()
        t0 = time.perf_counter()
        reports, err = check_grad(label, cg.chain_grad_dense, cg.chain_grad_dense_plain, tb, to, td, gg, cfg,
                                  spread_rtol=1e-4)
        dense_grad[label] = (tb, to, td, gg, reports, err)
        print(f"  {label}: check {time.perf_counter() - t0:.1f} s", flush=True)
    print("  seam-flip pixels of the dense adjoint (d_o, d_d): " + ", ".join(
        f"{k} {v[4]['d_o'].flips}, {v[4]['d_d'].flips}" for k, v in dense_grad.items())
        + "; of the culled forward (phase 15): " + ", ".join(
            f"{k} {r.flips}" for k, r in dense_reports.items()), flush=True)
    del m_scene

    # 17. the dense training steps, as a user calls them (bench.py:272-296, :359-383)
    print("[17 dense train] 512x512, SGD(lr=1e-6) on mean(img^2), camera focal trained too, "
          "8 steps per size", flush=True)
    dense_steps, dense_train_launches = {}, {}
    for label, kw in (("6016", {}), ("50800", dict(ni=128, nj=200))):
        ds, dc = dense_mesh_scene(W512, W512, spp=1, device=dev, **kw)
        dp, dst = partition(ds)
        dfocal = dc.focal.clone().requires_grad_(True)
        dc = dataclasses.replace(dc, focal=dfocal)
        dopt = torch.optim.SGD([*dp.values(), dfocal], lr=1e-6)
        dstep = make_train_step(dc, cfg_for(W512, W512), dopt, loss_fn=mean_sq)
        sync()
        ct.chain_trace.launches = 0
        cg.chain_grad.launches = 0
        cg.chain_grad_dense.launches = 0
        d_losses, d_grads = [], {}
        for _ in range(8):
            loss, d_grads = dstep(dp, dst, None)
            d_losses.append(loss)
        sync()
        launches_d = {"chain_trace": ct.chain_trace.launches,
                      "chain_grad_dense": cg.chain_grad_dense.launches, "chain_grad": cg.chain_grad.launches}
        d_grads = {**d_grads, "camera.focal": dfocal.grad}
        d_losses = [float(x) for x in d_losses]
        finite = all(np.isfinite(d_losses)) and all(
            v is None or bool(torch.isfinite(v).all()) for v in d_grads.values())
        nz = lambda k: d_grads.get(k) is not None and bool((d_grads[k] != 0).any())  # noqa: E731
        nonzero = {
            "mesh vertices": any(nz(k) for k in ("triangles.v0", "triangles.v1", "triangles.v2")),
            "materials": any(nz(k) for k in d_grads if ".materials." in k),
            "lights": any(nz(k) for k in d_grads if k.startswith("lights.")),
            "camera focal": nz("camera.focal"),
        }
        print(f"  {label} triangles: launches {launches_d} (8, 8, 0); losses {d_losses[0]:.6f} -> "
              f"{d_losses[-1]:.6f}; finite={finite}; non-zero grads {nonzero}", flush=True)
        if launches_d != {"chain_trace": 8, "chain_grad_dense": 8, "chain_grad": 0}:
            raise AssertionError(f"the dense training step did not run through the dense kernels: {launches_d}")
        if not finite or not all(nonzero.values()):
            raise AssertionError(f"dense training step {label}: finite={finite}, non-zero {nonzero}")
        dense_steps[label] = (dstep, dp, dst)
        dense_train_launches[label] = launches_d

    # 18. the linear tables' two routes, each side of the stage limit
    W320, H180 = 320, 180
    depth1 = dataclasses.replace(cfg, max_depth=1)
    print(f"[18 routes] {W320}x{H180}, each side of the staged route's limit "
          "(csrc/trace_common.cuh::trace_route)", flush=True)
    route_reports, route_frames = {}, {}
    for label, route, make in (
        ("stress_scene, 337 spheres", "staged", lambda spp: stress_scene(
            337, width=W320, height=H180, spp=spp, pad_multiple=None, device=dev)),
        ("stress_scene, 338 spheres", "in_place", lambda spp: stress_scene(
            338, width=W320, height=H180, spp=spp, pad_multiple=None, device=dev)),
        ("head box padded to 128", "in_place", lambda spp: head_box_scene(
            width=W320, height=H180, spp=spp, pad_multiple=128, device=dev)),
        ("head box", "staged", lambda spp: head_box_scene(
            width=W320, height=H180, spp=spp, device=dev)),
    ):
        r_scene, r_cam = make(1)
        r_tables = ct.pack_scene_tables(flatten_scene(r_scene))
        r_o, r_d = r_cam.rays_for_pixels(*r_cam.pixel_grid())
        r_o = r_o.contiguous()
        _, r_cam5 = make(5)
        r_px, r_py = r_cam5.pixel_grid()
        ct.chain_trace.routes = ct.new_route_counts()
        st.spp_trace.routes = ct.new_route_counts()
        # default depth, then max_depth 1 (every live ray of a packet ends
        # on the depth limit's sky after one bounce)
        route_frames[label] = [(ct.chain_trace(r_tables, r_o, r_d, c),
                                st.spp_trace(r_tables, r_cam5, r_px, r_py, c, seed=5))
                               for c in (cfg, depth1)]
        counted = (dict(ct.chain_trace.routes), dict(st.spp_trace.routes))
        print(f"  {label} ({r_tables.n_spheres} spheres, {r_tables.n_planes} planes, "
              f"{r_tables.n_triangles} triangles, {r_tables.n_lights} lights): launches per route "
              f"(chain_trace, spp_trace) {counted}", flush=True)
        if counted[0][route] != 2 or counted[1][route] != 2:
            raise AssertionError(f"{label}: the kernels did not launch on route {route}: {counted}")
        if label.startswith("head box"):  # their plain versions: below, the kernels' frames
            continue
        route_reports[label] = (
            route,
            budget(f"{label} chain_trace vs trace_chain_plain ({route})", route_frames[label][0][0],
                   ct.trace_chain_plain(r_tables, r_o, r_d, cfg)),
            budget(f"{label} spp_trace vs spp_trace_plain, spp=5 ({route})",
                   route_frames[label][0][1],
                   st.spp_trace_plain(r_tables, r_cam5, r_px, r_py, cfg, seed=5)),
        )
    # Padded slots never hit and their lights emit 0, and each ray's
    # arithmetic is the same on both routes: the frames must be equal.
    for (depth, frames_s), frames_p in zip(((cfg.max_depth, route_frames["head box"][0]),
                                            (1, route_frames["head box"][1])),
                                           route_frames["head box padded to 128"]):
        for name, a, b in zip(("chain_trace", "spp_trace spp=5"), frames_s, frames_p):
            same = bool(torch.equal(a, b))
            what = f"head box (staged) vs head box padded to 128 (in place), {name}, max_depth {depth}"
            budget(f"{what}; bit-identical {same}", a, b)
            if not same:
                raise AssertionError(f"{what}: the two routes' frames differ")
    del route_frames

    # The head-box adjoint's two routes (csrc/trace_common.cuh::grad_route):
    # its shadow scans over the stage where the stage and the accumulator fit
    # one block, in place past the stage limit. The staged route on the
    # stress scene (337 spheres) against the plain version: the ray
    # cotangents and every table row but the spheres'. Each of its 337
    # spheres' columns sums the ~100 rays that hit it at 320x180, and the
    # seam-flip rays move the sphere rows by as much as their largest entry;
    # the sphere rows are held against float64 below. Then the stress scene
    # and the head box staged and padded past the limit (in place): each
    # ray's arithmetic is the same on both routes and the tapes come from
    # equal frames, so d_o and d_d must be equal bit for bit, and the table
    # cotangents of the real columns within the shared-memory atomics'
    # run-to-run spread.
    print("[18 routes] chain_grad fed from the taping chain_trace, each side of the stage limit",
          flush=True)

    def route_rays(make, depth_cfg):
        r_scene, r_cam = make()
        r_tables = ct.pack_scene_tables(flatten_scene(r_scene))
        r_o, r_d = r_cam.rays_for_pixels(*r_cam.pixel_grid())
        r_o = r_o.contiguous()
        img, r_tape = ct.chain_trace(r_tables, r_o, r_d, depth_cfg, tape=True)
        return r_tables, r_o, r_d, img, r_tape

    def real_columns(cots, tb, real):
        """The cotangents of the tables `tb` on the columns of the unpadded
        tables `real`: each family's first columns, and the material
        columns of those primitives (spheres, planes, triangles in order)."""
        sph, pl, tri, mat, light = cots
        ns, np_, nt = real.n_spheres, real.n_planes, real.n_triangles
        o_pl, o_tri = tb.n_spheres, tb.n_spheres + tb.n_planes
        return (sph[:, :ns], pl[:, :np_], tri[:, :nt], light[:, :real.n_lights],
                torch.cat([mat[:, :ns], mat[:, o_pl:o_pl + np_], mat[:, o_tri:o_tri + nt]], 1))

    stress = lambda n, pad=None: lambda: stress_scene(  # noqa: E731
        n, width=W320, height=H180, spp=1, pad_multiple=pad, device=dev)
    head_box = lambda pad=None: lambda: head_box_scene(  # noqa: E731
        width=W320, height=H180, spp=1, pad_multiple=pad, device=dev)
    label = "stress_scene, 337 spheres"
    r_tables, r_o, r_d, img, r_tape = route_rays(stress(337), cfg)
    r_g = (2.0 * img / img.numel()).contiguous()
    keep = []
    cg.chain_grad.routes = dict.fromkeys(ct.ROUTES, 0)
    stress_reports, _ = check_grad(f"{label} adjoint", cg.chain_grad, cg.chain_grad_plain, r_tables, r_o,
                                   r_d, r_g, cfg, spread_rtol=1e-4, skip_rows=("sph",), keep=keep,
                                   width=W320, tape=r_tape)
    (ours, ref), = keep
    # The sphere rows against a float64 reference (parity.sphere_rows_vs_f64):
    # chain_grad_plain on the same tables, rays and g in float64, g zeroed on
    # the kernel's seam-flip rays (held above under the seam budget) and on
    # the float32 plain version's own flips against float64 (rays where
    # float32 takes another closest hit; counted here). No float32 result
    # comes within table_cot_rows' bound of the float64 sums here (the plain
    # version's sphere rows miss it by 4-8x, PERF.md §6), so each entry is
    # held within that bound plus F64_PLAIN_FACTOR times the float32 plain
    # version's own distance from float64: the kernel is as close as the
    # plain version. Each row prints the factor its worst entry needs.
    sph_off, seam, seam64 = sphere_rows_vs_f64(r_tables, r_o, r_d, r_g, cfg, ours, ref, width=W320,
                                               tape=r_tape)
    if cg.chain_grad.routes["staged"] != 3:
        raise AssertionError(f"{label}: chain_grad left the staged route: {cg.chain_grad.routes}")
    off = f"g zeroed on {int((seam | seam64).sum())} rays (the kernel's {int(seam.sum())} seam flips, the " \
          f"float32 plain version's {int(seam64.sum())} flips against float64)"
    for name, rows in (("kernel", table_cot_rows("sph", sph_off[0], sph_off[2])),
                       ("float32 plain", table_cot_rows("sph", sph_off[1], sph_off[2]))):
        for row in rows:
            print(f"  witness (not held): {label} adjoint, {off}: {name} vs float64, table {row}", flush=True)
    err = lambda x: np.abs(x - sph_off[2])  # noqa: E731
    print(f"  {label} adjoint, {off}: sphere rows' summed |diff| vs float64, kernel "
          f"{err(sph_off[0]).sum(1).tolist()}, float32 plain {err(sph_off[1]).sum(1).tolist()}", flush=True)
    bad = []
    for row, need in zip(table_cot_rows_vs_f64("sph", *sph_off), f64_factors_needed("sph", *sph_off)):
        print(f"  {'PASS' if row.ok else 'FAIL'} {label} adjoint vs float64, {off}: table {row} (bound: "
              f"table_cot_rows' + {F64_PLAIN_FACTOR:g} x |float32 plain - float64|; |diff| / bound "
              f"{row.err / row.bound:.4f}; the factor its worst entry needs {need:.4f})", flush=True)
        bad += [] if row.ok else [str(row)]
    if bad:
        raise AssertionError(f"{label}: chain_grad's sphere rows farther from float64 than the float32 plain "
                             f"version allows: {bad}")
    del ours, ref, keep, sph_off
    for label, (make_staged, make_padded) in (
        ("stress_scene, 337 spheres", (stress(337), stress(337, 128))),
        ("head box", (head_box(), head_box(128))),
    ):
        for depth_cfg in (cfg, depth1):
            cg.chain_grad.routes = dict.fromkeys(ct.ROUTES, 0)
            staged, padded = route_rays(make_staged, depth_cfg), route_rays(make_padded, depth_cfg)
            r_g = (2.0 * staged[3] / staged[3].numel()).contiguous()
            outs = [cg.chain_grad(tb, to, td, r_g, depth_cfg, width=W320, tape=tp)
                    for tb, to, td, _, tp in (staged, padded)]
            sync()
            what = (f"chain_grad, {label} (staged) vs padded to 128 (in place), max_depth "
                    f"{depth_cfg.max_depth}, routes {cg.chain_grad.routes}")
            same = [torch.equal(a, b) for a, b in zip(outs[0][1:], outs[1][1:])]
            # the real columns of each table: the padded ones carry none
            spread = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                         for a, b in zip(real_columns(outs[0][0], staged[0], staged[0]),
                                         real_columns(outs[1][0], padded[0], staged[0]))
                         if a.numel())
            ok = (all(same) and torch.equal(staged[3], padded[3]) and spread <= 1e-4
                  and cg.chain_grad.routes == {"in_place": 1, "culled": 0, "staged": 1})
            print(f"  {'PASS' if ok else 'FAIL'} {what}: the taping forwards' frames and d_o, d_d "
                  f"bit-identical {torch.equal(staged[3], padded[3])}, {same}; table cotangents "
                  f"{spread:.3e} of each table's largest entry apart (<= 1e-4)", flush=True)
            if not ok:
                raise AssertionError(f"{what}: the two routes' frames or cotangents differ ({same}, {spread})")
            del staged, padded, outs

    # 19. the sample loop and the entry points
    t19 = time.perf_counter()
    print("[19 sample loop] spp > 1 training through the fused kernels (use_pallas, differentiable=True), "
          "the CLI in-process, soft shadows and soft primary", flush=True)

    def reset_counts():
        sync()
        for fn in (ct.chain_trace, st.spp_trace, cg.chain_grad, cg.chain_grad_dense, wt.wavefront_trace,
                   wt.wavefront_spp_trace, wg.wavefront_grad):
            fn.launches = 0
        ct.chain_trace.tape_launches = 0
        wt.wavefront_trace.count_launches = 0
        cg.chain_grad_dense.routes = dict.fromkeys(cg.DENSE_SINKS, 0)
        wt.wavefront_trace.routes = wt.new_route_counts()
        wt.wavefront_trace.count_routes = wt.new_route_counts()
        wt.wavefront_spp_trace.routes = wt.new_route_counts()

    def read_counts() -> dict:
        sync()
        return {"chain_trace": ct.chain_trace.launches, "taping": ct.chain_trace.tape_launches,
                "chain_grad": cg.chain_grad.launches, "chain_grad_dense": cg.chain_grad_dense.launches,
                "spp_trace": st.spp_trace.launches, "wavefront_trace": wt.wavefront_trace.launches,
                "counting": wt.wavefront_trace.count_launches,
                "wavefront_spp_trace": wt.wavefront_spp_trace.launches,
                "wavefront_grad": wg.wavefront_grad.launches,
                # the glass kernels' culled instantiations (WarpCulledTris)
                "culled": wt.wavefront_trace.routes["culled"],
                "culled counting": wt.wavefront_trace.count_routes["culled"],
                "spp culled": wt.wavefront_spp_trace.routes["culled"]}

    def loop_cfg(w_, h_, **kw) -> RenderConfig:
        return RenderConfig(use_pallas=True, differentiable=True, chunk_size=w_ * h_, **kw)

    def train_loop(label, scene_, cam_, cfg_, steps, expect, seed0=100):
        """`steps` training steps at the camera's spp through make_train_step
        (SGD lr=1e-6 on mean(img^2)), one seed per step, the launch counters
        reset before and read after -> (counts, ms per step, peak MiB, the
        step closure)."""
        params_, static_ = partition(scene_)
        step_ = make_train_step(cam_, cfg_, torch.optim.SGD(params_.values(), lr=1e-6), loss_fn=mean_sq)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses_ = [float(step_(params_, static_, None, seed0 + i)[0]) for i in range(steps)]
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        grads_ = {k: p.grad for k, p in params_.items()}
        finite_ = all(np.isfinite(losses_)) and all(v is None or bool(torch.isfinite(v).all())
                                                    for v in grads_.values())
        ok = finite_ and all(counts[k] == v for k, v in expect.items())
        print(f"  {'PASS' if ok else 'FAIL'} {label}: {steps} steps, launches {counts} (expected {expect}); "
              f"losses {losses_[0]:.6f} -> {losses_[-1]:.6f}; finite={finite_}; {ms:.3f} ms per step "
              f"(host clock, a float(loss) per step, the first step included); peak device memory "
              f"{peak:.1f} MiB [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"{label}: launches {counts}, expected {expect}; finite={finite_}")
        return counts, ms, peak, (lambda: step_(params_, static_, None, seed0),
                                  cam_.num_pixels * cam_.spp)

    loop_launches, loop_steps = {}, {}
    hb4, hb4_cam = head_box_scene(width=W1080, height=H1080, spp=4, device=dev)
    loop_launches["head box"], _, _, loop_steps["head box 1080p spp=4"] = train_loop(
        "head box 1920x1080 spp=4", hb4, hb4_cam, loop_cfg(W1080, H1080, shadow_mode="binary"), 8,
        {"chain_trace": 32, "taping": 32, "chain_grad": 32, "spp_trace": 0, "chain_grad_dense": 0})
    gl4, gl4_cam = glass_sphere_scene(256, 256, spp=4, device=dev)
    loop_launches["glass"], _, _, loop_steps["glass 256x256 spp=4"] = train_loop(
        "glass 256x256 spp=4 (march)", gl4, gl4_cam, loop_cfg(256, 256), 8,
        {"wavefront_trace": 32, "counting": 32, "wavefront_grad": 32, "wavefront_spp_trace": 0})
    packs = []
    pack_fn = pipeline.pack_forward_tables_perm
    pipeline.pack_forward_tables_perm = lambda *a: packs.append(1) or pack_fn(*a)
    try:
        dm4, dm4_cam = dense_mesh_scene(W512, W512, spp=4, device=dev)
        loop_launches["dense"], _, _, loop_steps["dense 512x512 spp=4"] = train_loop(
            "dense_mesh_scene 6016 triangles 512x512 spp=4", dm4, dm4_cam,
            loop_cfg(W512, W512, shadow_mode="binary"), 2,
            {"chain_trace": 8, "taping": 0, "chain_grad_dense": 8, "chain_grad": 0, "spp_trace": 0})
    finally:
        pipeline.pack_forward_tables_perm = pack_fn
    print(f"  dense: culled tables packed {len(packs)} times in 2 steps of one chunk (2: once per chunk, "
          "along the centre rays' mean direction, for every sample)", flush=True)
    if len(packs) != 2:
        raise AssertionError(f"the dense loop packed its tables {len(packs)} times in 2 steps")

    # The loop's frame against the in-kernel AA at the same seed: the same
    # jitter, rays built by the camera (a division by a square root) against
    # the kernel's rsqrt, so the seam budget and not equality.
    with torch.no_grad():
        reset_counts()
        loop_frame = render_hdr(hb4, hb4_cam, loop_cfg(W1080, H1080, shadow_mode="binary"), seed=77)
        frame_counts = read_counts()
        px4, py4 = hb4_cam.pixel_grid()
        aa_frame = st.spp_trace(ct.pack_scene_tables(flatten_scene(hb4)), hb4_cam, px4, py4, cfg, seed=77)
    print(f"  the loop's 1080p spp=4 frame (no grad; launches {frame_counts}) vs spp_trace, seed 77:", flush=True)
    loop_aa_report = budget("loop vs spp_trace, head box 1080p spp=4", loop_frame.reshape(-1, 3), aa_frame)
    print(f"  {'PASS' if loop_aa_report.flips <= LOOP_AA_FLIPS else 'FAIL'} the loop's flipped pixels "
          f"{loop_aa_report.flips} (pinned: at most {LOOP_AA_FLIPS})", flush=True)
    if loop_aa_report.flips > LOOP_AA_FLIPS:
        raise AssertionError(f"the loop's frame flips {loop_aa_report.flips} pixels against spp_trace, "
                             f"past the pinned {LOOP_AA_FLIPS}")
    if frame_counts["chain_trace"] != 4 or frame_counts["spp_trace"] != 0:
        raise AssertionError(f"the loop's frame did not take 4 chain_trace launches: {frame_counts}")
    del loop_frame, aa_frame

    # The loop's gradient against the integrators' (use_pallas=False) at
    # 320x180 spp=4; the camera nudged off-axis, as the CPU tests do, so no
    # centre ray falls exactly on a cube edge.
    small, small_cam = head_box_scene(width=W320, height=H180, spp=4, device=dev)
    small_cam = dataclasses.replace(small_cam, position=small_cam.position
                                    + torch.tensor([0.013, 0.007, 0.0], device=dev))
    route_grads = {}
    for route, c in (("kernels", loop_cfg(W320, H180, shadow_mode="binary")),
                     ("integrators", RenderConfig(shadow_mode="binary", chunk_size=W320 * H180))):
        sp, ss = partition(small)
        img = render_hdr(combine(sp, ss), small_cam, c, seed=5)
        (img * img).mean().backward()
        route_grads[route] = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.cpu().numpy()
                              for k, p in sp.items()}
    grad_errors = grad_leaf_mismatches(route_grads["kernels"], route_grads["integrators"])
    print(f"  {'PASS' if not grad_errors else 'FAIL'} head box 320x180 spp=4: the loop's scene gradient through "
          "the kernels vs the integrators' (use_pallas=False), parity.grad_leaf_mismatches: "
          f"{grad_errors or 'every leaf within rtol 2e-3, atol 2e-4 + 1e-3 max|leaf|'}", flush=True)
    if grad_errors:
        raise AssertionError(f"the loop's gradient differs from the integrators': {grad_errors}")

    # The CLI, in-process, as a user calls it; files to out/cli_*.
    from raytracingengine_tpu_torch.cli import main as cli_main

    def cli(label: str, argv: list[str]) -> str:
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        text = buf.getvalue()
        wrote = [line.split()[-1] for line in text.splitlines() if line.startswith("wrote ")]
        print(f"  {'PASS' if rc == 0 and wrote else 'FAIL'} cli {label}: {' '.join(argv)} -> rc {rc}, "
              f"{secs:.2f} s, launches {counts}, wrote {len(wrote)} files", flush=True)
        for line in text.splitlines():
            if not line.startswith(("wrote ", "{")):
                print(f"    {line} [{card}]", flush=True)
        if rc != 0 or not wrote or not all(Path(p).is_file() for p in wrote):
            raise AssertionError(f"cli {label} failed: rc {rc}, wrote {wrote}")
        return text, counts

    cli_text, cli_counts = cli("render --use-pallas 1080p spp=8", [
        "render", "--use-pallas", "--shadow-mode", "binary", "--width", str(W1080), "--height", str(H1080),
        "--spp", "8", "--out", str(out_dir / "cli_render_pallas")])
    loop_launches["cli"] = cli_counts
    if not cli_counts.get("spp_trace") or cli_counts.get("chain_trace"):
        raise AssertionError(f"cli render --use-pallas at spp=8 did not take the in-kernel AA: {cli_counts}")
    cli("render defaults 512x512", ["render", "--out", str(out_dir / "cli_render_defaults")])
    cli("aov 512x512", ["aov", "--out", str(out_dir / "cli_aov")])
    fit_text, _ = cli("fit --steps 8 256x256 (baseline spheres: their albedos)", [
        "fit", "--scene", "baseline_spheres", "--steps", "8", "--width", "256", "--height", "256",
        "--out", str(out_dir / "cli_fit")])
    fit_line = [x for x in fit_text.splitlines() if x.startswith("fit: loss")][0]
    fit_first, fit_last = (float(x) for x in fit_line.split()[2:5:2])
    box_json = out_dir / "cli_scene_box.json"
    box_json.write_text(json.dumps({
        "camera": {"position": [0, 0, -25], "focal": 500, "near": 0, "far": 200},
        "models": [{"obj": "../refbuild/box.obj", "translation": [0, 0, 10],
                    "material": {"color": [0, 0, 1], "specular": 0.5, "refractive_index": 1.5}}],
        "planes": [{"point": [0, -15, 0], "normal": [0, 1, 0], "material": {"color": [0.9, 0.9, 0.9]}},
                   {"point": [0, 0, 15], "normal": [0, 0, -1], "material": {"color": [0.9, 0.9, 0.9]}}],
        "lights": [{"position": [0, 0, -5], "intensity": 150}, {"position": [-2, 2, -5], "intensity": 150}],
    }))
    cli("render a JSON scene with refbuild/box.obj", [
        "render", "--scene", str(box_json), "--use-pallas", "--shadow-mode", "binary",
        "--out", str(out_dir / "cli_render_json")])
    box_ldr = read_png(str(out_dir / "cli_render_json" / "aces.png")).astype(int)
    box_centre = box_ldr[256, 256]
    print(f"  fit loss {fit_first:.6f} -> {fit_last:.6f} (falls); the JSON box's centre pixel "
          f"{box_centre.tolist()} (blue)", flush=True)
    if not fit_last < fit_first or not box_centre[2] > max(box_centre[0], box_centre[1]) + 20:
        raise AssertionError(f"cli: fit loss {fit_first} -> {fit_last}, JSON box centre {box_centre}")

    # Soft shadows and soft primary: the integrators on the card, one
    # training step each at 512x512 spp=2 (the per-sample loop);
    # visibility_soft builds [rays, spheres, 3]
    # per light, so soft shadows on stress_scene (64 spheres in 128 slots, 4
    # lights) also render forward only, at render_hdr's default chunk size,
    # for their peak memory (a training step there would hold every bounce's
    # [rays, 128, 3] tensors of the whole frame until the backward).
    soft_cells = (("soft shadows, baseline spheres", baseline_sphere_scene,
                   RenderConfig(shadow_mode="soft", chunk_size=W512 * W512), True),
                  ("soft primary, baseline spheres", baseline_sphere_scene,
                   RenderConfig(shadow_mode="binary", soft_primary=True, use_pallas=True,
                                chunk_size=W512 * W512), True),
                  ("soft shadows, stress_scene 64 spheres", lambda w, h, **k: stress_scene(width=w, height=h, **k),
                   RenderConfig(shadow_mode="soft"), False))
    for label, make, c, train in soft_cells:
        s_scene, s_cam = make(W512, W512, spp=2 if train else 1, device=dev)
        sp, ss = partition(s_scene)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(train):
            img = render_hdr(combine(sp, ss), s_cam, c)
            if train:
                (img * img).mean().backward()
        sync()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        g_c = sp["spheres.centers"].grad
        finite = bool(torch.isfinite(img).all()) and all(p.grad is None or bool(torch.isfinite(p.grad).all())
                                                         for p in sp.values())
        moved = g_c is not None and bool((g_c != 0).any())
        ok = finite and (moved or not train) and not counts and img.shape == (W512, W512, 3)
        what = ("one training step (forward, backward) at spp=2" if train
                else "forward only at spp=1 (default chunk size)")
        print(f"  {'PASS' if ok else 'FAIL'} {label} 512x512: {what} {secs:.3f} s, finite={finite}"
              + (f", |d loss / d sphere centres| max {float(g_c.abs().max()) if moved else 0.0:.3e}" if train else "")
              + f", kernel launches {counts} (none: no kernel covers it), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"{label}: finite={finite}, centre grad moved={moved}, launches {counts}")
        del img, sp, ss
    phase19_s = time.perf_counter() - t19
    print(f"  phase 19 took {phase19_s:.1f} s (target: 90 s)", flush=True)

    # 20. the dense adjoint past one block's shared memory: the global sink
    t20 = time.perf_counter()
    print("[20 dense past shared memory] chain_grad_dense's global sink (kernels/chain_grad.py::dense_sink)",
          flush=True)
    s6k, c6k = stress_scene(6000, width=W512, height=W512, device=dev)  # 4 lights, 128 slots a family
    t6k = ct.pack_scene_tables(flatten_scene(s6k))
    small_bytes = 4 * sum(a * b for a, b in cg.small_table_shapes(t6k))
    print(f"  stress_scene 6000 spheres: {t6k.n_spheres} sphere, {t6k.n_planes} plane, {t6k.n_lights} light "
          f"slots; sphere, plane and light cotangents {small_bytes} bytes against {cg.MAX_SMEM_BYTES} of "
          f"one block: sink {cg.dense_sink(t6k)}", flush=True)
    if cg.dense_sink(t6k) != "global":
        raise AssertionError("the 6000-sphere stress scene did not take the global sink")
    p6k, st6k = partition(s6k)
    step6k = make_train_step(c6k, cfg_for(W512, W512), torch.optim.SGD(p6k.values(), lr=1e-6), loss_fn=mean_sq)
    reset_counts()
    ct.chain_trace.routes = ct.new_route_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses6k = [float(step6k(p6k, st6k, None)[0]) for _ in range(3)]
    step6k_ms = (time.perf_counter() - t0) * 1e3 / 3
    global_launches = read_counts()
    dense_routes = dict(cg.chain_grad_dense.routes)
    grads6k = {k: p.grad for k, p in p6k.items()}
    finite = all(np.isfinite(losses6k)) and all(v is None or bool(torch.isfinite(v).all())
                                                for v in grads6k.values())
    moved = bool((grads6k["spheres.centers"] != 0).any())
    expect = {"chain_trace": 3, "chain_grad_dense": 3, "chain_grad": 0, "taping": 0}
    ok = (finite and moved and all(global_launches[k] == v for k, v in expect.items())
          and dense_routes == {"shared": 0, "global": 3} and ct.chain_trace.routes["in_place"] == 3)
    print(f"  {'PASS' if ok else 'FAIL'} 3 training steps at 512x512 (SGD lr=1e-6 on mean(img^2)): launches "
          f"{global_launches} (expected {expect}), chain_grad_dense per sink {dense_routes}, chain_trace per "
          f"route {ct.chain_trace.routes}; losses {losses6k[0]:.6f} -> {losses6k[-1]:.6f}; finite={finite}; "
          f"sphere centres moved={moved}; {step6k_ms:.3f} ms per step (host clock, first step included); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"the 6000-sphere training steps: launches {global_launches}, sinks {dense_routes}, "
                             f"finite={finite}, moved={moved}")
    o6k, d6k = c6k.rays_for_pixels(*c6k.pixel_grid())
    o6k = o6k.contiguous()
    g6k = (2.0 * ct.chain_trace(t6k, o6k, d6k, cfg) / (3 * W512 * W512)).contiguous()
    # The plain version steps through 6,144 sphere and plane slots per scan
    # and through 128 light slots per bounce, at a cost set by its tensor
    # ops rather than its rays: the kernel is held to it at the training
    # steps' config (max_depth 10) on every 8th pixel of every 8th row
    # (4,096 rays of the frame), and the kernels line times both on those
    # rays; the whole frame is timed beside its own bound.
    every8 = (torch.arange(0, W512, 8, device=dev)[:, None] * W512
              + torch.arange(0, W512, 8, device=dev)[None, :]).reshape(-1)
    n_sub = every8.numel()

    def subset_g(tb, o_, d_):
        so_, sd_ = o_[every8].contiguous(), d_[every8].contiguous()
        return so_, sd_, (2.0 * ct.chain_trace(tb, so_, sd_, cfg) / (3 * n_sub)).contiguous()

    def sphere_rows_off_flips(label, tb, rays, keep):
        """The sphere rows with g zeroed on the rays whose cotangents flip
        (held above under the seam budget): each sphere column sums a few
        rays here, so one ray that took the other side of a seam moves it by
        that ray's whole share, past table_cot_rows' bound (as phase 18's
        stress scene does). A table cotangent is a sum of each ray's share,
        linear in its g, so each side subtracts its own call on the flipped
        rays alone (the plain version's cost is its bounces, not its rays)."""
        (ours, ref), = keep
        flips = torch.stack([((a - b).abs() > 1e-3 * b.abs().max()).any(1)
                             for a, b in ((ours[1], ref[1]), (ours[2], ref[2]))]).any(0)
        a, b = ours[0][0], ref[0][0]
        if bool(flips.any()):
            fr = [x[flips].contiguous() for x in rays]
            a = a - cg.chain_grad_dense(tb, *fr, cfg)[0][0]
            b = b - cg.chain_grad_dense_plain(tb, *fr, cfg)[0][0]
        a, b = a.cpu().numpy(), b.cpu().numpy()
        bad = []
        for row in table_cot_rows("sph", a, b):
            print(f"  {'PASS' if row.ok else 'FAIL'} {label}, less its {int(flips.sum())} flipped rays' share: "
                  f"table {row}", flush=True)
            bad += [] if row.ok else [str(row)]
        if bad:
            raise AssertionError(f"{label}: sphere rows out of budget off the flipped rays: {bad}")

    global_label = f"stress_scene 6000 spheres, {n_sub:,} rays of 512x512, max_depth {cfg.max_depth}, global sink"
    rays6k, keep = subset_g(t6k, o6k, d6k), []
    global_reports, global_err = check_grad(global_label, cg.chain_grad_dense, cg.chain_grad_dense_plain, t6k,
                                            *rays6k, cfg, spread_rtol=1e-4, skip_rows=("sph",), keep=keep)
    sphere_rows_off_flips(global_label, t6k, rays6k, keep)
    # the culled instantiation: the same spheres and dense_mesh_scene's mesh
    dm6, dc6 = dense_mesh_scene(W512, W512, device=dev)
    mixed6k = flatten_scene(dataclasses.replace(s6k, triangles=dm6.triangles))
    mo, md = dc6.rays_for_pixels(*dc6.pixel_grid())
    mo = mo.contiguous()
    tm6k = ct.pack_forward_tables_perm(mixed6k, mean_direction(md))
    if not tm6k.culled or cg.dense_sink(tm6k) != "global":
        raise AssertionError("the spheres-and-mesh tables are not culled on the global sink")
    gm6k = (2.0 * ct.chain_trace(tm6k, mo, md, cfg) / (3 * W512 * W512)).contiguous()
    culled_label = (f"6000 spheres and {tm6k.n_triangles} triangles, {n_sub:,} rays of 512x512, max_depth "
                    f"{cfg.max_depth}, culled, global sink")
    rays_m, keep = subset_g(tm6k, mo, md), []
    culled_reports, culled_err = check_grad(culled_label, cg.chain_grad_dense, cg.chain_grad_dense_plain, tm6k,
                                            *rays_m, cfg, spread_rtol=1e-4, skip_rows=("sph",), keep=keep)
    sphere_rows_off_flips(culled_label, tm6k, rays_m, keep)
    global_err = max(global_err, culled_err)
    print(f"  seam-flip pixels (d_o, d_d): {global_label} {global_reports['d_o'].flips}, "
          f"{global_reports['d_d'].flips}; {culled_label} {culled_reports['d_o'].flips}, "
          f"{culled_reports['d_d'].flips}", flush=True)
    # the kernels line's numbers, all on the 4,096 rays the plain version ran
    sub_ms = time_ms(lambda: cg.chain_grad_dense(t6k, *rays6k, cfg), 3)
    w_sub = chain_work(t6k, *rays6k[:2], cfg)
    sub_bound = bound_ms(work_ops(w_sub), adjoint_bytes(n_sub, t6k))
    print(f"  {global_label}: kernel {sub_ms:.3f} ms, plain version {plain_call_ms[global_label]:.3f} ms, "
          f"bound {sub_bound[0]:.4f} ms ({sub_bound[1]}; {w_sub.bounces / n_sub:.3f} bounces/ray, "
          f"{w_sub.shadow_rays / n_sub:.3f} shadow rays/ray to its 4 lights; its 124 padded light slots "
          f"send none) [H100 SXM peaks; {card}]", flush=True)
    # the whole frame, at the training steps' config
    global_ms = time_ms(lambda: cg.chain_grad_dense(t6k, o6k, d6k, g6k, cfg), 3)
    culled_global_ms = time_ms(lambda: cg.chain_grad_dense(tm6k, mo, md, gm6k, cfg), 2)
    report("chain_grad_dense kernel, stress_scene 6000 spheres 512x512, global sink", global_ms, W512 * W512)
    report("chain_grad_dense kernel, 6000 spheres and the mesh 512x512, culled, global sink", culled_global_ms,
           W512 * W512)
    scale = W512 * W512 / n_sub
    frame_bound = bound_ms(scale * work_ops(w_sub), adjoint_bytes(W512 * W512, t6k))
    print(f"  bound, stress_scene 6000 spheres 512x512 (the work of those {n_sub:,} rays times {scale:g}): "
          f"{frame_bound[0]:.4f} ms ({frame_bound[1]}); the kernel at {global_ms / frame_bound[0]:.1f}x it "
          f"[H100 SXM peaks; {card}]", flush=True)
    # the two sinks on the same inputs where both fit (one light, unpadded,
    # 5,281 spheres: the last count the shared sink fits; and phase 16's
    # mixed scene, culled), at the whole frame and max_depth 10: the global
    # sink against the shared one, whose outputs are the parent's; and the
    # cost of crossing the limit (5,282 spheres, global only)
    def sinks_agree(label, tb, o_, d_, g_):
        ours = cg.chain_grad_dense(tb, o_, d_, g_, cfg, sink="global")
        ref = cg.chain_grad_dense(tb, o_, d_, g_, cfg, sink="shared")
        rays_equal = all(torch.equal(a, b) for a, b in zip(ours[1:], ref[1:]))
        bad = [f"{cot}: {r}" for cot, a, b in (("d_o", ours[1], ref[1]), ("d_d", ours[2], ref[2]))
               for r in [ray_cot_seam_budget(a.cpu().numpy(), b.cpu().numpy())] if not r.ok]
        for name, a, b in zip(("sph", "pl", "tri", "mat", "light"), ours[0], ref[0]):
            if name == "tri" and tb.culled:  # row 12, the original index, carries none
                bad += ["tri row 12 carries a cotangent"] if a[12].any() or b[12].any() else []
                a, b = a[:12], b[:12]
            bad += [str(r) for r in table_cot_rows(name, a.cpu().numpy(), b.cpu().numpy()) if not r.ok]
        err = max(float((a - b).abs().max()) for a, b in zip((*ours[0], *ours[1:]), (*ref[0], *ref[1:])))
        print(f"  {'PASS' if not bad else 'FAIL'} global sink vs shared sink, {label}: d_o, d_d bit for bit "
              f"equal {rays_equal}; max|diff| over all outputs {err:.3e}; ray cotangents and every table row "
              "in budget", flush=True)
        if bad:
            raise AssertionError(f"the global sink disagrees with the shared one on {label}: {bad}")
        return err

    m_tb, m_o_, m_d_, m_g, _, _ = next(v for k, v in dense_grad.items() if k.startswith("mixed"))
    global_err = max(global_err, sinks_agree(f"mixed {m_tb.n_primitives} primitives 512x512, culled",
                                             m_tb, m_o_, m_d_, m_g))
    edge_ms = {}
    for n in (5281, 5282):
        es, ec = stress_scene(n, n_lights=1, width=W512, height=W512, pad_multiple=None, device=dev)
        et = ct.pack_scene_tables(flatten_scene(es))
        eo, ed = ec.rays_for_pixels(*ec.pixel_grid())
        eo = eo.contiguous()
        eg = (2.0 * ct.chain_trace(et, eo, ed, cfg) / (3 * W512 * W512)).contiguous()
        if n == 5281:
            global_err = max(global_err, sinks_agree("stress_scene 5281 spheres, one light, 512x512", et, eo,
                                                     ed, eg))
        else:
            try:
                cg.chain_grad_dense(et, eo, ed, eg, cfg, sink="shared")
            except RuntimeError as e:
                print(f"  PASS 5282 spheres: the shared sink refused ({e})", flush=True)
            else:
                raise AssertionError("the shared sink took an accumulator past one block's shared memory")
        cg.chain_grad_dense.routes = dict.fromkeys(cg.DENSE_SINKS, 0)
        edge_ms[n] = (cg.dense_sink(et), time_ms(lambda: cg.chain_grad_dense(et, eo, ed, eg, cfg), 5),
                      dict(cg.chain_grad_dense.routes))
        del es, et, eo, ed, eg
    print("  chain_grad_dense at the limit, one light, 512x512: " + "; ".join(
        f"{n} spheres sink {v[0]} {v[1]:.3f} ms (launches per sink {v[2]})" for n, v in edge_ms.items())
        + f" [{card}]", flush=True)
    if [v[0] for v in edge_ms.values()] != ["shared", "global"] or any(
            v[2][v[0]] != 6 for v in edge_ms.values()):
        raise AssertionError(f"the limit's two sides took other sinks: {edge_ms}")
    occ_global = {"linear": lib.rte_chain_grad_dense_occupancy(0, 4 * t6k.light.numel(), 1),
                  "culled": lib.rte_chain_grad_dense_occupancy(1, 4 * tm6k.light.numel(), 1)}
    phase20_s = time.perf_counter() - t20
    print(f"  the global sink's CTAs per SM {occ_global}; phase 20 took {phase20_s:.1f} s", flush=True)
    del s6k, t6k, p6k, st6k, step6k, grads6k, o6k, d6k, g6k, dm6, mixed6k, mo, md, tm6k, gm6k

    # 21. glass past the glass adjoint's 512 primitives
    import warnings

    from raytracingengine_tpu_torch.geometry.materials import Material
    from raytracingengine_tpu_torch.scene import SceneBuilder
    from raytracingengine_tpu_torch.scenes.assets import bumpy_sphere_mesh
    from raytracingengine_tpu_torch.render.pipeline import REPLAY_WARNING

    t21 = time.perf_counter()

    def glass_mesh_scene(w_, h_, device):
        """The glass sphere scene and a transparent bumpy mesh of 560
        triangles in front of it: 563 primitives."""
        b = SceneBuilder()
        b.add_sphere((0.0, 0.0, 5.0), 1.5, Material(color=(1, 1, 1), transparency=0.9, refractive_index=1.5))
        b.add_sphere((1.5, -0.8, 9.0), 1.0, Material(color=(0.9, 0.4, 0.1)))
        b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), Material(color=(0.8, 0.8, 0.8)))
        verts, idx = bumpy_sphere_mesh(radius=1.2, ni=8, nj=40)
        b.add_model(verts, idx, Material(color=(0.6, 0.9, 0.7), transparency=0.7, refractive_index=1.3),
                    translation=(-0.3, 0.2, 3.0))
        b.add_light((-3.0, 5.0, -1.0), (1, 1, 1), 60.0)
        return b.build(device=device), glass_sphere_scene(w_, h_, device=device)[1]

    gm_scene, gm_cam = glass_mesh_scene(256, 256, dev)
    gm_cfg = RenderConfig(use_pallas=True, shadow_mode="binary", max_depth=4, wavefront_budget=10,
                          chunk_size=128 * 128)
    gm_prims = flatten_scene(gm_scene).n_primitives
    print(f"[21 glass past 512] glass sphere and a transparent mesh, {gm_prims} primitives, 256x256; "
          f"{gm_cfg.shadow_mode} shadows, max_depth {gm_cfg.max_depth}, wavefront_budget "
          f"{gm_cfg.wavefront_budget}, chunk_size {gm_cfg.chunk_size}", flush=True)
    if not gm_prims > cg.MAX_PRIMS:
        raise AssertionError(f"the glass mesh scene has {gm_prims} primitives")
    gmp, gms = partition(gm_scene)
    gm_step = make_train_step(gm_cam, gm_cfg, torch.optim.SGD(gmp.values(), lr=1e-6), loss_fn=mean_sq)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        gm_losses = [float(gm_step(gmp, gms, None)[0]) for _ in range(3)]
        gm_ms = (time.perf_counter() - t0) * 1e3 / 3
    gm_counts = read_counts()
    gm_peak = torch.cuda.max_memory_allocated() / 2**20
    warned = sum(str(w.message) == REPLAY_WARNING for w in caught)
    chunks = -(-256 * 256 // gm_cfg.chunk_size)
    gm_grads = {k: p.grad for k, p in gmp.items()}
    finite = all(np.isfinite(gm_losses)) and all(v is None or bool(torch.isfinite(v).all())
                                                 for v in gm_grads.values())
    moved = bool((gm_grads["triangles.materials.transparency"] != 0).any())
    # 560 triangles: the forward takes the culled tables (phase 23)
    expect = {"wavefront_trace": 3 * chunks, "culled": 3 * chunks, "counting": 0, "wavefront_grad": 0}
    ok = finite and moved and warned == 3 * chunks and all(gm_counts[k] == v for k, v in expect.items())
    print(f"  {'PASS' if ok else 'FAIL'} 3 training steps (SGD lr=1e-6 on mean(img^2)): launches {gm_counts} "
          f"(expected {expect}: the culled forward kernel per chunk and step, the backward autograd of "
          f"integrate_wavefront's replay); the replay's warning {warned} times; losses {gm_losses[0]:.6f} -> "
          f"{gm_losses[-1]:.6f}; finite={finite}; mesh transparency moved={moved}; {gm_ms:.1f} ms per step "
          f"(host clock, first step included); peak device memory {gm_peak:.1f} MiB [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"glass past 512: launches {gm_counts}, warned {warned}, finite={finite}")
    gm_step_ms = time_ms(lambda: gm_step(gmp, gms, None), 3)
    report("glass past 512 training step, 256x256, host running ahead (CUDA events)", gm_step_ms, 256 * 256)
    # the gradient at 16x16 on the card against the CPU port's
    small_grads = {}
    for where in (dev, torch.device("cpu")):
        ss_, sc_ = glass_mesh_scene(16, 16, where)
        sp_, sst_ = partition(ss_)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            img = render_hdr(combine(sp_, sst_), sc_, dataclasses.replace(gm_cfg, chunk_size=256))
            (img * img).mean().backward()
        small_grads[where.type] = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                                   else p.grad.cpu().numpy() for k, p in sp_.items()}
    gm_errors = grad_leaf_mismatches(small_grads["cuda"], small_grads["cpu"])
    phase21_s = time.perf_counter() - t21
    print(f"  {'PASS' if not gm_errors else 'FAIL'} 16x16: the card's gradient (the kernel forward, the replay "
          "backward) vs the CPU port's (plain forward), parity.grad_leaf_mismatches: "
          f"{gm_errors or 'every leaf in budget'}; phase 21 took {phase21_s:.1f} s", flush=True)
    if gm_errors:
        raise AssertionError(f"glass past 512: the card's gradient differs from the CPU port's: {gm_errors}")
    del gm_scene, gmp, gms, gm_step, gm_grads

    # 22. sharded and fault-tolerant rendering, sharded training, the oracle
    import socket

    import torch.distributed as dist

    from raytracingengine_tpu_torch.golden import golden_from_scene
    from raytracingengine_tpu_torch.parallel import fault, make_mesh, make_sharded_loss, render_hdr_sharded

    t22 = time.perf_counter()
    with socket.socket() as sock:  # a free port on this host for the rendezvous
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        print(f"[22 sharded] a one-rank NCCL group (backend {dist.get_backend()}), mesh {mesh.shape}", flush=True)
        for spp in (1, 8):
            hs, hc = head_box_scene(width=W1080, height=H1080, spp=spp, device=dev)
            one = render_hdr(hs, hc, cfg_for(W1080, H1080), seed=2024)
            reset_counts()
            sharded = render_hdr_sharded(hs, hc, cfg_for(W1080, H1080), mesh, seed=2024)
            counts = {k: v for k, v in read_counts().items() if v}
            same = torch.equal(sharded, one)
            print(f"  {'PASS' if same else 'FAIL'} render_hdr_sharded head box 1080p spp={spp}: launches {counts}; "
                  f"equal to render_hdr bit for bit {same}", flush=True)
            if not same or not counts:
                raise AssertionError(f"render_hdr_sharded at spp={spp} differs from render_hdr or ran no kernel")
        hs, hc = head_box_scene(width=W1080, height=H1080, spp=1, device=dev)
        hp, hst = partition(hs)
        ho, hd = hc.rays_for_pixels(*hc.pixel_grid())
        ho = ho.contiguous()
        target = torch.zeros_like(ho)
        reset_counts()
        make_sharded_loss(hst, cfg, mesh)(hp, ho, hd, target).backward()
        loss_counts = {k: v for k, v in read_counts().items() if v}
        hp1, _ = partition(hs)
        img = cg.chain_trace_fused(ct.pack_scene_tables(flatten_scene(combine(hp1, hst))), ho, hd, cfg)
        ((img - target) ** 2).mean().backward()
        zero_or = lambda p: torch.zeros_like(p) if p.grad is None else p.grad  # noqa: E731
        off = [k for k, p in hp.items() if p.numel() and not bool(
            ((zero_or(p) - zero_or(hp1[k])).abs()
             <= 1e-4 * zero_or(hp1[k]).abs().max() + 1e-4 * zero_or(hp1[k]).abs()).all())]
        print(f"  {'PASS' if not off else 'FAIL'} make_sharded_loss, one step's gradients, head box 1080p: "
              f"launches {loss_counts}; every leaf within 1e-4 of its largest entry (+ 1e-4 relative; the "
              f"adjoint's atomics) of the one-process step's: {off or 'yes'}", flush=True)
        if off or loss_counts.get("chain_grad") != 1:
            raise AssertionError(f"make_sharded_loss: gradients off {off}, launches {loss_counts}")
        del hp, hp1, img
        real, events = fault.render_pixels, []

        def flaky(*a, **k):
            if not events:
                events.append(("injected", {}))
                raise RuntimeError("injected device fault")
            return real(*a, **k)

        fault.render_pixels = flaky
        try:
            banded = fault.render_hdr_faulttolerant(hs, hc, cfg_for(W1080, H1080), seed=2024, tile_rows=8,
                                                    on_event=lambda e, f: events.append((e, f)))
        finally:
            fault.render_pixels = real
        names = [e for e, _ in events[1:]]
        one = render_hdr(hs, hc, cfg_for(W1080, H1080), seed=2024)
        ok = names == ["band_retry"] + ["band_ok"] * 8 and torch.equal(banded, one)
        print(f"  {'PASS' if ok else 'FAIL'} render_hdr_faulttolerant 1080p, 8 bands, a fault injected: events "
              f"{names}; equal to render_hdr bit for bit {torch.equal(banded, one)}", flush=True)
        if not ok:
            raise AssertionError(f"render_hdr_faulttolerant: events {names}")
        del banded, one
        cli("render --mesh --use-pallas 1080p spp=8", [
            "render", "--mesh", "--use-pallas", "--shadow-mode", "binary", "--width", str(W1080), "--height",
            str(H1080), "--spp", "8", "--out", str(out_dir / "cli_render_mesh")])
    finally:
        dist.destroy_process_group()
    # The oracle (golden/, float64, recursive) against the kernels' frames at
    # tests/test_integrator_golden.py's budget: rtol 2e-3, atol 3e-3.
    for label, make, ocfg, kernel in (
        ("head box 32x24, chain_trace", lambda: head_box_scene(width=32, height=24, spp=1, device=dev),
         RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=32 * 24), "chain_trace"),
        ("glass sphere 32x24, wavefront_trace (march, max_depth 6)",
         lambda: glass_sphere_scene(32, 24, spp=1, device=dev),
         RenderConfig(use_pallas=True, max_depth=6, chunk_size=32 * 24), "wavefront_trace"),
    ):
        os_, oc_ = make()
        reset_counts()
        img = render_hdr(os_, oc_, ocfg).cpu().numpy().astype(np.float64)
        counts = read_counts()
        t0 = time.perf_counter()
        gold = golden_from_scene(os_, oc_, max_depth=ocfg.max_depth, bias=ocfg.bias).render()
        bad = int((~np.isclose(img, gold, rtol=2e-3, atol=3e-3)).sum())
        print(f"  {'PASS' if not bad and counts[kernel] == 1 else 'FAIL'} oracle, {label}: {counts[kernel]} "
              f"{kernel} launch; entries outside rtol 2e-3 / atol 3e-3 {bad} of {img.size}, max|diff| "
              f"{float(np.abs(img - gold).max()):.3e}; the oracle took {time.perf_counter() - t0:.2f} s", flush=True)
        if bad or counts[kernel] != 1:
            raise AssertionError(f"oracle {label}: {bad} entries out of budget, launches {counts}")
    phase22_s = time.perf_counter() - t22
    print(f"  phase 22 took {phase22_s:.1f} s; phases 20-22 {phase20_s + phase21_s + phase22_s:.1f} s "
          "(target: 90 s)", flush=True)

    # 23. the glass kernels' culled scan: a transparent mesh past TRI_BLOCK triangles
    t23 = time.perf_counter()

    def transparent_mesh_scene(w_, h_, spp, device, **mesh_kw):
        """glass_sphere_scene's three primitives and light with dense_mesh_scene's
        bumpy mesh (6,016 triangles at its default ni, nj; `scramble`
        shuffles them) made transparent (transparency 0.7, refractive index
        1.3), seen by the glass sphere's camera."""
        g_scene, g_cam = glass_sphere_scene(w_, h_, spp=spp, device=device)
        mesh = dense_mesh_scene(w_, h_, spp=spp, device=device, **mesh_kw)[0].triangles
        m = mesh.materials
        mats = dataclasses.replace(m, transparency=torch.full_like(m.transparency, 0.7),
                                   refractive_index=torch.full_like(m.refractive_index, 1.3))
        return dataclasses.replace(g_scene, triangles=dataclasses.replace(mesh, materials=mats)), g_cam

    tm_cfg = RenderConfig(use_pallas=True, chunk_size=W1080 * H1080)  # march shadows, max_depth 10
    tm_bin = dataclasses.replace(tm_cfg, shadow_mode="binary")
    tm_scene, tm_cam = transparent_mesh_scene(W1080, H1080, 1, dev)
    tm_flat = flatten_scene(tm_scene)
    print(f"[23 glass culled] the glass sphere scene and dense_mesh_scene's mesh made transparent "
          f"(0.7, ior 1.3): {tm_flat.n_triangles} triangles, 1920x1080, max_depth {tm_cfg.max_depth}", flush=True)
    # the main path: render_hdr packs the culled tables once per frame
    tm_runs = (("spp=1 march", 1, tm_cfg, {}), ("spp=8 march", 8, tm_cfg, {}),
               ("spp=1 binary", 1, tm_bin, {}), ("spp=1 march, scrambled", 1, tm_cfg, {"scramble": 5}))
    tm_frames = {}
    reset_counts()
    for label, spp, rcfg, kw in tm_runs:
        r_scene, r_cam = transparent_mesh_scene(W1080, H1080, spp, dev, **kw)
        t0 = time.perf_counter()
        hdr = render_hdr(r_scene, r_cam, rcfg, seed=2024)
        sync()
        tm_frames[label] = (hdr, time.perf_counter() - t0)
    tm_launches = read_counts()
    tm_expect = {"wavefront_trace": 3, "culled": 3, "counting": 0, "wavefront_spp_trace": 1, "spp culled": 1}
    ok = all(tm_launches[k] == v for k, v in tm_expect.items())
    print(f"  {'PASS' if ok else 'FAIL'} render_hdr: launches {tm_launches} (expected {tm_expect})", flush=True)
    if not ok:
        raise AssertionError(f"the glass mesh did not render through the culled kernels: {tm_launches}")
    for label, (hdr, secs) in tm_frames.items():
        if not (bool(torch.isfinite(hdr).all()) and hdr.shape == (H1080, W1080, 3)):
            raise AssertionError(f"glass mesh render {label}: not finite or shape {tuple(hdr.shape)}")
        path = out_dir / f"glass_mesh_{label.replace(' ', '_').replace(',', '').replace('=', '')}.png"
        write_png(str(path), to_uint8(tonemap(hdr, "aces")).cpu().numpy())
        print(f"  glass mesh 1080p {label}: first call {secs * 1e3:.1f} ms, mean {float(hdr.mean()):.4f} "
              f"-> {path.relative_to(ROOT)}", flush=True)

    # the culled kernels against the linear ones on whole frames, and against
    # their plain versions on a subset of the rays
    tm_o, tm_d = tm_cam.rays_for_pixels(px, py)
    tm_o = tm_o.contiguous()
    tm_lin, tm_tables = ct.pack_scene_tables(tm_flat), ct.pack_forward_tables_perm(tm_flat)
    rays1 = W1080 * H1080
    # 4,096 of the rays: 128 of the kernels' warps (32 neighbouring pixels of
    # a row each), spread evenly over the frame, so that the replay's
    # per-warp counts (roofline.py: warp_blocks, vote_blocks) are warps'
    sub = ((torch.arange(128, device=dev) * (rays1 // 128)) // 32 * 32)[:, None]
    sub = (sub + torch.arange(32, device=dev)).reshape(-1)
    sub8 = sub[::4]  # 1,024 pixels for the AA kernel's plain version (8 samples each)
    tm_out, tm_reports, tm_plain_ms, tm_equal = {}, {}, {}, {}

    def out_hash(t: torch.Tensor) -> str:
        import hashlib

        return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:12]

    def frames_equal(label: str, a: torch.Tensor, b: torch.Tensor) -> None:
        """The culled kernel's output against the linear kernel's: bit for
        bit, or the pixels that differ counted (and the phase fails)."""
        diff = int((a != b).reshape(a.shape[0], -1).any(1).sum())
        tm_equal[label] = diff
        print(f"  {'PASS' if not diff else 'FAIL'} {label}: culled vs linear kernel, pixels that differ "
              f"{diff} of {a.shape[0]} (bit for bit: {diff == 0}); sha1 {out_hash(a)} / {out_hash(b)}", flush=True)
        if diff:
            raise AssertionError(f"{label}: the culled kernel's frame differs from the linear kernel's")

    for mode, mcfg in (("march", tm_cfg), ("binary", tm_bin)):
        tm_out[mode] = wt.wavefront_trace(tm_tables, tm_o, tm_d, mcfg)
        frames_equal(f"wavefront_trace {mode}", tm_out[mode], wt.wavefront_trace(tm_lin, tm_o, tm_d, mcfg))
        ref, tm_plain_ms[mode] = once_ms(lambda: wt.trace_wavefront_plain(tm_tables, tm_o[sub], tm_d[sub], mcfg))
        tm_reports[mode] = budget(f"culled wavefront_trace vs trace_wavefront_plain (culled tables), {mode}, "
                                  f"{sub.numel()} rays", tm_out[mode][sub], ref)
    img_c, pops_c = wt.wavefront_trace(tm_tables, tm_o, tm_d, tm_cfg, count=True)
    (img_l, pops_l), lin_count_ms = once_ms(lambda: wt.wavefront_trace(tm_lin, tm_o, tm_d, tm_cfg, count=True))
    frames_equal("wavefront_trace counting, march (frame)", img_c, img_l)
    frames_equal("wavefront_trace counting, march (pops per warp)", pops_c[:, None], pops_l[:, None])
    frames_equal("wavefront_trace counting vs not counting, culled", img_c, tm_out["march"])
    # the AA kernel: render_hdr's spp=8 frame (seed 2024, one chunk) against
    # its plain version, whose samples' rays go through one plain trace
    # (launch-bound: one call costs as much as one sample); against the
    # linear kernel on a whole 240x135 frame (~15 s at 1080p spp=8)
    _, tm_cam8 = transparent_mesh_scene(W1080, H1080, 8, dev)
    tm_out["spp"] = tm_frames["spp=8 march"][0].reshape(-1, 3)

    def spp_plain():
        """wavefront_spp_trace_plain(tm_tables, tm_cam8, px[sub8], py[sub8],
        tm_cfg, seed=2024): mean_over_samples' rays and sum, one trace."""
        rays = []
        st.mean_over_samples(lambda o_, d_: rays.append((o_, d_)) or torch.zeros_like(o_), tm_cam8,
                             px[sub8], py[sub8], seed=2024)
        out = wt.trace_wavefront_plain(tm_tables, torch.cat([r[0] for r in rays]),
                                       torch.cat([r[1] for r in rays]), tm_cfg).split(sub8.numel())
        acc = torch.zeros_like(out[0])
        for x in out:
            acc = acc + x
        return acc * (1.0 / tm_cam8.spp)

    ref, tm_plain_ms["spp"] = once_ms(spp_plain)
    tm_reports["spp"] = budget(f"culled wavefront_spp_trace vs plain, spp=8, {sub8.numel()} pixels",
                               tm_out["spp"][sub8], ref)
    _, q_cam8 = transparent_mesh_scene(240, 135, 8, dev)
    qx, qy = q_cam8.pixel_grid()
    q_spp = {name: once_ms(lambda: wt.wavefront_spp_trace(tb, q_cam8, qx, qy, tm_cfg, seed=1234))
             for name, tb in (("culled", tm_tables), ("linear", tm_lin))}
    frames_equal("wavefront_spp_trace spp=8, 240x135", q_spp["culled"][0], q_spp["linear"][0])
    # a tail warp: 61x47 = 2,867 rays (pixels), not a multiple of 32, so the
    # last warp's lanes past the end join the culled kernels' votes
    t_scene, t_cam = transparent_mesh_scene(61, 47, 8, dev)
    t_flat = flatten_scene(t_scene)
    t_lin, t_cul = ct.pack_scene_tables(t_flat), ct.pack_forward_tables_perm(t_flat)
    tx, ty = t_cam.pixel_grid()
    t_o, t_d = t_cam.rays_for_pixels(tx, ty)
    t_o = t_o.contiguous()
    t_count = {name: wt.wavefront_trace(tb, t_o, t_d, tm_cfg, count=True) for name, tb in (("culled", t_cul),
                                                                                       ("linear", t_lin))}
    frames_equal("wavefront_trace counting, 61x47 (frame)", t_count["culled"][0], t_count["linear"][0])
    frames_equal("wavefront_trace counting, 61x47 (pops per warp)", t_count["culled"][1][:, None],
                 t_count["linear"][1][:, None])
    frames_equal("wavefront_trace binary, 61x47", wt.wavefront_trace(t_cul, t_o, t_d, tm_bin),
                 wt.wavefront_trace(t_lin, t_o, t_d, tm_bin))
    frames_equal("wavefront_spp_trace spp=8, 61x47", wt.wavefront_spp_trace(t_cul, t_cam, tx, ty, tm_cfg, seed=7),
                 wt.wavefront_spp_trace(t_lin, t_cam, tx, ty, tm_cfg, seed=7))
    del t_scene, t_flat, t_lin, t_cul, t_o, t_d, t_count
    s_scene, _ = transparent_mesh_scene(W1080, H1080, 1, dev, scramble=5)
    s_flat = flatten_scene(s_scene)
    s_tables = ct.pack_forward_tables_perm(s_flat)
    frames_equal("render_hdr spp=1 march, scrambled", tm_frames["spp=1 march, scrambled"][0].reshape(-1, 3),
                 wt.wavefront_trace(ct.pack_scene_tables(s_flat), tm_o, tm_d, tm_cfg))
    seam = int((tm_frames["spp=1 march, scrambled"][0] != tm_frames["spp=1 march"][0]).any(-1).sum())
    kept = bool((s_tables.perm[:s_flat.n_triangles] == torch.arange(s_flat.n_triangles, device=dev)).all())
    print(f"  scrambled order: the packing picks {'authoring' if kept else 'a spatial (Morton or median-split)'} "
          f"order; the frame differs from the unscrambled mesh's at {seam} pixels (exact seam ties take the "
          f"lower original index)", flush=True)
    del s_scene, s_flat, s_tables, ref, img_c, img_l, tm_frames, hdr

    print(f"  phase 23 so far {time.perf_counter() - t23:.1f} s; times follow", flush=True)
    # times in turns: linear, culled, culled, linear; the culled counting
    # and AA kernels at 1080p alone (the AA kernels' 240x135 checking calls
    # beside them: the linear one takes ~4 s there, underfilling the card)
    tm_ms = {}
    for label, fc, fl in (
        ("march", lambda: wt.wavefront_trace(tm_tables, tm_o, tm_d, tm_cfg),
         lambda: wt.wavefront_trace(tm_lin, tm_o, tm_d, tm_cfg)),
        ("binary", lambda: wt.wavefront_trace(tm_tables, tm_o, tm_d, tm_bin),
         lambda: wt.wavefront_trace(tm_lin, tm_o, tm_d, tm_bin)),
    ):
        tm_ms[label] = in_turns(fc, fl, 3, 1)
        report(f"culled {label} kernel, glass mesh 1080p", tm_ms[label][0], rays1)
        report(f"linear {label} kernel, glass mesh 1080p ({tm_ms[label][1] / tm_ms[label][0]:.2f}x)",
               tm_ms[label][1], rays1)
    for route, (_, ms) in q_spp.items():
        report(f"{route} spp kernel, glass mesh 240x135 spp=8 (its checking call)", ms, 240 * 135 * 8)
    tm_ms["counting"] = (time_ms(lambda: wt.wavefront_trace(tm_tables, tm_o, tm_d, tm_cfg, count=True), 3),)
    report("culled counting kernel, glass mesh 1080p", tm_ms["counting"][0], rays1)
    report("linear counting kernel, glass mesh 1080p (its checking call)", lin_count_ms, rays1)
    tm_ms["spp"] = (time_ms(lambda: wt.wavefront_spp_trace(tm_tables, tm_cam8, px, py, tm_cfg, seed=1234), 1),)
    report("culled spp kernel, glass mesh 1080p spp=8", tm_ms["spp"][0], rays1 * 8)
    tm_pack_ms = time_ms(lambda: ct.pack_forward_tables_perm(tm_flat), 5)
    print(f"  pack_forward_tables_perm (the host's packing, once per frame), {tm_flat.n_triangles} triangles: "
          f"{tm_pack_ms:.3f} ms; plain versions (one call each, on the subset): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in tm_plain_ms.items()) + f" [{card}]", flush=True)
    for label, spp, iters in (("spp=1", 1, 3), ("spp=8", 8, 1)):
        f_scene, f_cam = transparent_mesh_scene(W1080, H1080, spp, dev)
        report(f"render_hdr end to end, glass mesh 1080p {label}",
               time_ms(lambda: render_hdr(f_scene, f_cam, tm_cfg, seed=2024), iters), rays1 * spp)

    # the crossover near TRI_BLOCK: the same kernel on both routes, in turns
    for label, make in (("132 triangles", lambda: transparent_mesh_scene(W1080, H1080, 1, dev, ni=3, nj=33)[0]),
                        ("320 triangles", lambda: transparent_mesh_scene(W1080, H1080, 1, dev, ni=6, nj=32)[0]),
                        ("phase 21's 560 triangles", lambda: glass_mesh_scene(W1080, H1080, dev)[0])):
        c_flat = flatten_scene(make())
        c_lin, c_cul = ct.pack_scene_tables(c_flat), ct.pack_forward_tables_perm(c_flat)
        c_ms, l_ms = in_turns(lambda: wt.wavefront_trace(c_cul, tm_o, tm_d, tm_cfg),
                              lambda: wt.wavefront_trace(c_lin, tm_o, tm_d, tm_cfg), 5, 5)
        print(f"  crossover, {label} ({c_cul.n_blocks} blocks): wavefront_trace march 1080p culled {c_ms:.3f} ms, "
              f"linear {l_ms:.3f} ms, linear / culled {l_ms / c_ms:.2f} [{card}]", flush=True)

    # a glass training step with 129-509 triangles: the counting culled
    # forward, the adjoint on the linear tables
    tr_scene, tr_cam = transparent_mesh_scene(256, 256, 1, dev, ni=6, nj=32)
    tr_n = flatten_scene(tr_scene).n_primitives
    if not (ct.TRI_BLOCK < tr_scene.triangles.v0.shape[0] and tr_n <= cg.MAX_PRIMS):
        raise AssertionError(f"the training scene has {tr_n} primitives")
    trp, trs = partition(tr_scene)
    tr_step = make_train_step(tr_cam, RenderConfig(use_pallas=True, chunk_size=256 * 256),
                              torch.optim.SGD(trp.values(), lr=1e-6), loss_fn=mean_sq)
    reset_counts()
    tr_losses = [float(tr_step(trp, trs, None)[0]) for _ in range(3)]
    tr_counts = read_counts()
    tr_expect = {"wavefront_trace": 3, "counting": 3, "culled counting": 3, "wavefront_grad": 3}
    tr_grads = {k: p.grad for k, p in trp.items()}
    finite = all(np.isfinite(tr_losses)) and all(v is None or bool(torch.isfinite(v).all())
                                                 for v in tr_grads.values())
    moved = bool((tr_grads["triangles.materials.transparency"] != 0).any())
    ok = finite and moved and all(tr_counts[k] == v for k, v in tr_expect.items())
    tr_ms = time_ms(lambda: tr_step(trp, trs, None), 3)
    print(f"  {'PASS' if ok else 'FAIL'} 3 training steps, {tr_n} primitives at 256x256: launches {tr_counts} "
          f"(expected {tr_expect}: the counting culled forward, the adjoint on the linear tables, no tape "
          f"overrun); losses {tr_losses[0]:.6f} -> {tr_losses[-1]:.6f}; finite={finite}; mesh transparency "
          f"moved={moved}; {tr_ms:.3f} ms a step, host running ahead (CUDA events) [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"glass mesh training: launches {tr_counts}, finite={finite}, moved={moved}")
    del tr_scene, trp, trs, tr_step, tr_grads

    print(f"  phase 23 so far {time.perf_counter() - t23:.1f} s; the bounds' work follows", flush=True)
    # bounds: the work of the subset's rays (roofline.py), scaled to the frame
    def scaled(w: WavefrontWork, k: float, rays: int) -> WavefrontWork:
        return dataclasses.replace(w, rays=rays, **{f: getattr(w, f) * k for f in (
            "pops", "closest_ops", "shadow_rays", "march_steps", "shadow_ops", "shade_ops", "mufu_ops",
            "int_ops", "closest_scans", "closest_tris", "lane_blocks", "warp_blocks", "visit_blocks",
            "vote_blocks")})

    tm_work = {mode: wavefront_work(tm_tables, tm_o[sub], tm_d[sub], mcfg)
               for mode, mcfg in (("march", tm_cfg), ("binary", tm_bin))}
    # the AA kernel's 8 samples: sample 0, then samples 1-7 in one replay
    # (each ray's work is its own; jittered samples count alike)
    s_pids = (py[sub8].to(torch.int64) * W1080 + px[sub8].to(torch.int64))
    s_rays = [tm_cam8.rays_for_pixels(px[sub8], py[sub8], st.pixel_jitter(1234, s_pids, sample))
              for sample in range(tm_cam8.spp)]
    tm_work8 = wavefront_work(tm_tables, s_rays[0][0].contiguous(), s_rays[0][1].contiguous(), tm_cfg,
                              camera_sample=0)
    tm_work8 += wavefront_work(tm_tables, torch.cat([r[0] for r in s_rays[1:]]).contiguous(),
                               torch.cat([r[1] for r in s_rays[1:]]).contiguous(), tm_cfg, camera_sample=1)
    tm_bounds = {
        "march": wavefront_bound_ms(scaled(tm_work["march"], rays1 / sub.numel(), rays1),
                                    trace_bytes(rays1, tm_tables)),
        "binary": wavefront_bound_ms(scaled(tm_work["binary"], rays1 / sub.numel(), rays1),
                                     trace_bytes(rays1, tm_tables)),
        "spp": wavefront_bound_ms(scaled(tm_work8, rays1 / sub8.numel(), rays1),
                                  trace_bytes(rays1, tm_tables, in_per_ray=8)),
    }
    for mode, w in tm_work.items():
        n = w.rays
        print(f"  glass mesh work ({mode}, {n} rays): {w.pops / n:.3f} nodes/ray, closest-hit "
              f"{w.closest_ops / n:.0f} + shadow {w.shadow_ops / n:.0f} fp32 test ops/ray (culled traversal), "
              f"shading {w.shade_ops / n:.0f}; blocks of 128 tests per ray: per lane {w.lane_blocks / n:.3f}, "
              f"32 x each warp's busiest lane {w.warp_blocks / n:.3f} (a loop per lane: lanes use "
              f"{w.lane_blocks / max(w.warp_blocks, 1):.3f} of its turns), the warp-cooperative scan's turns "
              f"{w.coop_blocks / n:.3f} (the lanes' visited blocks {w.visit_blocks / n:.3f} + the warps' votes "
              f"{w.vote_blocks / n:.3f}); bound {tm_bounds[mode][0]:.4f} ms ({tm_bounds[mode][1]}) "
              f"[H100 SXM peaks; {card}]", flush=True)
    w = tm_work["march"]
    print(f"  a closest-hit or march scan tests {w.closest_tris / w.closest_scans:.1f} of the "
          f"{tm_flat.n_triangles} triangles on culled tables (the oracle's segments; the linear scan tests "
          f"all); spp=8 bound {tm_bounds['spp'][0]:.4f} ms ({tm_bounds['spp'][1]})", flush=True)
    phase23_s = time.perf_counter() - t23
    print(f"  phase 23 took {phase23_s:.1f} s (target: 90 s)", flush=True)
    del tm_lin, tm_scene, tm_flat

    # 24. native I/O: native_bridge's OBJ parser and PPM/PNG writers, and a JSON
    # scene of the 50,800-triangle mesh through the culled chain_trace
    t24 = time.perf_counter()
    from raytracingengine_tpu_torch.convert import scene_to_numpy
    from raytracingengine_tpu_torch.imageio import load_obj, write_ppm
    from raytracingengine_tpu_torch.scenes import bumpy_sphere_mesh, load_scene_json

    native_bridge.load()  # raises with the compiler's output if the build failed
    print(f"[24 native I/O] {nb_path.relative_to(ROOT)} (built in phase 2 in {nb_build_s:.2f} s) loaded; "
          "every parse and write below names its backend", flush=True)

    def write_obj(path: Path, verts: np.ndarray, faces: np.ndarray) -> None:
        """Vertices at full precision (both parsers round the text to the
        same float64); faces 1-based, triangles or quads."""
        with open(path, "w") as f:
            np.savetxt(f, verts, fmt="v %.17g %.17g %.17g")
            np.savetxt(f, faces + 1, fmt="f" + " %d" * faces.shape[1])

    def parse_both(label: str, path: Path, n_tris: int) -> dict:
        """load_obj natively and in Python, 3 times each -> the native dict;
        the two must be equal exactly, dtypes too."""
        got, secs = {}, {}
        for backend in ("native", "python"):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                got[backend] = load_obj(str(path), backend=backend)
                runs.append(time.perf_counter() - t0)
            secs[backend] = sorted(runs)[1]
        a, b = got["native"], got["python"]
        same = (sorted(a) == sorted(b) and a["materials"] == b["materials"]
                and a["material_names"] == b["material_names"]
                and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                        for k in ("vertices", "indices", "face_materials")))
        ok = same and a["indices"].size == 3 * n_tris
        print(f"  {'PASS' if ok else 'FAIL'} load_obj {label} ({path.stat().st_size / 2**20:.1f} MiB, "
              f"{a['vertices'].shape[0]} vertices, {a['indices'].size // 3} triangles): native and python equal "
              f"{same}; host time, median of 3: native {secs['native']:.3f} s, python {secs['python']:.3f} s "
              f"({secs['python'] / secs['native']:.1f}x) [{card}]", flush=True)
        if not ok:
            raise AssertionError(f"load_obj {label}: native and python differ or the count is not {n_tris}")
        return a

    mesh_v, mesh_i = bumpy_sphere_mesh(radius=2.0, ni=128, nj=200, amp=0.15)
    mesh_obj = out_dir / "dense_mesh_50800.obj"
    write_obj(mesh_obj, mesh_v, mesh_i.reshape(-1, 3))
    parsed = parse_both("dense_mesh_scene's mesh", mesh_obj, mesh_i.size // 3)
    if not (np.array_equal(parsed["vertices"], mesh_v) and np.array_equal(parsed["indices"], mesh_i)):
        raise AssertionError("the 50,800-triangle OBJ does not parse back to bumpy_sphere_mesh's arrays")
    # a height field of 707 x 707 quads (each two triangles by the fan)
    n_q = 707
    gx, gz = np.meshgrid(np.arange(n_q + 1) * 0.01, np.arange(n_q + 1) * 0.01)
    grid_v = np.stack([gx, np.random.default_rng(24).normal(0.0, 0.05, gx.shape), gz], -1).reshape(-1, 3)
    q0 = (np.arange(n_q)[:, None] * (n_q + 1) + np.arange(n_q)[None, :]).reshape(-1)
    grid_obj = out_dir / "grid_999698.obj"
    write_obj(grid_obj, grid_v, np.stack([q0, q0 + 1, q0 + n_q + 2, q0 + n_q + 1], -1))
    parse_both("a 707x707-quad grid", grid_obj, 2 * n_q * n_q)
    grid_obj.unlink()
    del parsed

    # the JSON scene: dense_mesh_scene(ni=128, nj=200) as a user writes it
    scene_json = out_dir / "native_io_scene.json"
    scene_json.write_text(json.dumps({
        "camera": {"position": [0, 0, -8], "focal": W512, "width": W512, "height": W512, "near": 0, "far": 100,
                   "spp": 1},
        "models": [{"obj": mesh_obj.name, "translation": [0.137, 0.5, 8.0],
                    "material": {"color": [0.85, 0.35, 0.2], "shininess": 64, "specular": 0.25}}],
        "planes": [{"point": [0, -2.5, 0], "normal": [0, 1, 0], "material": {"color": [0.9, 0.9, 0.9]}}],
        "lights": [{"position": [-4, 6, -2], "intensity": 120}, {"position": [4, 5, 2], "intensity": 90}],
    }))
    t0 = time.perf_counter()
    j_scene, j_cam = load_scene_json(str(scene_json), device=dev)
    sync()
    json_s = time.perf_counter() - t0
    ref_leaves = scene_to_numpy(dense_mesh_scene(W512, W512, spp=1, device=dev, ni=128, nj=200)[0])
    j_leaves = scene_to_numpy(j_scene)
    unequal = sorted(k for k in ref_leaves if k not in j_leaves or not np.array_equal(j_leaves[k], ref_leaves[k]))
    print(f"  {'PASS' if not unequal else 'FAIL'} load_scene_json {scene_json.relative_to(ROOT)}: "
          f"{j_scene.triangles.active.shape[0]} triangle slots, {json_s:.2f} s; equal to dense_mesh_scene(ni=128, "
          f"nj=200) leaf for leaf: {unequal or 'all'}", flush=True)
    if unequal:
        raise AssertionError(f"the JSON scene differs from dense_mesh_scene's at {unequal}")
    del ref_leaves, j_leaves
    cfg512 = cfg_for(W512, W512)
    reset_counts()
    ct.chain_trace.routes = ct.new_route_counts()
    t0 = time.perf_counter()
    j_img = render_hdr(j_scene, j_cam, cfg512)
    sync()
    j_secs = time.perf_counter() - t0
    j_counts = {k: v for k, v in read_counts().items() if v}
    j_routes = dict(ct.chain_trace.routes)
    ok = (j_counts == {"chain_trace": 1} and j_routes["culled"] == 1 and bool(torch.isfinite(j_img).all())
          and j_img.shape == (W512, W512, 3))
    print(f"  {'PASS' if ok else 'FAIL'} render_hdr 512x512 spp=1 (binary, whole-frame chunk): first call "
          f"{j_secs * 1e3:.1f} ms, launches {j_counts}, per route {j_routes} (expected 1 culled chain_trace), "
          f"mean {float(j_img.mean()):.4f}", flush=True)
    if not ok:
        raise AssertionError(f"the JSON scene did not render through one culled chain_trace: {j_counts} {j_routes}")
    j_o, j_d = j_cam.rays_for_pixels(*j_cam.pixel_grid())
    j_o = j_o.contiguous()
    j_tables = ct.pack_forward_tables_perm(flatten_scene(j_scene), mean_direction(j_d))
    # 4,096 of the rays: 128 runs of 32 neighbouring pixels spread over the frame
    sub24 = ((torch.arange(128, device=dev) * (W512 * W512 // 128)) // 32 * 32)[:, None]
    sub24 = (sub24 + torch.arange(32, device=dev)).reshape(-1)
    ref, j_plain_ms = once_ms(lambda: ct.trace_chain_plain(j_tables, j_o[sub24], j_d[sub24], cfg512))
    budget(f"render_hdr's frame vs trace_chain_plain (culled tables, {j_tables.n_blocks} blocks), "
           f"{sub24.numel()} rays ({j_plain_ms:.1f} ms)", j_img.reshape(-1, 3)[sub24], ref)
    del ref, j_tables

    ldr = to_uint8(tonemap(j_img, "aces")).cpu().numpy()
    io_secs = {}
    for backend in ("native", "python"):
        for ext, write in (("ppm", write_ppm), ("png", write_png)):
            t0 = time.perf_counter()
            write(str(out_dir / f"native_io_{backend}.{ext}"), ldr, backend=backend)
            io_secs[ext, backend] = time.perf_counter() - t0
    ppm_same = (out_dir / "native_io_native.ppm").read_bytes() == (out_dir / "native_io_python.ppm").read_bytes()
    png_pixels = all(np.array_equal(read_png(str(out_dir / f"native_io_{b}.png")), ldr) for b in ("native", "python"))
    png_bytes_same = (out_dir / "native_io_native.png").read_bytes() == (out_dir / "native_io_python.png").read_bytes()
    ok = ppm_same and png_pixels and np.array_equal(read_ppm(str(out_dir / "native_io_native.ppm")), ldr)
    print(f"  {'PASS' if ok else 'FAIL'} write_ppm native and python: the same bytes {ppm_same}; write_png: the "
          f"same pixels {png_pixels} (the same bytes {png_bytes_same}); host times "
          + ", ".join(f"{ext} {b} {t * 1e3:.1f} ms" for (ext, b), t in io_secs.items()) + f" [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"native writers: PPM bytes equal {ppm_same}, PNG pixels equal {png_pixels}")
    ct.chain_trace.routes = ct.new_route_counts()
    _, cli_json_counts = cli("render the JSON scene with the 50,800-triangle OBJ", [
        "render", "--scene", str(scene_json), "--use-pallas", "--shadow-mode", "binary", "--width", str(W512),
        "--height", str(W512), "--spp", "1", "--chunk-size", str(W512 * W512),
        "--out", str(out_dir / "cli_render_native_obj")])
    cli_routes = dict(ct.chain_trace.routes)
    cli_same = np.array_equal(read_png(str(out_dir / "cli_render_native_obj" / "aces.png")), ldr)
    ok = cli_json_counts == {"chain_trace": 2} and cli_routes["culled"] == 2 and cli_same
    print(f"  {'PASS' if ok else 'FAIL'} cli render: launches {cli_json_counts}, per route {cli_routes} (its "
          f"first and steady calls: 2 culled); its aces.png equals the frame above: {cli_same}", flush=True)
    if not ok:
        raise AssertionError(f"cli render of the JSON scene: launches {cli_json_counts} {cli_routes}, "
                             f"same frame {cli_same}")
    del j_scene, j_img, j_o, j_d
    phase24_s = time.perf_counter() - t24
    print(f"  phase 24 took {phase24_s:.1f} s (target: 20 s)", flush=True)

    # 8. timing: CUDA events around `iters` calls after one warm-up call

    print("[8 timing]", flush=True)
    rays1 = W1080 * H1080
    chain_ms, chain_plain_ms = in_turns(
        lambda: ct.chain_trace(tables, o, d, cfg),
        lambda: ct.trace_chain_plain(tables, o, d, cfg), 20, 3,
    )
    report("chain_trace kernel, 1080p spp=1", chain_ms, rays1)
    report("trace_chain_plain, 1080p spp=1", chain_plain_ms, rays1)
    spp_ms, spp_plain_ms = in_turns(
        lambda: st.spp_trace(tables, cam8, px, py, cfg, seed=1234),
        lambda: st.spp_trace_plain(tables, cam8, px, py, cfg, seed=1234), 10, 1,
    )
    report("spp_trace kernel, 1080p spp=8", spp_ms, rays1 * 8)
    report("spp_trace_plain, 1080p spp=8", spp_plain_ms, rays1 * 8)
    tape_ms = time_ms(lambda: ct.chain_trace(tables, o, d, cfg, tape=True), 20)
    report("chain_trace taping kernel (the training step's forward), 1080p spp=1", tape_ms, rays1)
    grad_ms, grad_plain_ms = in_turns(
        lambda: cg.chain_grad(tables, o, d, g, cfg, width=W1080, tape=tape),
        lambda: cg.chain_grad_plain(tables, o, d, g, cfg), 10, 1,
    )
    report("chain_grad kernel, 1080p (fed from the taping forward)", grad_ms, rays1)
    report("chain_grad kernel, identity map (not the main path's), 1080p",
           time_ms(lambda: cg.chain_grad(tables, o, d, g, cfg, tape=tape), 10), rays1)
    report("chain_grad_plain, 1080p", grad_plain_ms, rays1)
    # The dense adjoint serves the head box's tables too (not culled: a linear
    # scan): it must agree with chain_grad there, and its time beside
    # chain_grad's says whether chain_grad.cu still earns its place.
    hb_dense = cg.chain_grad_dense(tables, o, d, g, cfg)
    hb_grad = cg.chain_grad(tables, o, d, g, cfg, width=W1080, tape=tape)
    sync()
    hb_bad = [f"{cot}: {r}" for cot, a, b in (("d_o", hb_dense[1], hb_grad[1]), ("d_d", hb_dense[2], hb_grad[2]))
              for r in [ray_cot_seam_budget(a.cpu().numpy(), b.cpu().numpy())] if not r.ok]
    hb_bad += [str(r) for name, a, b in zip(("sph", "pl", "tri", "mat", "light"), hb_dense[0], hb_grad[0])
               for r in table_cot_rows(name, a.cpu().numpy(), b.cpu().numpy()) if not r.ok]
    hb_err = max(float((a - b).abs().max()) for a, b in zip((*hb_dense[0], *hb_dense[1:]),
                                                             (*hb_grad[0], *hb_grad[1:])))
    print(f"  {'PASS' if not hb_bad else 'FAIL'} chain_grad_dense vs chain_grad kernel, head box 1080p: "
          f"max|diff| over all outputs {hb_err:.3e}, ray cotangents and table rows in budget", flush=True)
    if hb_bad:
        raise AssertionError(f"chain_grad_dense disagrees with chain_grad on the head box: {hb_bad}")
    del hb_dense, hb_grad
    hb_dense_ms, hb_grad_ms = in_turns(lambda: cg.chain_grad_dense(tables, o, d, g, cfg),
                                       lambda: cg.chain_grad(tables, o, d, g, cfg, width=W1080, tape=tape),
                                       10, 10)
    report("chain_grad_dense kernel, head box 1080p (in turns with chain_grad)", hb_dense_ms, rays1)
    report("chain_grad kernel, head box 1080p (in turns with chain_grad_dense)", hb_grad_ms, rays1)

    def time_step(label: str, step, rays: int) -> None:
        report(f"{label}, host running ahead (CUDA events)", time_ms(step, 10), rays)
        t0 = time.perf_counter()
        for _ in range(10):
            step()
            sync()
        report(f"{label}, synchronised after every step (host clock)",
               (time.perf_counter() - t0) * 1e3 / 10, rays)
        torch.cuda.reset_peak_memory_stats()
        step()
        sync()
        print(f"  {label}: peak device memory of a step {torch.cuda.max_memory_allocated() / 2**20:.1f} "
              f"MiB (torch.cuda.max_memory_allocated) [{card}]", flush=True)

    time_step("training step (forward, backward, SGD), 1080p", lambda: train_step(params, static, None),
              rays1)
    wf_ms, wf_plain_ms = in_turns(
        lambda: wt.wavefront_trace(g_tables, g_o, g_d, glass_cfg),
        lambda: wt.trace_wavefront_plain(g_tables, g_o, g_d, glass_cfg), 20, 3,
    )
    report("wavefront_trace kernel, glass 1080p spp=1, march", wf_ms, rays1)
    report("trace_wavefront_plain, glass 1080p spp=1, march", wf_plain_ms, rays1)
    binary_cfg = dataclasses.replace(glass_cfg, shadow_mode="binary")
    report("wavefront_trace kernel, glass 1080p spp=1, binary",
           time_ms(lambda: wt.wavefront_trace(g_tables, g_o, g_d, binary_cfg), 20), rays1)
    count_ms = time_ms(lambda: wt.wavefront_trace(g_tables, g_o, g_d, glass_cfg, count=True), 20)
    report("wavefront_trace counting kernel (the glass step's forward), glass 1080p spp=1, march",
           count_ms, rays1)
    report("wavefront_trace counting kernel, glass 1080p spp=1, binary",
           time_ms(lambda: wt.wavefront_trace(g_tables, g_o, g_d, binary_cfg, count=True), 20), rays1)
    wf_spp_ms, wf_spp_plain_ms = in_turns(
        lambda: wt.wavefront_spp_trace(g_tables, gcam8, px, py, glass_cfg, seed=1234),
        lambda: wt.wavefront_spp_trace_plain(g_tables, gcam8, px, py, glass_cfg, seed=1234), 10, 1,
    )
    report("wavefront_spp_trace kernel, glass 1080p spp=8", wf_spp_ms, rays1 * 8)
    report("wavefront_spp_trace_plain, glass 1080p spp=8", wf_spp_plain_ms, rays1 * 8)
    wgr_ms, wgr_plain_ms = in_turns(
        lambda: wg.wavefront_grad(g_tables, g_o, g_d, wg_g["march"], glass_cfg, warp_pops=wg_pops["march"]),
        lambda: wg.wavefront_grad_plain(g_tables, g_o, g_d, wg_g["march"], glass_cfg), 10, 1,
    )
    report("wavefront_grad kernel, glass 1080p, march (fed from the counting forward)", wgr_ms, rays1)
    report("wavefront_grad_plain, glass 1080p, march", wgr_plain_ms, rays1)
    report("wavefront_grad kernel, glass 1080p, binary",
           time_ms(lambda: wg.wavefront_grad(g_tables, g_o, g_d, wg_g["binary"], binary_cfg,
                                             warp_pops=wg_pops["binary"]), 10), rays1)
    for (w_, h_), (gstep, gp, gst) in glass_steps.items():
        time_step(f"glass training step (forward, backward, SGD), {w_}x{h_}",
                  lambda: gstep(gp, gst, None), w_ * h_)
    for label, (step, rays) in loop_steps.items():
        time_step(f"spp=4 training step through the per-sample loop, {label}", step, rays)
    for w_, h_, spp in glass_cells:
        m_scene, m_cam = glass_sphere_scene(w_, h_, spp=spp, device=dev)
        gc = RenderConfig(use_pallas=True, chunk_size=w_ * h_)
        ms = time_ms(lambda: render_hdr(m_scene, m_cam, gc, seed=2024), 5)
        report(f"render_hdr end to end, glass {w_}x{h_} spp={spp}", ms, w_ * h_ * spp)
    _, cam32 = head_box_scene(width=1000, height=1000, spp=32, device=dev)
    px32, py32 = cam32.pixel_grid()
    spp32_ms = time_ms(lambda: st.spp_trace(tables, cam32, px32, py32, cfg, seed=7), 5)
    report("spp_trace kernel, 1000x1000 spp=32", spp32_ms, 1000 * 1000 * 32)
    for w, h, spp in main_cells:
        m_scene, m_cam = head_box_scene(width=w, height=h, spp=spp, device=dev)
        ms = time_ms(lambda: render_hdr(m_scene, m_cam, cfg_for(w, h), seed=2024), 5)
        report(f"render_hdr end to end, head box {w}x{h} spp={spp}", ms, w * h * spp)
    # The dense kernels; their plain versions' times are those of their
    # checking calls in phases 15 and 16 (one call each: seconds).
    rays512 = W512 * W512
    dense_ms = {}
    for label, (tb, to, td, _) in dense.items():
        dense_ms[label] = time_ms(lambda: ct.chain_trace(tb, to, td, cfg), 10)
        report(f"culled chain_trace kernel, {label} triangles 512x512", dense_ms[label], rays512)
        report(f"trace_chain_plain (one call), {label} triangles 512x512", dense_plain_ms[label], rays512)
    # The fill probe: the same camera at 4x the pixels, on phase 15's tables.
    _, f_cam = dense_mesh_scene(2 * W512, 2 * W512, spp=1, device=dev, ni=128, nj=200)
    f_o, f_d = f_cam.rays_for_pixels(*f_cam.pixel_grid())
    f_o = f_o.contiguous()
    f_ms = time_ms(lambda: ct.chain_trace(dense["50800"][0], f_o, f_d, cfg), 10)
    report("culled chain_trace kernel, 50800 triangles 1024x1024 (phase 15's tables)", f_ms, 4 * rays512)
    print(f"  fill probe: 1024^2 / 512^2 time {f_ms / dense_ms['50800']:.3f} for 4x the rays [{card}]",
          flush=True)
    del f_o, f_d
    occ = {}
    for label, tb in (("head box", tables), ("6016", dense["6016"][0]), ("50800", dense["50800"][0])):
        smem = 4 * sum(a * b for a, b in cg.small_table_shapes(tb))
        occ[label] = lib.rte_chain_grad_dense_occupancy(int(tb.culled), smem, 0)
    hb_acc = 4 * cg.table_entries(tables, "chain_grad")
    occ["chain_grad head box, staged"] = lib.rte_chain_grad_occupancy(2, hb_acc)
    occ["chain_grad head box, in place"] = lib.rte_chain_grad_occupancy(0, hb_acc)
    print(f"  CTAs per SM of the adjoints (128 threads, their scenes' shared accumulators; "
          f"chain_grad's staged route at the largest stage): chain_grad_dense {occ} [{card}]",
          flush=True)
    d_spp_ms = time_ms(lambda: st.spp_trace(spp_tables6, d_cam8, dpx, dpy, cfg, seed=1234), 5)
    report("culled spp_trace kernel, 6016 triangles 512x512 spp=8", d_spp_ms, rays512 * 8)
    report("spp_trace_plain (one call), 6016 triangles 512x512 spp=8", d_spp_plain_ms, rays512 * 8)
    dense_grad_ms, dense_grad_plain_ms = {}, {}
    for label, (tb, to, td, gg, _, _) in dense_grad.items():
        dense_grad_ms[label] = time_ms(lambda: cg.chain_grad_dense(tb, to, td, gg, cfg), 5)
        dense_grad_plain_ms[label] = plain_call_ms[label]
        n_rays = to.shape[0]
        report(f"chain_grad_dense kernel, {label}", dense_grad_ms[label], n_rays)
        report(f"chain_grad_dense_plain (one call), {label}", dense_grad_plain_ms[label], n_rays)
    for label, kw in (("6016", {}), ("50800", dict(ni=128, nj=200))):
        r_scene, r_cam = dense_mesh_scene(W512, W512, spp=1, device=dev, **kw)
        ms = time_ms(lambda: render_hdr(r_scene, r_cam, cfg_for(W512, W512)), 5)
        report(f"render_hdr end to end, dense mesh {label} triangles 512x512 spp=1", ms, rays512)
        r_flat = flatten_scene(r_scene)
        pack_ms = time_ms(lambda: ct.pack_forward_tables_perm(r_flat, mean_direction(d_d6)), 5)
        print(f"  pack_forward_tables_perm, {label} triangles: {pack_ms:.3f} ms [{card}]", flush=True)
    for label, (dstep, dp, dst) in dense_steps.items():
        time_step(f"dense training step (forward, backward, SGD), {label} triangles 512x512",
                  lambda: dstep(dp, dst, None), rays512)

    # The training steps' device time by kernel, from the profiler
    # (utils/profiling.py: the Chrome trace of three steps after a warm-up,
    # read back by kernel name and by top-level host range).
    import re

    from raytracingengine_tpu_torch.utils.profiling import profile_step as traced

    def profile_step(label: str, step) -> list[str]:
        """Prints the step's device time by kernel -> the names of the
        kernels it ran."""
        rep = traced(lambda: [step() for _ in range(3)], trace_dir=str(out_dir / "traces"))
        if not rep.op_ms:
            print(f"  {label} under the profiler: no device time recorded (not measured)")
            return []
        ours = {}
        for k, v in rep.op_ms.items():
            m = re.search(r"(chain|wavefront|partials)_\w*kernel", k)
            if m:
                ours[m.group(0)] = ours.get(m.group(0), 0.0) + v / 3
        total_ms = rep.device_total_ms / 3
        other = total_ms - sum(ours.values())
        pack = rep.host_ms.get("rte.tables")
        pack_note = (f"; the tables span (rte.tables: combine, flatten_scene, the packing) host "
                     f"{pack / 3:.3f} ms per step, its kernels "
                     f"{rep.module_ms.get('rte.tables', 0.0) / 3:.3f} device ms"
                     if pack else "")
        print(f"  {label} under the profiler (it adds host time): wall {rep.wall_ms / 3:.3f} ms, "
              f"device kernels {total_ms:.3f} ms: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items())
              + f", {len(rep.op_ms) - len(ours)} other kernel kinds {other:.3f} ms{pack_note} [{card}]",
              flush=True)
        return list(rep.op_ms)

    profile_step("training step 1080p", lambda: train_step(params, static, None))
    gstep, gp, gst = glass_steps[(W1080, H1080)]
    glass_kernels = profile_step("glass training step 1080p", lambda: gstep(gp, gst, None))
    if any("count" in k for k in glass_kernels):  # the adjoint's own counting replay is gone
        raise AssertionError(f"the glass step ran a counting kernel: {[k for k in glass_kernels if 'count' in k]}")
    for label, (dstep, dp, dst) in dense_steps.items():
        profile_step(f"dense training step {label} triangles 512x512", lambda: dstep(dp, dst, None))
    for label, (step, _) in loop_steps.items():
        profile_step(f"spp=4 training step through the per-sample loop, {label}", step)

    # Roofline bounds from this run's work (roofline.py: intersection tests
    # only). An adjoint's function needs the forward's scans: one closest
    # hit per bounce and the shadow scans; the head-box adjoint takes its
    # closest hits from the taping forward's tape, so its function needs
    # the shadow scans and the tape's bytes, and the taping forward's the
    # tape's writes. A replay of a scan is a choice of design, not counted.
    work1 = chain_work(tables, o, d, cfg)
    work8 = ChainWork(rays=0)
    pids = py.to(torch.int64) * W1080 + px.to(torch.int64)
    for sample in range(cam8.spp):
        o8, d8 = cam8.rays_for_pixels(px, py, st.pixel_jitter(1234, pids, sample))
        work8 += chain_work(tables, o8.contiguous(), d8.contiguous(), cfg)
    g_work8 = WavefrontWork(rays=0)
    for sample in range(gcam8.spp):
        o8, d8 = gcam8.rays_for_pixels(px, py, st.pixel_jitter(1234, pids, sample))
        g_work8 += wavefront_work(g_tables, o8.contiguous(), d8.contiguous(), glass_cfg, camera_sample=sample)
    g_work1 = g_work["march"]
    bounds = {
        "chain_trace": bound_ms(work_ops(work1), trace_bytes(rays1, tables)),
        "spp_trace": bound_ms(work_ops(work8), trace_bytes(rays1, tables, in_per_ray=8)),
        "chain_grad": bound_ms(work1.shadow_ops, taped_adjoint_bytes(work1, tables)),
        "chain_trace, taping": bound_ms(work_ops(work1),
                                        trace_bytes(rays1, tables) + chain_tape_bytes(work1)),
        "wavefront_trace": bound_ms(work_ops(g_work1), trace_bytes(rays1, g_tables)),
        "wavefront_spp_trace": bound_ms(work_ops(g_work8), trace_bytes(rays1, g_tables, in_per_ray=8)),
        "wavefront_grad": bound_ms(work_ops(g_work1), adjoint_bytes(rays1, g_tables)),
        "wavefront_grad, binary": bound_ms(work_ops(g_work["binary"]), adjoint_bytes(rays1, g_tables)),
    }
    # The glass forward kernels' bound on their whole counted work: the
    # tests and the shading, MUFU and jitter operations (roofline.
    # wavefront_bound_ms); the line below names the pipe that sets it.
    work_bounds = {
        "wavefront_trace": wavefront_bound_ms(g_work1, trace_bytes(rays1, g_tables)),
        "wavefront_trace, binary": wavefront_bound_ms(g_work["binary"], trace_bytes(rays1, g_tables)),
        "wavefront_spp_trace": wavefront_bound_ms(g_work8, trace_bytes(rays1, g_tables, in_per_ray=8)),
    }
    print(f"  work at 1080p spp=1: {work1.bounces / rays1:.3f} bounces/ray, "
          f"{work1.shadow_rays / rays1:.3f} shadow rays/ray, closest-hit {work1.closest_ops / rays1:.0f} "
          f"+ shadow {work1.shadow_ops / rays1:.0f} fp32 ops/ray; spp=8: "
          f"{(work8.closest_ops + work8.shadow_ops) / rays1:.0f} ops/pixel")
    print(f"  glass work at 1080p spp=1 (march): {g_work1.pops / rays1:.3f} nodes/ray (at most "
          f"{g_work1.max_pops}), {g_work1.shadow_rays / rays1:.3f} shadow rays/ray, "
          f"{g_work1.march_steps / rays1:.3f} march steps/ray, closest-hit "
          f"{g_work1.closest_ops / rays1:.0f} + march {g_work1.shadow_ops / rays1:.0f} fp32 ops/ray; "
          f"spp=8: {(g_work8.closest_ops + g_work8.shadow_ops) / rays1:.0f} ops/pixel, at most "
          f"{g_work8.max_pops} nodes in one sample's tree; beyond the tests, per ray (spp=1 march / binary) "
          f"and per pixel (spp=8): shading {g_work1.shade_ops / rays1:.0f} / "
          f"{g_work['binary'].shade_ops / rays1:.0f} / {g_work8.shade_ops / rays1:.0f} fp32, MUFU "
          f"{g_work1.mufu_ops / rays1:.1f} / {g_work['binary'].mufu_ops / rays1:.1f} / "
          f"{g_work8.mufu_ops / rays1:.1f}, jitter {g_work8.int_ops / rays1:.0f} integer ops")
    # The dense kernels' bounds: the culled work of a traversal that knew each
    # scan's answer (roofline.py), on the timed rays.
    dense_work = {label: chain_work(tb, to, td, cfg, widths=(0, W512)) for label, (tb, to, td, _) in dense.items()}
    d_work8 = ChainWork(rays=0)
    d_pids = dpy.to(torch.int64) * W512 + dpx.to(torch.int64)
    for sample in range(d_cam8.spp):
        o8, d8 = d_cam8.rays_for_pixels(dpx, dpy, st.pixel_jitter(1234, d_pids, sample))
        d_work8 += chain_work(spp_tables6, o8.contiguous(), d8.contiguous(), cfg)
    # spp_trace's other timed shapes: 50,800 triangles at 512^2 spp=8 (tables
    # in no order, as chip_kernel_times.py times it) and the head box at
    # 1000^2 spp=32 with seed 7, as timed above.
    s_scene50, s_cam50 = dense_mesh_scene(W512, W512, spp=8, device=dev, ni=128, nj=200)
    spp_tables50 = ct.pack_forward_tables_perm(flatten_scene(s_scene50))
    d50_work8 = ChainWork(rays=0)
    for sample in range(s_cam50.spp):
        o8, d8 = s_cam50.rays_for_pixels(dpx, dpy, st.pixel_jitter(1234, d_pids, sample))
        d50_work8 += chain_work(spp_tables50, o8.contiguous(), d8.contiguous(), cfg)
    work32 = ChainWork(rays=0)
    pids32 = py32.to(torch.int64) * 1000 + px32.to(torch.int64)
    for sample in range(cam32.spp):
        o32, d32 = cam32.rays_for_pixels(px32, py32, st.pixel_jitter(7, pids32, sample))
        work32 += chain_work(tables, o32.contiguous(), d32.contiguous(), cfg)
    del s_scene50, spp_tables50
    bounds.update({
        "spp_trace, 1000x1000 spp=32": bound_ms(work_ops(work32),
                                                trace_bytes(1000 * 1000, tables, in_per_ray=8)),
        "spp_trace, 50800 triangles": bound_ms(work_ops(d50_work8),
                                               trace_bytes(rays512, dense["50800"][0], in_per_ray=8)),
        "chain_trace, 6016 triangles": bound_ms(work_ops(dense_work["6016"]), trace_bytes(rays512, tables6)),
        "chain_trace_streamed": bound_ms(work_ops(dense_work["50800"]),
                                         trace_bytes(rays512, dense["50800"][0])),
        "spp_trace, 6016 triangles": bound_ms(work_ops(d_work8), trace_bytes(rays512, spp_tables6, in_per_ray=8)),
        "chain_grad_dense": bound_ms(work_ops(dense_work["6016"]), adjoint_bytes(rays512, tables6)),
        "chain_grad_dense_streamed": bound_ms(work_ops(dense_work["50800"]),
                                              adjoint_bytes(rays512, dense["50800"][0])),
    })
    for label, w in dense_work.items():
        print(f"  dense work {label}: {w.bounces / w.rays:.3f} bounces/ray, {w.shadow_rays / w.rays:.3f} "
              f"shadow rays/ray, closest-hit {w.closest_ops / w.rays:.0f} + shadow "
              f"{w.shadow_ops / w.rays:.0f} fp32 ops/ray (culled traversal)")
        # blocks of 128 triangle tests per ray: per lane, and 32 x each warp's union
        per = lambda x: x / w.rays  # noqa: E731
        print(f"  dense blocks {label} per ray: oracle per lane {per(w.lane_blocks):.3f} (closest-hit "
              f"{per(w.closest_lane_blocks):.3f}), kernel traversal per lane {per(w.visit_blocks):.3f} "
              f"(closest-hit {per(w.closest_visit_blocks):.3f}); a warp of 32 rays of a row that tests "
              f"a block for each lane while any lane needs it (the per-lane scan) would issue: oracle "
              f"{per(w.warp_blocks[0]):.3f}, traversal {per(w.warp_visit_blocks[0]):.3f}, so lanes use "
              f"{w.visit_blocks / w.warp_visit_blocks[0]:.3f} of its tests; blocks staged per CTA of 128 "
              f"rays {128 * per(w.staged_blocks[0]):.2f} (identity map) and "
              f"{128 * per(w.staged_blocks[W512]):.2f} (32x4 tiles)")
    for name, (b, by) in bounds.items():
        print(f"  bound {name}: {b:.4f} ms ({by}) [H100 SXM peaks; {card}]")
    for name, (b, by) in work_bounds.items():
        print(f"  work bound {name} (tests, shading, MUFU, jitter): {b:.4f} ms ({by}) [H100 SXM peaks; {card}]")
    as_contract = lambda by: "bytes" if by == "bytes" else "operations"  # noqa: E731

    # Launches: the main paths' runs (phases 7, 10, 12, 14, 17) and phase 19's
    # (the spp=4 training steps, the CLI's renders).
    loop = lambda key, *parts: sum(loop_launches[p].get(key, 0) for p in parts)  # noqa: E731
    kernels = [
        {"name": "chain_trace", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/chain_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/chain_trace.py:1401",
         "launches": launches["chain_trace"] + loop("chain_trace", "head box", "dense"),
         "max_abs_err": chain_report.max_abs,
         "ms": chain_ms, "plain_ms": chain_plain_ms, "bound_ms": bounds["chain_trace"][0],
         "bound_by": bounds["chain_trace"][1], "library_ms": None},
        {"name": "spp_trace", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/spp_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/spp_trace.py:109",
         "launches": launches["spp_trace"] + loop("spp_trace", "cli"), "max_abs_err": spp_report.max_abs,
         "ms": spp_ms, "plain_ms": spp_plain_ms, "bound_ms": bounds["spp_trace"][0],
         "bound_by": bounds["spp_trace"][1], "library_ms": None},
        {"name": "chain_grad", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/chain_grad.cu",
         "replaces": "raytracingengine_tpu/kernels/chain_grad.py:555",
         "launches": train_launches["chain_grad"] + loop("chain_grad", "head box"), "max_abs_err": grad_err,
         "ms": grad_ms, "plain_ms": grad_plain_ms, "bound_ms": bounds["chain_grad"][0],
         "bound_by": bounds["chain_grad"][1], "library_ms": None},
        {"name": "wavefront_trace", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/wavefront_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/wavefront_trace.py:655",
         "launches": glass_launches["wavefront_trace"] + loop("wavefront_trace", "glass"),
         "max_abs_err": max(r.max_abs for r in glass_reports.values()),
         "ms": wf_ms, "plain_ms": wf_plain_ms, "bound_ms": work_bounds["wavefront_trace"][0],
         "bound_by": as_contract(work_bounds["wavefront_trace"][1]), "library_ms": None},
        {"name": "wavefront_spp_trace", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/wavefront_spp_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/wavefront_trace.py:758",
         "launches": glass_launches["wavefront_spp_trace"], "max_abs_err": g_spp_report.max_abs,
         "ms": wf_spp_ms, "plain_ms": wf_spp_plain_ms, "bound_ms": work_bounds["wavefront_spp_trace"][0],
         "bound_by": as_contract(work_bounds["wavefront_spp_trace"][1]), "library_ms": None},
        # The glass kernels' culled instantiations (phase 23; the launches of
        # its render_hdr runs and phase 21's forward, and its training steps'
        # counting forward); their plain versions timed on the checked subset.
        {"name": "wavefront_trace_culled", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/wavefront_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/wavefront_trace.py:655",
         "launches": tm_launches["culled"] + gm_counts["culled"],
         "max_abs_err": max(tm_reports[m].max_abs for m in ("march", "binary")),
         "ms": tm_ms["march"][0], "plain_ms": tm_plain_ms["march"], "bound_ms": tm_bounds["march"][0],
         "bound_by": as_contract(tm_bounds["march"][1]), "library_ms": None},
        {"name": "wavefront_trace_culled_count", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/wavefront_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/wavefront_trace.py:655",
         "launches": tr_counts["culled counting"], "max_abs_err": tm_reports["march"].max_abs,
         "ms": tm_ms["counting"][0], "plain_ms": tm_plain_ms["march"], "bound_ms": tm_bounds["march"][0],
         "bound_by": as_contract(tm_bounds["march"][1]), "library_ms": None},
        {"name": "wavefront_spp_trace_culled", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/wavefront_spp_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/wavefront_trace.py:758",
         "launches": tm_launches["spp culled"], "max_abs_err": tm_reports["spp"].max_abs,
         "ms": tm_ms["spp"][0], "plain_ms": tm_plain_ms["spp"], "bound_ms": tm_bounds["spp"][0],
         "bound_by": as_contract(tm_bounds["spp"][1]), "library_ms": None},
        {"name": "wavefront_grad", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/wavefront_grad.cu",
         "replaces": "raytracingengine_tpu/kernels/wavefront_grad.py:762",
         "launches": glass_train_launches[(W1080, H1080)]["wavefront_grad"] + loop("wavefront_grad", "glass"),
         "max_abs_err": wg_err,
         "ms": wgr_ms, "plain_ms": wgr_plain_ms, "bound_ms": bounds["wavefront_grad"][0],
         "bound_by": bounds["wavefront_grad"][1], "library_ms": None},
        {"name": "chain_trace_streamed", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/chain_trace.cu",
         "replaces": "raytracingengine_tpu/kernels/chain_trace.py:1275",
         "launches": dense_train_launches["50800"]["chain_trace"],
         "max_abs_err": dense_reports["50800"].max_abs, "ms": dense_ms["50800"],
         "plain_ms": dense_plain_ms["50800"], "bound_ms": bounds["chain_trace_streamed"][0],
         "bound_by": bounds["chain_trace_streamed"][1], "library_ms": None},
        {"name": "chain_grad_dense", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/chain_grad_dense.cu",
         "replaces": "raytracingengine_tpu/kernels/chain_grad.py:1143",
         "launches": dense_train_launches["6016"]["chain_grad_dense"] + loop("chain_grad_dense", "dense"),
         "max_abs_err": max(v[5] for k, v in dense_grad.items() if not k.startswith("50800")),
         "ms": dense_grad_ms["6016 512x512"], "plain_ms": dense_grad_plain_ms["6016 512x512"],
         "bound_ms": bounds["chain_grad_dense"][0], "bound_by": bounds["chain_grad_dense"][1],
         "library_ms": None},
        {"name": "chain_grad_dense_global", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/chain_grad_dense.cu",
         "replaces": "raytracingengine_tpu/kernels/chain_grad.py:1143",
         "launches": global_launches["chain_grad_dense"], "max_abs_err": global_err, "ms": sub_ms,
         "plain_ms": plain_call_ms[global_label], "bound_ms": sub_bound[0], "bound_by": sub_bound[1],
         "library_ms": None},
        {"name": "chain_grad_dense_streamed", "route": "cuda",
         "source": "raytracingengine_tpu_torch/csrc/chain_grad_dense.cu",
         "replaces": "raytracingengine_tpu/kernels/chain_grad.py:1697",
         "launches": dense_train_launches["50800"]["chain_grad_dense"],
         "max_abs_err": dense_grad["50800 512x512"][5], "ms": dense_grad_ms["50800 512x512"],
         "plain_ms": dense_grad_plain_ms["50800 512x512"],
         "bound_ms": bounds["chain_grad_dense_streamed"][0],
         "bound_by": bounds["chain_grad_dense_streamed"][1], "library_ms": None},
    ]
    print(f"seam-flip pixels: chain_trace {chain_report.flips}/{chain_report.pixels}, "
          f"spp_trace {spp_report.flips}/{spp_report.pixels}, chain_grad "
          f"{cot_reports['d_d'].flips}/{cot_reports['d_d'].pixels} (spheres "
          f"{b_reports['d_d'].flips}/{b_reports['d_d'].pixels}), wavefront_trace "
          + ", ".join(f"{m} {r.flips}/{r.pixels}" for m, r in glass_reports.items())
          + f", wavefront_spp_trace {g_spp_report.flips}/{g_spp_report.pixels}, wavefront_grad "
          + ", ".join(f"{m} {r['d_d'].flips}/{r['d_d'].pixels}" for m, r in wg_reports.items())
          + f", culled chain_trace " + ", ".join(
              f"{k} {r.flips}/{r.pixels}" for k, r in dense_reports.items())
          + f", culled spp_trace {d_spp_report.flips}/{d_spp_report.pixels}, chain_grad_dense "
          + ", ".join(f"{k} {v[4]['d_d'].flips}/{v[4]['d_d'].pixels}" for k, v in dense_grad.items())
          + "; routes (chain_trace, spp_trace): " + ", ".join(
              f"{k} {v[0]} {v[1].flips}/{v[1].pixels}, {v[2].flips}/{v[2].pixels}"
              for k, v in route_reports.items())
          + f"; chain_grad staged on the stress scene {stress_reports['d_d'].flips}/{stress_reports['d_d'].pixels}"
          + f"; training-path launches {train_launches}; main-path launches per route {main_routes}; "
          f"glass-path launches {glass_launches}; "
          f"glass training launches {glass_train_launches[(W1080, H1080)]} at 1080p; dense training "
          f"launches {dense_train_launches}; phase 19's launches {loop_launches}; the loop's frame vs "
          f"spp_trace {loop_aa_report.flips}/{loop_aa_report.pixels} (pinned: {LOOP_AA_FLIPS}); the global sink "
          f"(phase 20) {global_reports['d_d'].flips}/{global_reports['d_d'].pixels}, culled "
          f"{culled_reports['d_d'].flips}/{culled_reports['d_d'].pixels}; the culled glass kernels (phase 23) "
          + ", ".join(f"{k} {r.flips}/{r.pixels}" for k, r in tm_reports.items())
          + f" against their plain versions, pixels unequal to the linear kernels' {tm_equal}; their plain_ms "
          f"is one call's on the subset ({sub.numel()} rays, {sub8.numel()} pixels at spp=8), their bounds "
          f"the subset's work scaled to the frame; the dense kernels' plain_ms is one "
          "call's (the global sink's on its 16,384 rays at max_depth 2, its ms on the whole frame at max_depth "
          "10); no PyTorch call traces rays, so library_ms is null")
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s [{card}]", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
