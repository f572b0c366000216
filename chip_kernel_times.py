#!/usr/bin/env python3
"""Time the chain kernels of the checkout this script sits in, on one CUDA
card, as render_hdr and the training step call them:

  head box 1920x1080   chain_trace, chain_grad (with the frame width where
                       its wrapper takes one), spp_trace at spp=8; spp_trace
                       at 1000x1000 spp=32
  dense_mesh_scene     culled chain_trace and chain_grad_dense (tables
  512x512, 6,016 and   ordered along the mean ray), culled spp_trace at
  50,800 triangles     spp=8 (tables in no order)

It also prints ptxas' register report of the build and the SASS instruction
count of each kernel function (cuobjdump), so that two versions' code can be
told apart beside their times.

The script uses only the package's public wrappers, so it runs the same in
two checkouts: copy it into each (unpacked from `git archive`) and run them
in turns on one card, parent, change, change, parent, to compare two
versions. CUDA events around repeated calls after one warm-up call; the last
line is one JSON object of ms per kernel and shape.

Run with no arguments on a machine with one CUDA card:
    python3 chip_kernel_times.py
"""

from __future__ import annotations

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


def sass_counts(lib: Path) -> dict[str, int]:
    """SASS instructions per kernel function of the built library, by
    `cuobjdump -sass` (an empty dict where cuobjdump is missing)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts: Counter = Counter()
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return dict(counts)


def main() -> int:
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
    for line in log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "stack frame" in line:
            print("  ptxas " + line.strip())
    for fn, n in sorted(sass_counts(lib_path).items()):
        if "chain" in fn or "spp_trace" in fn:
            print(f"  sass {fn}: {n} instructions")
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

    def show(name: str, ms: float) -> None:
        times[name] = ms
        print(f"  {name}: {ms:.3f} ms [{card}]", flush=True)

    # the head box, linear tables
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=W1080 * H1080)
    scene, cam = head_box_scene(width=W1080, height=H1080, spp=1, device=dev)
    tables = ct.pack_scene_tables(flatten_scene(scene))
    px, py = cam.pixel_grid()
    o, d = cam.rays_for_pixels(px, py)
    o = o.contiguous()
    img = ct.chain_trace(tables, o, d, cfg)
    g = (2.0 * img / img.numel()).contiguous()
    grad_kw = {"width": W1080} if "width" in inspect.signature(cg.chain_grad).parameters else {}
    _, cam8 = head_box_scene(width=W1080, height=H1080, spp=8, device=dev)
    _, cam32 = head_box_scene(width=1000, height=1000, spp=32, device=dev)
    px32, py32 = cam32.pixel_grid()
    show("chain_trace head box 1080p", time_ms(lambda: ct.chain_trace(tables, o, d, cfg), 20))
    show("chain_grad head box 1080p",
         time_ms(lambda: cg.chain_grad(tables, o, d, g, cfg, **grad_kw), 10))
    show("spp_trace head box 1080p spp=8",
         time_ms(lambda: st.spp_trace(tables, cam8, px, py, cfg, seed=1234), 10))
    show("spp_trace head box 1000x1000 spp=32",
         time_ms(lambda: st.spp_trace(tables, cam32, px32, py32, cfg, seed=7), 5))
    del o, d, img, g

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
             time_ms(lambda: cg.chain_grad_dense(tables, o, d, g, cfg), 5))
        show(f"spp_trace {label} triangles 512x512 spp=8",
             time_ms(lambda: st.spp_trace(tables8, cam8, px, py, cfg, seed=1234), 3))
    print(card)
    print(json.dumps({"ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
