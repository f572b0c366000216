#!/usr/bin/env python3
"""Time the chain kernels of the checkout this script sits in, on one CUDA
card, as render_hdr and the training step call them:

  head box 1920x1080   chain_trace, chain_grad (with the frame width where
                       its wrapper takes one), spp_trace at spp=8; spp_trace
                       at 1000x1000 spp=32
  dense_mesh_scene     culled chain_trace and chain_grad_dense (tables
  512x512, 6,016 and   ordered along the mean ray), culled spp_trace at
  50,800 triangles     spp=8 (tables in no order)

It also prints ptxas' register report of the build and, for each trace
kernel function, its SASS instruction count and opcode mix (cuobjdump): the
loads (LDG, LDS, LDC, ULDC), the fp32 arithmetic (FMUL, FADD, FFMA), MUFU
and branches, over the function and over each innermost loop of at least
30 fp32 instructions (the triangle tests' loops), so that two versions'
code can be told apart beside their times. Beside each head-box time it
prints a hash of the kernel's output, so that two versions' outputs can be
seen to be bit-identical.

The script uses only the package's public wrappers, so it runs the same in
two checkouts: copy it into each (unpacked from `git archive`) and run them
in turns on one card, parent, change, change, parent, to compare two
versions. CUDA events around repeated calls after one warm-up call; the last
line is one JSON object of ms per kernel and shape.

Run on a machine with one CUDA card:
    python3 chip_kernel_times.py              # every kernel above
    python3 chip_kernel_times.py --head-box   # the head-box kernels only
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
    "fp32": ("FMUL", "FADD", "FFMA"),
    "other": ("MUFU", "BRA"),
}
SASS_OPS = tuple(op for ops in SASS_CLASSES.values() for op in ops)


def sass_functions(lib: Path) -> dict[str, list[tuple[int, str, int | None]]]:
    """Kernel function -> its SASS as (address, opcode, branch target or
    None), by `cuobjdump -sass` (an empty dict where cuobjdump is missing)."""
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
            funcs[name].append((int(m.group(1), 16), op, int(t.group(1), 16) if t else None))
    return funcs


def opcode_mix(instrs) -> str:
    c = Counter(op for _, op, _ in instrs)
    return f"{len(instrs)} instructions, " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS)


def hot_loops(instrs, min_fp32: int = 30):
    """The innermost loops (a backward branch's span holding no other) with
    at least `min_fp32` fp32 instructions -> [(start, end, instructions)]."""
    spans = [(t, a) for a, op, t in instrs if op == "BRA" and t is not None and t <= a]
    inner = [(s, e) for s, e in spans
             if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e for s2, e2 in spans)]
    loops = []
    for s, e in sorted(set(inner)):
        body = [x for x in instrs if s <= x[0] <= e]
        if sum(op in SASS_CLASSES["fp32"] for _, op, _ in body) >= min_fp32:
            loops.append((s, e, body))
    return loops


def out_hash(t) -> str:
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:12]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head-box", action="store_true", help="time the head-box kernels only")
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
    for line in log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "stack frame" in line:
            print("  ptxas " + line.strip())
    for fn, instrs in sorted(sass_functions(lib_path).items()):
        if "chain_trace" in fn or "spp_trace" in fn or "chain_grad" in fn:
            print(f"  sass {fn}: {opcode_mix(instrs)}")
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

    def show(name: str, ms: float, out=None) -> None:
        times[name] = ms
        digest = f", output sha1 {out_hash(out)}" if out is not None else ""
        print(f"  {name}: {ms:.3f} ms{digest} [{card}]", flush=True)

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
    show("chain_trace head box 1080p", time_ms(lambda: ct.chain_trace(tables, o, d, cfg), 20), img)
    show("chain_grad head box 1080p",
         time_ms(lambda: cg.chain_grad(tables, o, d, g, cfg, **grad_kw), 10))
    show("spp_trace head box 1080p spp=8",
         time_ms(lambda: st.spp_trace(tables, cam8, px, py, cfg, seed=1234), 10),
         st.spp_trace(tables, cam8, px, py, cfg, seed=1234))
    show("spp_trace head box 1000x1000 spp=32",
         time_ms(lambda: st.spp_trace(tables, cam32, px32, py32, cfg, seed=7), 5),
         st.spp_trace(tables, cam32, px32, py32, cfg, seed=7))
    del o, d, img, g
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
             time_ms(lambda: cg.chain_grad_dense(tables, o, d, g, cfg), 5))
        show(f"spp_trace {label} triangles 512x512 spp=8",
             time_ms(lambda: st.spp_trace(tables8, cam8, px, py, cfg, seed=1234), 3))
    print(card)
    print(json.dumps({"ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
