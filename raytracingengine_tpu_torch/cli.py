"""Command-line interface: render, aov and fit.

The reference's app layer is main() (RaytracingEngine.cpp:216-330): build
the hard-coded scene, render, print the wall-clock, write all 7 tonemaps
as PPM and shell out to ffmpeg for PNG. The CLI generalises that, with the
JAX package's commands, flags and defaults:

  python -m raytracingengine_tpu_torch.cli render --scene head_box \
      --width 512 --height 512 --spp 4 --tonemap all --format png --out out/

Scenes: builtin names (head_box, baseline_spheres, glass, stress,
dense_mesh) or a JSON file (scenes/config.py). PNG is encoded in-process.
Every command renders on `--device` (default cuda, the card; cpu runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from raytracingengine_tpu_torch.imageio import write_png, write_ppm
from raytracingengine_tpu_torch.inverse import fit, masked_optimizer, partition, select
from raytracingengine_tpu_torch.inverse.checkpoint import save_checkpoint
from raytracingengine_tpu_torch.parallel import make_mesh, render_hdr_sharded
from raytracingengine_tpu_torch.parallel.multihost import initialize_distributed
from raytracingengine_tpu_torch.render.aov import render_aovs
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import builders
from raytracingengine_tpu_torch.scenes.config import load_scene_json
from raytracingengine_tpu_torch.tonemap import OPERATORS, aces_approx, to_uint8
from raytracingengine_tpu_torch.utils.metrics import MetricsLogger, fit_callback

BUILTIN_SCENES = {
    "head_box": builders.head_box_scene,
    "baseline_spheres": builders.baseline_sphere_scene,
    "glass": builders.glass_sphere_scene,
    "stress": builders.stress_scene,
    "dense_mesh": builders.dense_mesh_scene,
}


def _build_scene(args):
    kw = dict(width=args.width, height=args.height, spp=args.spp, device=args.device)
    if args.scene in BUILTIN_SCENES:
        return BUILTIN_SCENES[args.scene](**kw)
    return load_scene_json(args.scene, **kw)


def _save(img_u8, path_base: str, fmt: str) -> str:
    path = f"{path_base}.{fmt}"
    (write_png if fmt == "png" else write_ppm)(path, img_u8.cpu().numpy())
    return path


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args) -> int:
    if args.mesh:
        # The ranks of torchrun (or one rank without it): each renders its
        # pixels, the frame is gathered onto every rank, rank 0 writes it.
        initialize_distributed()
        mesh = make_mesh()
        render = lambda s, c, k: render_hdr_sharded(s, c, k, mesh)  # noqa: E731
    else:
        mesh, render = None, render_hdr
    scene, camera = _build_scene(args)
    cfg = RenderConfig(max_depth=args.max_depth, chunk_size=args.chunk_size,
                       shadow_mode=args.shadow_mode, use_pallas=args.use_pallas)
    device = scene.device
    with torch.no_grad():
        t0 = time.perf_counter()
        hdr = render(scene, camera, cfg)
        _sync(device)
        t1 = time.perf_counter()
        # The timing printout of RaytracingEngine.cpp:292-299, with the first
        # call (the kernels' build and load) apart.
        render(scene, camera, cfg)
        _sync(device)
        t2 = time.perf_counter()
    if mesh is not None and mesh.rank != 0:
        return 0
    print(f"render: {camera.width}x{camera.height} spp={camera.spp} first={t1 - t0:.2f}s "
          f"steady={t2 - t1:.3f}s ({camera.num_pixels * camera.spp / max(t2 - t1, 1e-9) / 1e6:.1f} "
          "Mrays/s)")
    os.makedirs(args.out, exist_ok=True)
    names = list(OPERATORS) if args.tonemap == "all" else [args.tonemap]
    for name in names:
        path = _save(to_uint8(OPERATORS[name](hdr)), os.path.join(args.out, name), args.format)
        print(f"wrote {path}")
    return 0


def cmd_aov(args) -> int:
    scene, camera = _build_scene(args)
    with torch.no_grad():
        aovs = render_aovs(scene, camera)
    os.makedirs(args.out, exist_ok=True)
    for name, a in aovs.items():
        if a.dim() == 2:
            a = a[..., None].expand(*a.shape, 3)
        u8 = (a.clamp(0, 1) * 255).to(torch.uint8)
        print(f"wrote {_save(u8, os.path.join(args.out, name), args.format)}")
    return 0


def cmd_fit(args) -> int:
    """Inverse-rendering demo (BASELINE config #4): perturb the scene's
    sphere albedos, recover them by Adam on the pixel L2 loss, report the
    loss curve and write the target, initial and fitted renders."""
    scene_true, camera = _build_scene(args)
    cfg = RenderConfig(shadow_mode="binary", chunk_size=args.width * args.height)

    def render(scene):
        with torch.no_grad():
            return render_hdr(scene, camera, cfg)

    target = render(scene_true)
    sph = scene_true.spheres
    mats = dataclasses.replace(sph.materials, color=(sph.materials.color + args.perturb).clamp(0.0, 1.0))
    scene0 = dataclasses.replace(scene_true, spheres=dataclasses.replace(sph, materials=mats))
    params0, _ = partition(scene0)
    mask = select(params0, ["spheres.materials.color"])
    adam = lambda ps: torch.optim.Adam(ps.values(), lr=args.lr)  # noqa: E731
    logger = MetricsLogger()
    fitted, losses = fit(scene0, camera, cfg, target, steps=args.steps, optimizer=adam, mask=mask,
                         callback=fit_callback(logger))
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} in {args.steps} steps")
    os.makedirs(args.out, exist_ok=True)
    for name, scn in (("target", scene_true), ("initial", scene0), ("fitted", fitted)):
        img = to_uint8(aces_approx(render(scn)))
        print(f"wrote {_save(img, os.path.join(args.out, name), args.format)}")
    if args.checkpoint:
        p, _ = partition(fitted)
        # The JAX CLI saves a freshly initialised optimizer state beside the
        # fitted params; so does this one.
        save_checkpoint(args.checkpoint, p, masked_optimizer(p, mask, adam).state_dict(),
                        step=args.steps)
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracingengine_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="head_box", help="builtin name or scene JSON path")
        sp.add_argument("--width", type=int, default=512)
        sp.add_argument("--height", type=int, default=512)
        sp.add_argument("--spp", type=int, default=4)
        sp.add_argument("--out", default="out")
        sp.add_argument("--format", choices=["png", "ppm"], default="png")
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the kernels) or cpu (their plain versions)")

    r = sub.add_parser("render", help="render + tonemap")
    common(r)
    r.add_argument("--tonemap", default="aces", help="operator name or 'all' (the 7-operator family)")
    r.add_argument("--max-depth", type=int, default=10)
    r.add_argument("--chunk-size", type=int, default=65536)
    r.add_argument("--use-pallas", action="store_true",
                   help="the hand-written trace kernels (chain, wavefront, in-kernel AA)")
    r.add_argument("--shadow-mode", choices=["march", "binary", "soft"], default="march")
    r.add_argument("--mesh", action="store_true",
                   help="shard the pixels over the ranks (torchrun for several cards; one rank "
                        "without it)")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("aov", help="depth/normal/albedo/hit maps")
    common(a)
    a.set_defaults(fn=cmd_aov)

    f = sub.add_parser("fit", help="inverse rendering demo: recover perturbed scene params")
    common(f)
    f.add_argument("--steps", type=int, default=150)
    f.add_argument("--lr", type=float, default=2e-2)
    f.add_argument("--perturb", type=float, default=0.15, help="albedo perturbation magnitude")
    f.add_argument("--checkpoint", default=None, help="checkpoint file (torch.save), written at the end")
    f.set_defaults(fn=cmd_fit)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
