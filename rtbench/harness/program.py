"""The system under test, driven as its users drive it.

Everything that imports raytracingengine_tpu_torch is here, and it imports
it inside the functions: the package's public entry points only
(SceneBuilder, Camera, RenderConfig, render_hdr, tonemap, to_uint8,
partition, masked_optimizer, make_train_step). The benchmark hands the
port the scene description it made from the config and the seed; the
port builds its own tables and rays from it.

Two kinds of traffic (the traffic file's "kind"):

* "render": frames in a closed loop, one client. Frame i renders pose
  i mod P of the camera path with its own AA seed: `render_hdr`, ACES
  `tonemap`, `to_uint8`, and a copy of the image to the host.
* "train": `make_train_step`'s step (forward, L2 loss against a target
  rendered at set-up, backward, Adam) with the loss read on the host
  after every step, as `fit` does.

`fault` plants one of the faults the comparison has to catch (the
control's tests): "frozen" (the optimizer step leaves the state as it
was), "half_batch" (the loss over the top half of the rows only) and
"altered" (one warp's 32 pixels of every frame off by 0.5).
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

FAULTS = ("frozen", "half_batch", "altered")
ADAM_BETA1 = 0.9


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent generators per purpose, all from the run's seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def perturbed(desc: dict, spec: dict, seed: int) -> dict:
    """The description with the leaves named in `spec` scaled by factors
    uniform in [1 - s, 1 + s] (one per value): the training target."""
    rng = rng_for(seed, 1)
    out = copy.deepcopy(desc)
    for key, s in sorted(spec.items()):
        if key == "lights.intensity":
            for li in out["lights"]:
                li["intensity"] *= float(rng.uniform(1 - s, 1 + s))
        elif key == "meshes.material.color":
            for m in out["meshes"]:
                m["material"]["color"] = [c * float(rng.uniform(1 - s, 1 + s))
                                          for c in m["material"]["color"]]
        else:
            raise ValueError(f"target perturbation: unknown key {key!r}")
    return out


def camera_path(cam: dict, traffic: dict, seed: int) -> list[dict]:
    """P poses around the documented camera position, offsets uniform in
    +-`pose_offset` per axis. The set of poses is the traffic's own (drawn
    from its `pose_seed`), so every run does the same work; the run's seed
    sets the order in which the path visits them."""
    rng = np.random.default_rng(int(traffic.get("pose_seed", 0)))
    off = np.asarray(traffic.get("pose_offset", (0.0, 0.0, 0.0)), np.float64)
    poses = []
    for _ in range(int(traffic.get("poses", 1))):
        c = dict(cam)
        c["position"] = (np.asarray(cam["position"], np.float64)
                         + rng.uniform(-off, off)).tolist()
        poses.append(c)
    order = rng_for(seed, 2).permutation(len(poses))
    return [poses[k] for k in order]


def trainable_mask(params: dict, keep: list[str]) -> dict[str, bool]:
    """The leaves whose dotted path contains one of `keep` train."""
    return {k: any(s in k for s in keep) for k in params}


def draw_seeds(seed: int, stream: int, n: int) -> list[int]:
    return [int(x) for x in rng_for(seed, stream).integers(0, 2**31 - 1, n)]


def build_scene(desc: dict, settings: dict, device):
    from raytracingengine_tpu_torch.geometry.materials import Material
    from raytracingengine_tpu_torch.scene import SceneBuilder

    def mat(m):
        return Material(**{k: (tuple(v) if k == "color" else v) for k, v in m.items()})

    b = SceneBuilder()
    for s in desc.get("spheres", []):
        b.add_sphere(s["center"], s["radius"], mat(s["material"]))
    for p in desc.get("planes", []):
        b.add_plane(p["point"], p["normal"], mat(p["material"]))
    for m in desc.get("meshes", []):
        b.add_model(np.asarray(m["vertices"], np.float64), np.asarray(m["indices"], np.int64),
                    mat(m["material"]), translation=tuple(m.get("translation", (0, 0, 0))))
    for li in desc.get("lights", []):
        b.add_light(li["position"], li["color"], li["intensity"])
    return b.build(pad_multiple=settings.get("pad_multiple"), device=device)


def build_camera(cam: dict, width: int, height: int, spp: int, device):
    from raytracingengine_tpu_torch.core.camera import Camera

    return Camera.create(cam["position"], focal=cam["focal"], width=width, height=height,
                         near=cam["near"], far=cam["far"], spp=spp, device=device)


def render_config(settings: dict, traffic: dict):
    from raytracingengine_tpu_torch.render.config import RenderConfig

    return RenderConfig(
        max_depth=settings["max_depth"], bias=settings["bias"], min_weight=settings["min_weight"],
        shadow_mode=settings["shadow_mode"], use_pallas=settings["use_pallas"],
        chunk_size=traffic["width"] * traffic["height"],  # one chunk a frame
        differentiable=bool(traffic.get("differentiable", False)),
    )


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class RenderRun:
    """Frames of one cell: `iteration(i)` renders frame i and returns when
    its uint8 image is on the host."""

    kind = "render"

    def __init__(self, config: dict, traffic: dict, seed: int, device, fault: str | None = None):
        t0 = time.perf_counter()
        from raytracingengine_tpu_torch.render.pipeline import render_hdr
        from raytracingengine_tpu_torch.tonemap import tonemap, to_uint8

        self._render, self._tonemap, self._u8 = render_hdr, tonemap, to_uint8
        self.device, self.fault = device, fault
        self.phases = {"import_port_s": time.perf_counter() - t0}
        w, h, spp = traffic["width"], traffic["height"], traffic["spp"]
        self.scene = build_scene(config["scene"], config["program"], device)
        self.poses = camera_path(config["camera"], traffic, seed)
        self.cameras = [build_camera(p, w, h, spp, device) for p in self.poses]
        self.cfg = render_config(config["program"], traffic)
        self._seeds = draw_seeds(seed, 3, 1 << 16)
        self._warp = int(rng_for(seed, 4).integers(0, w * h // 32)) * 32
        self._keep_rng = rng_for(seed, 5)
        self.kept: tuple[int, torch.Tensor, np.ndarray] | None = None
        self.seen = 0

    def begin_window(self) -> None:
        """The compared frame is drawn from the window's frames only."""
        self.seen, self.kept = 0, None

    def pose_of(self, i: int) -> int:
        return i % len(self.cameras)

    def aa_seed(self, i: int) -> int:
        return self._seeds[i % len(self._seeds)]

    def iteration(self, i: int) -> bool:
        hdr = self._render(self.scene, self.cameras[self.pose_of(i)], self.cfg,
                           seed=self.aa_seed(i))
        if self.fault == "altered":
            hdr = hdr.clone()
            hdr.view(-1, 3)[self._warp:self._warp + 32] += 0.5
        img = self._u8(self._tonemap(hdr)).cpu().numpy()
        self._reservoir(i, hdr, img)
        return True

    def _reservoir(self, i, hdr, img) -> None:
        """Keep one frame of all those rendered, uniformly, drawn from the seed."""
        self.seen += 1
        if self._keep_rng.integers(0, self.seen) == 0:
            self.kept = (i, hdr, img)

    def outputs(self) -> dict:
        i, hdr, img = self.kept
        return {"frame": i, "pose": self.pose_of(i), "aa_seed": self.aa_seed(i),
                "hdr": hdr.detach().reshape(-1, 3).float().cpu(), "u8": img.reshape(-1, 3)}

    def free(self) -> None:
        self.kept = (self.kept[0], None, self.kept[2]) if self.kept else None
        self.scene = self.cameras = None


class TrainRun:
    """Training steps of one cell. Set-up builds the step, its params and
    Adam, renders the target, and drives the first `snapshot_steps` steps
    through the same call the window makes, keeping what the comparison
    reads: each step's loss, Adam's first moment after step 1 (the first
    gradient) and the params before step 1 and after the last of them."""

    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device, fault: str | None = None):
        t0 = time.perf_counter()
        from raytracingengine_tpu_torch.inverse import make_train_step, partition
        from raytracingengine_tpu_torch.inverse.optimize import masked_optimizer
        from raytracingengine_tpu_torch.render.pipeline import render_hdr

        self.device, self.fault = device, fault
        self.phases = {"import_port_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        w, h, spp = traffic["width"], traffic["height"], traffic["spp"]
        self.cfg = render_config(config["program"], traffic)
        self.camera = build_camera(config["camera"], w, h, spp, device)
        self.target_desc = perturbed(config["scene"], traffic["target"]["perturb"], seed)
        self.target_seed = draw_seeds(seed, 6, 1)[0]
        with torch.no_grad():
            target_scene = build_scene(self.target_desc, config["program"], device)
            self.target = render_hdr(target_scene, self.camera, self.cfg, seed=self.target_seed)
        _sync(device)
        self.phases["target_s"] = time.perf_counter() - t0
        del target_scene
        scene = build_scene(config["scene"], config["program"], device)
        self.params, self.static = partition(scene)
        lr = traffic["optimizer"]["lr"]
        mask = trainable_mask(self.params, traffic["trainable"])
        t0 = time.perf_counter()
        self.opt = masked_optimizer(self.params, mask,
                                    lambda ps: torch.optim.Adam(ps.values(), lr=lr))
        self.phases["optimizer_s"] = time.perf_counter() - t0
        loss_fn = None
        if fault == "frozen":
            self.opt.step = lambda *a, **k: None
        if fault == "half_batch":
            def loss_fn(img, target):
                return torch.mean((img[: h // 2] - target[: h // 2]) ** 2)
        kw = {} if loss_fn is None else {"loss_fn": loss_fn}
        self.step = make_train_step(self.camera, self.cfg, self.opt, **kw)
        self._seeds = draw_seeds(seed, 7, 1 << 16)
        self.failed = 0
        t0 = time.perf_counter()
        self.snap = self._first_steps(int(traffic["snapshot_steps"]))
        self.phases["first_steps_s"] = time.perf_counter() - t0

    def begin_window(self) -> None:
        """The compared steps are set-up's first steps: nothing to reset."""

    def pose_of(self, i: int) -> int:
        return 0  # one camera

    def step_seed(self, i: int) -> int:
        return self._seeds[i % len(self._seeds)]

    def iteration(self, i: int) -> bool:
        loss, _ = self.step(self.params, self.static, self.target, seed=self.step_seed(i))
        value = float(loss)
        ok = bool(np.isfinite(value))
        self.failed += not ok
        return ok

    def _first_steps(self, n: int) -> dict:
        host = lambda ts: {k: v.detach().float().cpu().clone() for k, v in ts.items()}  # noqa: E731
        p0 = host(self.params)
        losses, g1 = [], {}
        for i in range(n):
            loss, _ = self.step(self.params, self.static, self.target, seed=self.step_seed(i))
            losses.append(float(loss))
            if i == 0:
                for k, p in self.params.items():
                    st = self.opt.state.get(p, {})
                    if "exp_avg" in st:
                        g1[k] = st["exp_avg"].detach().float().cpu() / (1.0 - ADAM_BETA1)
        self.next_iteration = n
        return {"losses": losses, "g1": g1, "p0": p0, "pn": host(self.params),
                "step_seeds": [self.step_seed(i) for i in range(n)]}

    def outputs(self) -> dict:
        return dict(self.snap, target_seed=self.target_seed, target_desc=self.target_desc)

    def free(self) -> None:
        self.params = self.static = self.opt = self.step = self.target = None


def make_run(config: dict, traffic: dict, seed: int, device, fault: str | None = None):
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
    kinds = {"render": RenderRun, "train": TrainRun}
    if traffic.get("kind") not in kinds:
        raise ValueError(f"traffic kind {traffic.get('kind')!r}: expected one of {sorted(kinds)}")
    return kinds[traffic["kind"]](config, traffic, seed, device, fault)


@dataclasses.dataclass
class Window:
    iterations: int
    failed: int
    seconds: float
    latencies_ms: list[float]  # per iteration, host clock: each ends in a host sync
    poses: list[int]  # per iteration, its camera pose (0 in training)
    peak_bytes: int


def run_window(run, seconds: float, start: int) -> Window:
    """Iterations from `start` until `seconds` have passed; the one in
    flight then finishes and counts. Each iteration ends in a host sync
    (the image on the host, or the loss read), so the host clock reads
    its whole latency."""
    cuda = torch.device(run.device).type == "cuda"
    _sync(run.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lat, poses = [], []
    failed, i = 0, start
    t0 = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        failed += not run.iteration(i)
        lat.append((time.perf_counter() - h0) * 1e3)
        poses.append(run.pose_of(i))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    _sync(run.device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return Window(i - start, failed, t1 - t0, lat, poses, peak)


def warm_up(run, n: int) -> int:
    """`n` iterations before the window (set-up); -> the next index."""
    start = getattr(run, "next_iteration", 0)
    for i in range(start, start + n):
        run.iteration(i)
    _sync(run.device)
    return start + n
