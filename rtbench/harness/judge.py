"""Whether what the timed path produced is correct: the comparison with the
plain reference (rtbench/reference/<config's "reference">.py).

Render cells: one frame of the window, drawn from the seed, against the
reference's frame of the same pose and AA seed. The reference also renders
the frame with every screen point shifted by 0.05 pixel, up, down, left
and right: more than what float32 rounding moves the program's rays and
silhouettes from the reference's (a sphere's b^2 - ac cancels: at 40-65
units a ray's tangency moves by 0.003-0.015 pixel with the rounding of
d.d). A pixel whose value any of these moves changes by more than ten
times the tolerance (1e-4 max(1, |ref|)) is unstable: an
edge, a shadow or reflection boundary, or a chain of reflections between
spheres that magnifies a ray's rounding, within reach of that rounding.
The others are stable, and each is known to within the tolerance plus the
largest change that the four moves make. The moves are traced only at
the pixels that differ from the reference by more than the tolerance.
Compared: `hdr_bad_px`, the stable pixels with a channel off by more than
that, and `u8_bad_subpx`, the stable pixels' uint8 channels more than 1
apart from ACES and toColor of the reference.

Train cells: the first `snapshot_steps` steps, followed by the reference
from the same description, target and seeds (its own target render,
autograd gradients, Adam). Compared: `loss_gap`, the largest relative gap
of a step's loss; `grad_gap`, the worst leaf's gap between the norms of
the first gradient (the program's read from Adam's first moment after
step 1), relative to the larger of that leaf's reference norm and the
median leaf's; `change_gap`, the same of the params' change over the
steps, over the leaves whose reference gradient is at least a thousandth
of the median leaf's (the others move by round-off alone under Adam).
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

STABILITY_SHIFT_PX = 0.05
#: A move that changes a pixel by more than this many tolerances marks it unstable.
UNSTABLE_FACTOR = 10.0
TOL = 1e-4
#: Leaves whose first reference gradient is under this share of the median
#: leaf's move under Adam by round-off alone: left out of `change_gap`.
ROUNDOFF_SHARE = 1e-3


def reference_module(config: dict):
    return importlib.import_module(f"rtbench.reference.{config['reference']}")


@dataclasses.dataclass
class Verdict:
    numbers: dict[str, float]
    limits: dict[str, float]
    counts: dict  # the reference's work counts, for the per-layer readers

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= self.limits[k] for k, v in self.numbers.items())


def _shifts() -> list[tuple[float, float]]:
    e = STABILITY_SHIFT_PX
    return [(e, 0.0), (-e, 0.0), (0.0, e), (0.0, -e)]


def _settings(config: dict) -> dict:
    p = config["program"]
    return {"bias": p["bias"], "min_weight": p["min_weight"], "max_depth": p["max_depth"]}


def reference_frame(ref, config, traffic, pose: dict, aa_seed: int, device, dtype=torch.float32,
                    counts=None, shift=(0.0, 0.0), pid=None):
    leaves = ref.scene_leaves(config["scene"], device, dtype)
    with torch.no_grad():
        return ref.render(ref.prims(leaves), pose, traffic["width"], traffic["height"],
                          traffic["spp"], aa_seed, _settings(config), counts, shift=shift,
                          pid=pid, dtype=dtype)


def judge_render(config, traffic, out: dict, poses: list[dict], device, limits,
                 control: bool = False) -> Verdict:
    """`out`: the program's kept frame (RenderRun.outputs()). With
    `control`, the reference in bfloat16 takes the program's place."""
    ref = reference_module(config)
    pose = poses[out["pose"]]
    counts = ref.Counts()
    base = reference_frame(ref, config, traffic, pose, out["aa_seed"], device, counts=counts)
    tol = TOL * base.abs().clamp_min(1.0)
    if control:
        hdr = reference_frame(ref, config, traffic, pose, out["aa_seed"], device,
                              dtype=torch.bfloat16).float()
        u8 = ref.aces_uint8(hdr)
    else:
        hdr = out["hdr"].to(base.device)
        u8 = torch.as_tensor(out["u8"], device=base.device)
    ref_u8 = ref.aces_uint8(base)
    off = (u8.int() - ref_u8.int()).abs() > 1
    finite = torch.isfinite(hdr).all(1)
    # Only a pixel beyond the tolerance can be bad: the moves are traced
    # for those alone (a pixel within it passes whether stable or not).
    cand = (~finite | ((hdr - base).abs() > tol).any(1) | off.any(1)).nonzero()[:, 0]
    spread = torch.zeros_like(base[cand])
    for s in _shifts():
        probe = reference_frame(ref, config, traffic, pose, out["aa_seed"], device, shift=s,
                                pid=cand)
        spread = torch.maximum(spread, (probe - base[cand]).abs())
    stable = (spread <= UNSTABLE_FACTOR * tol[cand]).all(1)
    gap = (hdr[cand] - base[cand]).abs() / (tol[cand] + spread)
    bad = stable & (~finite[cand] | (gap > 1).any(1))
    numbers = {
        "hdr_bad_px": float(bad.sum()),
        "u8_bad_subpx": float((off[cand] & stable[:, None]).sum()),
    }
    worst = [{"px": int(cand[i]), "prog": hdr[cand[i]].tolist(), "ref": base[cand[i]].tolist(),
              "spread": spread[i].tolist()}
             for i in torch.where(bad[:, None], gap, torch.zeros_like(gap)).amax(1)
             .topk(min(5, int(bad.sum()))).indices]
    return Verdict(numbers, limits, {"frame": counts, "seam_px": int((~stable).sum()),
                                     "pixels": base.shape[0], "worst": worst,
                                     "scene_bytes": ref.scene_bytes(
                                         ref.prims(ref.scene_leaves(config["scene"], device)))})


def _norms(ts: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in ts.items() if v.numel()}


def reference_steps(ref, config, traffic, out: dict, device, dtype=torch.float32):
    """The reference's first steps -> (losses, first grads, params before,
    params after, work counts of step 1)."""
    w, h, spp = traffic["width"], traffic["height"], traffic["spp"]
    cfg = _settings(config)
    cam = config["camera"]
    with torch.no_grad():
        tgt = ref.render(ref.prims(ref.scene_leaves(out["target_desc"], device, dtype)), cam,
                         w, h, spp, out["target_seed"], cfg, dtype=dtype).reshape(h, w, 3)
    leaves = ref.scene_leaves(config["scene"], device, dtype)
    keep = traffic["trainable"]
    trainable = {k for k in leaves if any(s in k for s in keep)}
    p0 = {k: v.clone() for k, v in leaves.items()}
    state, losses, g1 = {}, [], None
    counts = ref.Counts()
    lr = traffic["optimizer"]["lr"]
    for k, seed in enumerate(out["step_seeds"]):
        loss, grads = ref.loss_and_grads(leaves, tgt, cam, w, h, spp, seed, cfg, trainable,
                                         counts=counts if k == 0 else None)
        losses.append(loss)
        if k == 0:
            g1 = grads
        leaves = ref.adam_step(leaves, grads, state, k + 1, lr)
    return losses, g1, p0, leaves, counts


def judge_train(config, traffic, out: dict, device, limits, control: bool = False) -> Verdict:
    ref = reference_module(config)
    losses, g1, p0, pn, counts = reference_steps(ref, config, traffic, out, device)
    if control:
        c_losses, c_g1, c_p0, c_pn, _ = reference_steps(ref, config, traffic, out, device,
                                                        dtype=torch.bfloat16)
        out = {"losses": c_losses, "g1": {k: v.float().cpu() for k, v in c_g1.items()},
               "p0": {k: v.float().cpu() for k, v in c_p0.items()},
               "pn": {k: v.float().cpu() for k, v in c_pn.items()}}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], losses))
    gr = _norms({k: v.cpu() for k, v in g1.items()})
    med = float(np.median([v for v in gr.values() if v > 0]))
    gp = _norms(out["g1"])
    grad_gap = max(abs(gp.get(k, 0.0) - v) / max(v, med) for k, v in gr.items())
    counted = [k for k, v in gr.items() if v >= ROUNDOFF_SHARE * med]
    dr = {k: float((pn[k] - p0[k]).double().norm()) for k in counted}
    dmed = float(np.median(list(dr.values())))
    dp = {k: float((out["pn"][k] - out["p0"][k]).double().norm()) for k in counted}
    change_gap = max(abs(dp[k] - dr[k]) / max(dr[k], dmed) for k in counted)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    leaves = ref.scene_leaves(config["scene"], device)
    return Verdict(numbers, limits, {"step": counts, "pixels": traffic["width"] * traffic["height"],
                                     "scene_bytes": ref.scene_bytes(ref.prims(leaves)),
                                     "left_out": sorted(set(gr) - set(counted))})
