"""PyTorch port, the profiler spans at its host layers (utils/profiling.py::
span) on the CPU: a training step and a frame (render_hdr -> tonemap ->
to_uint8) of the head box through the kernels' route (`use_pallas`, binary
shadows: the wrappers and ChainTraceFused, their plain versions here) open
the layer spans under a profiler, one `rte.launch.<kernel>` per wrapper
call; a glass frame past 128 triangles opens `rte.cull` around the culled
packing once, inside `rte.tables`; with no profiler recording they enter
no profiler range at all; and `profile_step` reads a step's host ms by
layer."""

import dataclasses
import json
import re

import pytest
import torch

from raytracingengine_tpu_torch.inverse import make_train_step, partition
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr
from raytracingengine_tpu_torch.scenes import dense_mesh_scene, glass_sphere_scene, head_box_scene
from raytracingengine_tpu_torch.tonemap import to_uint8, tonemap
from raytracingengine_tpu_torch.utils import profiling
from rtbench.harness import spans

torch.set_num_threads(2)

W, H = 16, 12
#: The span families; a name is "rte.<family>", or "rte.launch.<kernel>".
FAMILIES = ("tables", "cull", "rays", "launch", "autograd", "optimizer", "tonemap")
NAME = {f: re.compile(rf"^rte\.{f}\.\w+$" if f == "launch" else rf"^rte\.{f}$") for f in FAMILIES}


def _workload(spp: int):
    """-> (a step, a frame): one make_train_step step and one tonemapped
    uint8 frame of the head box at W x H and `spp`."""
    cfg = RenderConfig(shadow_mode="binary", use_pallas=True, chunk_size=W * H, max_depth=3,
                       differentiable=spp > 1)
    scene, cam = head_box_scene(width=W, height=H, spp=spp, device="cpu")
    params, static = partition(scene)
    opt = torch.optim.SGD(params.values(), lr=1e-6)
    train_step = make_train_step(cam, cfg, opt, loss_fn=lambda img, _: (img * img).mean())

    def step():
        return train_step(params, static, None, seed=5)

    def frame():
        with torch.no_grad():
            return to_uint8(tonemap(render_hdr(scene, cam, cfg, seed=5)))

    return step, frame


def _glass_mesh_frame():
    """-> a frame of the glass sphere scene with dense_mesh_scene's bumpy
    mesh at 3 x 33 (132 triangles: the culled tables) made transparent
    (0.7, ior 1.3), through the kernels' route with march shadows."""
    glass, cam = glass_sphere_scene(width=8, height=8, device="cpu")
    mesh = dense_mesh_scene(width=8, height=8, ni=3, nj=33, device="cpu")[0].triangles
    m = mesh.materials
    mats = dataclasses.replace(m, transparency=torch.full_like(m.transparency, 0.7),
                               refractive_index=torch.full_like(m.refractive_index, 1.3))
    scene = dataclasses.replace(glass, triangles=dataclasses.replace(mesh, materials=mats))
    assert len(scene.triangles) == 132
    cfg = RenderConfig(use_pallas=True, chunk_size=64, max_depth=3)

    def frame():
        with torch.no_grad():
            return render_hdr(scene, cam, cfg, seed=5)

    return frame


def _user_ranges(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("spp", [1, 2])
def test_spans_name_each_layer(tmp_path, spp):
    step, frame = _workload(spp)
    step()  # the first call's lazy set-up stays out of the trace
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
        frame()
    ranges = [e for e in _user_ranges(prof, tmp_path) if e["name"].startswith("rte.")]
    names = [e["name"] for e in ranges]
    for name in set(names):
        assert sum(bool(rx.match(name)) for rx in NAME.values()) == 1, name
    assert {"rte.tables", "rte.rays", "rte.autograd", "rte.optimizer", "rte.tonemap",
            "rte.launch.chain_trace", "rte.launch.chain_grad"} <= set(names)
    # one chain_trace per sample in the step's forward and in the frame; one
    # adjoint per sample in the step's backward
    assert names.count("rte.launch.chain_trace") == 2 * spp
    assert names.count("rte.launch.chain_grad") == spp
    assert names.count("rte.optimizer") == 2  # zero_grad, step
    assert names.count("rte.tonemap") == 2  # tonemap, to_uint8

    def encloses(outer, inner):
        return (outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])

    launches = sorted((e for e in ranges if e["name"] == "rte.launch.chain_trace"),
                      key=lambda e: e["ts"])
    glue = [e for e in ranges if e["name"] == "rte.autograd"]
    # the step's forward launches run inside ChainTraceFused.forward's span,
    # the frame's (no gradients) straight from the pipeline
    assert all(any(encloses(g, x) for g in glue) for x in launches[:spp])
    assert not any(encloses(g, x) for g in glue for x in launches[spp:])
    # the head box packs no culled tables; a glass frame past 128 triangles
    # packs them once, inside the tables' span (here `spp` frames)
    assert "rte.cull" not in names
    glass = _glass_mesh_frame()
    glass()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(spp):
            glass()
    ranges = _user_ranges(prof, tmp_path)
    culls = [e for e in ranges if e["name"] == "rte.cull"]
    tables = [e for e in ranges if e["name"] == "rte.tables"]
    assert len(culls) == spp
    assert all(any(encloses(t, c) for t in tables) for c in culls)
    assert spans.family("rte.cull") == "cull"


def test_no_range_without_a_profiler(monkeypatch):
    step, frame = _workload(2)
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    step()
    frame()
    _glass_mesh_frame()()  # the culled packing's span too
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step()
    assert "rte.launch.chain_grad" in entered and "rte.optimizer" in entered


def test_span_is_shared_noop_when_off():
    assert profiling.span("rte.tables") is profiling.span("rte.rays")
    assert profiling.span("rte.cull") is profiling.span("rte.tables")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.span("rte.tables")
    assert isinstance(on, torch.profiler.record_function)


def test_profile_step_host_ms_by_layer(tmp_path):
    step, _ = _workload(1)
    rep = profiling.profile_step(step, trace_dir=str(tmp_path), warmup=1)
    layers = {k for k in rep.host_ms if k.startswith("rte.")}
    # the caller opens no root range: the layers are the top-level ranges
    # (the launches run inside the autograd spans)
    assert {"rte.tables", "rte.rays", "rte.autograd", "rte.optimizer"} <= layers
    assert all(rep.host_ms[k] > 0.0 for k in layers)

