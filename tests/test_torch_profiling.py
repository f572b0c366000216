"""PyTorch port, utils/profiling.py on the CPU, as tests/test_profiling.py
checks the JAX package's: the call is traced, the Chrome trace lands in
the directory and parses. A CPU trace has no device events, so the report
holds the wall time and the host ranges only; phase 8 of chip_smoke.py
reads the device tables on the card."""

import torch

from raytracingengine_tpu_torch.utils.profiling import TraceReport, parse_trace_dir, profile_step


def test_profile_step_captures_and_parses(tmp_path):
    x = torch.arange(4096, dtype=torch.float32)
    calls = []

    def step():
        calls.append(1)
        with torch.profiler.record_function("square_sum"):
            return (x * x + 1.0).sum()

    rep = profile_step(step, trace_dir=str(tmp_path), warmup=2)
    assert isinstance(rep, TraceReport) and len(calls) == 3
    assert rep.wall_ms > 0.0 and rep.trace_dir == str(tmp_path)
    assert list(tmp_path.glob("*.pt.trace.json"))
    op_ms, module_ms = parse_trace_dir(str(tmp_path))
    assert op_ms == rep.op_ms == {} and module_ms == rep.module_ms == {}
    assert rep.device_total_ms == 0.0
    assert rep.host_ms["square_sum"] > 0.0
    assert rep.pretty().startswith("wall ")
    assert parse_trace_dir(str(tmp_path / "empty")) == ({}, {})
