"""Structured per-step metrics and throughput counters.

The reference's observability is two cout lines (thread count and render
wall-clock, RaytracingEngine.cpp:218-221, :292-299). Here: a JSON-lines
metrics logger and rays/s accounting, used by the CLI's fit loop.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    seconds: float
    depth: int = 10

    @property
    def primary_rays(self) -> int:
        return self.width * self.height * self.spp

    @property
    def rays_per_s(self) -> float:
        return self.primary_rays / max(self.seconds, 1e-12)

    def as_dict(self) -> dict:
        return {
            "width": self.width,
            "height": self.height,
            "spp": self.spp,
            "seconds": round(self.seconds, 6),
            "primary_rays": self.primary_rays,
            "rays_per_s": round(self.rays_per_s, 1),
            "max_depth": self.depth,
        }


class MetricsLogger:
    """JSON-lines metrics sink: a file (appended to) or stderr."""

    def __init__(self, path: str | None = None):
        self._fh = open(path, "a") if path else sys.stderr
        self._owns = path is not None
        self._t0 = time.time()

    def log(self, event: str, **fields) -> None:
        rec = {"t": round(time.time() - self._t0, 3), "event": event}
        rec.update(fields)
        print(json.dumps(rec), file=self._fh, flush=True)

    def close(self) -> None:
        if self._owns:
            self._fh.close()


def fit_callback(logger: MetricsLogger):
    """Per-step callback for inverse.fit: logs the loss curve as metrics."""

    def cb(step: int, loss: float) -> None:
        logger.log("fit_step", step=step, loss=loss)

    return cb
