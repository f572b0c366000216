"""Structured per-step metrics.

The reference's observability is two cout lines (thread count and render
wall-clock, RaytracingEngine.cpp:218-221, :292-299). Here: a JSON-lines
metrics logger, used by the CLI's fit loop.
"""

from __future__ import annotations

import json
import sys
import time


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
