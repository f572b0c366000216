"""Fault-tolerant banded rendering: detect and retry at the band level.

The reference has no failure handling (one process, exceptions only). For
long offline renders the frame is split into independent bands of rows,
each rendered with bounded retries and checked for finite values; a band
that raised (a device error, a preemption) or came back with non-finite
pixels is rendered again. A band is a pure function of (scene, camera,
seed, its rows): each pixel's jitter is keyed by its row-major id, so a
retry is always safe and the frame equals `render_hdr`'s. The host-side
complement of the NaN guards (utils/checks.py).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_pixels
from raytracingengine_tpu_torch.scene import Scene


def render_hdr_faulttolerant(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    seed: int = 0,
    tile_rows: int = 8,
    max_retries: int = 2,
    on_event: Callable[[str, dict], None] | None = None,
) -> torch.Tensor:
    """Render in `tile_rows` horizontal bands with a retry per band ->
    [H, W, 3] on the scene's device, forward only.

    A band is retried when rendering it raises or its result holds a
    non-finite value; after `max_retries` the error propagates. `on_event`
    gets ("band_ok", {band, attempt}) and ("band_retry", {band, attempt,
    error}). Each band goes through this module's `render_pixels`, which a
    test may replace to inject a fault."""
    h, w = camera.height, camera.width
    rows_per = -(-h // tile_rows)
    out = torch.zeros((h, w, 3), dtype=torch.float32, device=scene.device)

    def emit(event, **fields):
        if on_event is not None:
            on_event(event, fields)

    for band in range(tile_rows):
        y0, y1 = band * rows_per, min((band + 1) * rows_per, h)
        if y0 >= y1:
            break
        for attempt in range(max_retries + 1):
            try:
                with torch.no_grad():
                    result = render_pixels(scene, camera, cfg, y0 * w, y1 * w, seed=seed)
                if not bool(torch.isfinite(result).all()):
                    raise FloatingPointError(f"non-finite pixels in band {band}")
                out[y0:y1] = result.reshape(y1 - y0, w, 3)
                emit("band_ok", band=band, attempt=attempt)
                break
            except Exception as e:  # a device fault or non-finite pixels: retry the band
                emit("band_retry", band=band, attempt=attempt, error=str(e))
                if attempt == max_retries:
                    raise
                time.sleep(0.1 * (attempt + 1))
    return out
