"""Device idle ms per traced frame while the host was making the camera
rays (`rte.rays`: pixel ids, `Camera.rays_for_pixels`, the AA jitter):
the innermost `rte.` span open at each idle instant
(`harness/spans.py`)."""

from rtbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "rays", "render")
