"""Pinhole camera and batched primary-ray generation.

The reference camera (Math.h:85-122):

  * screen coords: ``sx = x - width/2``, ``sy = height/2 - y`` (Y flipped),
  * screen point: ``(sx, sy, position.z + focal)``; the focal length is in
    pixels,
  * ray direction: ``normalize(screen_point - position)``, so the x/y
    components are ``sx - position.x`` / ``sy - position.y``,
  * anti-aliasing jitter: uniform in [0, 1) pixel added to both sx and sy,
  * sample 0 of the AA loop is always unjittered (Scene.h:289-296).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: tensors for the parameters, ints for the image."""

    position: torch.Tensor  # [3]
    focal: torch.Tensor  # scalar, in pixels
    near: torch.Tensor  # scalar
    far: torch.Tensor  # scalar
    width: int = 800
    height: int = 600
    spp: int = 32

    @staticmethod
    def create(
        position,
        focal: float = 1.0,
        width: int = 800,
        height: int = 600,
        near: float = 1.0,
        far: float = 1000.0,
        spp: int = 32,
        dtype=torch.float32,
        device: torch.device | str = "cuda",
    ) -> "Camera":
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return Camera(
            position=t(position),
            focal=t(focal),
            near=t(near),
            far=t(far),
            width=int(width),
            height=int(height),
            spp=int(spp),
        )

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def device(self) -> torch.device:
        return self.position.device

    def rays_for_pixels(
        self,
        px: torch.Tensor,
        py: torch.Tensor,
        jitter: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Rays for integer pixel coords px/py [N] -> (origins, dirs) [N,3].

        `jitter` is an optional [N, 2] tensor of uniform [0,1) offsets
        (jx, jy); None means the unjittered sample-0 ray.
        """
        dtype = self.position.dtype
        sx = px.to(dtype) - self.width / 2.0
        sy = self.height / 2.0 - py.to(dtype)
        if jitter is not None:
            sx = sx + jitter[..., 0]
            sy = sy + jitter[..., 1]
        dx = sx - self.position[0]
        dy = sy - self.position[1]
        dz = self.focal.expand(sx.shape)
        norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
        d = torch.stack([dx / norm, dy / norm, dz / norm], dim=-1)
        o = self.position.expand(d.shape)
        return o, d

    def pixel_grid(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat pixel index -> (px, py) [H*W] in row-major order
        (Scene.h:321-323: x = idx % width, y = idx / width)."""
        idx = torch.arange(self.num_pixels, dtype=torch.int32, device=self.device)
        return idx % self.width, idx // self.width
