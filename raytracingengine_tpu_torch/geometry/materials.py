"""Materials: scalar description + structure-of-arrays batch.

Mirrors the reference Material (Shape.h:13-19): albedo `color`,
`shininess=128`, `specular=0`, `transparency=0`, `refractive_index=1`.
The renderer consumes the SoA form: one tensor per property, gathered per
hit by global primitive id.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Material:
    """Host-side scalar material (scene-building convenience)."""

    color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    shininess: float = 128.0
    specular: float = 0.0
    transparency: float = 0.0
    refractive_index: float = 1.0


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA materials for N primitives."""

    color: torch.Tensor  # [N, 3]
    shininess: torch.Tensor  # [N]
    specular: torch.Tensor  # [N]
    transparency: torch.Tensor  # [N]
    refractive_index: torch.Tensor  # [N]

    @staticmethod
    def stack(
        mats: list[Material], dtype=torch.float32, device: torch.device | str = "cuda"
    ) -> "Materials":
        n = len(mats)
        t = lambda vals: torch.tensor(vals, dtype=dtype, device=device)
        return Materials(
            color=t([list(m.color) for m in mats]).reshape(n, 3),
            shininess=t([m.shininess for m in mats]),
            specular=t([m.specular for m in mats]),
            transparency=t([m.transparency for m in mats]),
            refractive_index=t([m.refractive_index for m in mats]),
        )

    @staticmethod
    def concat(parts: list["Materials"]) -> "Materials":
        return Materials(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts], dim=0)
            for f in dataclasses.fields(Materials)
        })

    def __len__(self) -> int:
        return self.shininess.shape[0]
