"""The float64 oracle (a copy of the JAX package's golden/, numpy only)."""

from raytracingengine_tpu_torch.golden.reference import GoldenScene, golden_from_scene

__all__ = ["GoldenScene", "golden_from_scene"]
