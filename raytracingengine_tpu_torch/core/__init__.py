from raytracingengine_tpu_torch.core.camera import Camera

__all__ = ["Camera"]
