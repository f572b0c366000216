from raytracingengine_tpu_torch.imageio.hdr64 import dump_path, have_dump, load_dump, read_hdr64
from raytracingengine_tpu_torch.imageio.obj import load_obj
from raytracingengine_tpu_torch.imageio.png import png_bytes, read_png, write_png
from raytracingengine_tpu_torch.imageio.ppm import ppm_bytes, read_ppm, write_ppm

__all__ = [
    "dump_path",
    "have_dump",
    "load_dump",
    "read_hdr64",
    "load_obj",
    "png_bytes",
    "read_png",
    "write_png",
    "ppm_bytes",
    "read_ppm",
    "write_ppm",
]
