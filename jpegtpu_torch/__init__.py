"""jpegtpu_torch — the jpegtpu JPEG encode engine in PyTorch, for NVIDIA
Hopper.

The port of `jpegtpu` (JAX/Pallas on a TPU), which stays the reference
it is held against byte for byte. It encodes one image per call, gray
(`encode_grayscale`) or YCbCr color at 4:2:0, 4:2:2 or 4:4:4
(`encode_color`): the Pallas kernels of those paths are hand-written CUDA
kernels (csrc/), each with a plain PyTorch version beside it that runs
when the tensors lie on the CPU. Entry points run on the CUDA device
unless the caller passes `device="cpu"`.
"""
from .color_pipeline import color_coefficients, encode_color
from .config import EncodeConfig
from .pipeline import encode_file, encode_grayscale, grayscale_coefficients

__version__ = "0.1.0"

__all__ = [
    "EncodeConfig",
    "color_coefficients",
    "encode_color",
    "encode_file",
    "encode_grayscale",
    "grayscale_coefficients",
]
