"""jpegtpu_torch — the jpegtpu JPEG encode engine in PyTorch, for NVIDIA
Hopper.

The port of `jpegtpu` (JAX/Pallas on a TPU), which stays the reference
it is held against byte for byte. This slice encodes one grayscale image
at the default EncodeConfig: the four Pallas kernels of that path are
hand-written CUDA kernels (csrc/), each with a plain PyTorch version
beside it that runs when the tensors lie on the CPU. Entry points run on
the CUDA device unless the caller passes `device="cpu"`.
"""
from .config import EncodeConfig
from .pipeline import encode_file, encode_grayscale, grayscale_coefficients

__version__ = "0.1.0"

__all__ = [
    "EncodeConfig",
    "encode_file",
    "encode_grayscale",
    "grayscale_coefficients",
]
