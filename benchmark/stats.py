"""The arithmetic of the end-to-end and per-layer numbers."""
from __future__ import annotations


def rate(work: float, seconds: float) -> float:
    """Work over the window's seconds."""
    return work / seconds


def least_bytes(pixels: int, channels: int, scan_bytes: int) -> int:
    """The least bytes an encode moves: each input pixel byte read once
    and each scan byte written once. It depends only on the images and
    the files, so it reads the same whatever kernels do the work."""
    return pixels * channels + scan_bytes
