"""The images a cell encodes, made from the seed on the device.

Each image is a smooth gradient with a structured texture and Gaussian
noise, with a brightness of its own (photographic complexity at Q50:
neither flat nor noise), as `chip_smoke.py`'s `batch_images_on_card`
makes them; here the generator is seeded from `--seed` and the noise is
made in chunks, so the pool's float temporaries stay near a gigabyte.

A configuration's `sizes` lists its image sizes with their shares of the
pool. Every seed gets the same number of images of each size; the seed
draws their order and their noise.
"""
from __future__ import annotations

import random

import numpy as np
import torch

_CHUNK_PIXELS = 1 << 27  # pixels of noise a chunk draws per channel call


def slot_sizes(sizes: list, n: int, seed: int) -> list:
    """(height, width) of each of n pool images: the sizes in proportion
    to their shares (the expanded share list, cycled), in an order drawn
    from the seed."""
    cycle = [(s["height"], s["width"]) for s in sizes
             for _ in range(s["share"])]
    out = [cycle[i % len(cycle)] for i in range(n)]
    if len(sizes) > 1:
        random.Random(seed).shuffle(out)
    return out


def _images(index: list, h: int, w: int, g, device: str):
    """uint8 RGB images [len(index), h, w, 3] on the host, one chunk of
    noise draws at a time; `index` gives each image's brightness."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    grad = (xx + yy) * (255.0 / (h + w))
    tex = 20.0 * torch.sin(xx / 3.1) * torch.cos(yy / 2.7)
    weights = ((0.9, 1.0), (1.0, 1.0), (1.1, -1.0))
    n = len(index)
    out = np.empty((n, h, w, 3), np.uint8)
    step = max(1, _CHUNK_PIXELS // (h * w))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        shift = (torch.tensor(index[lo:hi], device=device) % 61 - 30
                 ).float()[:, None, None]
        chans = [grad * a + tex * b + shift
                 + 6.0 * torch.randn((hi - lo, h, w), generator=g,
                                     device=device)
                 for a, b in weights]
        out[lo:hi] = torch.stack(chans, -1).clamp(0, 255).to(
            torch.uint8).cpu().numpy()
    return out


def make_pool(sizes: list, n: int, seed: int, device: str) -> list:
    """n distinct uint8 RGB images [h, w, 3] of `sizes` (slot_sizes) from
    `seed`, made on `device` a size at a time and copied to the host
    once."""
    g = torch.Generator(device=device).manual_seed(seed & ((1 << 63) - 1))
    shapes = slot_sizes(sizes, n, seed)
    pool: list = [None] * n
    for h, w in dict.fromkeys(shapes):
        index = [i for i, s in enumerate(shapes) if s == (h, w)]
        for i, image in zip(index, _images(index, h, w, g, device)):
            pool[i] = image
    return pool
