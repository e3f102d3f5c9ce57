"""Closed-loop batch calls on frames that are already on the device:
`jpegtpu_torch.encode_color_batch` on `images_per_call` tensors a call,
the next call as soon as the last returns, cycling through the pool.

Set-up copies the pool to `cell.device` once, as planar [3, H, W] uint8
tensors (the layout a video decoder hands out); each call passes their
[H, W, 3] views (`.permute(1, 2, 0)`), which the program reads in place.
On device="cpu" the same code passes CPU tensors."""
from __future__ import annotations

import time

import torch

import jpegtpu_torch

from benchmark.harness import Window


def _call(cell, frames):
    return jpegtpu_torch.encode_color_batch(frames, cell.encode_config,
                                            device=cell.device)


def warm(cell) -> None:
    """Copy the pool to the device as planar frames, then one call at the
    cell's size."""
    cell.frames = [torch.from_numpy(image).to(cell.device)
                   .permute(2, 0, 1).contiguous() for image in cell.pool]
    n = cell.traffic["images_per_call"]
    _call(cell, [cell.frames[i % len(cell.frames)].permute(1, 2, 0)
                 for i in range(n)])


def window(cell) -> Window:
    win = Window()
    n = cell.traffic["images_per_call"]
    n_pool = len(cell.pool)
    win.t_start = time.perf_counter()
    t_stop = win.t_start + cell.seconds
    k = 0
    while k == 0 or time.perf_counter() < t_stop:
        with cell.span("bench.next_image"):
            index = [(k * n + j) % n_pool for j in range(n)]
            frames = [cell.frames[i].permute(1, 2, 0) for i in index]
        if k == 0:
            cell.sample.choose([tuple(frame.shape) for frame in frames])
        win.attempted += n
        with cell.span("bench.call"):
            files = _call(cell, frames)
        with cell.span("bench.return"):
            for j, (i, data) in enumerate(zip(index, files)):
                if data:
                    cell.returned(win, j, i, data)
        k += 1
    win.t_end = time.perf_counter()
    return win
