"""Closed-loop batch calls: `jpegtpu_torch.encode_color_batch` on
`images_per_call` images a call, the next call as soon as the last
returns, cycling through the configuration's pool of distinct images.
Calls start until the window's time is up."""
from __future__ import annotations

import time

import jpegtpu_torch

from benchmark.harness import Window


def _call(cell, images):
    return jpegtpu_torch.encode_color_batch(images, cell.encode_config,
                                            device=cell.device)


def warm(cell) -> None:
    """One call at the cell's size."""
    n = cell.traffic["images_per_call"]
    _call(cell, [cell.pool[i % len(cell.pool)] for i in range(n)])


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
            images = [cell.pool[i] for i in index]
        if k == 0:
            cell.sample.choose([image.shape for image in images])
        win.attempted += n
        with cell.span("bench.call"):
            files = _call(cell, images)
        with cell.span("bench.return"):
            for j, (i, data) in enumerate(zip(index, files)):
                if data:
                    cell.returned(win, j, i, data)
        k += 1
    win.t_end = time.perf_counter()
    return win
