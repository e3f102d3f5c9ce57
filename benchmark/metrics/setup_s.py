"""Seconds from process start to the window: imports, the CUDA context,
loading (or, in a fresh checkout, building) the kernels, making the pool
on the card and warming the cell's entry at its size."""


def read(run):
    return run.setup_s
