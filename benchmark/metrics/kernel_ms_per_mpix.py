"""Summed device time of every CUDA kernel in the traced window (the
port's kernels and PyTorch's alike), in ms per megapixel encoded."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.window.pixels:
        return None
    return 1e3 * run.trace.kernel_s / (run.window.pixels / 1e6)
