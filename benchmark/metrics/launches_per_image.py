"""CUDA kernels launched in the traced window per image encoded."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.window.returned:
        return None
    return run.trace.kernels / run.window.returned
