"""Self time of the host's edge pads and np.stack of the images
(spans io.pad, io.stack) in the traced window, in ms per megapixel."""
from benchmark.program_spans import read_ms_per_mpix


def read(run):
    return read_ms_per_mpix(run, ("io.pad", "io.stack"))
