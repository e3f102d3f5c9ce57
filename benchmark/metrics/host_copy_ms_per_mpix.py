"""Self time of the host issuing or waiting for its copies to and from
the card (spans io.upload, io.readback) in the traced window, in ms per
megapixel."""
from benchmark.program_spans import read_ms_per_mpix


def read(run):
    return read_ms_per_mpix(run, ("io.upload", "io.readback"))
