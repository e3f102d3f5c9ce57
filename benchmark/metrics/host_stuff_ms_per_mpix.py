"""Self time of the host's byte stuffing (span io.stuff) in the traced
window, in ms per megapixel."""
from benchmark.program_spans import read_ms_per_mpix


def read(run):
    return read_ms_per_mpix(run, ("io.stuff",))
