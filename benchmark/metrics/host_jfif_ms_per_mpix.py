"""Self time of the host's JFIF assembly (span io.jfif) in the traced
window, in ms per megapixel."""
from benchmark.program_spans import read_ms_per_mpix


def read(run):
    return read_ms_per_mpix(run, ("io.jfif",))
