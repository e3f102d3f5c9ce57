"""Self time of the host blocked on the card (span orch.wait: the head's
readback, event waits) in the traced window, in ms per megapixel."""
from benchmark.program_spans import read_ms_per_mpix


def read(run):
    return read_ms_per_mpix(run, ("orch.wait",))
