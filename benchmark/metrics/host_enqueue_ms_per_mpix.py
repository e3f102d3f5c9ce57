"""Self time of the host queueing the card's work (spans orch.front,
orch.entropy, orch.tables, kernel.launch: the transform, each rung's
entropy chain, the tables and the launches of the hand-written kernels)
in the traced window, in ms per megapixel."""
from benchmark.program_spans import read_ms_per_mpix


def read(run):
    return read_ms_per_mpix(run, ("orch.front", "orch.entropy",
                                  "orch.tables", "kernel.launch"))
