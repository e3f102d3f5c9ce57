"""Self time of the host staging images that are already on the card
(span io.on_card: K13's table and launch) in the traced window, in ms per
megapixel; None where the program records no such span."""
from benchmark.program_spans import read_ms_per_mpix, recorded


def read(run):
    t = recorded(run)
    if t is None or "io.on_card" not in t["spans"]:
        return None
    return read_ms_per_mpix(run, ("io.on_card",))
