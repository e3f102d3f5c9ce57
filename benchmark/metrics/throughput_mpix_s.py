"""Megapixels of every image whose file came back, over the time from the
window's first call to the end of the last call that began in it."""
from benchmark.stats import rate


def read(run):
    return rate(run.window.pixels / 1e6, run.window.seconds)
