"""Summed device time of the host-to-device copies in the traced window,
in ms per megapixel encoded."""


def read(run):
    if run.trace is None or not run.window.pixels or run.trace.h2d_s <= 0:
        return None
    return 1e3 * run.trace.h2d_s / (run.window.pixels / 1e6)
