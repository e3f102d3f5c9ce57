"""The encode's least bytes (each input pixel byte read once, each scan
byte written once: stats.least_bytes) over the card's published memory
bandwidth (peaks.json), as a share of the kernels' summed device time."""


def read(run):
    bw = run.peaks.get("hbm_bytes_per_s")
    if run.trace is None or not bw or run.trace.kernel_s <= 0:
        return None
    return 100.0 * (run.least_bytes / bw) / run.trace.kernel_s
