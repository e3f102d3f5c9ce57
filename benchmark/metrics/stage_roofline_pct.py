"""K13 (stage_images) against its byte roofline: the least bytes it
moves, each input pixel byte read once and each written once, over the
card's published memory bandwidth (peaks.json), as a share of K13's
summed device time in the traced window. None where the trace holds no
K13 entry among its top device ops."""

KERNEL = "stage_images_kernel"
CHANNELS = 3  # the cells that list this metric stage RGB frames


def least_bytes(pixels: int, channels: int = CHANNELS) -> int:
    """Each input pixel byte read once and written once."""
    return 2 * channels * pixels


def read(run):
    bw = run.peaks.get("hbm_bytes_per_s")
    if run.trace is None or not bw or not run.window.pixels:
        return None
    seconds = sum(s for name, s in run.trace.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    return 100.0 * (least_bytes(run.window.pixels) / bw) / seconds
