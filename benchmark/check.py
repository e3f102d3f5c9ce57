"""The comparison that decides `correct`.

Once the window has closed, a sample of the files it returned, drawn from
the seed, is compared with the plain reference's encode of the same pool
images (reference/compare.py). The numbers compared, each with its limit
from `limits/<config>.json`:

  missing         images handed to the program whose file never came
  header          sampled files whose bytes outside the scan differ
  scan_faults     sampled files whose scan does not decode as stated
                  (stuffing, markers, MCU count, padding, EOI)
  cut_short       sampled files with more MCUs differing than the
                  comparison decodes
  off_by_more     levels more than 1 away from the reference's
  off_by_one_ppm  levels 1 away, per million levels compared: float32
                  against float64 rounding of coefficients that lie
                  within rounding of a half-step
"""
from __future__ import annotations

from benchmark.reference.compare import Counts, compare

NUMBERS = ("missing", "header", "scan_faults", "cut_short", "off_by_more",
           "off_by_one_ppm")


def compare_sample(reference, spec: dict, pool, sample, budget: int
                   ) -> Counts:
    """Compare each (pool index, file) of `sample` with the reference's
    encode of that pool image, made once per image."""
    refs, total = {}, Counts()
    for index, data in sample:
        if index not in refs:
            refs[index] = reference.encode(pool[index], spec)
        total.add(compare(data, refs[index], budget))
    return total


def numbers(counts: Counts, missing: int) -> dict:
    return {
        "missing": missing,
        "header": counts.header_mismatch,
        "scan_faults": counts.scan_faults,
        "cut_short": counts.cut_short,
        "off_by_more": counts.off_by_more,
        "off_by_one_ppm": (1e6 * counts.off_by_one / counts.coefficients
                           if counts.coefficients else 0.0),
    }


def judge(values: dict, limits: dict) -> tuple:
    """(every number within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in table.values()), table
