"""The readings that a configuration's limits are set from, in one process
on the card:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 2

For each of `--seeds`, one run of the cell as the benchmark makes it (a
short window at the cell's own size and load): the program's reading of
each number compared. For each of `--control-seeds`, the control: the
reference put in the program's place with its DCT in bfloat16, on as
many of that seed's pool images as a run compares. One JSON line each;
the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time


def control_reading(bench, workload: str, seed: int) -> dict:
    from benchmark import check, content
    cfg = bench.config(bench.cell(workload)["config"])
    reference = bench.reference(cfg["reference"])
    pool = content.make_pool(cfg["sizes"], cfg["pool_images"], seed, "cuda")
    picks = random.Random(seed).sample(range(len(pool)), cfg["check_files"])
    sample = [(i, reference.encode(pool[i], cfg["encode"], "bfloat16").file)
              for i in picks]
    counts = check.compare_sample(reference, cfg["encode"], pool, sample,
                                  cfg["check_budget"])
    return check.numbers(counts, 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from benchmark.manifest import Bench
    from benchmark.run import run_cell
    bench = Bench()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        r = run_cell(bench, args.workload, seed, args.seconds, False)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": r["correct"],
                          "values": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in controls:
        t = time.perf_counter()
        print(json.dumps({"side": "control", "seed": seed,
                          "values": control_reading(bench, args.workload,
                                                    seed),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
