"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. Set-up makes
the cell's pool of images on the card from the seed, copies it to the
host once and warms the cell's entry at the cell's size; the window then
drives the entry for `--seconds`; untraced, the line holds the cell's
end-to-end metrics, traced (`torch.profiler` around the window) its
per-layer metrics and a breakdown. A sample of the files is then compared
with the plain reference (check.py). The last lines of standard error,
and the result's last key, give each number compared beside its limit.
"""
import time

T0 = time.perf_counter()  # set-up runs from here to the window

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "jpegtpu"}


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark may not load: JAX and the JAX package. jpegtpu_torch's
    top-level name is its own."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _keep_caches_in(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    nvcc builds already go to build/jpegtpu_torch/ there)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "build", "triton"))


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None) -> dict:
    """One run of a cell; returns the result line's object. device="cpu"
    runs the port's plain versions (the tests' route; no card metrics)."""
    import torch

    import jpegtpu_torch
    from benchmark import check, content, stats
    from benchmark import trace as tracing
    from benchmark.harness import Cell, Run, SlotSample

    t0 = time.perf_counter() if t0 is None else t0
    phases = {"imports_s": time.perf_counter() - t0}
    spec = bench.cell(workload)
    cfg = bench.config(spec["config"])
    mix = bench.traffic(spec["traffic"])
    driver = bench.driver(mix["driver"])
    reference = bench.reference(cfg["reference"])
    reference.check_spec(cfg["encode"])
    pool = content.make_pool(cfg["sizes"], cfg["pool_images"], seed, device)
    phases["pool_s"] = time.perf_counter() - t0 - phases["imports_s"]
    cell = Cell(config=cfg, traffic=mix,
                encode_config=jpegtpu_torch.EncodeConfig(**cfg["encode"]),
                pool=pool, device=device, seconds=seconds,
                sample=SlotSample(cfg["check_files"], seed), spans=trace)
    driver.warm(cell)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    phases["warm_s"] = setup_s - phases["imports_s"] - phases["pool_s"]
    print(f"setup phases {json.dumps(phases)}", file=sys.stderr)

    prof = tracing.profiler() if trace else None
    if prof is not None:
        t = time.perf_counter()
        prof.__enter__()
        cost = {"start_s": time.perf_counter() - t}
    with cell.span(tracing.WINDOW_SPAN):
        window = driver.window(cell)
    summary = None
    if prof is not None:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        cost["stop_s"] = time.perf_counter() - t
        t = time.perf_counter()
        summary = tracing.summarize(prof) if cuda else None
        cost["reduce_s"] = time.perf_counter() - t
        del prof
        print(f"trace cost {json.dumps(cost)}", file=sys.stderr)

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": spec["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if cuda else 0)}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s

    header = len(reference.headers(1, 1, cfg["encode"]))  # any size
    scan_bytes = window.out_bytes - window.returned * (header + 2)
    with open(os.path.join(bench.dir, "peaks.json")) as f:
        peaks = json.load(f)
    run = Run(setup_s=setup_s, window=window, trace=summary,
              least_bytes=stats.least_bytes(window.pixels, 3,
                                            scan_bytes),
              peaks=peaks.get(kind, {}))
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    counts = check.compare_sample(reference, cfg["encode"], pool,
                                  cell.sample.items, cfg["check_budget"])
    values = check.numbers(counts, window.attempted - window.returned)
    correct, checks = check.judge(values, bench.limits(spec["config"]))
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.attempted - window.returned,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.manifest import Bench
    bench = Bench()
    _keep_caches_in(bench.root)
    chips = bench.cell(args.workload)["chips"]
    import torch

    import jpegtpu_torch  # noqa: F401  (no result line without the program)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than the {chips} the cell asks for",
              file=sys.stderr)
        return 2
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "power_limit": power_limit()}), flush=True)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T0)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules the benchmark may not load are loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
