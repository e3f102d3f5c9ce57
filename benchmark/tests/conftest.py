"""A copy of the benchmark at CPU-test size: the same files, with each
configuration's image sizes cut by 40 (odd sizes stay odd), its pool to 5
images and each batch to 3 images a call, so that whole runs finish in
seconds on the port's CPU path."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def tiny_sizes(sizes: list) -> list:
    return [{**s, "height": s["height"] // 40, "width": s["width"] // 40}
            for s in sizes]


def tiny_root(dest: str) -> str:
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    bench = os.path.join(dest, "benchmark")
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(sizes=tiny_sizes(cfg["sizes"]), pool_images=5,
                   check_files=4)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as f:
            mix = json.load(f)
        if "images_per_call" in mix:
            mix["images_per_call"] = 3
            with open(path, "w") as f:
                json.dump(mix, f)
    return dest


@pytest.fixture
def tiny(tmp_path):
    from benchmark.manifest import Bench
    return Bench(tiny_root(str(tmp_path)))
