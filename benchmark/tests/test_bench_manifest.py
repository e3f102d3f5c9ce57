"""BENCHMARK.json resolves by name, keeps to its contract's form, and takes
a new configuration, traffic mix and metric as files alone."""
from __future__ import annotations

import filecmp
import json
import os
import re

import pytest

from conftest import REPO, tiny_root

from benchmark.manifest import Bench
from benchmark.run import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_resolves(cell):
    bench = Bench(REPO)
    spec = bench.cell(cell)
    cfg = bench.config(spec["config"])
    assert cfg["name"] == spec["config"]
    mix = bench.traffic(spec["traffic"])
    driver = bench.driver(mix["driver"])
    assert callable(driver.warm) and callable(driver.window)
    ref = bench.reference(cfg["reference"])
    ref.check_spec(cfg["encode"])
    assert set(bench.limits(spec["config"])) >= {
        "missing", "header", "scan_faults", "cut_short", "off_by_more",
        "off_by_one_ppm"}
    for trace in (False, True):
        metrics = bench.metrics(cell, trace)
        assert metrics
        for m in metrics:
            assert callable(bench.reader(m["name"]).read)
    names = {m["name"] for m in bench.metrics(cell, False)}
    assert {"setup_s", "throughput_mpix_s"} <= names


def test_manifest_form():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    assert m["paths"] == ["benchmark"]
    files = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and UNIT.match(e["unit"])
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert p["moves"] in e2e and UNIT.match(p["unit"])
        assert set(p.get("workloads", cells)) <= cells
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(m)) < 64 << 10


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tiny_root(str(tmp_path))
    bench_dir = os.path.join(root, "benchmark")
    before = {os.path.relpath(os.path.join(d, f), bench_dir)
              for d, _, fs in os.walk(bench_dir) for f in fs}
    with open(os.path.join(bench_dir, "configs", "photo_420_12mp.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "q75_tiny"
    cfg["encode"]["quality"] = 75
    with open(os.path.join(bench_dir, "configs", "q75_tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "limits", "q75_tiny.json"), "w") as f:
        json.dump({"missing": 0, "header": 0, "scan_faults": 0,
                   "cut_short": 0, "off_by_more": 0, "off_by_one_ppm": 100},
                  f)
    with open(os.path.join(bench_dir, "traffic", "pairs.json"), "w") as f:
        json.dump({"driver": "batch", "images_per_call": 2}, f)
    with open(os.path.join(bench_dir, "metrics", "files_per_call.py"),
              "w") as f:
        f.write("def read(run):\n    return run.window.returned / 2\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        m = json.load(f)
    m["workloads"].append({"name": "q75_tiny.pairs", "config": "q75_tiny",
                           "traffic": "pairs", "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "files_per_call", "unit": "files",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["q75_tiny.pairs"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    for rel in before:
        assert filecmp.cmp(os.path.join(REPO, "benchmark", rel),
                           os.path.join(bench_dir, rel), shallow=False) or (
            rel.startswith(("configs", "traffic")))  # cut to test size
    result = run_cell(Bench(root), "q75_tiny.pairs", 5, 0.2, False, "cpu")
    assert result["correct"]
    assert result["metrics"]["files_per_call"]["value"] >= 1
    assert set(result["metrics"]) == {"throughput_mpix_s", "setup_s",
                                      "files_per_call"}
