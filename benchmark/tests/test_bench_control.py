"""The comparison that decides `correct` fails what it has to fail.

The control: the reference itself in the program's place, its DCT in
bfloat16, the precision below the configuration's float32; the limits of
each configuration have to reject it. The faults: whole runs on the port's
CPU path, with the timed path's answers altered where they are produced
(every one, or only the first or the last of each call), some of them
left out, or handed to the wrong images, have to come out not correct,
while the same runs unbroken come out correct."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

import jpegtpu_torch
from conftest import REPO

from benchmark import check
from benchmark.content import make_pool
from benchmark.manifest import Bench
from benchmark.reference import encoder
from benchmark.run import run_cell

CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]
CONFIGS = sorted({w["config"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]})


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_fails_the_limits(config):
    """At a tenth of each size (a quarter for the smallest), the bfloat16
    control fails and the port's CPU path passes."""
    bench = Bench(REPO)
    cfg = bench.config(config)
    sizes = [{**s, "height": max(s["height"] // 10, 128),
              "width": max(s["width"] // 10, 128)} for s in cfg["sizes"]]
    pool = make_pool(sizes, 4, 2**31 + 3, "cpu")
    sample = [(i, encoder.encode(pool[i], cfg["encode"], "bfloat16").file)
              for i in range(len(pool))]
    counts = check.compare_sample(encoder, cfg["encode"], pool, sample,
                                  cfg["check_budget"])
    ok, table = check.judge(check.numbers(counts, 0), bench.limits(config))
    assert not ok, table
    sound = [(i, jpegtpu_torch.encode_color(
        pool[i], jpegtpu_torch.EncodeConfig(**cfg["encode"]), device="cpu"))
        for i in range(len(pool))]
    counts = check.compare_sample(encoder, cfg["encode"], pool, sound,
                                  cfg["check_budget"])
    ok, table = check.judge(check.numbers(counts, 0), bench.limits(config))
    assert ok, table


def _alter(data: bytes) -> bytes:
    b = bytearray(data)
    b[len(b) * 2 // 3] ^= 0x5A  # inside the scan
    return bytes(b)


def _broken(monkeypatch, fault: str):
    batch = jpegtpu_torch.encode_color_batch

    def bad_batch(images, *args, **kw):
        files = batch(images, *args, **kw)
        if fault == "altered":
            return [_alter(f) for f in files]
        if fault == "first_altered":
            return [_alter(files[0])] + files[1:]
        if fault == "last_altered":
            return files[:-1] + [_alter(files[-1])]
        if fault == "half_missing":
            return [f if i % 2 else b"" for i, f in enumerate(files)]
        return files[1:] + files[:1]  # each answer given to another image

    monkeypatch.setattr(jpegtpu_torch, "encode_color_batch", bad_batch)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    result = run_cell(tiny, cell, 2**32 + 9, 0.2, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    traced = run_cell(tiny, cell, 2**32 + 9, 0.2, True, "cpu")
    assert traced["correct"]
    assert traced["metrics"] == {}  # the trace's readers need a card


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "first_altered",
                                   "last_altered", "half_missing",
                                   "swapped"])
def test_a_broken_run_is_not_correct(tiny, monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    result = run_cell(tiny, cell, 2**32 + 9, 0.2, False, "cpu")
    assert not result["correct"], result["checks"]


def test_the_window_bounds_its_work(tiny):
    result = run_cell(tiny, CELLS[0], 4, 0.2, False, "cpu")
    assert result["metrics"]["throughput_mpix_s"]["value"] > 0
    assert result["metrics"]["setup_s"]["value"] > 0
    assert np.isfinite(result["metrics"]["throughput_mpix_s"]["value"])
