"""The command line (jpegtpu_torch.cli) and the stage profile
(jpegtpu_torch.profiling) on the CPU (`--device cpu`, device="cpu"):
`encode` files byte-equal to jpegtpu's CLI with the same flags (its side
with host entropy, which gives the same bytes in a fraction of its
interpret-mode time), `--sharded` equal to the sharded entry points,
`encode-dir` files equal to single encodes (batch and --pipeline),
`profile` in jpegtpu's report layout, `analyze` and `analyze-dir` text
equal to jpegtpu's; the profile's rows, cumulative totals and file equal
to the entry point's, and its refusals. Images are seeded and written as
BMPs into tmp_path."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jpegtpu import cli as jcli
from jpegtpu import profiling as jprofiling

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, cli, color_pipeline, profiling
from jpegtpu_torch.entropy import concat
from jpegtpu_torch.io import bmp
from jpegtpu_torch.parallel import sharding

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
GRAY_ROWS = ["pad+h2d+K1", "dc diff", "K4 pack", "K8+K9 concat",
             "read+stuff(host)", "jfif(host)"]
COLOR_ROWS = ["pad+h2d+K2+K3", "dc diff", "K4x2+K5 merge", "K8+K9 concat",
              "read+stuff(host)", "jfif(host)"]


def _rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 2.3 + yy * 1.1) % 256)[..., None]
    return np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "img.bmp")
    bmp.write(path, _rgb(40, 56, 1))
    return path


@pytest.mark.parametrize("flags", [
    [],
    ["--subsampling", "420"],
    ["--quality", "90"],
    ["--restart-interval", "3"],
    ["--subsampling", "420", "--restart-interval", "2", "--quality", "20"],
], ids=["gray", "420", "q90", "restart", "420_restart_q20"])
def test_encode_equals_jpegtpu_cli(tmp_path, src, flags):
    got, want = str(tmp_path / "port.jpg"), str(tmp_path / "ref.jpg")
    assert cli.main(["encode", src, got, *flags, "--device", "cpu"]) == 0
    assert jcli.main(["encode", src, want, *flags, "--entropy", "host"]) == 0
    assert Path(got).read_bytes() == Path(want).read_bytes()


@pytest.mark.parametrize("flags", [
    ["--entropy", "host"], ["--optimize-huffman"], ["--stats"],
], ids=["host_entropy", "two_pass", "stats"])
def test_encode_flags_equal_the_entry_point(tmp_path, src, flags, capsys):
    out = str(tmp_path / "o.jpg")
    assert cli.main(["encode", src, out, *flags, "--device", "cpu"]) == 0
    cfg = EncodeConfig(optimize_huffman="--optimize-huffman" in flags)
    assert Path(out).read_bytes() == jpegtpu_torch.encode_grayscale(
        bmp.read(src), cfg, **CPU)
    assert ("MPix/s" in capsys.readouterr().err) == ("--stats" in flags)


@pytest.mark.parametrize("ss", ["gray", "420"])
def test_encode_sharded_on_the_one_cpu_device(tmp_path, src, ss):
    out = str(tmp_path / "o.jpg")
    assert cli.main(["encode", src, out, "--subsampling", ss, "--sharded",
                     "--device", "cpu"]) == 0
    img, cfg = bmp.read(src), EncodeConfig(subsampling=ss)
    enc = (sharding.encode_grayscale_sharded if ss == "gray"
           else color_pipeline.encode_color_sharded)
    assert Path(out).read_bytes() == enc(img, cfg, mesh=["cpu"])


@pytest.mark.parametrize("flags", [[], ["--pipeline", "2"]],
                         ids=["batch", "pipeline2"])
@pytest.mark.parametrize("ss", ["gray", "420"])
def test_encode_dir_files_equal_single_encodes(tmp_path, flags, ss):
    ind, outd = tmp_path / "in", tmp_path / "out"
    ind.mkdir()
    images = {f"im{i}": _rgb(h, w, 10 + i) for i, (h, w) in
              enumerate([(24, 32), (24, 32), (17, 40), (24, 32)])}
    for stem, im in images.items():
        bmp.write(str(ind / f"{stem}.bmp"), im)
    assert cli.main(["encode-dir", str(ind), str(outd), "--subsampling", ss,
                     *flags, "--device", "cpu"]) == 0
    cfg = EncodeConfig(subsampling=ss)
    enc = (jpegtpu_torch.encode_grayscale if ss == "gray"
           else jpegtpu_torch.encode_color)
    for stem, im in images.items():
        assert (outd / f"{stem}.jpeg").read_bytes() == enc(im, cfg, **CPU)


def test_encode_dir_without_bmps_fails(tmp_path):
    assert cli.main(["encode-dir", str(tmp_path), str(tmp_path / "o"),
                     "--device", "cpu"]) == 1


@pytest.mark.parametrize("ss,rows", [("gray", GRAY_ROWS),
                                     ("420", COLOR_ROWS)])
def test_profile_prints_jpegtpu_layout(src, capsys, ss, rows):
    assert cli.main(["profile", src, "--subsampling", ss, "--reps", "1",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == jprofiling.format_report([], 40, 56).splitlines()
    assert [ln[:16].rstrip() for ln in lines[2:]] == rows
    assert all(len(ln) == 48 for ln in lines[1:])


def test_analyze_and_analyze_dir_print_jpegtpu_text(tmp_path, src, capsys):
    outd = tmp_path / "out"
    outd.mkdir()
    jpg = str(outd / "img.jpeg")
    assert cli.main(["encode", src, jpg, "--device", "cpu"]) == 0
    runs = []
    for main in (cli.main, jcli.main):
        assert main(["analyze", src, jpg]) == 0
        assert main(["analyze-dir", str(Path(src).parent), str(outd),
                     "-d", str(tmp_path / main.__module__)]) == 0
        runs.append(capsys.readouterr().out)
    assert runs[0] == runs[1] and "PSNR" in runs[0]
    assert os.path.getsize(tmp_path / "jpegtpu_torch.cli" / "img.png") > 1000
    assert cli.main(["analyze-dir", str(tmp_path), str(outd)]) == 1


@pytest.mark.parametrize("kind", ["gray", "rgb_gray", "420", "444",
                                  "device_stuffing", "q100_ladder"])
def test_profile_rows_totals_and_file(kind):
    img = _rgb(24, 40, 20)
    cfg = {"gray": EncodeConfig(), "rgb_gray": EncodeConfig(),
           "420": EncodeConfig(subsampling="420"),
           "444": EncodeConfig(subsampling="444", dct_dtype="int32"),
           "device_stuffing": EncodeConfig(stuff="device"),
           "q100_ladder": EncodeConfig(quality=100)}[kind]
    if kind == "gray":
        img = img[..., 0].copy()
    if kind == "q100_ladder":  # overflows rung 8: the warm-up climbs
        img = np.random.default_rng(21).integers(0, 256, (24, 40),
                                                 dtype=np.uint8)
    color = cfg.n_components == 3
    prof = (profiling.profile_encode_color if color
            else profiling.profile_encode)(img, cfg, reps=2, **CPU)
    rows = list(COLOR_ROWS if color else GRAY_ROWS)
    if kind == "device_stuffing":
        rows[3:5] = ["K8+K9+stuff", "read(host)"]
    assert [s.name for s in prof] == rows
    assert all(len(s.name) <= 16 and s.stage_ms >= 0 for s in prof)
    np.testing.assert_allclose([s.total_ms for s in prof],
                               np.cumsum([s.stage_ms for s in prof]))
    enc = (jpegtpu_torch.encode_color if color
           else jpegtpu_torch.encode_grayscale)
    assert prof.jfif == enc(img, cfg, **CPU)


def test_profile_past_the_resident_budget_names_k10(monkeypatch):
    monkeypatch.setattr(concat, "VMEM_BUDGET", 64 << 10)
    img = _rgb(64, 256, 30)[..., 1].copy()
    prof = profiling.profile_encode(img, reps=1, **CPU)
    assert prof[3].name == "K8+K10 concat"
    assert prof.jfif == jpegtpu_torch.encode_grayscale(img, **CPU)


@pytest.mark.parametrize("cfg", [
    EncodeConfig(restart_interval=4), EncodeConfig(optimize_huffman=True),
    EncodeConfig(entropy="host"),
], ids=["restart", "two_pass", "host_entropy"])
def test_profile_refuses_other_paths(cfg):
    with pytest.raises(ValueError):
        profiling.profile_encode(_rgb(16, 16, 2), cfg, **CPU)
    with pytest.raises(ValueError):
        profiling.profile_encode_color(
            _rgb(16, 16, 2), dataclasses.replace(cfg, subsampling="420"),
            **CPU)
    with pytest.raises(ValueError):
        profiling.profile_encode(_rgb(16, 16, 2), reps=0, **CPU)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError):
            profiling.profile_encode(_rgb(16, 16, 2))


def test_tooling_imports_without_pil_matplotlib_jax_or_jpegtpu():
    code = (
        "import sys\n"
        "for m in ('PIL', 'matplotlib'):\n"
        "    sys.modules[m] = None  # importing them now raises\n"
        "from jpegtpu_torch import analysis, cli, debug, profiling\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'jpegtpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    for sub in ("encode", "encode-dir", "profile", "analyze", "analyze-dir"):
        assert sub in out
