"""Sharded encode (jpegtpu_torch.parallel, color_pipeline.
encode_color_sharded) and the batch mesh, on the CPU: the geometry rules
against jpegtpu's (numpy only); int32 files equal to jpegtpu's host
restart coder at the shards' interval; one gray and one 4:2:0 file equal
to jpegtpu's sharded encodes on a mesh of two virtual CPU devices (its
interpret-mode chains); 2-pass and its fallback past rung 16; a batch
mesh equal to no mesh; and two processes over gloo equal to one. Bytes
are compared exactly."""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import jpegtpu
from jpegtpu import color_pipeline as jcolor
from jpegtpu import pipeline as jpipeline
from jpegtpu.parallel import sharding as jsharding

from jpegtpu_torch import EncodeConfig, batch, color_pipeline
from jpegtpu_torch.parallel import multihost, sharding

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")
WORKER = pathlib.Path(__file__).parent / "torch_multiproc_worker.py"
# shard geometries: one segment a shard, past DRI's 16-bit interval, prime
# rows, awkward widths
GEOMETRIES = [(10, 10), (256, 512), (8191, 17), (7919, 7907), (8192, 8191),
              (6151, 31), (1, 8191), (65537, 1), (101, 1000), (95, 504)]


def _photo(h, w, seed, rgb=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9)
    chans = [np.clip(base + k * 9 + rng.normal(0, 10, (h, w)), 0, 255)
             for k in range(3 if rgb else 1)]
    return (np.stack(chans, -1) if rgb else chans[0]).astype(np.uint8)


def _host_restart(image, cfg, interval, color=False):
    """jpegtpu's numpy host coder at a restart interval."""
    hcfg = jpegtpu.EncodeConfig(subsampling=cfg.subsampling,
                                dct_dtype=cfg.dct_dtype, entropy="host",
                                restart_interval=interval,
                                optimize_huffman=cfg.optimize_huffman)
    if color:
        return jcolor.encode_color(image, hcfg)
    return jpipeline.encode_grayscale(image, hcfg)


@pytest.mark.parametrize("rows,mpr", GEOMETRIES)
def test_restart_subsegments_and_padding_match_jpegtpu(rows, mpr):
    r = sharding.restart_subsegments(rows, mpr)
    assert r == jsharding.restart_subsegments(rows, mpr)
    assert r <= 0xFFFF and rows * mpr % r == 0
    for n in (1, 2, 3, 8):
        h, w = rows * 8 - 3, mpr * 8 - 5
        assert sharding.shard_padded_dims(h, w, n) == \
            jsharding.shard_padded_dims(h, w, n)


@pytest.mark.parametrize("ph,pw,n", [(64, 64, 2), (2048, 4096, 2),
                                     (16384, 8192, 4), (4096, 65536, 2)])
def test_stitch_plans_match_jpegtpu(ph, pw, n):
    for cap in (8, 16, 53):
        assert sharding.sharded_stitch_plan(ph, pw, n, cap) == \
            jsharding.sharded_stitch_plan(ph, pw, n, cap)
        for ss in ("420", "422", "444"):
            jcfg = jpegtpu.EncodeConfig(subsampling=ss)
            assert color_pipeline.sharded_color_stitch_plan(
                ph, pw, EncodeConfig(subsampling=ss), n, cap) == \
                jcolor.sharded_color_stitch_plan(ph, pw, jcfg, n, cap)


@pytest.mark.parametrize("n", [2, 8])
def test_gray_sharded_int32_equals_host_restart_coder(n):
    img = _photo(8 * n * 2, 72, 11)
    cfg = EncodeConfig(dct_dtype="int32")
    got = sharding.encode_grayscale_sharded(img, cfg, mesh=["cpu"] * n)
    want = _host_restart(img, cfg, (16 // 8) * 9)
    assert got == want


@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_sharded_int32_equals_host_restart_coder(ss):
    n = 2
    mh = 16 if ss == "420" else 8
    img = _photo(mh * n * 2, 48, 12, rgb=True)
    cfg = EncodeConfig(subsampling=ss, dct_dtype="int32")
    got = color_pipeline.encode_color_sharded(img, cfg, mesh=["cpu"] * n)
    mw = 8 if ss == "444" else 16
    assert got == _host_restart(img, cfg, 2 * 48 // mw, color=True)


@pytest.mark.parametrize("ss,n", [("420", 3), ("444", 4)])
def test_color_sharded_pads_the_last_bands_as_np_pad(ss, n):
    """Awkward dims: only the bands past the image are edge-padded, on
    the host; the scan equals the single-image restart encode of the
    whole image padded by np.pad (frame dims aside)."""
    img = _photo(37, 29, 13, rgb=True)
    cfg = EncodeConfig(subsampling=ss, dct_dtype="int32")
    got = color_pipeline.encode_color_sharded(img, cfg, mesh=["cpu"] * n)
    mh, mw = (16, 16) if ss == "420" else (8, 8)
    ph, pw = -(-37 // (mh * n)) * mh * n, -(-29 // mw) * mw
    padded = np.pad(img, [(0, ph - 37), (0, pw - 29), (0, 0)], mode="edge")
    want = color_pipeline.encode_color(padded, EncodeConfig(
        subsampling=ss, dct_dtype="int32",
        restart_interval=ph // n // mh * pw // mw), **CPU)
    assert got[got.index(b"\xff\xda"):] == want[want.index(b"\xff\xda"):]


def test_gray_sharded_equals_jpegtpu_sharded():
    """Awkward dims (padding, orig dims in the header), float mode."""
    img = _photo(13, 24, 21)
    got = sharding.encode_grayscale_sharded(img, EncodeConfig(),
                                            mesh=["cpu"] * 2)
    want = jsharding.encode_grayscale_sharded(
        img, jpegtpu.EncodeConfig(), mesh=jsharding.make_mesh(2))
    assert got == want


def test_color_sharded_equals_jpegtpu_sharded():
    img = _photo(32, 16, 22, rgb=True)
    got = color_pipeline.encode_color_sharded(
        img, EncodeConfig(subsampling="420"), mesh=["cpu"] * 2)
    want = jcolor.encode_color_sharded(
        img, jpegtpu.EncodeConfig(subsampling="420"),
        mesh=jsharding.make_mesh(2))
    assert got == want


def test_gray_and_color_2pass_equal_host_2pass_restart():
    """Counts summed over the shards: the host coder's 2-pass tables at
    the shards' interval (floored as every 2-pass path floors them)."""
    img = _photo(64, 40, 31)
    cfg = EncodeConfig(dct_dtype="int32", optimize_huffman=True)
    got = sharding.encode_grayscale_sharded(img, cfg, mesh=["cpu"] * 4)
    assert got == _host_restart(img, cfg, 2 * 5)
    rgb = _photo(64, 32, 32, rgb=True)
    ccfg = EncodeConfig(subsampling="420", dct_dtype="int32",
                        optimize_huffman=True)
    got = color_pipeline.encode_color_sharded(rgb, ccfg, mesh=["cpu"] * 2)
    assert got == _host_restart(rgb, ccfg, 2 * 2, color=True)


def test_2pass_pathological_drops_its_tables_past_rung_16():
    """Q100 noise overflows rung 16: jpegtpu's sharded 2-pass drops the
    optimal tables there, so the file is the standard-table one."""
    img = np.random.default_rng(7).integers(0, 256, (64, 64), np.uint8)
    got = sharding.encode_grayscale_sharded(
        img, EncodeConfig(quality=100, optimize_huffman=True),
        mesh=["cpu"] * 8)
    assert got == sharding.encode_grayscale_sharded(
        img, EncodeConfig(quality=100), mesh=["cpu"] * 8)
    rgb = np.random.default_rng(8).integers(0, 256, (32, 32, 3), np.uint8)
    got = color_pipeline.encode_color_sharded(
        rgb, EncodeConfig(subsampling="420", quality=100,
                          optimize_huffman=True), mesh=["cpu"] * 2)
    assert got == color_pipeline.encode_color_sharded(
        rgb, EncodeConfig(subsampling="420", quality=100), mesh=["cpu"] * 2)


def test_ladder_starts_at_the_first_rung_on_every_call(monkeypatch):
    """No site history: a second call after an overflow starts at 8."""
    img = np.random.default_rng(9).integers(0, 256, (32, 32), np.uint8)
    caps = []
    real = sharding.encode_blocks

    def spy(levels, dcd, huff, cap):
        caps.append(cap)
        return real(levels, dcd, huff, cap)

    monkeypatch.setattr(sharding, "encode_blocks", spy)
    cfg = EncodeConfig(quality=100)
    first = sharding.encode_grayscale_sharded(img, cfg, mesh=["cpu"] * 2)
    assert caps[0] == 8 and caps[-1] > 8
    caps.clear()
    assert sharding.encode_grayscale_sharded(img, cfg,
                                             mesh=["cpu"] * 2) == first
    assert caps[0] == 8


def test_mesh_helpers():
    assert sharding.make_mesh(3, devices=["cpu"] * 4) == [
        sharding.resolve_device("cpu")] * 3
    assert multihost.process_count() == 1 and multihost.is_coordinator()
    assert multihost.local_shard_indices(["cpu"] * 4) == [0, 1, 2, 3]
    multihost.initialize()  # no rendezvous configured: a no-op
    assert multihost.process_count() == 1
    with pytest.raises(ValueError):
        sharding.make_mesh(5, devices=["cpu"] * 4)


@pytest.mark.parametrize("cfg", [
    EncodeConfig(dct_dtype="int32"), EncodeConfig(optimize_huffman=True),
    EncodeConfig(subsampling="420"),
    EncodeConfig(subsampling="420", optimize_huffman=True),
], ids=["gray", "gray_2pass", "420", "420_2pass"])
def test_batch_mesh_equals_no_mesh(cfg):
    """Shares of 5 images on a mesh of 2 (jpegtpu's bucket of 8 over 2 x
    r = 16 slots: all on the first device for 16-block rows) and of 3."""
    images = [_photo(24, 40, s, rgb=s % 2 == 1) for s in range(5)] + [
        _photo(16, 1100, 9)]
    enc = (batch.encode_color_batch if cfg.n_components == 3
           else batch.encode_grayscale_batch)
    want = enc(images, cfg, **CPU)
    assert enc(images, cfg, mesh=["cpu"] * 2) == want
    assert enc(images, cfg, mesh=["cpu"] * 3) == want


def test_batch_mesh_shares():
    """jpegtpu's split: the bucket padded to r * mesh size."""
    devs = ["a", "b"]
    # rows of 5 blocks: r = 8 images a slot row; 5 -> bucket 8 -> 16 -> 8 each
    assert batch._shares(5, devs, 5) == [("a", 0, 5)]
    # rows of 128 blocks: r = 1; 5 -> bucket 8 -> 4 each
    assert batch._shares(5, devs, 128) == [("a", 0, 4), ("b", 4, 5)]
    assert batch._shares(3, ["a"], 128) == [("a", 0, 3)]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_equal_one(tmp_path):
    """Two gloo processes, one shard each, on the per-segment route
    (K8 + K11; 4:2:0 through K6's slot-major merge): every process
    returns the single-process sharded file."""
    port = _free_port()
    out = tmp_path / "mp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(port), str(r), "2", str(out),
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log[-4000:]
    sys.path.insert(0, str(WORKER.parent))
    import torch_multiproc_worker as worker

    gray, rgb = worker.image()
    mesh = ["cpu"] * 2
    want = {
        "gray": sharding.encode_grayscale_sharded(
            gray, EncodeConfig(dct_dtype="int32"), mesh=mesh),
        "grayopt": sharding.encode_grayscale_sharded(
            gray, EncodeConfig(dct_dtype="int32", optimize_huffman=True),
            mesh=mesh),
        "color": color_pipeline.encode_color_sharded(
            rgb, EncodeConfig(subsampling="420", dct_dtype="int32"),
            mesh=mesh),
    }
    for name, data in want.items():
        for r in (0, 1):
            assert (tmp_path / f"mp.{name}.p{r}").read_bytes() == data, name
    assert want["gray"] == _host_restart(gray, EncodeConfig(
        dct_dtype="int32"), 8 * 8)
