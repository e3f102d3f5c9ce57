"""jpegtpu_torch's color encode on the CPU (the kernels' plain versions)
against jpegtpu's encode of the same image and config.

One case holds the port against jpegtpu's device color chain (its Pallas
kernels in interpret mode); the rest use jpegtpu's host entropy coder,
which jpegtpu's own on-chip parity test pins to the same bytes as its
device chain, to keep the suite's compile time down."""
import functools

import numpy as np
import pytest

import jpegtpu
from jpegtpu import color_pipeline as jcp
from jpegtpu.io import bmp as jbmp

import jpegtpu_torch
from jpegtpu_torch import color_pipeline, pipeline
from jpegtpu_torch.ops import blocks

MODES = ["420", "422", "444"]


def _rgb(h, w, seed=0):
    """Photographic-complexity color content: a gradient, texture and
    noise per channel, each channel different."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [
        (xx * (1.3 + c) + yy * (0.7 + 0.4 * c)) % 256
        + 25 * np.sin(xx / (2.9 + c)) * np.cos(yy / 3.3)
        + rng.normal(0, 10, (h, w))
        for c in range(3)
    ]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def _noise(h, w, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


CASES = {
    "q50": (lambda: _rgb(48, 64, seed=50), {}),
    "q85": (lambda: _rgb(48, 64, seed=85), {"quality": 85}),
    "int32": (lambda: _rgb(48, 80, seed=21), {"dct_dtype": "int32"}),
    "ortho_basis": (lambda: _rgb(32, 64, seed=22), {"bitexact": False}),
    "pad_zeros": (lambda: _rgb(40, 48, seed=23), {"pad_ones": False}),
    "odd_dims": (lambda: _rgb(61, 93, seed=3), {}),
    "gray_promoted": (lambda: _rgb(45, 70, seed=4)[..., 1], {}),
}


@functools.lru_cache(maxsize=None)
def _jpegtpu_bytes(ss, name):
    make, kw = CASES[name]
    return jcp.encode_color(
        make(), jpegtpu.EncodeConfig(subsampling=ss, entropy="host", **kw))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("ss", MODES)
@pytest.mark.parametrize("entropy", ["device", "host"])
def test_bytes_match_jpegtpu(name, ss, entropy):
    make, kw = CASES[name]
    cfg = jpegtpu_torch.EncodeConfig(subsampling=ss, entropy=entropy, **kw)
    got = jpegtpu_torch.encode_color(make(), cfg, device="cpu")
    assert got == _jpegtpu_bytes(ss, name)


def test_default_config_matches_jpegtpu_device_path():
    """The one comparison with jpegtpu's device chain (K2, K3, K4, K5, K8,
    K9 in interpret mode) at jpegtpu's default color config, 4:2:0."""
    img = _rgb(48, 64, seed=7)
    assert jpegtpu_torch.encode_color(img, device="cpu") == (
        jcp.encode_color(img))


@pytest.mark.parametrize("ss", MODES)
def test_ladder_climbs_to_the_top_rung(ss):
    """Q100 noise overflows caps 8 and 16; the bytes at cap 53 match."""
    img = _noise(48, 64, seed=6)
    cfg = jpegtpu_torch.EncodeConfig(quality=100, dct_dtype="int32",
                                     subsampling=ss)
    key = (48, 64, cfg, "color")
    pipeline._cap_history.pop(key, None)
    assert pipeline.capacity_ladder(cfg, key) == (8, 16, 53)
    got = jpegtpu_torch.encode_color(img, cfg, device="cpu")
    assert pipeline._cap_history[key][0] == 53
    assert got == jcp.encode_color(img, jpegtpu.EncodeConfig(
        quality=100, dct_dtype="int32", subsampling=ss, entropy="host"))


@pytest.mark.parametrize("ss", MODES)
@pytest.mark.parametrize("dct_dtype", ["float32", "int32"])
def test_coefficients_match_jpegtpu(ss, dct_dtype):
    img = _rgb(61, 93, seed=8)
    got = jpegtpu_torch.color_coefficients(
        img, jpegtpu_torch.EncodeConfig(subsampling=ss, dct_dtype=dct_dtype),
        device="cpu")
    want = jcp.color_coefficients(
        img, jpegtpu.EncodeConfig(subsampling=ss, dct_dtype=dct_dtype))
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ss", MODES)
@pytest.mark.parametrize("shape", [(16, 16), (48, 80), (64, 96)])
def test_scan_layout_matches_jpegtpu(ss, shape):
    got = color_pipeline._scan_layout(*shape, ss)
    want = jcp._scan_layout(*shape, ss)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert blocks.slots_per_mcu(ss) == jcp.slots_per_mcu(ss)


@pytest.mark.parametrize("ss", MODES)
def test_encode_file(tmp_path, ss):
    src = tmp_path / "in.bmp"
    jbmp.write(str(src), _rgb(50, 70, seed=9))
    n = jpegtpu_torch.encode_file(
        str(src), str(tmp_path / "port.jpg"),
        jpegtpu_torch.EncodeConfig(subsampling=ss), device="cpu")
    m = jpegtpu.encode_file(str(src), str(tmp_path / "ref.jpg"),
                            jpegtpu.EncodeConfig(subsampling=ss,
                                                 entropy="host"))
    assert n == m
    assert (tmp_path / "port.jpg").read_bytes() == (
        tmp_path / "ref.jpg").read_bytes()


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(pipeline.torch.cuda, "is_available", lambda: False)
    img = _rgb(16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.encode_color(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.color_coefficients(img)


def test_gray_and_color_entry_points_refuse_each_others_configs():
    img = _rgb(16, 16)
    with pytest.raises(ValueError, match="encode_color"):
        jpegtpu_torch.encode_grayscale(
            img, jpegtpu_torch.EncodeConfig(subsampling="420"), device="cpu")
    with pytest.raises(ValueError, match="encode_grayscale"):
        jpegtpu_torch.encode_color(img, jpegtpu_torch.EncodeConfig(),
                                   device="cpu")
    with pytest.raises(ValueError):
        jpegtpu_torch.encode_color(np.zeros((8, 8, 4), np.uint8),
                                   device="cpu")
