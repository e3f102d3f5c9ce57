"""EncodeConfig values the port serves as jpegtpu does, on the CPU (the
kernels' plain versions), held against jpegtpu's host entropy coder,
which jpegtpu's own tests pin to its device chain:

- a first capacity rung past the longest block (53 words): the kernels
  run at 53 words (pipeline.kernel_cap) on every path, with the bytes of
  rung 8;
- dct_dtype: every name numpy parses; "int32" is the integer path and the
  rest the float32 path;
- stuff="device": stuffed on the device by the single-segment encodes,
  ignored by restart and batch encodes, as in jpegtpu."""
import dataclasses

import numpy as np
import pytest
import torch

import jpegtpu

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, batch, pipeline
from jpegtpu_torch.entropy import concat, device, pack
from jpegtpu_torch.entropy.device import MAX_WORDS_PER_BLOCK
from jpegtpu_torch.io import transfer

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")


def _photo(h, w, seed, rgb=False):
    """Photographic-complexity content (tests/test_tpu_parity.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    chans = [np.clip(base + k * 9 + rng.normal(0, 10, (h, w)), 0, 255)
             for k in range(3 if rgb else 1)]
    return np.stack(chans, -1).astype(np.uint8) if rgb else chans[0].astype(
        np.uint8)


def _jpegtpu_bytes(images, kw):
    """jpegtpu's host entropy coder on each image."""
    cfg = jpegtpu.EncodeConfig(entropy="host", **kw)
    encode = (jpegtpu.encode_grayscale if cfg.n_components == 1
              else jpegtpu.encode_color)
    return [encode(im, cfg) for im in images]


def _port_bytes(images, kw, path):
    cfg = EncodeConfig(**kw)
    if path == "batch":
        encode_batch = (batch.encode_grayscale_batch if cfg.n_components == 1
                        else batch.encode_color_batch)
        return encode_batch(images, cfg, **CPU)
    encode = (jpegtpu_torch.encode_grayscale if cfg.n_components == 1
              else jpegtpu_torch.encode_color)
    return [encode(im, cfg, **CPU) for im in images]


PATHS = {"single": {}, "restart": {"restart_interval": 3},
         "two_pass": {"optimize_huffman": True}, "batch": {}}


@pytest.fixture
def k4_caps(monkeypatch):
    """The caps K4's plain version runs at."""
    caps = []
    orig = pack.encode_blocks_plain

    def spy(levels, dc_diff, huff, cap):
        caps.append(cap)
        return orig(levels, dc_diff, huff, cap)
    monkeypatch.setattr(pack, "encode_blocks_plain", spy)
    return caps


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("ss,cap", [("gray", 453), ("420", 76)])
def test_first_rung_past_the_longest_block(ss, cap, path, k4_caps):
    """4:2:0 at 76 words and gray at 453: past K8's shared memory on the
    card at those rungs. The kernels run at 53 words with rung 8's
    bytes."""
    color = ss != "gray"
    images = [_photo(40, 56, s, rgb=color) for s in (1, 2)]
    kw = dict(subsampling=ss, **PATHS[path])
    got = _port_bytes(images, dict(kw, capacity_words_per_block=cap), path)
    assert k4_caps and set(k4_caps) == {MAX_WORDS_PER_BLOCK}
    assert got == _jpegtpu_bytes(images, kw)
    assert got == _port_bytes(images, kw, path)


def test_concat_decision_reads_the_rung(monkeypatch):
    """The kernels run at 53 words, but K9 or K10 is jpegtpu's choice at
    the rung: with a 1 MiB budget a 40 x 56 gray frame is resident at 53
    words a block and past the budget at 453, so K10's twin joins it."""
    img = _photo(40, 56, 8)
    monkeypatch.setattr(concat, "VMEM_BUDGET", 1 << 20)
    assert pipeline.gray_concat_mode(40, 56, 53) == "pallas-resident"
    assert pipeline.gray_concat_mode(40, 56, 453) != "pallas-resident"
    joins = []
    for name in ("stream_concat_plain", "stream_concat_chunked_plain"):
        orig = getattr(concat, name)
        monkeypatch.setattr(concat, name, lambda *a, _o=orig, _n=name: (
            joins.append(_n), _o(*a))[1])
    got = _port_bytes([img], {"capacity_words_per_block": 453}, "single")
    assert joins == ["stream_concat_chunked_plain"]
    assert got == _jpegtpu_bytes([img], {})


def test_encode_scan_device_keeps_the_stream_size_past_53(k4_caps):
    rng = np.random.default_rng(4)
    zz = (rng.integers(-20, 21, (24, 64)) * (rng.random((24, 64)) < 0.4)
          ).astype(np.int32)
    nb = zz.shape[0]
    big, big_n, big_ov = device.encode_scan_device(zz, capacity_words=nb * 80,
                                                   stuff=False)
    top, top_n, _ = device.encode_scan_device(zz, stuff=False)
    assert set(k4_caps) == {MAX_WORDS_PER_BLOCK}
    assert big.shape == (concat.stream_words(nb, 80),)
    assert int(big_n) == int(top_n) and not bool(big_ov)
    assert torch.equal(big[:top.shape[0]], top)
    assert not big[top.shape[0]:].any()


@pytest.mark.parametrize("dct_dtype", ["float64", "float16", "bfloat16"])
@pytest.mark.parametrize("ss", ["gray", "420"])
def test_dct_dtype_takes_the_float32_path(ss, dct_dtype):
    """jpegtpu parses dct_dtype with np.dtype and takes the float path for
    every value but "int32"; "bfloat16" parses where ml_dtypes is
    importable (here: JAX imports it)."""
    images = [_photo(40, 56, 3, rgb=ss != "gray")]
    kw = dict(subsampling=ss, dct_dtype=dct_dtype)
    got = _port_bytes(images, kw, "single")
    assert got == _jpegtpu_bytes(images, kw)
    assert got == _port_bytes(images, dict(subsampling=ss), "single")


@pytest.mark.parametrize("bitexact", [True, False])
@pytest.mark.parametrize("dct_dtype", ["float32", "float64", "float16",
                                       "bfloat16", "int32"])
def test_dct_basis_matches_jpegtpu(dct_dtype, bitexact):
    got = EncodeConfig(dct_dtype=dct_dtype, bitexact=bitexact).dct_basis()
    want = jpegtpu.EncodeConfig(dct_dtype=dct_dtype,
                                bitexact=bitexact).dct_basis()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_unknown_dct_dtype_is_refused():
    """Names numpy does not parse: jpegtpu fails when it builds its basis,
    the port when the config is made."""
    with pytest.raises(TypeError):
        jpegtpu.EncodeConfig(dct_dtype="float99").dct_basis()
    with pytest.raises(ValueError, match="dct_dtype"):
        EncodeConfig(dct_dtype="float99")


# (config, path, whether it stuffs on the device): jpegtpu reads `stuff`
# only at its single-segment encodes
STUFF_CASES = {
    "gray": ({}, "single", True),
    "gray_two_pass": ({"optimize_huffman": True}, "single", True),
    "color": ({"subsampling": "420"}, "single", True),
    "color_two_pass": ({"subsampling": "420", "optimize_huffman": True},
                       "single", True),
    "gray_restart": ({"restart_interval": 2}, "single", False),
    "color_restart": ({"subsampling": "422", "restart_interval": 2},
                      "single", False),
    "gray_batch": ({}, "batch", False),
    "color_batch": ({"subsampling": "420"}, "batch", False),
}


@pytest.mark.parametrize("name", sorted(STUFF_CASES))
def test_stuff_device_matches_jpegtpu(name, monkeypatch):
    kw, path, on_device = STUFF_CASES[name]
    color = kw.get("subsampling", "gray") != "gray"
    # 0xFF bytes in the scan: Q100 noise
    images = [np.random.default_rng(s).integers(
        0, 256, (48, 64, 3) if color else (48, 64), np.uint8) for s in (5, 6)]
    kw = dict(kw, quality=100)
    calls = []
    orig = pipeline.stuff_bytes_device
    monkeypatch.setattr(pipeline, "stuff_bytes_device",
                        lambda *a: calls.append(1) or orig(*a))
    got = _port_bytes(images, dict(kw, stuff="device"), path)
    # once per rung climbed (the noise overflows rung 8 at 4:2:0)
    assert len(calls) >= len(images) if on_device else not calls
    assert got == _jpegtpu_bytes(images, dict(kw, stuff="device"))
    assert got == _port_bytes(images, kw, path)
    assert any(b"\xff\x00" in g for g in got)


def test_stuff_device_is_read_back_stuffed(monkeypatch):
    """The host reads the stuffed bytes the device made, and stuffs
    nothing itself."""
    img = np.random.default_rng(7).integers(0, 256, (32, 32), np.uint8)
    cfg = EncodeConfig(quality=100)
    want = jpegtpu_torch.encode_grayscale(img, cfg, **CPU)
    monkeypatch.setattr(transfer, "read_segments", None)
    assert jpegtpu_torch.encode_grayscale(
        img, dataclasses.replace(cfg, stuff="device"), **CPU) == want
