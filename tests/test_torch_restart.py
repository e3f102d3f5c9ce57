"""Restart intervals in jpegtpu_torch on the CPU (the kernels' plain
versions, K12 included) against jpegtpu.

Bytes must be equal and levels exactly equal. The oracle is jpegtpu's
host entropy coder (entropy="host"), which jpegtpu's own tests pin to the
bytes of its device chain; one case holds the port against that device
chain itself (K12 in interpret mode)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu import color_pipeline as jcp
from jpegtpu import native as jnative
from jpegtpu.entropy import device as jdevice
from jpegtpu.entropy import pallas_concat
from jpegtpu.io import bmp as jbmp
from jpegtpu.io import jfif as jjfif

import jpegtpu_torch
from jpegtpu_torch import native, pipeline
from jpegtpu_torch.entropy import host as entropy_host
from jpegtpu_torch.entropy import stitch
from jpegtpu_torch.entropy.device import dc_differences, y_dc_differences
from jpegtpu_torch.io import jfif

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)


def _gray(h, w, seed=0):
    """Photographic-complexity content (tests/test_tpu_parity.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    return np.clip(base + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)


def _rgb(h, w, seed=0):
    return np.stack([_gray(h, w, seed + c) for c in range(3)], -1)


GRAY = _gray(96, 72, seed=31)  # 12 x 9 = 108 blocks
RGB = _rgb(72, 56, seed=41)


@functools.lru_cache(maxsize=None)
def _jpegtpu_gray(**kw):
    return jpegtpu.encode_grayscale(GRAY, jpegtpu.EncodeConfig(
        entropy="host", **kw))


@functools.lru_cache(maxsize=None)
def _jpegtpu_color(**kw):
    return jcp.encode_color(RGB, jpegtpu.EncodeConfig(entropy="host", **kw))


@pytest.mark.parametrize("interval", [1, 7, 25, 108, 500])
@pytest.mark.parametrize("dct_dtype", ["float32", "int32"])
@pytest.mark.parametrize("pad_ones", [True, False])
@pytest.mark.parametrize("entropy", ["device", "host"])
def test_gray_restart_matches_jpegtpu(interval, dct_dtype, pad_ones,
                                      entropy):
    kw = dict(restart_interval=interval, dct_dtype=dct_dtype,
              pad_ones=pad_ones)
    cfg = jpegtpu_torch.EncodeConfig(entropy=entropy, **kw)
    got = jpegtpu_torch.encode_grayscale(GRAY, cfg, device="cpu")
    assert got == _jpegtpu_gray(**kw)


@pytest.mark.parametrize("ss", ["420", "422", "444"])
@pytest.mark.parametrize("interval", [1, 2, 5])
@pytest.mark.parametrize("entropy", ["device", "host"])
def test_color_restart_matches_jpegtpu(ss, interval, entropy):
    kw = dict(subsampling=ss, restart_interval=interval)
    cfg = jpegtpu_torch.EncodeConfig(entropy=entropy, **kw)
    got = jpegtpu_torch.encode_color(RGB, cfg, device="cpu")
    assert got == _jpegtpu_color(**kw)


def test_gray_restart_matches_jpegtpu_device_path():
    """The one comparison with jpegtpu's stitched restart chain (K1, K4,
    K8, K12 in interpret mode), at a ragged final segment."""
    cfg = dict(restart_interval=25)
    assert jpegtpu_torch.encode_grayscale(
        GRAY, jpegtpu_torch.EncodeConfig(**cfg), device="cpu") == (
        jpegtpu.encode_grayscale(GRAY, jpegtpu.EncodeConfig(**cfg)))


def _random_streams(rng, c, n):
    """Per-stream words [c, n] (zero past each stream's bits, as K4 and
    K5 store them) and bit counts [n], short streams included."""
    bits = rng.integers(0, c * 32 + 1, n)
    short = rng.random(n) < 0.3
    bits[short] = rng.integers(0, 12, int(short.sum()))
    valid = (bits[None, :] - 32 * np.arange(c)[:, None]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 2**32, (c, n), dtype=np.int64) & keep
    return words.astype(np.uint32), bits.astype(np.int32)


@pytest.mark.parametrize("c,n,seg_len", [
    (2, 200, 37), (2, 130, 300), (1, 64, 1),
])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_stitch_plain_matches_pallas_stitch(c, n, seg_len, pad_ones):
    """K12's plain version against jpegtpu's stitch_segments_pallas (K8 +
    K12, interpret mode), whose segments are padded to 128-slot rows with
    empty streams: the segment totals and the valid word prefix agree."""
    rng = np.random.default_rng(c * 1000 + n + seg_len)
    words, bits = _random_streams(rng, c, n)
    stream, seg_tot, total = stitch.stitch_segments(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        seg_len, pad_ones)

    n_seg = -(-n // seg_len)
    seg128 = -(-seg_len // 128) * 128
    w_t = np.zeros((c, n_seg, seg128), np.uint32)
    b_t = np.zeros((n_seg, seg128), np.int32)
    for s in range(n_seg):
        lo, hi = s * seg_len, min(n, (s + 1) * seg_len)
        w_t[:, s, : hi - lo] = words[:, lo:hi]
        b_t[s, : hi - lo] = bits[lo:hi]
    spc = pallas_concat.stitch_plan(n_seg, seg128, c)
    chunks, ref_tot, _ = pallas_concat.stitch_segments_pallas(
        jnp.asarray(w_t.reshape(c, -1)), jnp.asarray(b_t.reshape(-1)),
        seg128, spc, pad_ones=pad_ones, interpret=True)
    assert spc == n_seg and chunks.shape[0] == 1
    np.testing.assert_array_equal(seg_tot.numpy(), np.asarray(ref_tot))
    assert int(total) == int(np.asarray(ref_tot).sum())
    nw = -(-int(total) // 32)
    np.testing.assert_array_equal(stream.numpy().view(np.uint32)[:nw],
                                  np.asarray(chunks)[0, :nw])
    assert not stream.numpy()[nw:].any()


def test_stitch_clamps_overflowed_streams():
    """A stream past C words (the encode will retry) counts C * 32 bits,
    so the buffer never overruns."""
    words = torch.full((2, 5), -1, dtype=torch.int32)
    bits = torch.full((5,), 200, dtype=torch.int32)
    stream, seg_tot, total = stitch.stitch_segments(words, bits, 2)
    assert seg_tot.tolist() == [128, 128, 64] and int(total) == 320
    assert (stream.numpy().view(np.uint32)[:10] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("seg_len", [0, 1, 3, 7])
def test_dc_chain_resets_match_jpegtpu(seg_len):
    dc = np.random.default_rng(seg_len).integers(-500, 500, 40, np.int32)
    np.testing.assert_array_equal(
        dc_differences(torch.from_numpy(dc), seg_len).numpy(),
        np.asarray(jdevice.dc_differences(jnp.asarray(dc), seg_len)))


@pytest.mark.parametrize("ss", ["420", "422", "444"])
@pytest.mark.parametrize("seg_mcus", [1, 3, 5])
def test_luma_dc_chain_resets_match_jpegtpu(ss, seg_mcus):
    dc = np.random.default_rng(seg_mcus).integers(-500, 500, (6, 10),
                                                  np.int32)
    np.testing.assert_array_equal(
        y_dc_differences(torch.from_numpy(dc), ss, seg_mcus).numpy(),
        np.asarray(jcp._y_dc_diff_natural(jnp.asarray(dc), ss, seg_mcus)))


@pytest.mark.parametrize("n_seg", [1, 20])
def test_scan_from_words_matches_jpegtpu_native(n_seg):
    rng = np.random.default_rng(n_seg)
    seg_bytes = rng.integers(0, 9, n_seg)
    words = rng.integers(0, 2**32, -(-int(seg_bytes.sum()) // 4),
                         dtype=np.uint64).astype(np.uint32)
    words[::3] |= 0xFF00FF00  # 0xFF bytes to stuff
    assert native.scan_from_words(words, seg_bytes) == (
        jnative.scan_from_words(words, seg_bytes))


def test_numpy_finish_matches_native(monkeypatch):
    """Without g++ the restart scan finishes in numpy: same bytes."""
    cfg = jpegtpu_torch.EncodeConfig(restart_interval=3)
    want = jpegtpu_torch.encode_grayscale(GRAY, cfg, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    assert jpegtpu_torch.encode_grayscale(GRAY, cfg, device="cpu") == want
    words = np.arange(1, 6, dtype=np.uint32) * 0x01FF03FF
    assert entropy_host.scan_from_words(words, np.array([3, 0, 9, 8])) == (
        jnative.scan_from_words(words, np.array([3, 0, 9, 8])))


@pytest.mark.parametrize("ss", ["gray", "420"])
def test_ladder_climbs_to_the_top_rung_with_restarts(ss):
    """Q100 int32 noise overflows caps 8 and 16; the bytes at cap 53
    match jpegtpu."""
    img = np.random.default_rng(9).integers(0, 256, (48, 64, 3), np.uint8)
    kw = dict(quality=100, dct_dtype="int32", subsampling=ss,
              restart_interval=5)
    cfg = jpegtpu_torch.EncodeConfig(**kw)
    if ss == "gray":
        img = img[..., 0]
        key, encode, ref = ((6, 8, cfg, False), jpegtpu_torch.encode_grayscale,
                            jpegtpu.encode_grayscale)
    else:
        key, encode, ref = ((48, 64, cfg, "color"), jpegtpu_torch.encode_color,
                            jcp.encode_color)
    pipeline._cap_history.pop(key, None)
    got = encode(img, cfg, device="cpu")
    assert pipeline._cap_history[key][0] == 53
    assert got == ref(img, jpegtpu.EncodeConfig(entropy="host", **kw))


@pytest.mark.parametrize("kw", [
    {"restart_interval": 9},
    {"restart_interval": 2, "subsampling": "422"},
])
def test_headers_match_jpegtpu(kw):
    cfg = jpegtpu_torch.EncodeConfig(**kw)
    ref = jpegtpu.EncodeConfig(**kw)
    headers = (jfif.grayscale_headers, jjfif.grayscale_headers)
    if cfg.n_components == 3:
        headers = (jfif.color_headers, jjfif.color_headers)
    assert headers[0](70, 50, cfg) == headers[1](70, 50, ref)
    assert b"\xff\xdd\x00\x04" in headers[0](70, 50, cfg)
    assert jfif.assemble(70, 50, cfg, [b"a", b"b", b"c"]) == jjfif.assemble(
        70, 50, ref, [b"a", b"b", b"c"])
    with pytest.raises(ValueError):
        jfif.assemble(70, 50, jpegtpu_torch.EncodeConfig(), [b"a", b"b"])


def test_encode_file_with_restarts(tmp_path):
    src = tmp_path / "in.bmp"
    jbmp.write(str(src), _rgb(50, 70, seed=9))
    for kw in ({"restart_interval": 4}, {"restart_interval": 3,
                                          "subsampling": "420"}):
        n = jpegtpu_torch.encode_file(
            str(src), str(tmp_path / "port.jpg"),
            jpegtpu_torch.EncodeConfig(**kw), device="cpu")
        m = jpegtpu.encode_file(str(src), str(tmp_path / "ref.jpg"),
                                jpegtpu.EncodeConfig(entropy="host", **kw))
        assert n == m
        assert (tmp_path / "port.jpg").read_bytes() == (
            tmp_path / "ref.jpg").read_bytes()


@pytest.mark.parametrize("kw", [
    {"restart_interval": 4},
    {"restart_interval": 4, "optimize_huffman": True},
    {"subsampling": "420", "restart_interval": 2},
])
def test_restart_configs_need_cuda_by_default(monkeypatch, kw):
    monkeypatch.setattr(pipeline.torch.cuda, "is_available", lambda: False)
    cfg = jpegtpu_torch.EncodeConfig(**kw)
    encode = (jpegtpu_torch.encode_grayscale if cfg.n_components == 1
              else jpegtpu_torch.encode_color)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode(_gray(16, 16), cfg)
    # stuff="device" (ROADMAP.md M10): restart segments stuff on the host,
    # as in jpegtpu, which ignores the field there
    jencode = (jpegtpu.encode_grayscale if cfg.n_components == 1
               else jpegtpu.encode_color)
    assert encode(_gray(16, 16), jpegtpu_torch.EncodeConfig(
        stuff="device", **kw), device="cpu") == jencode(
        _gray(16, 16), jpegtpu.EncodeConfig(stuff="device", entropy="host",
                                            **kw))
