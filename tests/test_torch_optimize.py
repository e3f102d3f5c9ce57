"""2-pass optimal Huffman tables in jpegtpu_torch on the CPU (the kernels'
plain versions, K4 with runtime tables) against jpegtpu.

Bytes must be equal and histograms exactly equal. The oracle is jpegtpu's
host 2-pass (entropy="host"), which floors its frequencies as every
jpegtpu 2-pass path does; one case holds the port against jpegtpu's
device 2-pass chain itself (interpret mode). Color restart 2-pass is held
against the host 2-pass only (ROADMAP.md Queue 3)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu import color_pipeline as jcp
from jpegtpu import tables as jtables
from jpegtpu.entropy import device as jdevice
from jpegtpu.entropy import host as jhost
from jpegtpu.io import jfif as jjfif

import jpegtpu_torch
from jpegtpu_torch import pipeline, tables
from jpegtpu_torch.entropy import pack
from jpegtpu_torch.entropy.device import (MAX_WORDS_PER_BLOCK,
                                          assemble_histograms,
                                          dc_differences, symbol_histograms)
from jpegtpu_torch.io import jfif

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)


def _gray(h, w, seed=0):
    """Photographic-complexity content (tests/test_tpu_parity.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    return np.clip(base + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)


GRAY = _gray(96, 72, seed=51)
RGB = np.stack([_gray(72, 56, seed=61 + c) for c in range(3)], -1)


@pytest.mark.parametrize("ss", ["gray", "420"])
@pytest.mark.parametrize("dct_dtype", ["float32", "int32"])
@pytest.mark.parametrize("interval", [0, 3])
@pytest.mark.parametrize("entropy", ["device", "host"])
def test_two_pass_matches_jpegtpu_host_two_pass(ss, dct_dtype, interval,
                                                entropy):
    kw = dict(subsampling=ss, dct_dtype=dct_dtype, restart_interval=interval,
              optimize_huffman=True)
    cfg = jpegtpu_torch.EncodeConfig(entropy=entropy, **kw)
    ref = jpegtpu.EncodeConfig(entropy="host", **kw)
    if ss == "gray":
        got = jpegtpu_torch.encode_grayscale(GRAY, cfg, device="cpu")
        want = jpegtpu.encode_grayscale(GRAY, ref)
    else:
        got = jpegtpu_torch.encode_color(RGB, cfg, device="cpu")
        want = jcp.encode_color(RGB, ref)
    assert got == want


def test_gray_two_pass_matches_jpegtpu_device_path():
    """The one comparison with jpegtpu's device 2-pass chain (symbol
    histograms, then K4 with runtime tables, interpret mode)."""
    cfg = dict(optimize_huffman=True)
    assert jpegtpu_torch.encode_grayscale(
        GRAY, jpegtpu_torch.EncodeConfig(**cfg), device="cpu") == (
        jpegtpu.encode_grayscale(GRAY, jpegtpu.EncodeConfig(**cfg)))


def _levels(rng, nb):
    """Random sparse zigzag levels [nb, 64]: long zero runs (ZRLs), full
    tails (no EOB), sizes 1..10 and DC sizes up to 11."""
    zz = np.zeros((nb, 64), np.int32)
    for i in range(nb):
        k = rng.integers(0, 12)
        pos = rng.choice(np.arange(1, 64), size=k, replace=False)
        zz[i, pos] = rng.choice([-1, 1], k) * rng.integers(1, 1024, k)
    zz[::7, 63] = 5
    zz[::5, 1:] = rng.integers(-3, 4, (len(zz[::5]), 63))
    zz[:, 0] = rng.integers(-1024, 1024, nb)
    return zz


@pytest.mark.parametrize("seg_len", [0, 4])
def test_symbol_histograms_match_jpegtpu(seg_len):
    rng = np.random.default_rng(seg_len)
    zz = _levels(rng, 300)
    table_sel = (np.arange(300) % 3 == 2).astype(np.int32)
    dcd = dc_differences(torch.from_numpy(zz[:, 0].copy()), seg_len)
    lv = torch.from_numpy(zz.T.copy())
    # the port counts each table class's blocks in its own call
    counts = sum(symbol_histograms(lv[:, table_sel == t], dcd[table_sel == t],
                                   t) for t in (0, 1))
    want = jdevice.symbol_histograms(
        jnp.asarray(zz), table_sel=jnp.asarray(table_sel),
        dc_diff=jnp.asarray(dcd.numpy()))
    c = counts.numpy()
    np.testing.assert_array_equal(c[:, :12], np.asarray(want["dc12"]))
    np.testing.assert_array_equal(c[:, 12:188].reshape(2, 16, 11),
                                  np.asarray(want["ac"]))
    np.testing.assert_array_equal(c[:, 188], np.asarray(want["zrl"]))
    np.testing.assert_array_equal(c[:, 189], np.asarray(want["eob"]))
    got = assemble_histograms(counts)
    ref = jdevice.assemble_histograms(want)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    # and the host coder's histograms of the same scan
    seg_ids = np.arange(300) // seg_len if seg_len else None
    host = jhost.symbol_frequencies(zz, table_sel=table_sel.astype(np.int64),
                                    segment_ids=seg_ids)
    for k in got:
        np.testing.assert_array_equal(got[k], host[k])


@pytest.mark.parametrize("seed", range(6))
def test_optimal_spec_and_floor_match_jpegtpu(seed):
    rng = np.random.default_rng(seed)
    freqs = {}
    for k in ("dc_lum", "ac_lum", "dc_chrom", "ac_chrom"):
        f = np.zeros(256, np.int64)
        used = rng.choice(256, size=rng.integers(1, 256), replace=False)
        f[used] = (rng.pareto(0.7, used.size) * 10).astype(np.int64) + 1
        freqs[k] = f
    floored = tables.floor_frequencies(freqs)
    ref_floored = jtables.floor_frequencies(freqs)
    for k in freqs:
        np.testing.assert_array_equal(floored[k], ref_floored[k])
    specs = tables.optimal_specs_from_frequencies(floored)
    ref_specs = jtables.optimal_specs_from_frequencies(ref_floored)
    for k in freqs:
        for a, b in zip(specs[k], ref_specs[k], strict=True):
            np.testing.assert_array_equal(a, b)
        assert int(specs[k][0].astype(np.int64) @ (0.5 ** np.arange(1, 17))
                   ) <= 1  # Kraft
    luts = tables.huffman_luts_from_specs(specs)
    ref_luts = jtables.huffman_luts_from_specs(ref_specs)
    for k in freqs:
        for a, b in zip(luts[k], ref_luts[k], strict=True):
            np.testing.assert_array_equal(a, b)
    assert tables.optimal_spec(np.zeros(256))[1].size == 0


def _long_code_luts():
    """A legal spec whose DC codes of sizes 1..11, ZRL, EOB and AC (0, 10)
    are 16 bits long with their high bit set (every other symbol 8 bits):
    the longest puts K4 can make, 16 + 11 and 16 + 10 bits."""
    dc_bits = np.zeros(16, np.uint8)
    dc_bits[0], dc_bits[15] = 1, 11
    dc_vals = np.arange(12, dtype=np.uint8)  # size 0 gets the 1-bit code
    long_ac = [0x00, 0xF0, 0x0A]
    short_ac = [(r << 4) | s for r in range(16) for s in range(1, 11)
                if (r << 4) | s not in long_ac]
    ac_bits = np.zeros(16, np.uint8)
    ac_bits[7], ac_bits[15] = len(short_ac), len(long_ac)
    ac_vals = np.array(short_ac + long_ac, np.uint8)
    specs = {"dc_lum": (dc_bits, dc_vals), "ac_lum": (ac_bits, ac_vals)}
    return specs, tables.huffman_luts_from_specs(specs)


def test_k4_plain_takes_16_bit_codes():
    """K4's plain version with 16-bit DC, ZRL, EOB and AC codes equals
    jpegtpu's host coder; the worst block (63 AC of 26 bits after a 27-bit
    DC, 1665 bits) fits the top rung."""
    specs, luts = _long_code_luts()
    for k, (c, ln) in luts.items():
        assert ln.max() == 16 and (c[ln == 16] >> 15).all(), k
    rng = np.random.default_rng(3)
    zz = _levels(rng, 60)
    zz[0, 1:] = 1023  # the worst block: every AC (0, 10)
    zz[0, 0] = -1024  # DC size 11
    zz[1, 0] = 1000
    zz[2, :] = 0
    zz[2, 40] = 1  # 39 zeros: two ZRLs, then EOB
    huff = tables.huffman_table(luts, "lum", "cpu")
    dcd = dc_differences(torch.from_numpy(zz[:, 0].copy()))
    words, bits = pack.encode_blocks(torch.from_numpy(zz.T.copy()), dcd,
                                     huff, MAX_WORDS_PER_BLOCK)
    assert int(bits[0]) == 27 + 63 * 26 == 1665
    assert int(bits.max()) <= MAX_WORDS_PER_BLOCK * 32
    scan = pipeline.finish_scan(words, bits, torch.tensor(False), 6, 10,
                                True)
    assert [scan] == jhost.encode_scan(zz, luts=jtables.huffman_luts_from_specs(
        specs))


@pytest.mark.parametrize("ss,interval", [("gray", 0), ("420", 4)])
def test_two_pass_ladder_climbs_to_the_top_rung(ss, interval):
    """Q100 int32 noise overflows caps 8 and 16; K4 keeps the optimal
    tables at cap 53 and the bytes match jpegtpu's host 2-pass."""
    img = np.random.default_rng(11).integers(0, 256, (48, 64, 3), np.uint8)
    kw = dict(quality=100, dct_dtype="int32", subsampling=ss,
              restart_interval=interval, optimize_huffman=True)
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


@functools.lru_cache(maxsize=None)
def _specs():
    return jtables.optimal_specs_from_frequencies(jtables.floor_frequencies(
        jhost.symbol_frequencies(_levels(np.random.default_rng(0), 50))))


@pytest.mark.parametrize("kw", [{}, {"subsampling": "420",
                                     "restart_interval": 3}])
def test_headers_carry_the_optimal_specs(kw):
    specs = _specs()
    cfg, ref = jpegtpu_torch.EncodeConfig(**kw), jpegtpu.EncodeConfig(**kw)
    assert jfif.assemble(30, 20, cfg, [b"xy"], huffman_specs=specs) == (
        jjfif.assemble(30, 20, ref, [b"xy"], huffman_specs=specs))


def test_huffman_table_layout():
    luts = tables.huffman_luts()
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu")
    assert torch.equal(tables.huffman_table(luts, "lum", "cpu"), state.huff)
    assert torch.equal(tables.huffman_table(luts, "chrom", "cpu"),
                       state.huff_chroma)
    assert tables.huffman_table(luts, "lum", "cpu").dtype == torch.int32
