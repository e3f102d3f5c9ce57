"""K6 (jpegtpu_torch.entropy.merge.merge_streams) and the color batch's
slot-major route, as their plain versions run them on the CPU.

- merge_streams_plain against jpegtpu's merge_streams_pallas (interpret
  mode) on seeded MSB-aligned streams, exactly;
- merge_streams_plain on K4's streams gathered slot-major against
  merge_mcu_plain (K5's twin) and against a bit-string oracle, overflowed
  blocks included;
- batch.color_raw_ok against jpegtpu.batch._color_raw_ok;
- encode_color_batch through K6's twin where jpegtpu takes K6, with the
  bytes of the single-image encodes and of jpegtpu's batch encode."""
import numpy as np
import pytest
import torch

from jpegtpu import EncodeConfig as JConfig
from jpegtpu import batch as jbatch
from jpegtpu.entropy import pallas_pack

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, batch, tables
from jpegtpu_torch.entropy import merge
from jpegtpu_torch.entropy.pack import encode_blocks
from jpegtpu_torch.ops.blocks import padded_dims_color, sampling_factors

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")
LANES_PER_STEP = pallas_pack.SUBLANES * pallas_pack.LANES  # 1024 MCUs


def _streams(e, cap, m, seed):
    """E x M MSB-aligned streams of up to cap words, bits past each
    stream's count zero: (words [E, cap, M] int64 < 2^32, bits [E, M])."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, cap * 32 + 1, (e, m))
    bits[:, :5] = [0, 1, 31, cap * 32 - 1, cap * 32]  # the edges
    words = rng.integers(0, 1 << 32, (e, cap, m), dtype=np.uint64)
    keep = np.clip(bits[:, None, :] - 32 * np.arange(cap)[None, :, None],
                   0, 32).astype(np.uint64)
    mask = (np.uint64(0xFFFFFFFF) << (np.uint64(32) - keep)) & np.uint64(
        0xFFFFFFFF)
    return (words & mask).astype(np.int64), bits


def _bit_oracle(words, bits):
    """Each MCU's streams as '0'/'1' strings, joined and packed into
    words: (words [E * cap, M] int64, bits [M])."""
    e, cap, m = words.shape
    out = np.zeros((e * cap, m), np.int64)
    total = np.zeros(m, np.int64)
    for j in range(m):
        s = "".join(
            "".join(f"{int(w):032b}" for w in words[k, :, j])[
                :min(int(bits[k, j]), cap * 32)]
            for k in range(e))
        total[j] = len(s)
        s = s.ljust(e * cap * 32, "0")
        out[:, j] = [int(s[32 * i:32 * i + 32], 2) for i in range(e * cap)]
    return out, total


def _u32(t):
    return t.numpy().view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("e,cap", [(3, 1), (4, 2), (6, 8)])
def test_merge_streams_plain_matches_pallas_interpret(e, cap):
    m = LANES_PER_STEP  # G = 1: MCU m is sublane m // 128, lane m % 128
    words, bits = _streams(e, cap, m, seed=10 * e + cap)
    w_raw = words.astype(np.uint32).reshape(e, cap, 1, 8, 128).transpose(
        2, 0, 1, 3, 4)
    b_raw = bits.astype(np.int32).reshape(e, 1, 8, 128).transpose(1, 0, 2, 3)
    want_w, want_b = pallas_pack.merge_streams_pallas(w_raw, b_raw,
                                                      interpret=True)
    want_w = np.asarray(want_w).transpose(1, 0, 2, 3).reshape(e * cap, m)
    got_w, got_b = merge.merge_streams_plain(
        torch.from_numpy(words).to(torch.int32), torch.from_numpy(bits).to(
            torch.int32))
    np.testing.assert_array_equal(_u32(got_w), want_w.astype(np.int64))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b).reshape(-1))


def _block_streams(ss, nmch, nmcw, cap, seed):
    """K4's plain streams of seeded levels for an nmch x nmcw MCU grid,
    two blocks of every class made long enough to overflow cap words."""
    fy, fx = sampling_factors(ss)
    nmcu = nmch * nmcw
    rng = np.random.default_rng(seed)
    state = tables.encoder_state(EncodeConfig(), "cpu")
    out = []
    for n, huff in ((fy * fx * nmcu, state.huff),
                    (2 * nmcu, state.huff_chroma)):
        lv = rng.integers(-3, 4, (64, n)) * (rng.random((64, n)) < 0.3)
        lv[1:, [1, n - 1]] = rng.choice([-900, 900], (63, 2))
        dcd = torch.from_numpy(rng.integers(-50, 51, n).astype(np.int32))
        w, b = encode_blocks(torch.from_numpy(lv.astype(np.int32)), dcd,
                             huff, cap)
        assert int(b.max()) > cap * 32  # an overflowed block
        out += [w, b]
    return out


@pytest.mark.parametrize("cap", [1, 8, 16])
@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_slot_major_merge_matches_merge_mcu(ss, cap):
    nmch, nmcw = 3, 5
    wy, by, wc, bc = _block_streams(ss, nmch, nmcw, cap, seed=cap)
    words, bits = merge.slot_major_streams(wy, by, wc, bc, nmch, nmcw, ss)
    fy, fx = sampling_factors(ss)
    assert words.shape == (fy * fx + 2, cap, nmch * nmcw)
    got = merge.merge_streams(words, bits)
    want = merge.merge_mcu_plain(wy, by, wc, bc, nmch, nmcw, ss)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    oracle_w, oracle_b = _bit_oracle(
        words.numpy().astype(np.int64) & 0xFFFFFFFF, bits.numpy())
    np.testing.assert_array_equal(_u32(got[0]), oracle_w)
    np.testing.assert_array_equal(got[1].numpy(), oracle_b)


def test_merge_streams_rejects_mismatched_shapes():
    z = torch.zeros((6, 8, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot-major"):
        merge.merge_streams(z, z[:, 0, :9])


# padded shapes of jpegtpu's raw / K6 table (bench sizes, 12 MPix, a
# tall strip past 256 kernel rows, and the small jpegtpu batch test)
ROUTE_SHAPES = [(512, 512), (1080, 1920), (2160, 3840), (3024, 4032),
                (1536, 2048), (4112, 64), (32, 48)]


@pytest.mark.parametrize("h,w", ROUTE_SHAPES)
@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_raw_ok_matches_jpegtpu(h, w, ss):
    ph, pw = padded_dims_color(h, w, ss)
    fx = 1 if ss == "444" else 2
    _, r, _ = jbatch._slot_geom(pw // fx // 8)
    for cap in (1, 8, 16, 53):
        assert batch.color_raw_ok(ph, pw, ss, cap) == jbatch._color_raw_ok(
            r, ph, pw, JConfig(subsampling=ss), cap)


def _spy(monkeypatch):
    """Count the calls of K5's and K6's plain versions."""
    calls = {"merge_mcu_plain": 0, "merge_streams_plain": 0}
    for name in calls:
        orig = getattr(merge, name)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(merge, name, counted)
    return calls


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(xx * (1.7 + c) + yy * 0.9) % 256 + rng.normal(0, 10, (h, w))
             for c in range(3)]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


def test_batch_past_the_row_budget_merges_with_k6(monkeypatch):
    """4112 x 16 at 4:2:0 (one MCU column): 264 kernel rows per image,
    past jpegtpu's 256, so jpegtpu merges with K6 at cap 8; the port
    takes K6's twin, K5's not at all, with the single-image bytes."""
    images = [_photo(4112, 16, 1), _photo(4112, 16, 2)]
    cfg = EncodeConfig(subsampling="420")
    assert not batch.color_raw_ok(4112, 16, "420", 8)
    calls = _spy(monkeypatch)
    got = batch.encode_color_batch(images, cfg, **CPU)
    assert calls == {"merge_mcu_plain": 0, "merge_streams_plain": 1}
    assert got == [jpegtpu_torch.encode_color(im, cfg, **CPU)
                   for im in images]


def test_rung_16_batch_matches_jpegtpu(monkeypatch):
    """jpegtpu's batch at capacity_words_per_block=16 runs K6 (its
    non-raw route); the port runs K6's twin with jpegtpu's bytes."""
    images = [_photo(32, 48, 3), _photo(32, 48, 4)]
    kw = dict(subsampling="420", capacity_words_per_block=16)
    want = jbatch.encode_color_batch(images, JConfig(**kw))
    calls = _spy(monkeypatch)
    assert batch.encode_color_batch(images, EncodeConfig(**kw), **CPU) == want
    assert calls == {"merge_mcu_plain": 0, "merge_streams_plain": 1}
