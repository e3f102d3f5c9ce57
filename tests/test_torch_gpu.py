"""jpegtpu_torch's CUDA kernels against their plain PyTorch versions on
the card, at small and ragged shapes (chip_smoke.py covers the main
paths' 3024 x 4032). Needs a CUDA card; skipped without one. Run on the
card with:
  python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -o addopts=""
"""
import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch import tables
from jpegtpu_torch.entropy import concat, merge, pack
from jpegtpu_torch.entropy.device import dc_differences, y_dc_differences
from jpegtpu_torch.ops import transform

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cap", [8, 16, 53])
@pytest.mark.parametrize("shape", [(8, 8), (200, 1504), (72, 1032)])
@pytest.mark.parametrize("quality", [50, 100])
def test_kernels_match_plain(cuda, shape, cap, quality):
    rng = np.random.default_rng(shape[0] + cap)
    img = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda)
    state = tables.encoder_state(
        jpegtpu_torch.EncodeConfig(quality=quality), cuda)
    nbh, nbw = shape[0] // 8, shape[1] // 8
    for int_mode in (False, True):
        lv = transform.transform(img, state, int_mode)
        assert torch.equal(lv, transform.transform_plain(img, state, int_mode))
    dcd = dc_differences(lv[0])
    words, bits = pack.encode_blocks(lv, dcd, state.huff, cap)
    w_p, b_p = pack.encode_blocks_plain(lv, dcd, state.huff, cap)
    assert torch.equal(bits, b_p) and torch.equal(words, w_p)
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
    s_p, sb_p = concat.merge_rows_plain(words, bits, nbh, nbw)
    assert torch.equal(segs, s_p) and torch.equal(seg_bits, sb_p)
    n = concat.stream_words(nbh * nbw, cap)
    stream, total = concat.stream_concat(segs, seg_bits, n)
    st_p, tot_p = concat.stream_concat_plain(segs, seg_bits, n)
    assert torch.equal(stream, st_p) and int(total) == int(tot_p)


def test_encode_matches_cpu_in_int32_mode(cuda):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (61, 93), np.uint8)
    for quality in (50, 100):
        cfg = jpegtpu_torch.EncodeConfig(quality=quality, dct_dtype="int32")
        assert jpegtpu_torch.encode_grayscale(img, cfg) == (
            jpegtpu_torch.encode_grayscale(img, cfg, device="cpu"))


# (subsampling, MCU rows, MCU cols): one MCU, a ragged grid (tiles of
# 8 x 32 blocks cut at both edges), and one wider than a tile row
COLOR_SHAPES = [(ss, mh, mw) for ss in ("420", "422", "444")
                for mh, mw in ((1, 1), (9, 37), (17, 70))]


def _rgb(cuda, ss, nmch, nmcw, seed=0):
    fy, fx = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}[ss]
    rng = np.random.default_rng(seed + nmch * 100 + nmcw)
    shape = (8 * fy * nmch, 8 * fx * nmcw, 3)
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda)


@pytest.mark.parametrize("ss,nmch,nmcw", COLOR_SHAPES)
def test_color_transforms_match_plain(cuda, ss, nmch, nmcw):
    rgb = _rgb(cuda, ss, nmch, nmcw)
    state = tables.encoder_state(
        jpegtpu_torch.EncodeConfig(quality=75, subsampling=ss), cuda)
    for int_mode in (False, True):
        for ref_luma in (False, True):
            assert torch.equal(
                transform.transform_rgb_y(rgb, state, int_mode, ref_luma),
                transform.transform_rgb_y_plain(rgb, state, int_mode,
                                                ref_luma))
        assert torch.equal(
            transform.transform_rgb_chroma(rgb, state, int_mode, ss),
            transform.transform_rgb_chroma_plain(rgb, state, int_mode, ss))


def _color_streams(cuda, ss, nmch, nmcw, quality, cap):
    rgb = _rgb(cuda, ss, nmch, nmcw, seed=quality)
    state = tables.encoder_state(
        jpegtpu_torch.EncodeConfig(quality=quality, subsampling=ss), cuda)
    fy, fx = rgb.shape[0] // (8 * nmch), rgb.shape[1] // (8 * nmcw)
    ly = transform.transform_rgb_y(rgb, state, True)
    lc = transform.transform_rgb_chroma(rgb, state, True, ss)
    dy = y_dc_differences(ly[0].reshape(fy * nmch, fx * nmcw), ss)
    dc = dc_differences(lc[0].reshape(2, -1)).reshape(-1)
    wy, by = pack.encode_blocks(ly, dy.reshape(-1), state.huff, cap)
    wc, bc = pack.encode_blocks(lc, dc, state.huff_chroma, cap)
    return wy, by, wc, bc


@pytest.mark.parametrize("ss,nmch,nmcw", COLOR_SHAPES)
@pytest.mark.parametrize("quality,cap", [(50, 8), (100, 8), (100, 53)])
def test_merge_mcu_matches_plain(cuda, ss, nmch, nmcw, quality, cap):
    """K5 against its plain version, overflowed blocks (Q100 noise at cap
    8) included; then K8 + K9 on the MCU streams."""
    streams = _color_streams(cuda, ss, nmch, nmcw, quality, cap)
    got = merge.merge_mcu(*streams, nmch, nmcw, ss)
    want = merge.merge_mcu_plain(*streams, nmch, nmcw, ss)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    segs, seg_bits = concat.merge_rows(*got, nmch, nmcw)
    s_p, sb_p = concat.merge_rows_plain(*got, nmch, nmcw)
    assert torch.equal(segs, s_p) and torch.equal(seg_bits, sb_p)
    n = concat.stream_words(nmch * nmcw, got[0].shape[0])
    st, tot = concat.stream_concat(segs, seg_bits, n)
    st_p, tot_p = concat.stream_concat_plain(segs, seg_bits, n)
    assert torch.equal(st, st_p) and int(tot) == int(tot_p)


@pytest.mark.parametrize("cap", [96, 318])
def test_merge_rows_above_48k_of_shared_memory(cuda, cap):
    """K8 on MCU streams of 4:2:0 at caps 16 and 53 (6 * cap words): its
    segment needs (cap + 1) * 512 B of shared memory, past the 48 KB a
    launch gets without opting in."""
    rng = np.random.default_rng(cap)
    nbh, nbw = 3, 200
    bits = torch.from_numpy(
        rng.integers(0, cap * 32 + 1, nbh * nbw).astype(np.int32)).to(cuda)
    # random words, zero past each block's bits as K4 and K5 store them
    valid = (bits.cpu().numpy()[None, :].astype(np.int64)
             - 32 * np.arange(cap)[:, None]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = torch.from_numpy(
        (rng.integers(0, 2**32, (cap, nbh * nbw), dtype=np.int64) & keep)
        .astype(np.uint32).view(np.int32)).to(cuda)
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
    s_p, sb_p = concat.merge_rows_plain(words, bits, nbh, nbw)
    assert torch.equal(seg_bits, sb_p) and torch.equal(segs, s_p)


def test_merge_rows_refuses_a_segment_past_the_card(cuda):
    words = torch.zeros((600, 128), dtype=torch.int32, device=cuda)
    bits = torch.zeros((128,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        concat.merge_rows(words, bits, 1, 128)


@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_encode_matches_cpu_in_int32_mode(cuda, ss):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (61, 93, 3), np.uint8)
    for quality in (50, 100):
        cfg = jpegtpu_torch.EncodeConfig(quality=quality, subsampling=ss,
                                         dct_dtype="int32")
        assert jpegtpu_torch.encode_color(img, cfg) == (
            jpegtpu_torch.encode_color(img, cfg, device="cpu"))
