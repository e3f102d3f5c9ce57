"""jpegtpu_torch's CUDA kernels against their plain PyTorch versions on
the card, at small and ragged shapes (chip_smoke.py covers the main
paths' 3024 x 4032). Needs a CUDA card; skipped without one. Run on the
card with:
  python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -o addopts=""
"""
import dataclasses

import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch import pipeline, tables, tracing
from jpegtpu_torch import _build
from jpegtpu_torch.entropy import concat, device, merge, pack, stitch
from jpegtpu_torch.entropy import treepack
from jpegtpu_torch.entropy.device import (dc_differences, symbol_histograms,
                                          y_dc_differences)
from jpegtpu_torch.io import transfer
from jpegtpu_torch.ops import stage, transform

from kernel_edge_cases import (K10_CASES, K7_CAPS, K8_CASES, K9_CASES,
                               k10_case, k5_streams, k7_elements, k8_case,
                               k9_case)
from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("ws", [16, 32, 64, 128])
@pytest.mark.parametrize("case", range(len(K8_CASES)))
def test_merge_rows_edge_cases_match_plain(cuda, case, ws):
    """K8 on tests/kernel_edge_cases.py's rows at every width: empty,
    sub-word, full and clamped blocks, ragged and narrow rows, MCU-stream
    caps 48, 96 and 318."""
    words, bits, nbh, nbw, _ = k8_case(case)
    words = torch.from_numpy(words.view(np.int32)).to(cuda)
    bits = torch.from_numpy(bits).to(cuda)
    before = _build.LAUNCHES["merge_rows"]
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw, ws)
    assert _build.LAUNCHES["merge_rows"] == before + 1
    s_p, sb_p = concat.merge_rows_plain(words, bits, nbh, nbw, ws)
    assert torch.equal(seg_bits, sb_p) and torch.equal(segs, s_p)


@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_encode_matches_cpu_in_int32_mode(cuda, ss):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (61, 93, 3), np.uint8)
    for quality in (50, 100):
        cfg = jpegtpu_torch.EncodeConfig(quality=quality, subsampling=ss,
                                         dct_dtype="int32")
        assert jpegtpu_torch.encode_color(img, cfg) == (
            jpegtpu_torch.encode_color(img, cfg, device="cpu"))


def _streams(cuda, c, n, seed):
    """Random per-stream words [c, n] (zero past each stream's bits, as
    K4 and K5 store them) and bit counts [n], a third of them shorter
    than a byte."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, c * 32 + 1, n)
    short = rng.random(n) < 0.3
    bits[short] = rng.integers(0, 8, int(short.sum()))
    valid = (bits[None, :] - 32 * np.arange(c)[:, None]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 2**32, (c, n), dtype=np.int64) & keep
    return (torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(cuda),
            torch.from_numpy(bits.astype(np.int32)).to(cuda))


@pytest.mark.parametrize("seg_len", [1, 5, 128, 300])
@pytest.mark.parametrize("c,n", [(8, 1001), (48, 777), (1, 64)])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_stitch_matches_plain(cuda, seg_len, c, n, pad_ones):
    """K12 against its plain version: segments shorter than a word, many
    segments in one word, a ragged last segment, one segment."""
    words, bits = _streams(cuda, c, n, seg_len * 7 + c)
    got = stitch.stitch_segments(words, bits, seg_len, pad_ones)
    want = stitch.stitch_segments_plain(words, bits, seg_len, pad_ones)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def _edge_streams(cuda, c, n, seed):
    """Streams whose bit counts include 0, 1-31, multiples of a byte and
    of a word, c * 32 and past it (clamped), zero past their bits."""
    rng = np.random.default_rng(seed)
    bits = rng.choice(np.concatenate([
        np.arange(0, 32), [8, 16, 24, 32, 40, 64, c * 32, c * 32 + 9],
        rng.integers(0, c * 32 + 1, 8)]), n)
    valid = (np.minimum(bits, 32 * c)[None, :]
             - 32 * np.arange(c)[:, None]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 2**32, (c, n), dtype=np.int64) & keep
    return (torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(cuda),
            torch.from_numpy(bits.astype(np.int32)).to(cuda))


@pytest.mark.parametrize("seg_len", [1, 2, 37, "n"])
@pytest.mark.parametrize("c,n", [(2, 5003), (6, 1500)])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_stitch_edge_cases_match_plain(cuda, seg_len, c, n, pad_ones):
    """K12 over several tiles: empty and sub-word streams, segment totals
    that end on a byte and on a word, clamped streams; one K12 call is
    one launch of each of its two kernels."""
    seg_len = n if seg_len == "n" else seg_len
    words, bits = _edge_streams(cuda, c, n, seg_len + c)
    before = {k: _build.LAUNCHES[k] for k in ("stitch_scan",
                                              "stitch_segments")}
    got = stitch.stitch_segments(words, bits, seg_len, pad_ones)
    assert all(_build.LAUNCHES[k] == v + 1 for k, v in before.items())
    want = stitch.stitch_segments_plain(words, bits, seg_len, pad_ones)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [256, 3072, 8192])
@pytest.mark.parametrize("seg_len", [1, 50])
def test_stitch_tile_sizes_match_plain(cuda, monkeypatch, tile, seg_len):
    """K12 at other tile sizes: 256 streams (many tiles), and tiles whose
    scan needs more than 48 KB of shared memory (the launch opts in)."""
    monkeypatch.setattr(stitch, "stitch_tile", lambda n: tile)
    words, bits = _edge_streams(cuda, 3, 20011, tile + seg_len)
    got = stitch.stitch_segments(words, bits, seg_len)
    want = stitch.stitch_segments_plain(words, bits, seg_len)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_stream_concat_rows_past_48k_of_shared_memory(cuda):
    """K11 for images of 7,000 segments: the scan's 56 KB of shared memory
    takes the launch's opt-in."""
    p, n_images = 7000, 2
    segs, seg_bits = _segments(cuda, p * n_images, 1, 7)
    got = concat.stream_concat_rows(segs, seg_bits, p, p + 3)
    want = concat.stream_concat_rows_plain(segs, seg_bits, p, p + 3)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("seg_len", [1000, 2000])
def test_stitch_walks_past_the_halo(cuda, monkeypatch, seg_len):
    """A tile that ends inside a word, followed by more empty streams
    than its block scans: the word's last bits come from a stream that
    only the serial walk over the bit counts reaches."""
    monkeypatch.setattr(stitch, "stitch_tile", lambda n: 256)
    n = 1200
    bits = np.zeros(n, np.int32)
    bits[:255] = 3  # 765 bits: tile 0's last word starts at bit 736
    bits[855:] = 5
    words = np.zeros((1, n), np.uint32)
    words[0, bits == 3] = 0xA0000000
    words[0, bits == 5] = 0xD8000000
    got = stitch.stitch_segments(
        torch.from_numpy(words.view(np.int32)).to(cuda),
        torch.from_numpy(bits).to(cuda), seg_len)
    want = stitch.stitch_segments_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        seg_len)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a.cpu(), b)


def test_stitch_clamps_overflowed_streams(cuda):
    """Streams past C words (the encode will retry) count C * 32 bits,
    between 3-bit streams (zero past their bits, as K4 stores them)."""
    words = torch.full((2, 9), -1, dtype=torch.int32, device=cuda)
    bits = torch.full((9,), 100, dtype=torch.int32, device=cuda)
    bits[::2] = 3
    words[:, ::2] = 0
    words[0, ::2] = -(1 << 29)  # 0xE0000000: the top 3 bits
    got = stitch.stitch_segments(words, bits, 2)
    want = stitch.stitch_segments_plain(words, bits, 2)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def test_encode_blocks_with_optimal_tables_matches_plain(cuda):
    """K4 with runtime tables (the 2-pass optimal codes, up to 16 bits)
    against its plain version, at every rung."""
    rng = np.random.default_rng(12)
    img = torch.from_numpy(rng.integers(0, 256, (200, 264), np.uint8)).to(cuda)
    cfg = jpegtpu_torch.EncodeConfig(quality=90)
    state = tables.encoder_state(cfg, cuda)
    lv = transform.transform(img, state, True)
    dcd = dc_differences(lv[0], 7)
    _, (huff,) = pipeline.optimal_tables(
        symbol_histograms(lv[:, ::3].contiguous(), dcd[::3].contiguous()),
        ("lum",), cuda)
    for cap in (8, 16, 53):
        got = pack.encode_blocks(lv, dcd, huff, cap)
        want = pack.encode_blocks_plain(lv, dcd, huff, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kw", [
    {"restart_interval": 1}, {"restart_interval": 13},
    {"optimize_huffman": True},
    {"restart_interval": 4, "optimize_huffman": True, "quality": 100},
    {"subsampling": "420", "restart_interval": 1},
    {"subsampling": "422", "restart_interval": 5, "optimize_huffman": True},
    {"subsampling": "444", "optimize_huffman": True, "pad_ones": False},
])
def test_restart_and_two_pass_encode_match_cpu_in_int32_mode(cuda, kw):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (61, 93, 3), np.uint8)
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", **kw)
    encode = (jpegtpu_torch.encode_grayscale if cfg.n_components == 1
              else jpegtpu_torch.encode_color)
    assert encode(img, cfg) == encode(img, cfg, device="cpu")


@pytest.mark.parametrize("ws", [16, 32, 64, 128])
@pytest.mark.parametrize("cap", [8, 53])
@pytest.mark.parametrize("nbh,nbw", [(9, 64), (5, 100), (3, 300), (1, 7)])
def test_merge_rows_ws_matches_plain(cuda, ws, cap, nbh, nbw):
    """K8 at every segment width: several segments per thread block, a
    ragged last segment in a row, a row of fewer blocks than ws; overflowed
    blocks (bits past cap * 32) included."""
    words, bits = _streams(cuda, cap, nbh * nbw, ws + cap + nbw)
    bits[::11] = cap * 32 + 5
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw, ws)
    s_p, sb_p = concat.merge_rows_plain(words, bits, nbh, nbw, ws)
    assert torch.equal(seg_bits, sb_p) and torch.equal(segs, s_p)


def test_merge_rows_ws_at_the_top_color_rung(cuda):
    """4:2:0 MCU streams at cap 53 (E * cap = 318 words) in rows of 32
    MCUs: 41 KB of shared memory per 32-wide block, where a 128-wide
    segment takes 163 KB, near the card's limit."""
    words, bits = _streams(cuda, 318, 40 * 32, 318)
    segs, seg_bits = concat.merge_rows(words, bits, 40, 32, 32)
    s_p, sb_p = concat.merge_rows_plain(words, bits, 40, 32, 32)
    assert torch.equal(seg_bits, sb_p) and torch.equal(segs, s_p)


@pytest.mark.parametrize("segs_per_image,n_images", [(1, 7), (3, 5),
                                                     (64, 3), (378, 2)])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_stream_concat_rows_matches_plain(cuda, segs_per_image, n_images,
                                          pad_ones):
    """K11 on K8's segments: one segment per image, several, many (a
    2-image batch of the K6 route's 378); empty and sub-byte segments."""
    c, ws = 8, 32
    words, bits = _streams(cuda, c, n_images * segs_per_image * ws,
                           segs_per_image + n_images)
    segs, seg_bits = concat.merge_rows(words, bits, n_images * segs_per_image,
                                       ws, ws)
    seg_bits[::4] = 0
    segs[::4] = 0
    slab = segs_per_image * ws * c
    before = _build.LAUNCHES["stream_concat_rows"]
    got = concat.stream_concat_rows(segs, seg_bits, segs_per_image, slab,
                                    pad_ones)
    assert _build.LAUNCHES["stream_concat_rows"] == before + 1
    want = concat.stream_concat_rows_plain(segs, seg_bits, segs_per_image,
                                           slab, pad_ones)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _segments(cuda, nseg, sw, seed):
    """nseg segments of sw words, zero past each one's bits: empty ones,
    ones shorter than a word, and full ones."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, sw * 32 + 1, nseg)
    bits[rng.random(nseg) < 0.3] = 0
    bits[rng.random(nseg) < 0.3] = rng.integers(1, 32)
    bits[rng.random(nseg) < 0.1] = sw * 32
    valid = (bits[:, None] - 32 * np.arange(sw)[None, :]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 2**32, (nseg, sw), dtype=np.int64) & keep
    return (torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(cuda),
            torch.from_numpy(bits.astype(np.int32)).to(cuda))


@pytest.mark.parametrize("scan", ["shared", "global"])
@pytest.mark.parametrize("slab", [61, 1203, 4100])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_stream_concat_rows_odd_slabs_and_global_scan(cuda, monkeypatch, scan,
                                                     slab, pad_ones):
    """K11 with slabs of a word count that is not a multiple of 4 (no
    image but the first starts on a 16-byte line), tiles that cut the
    slab, and the second launch that images past the card's shared memory
    take (forced here by a smaller limit)."""
    p, n_images, sw = 40, 5, 3
    segs, seg_bits = _segments(cuda, p * n_images, sw, slab + p)
    seg_bits[p:2 * p] = 0  # an image with no bits
    segs[p:2 * p] = 0
    if scan == "global":
        monkeypatch.setattr(concat, "_smem_optin", lambda dev: 1024)
    got = concat.stream_concat_rows(segs, seg_bits, p, slab, pad_ones)
    want = concat.stream_concat_rows_plain(segs, seg_bits, p, slab, pad_ones)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("kw", [
    {}, {"quality": 100}, {"optimize_huffman": True},
    {"subsampling": "420"}, {"subsampling": "422", "pad_ones": False},
    {"subsampling": "444", "optimize_huffman": True},
    {"subsampling": "420", "optimize_huffman": True, "quality": 100},
])
def test_batch_encode_matches_cpu_in_int32_mode(cuda, kw):
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (61, 93, 3), np.uint8),
              rng.integers(0, 256, (61, 93), np.uint8),
              rng.integers(0, 256, (16, 1030), np.uint8),
              rng.integers(0, 256, (64, 64, 3), np.uint8)]
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", **kw)
    encode = (jpegtpu_torch.encode_grayscale_batch if cfg.n_components == 1
              else jpegtpu_torch.encode_color_batch)
    assert encode(images, cfg) == encode(images, cfg, device="cpu")


def test_batch_stages_through_a_pinned_ring(cuda, monkeypatch):
    """A 4:2:0 batch over several chunks of the ring (a 2-D image, sizes
    that are not whole MCUs, an image larger than a buffer) gives the CPU
    path's bytes, also on a mesh; the ring's buffers are pinned, and a
    second call pins no new one."""
    rng = np.random.default_rng(9)
    shapes = [(61, 93, 3), (61, 93), (64, 96, 3), (50, 90, 3), (61, 93, 3),
              (200, 330, 3)]
    images = [rng.integers(0, 256, s, np.uint8) for s in shapes]
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", subsampling="420")
    monkeypatch.setattr(transfer, "_CHUNK_BYTES", 2 * 64 * 96 * 3)
    monkeypatch.setattr(transfer, "_rings", {})
    with tracing.recording():
        got = jpegtpu_torch.encode_color_batch(images, cfg)
    assert tracing.totals()["counts"]["io.chunks"] == 3 + 1
    ring = transfer._rings[True]
    assert all(b.is_pinned() for b in ring.buffers)
    pinned = [b.data_ptr() for b in ring.buffers]
    assert jpegtpu_torch.encode_color_batch(images, cfg) == got
    assert jpegtpu_torch.encode_color_batch(
        images, cfg, mesh=["cuda:0"] * 2) == got
    assert [b.data_ptr() for b in ring.buffers] == pinned
    ring.copiers.shutdown()
    assert got == jpegtpu_torch.encode_color_batch(images, cfg, device="cpu")


@pytest.mark.parametrize("color", [True, False], ids=["420", "gray"])
def test_stream_matches_cpu_in_int32_mode(cuda, color, monkeypatch):
    """encode_stream's edge pad into the ring's pinned buffers over its
    copying threads (a 2-D image, sizes that are not whole blocks or
    MCUs, one of more than a band of rows) gives the CPU path's bytes:
    one chunk an image, both buffers pinned, and a second stream pins no
    new one."""
    rng = np.random.default_rng(10)
    images = [rng.integers(0, 256, s, np.uint8) for s in [
        (61, 93, 3), (61, 93), (300, 130, 3), (16, 1030), (64, 64, 3)]]
    cfg = jpegtpu_torch.EncodeConfig(
        dct_dtype="int32", subsampling="420" if color else "gray")
    monkeypatch.setattr(transfer, "_rings", {})
    with tracing.recording():
        got = jpegtpu_torch.encode_stream_list(images, cfg, color=color)
    assert tracing.totals()["counts"]["io.chunks"] == len(images)
    ring = transfer._rings[True]
    assert all(b.is_pinned() for b in ring.buffers)
    pinned = [b.data_ptr() for b in ring.buffers]
    assert jpegtpu_torch.encode_stream_list(images, cfg, color=color,
                                            depth=3) == got
    assert [b.data_ptr() for b in ring.buffers] == pinned
    ring.copiers.shutdown()
    assert got == jpegtpu_torch.encode_stream_list(images, cfg, color=color,
                                                   device="cpu")


@pytest.mark.parametrize("cap,nbw,tiles", [
    (8, 300, 1), (8, 300, 2), (8, 300, 5), (8, 300, 17),
    (53, 130, 1), (53, 130, 5), (53, 130, 17),
    (318, 200, 1), (318, 200, 2),
])
def test_stream_concat_chunked_matches_plain_and_k9(cuda, cap, nbw, tiles):
    """K10 against its plain version and against K9 on K8's segments, from
    a few hundred segments to a few thousand (2 * SMs * (tiles - 1) + SMs
    of them, the segment counts that once set K10's tiles), up to 4:2:0's
    top rung (318-word MCU streams). Ragged rows, sub-byte and empty
    segments; one launch a call."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    nbh = -(-(2 * sms * (tiles - 1) + sms) // -(-nbw // 128))
    words, bits = _streams(cuda, cap, nbh * nbw, cap + nbh)
    bits[: 2 * nbw] = 0  # two rows of empty segments
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
    n = concat.stream_words(nbh * nbw, cap)
    before = _build.LAUNCHES["stream_concat_chunked"]
    got, total = concat.stream_concat_chunked(segs, seg_bits, n)
    assert _build.LAUNCHES["stream_concat_chunked"] == before + 1
    want, want_total = concat.stream_concat_chunked_plain(segs, seg_bits, n,
                                                          tiles)
    k9, k9_total = concat.stream_concat(segs, seg_bits, n)
    assert total.dtype == torch.int64 and total.device.type == "cuda"
    assert int(total) == int(want_total) == int(k9_total)
    assert torch.equal(got, want) and torch.equal(got, k9)


def test_stream_concat_chunked_joins_segments_past_shared_memory(cuda):
    """K10 keeps no segment in shared memory: two segments of 58,880
    words (past what one thread block holds) join as K9 joins them."""
    segs, seg_bits = _segments(cuda, 2, 128 * 460, 11)
    n = 2 * 128 * 460 + 64
    got = concat.stream_concat_chunked(segs, seg_bits, n)
    want = concat.stream_concat(segs, seg_bits, n)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.parametrize("scan", ["shared", "global"])
@pytest.mark.parametrize("case", range(len(K10_CASES)))
def test_stream_concat_chunked_edges_match_plain(cuda, monkeypatch, case,
                                                 scan):
    """K10 on tests/kernel_edge_cases.py's segments: empty and sub-word
    segments, totals on a word boundary with no zeros after them, a
    partial last word, one-segment streams; with the scan in shared
    memory and in global scratch (forced by a smaller limit: two
    launches)."""
    segs, seg_bits, out_words = k10_case(case)
    if scan == "global":
        monkeypatch.setattr(concat, "_smem_optin", lambda dev: 256)
    s = torch.from_numpy(segs.view(np.int32)).to(cuda)
    b = torch.from_numpy(seg_bits).to(cuda)
    got, total = concat.stream_concat_chunked(s, b, out_words)
    want, want_total = concat.stream_concat_chunked_plain(s, b, out_words, 3)
    assert int(total) == int(want_total) and torch.equal(got, want)


def test_stream_concat_chunked_many_segments(cuda):
    """K10 over 6,000 segments: a scan of 48 KB of shared memory (past
    the default limit) and a grid of the card's resident blocks."""
    segs, seg_bits = _segments(cuda, 6000, 7, 12)
    n = 6000 * 7 + 100
    got = concat.stream_concat_chunked(segs, seg_bits, n)
    want = concat.stream_concat(segs, seg_bits, n)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.parametrize("cap", K7_CAPS)
@pytest.mark.parametrize("nb,n_elem", [(1, 64), (31, 64), (33, 64),
                                       (1000, 64), (300, 130), (40, 1)])
def test_pack_blocks_edges_match_plain(cuda, nb, n_elem, cap):
    """K7 on tests/kernel_edge_cases.py's elements: 96-bit elements at
    every residue, more long elements than the kernel stages, exact word
    ends and one bit past caps 1, 8 and 53; ragged warp tiles (31, 33),
    elements past one staged chunk (130). One launch a call, the
    overflow flag its own."""
    words_t, bits_t = k7_elements(nb, seed=nb + n_elem, n_elem=n_elem)
    w = torch.from_numpy(words_t.view(np.int32)).to(cuda)
    b = torch.from_numpy(bits_t).to(cuda)
    before = dict(_build.LAUNCHES)
    got = pack.pack_blocks(w, b, cap)
    assert {k for k in before if _build.LAUNCHES[k] != before[k]} == {
        "pack_blocks"}
    assert _build.LAUNCHES["pack_blocks"] == before["pack_blocks"] + 1
    want = pack.pack_blocks_plain(w, b, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[2]) == bool(want[2])
    # the next call on the stream starts from a reset flag
    quiet = pack.pack_blocks(w[:, :, -1:].contiguous(),
                             torch.zeros_like(b[:, -1:]), cap)
    assert not bool(quiet[2])


@pytest.mark.parametrize("cap", [1, 8, 16, 53])
@pytest.mark.parametrize("quality", [50, 100])
def test_pack_blocks_matches_plain(cuda, cap, quality):
    """K7 on the staged path's fused elements of a real block transform,
    every cap from one word (overflowing) to the top rung."""
    rng = np.random.default_rng(cap + quality)
    img = torch.from_numpy(rng.integers(0, 256, (72, 1032), np.uint8)).to(
        cuda)
    state = tables.encoder_state(
        jpegtpu_torch.EncodeConfig(quality=quality), cuda)
    lv = transform.transform(img, state, True)
    values, lengths = device.symbolize_elements64(lv.T)
    words_t, bits_t = treepack._fuse_subslots(values, lengths, 3)
    got = pack.pack_blocks(words_t, bits_t, cap)
    want = pack.pack_blocks_plain(words_t, bits_t, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("kw", [
    {}, {"fused": False}, {"fused": False, "capacity_words": 131 * 8},
    {"packer": "scatter"}, {"stuff": False, "seg_len": 5},
    {"stuff": False, "fused": False, "pad_ones": False},
    {"table_sel": "array"}, {"table_sel": "array", "dc_diff": True},
])
def test_encode_scan_device_matches_cpu(cuda, kw):
    rng = np.random.default_rng(9)
    zz = (rng.standard_normal((131, 64))
          * np.geomspace(6, 0.3, 64)[None, :]).astype(np.int32)
    kw = dict(kw)
    if kw.get("table_sel") == "array":
        kw["table_sel"] = (np.arange(131) % 6 >= 4).astype(np.int64)
    if kw.pop("dc_diff", None):
        kw["dc_diff"] = torch.from_numpy(
            np.diff(zz[:, 0], prepend=0).astype(np.int32))
    before = dict(_build.LAUNCHES)
    got = device.encode_scan_device(torch.from_numpy(zz).to(cuda), **kw)
    launched = {k for k in before if _build.LAUNCHES[k] > before[k]}
    if kw.get("packer") == "scatter":
        assert not launched
    elif kw.get("fused", True) and (not isinstance(kw.get("table_sel", 0),
                                                    np.ndarray)
                                    or "dc_diff" in kw):
        assert launched == {"encode_blocks", "merge_rows", "stream_concat"}
    else:
        assert launched == {"pack_blocks", "merge_rows", "stream_concat"}
    want = device.encode_scan_device(torch.from_numpy(zz), **kw)
    assert all(a.device.type == "cuda" for a in got)
    assert int(got[1]) == int(want[1]) and bool(got[2]) == bool(want[2])
    assert torch.equal(got[0].cpu(), want[0])


@pytest.mark.parametrize("kind", ["gray", "420"])
def test_encode_through_k10_matches_cpu_in_int32_mode(cuda, monkeypatch,
                                                      kind):
    """With the resident budget shrunk, small frames take K10's route on
    the card, byte-equal to the CPU path."""
    monkeypatch.setattr(concat, "VMEM_BUDGET", 64 << 10)
    rng = np.random.default_rng(4)
    if kind == "gray":
        img = rng.integers(0, 256, (200, 264), np.uint8)
        cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32")
        encode = jpegtpu_torch.encode_grayscale
    else:
        img = rng.integers(0, 256, (200, 264, 3), np.uint8)
        cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", subsampling="420")
        encode = jpegtpu_torch.encode_color
    before = dict(_build.LAUNCHES)
    got = encode(img, cfg)
    assert _build.LAUNCHES["stream_concat_chunked"] > before[
        "stream_concat_chunked"]
    assert _build.LAUNCHES["stream_concat"] == before["stream_concat"]
    assert got == encode(img, cfg, device="cpu")


@pytest.mark.parametrize("ss,nmch,nmcw", COLOR_SHAPES)
@pytest.mark.parametrize("quality,cap", [(50, 8), (100, 8), (100, 16),
                                         (100, 53)])
def test_merge_streams_matches_plain(cuda, ss, nmch, nmcw, quality, cap):
    """K6 against its plain version and K5 on the same K4 streams,
    overflowed blocks (Q100 noise at caps 8 and 16) included."""
    streams = _color_streams(cuda, ss, nmch, nmcw, quality, cap)
    sm = merge.slot_major_streams(*streams, nmch, nmcw, ss)
    before = _build.LAUNCHES["merge_streams"]
    got = merge.merge_streams(*sm)
    assert _build.LAUNCHES["merge_streams"] == before + 1
    want = merge.merge_streams_plain(*sm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    k5 = merge.merge_mcu(*streams, nmch, nmcw, ss)
    assert torch.equal(got[0], k5[0]) and torch.equal(got[1], k5[1])


def test_merge_streams_refuses_cpu_and_other_dtypes(cuda):
    w = torch.zeros((6, 8, 10), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        merge.merge_streams(w, torch.zeros((6, 10), dtype=torch.int32,
                                           device=cuda))


@pytest.mark.parametrize("kw,k6,k5", [
    ({"subsampling": "420"}, True, False),  # 264 kernel rows: not raw
    ({"subsampling": "420", "capacity_words_per_block": 16}, True, False),
    ({"subsampling": "444", "quality": 100}, True, True),  # rungs 8-53
    ({"subsampling": "422", "capacity_words_per_block": 76}, False, True),
])
def test_batch_k6_route_matches_cpu_in_int32_mode(cuda, kw, k6, k5):
    """Color batches that jpegtpu merges with K6 (up to cap 16, past its
    raw body) run K6 and not K5 on the card, byte-equal to the CPU path;
    past cap 16 K5 runs."""
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:4112, 0:64]
    smooth = (xx * 2 + yy // 8)[..., None] % 256
    images = [np.clip(smooth + rng.normal(0, 4 + 200 * (
        kw.get("quality") == 100), (4112, 64, 3)), 0, 255).astype(np.uint8)
        for _ in range(2)]
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", **kw)
    before = dict(_build.LAUNCHES)
    got = jpegtpu_torch.encode_color_batch(images, cfg)
    k6_runs = _build.LAUNCHES["merge_streams"] - before["merge_streams"]
    k5_runs = _build.LAUNCHES["merge_mcu"] - before["merge_mcu"]
    assert (k6_runs > 0, k5_runs > 0) == (k6, k5)
    assert got == jpegtpu_torch.encode_color_batch(images, cfg, device="cpu")


@pytest.mark.parametrize("kw", [
    {"subsampling": "420", "capacity_words_per_block": 76},
    {"capacity_words_per_block": 453},
    {"subsampling": "420", "capacity_words_per_block": 76,
     "optimize_huffman": True},
    {"capacity_words_per_block": 453, "restart_interval": 3},
])
def test_first_rung_past_the_card_matches_cpu_in_int32_mode(cuda, kw):
    """Rungs whose K8 segments would pass the card's shared memory run
    the kernels at 53 words, with rung 8's bytes."""
    rng = np.random.default_rng(9)
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", **kw)
    color = cfg.n_components == 3
    img = rng.integers(0, 256, (200, 264, 3) if color else (200, 264),
                       np.uint8)
    encode = (jpegtpu_torch.encode_color if color
              else jpegtpu_torch.encode_grayscale)
    got = encode(img, cfg)
    assert got == encode(img, cfg, device="cpu")
    assert got == encode(img, dataclasses.replace(
        cfg, capacity_words_per_block=8))


@pytest.mark.parametrize("kw", [
    {}, {"optimize_huffman": True}, {"subsampling": "420"},
    {"subsampling": "420", "optimize_huffman": True},
    {"restart_interval": 3}, {"subsampling": "422", "quality": 100},
])
def test_stuff_device_matches_host_stuffing(cuda, kw):
    """stuff="device": stuffed on the card at the single-segment encodes,
    the bytes of host stuffing."""
    rng = np.random.default_rng(10)
    cfg = jpegtpu_torch.EncodeConfig(stuff="device", **kw)
    color = cfg.n_components == 3
    img = rng.integers(0, 256, (96, 136, 3) if color else (96, 136),
                       np.uint8)
    encode = (jpegtpu_torch.encode_color if color
              else jpegtpu_torch.encode_grayscale)
    got = encode(img, cfg)
    assert b"\xff\x00" in got
    assert got == encode(img, dataclasses.replace(cfg, stuff="host"))


@pytest.mark.parametrize("kind,kw", [
    ("gray_batch", {"stuff": "device"}),
    ("420_batch", {"stuff": "device", "subsampling": "420"}),
    ("gray", {"dct_dtype": "float64"}),
    ("420", {"dct_dtype": "float16", "subsampling": "420"}),
])
def test_configs_jpegtpu_reads_as_the_default(cuda, kind, kw):
    """stuff="device" on a batch (ignored, as in jpegtpu) and float
    dct_dtypes other than float32 (the float32 path) give the default's
    bytes on the card."""
    rng = np.random.default_rng(11)
    cfg = jpegtpu_torch.EncodeConfig(**kw)
    color = cfg.n_components == 3
    images = [rng.integers(0, 256, (64, 96, 3) if color else (64, 96),
                           np.uint8) for _ in range(3)]
    base = jpegtpu_torch.EncodeConfig(subsampling=cfg.subsampling)
    if kind.endswith("batch"):
        encode = (jpegtpu_torch.encode_color_batch if color
                  else jpegtpu_torch.encode_grayscale_batch)
        assert encode(images, cfg) == encode(images, base)
    else:
        encode = (jpegtpu_torch.encode_color if color
                  else jpegtpu_torch.encode_grayscale)
        assert encode(images[0], cfg) == encode(images[0], base)


@pytest.mark.parametrize("pad_ones", [None, False, True])
@pytest.mark.parametrize("scan", ["shared", "global"])
@pytest.mark.parametrize("case", range(len(K9_CASES)))
def test_stream_concat_edges_match_plain(cuda, monkeypatch, case, scan,
                                         pad_ones):
    """K9 on tests/kernel_edge_cases.py's segments, with no pad, a pad of
    0s and one of 1s, against its plain version and apply_tail_padding:
    one launch (two with the scan in global scratch, forced by a smaller
    limit or, at 30,000 segments, by the card's), K10 with the same pad
    equal."""
    segs, seg_bits, out_words = k9_case(case)
    if scan == "global":
        monkeypatch.setattr(concat, "_smem_optin", lambda dev: 256)
    s = torch.from_numpy(segs.view(np.int32)).to(cuda)
    b = torch.from_numpy(seg_bits).to(cuda)
    before = _build.LAUNCHES["stream_concat"]
    got, total = concat.stream_concat(s, b, out_words, pad_ones)
    assert _build.LAUNCHES["stream_concat"] == before + 1
    want, want_total = concat.stream_concat_plain(s, b, out_words)
    if pad_ones is not None:
        want, want_total = concat.apply_tail_padding(want, want_total,
                                                     pad_ones)
    assert total.dtype == torch.int64 and total.device.type == "cuda"
    assert int(total) == int(want_total) and torch.equal(got, want)
    k10, k10_total = concat.stream_concat_chunked(s, b, out_words, pad_ones)
    assert int(k10_total) == int(want_total) and torch.equal(k10, want)


@pytest.mark.parametrize("blocks", [1, 7, 300])
def test_stream_concat_grids_match_plain(cuda, monkeypatch, blocks):
    """K9 on grids from one thread block to more than the stream has
    groups, padded with 1s."""
    segs, seg_bits, out_words = k9_case(0)
    monkeypatch.setattr(concat, "stream_concat_blocks",
                        lambda words, resident: blocks)
    s = torch.from_numpy(segs.view(np.int32)).to(cuda)
    b = torch.from_numpy(seg_bits).to(cuda)
    got, total = concat.stream_concat(s, b, out_words, True)
    want, want_total = concat.apply_tail_padding(
        *concat.stream_concat_plain(s, b, out_words), True)
    assert int(total) == int(want_total) and torch.equal(got, want)


@pytest.mark.parametrize("cap", [1, 8, 16, 17, 53])
@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_merge_mcu_edges_match_plain(cuda, ss, cap):
    """K5 on tests/kernel_edge_cases.py's MCUs (empty, full and
    overflowed slots, slots of a few bits sharing a word), at caps below,
    at and past the 8 words a block it stages (past them it reads the
    rest in its walk): one launch."""
    wy, by, wc, bc = k5_streams(9, 31, ss, cap, seed=cap)
    t = [torch.from_numpy(x.view(np.int32)).to(cuda)
         for x in (wy, by, wc, bc)]
    before = _build.LAUNCHES["merge_mcu"]
    got = merge.merge_mcu(*t, 9, 31, ss)
    assert _build.LAUNCHES["merge_mcu"] == before + 1
    want = merge.merge_mcu_plain(*t, 9, 31, ss)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _on_card_images(cuda, shapes, seed):
    """Images on the card in three layouts: contiguous, a planar [C, H, W]
    (or [W, H]) frame permuted, and a crop of every other column."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        t = torch.from_numpy(rng.integers(0, 256, s, np.uint8)).to(cuda)
        if i % 3 == 1:
            t = (t.permute(2, 0, 1).contiguous().permute(1, 2, 0)
                 if t.dim() == 3 else t.T.contiguous().T)
        elif i % 3 == 2:
            big = torch.zeros((s[0] + 1, 2 * s[1] + 3, *s[2:]),
                              dtype=torch.uint8, device=cuda)
            big[1:, 2::2][:, :s[1]] = t
            t = big[1:, 2::2][:, :s[1]]
        out.append(t)
    return out


@pytest.mark.parametrize("shapes,stack", [
    ([(13, 21), (16, 24), (1, 1), (7, 9)], (16, 24)),
    ([(13, 21, 3), (9, 24, 3), (16, 17, 3), (1, 1, 3)], (16, 24, 3)),
    ([(13, 21), (16, 24, 3), (5, 3), (16, 24)], (16, 24, 3)),
    ([(1080, 1920, 3)] * 2 + [(1079, 1913, 3)], (1088, 1920, 3)),
    ([(30, 41, 3), (32, 40)] * 35, (32, 48, 3)),  # two launches of 64 + 6
])
def test_stage_images_matches_plain(cuda, shapes, stack):
    """K13 against its twin on contiguous, planar-permuted and cropped
    images; one launch per 64 images."""
    images = _on_card_images(cuda, shapes, len(shapes))
    before = _build.LAUNCHES["stage_images"]
    got = stage.stage_images(images, stack)
    assert _build.LAUNCHES["stage_images"] == before + -(-len(images) // 64)
    assert torch.equal(got, stage.stage_images_plain(images, stack))


@pytest.mark.parametrize("kw", [
    {"subsampling": "420"}, {"subsampling": "420", "quality": 75},
    {}, {"subsampling": "420", "optimize_huffman": True},
    {"subsampling": "444", "restart_interval": 3},
])
def test_card_tensor_batches_equal_numpy_batches(cuda, kw):
    """Card tensors in three layouts, alone and mixed with numpy arrays
    and CPU tensors, give the numpy batch's files; the batch stages them
    with no host sync; the single-image entries give their numpy input's
    files too."""
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32", **kw)
    shapes = [(61, 93, 3), (61, 93, 3), (61, 93), (40, 70, 3), (64, 64, 3)]
    if cfg.n_components == 1:
        shapes = [s[:2] for s in shapes]
    images = _on_card_images(cuda, shapes, 8)
    arrays = [im.cpu().numpy() for im in images]
    encode = (jpegtpu_torch.encode_grayscale_batch if cfg.n_components == 1
              else jpegtpu_torch.encode_color_batch)
    want = encode(arrays, cfg)
    assert want == encode(arrays, cfg, device="cpu")
    assert encode(images, cfg) == want
    mixed = [arrays[0], images[1], torch.from_numpy(arrays[2]), images[3],
             images[4]]
    assert encode(mixed, cfg) == want
    single = (jpegtpu_torch.encode_grayscale if cfg.n_components == 1
              else jpegtpu_torch.encode_color)
    assert [single(im, cfg) for im in images[:3]] == [
        single(im, cfg) for im in arrays[:3]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stack = transfer.stage(images[:2], (64, 96, *shapes[0][2:]), cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(stack, stage.stage_images_plain(
        images[:2], (64, 96, *shapes[0][2:])))
