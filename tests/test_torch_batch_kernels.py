"""K8 at segment widths below 128 and K11 (jpegtpu_torch.entropy.concat)
against jpegtpu's Pallas `merge_sublanes_pallas(ws=...)` and
`concat_segments_pallas` (interpret mode) and
`treepack.apply_tail_padding_segments`; the batch's geometry rules
against jpegtpu.batch's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu import batch as jbatch
from jpegtpu.config import EncodeConfig as JConfig
from jpegtpu.entropy import pallas_concat, treepack

import jpegtpu_torch
from jpegtpu_torch import batch, tables
from jpegtpu_torch.entropy import concat, pack

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

HUFF = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu").huff


def _block_streams(rng, nb, cap):
    """Per-block streams of random sparse levels, packed by the port's K4
    (words past each block's bits are zero), none past cap words."""
    zz = np.zeros((nb, 64), np.int32)
    for i in range(nb):
        k = rng.integers(0, 8)
        pos = rng.choice(50, size=k, replace=False) if k else []
        zz[i, pos] = rng.integers(-31, 32, size=k)
    zz[:, 0] = rng.integers(-200, 200, size=nb)
    dcd = np.concatenate([zz[:1, 0], np.diff(zz[:, 0])]).astype(np.int32)
    words, bits = pack.encode_blocks(
        torch.from_numpy(zz.T.copy()), torch.from_numpy(dcd), HUFF, cap)
    assert int(bits.max()) <= cap * 32
    return words, bits


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("ws,nbh,nbw,cap", [
    (16, 8, 100, 8), (32, 11, 70, 16), (64, 5, 64, 16),
])
def test_merge_rows_ws_matches_pallas(ws, nbh, nbw, cap):
    """Segment (br, c) is jpegtpu's chunk c of lane row br: the same words
    (jpegtpu's chunk holds cr * 128 >= ws * cap + cap + 2 words, the
    port's ws * (cap + 1); past the bits both are zero) and bit counts."""
    rng = np.random.default_rng(ws * 100 + nbw)
    words, bits = _block_streams(rng, nbh * nbw, cap)
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw, ws)
    per_row = -(-nbw // ws)
    assert segs.shape == (nbh * per_row, ws * (cap + 1))

    g = -(-nbh // 8)  # jpegtpu's [G, cap, 8, 128] lane tiling, ncg = 1
    w_raw = np.zeros((cap, g * 8, 128), np.uint32)
    w_raw[:, :nbh, :nbw] = _u32(words).reshape(cap, nbh, nbw)
    b_raw = np.zeros((g * 8, 128), np.int32)
    b_raw[:nbh, :nbw] = bits.numpy().reshape(nbh, nbw)
    ref = np.asarray(pallas_concat.merge_sublanes_pallas(
        jnp.asarray(w_raw.reshape(cap, g, 8, 128).transpose(1, 0, 2, 3)),
        jnp.asarray(b_raw.reshape(g, 8, 128)), ws=ws, interpret=True))
    nc = 128 // ws
    ref = ref.reshape(g * 8, nc, -1)[:nbh, :per_row].reshape(nbh * per_row, -1)
    n = min(ref.shape[1], segs.shape[1])
    np.testing.assert_array_equal(_u32(segs)[:, :n], ref[:, :n])
    assert not _u32(segs)[:, n:].any() and not ref[:, n:].any()
    np.testing.assert_array_equal(
        seg_bits.numpy(), b_raw[:nbh].reshape(nbh, nc, ws).sum(-1)
        [:, :per_row].reshape(-1))


@pytest.mark.parametrize("ws", [128, 32])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_concat_segments_matches_pallas(ws, pad_ones):
    """K8 + K11 + tail padding: per-image streams equal jpegtpu's
    concat_segments_pallas (rows of 128 blocks, per-segment streaming
    concat) and apply_tail_padding_segments, whatever the port's segment
    width, since a stream is its blocks back to back."""
    rng = np.random.default_rng(ws)
    n_images, seg_slots, cap = 3, 256, 8
    words, bits = _block_streams(rng, n_images * seg_slots, cap)
    ref, ref_tot = pallas_concat.concat_segments_pallas(
        jnp.asarray(_u32(words)), jnp.asarray(bits.numpy()), seg_slots,
        seg_slots * cap, interpret=True)
    ref, ref_tot = treepack.apply_tail_padding_segments(ref, ref_tot,
                                                        pad_ones)
    nbw = ws  # the port's grid: seg_slots / ws rows of ws blocks per image
    streams, totals = concat.concat_segments(
        words, bits, n_images * seg_slots // nbw, nbw, n_images, ws, pad_ones)
    assert streams.shape == (n_images, seg_slots * cap)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(ref_tot))
    np.testing.assert_array_equal(_u32(streams), np.asarray(ref))


@pytest.mark.parametrize("pad_ones", [True, False])
def test_tail_padding_segments_matches_treepack(pad_ones):
    rng = np.random.default_rng(7)
    streams = rng.integers(0, 1 << 32, (9, 6), dtype=np.uint64).astype(
        np.uint32)
    # every residue mod 8, word edges, and a stream that fills its words
    totals = np.array([0, 1, 7, 8, 31, 32, 100, 187, 6 * 32], np.int32)
    for i, t in enumerate(totals.tolist()):  # bits past each total are 0
        streams[i, -(-t // 32):] = 0
        if t % 32:
            streams[i, t // 32] &= np.uint32(0xFFFFFFFF << (32 - t % 32)
                                             & 0xFFFFFFFF)
    want, want_tot = treepack.apply_tail_padding_segments(
        jnp.asarray(streams), jnp.asarray(totals), pad_ones)
    got, got_tot = concat.apply_tail_padding_segments(
        torch.from_numpy(streams.view(np.int32).copy()),
        torch.from_numpy(totals.astype(np.int64)), pad_ones)
    np.testing.assert_array_equal(got_tot.numpy(), np.asarray(want_tot))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_stream_concat_rows_plain_places_each_image_in_its_slab():
    """Hand-made segments: image 0 of two segments (5 + 33 bits), image 1
    of one empty and one 9-bit segment."""
    segs = torch.zeros((4, 3), dtype=torch.int32)
    segs[0, 0] = pack.to_int32(torch.tensor(0b10101 << 27))
    segs[1, 0], segs[1, 1] = -1, pack.to_int32(torch.tensor(1 << 31))
    segs[3, 0] = pack.to_int32(torch.tensor(0b101010101 << 23))
    seg_bits = torch.tensor([5, 33, 0, 9], dtype=torch.int32)
    streams, totals = concat.stream_concat_rows(segs, seg_bits, 2, 4)
    assert totals.tolist() == [40, 16]
    got = _u32(streams)
    assert got[0, :2].tolist() == [(0b10101 << 27) | (0xFFFFFFFF >> 5),
                                   0xFF << 24]
    assert got[1, 0] == (0b101010101 << 23) | (0x7F << 16)
    assert not got[:, 2:].any() and not got[1, 1:].any()


def test_stream_concat_rows_checks_its_shapes():
    segs = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="images of 2 segments"):
        concat.stream_concat_rows(segs, torch.zeros(5, dtype=torch.int32),
                                  2, 8)
    with pytest.raises(ValueError, match="segment width 8"):
        concat.merge_rows(torch.zeros((2, 16), dtype=torch.int32),
                          torch.zeros(16, dtype=torch.int32), 1, 16, 8)


@pytest.mark.parametrize("ws", [16, 64])
def test_merge_rows_ws_clamps_overflowed_blocks(ws):
    """A block past cap words (the encode will retry) deposits at most
    cap * 32 bits, so a narrow segment never overruns either."""
    cap, nbw = 2, ws + 3
    words = torch.full((cap, nbw), -1, dtype=torch.int32)
    bits = torch.full((nbw,), 5 * 32, dtype=torch.int32)
    segs, seg_bits = concat.merge_rows(words, bits, 1, nbw, ws)
    assert seg_bits.tolist() == [ws * cap * 32, 3 * cap * 32]
    full = _u32(segs)
    assert (full[0, : ws * cap] == 0xFFFFFFFF).all()
    assert (full[0, ws * cap:] == 0).all()
    assert (full[1, : 3 * cap] == 0xFFFFFFFF).all()
    assert (full[1, 3 * cap:] == 0).all()


# (ph, pw) padded shapes around every edge of the rules: narrow and wide
# rows, 2 and 3 column groups, 256 kernel rows per image and past them
SHAPES = [(16, 16), (64, 512), (512, 512), (48, 760), (64, 1368), (40, 200),
          (2048, 512), (2112, 16), (2048, 1032), (1024, 2048), (3024, 4032),
          (704, 3072), (1024, 8192), (2048, 4096), (256, 16384)]


@pytest.mark.parametrize("ph,pw", SHAPES)
def test_sharing_rules_match_jpegtpu(ph, pw):
    for cap in (8, 16, 53):
        for bsz in (8, 16):  # jpegtpu rounds its batch to the packing ratio
            assert batch.shares_gray_tables(ph, pw, cap) == (
                jbatch._gray_raw_ok(bsz, ph, pw, JConfig(), cap))
            for ss, fy, fx in (("420", 2, 2), ("422", 1, 2), ("444", 1, 1)):
                cph = -(-ph // (8 * fy)) * 8 * fy
                cpw = -(-pw // (8 * fx)) * 8 * fx
                assert batch.color_raw_ok(cph, cpw, ss, cap) == (
                    jbatch._color_raw_ok(bsz, cph, cpw,
                                         JConfig(subsampling=ss), cap))
    nbw = pw // 8
    wsb, r, _ = jbatch._slot_geom(nbw)
    assert batch.segment_width(nbw) == (wsb if r > 1 else 128)
