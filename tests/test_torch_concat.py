"""K8 + K9 (jpegtpu_torch.entropy.concat) against jpegtpu's Pallas
`merge_sublanes_pallas` / `concat_raw_pallas` (interpret mode) and
`treepack._apply_tail_padding`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.entropy import pallas_concat, treepack
from jpegtpu.ops import pallas_transform as pt

import jpegtpu_torch
from jpegtpu_torch import tables
from jpegtpu_torch.entropy import concat, pack

HUFF = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu").huff


def _block_streams(rng, nb, cap):
    """Per-block streams of random sparse levels, packed by the port's K4."""
    zz = np.zeros((nb, 64), np.int32)
    for i in range(nb):
        k = rng.integers(0, 10)
        pos = rng.choice(40, size=k, replace=False) if k else []
        zz[i, pos] = rng.integers(-31, 32, size=k)
    zz[:, 0] = rng.integers(-40, 40, size=nb)
    dcd = np.concatenate([zz[:1, 0], np.diff(zz[:, 0])]).astype(np.int32)
    return pack.encode_blocks(
        torch.from_numpy(zz.T.copy()), torch.from_numpy(dcd), HUFF, cap
    )


def _to_raw(rows, nbh, nbw, ncg):
    """[C, nb] scan order -> jpegtpu's [G, C, 8, 128] grid-natural tiling."""
    return np.stack(
        [np.asarray(pt.scan_to_raw(jnp.asarray(r), nbh, nbw, ncg))
         for r in rows], axis=1,
    )


@pytest.mark.parametrize(
    "nbh,nbw,ncg,cap",
    [(8, 128, 1, 8), (11, 200, 2, 8), (16, 256, 2, 6), (3, 40, 1, 8)],
)
def test_plain_matches_pallas_concat(nbh, nbw, ncg, cap):
    rng = np.random.default_rng(nbh * 1000 + nbw)
    words, bits = _block_streams(rng, nbh * nbw, cap)
    w_u32 = words.numpy().view(np.uint32)
    w_raw = _to_raw(w_u32, nbh, nbw, ncg)
    b_raw = _to_raw(bits.numpy()[None], nbh, nbw, ncg)[:, 0]

    # K8: each (block row, 128-column group) row segment
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
    ref = np.asarray(pallas_concat.merge_sublanes_pallas(
        jnp.asarray(w_raw), jnp.asarray(b_raw), interpret=True))
    g, _, sr, lanes = ref.shape
    ref = ref.reshape(g // ncg, ncg, 8, sr * lanes).transpose(0, 2, 1, 3)
    ref = ref.reshape(-1, sr * lanes)[: nbh * ncg]
    np.testing.assert_array_equal(segs.numpy().view(np.uint32), ref)
    lane_bits = np.zeros((nbh, ncg * 128), np.int64)
    lane_bits[:, :nbw] = bits.numpy().reshape(nbh, nbw)
    np.testing.assert_array_equal(
        seg_bits.numpy(), lane_bits.reshape(-1, 128).sum(1))

    # K9 and tail padding: the whole scan stream
    stream, total = concat.concat_stream(words, bits, nbh, nbw)
    ref_words, ref_total = pallas_concat.concat_raw_pallas(
        jnp.asarray(w_raw), jnp.asarray(b_raw), nbh, nbw, ncg, interpret=True)
    assert stream.shape[0] == ref_words.shape[0]
    assert int(total) == int(ref_total)
    np.testing.assert_array_equal(
        stream.numpy().view(np.uint32), np.asarray(ref_words))
    for pad_ones in (True, False):
        got, got_total = concat.apply_tail_padding(
            stream.clone(), total, pad_ones)
        want, want_total = treepack._apply_tail_padding(
            ref_words, ref_total, pad_ones)
        assert int(got_total) == int(want_total)
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), np.asarray(want))


def test_merge_rows_clamps_overflowed_blocks():
    """A block past cap words (the encode will retry) deposits at most
    cap * 32 bits, so the segment never overruns."""
    cap, nbw = 2, 130
    words = torch.full((cap, nbw), -1, dtype=torch.int32)
    bits = torch.full((nbw,), 5 * 32, dtype=torch.int32)
    segs, seg_bits = concat.merge_rows(words, bits, 1, nbw)
    assert seg_bits.tolist() == [128 * cap * 32, 2 * cap * 32]
    full = segs.numpy().view(np.uint32)
    assert (full[0, : 128 * cap] == 0xFFFFFFFF).all()
    assert (full[0, 128 * cap:] == 0).all()
    assert (full[1, : 2 * cap] == 0xFFFFFFFF).all()
