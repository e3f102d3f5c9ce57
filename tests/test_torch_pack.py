"""K4 (jpegtpu_torch.entropy.pack) against jpegtpu's Pallas
`encode_blocks_pallas` (interpret mode) and jpegtpu's host coder."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu import tables as jtables
from jpegtpu.entropy import host as jhost
from jpegtpu.entropy import pallas_pack

import jpegtpu_torch
from jpegtpu_torch import tables
from jpegtpu_torch.entropy import pack

HUFF = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu").huff


def _levels(seed: int, nb: int = 300) -> np.ndarray:
    """Sparse photographic-like blocks, then the stress cases: long zero
    runs (one, two and three ZRLs, a nonzero at 63), maximal amplitudes
    (|AC| 1023 and DC steps of 2047), an all-zero block, and one block
    whose 63 maximal ACs overflow any cap below 53."""
    rng = np.random.default_rng(seed)
    zz = np.zeros((nb, 64), np.int32)
    for i in range(nb):
        k = rng.integers(0, 12)
        pos = rng.choice(np.arange(1, 64), size=k, replace=False)
        zz[i, pos] = rng.integers(-40, 41, size=k)
    zz[:, 0] = rng.integers(-60, 60, size=nb)
    zz[10, [17, 50, 63]] = [3, -2, 1]  # runs of 15, 32 and 12 zeros
    zz[11, [49]] = [-7]  # three ZRLs, then EOB
    zz[12, 1:] = 0
    zz[13, 1:] = np.where(np.arange(63) % 2, 1023, -1023)
    zz[14, 63] = -1023
    zz[15, 0], zz[16, 0] = 1023, -1024  # DC differences of -2047 / 2047
    zz[20, :] = 0
    return zz


def _dc_diff(zz):
    return np.concatenate([zz[:1, 0], np.diff(zz[:, 0])]).astype(np.int32)


@pytest.mark.parametrize("cap", [8, 16])
def test_plain_matches_pallas_pack(cap):
    zz = _levels(cap)
    dcd = _dc_diff(zz)
    w_ref, b_ref, _ = pallas_pack.encode_blocks_pallas(
        jnp.asarray(zz), jnp.asarray(dcd), cap=cap, table=0, interpret=True
    )
    words, bits = pack.encode_blocks(
        torch.from_numpy(zz.T.copy()), torch.from_numpy(dcd), HUFF, cap
    )
    assert words.shape == (cap, zz.shape[0]) and words.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(b_ref))
    assert bits[13] > cap * 32  # the overflowing block counts every bit
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32), np.asarray(w_ref)
    )


def _host_block_streams(zz):
    """Per-block (value, nbits) bit strings from jpegtpu's host coder."""
    symbols, amps, amp_bits, is_dc, block_of = jhost.symbolize(zz)
    luts = jtables.huffman_luts()
    out = [[0, 0] for _ in range(zz.shape[0])]
    for s, a, ab, dc, b in zip(symbols, amps, amp_bits, is_dc, block_of):
        codes, lens = luts["dc_lum" if dc else "ac_lum"]
        n = int(lens[s]) + int(ab)
        out[b][0] = (out[b][0] << n) | (int(codes[s]) << int(ab)) | int(a)
        out[b][1] += n
    return out


def test_plain_at_top_rung_matches_host_coder():
    zz = _levels(53)
    cap = jpegtpu_torch.pipeline.MAX_WORDS_PER_BLOCK
    words, bits = pack.encode_blocks(
        torch.from_numpy(zz.T.copy()), torch.from_numpy(_dc_diff(zz)), HUFF,
        cap,
    )
    w = words.numpy().view(np.uint32)
    for i, (val, nbits) in enumerate(_host_block_streams(zz)):
        assert int(bits[i]) == nbits
        got = 0
        for j in range(cap):
            got = (got << 32) | int(w[j, i])
        assert got >> (32 * cap - nbits) == val
        assert got & ((1 << (32 * cap - nbits)) - 1) == 0  # zero past bits
