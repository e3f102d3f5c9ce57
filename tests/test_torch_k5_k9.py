"""Numpy models of the index arithmetic of K5 (csrc/merge.cu, merge_mcu)
and K9 (csrc/concat.cu, stream_concat, with its tail padding), held word
for word against the kernels' plain versions on the CPU, on
tests/kernel_edge_cases.py's adversarial inputs; and K9 with the pad
against jpegtpu's concat_raw_pallas (interpret mode) and
treepack._apply_tail_padding.

The CUDA kernels run only on a card (tests/test_torch_gpu.py holds them
against the same plain versions there). These models follow the kernels'
own steps. K5: a thread an MCU; its E bit counts clamped to cap * 32; an
asynchronous copy of each of the first 16 words of a block that hold
bits; the walk through the 64-bit accumulator, a block's later words
copied 16 at a time as the walk reaches them; the zeros past the MCU's
bits. The word-parallel K5 of tools/k5_word_parallel.cu: T threads an
MCU, thread g taking words g, g + T, ...; each word below the MCU's
total from the slot holding its first bit (found by E compares) and the
slots after it. K9: the scan, each thread block's share of the words
that hold bits or the pad and of the zeros past them, each 4-word
group's covering segment (one segment's five words, or the walk across
segment ends that also sets the pad's 1s), and the total rounded up to
the byte. Each model checks that every output word is written exactly
once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.entropy import pallas_concat, treepack
from jpegtpu.ops import pallas_transform as pt

from jpegtpu_torch.entropy import concat, merge

from kernel_edge_cases import K9_CASES, SAMPLING, k5_streams, k9_case
from test_torch_k7_k10 import _Once2D, _share, _words4
from test_torch_stream_joins import _groups, _Once, _rows_word, _top
from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

MASK = 0xFFFFFFFF


# --- K5 ------------------------------------------------------------------

STAGED = 16  # csrc/merge.cu kStaged: words a block K5 stages, at most


def _mcu_blocks(m, nmcw, nmcu, fy, fx):
    """Raster index of MCU m's E blocks: luma in (dy, dx) order, then Cb
    and Cr."""
    my, mx = divmod(m, nmcw)
    return [(fy * my + s // fx) * (fx * nmcw) + fx * mx + s % fx
            for s in range(fy * fx)] + [m, nmcu + m]


def k5_model(wy, by, wc, bc, nmch, nmcw, subsampling):
    """-> (frame [E * cap, nmcu] uint32, bits [nmcu], words copied before
    the walk, words copied in it), as the kernel's threads compute them:
    the clamped counts; an asynchronous copy of each of the first
    min(cap, STAGED) words of a block that hold bits into the thread's
    rows; the walk through the 64-bit accumulator, a block's words past
    STAGED copied STAGED at a time into its rows as the walk reaches them;
    the zeros past the MCU's bits."""
    fy, fx = SAMPLING[subsampling]
    ky, e, cap = fy * fx, fy * fx + 2, wy.shape[0]
    nmcu = nmch * nmcw
    staged = min(cap, STAGED)
    out, bits = _Once2D(e * cap, nmcu), np.zeros(nmcu, np.int64)
    before = during = 0
    for m in range(nmcu):
        blocks = _mcu_blocks(m, nmcw, nmcu, fy, fx)

        def word(s, k):
            assert k < cap, "a load past the block's cap words"
            return int((wy if s < ky else wc)[k, blocks[s]])

        n = [min(int((by if s < ky else bc)[blocks[s]]), 32 * cap)
             for s in range(e)]
        rows = {}  # (slot, row) -> (word index, word)
        for s in range(e):
            for k in range(staged):
                if 32 * k < n[s]:
                    rows[(s, k)] = (k, word(s, k))
                    before += 1
        acc, nacc, widx = 0, 0, 0
        for s in range(e):
            k, b = 0, n[s]
            while b > 0:
                if k >= STAGED and k % STAGED == 0:
                    for i in range(STAGED):
                        if 32 * (k + i) < n[s]:
                            rows[(s, i)] = (k + i, word(s, k + i))
                            during += 1
                held, x = rows[(s, k % STAGED)]
                assert held == k, "a row read before its word arrived"
                ln = min(b, 32)
                acc |= (x >> (32 - ln)) << (64 - nacc - ln)
                nacc += ln
                if nacc >= 32:
                    out.put2(widx, m, acc >> 32)
                    widx += 1
                    acc = (acc << 32) & ((1 << 64) - 1)
                    nacc -= 32
                k, b = k + 1, b - 32
        if nacc:
            out.put2(widx, m, acc >> 32)
            widx += 1
        for j in range(widx, e * cap):
            out.put2(j, m, 0)
        bits[m] = sum(n)
    return out.result2(), bits, before, during


def _mcu_word(j, ends, word):
    """The word-parallel design's mcu_word: word j of an MCU's stream (32
    j < its total), from the slot holding bit 32 j and the slots after
    it; returns the word and the slots it read."""
    p, wend, v, read = 32 * j, 32 * j + 32, 0, 0
    s = sum(int(e <= p) for e in ends)  # E compares
    while s < len(ends) and p < wend:
        start, end = (ends[s - 1] if s else 0), ends[s]
        if end > p:
            stop = min(end, wend)
            q, ln = p - start, stop - p
            k, r = q >> 5, q & 31
            x = (word(s, k) << r) & MASK
            if r + ln > 32:
                x |= word(s, k + 1) >> (32 - r)
            v |= (x & _top(ln)) >> (p - 32 * j)
            read += 1
            p = stop
        s += 1
    return v, read


def k5_words_model(wy, by, wc, bc, nmch, nmcw, subsampling, groups):
    """tools/k5_word_parallel.cu -> (frame, bits, the slots each built
    word read): T = groups threads an MCU, thread g taking words g, g + T,
    ..., each from the slots covering its 32 bits."""
    fy, fx = SAMPLING[subsampling]
    ky, e, cap = fy * fx, fy * fx + 2, wy.shape[0]
    nmcu = nmch * nmcw
    out, bits, reads = _Once2D(e * cap, nmcu), np.zeros(nmcu, np.int64), []
    for m in range(nmcu):
        blocks = _mcu_blocks(m, nmcw, nmcu, fy, fx)

        def word(s, k):
            assert k < cap, "a load past the block's cap words"
            return int((wy if s < ky else wc)[k, blocks[s]])

        ends = np.cumsum([min(int((by if s < ky else bc)[blocks[s]]),
                              32 * cap) for s in range(e)]).tolist()
        total = ends[-1]
        for g in range(groups):
            for j in range(g, e * cap, groups):
                v = 0
                if 32 * j < total:
                    v, read = _mcu_word(j, ends, word)
                    reads.append(read)
                out.put2(j, m, v)
        bits[m] = total
    return out.result2(), bits, reads


def _plain_k5(wy, by, wc, bc, nmch, nmcw, subsampling):
    w, b = merge.merge_mcu_plain(
        torch.from_numpy(wy.view(np.int32)), torch.from_numpy(by),
        torch.from_numpy(wc.view(np.int32)), torch.from_numpy(bc), nmch,
        nmcw, subsampling)
    return w.numpy().view(np.uint32), b.numpy()


@pytest.mark.parametrize("cap", [1, 8, 16, 17, 53])
@pytest.mark.parametrize("subsampling", ["420", "422", "444"])
def test_k5_model_matches_plain(subsampling, cap):
    """The edge MCUs (empty, full and overflowed slots, slots of a few
    bits sharing a word, slot ends on and off word boundaries) and random
    ones, at caps below, at and past the words K5 stages before its walk:
    past them (caps 17 and 53, full blocks) the walk copies the rest in
    chunks."""
    nmch, nmcw = 3, 7
    streams = k5_streams(nmch, nmcw, subsampling, cap, seed=5)
    want_w, want_b = _plain_k5(*streams, nmch, nmcw, subsampling)
    got_w, got_b, before, during = k5_model(*streams, nmch, nmcw,
                                            subsampling)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_w, want_w)
    assert before and (during > 0) == (cap > STAGED)


@pytest.mark.parametrize("groups", [1, 5, 6, 48])
@pytest.mark.parametrize("subsampling", ["420", "422", "444"])
def test_k5_word_parallel_model_matches_plain(subsampling, groups):
    """The word-parallel design at one thread an MCU, T that do and do not
    divide E * cap, and one thread a word (T past E * cap at 4:4:4: its
    last threads idle)."""
    nmch, nmcw, cap = 3, 7, 8
    streams = k5_streams(nmch, nmcw, subsampling, cap, seed=5)
    want_w, want_b = _plain_k5(*streams, nmch, nmcw, subsampling)
    got_w, got_b, reads = k5_words_model(*streams, nmch, nmcw, subsampling,
                                         groups)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_w, want_w)
    # words that took one slot, two, and more than two (short slots)
    assert {1, 2} <= set(reads) and max(reads) > 2


def test_k5_edge_streams_cover_the_edges():
    """The edge MCUs' slot counts, and blocks past cap * 32 bits."""
    wy, by, wc, bc = k5_streams(2, 6, "420", 8, seed=0)
    assert (by > 8 * 32).any() and (bc > 8 * 32).any()
    assert (by == 0).any() and ((bc > 0) & (bc < 32)).any()
    # words past a block's bits are zero, an overflowed block's all full
    assert (wy[:, by == 0] == 0).all()
    assert (wy[:, by > 8 * 32] != 0).all(axis=0).mean() > 0.9


# --- K9 ------------------------------------------------------------------

def _build_group(d0, d1, s, inc, segs, padded, pad_ones, fast):
    """join_stream's group: words [d0, d1) from segment s (the one holding
    bit 32 d0, or S past the bits): one segment's five words when it holds
    all 128 bits, else word by word across segment ends, then the pad."""
    off = int(inc[s - 1]) if s else 0
    if d1 - d0 == 4 and s < len(inc) and 32 * d0 + 128 <= inc[s]:
        fast.append(s)
        return _words4(segs[s], 32 * d0 - off)
    vals = []
    for d in range(d0, d1):
        v, s = _rows_word(d, s, inc, segs, 0, padded, pad_ones)
        vals.append(v)
    return vals


def k9_model(segs, seg_bits, out_words, blocks, pad_ones):
    """join_stream (csrc/concat.cu) over `blocks` thread blocks ->
    (stream, total, groups built from one segment)."""
    inc = np.cumsum(seg_bits.astype(np.int64))
    total = int(inc[-1])
    padded = total if pad_ones is None else (total + 7) & ~7
    valid = min((padded + 31) >> 5, out_words)
    out, fast = _Once(out_words), []
    for i in range(blocks):
        for d0, d1 in _groups(_share(valid, i, blocks),
                              _share(valid, i + 1, blocks)):
            s = int(np.searchsorted(inc, 32 * d0, side="right"))
            for d, v in zip(range(d0, d1), _build_group(
                    d0, d1, s, inc, segs, padded, bool(pad_ones), fast)):
                out.put(d, v)
    nz = out_words - valid
    for i in range(blocks):
        for d in range(valid + _share(nz, i, blocks),
                       valid + _share(nz, i + 1, blocks)):
            out.put(d, 0)
    return out.result(), padded, fast


def _plain_k9(segs, seg_bits, out_words, pad_ones):
    s = torch.from_numpy(segs.view(np.int32))
    b = torch.from_numpy(seg_bits)
    stream, total = concat.stream_concat_plain(s, b, out_words)
    if pad_ones is not None:
        stream, total = concat.apply_tail_padding(stream, total, pad_ones)
    # the CPU wrapper is the plain version, then the padding
    got, got_total = concat.stream_concat(s, b, out_words, pad_ones)
    assert torch.equal(got, stream) and int(got_total) == int(total)
    return stream.numpy().view(np.uint32), int(total)


@pytest.mark.parametrize("pad_ones", [None, False, True])
@pytest.mark.parametrize("case", range(len(K9_CASES)))
def test_k9_model_matches_plain(case, pad_ones):
    """K9 at one thread block, a few, and more blocks than some streams
    have groups, with no pad, a pad of 0s and a pad of 1s."""
    segs, seg_bits, out_words = k9_case(case)
    want, want_total = _plain_k9(segs, seg_bits, out_words, pad_ones)
    for blocks in (1, 3, 8) if len(seg_bits) < 1000 else (5,):
        got, total, _ = k9_model(segs, seg_bits, out_words, blocks, pad_ones)
        assert total == want_total
        np.testing.assert_array_equal(got, want)


def test_k9_cases_cover_the_edges():
    """The totals each K9 case is there for: on a word boundary (no pad),
    on a byte boundary off a word one (no pad either), off a byte (a pad
    inside the last word), zero; and a scan past shared memory."""
    made = [k9_case(i) for i in range(len(K9_CASES))]
    totals = [int(b.astype(np.int64).sum()) for _, b, _ in made]
    assert any(t and t % 32 == 0 for t in totals)
    assert any(t % 32 and t % 8 == 0 for t in totals)
    assert any(t % 8 for t in totals) and 0 in totals
    smem = 232448  # an H100's opt-in shared memory per block
    assert not concat.rows_scan_fits(len(made[-1][1]), smem)
    _, _, fast = k9_model(*made[0], 3, True)
    assert fast


def test_k9_grid():
    """K9's thread blocks: one an SM (132 on an H100), at most one per
    K9_MIN_WORDS stream words."""
    assert concat.stream_concat_blocks(1_525_632, 132) == 132
    assert concat.stream_concat_blocks(4 * concat.K9_MIN_WORDS + 1,
                                       132) == 5
    assert concat.stream_concat_blocks(3, 132) == 1
    assert concat.chunked_blocks(20_000, 132) == 5


def test_k9_pad_matches_jpegtpu():
    """K8 + K9 with the pad of 1s and of 0s (the port's plain versions)
    against jpegtpu's concat_raw_pallas (interpret mode) and
    treepack._apply_tail_padding, on seeded streams of a 3 x 40 grid."""
    nbh, nbw, ncg, cap = 3, 40, 1, 4
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 32 * cap + 1, nbh * nbw)
    if bits.sum() % 8 == 0:  # a total off the byte
        bits[0] = 5 if bits[0] != 5 else 6
    valid = (bits[None, :] - 32 * np.arange(cap)[:, None]).clip(0, 32)
    words = (rng.integers(0, 1 << 32, (cap, nbh * nbw), dtype=np.int64)
             & (((1 << valid) - 1) << (32 - valid))).astype(np.uint32)
    raw = np.stack([np.asarray(pt.scan_to_raw(jnp.asarray(r), nbh, nbw,
                                              ncg)) for r in words], axis=1)
    braw = np.asarray(pt.scan_to_raw(jnp.asarray(bits.astype(np.int32)), nbh,
                                     nbw, ncg))
    ref_words, ref_total = pallas_concat.concat_raw_pallas(
        jnp.asarray(raw), jnp.asarray(braw), nbh, nbw, ncg, interpret=True)
    assert int(ref_total) % 8
    w = torch.from_numpy(words.view(np.int32))
    b = torch.from_numpy(bits.astype(np.int32))
    for pad_ones in (True, False):
        got, got_total = concat.concat_stream(w, b, nbh, nbw,
                                              pad_ones=pad_ones)
        want, want_total = treepack._apply_tail_padding(
            ref_words, ref_total, pad_ones)
        assert int(got_total) == int(want_total)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
