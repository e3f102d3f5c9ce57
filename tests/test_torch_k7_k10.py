"""Numpy models of the index arithmetic of K7 (csrc/pack.cu, pack_blocks)
and K10 (csrc/concat.cu, stream_concat_chunked; and the warp-per-segment
design of tools/k10_warp_per_segment.cu), held word for word against the
kernels' plain versions on the CPU, on tests/kernel_edge_cases.py's
adversarial inputs.

The CUDA kernels run only on a card (tests/test_torch_gpu.py holds them
against the same plain versions there). These models follow the kernels'
own steps. K7: each block's elements in groups of 6, a group's counts
read one group ahead of its first words, an element's later words read
where they are used, the 4-word accumulator at every residue, words stored
up to cap and zeros after them, and the count of every bit past cap.
K10: the scan, each thread block's share of the words that hold bits
and of the zeros past the total, each 4-word group's covering segment
(by binary search, one segment's five words or the walk across segment
ends), and, for the warp per segment, the rule that a word belongs to
the segment holding its first bit. Each model checks that every output word is
written exactly once."""
import numpy as np
import pytest
import torch

from jpegtpu_torch.entropy import concat, pack

from kernel_edge_cases import K10_CASES, K7_CAPS, k10_case, k7_elements
from test_torch_stream_joins import _groups, _Once, _rows_word
from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

MASK = 0xFFFFFFFF
GROUP = 6  # csrc/pack.cu kGroup: K7's elements a round trip


# --- K7 ------------------------------------------------------------------

class _Once2D(_Once):
    """An output [rows, cols] whose words must each be written once."""

    def __init__(self, rows, cols):
        super().__init__(rows * cols)
        self.shape = (rows, cols)

    def put2(self, r, c, v):
        self.put(r * self.shape[1] + c, v)

    def result2(self):
        return self.result().reshape(self.shape)


def k7_model(words_t, bits_t, cap):
    """words_t [3, E, nb] uint32, bits_t [E, nb] -> (words [cap, nb]
    uint32, bits [nb], overflow, later words read), as the kernel's
    threads compute them: groups of GROUP elements, each group's counts
    read one group ahead of its first words, an element's later words
    where they are used."""
    _, e, nb = words_t.shape
    out = _Once2D(cap, nb)
    bits = np.zeros(nb, np.int64)
    later = 0
    for b in range(nb):
        a, cnt, widx = [0, 0, 0, 0], 0, 0
        nxt = [int(bits_t[j, b]) if j < e else 0 for j in range(GROUP)]
        for e0 in range(0, e, GROUP):
            ln = nxt
            w0 = [int(words_t[0, e0 + j, b]) if ln[j] > 0 else 0
                  for j in range(GROUP)]
            nxt = [int(bits_t[e0 + GROUP + j, b]) if e0 + GROUP + j < e
                   else 0 for j in range(GROUP)]
            for j in range(GROUP):
                if ln[j] <= 0:
                    continue
                w1 = w2 = 0
                if ln[j] > 32:
                    w1 = int(words_t[1, e0 + j, b])
                    later += 1
                if ln[j] > 64:
                    w2 = int(words_t[2, e0 + j, b])
                    later += 1
                if cnt:
                    t = 32 - cnt
                    a[0] |= w0[j] >> cnt
                    a[1] |= ((w1 >> cnt) | (w0[j] << t)) & MASK
                    a[2] |= ((w2 >> cnt) | (w1 << t)) & MASK
                    a[3] |= (w2 << t) & MASK
                else:
                    a[0] |= w0[j]
                    a[1] |= w1
                    a[2] |= w2
                cnt += ln[j]
                while cnt >= 32:
                    if widx < cap:
                        out.put2(widx, b, a[0])
                    widx += 1
                    a = a[1:] + [0]
                    cnt -= 32
        produced = widx
        if cnt:
            if widx < cap:
                out.put2(widx, b, a[0])
            produced += 1
        for r in range(produced, cap):  # row by row for the warp
            out.put2(r, b, 0)
        bits[b] = widx * 32 + cnt
    return out.result2(), bits, bool((bits > cap * 32).any()), later


def _plain_k7(words_t, bits_t, cap):
    w, b, over = pack.pack_blocks_plain(
        torch.from_numpy(words_t.view(np.int32)), torch.from_numpy(bits_t),
        cap)
    return w.numpy().view(np.uint32), b.numpy(), bool(over)


@pytest.mark.parametrize("cap", K7_CAPS)
@pytest.mark.parametrize("nb,n_elem", [(45, 64), (33, 130), (5, 1)])
def test_k7_model_matches_plain(nb, n_elem, cap):
    """The edge blocks (96-bit elements at every residue, exact word ends
    and one bit past caps 1, 8 and 53), at 64 elements a block, 130 (a
    last group of 4) and one."""
    words_t, bits_t = k7_elements(nb, seed=nb + n_elem, n_elem=n_elem)
    want_w, want_b, want_over = _plain_k7(words_t, bits_t, cap)
    got_w, got_b, got_over, later = k7_model(words_t, bits_t, cap)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_w, want_w)
    assert got_over == want_over
    assert (later > 0) == (n_elem > 1)


def test_k7_edge_blocks_end_where_built():
    """The edge blocks' bit counts: every residue of the dense blocks,
    exact word ends for caps 1, 8 and 53 and one bit past each, and 8
    and 9 elements past 32 bits."""
    _, bits_t = k7_elements(45, seed=0)
    totals = bits_t.sum(axis=0)
    assert sorted(set(totals[:32] % 32)) == list(range(32))
    assert list(totals[32:42]) == [0, 1, 32, 33, 256, 257, 1696, 1697,
                                   sum((32, 33, 64, 65)) * 16, totals[41]]
    assert [(bits_t[:, b] > 32).sum() for b in (41, 42)] == [8, 9]


# --- K10 -----------------------------------------------------------------

def _share(n, i, parts):
    """The kernels' share_start: word i of `parts` shares of n words in
    whole 4-word groups."""
    each = ((-(-n // parts)) + 3) & ~3
    return min(n, i * each)


def _words4(seg, q):
    """segment_words4: four words from bit q of one segment."""
    k, r = q >> 5, q & 31
    x = [int(seg[k + i]) if k + i < len(seg) else 0 for i in range(5)]
    return [((x[i] << r) | (x[i + 1] >> (32 - r))) & MASK if r else x[i]
            for i in range(4)]


def _build_group(d0, d1, s, inc, segs, total, fast):
    """The words [d0, d1) of the stream, from segment s (the one holding
    bit 32 d0) on: one segment's five words when it holds all 128 bits,
    else word by word across segment ends."""
    off = int(inc[s - 1]) if s else 0
    if d1 - d0 == 4 and 32 * d0 + 128 <= inc[s]:
        fast.append(s)
        return _words4(segs[s], 32 * d0 - off)
    vals = []
    for d in range(d0, d1):
        v, s = _rows_word(d, s, inc, segs, 0, total, False)
        vals.append(v)
    return vals


def _zeros(out, valid, out_words, blocks):
    nz = out_words - valid
    for i in range(blocks):
        for d in range(valid + _share(nz, i, blocks),
                       valid + _share(nz, i + 1, blocks)):
            out.put(d, 0)


def k10_model(segs, seg_bits, out_words, blocks):
    """The gather (csrc/concat.cu): (stream, total, the segment each built
    word was searched from, the groups built from one segment)."""
    inc = np.cumsum(seg_bits.astype(np.int64))
    total = int(inc[-1])
    valid = min((total + 31) >> 5, out_words)
    out, cover, fast = _Once(out_words), {}, []
    for i in range(blocks):
        for d0, d1 in _groups(_share(valid, i, blocks),
                              _share(valid, i + 1, blocks)):
            s = int(np.searchsorted(inc, 32 * d0, side="right"))
            for d, v in zip(range(d0, d1),
                            _build_group(d0, d1, s, inc, segs, total, fast)):
                out.put(d, v)
                cover[d] = int(np.searchsorted(inc, 32 * d, side="right"))
    _zeros(out, valid, out_words, blocks)
    return out.result(), total, cover, fast


def k10_warp_model(segs, seg_bits, out_words, blocks, warps):
    """The warp per segment (tools/k10_warp_per_segment.cu): (stream,
    total, each word's owner segment)."""
    inc = np.cumsum(seg_bits.astype(np.int64))
    total = int(inc[-1])
    valid = min((total + 31) >> 5, out_words)
    out, owner, fast = _Once(out_words), {}, []
    for w in range(blocks * warps):
        for s in range(w, len(inc), blocks * warps):
            off = int(inc[s - 1]) if s else 0
            lo, hi = (off + 31) >> 5, min((int(inc[s]) + 31) >> 5, valid)
            for d0, d1 in _groups(lo, hi):
                for d, v in zip(range(d0, d1), _build_group(
                        d0, d1, s, inc, segs, total, fast)):
                    out.put(d, v)
                    owner[d] = s
    _zeros(out, valid, out_words, blocks)
    return out.result(), total, owner


def _plain_k10(segs, seg_bits, out_words):
    got, total = concat.stream_concat_chunked_plain(
        torch.from_numpy(segs.view(np.int32)), torch.from_numpy(seg_bits),
        out_words, 3)
    k9, k9_total = concat.stream_concat_plain(
        torch.from_numpy(segs.view(np.int32)), torch.from_numpy(seg_bits),
        out_words)
    assert torch.equal(got, k9) and int(total) == int(k9_total)
    return got.numpy().view(np.uint32), int(total)


@pytest.mark.parametrize("blocks", [1, 3, 8])
@pytest.mark.parametrize("case", range(len(K10_CASES)))
def test_k10_models_match_plain(case, blocks):
    """Both designs, at one thread block, a few, and more blocks than
    some streams have groups."""
    segs, seg_bits, out_words = k10_case(case)
    want, want_total = _plain_k10(segs, seg_bits, out_words)
    got, total, cover, _ = k10_model(segs, seg_bits, out_words, blocks)
    assert total == want_total
    np.testing.assert_array_equal(got, want)
    warp, warp_total, owner = k10_warp_model(segs, seg_bits, out_words,
                                             blocks, 2)
    assert warp_total == want_total
    np.testing.assert_array_equal(warp, want)
    # a word is searched from, and owned by, the segment of its first bit
    assert cover == owner
    inc = np.cumsum(seg_bits.astype(np.int64))
    for d, s in owner.items():
        assert (inc[s - 1] if s else 0) <= 32 * d < inc[s]


def test_k10_cases_cover_the_edges():
    """The segments' and streams' edges each case is there for, and the
    paths through the gather they take."""
    made = [k10_case(i) for i in range(len(K10_CASES))]
    totals = [int(b.astype(np.int64).sum()) for _, b, _ in made]
    assert any(t % 32 == 0 and t and o == t // 32
               for t, (_, _, o) in zip(totals, made))  # no zeros after
    assert any(t % 32 and o == -(-t // 32)
               for t, (_, _, o) in zip(totals, made))  # partial last word
    assert totals[-1] == 0 and made[-1][2] > 0  # a stream of zeros only
    assert any(len(b) == 1 for _, b, _ in made)  # one-segment streams
    bits = np.concatenate([b for _, b, _ in made])
    assert (bits == 0).any() and ((bits > 0) & (bits < 32)).any()
    _, _, _, fast = k10_model(*made[0], 3)
    _, _, cover, _ = k10_model(*made[1], 3)
    assert fast and len(set(cover.values())) < len(made[1][1])


def test_k10_grid_and_scan_placement():
    """K10's launch: the card's resident blocks (132 of 1024 threads on an
    H100), at most one per 4096 stream words; the scan in shared memory up
    to some 29,000 segments (the 8K frame's 4,320 gray and 1,080 4:2:0
    fit)."""
    smem = 232448  # an H100's opt-in shared memory per block
    assert concat.chunked_blocks(4_148_736, 132) == 132
    assert concat.chunked_blocks(20_000, 132) == 5
    assert concat.chunked_blocks(3, 132) == 1
    assert concat.rows_scan_fits(4320, smem)
    assert concat.rows_scan_fits(1080, smem)
    assert not concat.rows_scan_fits(29100, smem)
