"""Numpy models of the index arithmetic of K11 (csrc/concat.cu,
stream_concat_rows) and K12 (csrc/stitch.cu, stitch_segments), held word
for word against the kernels' plain versions on the CPU.

The CUDA kernels run only on a card (tests/test_torch_gpu.py holds them
against the same plain versions there). These models follow the kernels'
own steps: K11's per-image scan, its tiles (those past the image's bits
all zeros) and 4-word groups, and the binary search for the segment
that covers each group's first word; K12's scan operator
(a span of streams maps the bit position x before it to x + a, or to
round8(x + a) + b when it holds a segment start), its tile spans, its
halo and serial walk, and which tile writes each word. Each model also
checks that every output word is written exactly once."""
import numpy as np
import pytest
import torch

from jpegtpu_torch.entropy import concat, stitch

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

MASK = 0xFFFFFFFF


def _round8(x):
    return (x + 7) & ~7


def _top(length):
    """A word with its top `length` bits set (length clamped to 0..32)."""
    length = max(0, min(32, length))
    return (MASK << (32 - length)) & MASK


def _take(word, nw, q, length):
    """The kernels' jt::take_bits: the top `length` bits of the 32 bits of
    a stream (word(k), zero at k >= nw) starting at its bit q."""
    k, r = q >> 5, q & 31
    x = word(k) if k < nw else 0
    if r:
        lo = word(k + 1) if k + 1 < nw else 0
        x = ((x << r) | (lo >> (32 - r))) & MASK
    return x & _top(length)


def _groups(lo, hi, phase=0):
    """A thread's 4-word groups over words [lo, hi): lines of the output
    (base `phase` words into its 16-byte line), cut at lo and hi."""
    g = ((lo + phase) & ~3) - phase
    while g < hi:
        yield max(g, lo), min(g + 4, hi)
        g += 4


class _Once:
    """An output whose words must each be written exactly once."""

    def __init__(self, n):
        self.words = np.zeros(n, np.int64)
        self.writes = np.zeros(n, np.int64)

    def put(self, d, v):
        self.words[d] = v
        self.writes[d] += 1

    def result(self):
        assert (self.writes == 1).all(), "a word written twice or never"
        return self.words.astype(np.uint32)


# --- K11 -----------------------------------------------------------------

def _rows_word(d, s, inc, segs, s0, padded, pad_ones):
    """The kernel's rows_word: word d from the bits covering it, starting
    at segment s (the first whose end passes bit 32 d), then the pad;
    returns the word and the segment where it ended."""
    p, sw = len(inc), segs.shape[1]
    v, pos, wend = 0, 32 * d, 32 * d + 32
    while pos < wend:
        while s < p and inc[s] <= pos:
            s += 1
        if s == p:
            if pad_ones and pos < padded:
                v |= _top(min(padded, wend) - pos) >> (pos - 32 * d)
            break
        off = int(inc[s - 1]) if s else 0
        stop = min(int(inc[s]), wend)
        seg = segs[s0 + s]
        v |= _take(lambda k: int(seg[k]), sw, pos - off,
                   stop - pos) >> (pos - 32 * d)
        pos = stop
    return v, s


def k11_model(segs, seg_bits, segs_per_image, slab_words, pad_ones,
              tile_words):
    """segs [S, SW] uint32, seg_bits [S] -> (streams [B, slab_words]
    uint32, padded totals [B]), as the kernel's blocks compute them: a
    tile past the image's padded total is zeros; in the others each
    thread's 4-word group searches for the segment holding its first
    bit, then builds its words one after another."""
    nseg, sw = segs.shape
    n_images = nseg // segs_per_image
    out, totals = [], []
    for img in range(n_images):
        s0 = img * segs_per_image
        inc = np.cumsum(seg_bits[s0:s0 + segs_per_image].astype(np.int64))
        padded = _round8(int(inc[-1]))
        totals.append(padded)
        slab = _Once(slab_words)
        phase = (img * slab_words) & 3
        for lo in range(0, max(slab_words, 1), tile_words):
            hi = min(lo + tile_words, slab_words)
            for d0, d1 in _groups(lo, hi, phase):
                if 32 * lo >= padded or 32 * d0 >= padded:
                    for d in range(d0, d1):
                        slab.put(d, 0)
                    continue
                s = int(np.searchsorted(inc, 32 * d0, side="right"))
                for d in range(d0, d1):
                    v, s = _rows_word(d, s, inc, segs, s0, padded, pad_ones)
                    slab.put(d, v)
        out.append(slab.result())
    return np.stack(out), np.array(totals)


def _segments(rng, nseg, sw, kind):
    """nseg segments of sw words, zero past each one's bits: bit counts
    drawn to include empty segments, segments shorter than a word and
    full ones."""
    if kind == "short":
        bits = rng.integers(0, 32, nseg)
    else:
        bits = rng.integers(0, sw * 32 + 1, nseg)
        bits[rng.random(nseg) < 0.3] = 0
        bits[rng.random(nseg) < 0.2] = sw * 32
    valid = (bits[:, None] - 32 * np.arange(sw)[None, :]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 1 << 32, (nseg, sw), dtype=np.int64) & keep
    return words.astype(np.uint32), bits.astype(np.int32)


def _plain_k11(segs, seg_bits, p, slab, pad_ones):
    got, tot = concat.stream_concat_rows_plain(
        torch.from_numpy(segs.view(np.int32)), torch.from_numpy(seg_bits),
        p, slab, pad_ones)
    return got.numpy().view(np.uint32), tot.numpy()


@pytest.mark.parametrize("pad_ones", [True, False])
@pytest.mark.parametrize("p,n_images,sw,slab,kind,tile", [
    (1, 7, 3, 3, "any", 1024),      # one segment an image, odd slabs
    (3, 5, 4, 13, "short", 4),      # segments shorter than a word, 4 tiles
    (64, 2, 2, 130, "any", 8),      # a 2-image batch of many segments
    (5, 3, 6, 30, "any", 7),        # tiles that cut 4-word groups
])
def test_k11_model_matches_plain(p, n_images, sw, slab, kind, tile,
                                 pad_ones):
    rng = np.random.default_rng(p * 100 + n_images + sw)
    segs, seg_bits = _segments(rng, p * n_images, sw, kind)
    seg_bits[:p], segs[:p] = 0, 0  # an image with no bits at all
    want, want_tot = _plain_k11(segs, seg_bits, p, slab, pad_ones)
    got, tot = k11_model(segs, seg_bits, p, slab, pad_ones, tile)
    np.testing.assert_array_equal(tot, want_tot)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total", [31, 32, 56, 57, 63, 64, 89, 96])
@pytest.mark.parametrize("pad_ones", [True, False])
def test_k11_model_pads_at_word_and_byte_ends(total, pad_ones):
    """An image whose total ends on a byte or a word, or whose pad runs
    to a word's end (57 and 89 bits pad to 64 and 96)."""
    rng = np.random.default_rng(total)
    segs, seg_bits = _segments(rng, 4, 3, "any")
    seg_bits[:] = [total - 20, 0, 13, 7]
    for s, b in enumerate(seg_bits):
        for k in range(3):
            segs[s, k] &= _top(int(b) - 32 * k)
    want, want_tot = _plain_k11(segs, seg_bits, 4, 5, pad_ones)
    got, tot = k11_model(segs, seg_bits, 4, 5, pad_ones, 4)
    np.testing.assert_array_equal(tot, want_tot)
    np.testing.assert_array_equal(got, want)


def test_k11_tiles_and_scan_placement():
    """The tile grows with the segment count and shrinks to fill the
    card; an image's scan leaves shared memory past the card's limit."""
    assert concat.rows_tile_words(64, 1024, 32768, 132) == 4096
    assert concat.rows_tile_words(378, 16, 2286144, 132) == 4096
    assert concat.rows_tile_words(1512, 16, 1 << 22, 132) == 12288
    assert concat.rows_tile_words(64, 2, 32768, 132) == 1024
    assert concat.rows_scan_fits(29000, 232448)
    assert not concat.rows_scan_fits(29100, 232448)


# --- K12 -----------------------------------------------------------------

def _compose(f, g):
    """Span f, then span g. A span is (a, None): x -> x + a, or (a, b, c):
    x -> round8(x + a) + b, its last segment start c bits before its
    end."""
    if g[1] is None:
        if f[1] is None:
            return (f[0] + g[0], None, 0)
        return (f[0], f[1] + g[0], f[2] + g[0])
    if f[1] is None:
        return (f[0] + g[0], g[1], g[2])
    return (f[0], _round8(f[1] + g[0]) + g[1], g[2])


IDENTITY = (0, None, 0)


def _stream_span(b, start):
    return (0, b, b) if start else (b, None, 0)


def _apply(pos, f):
    """(bit position, segment base) after a span."""
    p, base = pos
    if f[1] is None:
        return p + f[0], base
    p = _round8(p + f[0]) + f[1]
    return p, p - f[2]


def _tree(spans, threads):
    """The composition of spans as a block computes it: each of `threads`
    threads composes a run, then the runs combine pairwise."""
    run = max(1, -(-len(spans) // threads))
    level = []
    for t in range(0, len(spans), run):
        f = IDENTITY
        for s in spans[t:t + run]:
            f = _compose(f, s)
        level.append(f)
    while len(level) > 1:
        nxt = [_compose(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0] if level else IDENTITY


def k12_model(words, bits, seg_len, pad_ones, tile, halo):
    """words [C, n] uint32, bits [n] -> (buffer, seg_tot, total, streams
    reached by the serial walk past a halo) as the kernel's two launches
    compute them, with tiles of `tile` streams and `halo` more streams
    scanned by each block."""
    c, n = words.shape
    cap_bits = 32 * c
    b = np.minimum(bits.astype(np.int64), cap_bits)
    n_seg = -(-n // seg_len)
    out_words = stitch.stitch_words(n, c, n_seg)
    tiles = -(-n // tile)
    # launch 1: each tile's span
    spans = [_tree([_stream_span(int(b[i]), i % seg_len == 0)
                    for i in range(k * tile, min(n, (k + 1) * tile))], 8)
             for k in range(tiles)]
    out = _Once(out_words)
    seg_tot = np.full(n_seg, -1, np.int64)
    total = _round8(_apply((0, 0), _tree(spans, 8))[0])
    zlo = (total + 31) >> 5
    share = (-(-(out_words - zlo) // tiles) + 3) & ~3
    serial = 0
    for k in range(tiles):  # launch 2, block k
        start = _apply((0, 0), _tree(spans[:k], 8))
        t0 = k * tile
        r_eff = min(tile + halo, n - t0)
        off, end = np.zeros(r_eff, np.int64), np.zeros(r_eff, np.int64)
        p, base = start
        for j in range(r_eff):
            i = t0 + j
            o = _round8(p) if i % seg_len == 0 else p
            if i % seg_len == 0:
                base = o
            p = o + int(b[i])
            off[j], end[j] = o, p
            if j < tile and (i % seg_len == seg_len - 1 or i == n - 1):
                assert seg_tot[i // seg_len] == -1
                seg_tot[i // seg_len] = _round8(p) - base

        def walk(j, o, e):
            """The stream after local stream j (offset o, end e)."""
            nonlocal serial
            j += 1
            if j < r_eff:
                return j, int(off[j]), int(end[j])
            i = t0 + j
            if i >= n:
                return j, None, None
            serial += 1
            o = _round8(e) if i % seg_len == 0 else e
            return j, o, o + int(b[i])

        q_hi = int(off[tile]) if t0 + tile < n else total
        dlo, dhi = (int(off[0]) + 31) >> 5, (q_hi + 31) >> 5
        for d0, d1 in _groups(dlo, dhi):
            pos = 32 * d0
            j = int(np.searchsorted(end, pos, side="right"))
            if j < r_eff:
                cur = (j, int(off[j]), int(end[j]))
            else:
                cur = walk(r_eff - 1, int(off[-1]), int(end[-1]))
            for d in range(d0, d1):
                v, wend = 0, pos + 32
                while pos < wend:
                    while cur[1] is not None and cur[2] <= pos:
                        cur = walk(*cur)
                    if cur[1] is None:
                        if pad_ones and pos < total:
                            v |= _top(min(total, wend) - pos) >> (pos - 32 * d)
                        pos = wend
                        break
                    if cur[1] > pos:
                        stop = min(cur[1], wend)
                        if pad_ones:
                            v |= _top(stop - pos) >> (pos - 32 * d)
                        pos = stop
                        continue
                    stop = min(cur[2], wend)
                    i = t0 + cur[0]
                    v |= _take(lambda kw: int(words[kw, i]), c,
                               pos - cur[1], stop - pos) >> (pos - 32 * d)
                    pos = stop
                out.put(d, v)
        z0 = min(out_words, zlo + share * k)
        for d in range(z0, min(out_words, z0 + share)):
            out.put(d, 0)
    assert (seg_tot >= 0).all()
    return out.result(), seg_tot, total, serial


def _streams(rng, c, n, kind):
    """n streams of c words, zero past each one's bits. "mixed": 0,
    1-31, byte and word multiples, full, and overflowed (clamped to
    c * 32) counts; "empty": runs of empty streams between short ones."""
    if kind == "mixed":
        bits = rng.choice(np.concatenate([
            np.arange(0, 32), [8, 16, 24, 32, 40, 64, c * 32, c * 32 + 9],
            rng.integers(0, c * 32 + 1, 8)]), n)
    else:
        bits = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 12, n))
    valid = (np.minimum(bits, 32 * c)[None, :]
             - 32 * np.arange(c)[:, None]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 1 << 32, (c, n), dtype=np.int64) & keep
    return words.astype(np.uint32), bits.astype(np.int32)


def _plain_k12(words, bits, seg_len, pad_ones):
    got, seg_tot, total = stitch.stitch_segments_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits),
        seg_len, pad_ones)
    return got.numpy().view(np.uint32), seg_tot.numpy(), int(total)


@pytest.mark.parametrize("pad_ones", [True, False])
@pytest.mark.parametrize("seg_len", [1, 2, 37, "n"])
@pytest.mark.parametrize("c,n,kind,tile,halo", [
    (2, 203, "mixed", 8, 4),     # many tiles, halos of a few streams
    (3, 77, "empty", 4, 2),      # runs of empty streams past the halo
    (1, 600, "mixed", 512, 256),  # the kernel's own tile and halo
])
def test_k12_model_matches_plain(c, n, kind, tile, halo, seg_len, pad_ones):
    seg_len = n if seg_len == "n" else seg_len
    rng = np.random.default_rng(c * 1000 + n + seg_len)
    words, bits = _streams(rng, c, n, kind)
    want, want_tot, want_total = _plain_k12(words, bits, seg_len, pad_ones)
    got, seg_tot, total, serial = k12_model(words, bits, seg_len, pad_ones,
                                            tile, halo)
    assert (serial > 0) == (kind == "empty")
    assert total == want_total
    np.testing.assert_array_equal(seg_tot, want_tot)
    np.testing.assert_array_equal(got, want)


def test_k12_operator_is_associative():
    """Any grouping of the streams' spans gives the positions a
    stream-by-stream walk gives: every order in which blocks and warps
    may combine them."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        spans = [_stream_span(int(rng.integers(0, 40)),
                              bool(rng.random() < 0.3))
                 for _ in range(int(rng.integers(1, 12)))]
        x = (int(rng.integers(0, 100)), 0)
        want = x
        for s in spans:
            want = _apply(want, s)
        for threads in (1, 2, 3, 8):
            got = _apply(x, _tree(spans, threads))
            assert got[0] == want[0]
            if any(s[1] is not None for s in spans):
                assert got[1] == want[1]
        cut = int(rng.integers(0, len(spans) + 1))
        left, right = _tree(spans[:cut], 1), _tree(spans[cut:], 1)
        assert _apply(x, _compose(left, right))[0] == want[0]


def test_k12_tile_sizes():
    """Tiles are THREADS-multiples of at least 512 streams; a 12 MPix
    restart scan (190,512 blocks) makes 373 tiles, an 8K one 507."""
    assert stitch.stitch_tile(1) == 512
    assert stitch.stitch_tile(190_512) == 512
    assert stitch.stitch_tile(518_400) == 1024
    assert stitch.stitch_tile(1 << 30) == 32 * stitch.THREADS
    assert -(-190_512 // stitch.stitch_tile(190_512)) == 373
