"""K8 + K9 (jpegtpu_torch.entropy.concat) against jpegtpu's Pallas
`merge_sublanes_pallas` / `concat_raw_pallas` (interpret mode) and
`treepack._apply_tail_padding`; numpy models of K8's index arithmetic
(csrc/concat.cu and the word-parallel design of
tools/k8_word_parallel.cu) against `merge_rows_plain`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.entropy import pallas_concat, treepack
from jpegtpu.ops import pallas_transform as pt

import jpegtpu_torch
from jpegtpu_torch import tables
from jpegtpu_torch.entropy import concat, pack

from kernel_edge_cases import K8_CASES, k8_case
from test_torch_stream_joins import _Once
from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

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


# --- K8: numpy models of csrc/concat.cu (merge_rows) and of the
# word-parallel design of tools/k8_word_parallel.cu, word for word against
# merge_rows_plain on tests/kernel_edge_cases.py's rows. Each follows its
# kernel's steps (the lanes a thread block scans, the segment-local
# shuffle scan, the 16-byte groups each thread stores) and checks that
# every output word is written exactly once.

MASK = 0xFFFFFFFF
WP_LANES = 128  # k8_word_parallel.cu kMergeLanes: counts a block scans
WP_GROUPS = 3  # kMergeGroups: 16-byte groups a thread stores, about
WP_MAX_THREADS = 512  # kMergeMaxThreads


def k8_lanes(ws):
    """csrc/concat.cu merge_lanes: the blocks a thread block stages, one
    segment (two at ws 16)."""
    return max(ws, 32)


def wp_threads(ws, seg_words):
    """k8_word_parallel.cu merge_threads: a power of two from 128 to 512,
    about WP_GROUPS groups of the block's segments a thread."""
    groups = (WP_LANES // ws) * seg_words // 4
    t = WP_LANES
    while t < WP_MAX_THREADS and t * WP_GROUPS < groups:
        t *= 2
    return t


def _k8_lanes(bits, nbh, nbw, ws, cap, s0, lanes):
    """A thread block's lanes from segment s0 on: (clamped counts, 0 past
    a row or the last segment; each lane's block index)."""
    per_row = -(-nbw // ws)
    nseg = nbh * per_row
    b = np.zeros(lanes, np.int64)
    blk = np.zeros(lanes, np.int64)
    for t in range(lanes):
        s = s0 + t // ws
        col = (s % per_row) * ws + t % ws
        blk[t] = (s // per_row) * nbw + col
        if s < nseg and col < nbw:
            b[t] = min(int(bits[blk[t]]), cap * 32)
    return b, blk


def _k8_scan(b, ws):
    """merge_scan: inclusive shuffle scans over min(ws, 32) lanes, then
    for ws > 32 the totals of the segment's earlier warps."""
    width = min(ws, 32)
    lanes = len(b)
    lane = np.arange(lanes) & 31
    x = b.copy()
    o = 1
    while o < width:
        x = x + np.where((lane & (width - 1)) >= o, np.roll(x, o), 0)
        o *= 2
    if ws > 32:
        warp = np.arange(lanes) >> 5
        tot = x[31::32].copy()
        first = warp & ~(ws // 32 - 1)
        x = x + np.array([tot[first[t]:warp[t]].sum()
                          for t in range(lanes)])
    return x


K8_GATHER = 8  # k8_word_parallel.cu kGather: words a thread loads at once


def _gather_group(d0, inc, ws, word):
    """gather_group: the group of segment words [d0, d0 + 4) from the
    words holding its bits, from the lane holding bit 32 d0 on, K8_GATHER
    words a round (all loaded before any is used), each ORed in at its
    bit offset; -> (its four words, the rounds)."""
    p0 = 32 * d0
    p1 = min(p0 + 128, int(inc[ws - 1]))
    lane = int(np.searchsorted(inc, p0, "right"))
    off = int(inc[lane - 1]) if lane else 0
    k = (p0 - off) >> 5
    v, rounds = [0, 0, 0, 0], 0
    while lane < ws and off + 32 * k < p1:
        rounds += 1
        got = []
        for _ in range(K8_GATHER):
            if lane < ws and off + 32 * k < p1:
                got.append((word(lane, k), off + 32 * k - p0))
                if off + 32 * (k + 1) < inc[lane]:
                    k += 1
                else:
                    off, k = int(inc[lane]), 0
                    lane += 1
                    while lane < ws and inc[lane] == off:
                        lane += 1
        for w, at in got:
            for j in range(4):
                sh = at - 32 * j
                if 0 <= sh < 32:
                    v[j] |= w >> sh
                elif -32 < sh < 0:
                    v[j] |= (w << -sh) & MASK
    return v, rounds


def k8_model(words, bits, nbh, nbw, ws):
    """words [cap, nb] uint32, bits [nb] -> (segs [S, ws * (cap + 1)]
    uint32, seg_bits [S]) as csrc/concat.cu's threads compute them: each
    thread block stages max(ws, 32) lanes (one segment, two at ws 16) in
    shared memory, zeroed while the lanes' counts load; after the scan
    each lane deposits its words (loaded a few a round, the first with
    its count and zeroed past it) at its offset (plain stores inside, OR
    on its first and last word: no word takes a plain store and another
    write, none lands past the valid words); then every 16-byte group goes
    out once, from shared memory where it holds valid words (those past
    them are still zero there), else zeros."""
    cap, nb = words.shape
    lanes = k8_lanes(ws)
    per_block = lanes // ws
    nseg = nbh * -(-nbw // ws)
    seg_words, seg_groups = ws * (cap + 1), ws * (cap + 1) // 4
    out, seg_bits = _Once(nseg * seg_words), _Once(nseg)
    for s0 in range(0, nseg, per_block):
        b, blk = _k8_lanes(bits, nbh, nbw, ws, cap, s0, lanes)
        inc = _k8_scan(b, ws)
        live = min(per_block, nseg - s0)
        for t in range(ws - 1, live * ws, ws):
            seg_bits.put(s0 + t // ws, inc[t])
        stage = np.zeros(per_block * seg_words, np.int64)
        valid = [(int(inc[p * ws + ws - 1]) + 31) >> 5 for p in range(live)]
        plain = np.zeros(stage.shape, np.int64)
        ored = np.zeros(stage.shape, bool)
        for t in range(lanes):
            if not b[t]:
                continue
            excl = int(inc[t] - b[t])
            f, r = excl >> 5, excl & 31
            n_out = ((excl + int(b[t]) - 1) >> 5) - f + 1
            nw = (int(b[t]) + 31) >> 5
            # loaded a few a round; the first, loaded before the count was
            # known, zeroed past it like the rest
            w = [int(words[j, blk[t]]) if j < nw else 0
                 for j in range(n_out)]
            for j in range(n_out):
                prev = w[j - 1] if j else 0
                val = (((w[j] >> r) | (prev << (32 - r))) & MASK if r
                       else w[j])
                idx = (t // ws) * seg_words + f + j
                assert f + j < valid[t // ws], "a deposit past the valid words"
                if j in (0, n_out - 1):
                    stage[idx] |= val
                    ored[idx] = True
                else:
                    stage[idx] = val
                    plain[idx] += 1
        assert not ((plain > 1) | ((plain > 0) & ored)).any(), \
            "a plain store races another write"
        for p in range(live):
            for g in range(seg_groups):
                for i in range(4):
                    d = 4 * g + i
                    out.put((s0 + p) * seg_words + d,
                            int(stage[p * seg_words + d]) if 4 * g < valid[p]
                            else 0)
    return out.result().reshape(nseg, seg_words), seg_bits.result()


def k8_words_model(words, bits, nbh, nbw, ws):
    """The same, as tools/k8_word_parallel.cu's threads compute it: each
    thread block scans its 128 lanes; thread t of T (wp_threads) stores
    groups t, t + T, ... of the block's segments; a group past its
    segment's total is zeros, else it is gathered from the words of the
    lanes covering it (_gather_group)."""
    cap, nb = words.shape
    per_block = WP_LANES // ws
    nseg = nbh * -(-nbw // ws)
    seg_words = ws * (cap + 1)
    threads = wp_threads(ws, seg_words)
    out, seg_bits = _Once(nseg * seg_words), _Once(nseg)
    for s0 in range(0, nseg, per_block):
        b, blk = _k8_lanes(bits, nbh, nbw, ws, cap, s0, WP_LANES)
        inc = _k8_scan(b, ws)
        live = min(per_block, nseg - s0)
        for t in range(ws - 1, live * ws, ws):
            seg_bits.put(s0 + t // ws, inc[t])
        groups = live * (seg_words // 4)
        for t in range(threads):
            for g in range(t, groups, threads):
                p, d0 = divmod(4 * g, seg_words)
                pinc = inc[p * ws:(p + 1) * ws]
                v = [0, 0, 0, 0]
                if 32 * d0 < pinc[-1]:
                    v, _ = _gather_group(
                        d0, pinc, ws,
                        lambda lane, k, p=p: int(words[k, blk[p * ws + lane]]))
                for i in range(4):
                    out.put(s0 * seg_words + 4 * g + i, v[i])
    return out.result().reshape(nseg, seg_words), seg_bits.result()


@pytest.mark.parametrize("model", ["shipped", "word_parallel"])
@pytest.mark.parametrize("case", range(len(K8_CASES)))
def test_k8_models_match_plain(case, model):
    words, bits, nbh, nbw, ws = k8_case(case)
    want = concat.merge_rows_plain(torch.from_numpy(words.view(np.int32)),
                                   torch.from_numpy(bits), nbh, nbw, ws)
    fn = k8_model if model == "shipped" else k8_words_model
    segs, seg_bits = fn(words, bits, nbh, nbw, ws)
    np.testing.assert_array_equal(segs, want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(seg_bits.astype(np.int64),
                                  want[1].numpy())


def test_k8_cases_cover_the_edges():
    """K8_CASES hold every width, ragged last segments, rows narrower
    than a segment, blocks that are empty, under a word, exactly cap * 32
    bits and past it, and the MCU-stream caps 48, 96 and 318."""
    seen = set()
    for i, (ws, nbh, nbw, cap, _) in enumerate(K8_CASES):
        _, bits, *_ = k8_case(i)
        seen |= {f"ws{ws}", f"cap{cap}"}
        seen |= {name for name, hit in (
            ("ragged", nbw % ws != 0), ("narrow", nbw < ws),
            ("empty", (bits == 0).any()),
            ("sub-word", ((bits > 0) & (bits < 32)).any()),
            ("exact", (bits == cap * 32).any()),
            ("clamped", (bits > cap * 32).any())) if hit}
    assert {"ws16", "ws32", "ws64", "ws128", "cap48", "cap96", "cap318",
            "ragged", "narrow", "empty", "sub-word", "exact",
            "clamped"} <= seen


def test_k8_groups_take_several_gather_rounds():
    """Some 16-byte group of the cases gathers more than 2 * K8_GATHER
    words (blocks of a few bits each): gather_group's third round."""
    words, bits, nbh, nbw, ws = k8_case(
        [c[4] for c in K8_CASES].index("short"))
    b, _ = _k8_lanes(bits, nbh, nbw, ws, words.shape[0], 0, k8_lanes(ws))
    inc = _k8_scan(b, ws)
    rounds = [_gather_group(d0, inc[:ws], ws, lambda lane, k: 0)[1]
              for d0 in range(0, (int(inc[ws - 1]) + 31) // 32, 4)]
    assert max(rounds) >= 3


@pytest.mark.parametrize("ws,cap,lanes,threads", [
    (128, 8, 128, 128), (128, 48, 128, 512), (64, 8, 64, 128),
    (32, 48, 32, 512), (16, 1, 32, 128), (128, 318, 128, 512),
])
def test_k8_launch_shapes(ws, cap, lanes, threads):
    """Blocks a thread block stages at the paths' widths and caps (one
    segment, two at ws 16), and the word-parallel design's threads: 128
    for a gray row segment (288 groups), 512 for the 4:2:0 MCU streams'
    (1,568 groups a block) and the top rung's."""
    assert k8_lanes(ws) == lanes
    assert wp_threads(ws, ws * (cap + 1)) == threads
