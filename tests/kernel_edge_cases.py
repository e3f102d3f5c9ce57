"""Adversarial inputs for K4 (jpegtpu_torch.entropy.pack.encode_blocks),
the transforms K1-K3 (jpegtpu_torch.ops.transform), K5
(entropy.merge.merge_mcu), K7 (entropy.pack.pack_blocks), K9 and K10
(entropy.concat.stream_concat, stream_concat_chunked), made from a seed
with numpy alone. tests/test_torch_kernel_edges.py holds the port's twins
against jpegtpu on the K1-K4 ones, and the kernels against the twins on
the card; tests/test_torch_k7_k10.py and tests/test_torch_k5_k9.py hold
numpy models of K5's, K7's, K9's and K10's index arithmetic against their
twins on theirs, and tests/test_torch_gpu.py the kernels; chip_smoke.py's
kernel_edges phase runs the same kernel checks."""
import numpy as np

# zeros before a nonzero: one ZRL short of 16, one, two and three ZRLs
ZERO_RUNS = (15, 16, 31, 32, 47, 48, 62)


def _mag(rng, size: int, n: int) -> np.ndarray:
    """n values of JPEG size category `size`, random signs."""
    lo = 1 << (size - 1)
    return rng.integers(lo, 2 * lo, n) * rng.choice([-1, 1], n)


def k4_edge_blocks(rng) -> tuple:
    """The edge blocks, all within the tables (AC sizes <= 10, DC
    difference sizes <= 11): (zz [m, 64] int32 zigzag levels, dc_diff [m]
    int32). Block 0 has 63 AC levels of size 10 (past cap * 32 bits at caps
    1 and 8); then a nonzero after each run of ZERO_RUNS zeros, alone and
    after a nonzero at k = 1 (run 62 puts it at coefficient 63: no EOB);
    63 AC levels of +-1 (no EOB); an all-zero block with a DC difference of
    size 0; DC differences of size 11 and of +-2047; every size 1-10 at
    random places."""
    blocks, dcs = [], []

    def add(ac: dict, dc: int):
        b = np.zeros(64, np.int64)
        for k, v in ac.items():
            b[k] = v
        blocks.append(b)
        dcs.append(dc)

    add(dict(zip(range(1, 64), _mag(rng, 10, 63))), int(_mag(rng, 11, 1)[0]))
    for run in ZERO_RUNS:
        add({1 + run: int(_mag(rng, 3, 1)[0])}, 5)
        if 2 + run <= 63:
            add({1: -1, 2 + run: int(_mag(rng, 7, 1)[0])}, -3)
    add(dict(zip(range(1, 64), rng.choice([-1, 1], 63))), 0)
    add({}, 0)
    add({63: 1}, 2047)
    add({5: 1023, 40: -1023}, -2047)
    add({1: -1024 + 1}, int(_mag(rng, 11, 1)[0]))
    pos = rng.choice(np.arange(1, 64), 10, replace=False)
    add({int(k): int(_mag(rng, s, 1)[0]) for s, k in zip(range(1, 11), pos)},
        int(_mag(rng, 6, 1)[0]))
    return np.stack(blocks).astype(np.int32), np.asarray(dcs, np.int32)


def k4_past_table_blocks(rng) -> tuple:
    """Blocks past the tables, which jpegtpu's select cascades encode with
    entry 0 of their class: DC differences of sizes 12-15 and AC levels of
    sizes 11-15 (each put still within 32 bits)."""
    zz = np.zeros((8, 64), np.int64)
    dc = np.zeros(8, np.int64)
    for i, size in enumerate(range(12, 16)):
        dc[i] = _mag(rng, size, 1)[0]
        zz[i, rng.integers(1, 64)] = _mag(rng, 2, 1)[0]
    for i, size in enumerate(range(11, 16)):
        k = sorted(rng.choice(np.arange(1, 64), 2, replace=False))
        zz[3 + i, k[0]] = _mag(rng, size, 1)[0]
        zz[3 + i, k[1]] = _mag(rng, 4, 1)[0]
    zz[7, 63] = _mag(rng, 11, 1)[0]  # past the table at coefficient 63
    return zz.astype(np.int32), dc.astype(np.int32)


def k4_blocks(nb: int, seed: int, past_table: bool = False) -> tuple:
    """nb blocks: the edge blocks (and with past_table those past the
    tables) first, then sparse photographic-like ones; cut to nb.
    -> (zz [nb, 64] int32, dc_diff [nb] int32)."""
    rng = np.random.default_rng(seed)
    parts = [k4_edge_blocks(rng)]
    if past_table:
        parts.append(k4_past_table_blocks(rng))
    zz = np.concatenate([p[0] for p in parts])
    dc = np.concatenate([p[1] for p in parts])
    fill = max(nb - zz.shape[0], 0)
    extra = np.zeros((fill, 64), np.int32)
    for i in range(fill):
        k = rng.integers(0, 16)
        pos = rng.choice(np.arange(1, 64), k, replace=False)
        extra[i, pos] = rng.integers(-300, 301, k)
    zz = np.concatenate([zz, extra])[:nb]
    dc = np.concatenate([dc, rng.integers(-200, 201, fill)])[:nb]
    return zz.astype(np.int32), dc.astype(np.int32)


def transform_image(h: int, w: int, seed: int, channels: int = 0):
    """uint8 [h, w] (or [h, w, channels]) content that drives the DCT to
    its extremes: random 8x8 blocks of 0, of 255, of a 0/255 checkerboard
    (the largest high-frequency coefficients), of 0/255 stripes either way,
    and of noise."""
    rng = np.random.default_rng(seed)
    shape = (h, w) + ((channels,) if channels else ())
    img = rng.integers(0, 256, shape).astype(np.uint8)
    yy, xx = np.mgrid[0:8, 0:8]
    patterns = [np.zeros((8, 8)), np.full((8, 8), 255),
                255 * ((yy + xx) % 2), 255 * (xx % 2), 255 * (yy % 2)]
    for by in range(h // 8):
        for bx in range(w // 8):
            pick = rng.integers(0, len(patterns) + 1)
            if pick == len(patterns):
                continue  # noise
            tile = patterns[pick].astype(np.uint8)
            if channels:  # each channel its own pattern or its inverse
                tile = np.stack([tile if rng.integers(0, 2) else 255 - tile
                                 for _ in range(channels)], -1)
            img[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = tile
    return img


def _msb_words(rng, bits: np.ndarray, n_words: int) -> np.ndarray:
    """Random MSB-first words [..., n_words] uint32 holding `bits` [...]
    bits each, zero past them."""
    valid = (bits[..., None] - 32 * np.arange(n_words)).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 1 << 32, valid.shape, dtype=np.int64) & keep
    return words.astype(np.uint32)


# caps the K7 checks run at: one word, the first rung, the top rung
K7_CAPS = (1, 8, 53)


def k7_elements(nb: int, seed: int, n_elem: int = 64) -> tuple:
    """nb blocks of n_elem fused elements (<= 96 bits each), as K7 takes
    them: (words [3, n_elem, nb] uint32, bits [n_elem, nb] int32). The
    edge blocks first: 96-bit elements after a first element of r bits,
    at every residue r = 0..31 (every element past 32 and 64 bits, more
    than the kernel stages); an empty block; a single bit in the last
    element; blocks of exactly 32, 256 and 1696 bits (1, 8 and 53 words)
    and one bit more (past caps 1, 8 and 53); elements of 32, 33, 64 and
    65 bits; 8 and 9 elements past 32 bits (as many as the kernel stages,
    and one more); then sparse Q50-like blocks of short elements; cut to
    nb."""
    rng = np.random.default_rng(seed)
    e = n_elem
    rows = []

    def add(lens: dict):
        row = np.zeros(e, np.int64)
        for k, v in lens.items():
            if k < e:
                row[k] = v
        rows.append(row)

    for r in range(32):
        add({0: r, **{k: 96 for k in range(1, e)}})
    add({})
    add({e - 1: 1})
    for words in (1, 8, 53):
        n96, rest = divmod(32 * words, 96)
        exact = {k: 96 for k in range(n96)}
        if rest:
            exact[n96] = rest
        add(exact)
        add({**exact, e - 1: 1})
    add({k: (32, 33, 64, 65)[k % 4] for k in range(e)})
    for n_long in (8, 9):
        picks = rng.choice(np.arange(e), min(n_long, e), replace=False)
        add({**{int(k): 5 for k in rng.choice(np.arange(e), 10)},
             **{int(k): int(rng.integers(33, 97)) for k in picks}})
    lens = np.stack(rows)
    fill = max(nb - lens.shape[0], 0)
    sparse = np.zeros((fill, e), np.int64)
    for i in range(fill):
        k = rng.choice(np.arange(e), int(rng.integers(0, 12)), replace=False)
        sparse[i, k] = rng.integers(2, 27, len(k))
    bits = np.concatenate([lens, sparse])[:nb]
    words = _msb_words(rng, bits, 3)  # [nb, e, 3]
    return (np.ascontiguousarray(words.transpose(2, 1, 0)),
            np.ascontiguousarray(bits.T).astype(np.int32))


def k10_segments(kind: str, nseg: int, sw: int, seed: int) -> tuple:
    """nseg segments of sw words, zero past each one's bits, as K8 makes
    them: (segs [nseg, sw] uint32, seg_bits [nseg] int32). kind "mixed":
    empty, shorter than a word, full and any; "short": 0-31 bits;
    "aligned": multiples of 32 (every segment and the total end on a word
    boundary); "partial": any, the total not a multiple of 32; "empty":
    no bits at all; "full": every segment full."""
    rng = np.random.default_rng(seed)
    top = sw * 32
    if kind == "short":
        bits = rng.integers(0, 32, nseg)
    elif kind == "aligned":
        bits = 32 * rng.integers(0, sw + 1, nseg)
    elif kind == "empty":
        bits = np.zeros(nseg, np.int64)
    elif kind == "full":
        bits = np.full(nseg, top)
    else:
        bits = rng.integers(0, top + 1, nseg)
        bits[rng.random(nseg) < 0.25] = 0
        bits[rng.random(nseg) < 0.25] = rng.integers(1, 32)
        bits[rng.random(nseg) < 0.1] = top
        if kind == "partial" and bits.sum() % 32 == 0:
            bits[-1] = 7 if bits[-1] != 7 else 9
    return _msb_words(rng, bits, sw), bits.astype(np.int32)


# (kind, segments, words a segment, stream words past the total's words):
# one-segment streams, a total on a word boundary with no zeros after
# it, a last word that is partial, empty and sub-word segments
K10_CASES = (
    ("mixed", 300, 9, 100),
    ("short", 200, 2, 7),
    ("aligned", 150, 5, 0),
    ("aligned", 150, 5, 33),
    ("partial", 77, 4, 0),
    ("mixed", 1, 40, 5),
    ("full", 1, 3, 0),
    ("empty", 50, 3, 10),
)


def k10_case(i: int) -> tuple:
    """K10_CASES[i] made: (segs, seg_bits, out_words)."""
    kind, nseg, sw, extra = K10_CASES[i]
    segs, bits = k10_segments(kind, nseg, sw, seed=100 + i)
    return segs, bits, (int(bits.astype(np.int64).sum()) + 31) // 32 + extra


# K9's streams: K10's, then segments of whole bytes (a total on a byte
# boundary that is not a word boundary), and more segments than one
# thread block's shared memory holds (some 29,000 on an H100: the scan
# goes to global scratch)
K9_CASES = K10_CASES + (
    ("byte", 120, 3, 4),
    ("short", 30000, 1, 3),
)


def k9_case(i: int) -> tuple:
    """K9_CASES[i] made: (segs, seg_bits, out_words). The cases K10 shares
    are made from K10's seeds."""
    if i < len(K10_CASES):
        return k10_case(i)
    kind, nseg, sw, extra = K9_CASES[i]
    rng = np.random.default_rng(200 + i)
    if kind == "byte":
        bits = 8 * rng.integers(0, 4 * sw + 1, nseg)
        if bits.sum() % 32 == 0:
            bits[-1] = 8 if bits[-1] != 8 else 16
        segs = _msb_words(rng, bits, sw)
    else:
        segs, bits = k10_segments(kind, nseg, sw, seed=200 + i)
    bits = bits.astype(np.int32)
    return segs, bits, (int(bits.astype(np.int64).sum()) + 31) // 32 + extra


# K8's rows (ws, nbh, nbw, cap, kind): every segment width, ragged last
# segments (nbw % ws != 0), rows narrower than a segment, one block a row,
# blocks that are empty, shorter than a word (many to a word), exactly
# cap * 32 bits and past it (clamped), and the 4:2:0 MCU streams' caps
# 48, 96 and 318
K8_CASES = (
    (16, 3, 37, 8, "mixed"),
    (32, 4, 70, 8, "mixed"),
    (64, 2, 130, 8, "mixed"),
    (128, 2, 300, 8, "mixed"),
    (128, 3, 7, 8, "mixed"),
    (16, 5, 1, 8, "mixed"),
    (32, 2, 40, 1, "full"),
    (128, 2, 140, 2, "clamped"),
    (64, 3, 64, 4, "empty"),
    (64, 2, 100, 8, "short"),
    (16, 2, 33, 48, "mixed"),
    (128, 1, 150, 96, "mixed"),
    (32, 2, 36, 318, "mixed"),
)


def k8_case(i: int) -> tuple:
    """K8_CASES[i] made: (words [cap, nb] uint32, bits [nb] int32, nbh,
    nbw, ws). A block's words are zero past its bits, as K4 and K5 store
    them; a block past cap * 32 bits (it overflowed) fills its cap words.
    kind "mixed": any count, a quarter empty, a fifth under a word, a
    tenth exactly cap * 32 and a tenth past it; "full": every block cap *
    32; "clamped": every block past it; "empty": no bits at all; "short":
    0-12 bits a block, so a word holds many blocks."""
    ws, nbh, nbw, cap, kind = K8_CASES[i]
    rng = np.random.default_rng(300 + i)
    nb, top = nbh * nbw, cap * 32
    if kind == "full":
        bits = np.full(nb, top)
    elif kind == "clamped":
        bits = top + rng.integers(1, 500, nb)
    elif kind == "empty":
        bits = np.zeros(nb, np.int64)
    elif kind == "short":
        bits = rng.integers(0, 13, nb)
    else:
        bits = rng.integers(0, top + 1, nb)
        u = rng.random(nb)
        bits[u < 0.25] = 0
        bits[(u >= 0.25) & (u < 0.45)] = rng.integers(1, 32)
        bits[(u >= 0.45) & (u < 0.55)] = top
        bits[(u >= 0.55) & (u < 0.65)] = top + rng.integers(1, 100)
    words = _msb_words(rng, np.minimum(bits, top), cap).T.copy()
    return words, bits.astype(np.int32), nbh, nbw, ws


# (fy, fx) of each subsampling K5 takes
SAMPLING = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}


def k5_streams(nmch: int, nmcw: int, subsampling: str, cap: int,
               seed: int) -> tuple:
    """K4-like block streams of an nmch x nmcw MCU grid, as K5 takes them:
    (words_y [cap, ny] uint32, bits_y [ny] int32, words_c [cap, 2 * nmcu]
    uint32, bits_c [2 * nmcu] int32), luma in raster order over the luma
    grid, Cb then Cr in MCU order, words zero past each block's bits (a
    block past cap * 32 bits keeps cap full words, as K4 stores an
    overflowed one). The edge MCUs first (E slots each): all empty; all
    full; all past cap * 32 (clamped); slots of 1-7 bits, several in one
    word; one bit in the last slot only; slots of 31, 32 and 33 bits;
    slots of whole bytes; then slots drawn from 0, 1-31, 32 * k and k
    bits, full and past cap * 32; cut to nmch * nmcw."""
    fy, fx = SAMPLING[subsampling]
    ky, e, top = fy * fx, fy * fx + 2, 32 * cap
    nmcu = nmch * nmcw
    rng = np.random.default_rng(seed)
    rows = [[0] * e, [top] * e, [top + 9] * e, list(range(1, e + 1)),
            [7, 1, 3, 0, 5, 2][:e], [0] * (e - 1) + [1], [31] * e,
            [32] * e, [33] * e, [8 * (k + 1) for k in range(e)]]
    pick = (lambda: 0, lambda: int(rng.integers(1, 32)),
            lambda: 32 * int(rng.integers(1, cap + 1)),
            lambda: int(rng.integers(0, top + 1)), lambda: top,
            lambda: top + int(rng.integers(1, 64)))
    while len(rows) < nmcu:
        rows.append([pick[int(rng.integers(0, len(pick)))]()
                     for _ in range(e)])
    counts = np.array(rows[:nmcu], np.int64)  # [nmcu, E]
    words = _msb_words(rng, np.minimum(counts, top), cap)  # [nmcu, E, cap]
    m = np.arange(nmcu)
    my, mx = m // nmcw, m % nmcw
    bits_y = np.zeros(ky * nmcu, np.int64)
    words_y = np.zeros((cap, ky * nmcu), np.uint32)
    for s in range(ky):
        blk = (fy * my + s // fx) * (fx * nmcw) + fx * mx + s % fx
        bits_y[blk] = counts[:, s]
        words_y[:, blk] = words[:, s].T
    bits_c = np.concatenate([counts[:, ky], counts[:, ky + 1]])
    words_c = np.concatenate([words[:, ky].T, words[:, ky + 1].T], axis=1)
    return (words_y, bits_y.astype(np.int32),
            np.ascontiguousarray(words_c), bits_c.astype(np.int32))
