"""Adversarial inputs for K4 (jpegtpu_torch.entropy.pack.encode_blocks)
and the transforms K1-K3 (jpegtpu_torch.ops.transform), made from a seed
with numpy alone. tests/test_torch_kernel_edges.py holds the port's twins
against jpegtpu on them, and the kernels against the twins on the card;
chip_smoke.py's kernel_edges phase runs the same kernel checks."""
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
