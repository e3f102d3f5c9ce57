"""On-device entropy helpers around the kernels (counterpart of the parts
of `jpegtpu/entropy/device.py` and `jpegtpu/color_pipeline.py` the
single-image paths use): DC differences with restart resets, the symbol
histograms of 2-pass optimal coding, and the worst-case per-block
capacity. Plain PyTorch, as jpegtpu computes these in XLA outside any
kernel.

It also holds jpegtpu's levels -> scan entry point, encode_scan_device,
with its three packers: the fused one (K4 per table class, then K8 and
K9), the staged one (symbolize_elements64 into sub-slots,
treepack._fuse_subslots into 3-word elements, K7, then the same concat)
and the scatter one (symbolize_slots, a cumulative sum and a deposit, in
plain torch as in jpegtpu), and its byte stuffing, stuff_bytes_device
(plain torch on the stream's device). Symbol values are int64 tensors holding
jpegtpu's uint32 codes."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..ops.blocks import sampling_factors
from .concat import (apply_tail_padding, merge_rows, stream_concat,
                     stream_words)
from .pack import (MAX_WORDS_PER_BLOCK, _amplitude, deposit, encode_blocks,
                   pack_blocks, to_int32)
from .treepack import _fuse_subslots


def dc_differences(dc: torch.Tensor, seg_len: int = 0) -> torch.Tensor:
    """DC difference along the last axis: one predictor chain per row,
    starting from 0 (T.81 F.1.2.1) and reset to 0 at every multiple of
    seg_len (a restart segment's first block or MCU, F.1.2.3; 0 = no
    restarts). Gray: [nb], the whole scan. Color: [2, nc], the Cb and Cr
    chains in MCU raster order."""
    prev = torch.nn.functional.pad(dc[..., :-1], (1, 0))
    if seg_len:
        first = torch.arange(dc.shape[-1], device=dc.device) % seg_len == 0
        prev = torch.where(first, 0, prev)
    return dc - prev


def y_dc_differences(dc: torch.Tensor, subsampling: str,
                     seg_mcus: int = 0) -> torch.Tensor:
    """Luma DC differences of a color scan (counterpart of jpegtpu's
    `color_pipeline._y_dc_diff_natural`): dc [R, C] raster Y-plane DCs ->
    differences along the interleaved scan's Y chain, still in [R, C]
    raster layout.

    4:2:0 visits each MCU's 2x2 Y blocks as Y00 Y01 Y10 Y11 (T.81 A.2.3),
    so a block's predecessor is one of a few fixed neighbours:
      col odd            -> left       dc[r, c-1]
      col even, row odd  -> up-right   dc[r-1, c+1]
      col even, row even -> down-left  dc[r+1, c-1]
        (col 0: the previous MCU row's last block dc[r-1, C-1]; the
         first block has predecessor 0)
    4:2:2 and 4:4:4 visit Y in raster order: the predecessor is the left
    block, with the same wrap at col 0. With seg_mcus, the first luma
    block of every seg_mcus-th MCU (a restart segment's start) has
    predecessor 0."""
    r, c = dc.shape
    pad = torch.nn.functional.pad
    left = pad(dc[:, :-1], (1, 0))
    lastcol_up = pad(dc[:-1, -1], (1, 0))[:, None].expand(r, c)
    cols = torch.arange(c, device=dc.device)[None, :]
    rows = torch.arange(r, device=dc.device)[:, None]
    pred = torch.where(cols == 0, lastcol_up, left)
    if subsampling == "420":
        up_right = pad(dc[:-1, 1:], (0, 1, 1, 0))
        down_left = pad(dc[1:, :-1], (1, 0, 0, 1))
        pred = torch.where(cols % 2 == 1, left,
                           torch.where(rows % 2 == 1, up_right,
                                       torch.where(cols == 0, lastcol_up,
                                                   down_left)))
    if seg_mcus:
        fy, fx = sampling_factors(subsampling)
        mcu = (rows // fy) * (c // fx) + cols // fx
        first = (cols % fx == 0) & (rows % fy == 0) & (mcu % seg_mcus == 0)
        pred = torch.where(first, 0, pred)
    return dc - pred


# Layout of the flat per-table-class symbol counts symbol_histograms
# returns, one row per class (0 luminance, 1 chrominance).
HIST_DC = 0      # [12] DC size categories
HIST_AC = 12     # [176] AC (run, size) at run * 11 + size (size >= 1)
HIST_ZRL = 188
HIST_EOB = 189
HIST_SIZE = 190


def _size(v: torch.Tensor) -> torch.Tensor:
    """JPEG size category (bit length of |v|) of an int32 tensor with
    |v| < 2^24, as int32: the binary exponent of |v| in float32, which
    holds such integers exactly (frexp(0) gives 0)."""
    return torch.frexp(v.abs().float()).exponent


def symbol_histograms(levels: torch.Tensor, dc_diff: torch.Tensor,
                      table: int = 0) -> torch.Tensor:
    """Pass 1 of 2-pass optimal Huffman coding, on the levels' device
    (counterpart of jpegtpu.entropy.device.symbol_histograms): levels
    [64, nb] int32 + their DC differences [nb] -> int64 symbol counts
    [2, HIST_SIZE] with every count in row `table` (0 luminance,
    1 chrominance): DC size categories, AC (run, size) with size >= 1,
    ZRL and EOB, exactly the symbols K4 emits for these levels. Counts of
    several calls add. A bincount over run * 11 + size replaces jpegtpu's
    chunked one-hot einsum; the [63, nb] temporaries stay int32."""
    dev = levels.device
    ac = levels[1:]  # [63, nb]
    nz = ac != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=dev)[:, None]
    last = torch.cummax(torch.where(nz, pos, 0), dim=0).values
    prev = torch.nn.functional.pad(last[:-1], (0, 0, 1, 0))
    run = pos - prev - 1  # zeros since the previous nonzero (or DC)
    asize = _size(ac)
    dump = HIST_ZRL - HIST_AC  # symbols K4 never emits land here
    sym = torch.where(nz & (asize <= 10), (run & 15) * 11 + asize, dump)
    dsize = _size(dc_diff)
    counts = torch.zeros((2, HIST_SIZE), dtype=torch.int64, device=dev)
    counts[table, HIST_DC:HIST_AC] = torch.bincount(
        torch.where(dsize <= 11, dsize, 12), minlength=13)[:12]
    counts[table, HIST_AC:HIST_ZRL] = torch.bincount(
        sym.reshape(-1), minlength=dump + 1)[:dump]
    counts[table, HIST_ZRL] = torch.where(nz, run >> 4, 0).sum()
    counts[table, HIST_EOB] = (ac[62] == 0).sum()
    return counts


def assemble_histograms(counts) -> dict:
    """Host finish of symbol_histograms (one readback): counts
    [2, HIST_SIZE] on any device -> 256-bin histograms {'dc_lum',
    'ac_lum', 'dc_chrom', 'ac_chrom'} as tables.optimal_specs_from_
    frequencies takes them."""
    c = counts.cpu().numpy() if torch.is_tensor(counts) else np.asarray(counts)
    out = {}
    for t, kind in ((0, "lum"), (1, "chrom")):
        d = np.zeros(256, np.int64)
        d[:12] = c[t, HIST_DC:HIST_DC + 12]
        a = np.zeros(256, np.int64)
        ac = c[t, HIST_AC:HIST_AC + 176].reshape(16, 11)
        for r in range(16):
            a[(r << 4) + 1:(r << 4) + 11] = ac[r, 1:]
        a[0xF0] = c[t, HIST_ZRL]
        a[0x00] = c[t, HIST_EOB]
        out[f"dc_{kind}"] = d
        out[f"ac_{kind}"] = a
    return out


_ZRL = 0xF0
_EOB = 0x00


@functools.lru_cache(maxsize=None)
def _host_luts():
    """The standard Huffman (codes, lengths) LUTs stacked [table, symbol]
    (0 luminance, 1 chrominance), numpy, from this package's tables:
    DC codes and lengths [2, 16], AC [2, 256], row-major."""
    luts = tables.huffman_luts()

    def stack(kind, i, n):
        return np.ascontiguousarray(np.stack(
            [luts[f"{kind}_lum"][i][:n], luts[f"{kind}_chrom"][i][:n]]))

    return (stack("dc", 0, 16).astype(np.int64),
            stack("dc", 1, 16).astype(np.int64),
            stack("ac", 0, 256).astype(np.int64),
            stack("ac", 1, 256).astype(np.int64))


def _device_luts(device=None):
    """_host_luts as int64 tensors on `device`: (dc_codes, dc_lens,
    ac_codes, ac_lens)."""
    return tuple(torch.from_numpy(a).to(device) for a in _host_luts())


def magnitude_category(v: torch.Tensor) -> torch.Tensor:
    """JPEG size category, the bit length of |v|, as int64: the binary
    exponent of |v| in float64, which holds such integers exactly."""
    return torch.frexp(v.abs().double()).exponent.to(torch.int64)


def _lane_codes(zz: torch.Tensor, table_sel=0, dc_diff=None,
                seg_len: int = 0) -> dict:
    """Per-lane (value, length) pieces of RLE + Huffman coding, as
    jpegtpu's _lane_codes: dc [nb], zrl_a / zrl_b / ac [nb, 63], eob [nb].
    A piece of length 0 is empty (its value is whatever the formula gives,
    as in jpegtpu)."""
    zz = zz.to(torch.int64)
    nb, dev = zz.shape[0], zz.device
    dc_codes, dc_lens, ac_codes, ac_lens = _device_luts(dev)
    tsel = torch.as_tensor(table_sel, dtype=torch.int64,
                           device=dev).expand(nb)
    if dc_diff is None:
        dc_diff = dc_differences(zz[:, 0], seg_len)
    dc_diff = torch.as_tensor(dc_diff, device=dev).to(torch.int64)
    dc_size = magnitude_category(dc_diff)
    dsz = dc_size.clamp(max=15)  # a gather clamps, as jnp's does
    dc_val = (dc_codes[tsel, dsz] << dc_size) | _amplitude(dc_diff,
                                                               dc_size)
    dc_len = dc_lens[tsel, dsz] + dc_size

    ac = zz[:, 1:]
    lanes = torch.arange(1, 64, device=dev)
    nz = ac != 0
    pos = torch.where(nz, lanes, 0)
    # previous nonzero lane before k (DC counts as lane 0)
    prev = torch.cummax(torch.nn.functional.pad(pos, (1, 0)),
                        dim=1).values[:, :-1]
    run = lanes - prev - 1
    zrl_cnt = torch.where(nz, run >> 4, 0)
    rem = torch.where(nz, run & 15, 0)
    ac_size = magnitude_category(ac)
    sym = torch.where(nz, (rem << 4) | ac_size, 0).clamp(max=255)
    ach = ac_codes[tsel[:, None], sym]
    achl = torch.where(nz, ac_lens[tsel[:, None], sym], 0)
    ac_val = (ach << ac_size) | _amplitude(ac, ac_size)
    ac_len = achl + torch.where(nz, ac_size, 0)

    zc = ac_codes[tsel, _ZRL][:, None]
    zl = ac_lens[tsel, _ZRL][:, None]
    n_a = zrl_cnt.clamp(max=2)  # sub-slot A: one or two ZRLs; B: the third
    val_a = torch.where(n_a == 2, (zc << zl) | zc, zc)
    len_a = n_a * zl
    len_b = torch.where(zrl_cnt == 3, zl, 0)

    eob = pos.max(dim=1).values < 63
    eob_len = torch.where(eob, ac_lens[tsel, _EOB], 0)
    return {"dc": (dc_val, dc_len), "zrl_a": (val_a, len_a),
            "zrl_b": (zc.expand(nb, 63), len_b), "ac": (ac_val, ac_len),
            "eob": (ac_codes[tsel, _EOB], eob_len), "nb": nb}


def symbolize_slots(zz: torch.Tensor, table_sel=0, dc_diff=None,
                    seg_len: int = 0):
    """[nb, 64] zigzag levels -> per-slot (values int64, lengths int32)
    [nb, 65, 3] in emission order, as jpegtpu's symbolize_slots: per lane
    [first + second ZRL, third ZRL, the coded symbol] (DC at lane 0, AC
    at 1..63, EOB at lane 64). table_sel: 0 / 1, or a per-block array;
    dc_diff: per-block DC differences (None: the scan's chain, reset
    every seg_len blocks)."""
    c = _lane_codes(zz, table_sel, dc_diff, seg_len)
    nb, dev = c["nb"], zz.device
    values = torch.zeros((nb, 65, 3), dtype=torch.int64, device=dev)
    lengths = torch.zeros((nb, 65, 3), dtype=torch.int64, device=dev)
    for (lane, slot), key in (((0, 2), "dc"), ((slice(1, 64), 0), "zrl_a"),
                              ((slice(1, 64), 1), "zrl_b"),
                              ((slice(1, 64), 2), "ac"), ((64, 2), "eob")):
        values[:, lane, slot], lengths[:, lane, slot] = c[key]
    return values, lengths.to(torch.int32)


def symbolize_elements64(zz: torch.Tensor, table_sel=0, dc_diff=None,
                         seg_len: int = 0):
    """[nb, 64] zigzag levels -> (values int64, lengths int32) [nb, 64, 5],
    as jpegtpu's symbolize_elements64: element e (0..62) is AC lane e + 1
    with sub-slots [DC (e == 0 only), ZRL x 2, ZRL, symbol, EOB (e == 62
    only)], element 63 empty; at most 83 bits per element."""
    c = _lane_codes(zz, table_sel, dc_diff, seg_len)
    nb, dev = c["nb"], zz.device
    values = torch.zeros((nb, 64, 5), dtype=torch.int64, device=dev)
    lengths = torch.zeros((nb, 64, 5), dtype=torch.int64, device=dev)
    for (el, slot), key in (((0, 0), "dc"), ((slice(0, 63), 1), "zrl_a"),
                            ((slice(0, 63), 2), "zrl_b"),
                            ((slice(0, 63), 3), "ac"), ((62, 4), "eob")):
        values[:, el, slot], lengths[:, el, slot] = c[key]
    return values, lengths.to(torch.int32)


def _standard_table(kind: int, device) -> torch.Tensor:
    """K4's [192] table of the standard luminance (0) or chrominance (1)
    class on `device`."""
    return tables.huffman_table(tables.huffman_luts(),
                                ("lum", "chrom")[kind], device)


def _fused_grouped_pack(zz: torch.Tensor, table_sel: np.ndarray,
                        dc_diff: torch.Tensor, cap: int):
    """K4 once per table class over the blocks using it, then a gather
    back to scan order (jpegtpu's _fused_grouped_pack): zz [nslots, 64],
    table_sel numpy [nslots] of 0 / 1, dc_diff [nslots] -> (words
    [cap, nslots], bits [nslots])."""
    dev = zz.device
    perms = [np.nonzero(table_sel == t)[0] for t in (0, 1)]
    inv = np.empty(zz.shape[0], np.int64)
    inv[np.concatenate(perms)] = np.arange(zz.shape[0])
    words, bits = [], []
    for t, idx in enumerate(perms):
        if len(idx):
            sel = torch.from_numpy(idx).to(dev)
            w, b = encode_blocks(zz[sel].T.contiguous(), dc_diff[sel],
                                 _standard_table(t, dev), cap)
            words.append(w)
            bits.append(b)
    inv = torch.from_numpy(inv).to(dev)
    return torch.cat(words, dim=1)[:, inv], torch.cat(bits)[inv]


def stuff_bytes_device(words: torch.Tensor, total_bits: torch.Tensor):
    """0xFF -> 0xFF 00 byte stuffing as a prefix-sum scatter on the
    stream's device (jpegtpu's stuff_bytes_device): words [N] int32 + total
    bits (0-dim) -> (bytes uint8 [8 * N], nbytes 0-dim int64). Each valid
    byte moves right by the 0xFF bytes before it; the stuffed 0x00s are
    the zeros left between."""
    dev = words.device
    n = words.shape[0] * 4
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    raw = ((words.to(torch.int64)[:, None] >> shifts) & 0xFF).reshape(-1)
    nbytes = (total_bits.to(torch.int64) + 7) >> 3
    valid = torch.arange(n, device=dev) < nbytes
    is_ff = (raw == 0xFF) & valid
    dest = torch.arange(n, device=dev) + torch.cumsum(is_ff, 0) - is_ff.long()
    out = torch.zeros((2 * n,), dtype=torch.uint8, device=dev)
    out[dest] = torch.where(valid, raw, 0).to(torch.uint8)
    return out, nbytes + is_ff.sum()


def encode_scan_device(zz, table_sel=0, dc_diff=None, seg_len: int = 0,
                       capacity_words: int | None = None,
                       pad_ones: bool = True, packer: str = "tree",
                       stuff: bool = True, deposit_threshold: int = 256,
                       fused: bool = True):
    """Entropy-encode one scan: zigzag levels [nb, 64] (a tensor on any
    device, or numpy on the CPU) -> (words int32 [N], total bits, overflow)
    with stuff=False, or (stuffed bytes uint8 [8 * N], nbytes, overflow)
    with stuff=True; sizes and flags are 0-dim tensors on zz's device.
    jpegtpu's encode_scan_device, with its arguments and defaults.

    table_sel: 0 / 1 for every block, or a per-block array (an interleaved
    color scan); dc_diff: per-block DC differences (None: the scan's
    chain, reset every seg_len blocks). capacity_words (default nb * 53)
    sets cap = capacity_words // nb words per block; a block past it sets
    overflow, and the caller retries with more. The total includes the
    tail padding of the last byte (1s with pad_ones).

    packer="tree", the fused branch (an int table_sel, or an array with
    dc_diff, unless fused=False): K4 once per table class, back to scan
    order, K8, K9, tail padding.
    The staged branch (fused=False, or an array without dc_diff):
    symbolize_elements64, treepack._fuse_subslots into 3-word elements,
    K7, then the same concat. Both run at every cap: jpegtpu's fused
    kernel stops at cap 16 and its staged one at caps 3-16, where it
    leaves for an XLA block reduce with the same bytes. packer="scatter":
    symbolize_slots, one cumulative sum, a deposit into capacity_words
    words (plain torch, no kernel, as in jpegtpu). deposit_threshold
    tunes jpegtpu's XLA merge tree, which the port does not have; it is
    accepted and unused.

    On CUDA tensors the kernels run on the card; on CPU tensors their
    plain versions. stuff=True stuffs with stuff_bytes_device on zz's
    device, so nothing is read back."""
    del deposit_threshold
    zz = torch.as_tensor(zz).to(torch.int32)
    nb, dev = zz.shape[0], zz.device
    if capacity_words is None:
        capacity_words = nb * MAX_WORDS_PER_BLOCK
    multi_table = not isinstance(table_sel, int)
    if multi_table:
        table_sel = np.asarray(torch.as_tensor(table_sel).cpu())
    if dc_diff is not None:
        dc_diff = torch.as_tensor(dc_diff, device=dev).to(torch.int32)
    if packer == "tree":
        # the kernels run at no more words than the longest block takes;
        # the stream keeps jpegtpu's size for the capacity asked
        rung = max(1, capacity_words // nb)
        cap = min(rung, MAX_WORDS_PER_BLOCK)
        if fused and (not multi_table or dc_diff is not None):
            if multi_table:
                words, bits = _fused_grouped_pack(zz, table_sel, dc_diff, cap)
            else:
                if dc_diff is None:
                    dc_diff = dc_differences(zz[:, 0], seg_len)
                words, bits = encode_blocks(zz.T.contiguous(), dc_diff,
                                            _standard_table(table_sel, dev),
                                            cap)
            overflow = (bits > cap * 32).any()
        else:
            sel = torch.from_numpy(table_sel).to(dev) if multi_table \
                else table_sel
            values, lengths = symbolize_elements64(zz, sel, dc_diff, seg_len)
            words_t, bits_t = _fuse_subslots(values, lengths, 3)
            words, bits, overflow = pack_blocks(words_t, bits_t, cap)
        segs, seg_bits = merge_rows(words, bits, 1, nb)
        stream, total = stream_concat(segs, seg_bits, stream_words(nb, rung))
        stream, total = apply_tail_padding(stream, total, pad_ones)
    else:
        sel = torch.from_numpy(table_sel).to(dev) if multi_table \
            else table_sel
        values, lengths = symbolize_slots(zz, sel, dc_diff, seg_len)
        stream, total = pack_bits_device(values, lengths, capacity_words,
                                         pad_ones)
        overflow = total > capacity_words * 32
    if not stuff:
        return stream, total, overflow
    return (*stuff_bytes_device(stream, total), overflow)


def pack_bits_device(values: torch.Tensor, lengths: torch.Tensor,
                     capacity_words: int, pad_ones: bool = True):
    """Codes (values int64 < 2^32, lengths <= 32, any shape, in emission
    order) -> (words int32 [capacity_words], total bits as a 0-dim int64
    tensor, with the final byte's padding), as jpegtpu's
    pack_bits_device: an exclusive cumulative sum of the lengths gives
    each code's offset, the pad is one more code, and `deposit` places
    them; bits past capacity_words are dropped."""
    lengths = lengths.reshape(-1).to(torch.int64)
    values = torch.where(lengths > 0, values.reshape(-1).to(torch.int64), 0)
    ends = torch.cumsum(lengths, 0)
    total = ends[-1] if lengths.numel() else ends.new_zeros(())
    padlen = (-total) % 8
    padval = (1 << padlen) - 1 if pad_ones else torch.zeros_like(padlen)
    values = torch.cat([values, padval.reshape(1)])
    lengths = torch.cat([lengths, padlen.reshape(1)])
    offs = torch.cat([ends - lengths[:-1], total.reshape(1)])
    words = deposit(values[None], lengths[None], offs[None], capacity_words)
    return to_int32(words[0]), total + padlen
