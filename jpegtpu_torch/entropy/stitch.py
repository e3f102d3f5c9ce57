"""K12: restart segments stitched into one buffer (counterpart of
`jpegtpu/entropy/pallas_concat.py: stitch_segments_pallas`, whose
`_stitch_rows` kernel this replaces, with the K8 row merge before it).

Per-block (gray) or per-MCU (color) streams in scan order, words [C, n]
int32 (words past a stream's bits zero, as K4 and K5 store them) and bit
counts [n], are cut into restart segments of seg_len streams (the last
ragged when n % seg_len != 0). Segment s starts at byte
sum(seg_tot[:s]) / 8 of one buffer; its bits are the exclusive prefix of
its streams' bits, and its last partial byte is padded with 1s (T.81) or
left 0s. seg_tot[s] counts the padding. The host finish is
entropy.host.scan_from_words over the valid word prefix with
seg_bytes = seg_tot / 8: it stuffs each segment and puts RSTn between.

The card has no VMEM budget, so there is one chunk (jpegtpu's stitch_plan
splits the buffer past 14 MB), and no stream is padded to 128-slot rows.
The kernel's two launches do the prefix sums too: the offsets are a scan
over the streams with one operator (csrc/stitch.cu), tiles of
`stitch_tile` streams first composing their spans, then each tile
placing its streams and writing the words that start in its bit range.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .pack import deposit, to_int32


def stitch_words(n: int, c: int, n_seg: int) -> int:
    """Output size: room for every stream's C words, each segment's pad
    byte, and one spare word."""
    return n * c + (7 * n_seg + 31) // 32 + 1


def segment_offsets(bits: torch.Tensor, seg_len: int, cap_bits: int):
    """Plain torch prefix sums of K12's plain version: bits [n] ->
    (stream bit offsets [n] int64, seg_bits [S] int64, seg_tot [S] int64
    byte-aligned, total bits 0-dim int64). A stream's bits count at most
    cap_bits: one past that overflowed and the encode retries at a larger
    cap. (The kernel folds this scan into its two launches.)"""
    n = bits.shape[0]
    dev = bits.device
    b = bits.to(torch.int64).clamp(max=cap_bits)
    # one scan over all streams, cut at each segment's last stream
    inc = torch.cumsum(b, dim=0)
    last = torch.arange(seg_len - 1, n + seg_len - 1, seg_len,
                        device=dev).clamp(max=n - 1)
    seg_end = inc[last]
    seg_bits = seg_end - torch.nn.functional.pad(seg_end[:-1], (1, 0))
    seg_tot = (seg_bits + 7) & -8
    ends = torch.cumsum(seg_tot, dim=0)
    # a stream's offset: its scan prefix, moved from its segment's first
    # bit in the scan to the segment's byte-aligned base
    shift = (ends - seg_tot) - (seg_end - seg_bits)
    seg = torch.arange(n, device=dev) // seg_len
    return inc - b + shift[seg], seg_bits, seg_tot, ends[-1]


def _check(words: torch.Tensor, bits: torch.Tensor, seg_len: int) -> None:
    if (words.dim() != 2 or bits.shape != (words.shape[1],) or seg_len < 1
            or words.shape[1] < 1):
        raise ValueError(f"words {tuple(words.shape)} / bits "
                         f"{tuple(bits.shape)} / seg_len {seg_len}")


THREADS = 256  # K12's thread block (csrc/stitch.cu kThreads)


def stitch_tile(n: int) -> int:
    """Streams per K12 tile: a multiple of THREADS, at least 512, grown so
    that a call has at most 512 tiles up to 4M streams (every tile's block
    composes the spans of all tiles)."""
    return THREADS * min(max(-(-n // (THREADS * 512)), 2), 32)


def stitch_segments(words: torch.Tensor, bits: torch.Tensor, seg_len: int,
                    pad_ones: bool = True):
    """-> (stream [out_words] int32, seg_tot [S] int32, total bits 0-dim
    int64).

    On CUDA tensors this launches csrc/stitch.cu twice, its scan inside:
    stitch_scan (each tile's span of the offset scan) and stitch_segments
    (every output word written once); on CPU tensors it runs
    `stitch_segments_plain`."""
    _check(words, bits, seg_len)
    if words.device.type == "cpu":
        return stitch_segments_plain(words, bits, seg_len, pad_ones)
    _build.require_cuda(words, "words", torch.int32)
    _build.require_cuda(bits, "bits", torch.int32)
    dev = words.device
    c, n = words.shape
    n_seg = -(-n // seg_len)
    out_words = stitch_words(n, c, n_seg)
    tile = stitch_tile(n)
    spans = torch.empty((-(-n // tile), 3), dtype=torch.int64, device=dev)
    out = torch.empty((out_words,), dtype=torch.int32, device=dev)
    seg_tot = torch.empty((n_seg,), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch("stitch", "stitch_scan", (P, I, I, I, I, P),
                  bits.data_ptr(), n, c, seg_len, tile, spans.data_ptr(),
                  device=dev)
    _build.launch(
        "stitch", "stitch_segments",
        (P, P, P, I, I, I, I, I, P, ctypes.c_longlong, P, P),
        words.data_ptr(), bits.data_ptr(), spans.data_ptr(), n, c, seg_len,
        tile, int(pad_ones), out.data_ptr(), out_words, seg_tot.data_ptr(),
        total.data_ptr(), device=dev,
    )
    return out, seg_tot, total


def stitch_segments_plain(words: torch.Tensor, bits: torch.Tensor,
                          seg_len: int, pad_ones: bool = True):
    """Plain PyTorch K12 (any device), the same function as the kernel:
    every stream word deposited at its offset, then each segment's pad
    bits (the bits from its end to the next byte boundary, zero before)."""
    _check(words, bits, seg_len)
    c, n = words.shape
    dev = words.device
    offs, seg_bits, seg_tot, total = segment_offsets(bits, seg_len, c * 32)
    out_words = stitch_words(n, c, seg_tot.shape[0])
    vals = (words.to(torch.int64) & 0xFFFFFFFF).T.reshape(1, -1)
    woffs = (offs[:, None] + 32 * torch.arange(c, device=dev)).reshape(1, -1)
    out = deposit(vals, torch.full_like(woffs, 32), woffs, out_words)[0]
    if pad_ones:
        padlen = seg_tot - seg_bits
        ends = (torch.cumsum(seg_tot, dim=0) - padlen)[None]
        out += deposit(((1 << padlen) - 1)[None], padlen[None], ends,
                       out_words)[0]
    return to_int32(out), seg_tot.to(torch.int32), total
