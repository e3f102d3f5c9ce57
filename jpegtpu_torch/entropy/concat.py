"""K8 + K9 + K11: per-block streams -> one scan-order stream, or one
stream per image of a batch (counterpart of
`jpegtpu/entropy/pallas_concat.py`: merge_sublanes_pallas,
stream_concat_pallas, concat_raw_pallas, _stream_concat_rows and
concat_segments_pallas; and of `jpegtpu/entropy/treepack.py`:
_apply_tail_padding and apply_tail_padding_segments).

A row segment holds up to ws consecutive blocks of one block row (ws a
power of two, 16..128; 128 for the single-image scan): segment (br, c) is
blocks br * nbw + c * ws + l, l < ws, so a row of nbw blocks has
ceil(nbw / ws) segments and the last is ragged when nbw % ws != 0 (its
pad lanes contribute nothing). Segments run in scan order (br, c), each
ws * (cap + 1) words, as jpegtpu's row segments are (cap + 1) * 128 words
at ws = 128. Words travel as int32 bit patterns (see entropy.pack).

A batch stacks its images vertically, so image i owns a run of whole
block rows and so a run of segments; K11 lays each image's segments back
to back in a slab of its own.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .pack import deposit, to_int32

LANES = 128
SEGMENT_WIDTHS = (16, 32, 64, 128)


def _segments(nbh: int, nbw: int, ws: int) -> int:
    return nbh * (-(-nbw // ws))


def merge_rows(words: torch.Tensor, bits: torch.Tensor, nbh: int, nbw: int,
               ws: int = LANES):
    """K8: words [cap, nb] int32 + bits [nb] int32 -> (segments
    [S, ws * (cap + 1)] int32, segment bit counts [S] int32).

    A block's bits count at most cap * 32 here: a block past that
    overflowed and the encode retries at a larger cap. On CUDA tensors
    this launches csrc/concat.cu (merge_rows), whose thread block holds
    max(ws, 32) * (cap + 1) words of segments in shared memory; it raises
    if the card cannot hold that. On CPU tensors it runs
    `merge_rows_plain`."""
    cap, nb = words.shape
    if nb != nbh * nbw or bits.shape != (nb,):
        raise ValueError(f"words {tuple(words.shape)} / bits "
                         f"{tuple(bits.shape)} do not match {nbh}x{nbw} blocks")
    if ws not in SEGMENT_WIDTHS:
        raise ValueError(f"segment width {ws} is not one of {SEGMENT_WIDTHS}")
    if words.device.type == "cpu":
        return merge_rows_plain(words, bits, nbh, nbw, ws)
    _build.require_cuda(words, "words", torch.int32)
    _build.require_cuda(bits, "bits", torch.int32)
    limit = _merge_rows_max_cap(words.device, ws)
    if cap > limit:
        raise ValueError(
            f"merge_rows: segments of cap {cap} at width {ws} need "
            f"{(cap + 1) * max(ws, 32) * 4} B of shared memory per block; "
            f"this card holds at most cap {limit}")
    nseg = _segments(nbh, nbw, ws)
    segs = torch.empty((nseg, ws * (cap + 1)), dtype=torch.int32,
                       device=words.device)
    seg_bits = torch.empty((nseg,), dtype=torch.int32, device=words.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "concat", "merge_rows", (P, P, I, I, I, I, I, P, P),
        words.data_ptr(), bits.data_ptr(), nb, cap, nbh, nbw, ws,
        segs.data_ptr(), seg_bits.data_ptr(), device=words.device,
    )
    return segs, seg_bits


@functools.lru_cache(maxsize=None)
def _merge_rows_max_cap(device: torch.device, ws: int) -> int:
    with torch.cuda.device(device):
        return _build.query("concat", "merge_rows_max_cap", (ctypes.c_int,),
                            ws)


def merge_rows_plain(words: torch.Tensor, bits: torch.Tensor, nbh: int,
                     nbw: int, ws: int = LANES):
    """Plain PyTorch K8 (any device), the same function as the kernel."""
    cap, nb = words.shape
    dev = words.device
    width = -(-nbw // ws) * ws
    b = torch.zeros((nbh, width), dtype=torch.int64, device=dev)
    b[:, :nbw] = bits.to(torch.int64).clamp(max=cap * 32).reshape(nbh, nbw)
    w = torch.zeros((cap, nbh, width), dtype=torch.int64, device=dev)
    w[:, :, :nbw] = (words.to(torch.int64) & 0xFFFFFFFF).reshape(cap, nbh, nbw)
    b = b.reshape(-1, ws)  # [S, ws]
    w = w.reshape(cap, -1, ws).permute(1, 2, 0)  # [S, ws, cap]
    excl = torch.cumsum(b, dim=1) - b
    offs = excl[..., None] + 32 * torch.arange(cap, device=dev)
    # words past a block's bits are zero (K4 stores them so): deposit all
    segs = deposit(w.reshape(w.shape[0], -1),
                   torch.full_like(offs, 32).reshape(w.shape[0], -1),
                   offs.reshape(w.shape[0], -1), ws * (cap + 1))
    return to_int32(segs), b.sum(dim=1).to(torch.int32)


def stream_concat(segs: torch.Tensor, seg_bits: torch.Tensor,
                  out_words: int):
    """K9: segments [S, SW] int32 + bit counts [S] -> (stream
    [out_words] int32, total bits, a 0-dim int64 tensor). Segment s
    starts at the exclusive cumulative sum of the bit counts before it.

    On CUDA tensors this launches csrc/concat.cu (stream_concat) into a
    zeroed output; on CPU tensors it runs `stream_concat_plain`."""
    if segs.device.type == "cpu":
        return stream_concat_plain(segs, seg_bits, out_words)
    _build.require_cuda(segs, "segs", torch.int32)
    _build.require_cuda(seg_bits, "seg_bits", torch.int32)
    inc = torch.cumsum(seg_bits, 0, dtype=torch.int64)
    offs = inc - seg_bits
    out = torch.zeros((out_words,), dtype=torch.int32, device=segs.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "concat", "stream_concat", (P, P, P, I, I, P, ctypes.c_longlong),
        segs.data_ptr(), seg_bits.data_ptr(), offs.data_ptr(),
        segs.shape[0], segs.shape[1], out.data_ptr(), out_words,
        device=segs.device,
    )
    return out, inc[-1]


def stream_concat_plain(segs: torch.Tensor, seg_bits: torch.Tensor,
                        out_words: int):
    """Plain PyTorch K9 (any device), the same function as the kernel."""
    nseg, sw = segs.shape
    inc = torch.cumsum(seg_bits, 0, dtype=torch.int64)
    offs = (inc - seg_bits)[:, None] + 32 * torch.arange(sw, device=segs.device)
    vals = segs.to(torch.int64) & 0xFFFFFFFF
    out = deposit(vals.reshape(1, -1), torch.full_like(offs, 32).reshape(1, -1),
                  offs.reshape(1, -1), out_words)
    return to_int32(out[0]), inc[-1]


def image_offsets(seg_bits: torch.Tensor, segs_per_image: int):
    """Plain torch prefix sums shared by K11 and its plain version:
    seg_bits [S] -> (each segment's bit offset inside its image [S] int64,
    each image's total bits [B] int64, before tail padding). One flat scan
    over every segment, minus each image's base (a segmented scan of many
    short rows is slow on the card)."""
    inc = torch.cumsum(seg_bits, 0, dtype=torch.int64)
    ends = inc[segs_per_image - 1::segs_per_image]
    base = torch.nn.functional.pad(ends[:-1], (1, 0))
    offs = inc - seg_bits - base.repeat_interleave(segs_per_image)
    return offs, ends - base


def _check_rows(segs: torch.Tensor, seg_bits: torch.Tensor,
                segs_per_image: int) -> None:
    if (segs.dim() != 2 or seg_bits.shape != (segs.shape[0],)
            or segs_per_image < 1 or segs.shape[0] % segs_per_image):
        raise ValueError(f"segs {tuple(segs.shape)} / seg_bits "
                         f"{tuple(seg_bits.shape)} do not split into images "
                         f"of {segs_per_image} segments")


def stream_concat_rows(segs: torch.Tensor, seg_bits: torch.Tensor,
                       segs_per_image: int, slab_words: int,
                       pad_ones: bool = True):
    """K11: segments [S, SW] int32 + bit counts [S], S = B * segs_per_image
    in scan order, image after image -> (streams [B, slab_words] int32,
    total bits [B] int64 with the tail padding): image i's stream is its
    segments back to back, its final partial byte padded with 1s (T.81)
    or left 0s, and its total rounded up to the byte.

    On CUDA tensors this launches csrc/concat.cu (stream_concat_rows, which
    ORs the pad too) into a zeroed output; on CPU tensors it runs
    `stream_concat_rows_plain`."""
    _check_rows(segs, seg_bits, segs_per_image)
    if segs.device.type == "cpu":
        return stream_concat_rows_plain(segs, seg_bits, segs_per_image,
                                        slab_words, pad_ones)
    _build.require_cuda(segs, "segs", torch.int32)
    _build.require_cuda(seg_bits, "seg_bits", torch.int32)
    offs, totals = image_offsets(seg_bits, segs_per_image)
    out = torch.zeros((totals.shape[0], slab_words), dtype=torch.int32,
                      device=segs.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "concat", "stream_concat_rows", (P, P, P, P, I, I, I, I, P, I),
        segs.data_ptr(), seg_bits.data_ptr(), offs.data_ptr(),
        totals.data_ptr(), segs.shape[0], segs.shape[1], segs_per_image,
        int(pad_ones), out.data_ptr(), slab_words, device=segs.device,
    )
    return out, (totals + 7) & -8


def stream_concat_rows_plain(segs: torch.Tensor, seg_bits: torch.Tensor,
                             segs_per_image: int, slab_words: int,
                             pad_ones: bool = True):
    """Plain PyTorch K11 (any device), the same function as the kernel:
    every segment word deposited at its offset in its image's slab, then
    the tail padding."""
    _check_rows(segs, seg_bits, segs_per_image)
    nseg, sw = segs.shape
    offs, totals = image_offsets(seg_bits, segs_per_image)
    n_images = totals.shape[0]
    woffs = offs[:, None] + 32 * torch.arange(sw, device=segs.device)
    vals = segs.to(torch.int64) & 0xFFFFFFFF
    out = deposit(vals.reshape(n_images, -1),
                  torch.full_like(woffs, 32).reshape(n_images, -1),
                  woffs.reshape(n_images, -1), slab_words)
    return apply_tail_padding_segments(to_int32(out), totals, pad_ones)


def stream_words(nb: int, cap: int) -> int:
    """Output size of the scan stream, as jpegtpu sizes it
    (pallas_concat.concat_raw_pallas): room for cap words per block plus
    a margin, so the tail-padding word always exists."""
    return (-(-(nb * cap) // LANES) + cap + 4) * LANES


def concat_stream(words: torch.Tensor, bits: torch.Tensor, nbh: int,
                  nbw: int):
    """Per-block streams [cap, nb] + bits [nb] -> (scan stream int32,
    total bits 0-dim int64): K8 then K9."""
    cap, nb = words.shape
    segs, seg_bits = merge_rows(words, bits, nbh, nbw)
    return stream_concat(segs, seg_bits, stream_words(nb, cap))


def concat_segments(words: torch.Tensor, bits: torch.Tensor, nbh: int,
                    nbw: int, n_images: int, ws: int, pad_ones: bool):
    """Per-block (or per-MCU) streams [C, n] + bits [n] of n_images images
    stacked vertically, an nbh x nbw grid in scan order with nbh / n_images
    rows per image -> (streams [n_images, n / n_images * C] int32, total
    bits [n_images] int64 with the tail padding): K8 at segment width ws,
    then K11. The concat half of jpegtpu's encode_segments_device (its
    concat_segments_pallas and tail padding). Every stream counts at most
    C * 32 bits (K8 clamps an overflowed one) and a total that is a
    multiple of 8 needs no pad, so n / n_images * C words hold every
    image's bits and its pad, as jpegtpu sizes them."""
    c, n = words.shape
    if nbh % n_images:
        raise ValueError(f"{nbh} rows do not split into {n_images} images")
    segs, seg_bits = merge_rows(words, bits, nbh, nbw, ws)
    return stream_concat_rows(segs, seg_bits, segs.shape[0] // n_images,
                              n // n_images * c, pad_ones)


def apply_tail_padding_segments(streams: torch.Tensor, totals: torch.Tensor,
                                pad_ones: bool):
    """Pad each stream's final partial byte with 1s (T.81) or 0s: streams
    [B, W] int32, totals [B] int64 -> (streams, padded totals). `streams`
    is updated in place. The pad only completes the byte holding bit
    `total`, inside one word."""
    padlen = (-totals) % 8
    if pad_ones:
        widx = (totals >> 5).clamp(max=streams.shape[-1] - 1)[:, None]
        off = totals & 31
        mask = ((torch.ones_like(padlen) << padlen) - 1) << (
            32 - off - padlen).clamp(min=0)
        mask = to_int32(torch.where(padlen > 0, mask, 0))[:, None]
        streams.scatter_(1, widx, streams.gather(1, widx) | mask)
    return streams, totals + padlen


def apply_tail_padding(stream: torch.Tensor, total: torch.Tensor,
                       pad_ones: bool):
    """One stream's tail padding: stream [W] int32, total a 0-dim int64
    tensor -> (stream, padded total). `stream` is updated in place."""
    _, padded = apply_tail_padding_segments(stream[None], total.reshape(1),
                                            pad_ones)
    return stream, padded.reshape(())
