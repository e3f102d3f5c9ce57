"""K8 + K9: per-block streams -> one scan-order stream (counterpart of
`jpegtpu/entropy/pallas_concat.py`: merge_sublanes_pallas,
stream_concat_pallas, concat_raw_pallas; and of
`jpegtpu/entropy/treepack.py: _apply_tail_padding`).

A row segment holds up to 128 consecutive blocks of one block row:
segment (br, cg) is blocks br * nbw + cg * 128 + l, l < 128, so a row of
nbw blocks has ncg = ceil(nbw / 128) segments and the last is ragged when
nbw % 128 != 0 (its pad lanes contribute nothing). Segments run in scan
order (br, cg), each (cap + 1) * 128 words, as in jpegtpu. Words travel
as int32 bit patterns (see entropy.pack).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .pack import deposit, to_int32

LANES = 128


def _segments(nbh: int, nbw: int) -> int:
    return nbh * (-(-nbw // LANES))


def merge_rows(words: torch.Tensor, bits: torch.Tensor, nbh: int, nbw: int):
    """K8: words [cap, nb] int32 + bits [nb] int32 -> (segments
    [S, (cap + 1) * 128] int32, segment bit counts [S] int32).

    A block's bits count at most cap * 32 here: a block past that
    overflowed and the encode retries at a larger cap. On CUDA tensors
    this launches csrc/concat.cu (merge_rows); on CPU tensors it runs
    `merge_rows_plain`."""
    cap, nb = words.shape
    if nb != nbh * nbw or bits.shape != (nb,):
        raise ValueError(f"words {tuple(words.shape)} / bits "
                         f"{tuple(bits.shape)} do not match {nbh}x{nbw} blocks")
    if words.device.type == "cpu":
        return merge_rows_plain(words, bits, nbh, nbw)
    _build.require_cuda(words, "words", torch.int32)
    _build.require_cuda(bits, "bits", torch.int32)
    nseg = _segments(nbh, nbw)
    segs = torch.empty((nseg, (cap + 1) * LANES), dtype=torch.int32,
                       device=words.device)
    seg_bits = torch.empty((nseg,), dtype=torch.int32, device=words.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "concat", "merge_rows", (P, P, I, I, I, I, P, P),
        words.data_ptr(), bits.data_ptr(), nb, cap, nbh, nbw,
        segs.data_ptr(), seg_bits.data_ptr(), device=words.device,
    )
    return segs, seg_bits


def merge_rows_plain(words: torch.Tensor, bits: torch.Tensor, nbh: int,
                     nbw: int):
    """Plain PyTorch K8 (any device), the same function as the kernel."""
    cap, nb = words.shape
    dev = words.device
    ncg = -(-nbw // LANES)
    width = ncg * LANES
    b = torch.zeros((nbh, width), dtype=torch.int64, device=dev)
    b[:, :nbw] = bits.to(torch.int64).clamp(max=cap * 32).reshape(nbh, nbw)
    w = torch.zeros((cap, nbh, width), dtype=torch.int64, device=dev)
    w[:, :, :nbw] = (words.to(torch.int64) & 0xFFFFFFFF).reshape(cap, nbh, nbw)
    b = b.reshape(-1, LANES)  # [S, 128]
    w = w.reshape(cap, -1, LANES).permute(1, 2, 0)  # [S, 128, cap]
    excl = torch.cumsum(b, dim=1) - b
    offs = excl[..., None] + 32 * torch.arange(cap, device=dev)
    # words past a block's bits are zero (K4 stores them so): deposit all
    segs = deposit(w.reshape(w.shape[0], -1),
                   torch.full_like(offs, 32).reshape(w.shape[0], -1),
                   offs.reshape(w.shape[0], -1), (cap + 1) * LANES)
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


def apply_tail_padding(stream: torch.Tensor, total: torch.Tensor,
                       pad_ones: bool):
    """Pad the final partial byte with 1s (T.81) or 0s. Returns
    (stream, padded total bits). `stream` is updated in place."""
    padlen = (-total) % 8
    if pad_ones:
        # the pad only completes the byte holding bit `total`: one word
        widx = (total >> 5).reshape(1)
        off = total & 31
        mask = ((torch.ones_like(padlen) << padlen) - 1) << (
            32 - off - padlen).clamp(min=0)
        mask = to_int32(torch.where(padlen > 0, mask, 0).reshape(1))
        stream.index_put_((widx,), stream[widx] | mask)
    return stream, total + padlen
