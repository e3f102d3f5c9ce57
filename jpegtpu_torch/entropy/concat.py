"""K8 + K9 + K10 + K11: per-block streams -> one scan-order stream, or
one stream per image of a batch (counterpart of
`jpegtpu/entropy/pallas_concat.py`: merge_sublanes_pallas,
stream_concat_pallas, concat_raw_pallas, stream_concat_chunked,
concat_raw_chunked, _stream_concat_rows, concat_segments_pallas, and the
concat decision fits_vmem / chunk_plan / concat_mode; and of
`jpegtpu/entropy/treepack.py`: _apply_tail_padding and
apply_tail_padding_segments).

A row segment holds up to ws consecutive blocks of one block row (ws a
power of two, 16..128; 128 for the single-image scan): segment (br, c) is
blocks br * nbw + c * ws + l, l < ws, so a row of nbw blocks has
ceil(nbw / ws) segments and the last is ragged when nbw % ws != 0 (its
pad lanes contribute nothing). Segments run in scan order (br, c), each
ws * (cap + 1) words, as jpegtpu's row segments are (cap + 1) * 128 words
at ws = 128. Words travel as int32 bit patterns (see entropy.pack).

A single scan's segments become one stream by K9 or K10, split as
jpegtpu splits its twins: K9 where jpegtpu's stream buffer fits its VMEM
budget (`concat_mode` "pallas-resident") and on every staged entropy
scan, K10 everywhere else. Both are one launch of one body
(csrc/concat.cu join_stream) that scans the bit counts itself, builds
every output word once from the segments covering it, stores the zeros
past the total and, when asked (`pad_ones` True or False), pads the last
byte and returns the total rounded up to it: no zero-fill, cumsum or
padding ops around it. They differ in their launch shape: K9's streams
are small, so it runs one thread block of 512 an SM, K10 one of 1024
(tools/torch_kernel_ab.py's sweep). The TPU's K10 cuts the stream into
worst-case-sized VMEM chunks that an XLA epilogue ORs together; those
have no counterpart on the card. Both write the same stream.

A batch stacks its images vertically, so image i owns a run of whole
block rows and so a run of segments; K11 lays each image's segments back
to back in a slab of its own: each thread block scans its image's bit
counts and builds its tile of slab words from the segments covering them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .pack import deposit, to_int32

LANES = 128
SUBLANES = 8
SEGMENT_WIDTHS = (16, 32, 64, 128)
# jpegtpu's VMEM budget for the resident stream buffer
# (pallas_concat.fits_vmem, chunk_plan). It decides where K9 or K10 runs;
# nothing on the card is sized by it.
VMEM_BUDGET = 14 << 20
# Segments per chunk of K10's plain version on CPU tensors; its stream
# does not depend on the chunk size.
PLAIN_TILE = 16


def _segments(nbh: int, nbw: int, ws: int) -> int:
    return nbh * (-(-nbw // ws))


def merge_rows(words: torch.Tensor, bits: torch.Tensor, nbh: int, nbw: int,
               ws: int = LANES):
    """K8: words [cap, nb] int32 + bits [nb] int32 -> (segments
    [S, ws * (cap + 1)] int32, segment bit counts [S] int32).

    A block's bits count at most cap * 32 here: a block past that
    overflowed and the encode retries at a larger cap. On CUDA tensors
    this is one launch of csrc/concat.cu (merge_rows), whose thread block
    stages max(ws, 32) * (cap + 1) words of segments in shared memory and
    writes every segment word once with 16-byte stores; it raises if the
    card cannot hold that. On CPU tensors it runs `merge_rows_plain`."""
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


# The stream words each of K9's thread blocks (one of 512 threads an SM,
# csrc/concat.cu kK9Threads) takes at least.
K9_MIN_WORDS = 2048


def _pad_code(pad_ones: bool | None) -> int:
    """The kernels' pad argument: -1 no tail padding, 0 pad bits 0, 1 pad
    bits 1."""
    return -1 if pad_ones is None else int(bool(pad_ones))


def _check_join(segs: torch.Tensor, seg_bits: torch.Tensor) -> None:
    if segs.dim() != 2 or seg_bits.shape != (segs.shape[0],) \
            or segs.shape[0] < 1:
        raise ValueError(f"segs {tuple(segs.shape)} / seg_bits "
                         f"{tuple(seg_bits.shape)} do not match")


def _join(kernel: str, segs: torch.Tensor, seg_bits: torch.Tensor,
          out_words: int, pad_ones: bool | None, grid) -> tuple:
    """One launch of K9 or K10 (`kernel`): allocates the stream and the
    total, and the scan's global scratch where the segments' scan does
    not fit shared memory (then two launches). grid(scratch) -> the
    kernel's thread blocks."""
    _build.require_cuda(segs, "segs", torch.int32)
    _build.require_cuda(seg_bits, "seg_bits", torch.int32)
    dev = segs.device
    nseg, sw = segs.shape
    out = torch.empty((out_words,), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    scratch = (None if rows_scan_fits(nseg, _smem_optin(dev))
               else torch.empty((nseg,), dtype=torch.int64, device=dev))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch(
        "concat", kernel, (P, P, P, I, I, I, I, P, L, P),
        segs.data_ptr(), seg_bits.data_ptr(),
        None if scratch is None else scratch.data_ptr(), nseg, sw,
        grid(scratch is not None), _pad_code(pad_ones), out.data_ptr(),
        out_words, total.data_ptr(), device=dev,
    )
    return out, total


def stream_concat_blocks(out_words: int, most: int,
                         min_words: int = K9_MIN_WORDS) -> int:
    """K9's thread blocks: `most` (one an SM), but no more than one per
    min_words stream words, since each block scans every bit count before
    it writes."""
    return max(1, min(most, -(-out_words // min_words)))


def stream_concat(segs: torch.Tensor, seg_bits: torch.Tensor,
                  out_words: int, pad_ones: bool | None = None):
    """K9: segments [S, SW] int32 + bit counts [S] -> (stream
    [out_words] int32, total bits, a 0-dim int64 tensor). Segment s
    starts at the exclusive cumulative sum of the bit counts before it; a
    segment holds at most SW * 32 bits, as K8's do. With pad_ones True
    or False the last partial byte is padded with 1s (T.81) or left 0s
    and the total is rounded up to the byte, as apply_tail_padding does;
    None leaves both as they are.

    On CUDA tensors this is one launch of csrc/concat.cu (stream_concat)
    that writes every stream word once, zeros past the total and the pad
    included, and the total: each of its thread blocks (one of 512 an SM,
    stream_concat_blocks) scans the bit counts in shared memory and
    builds its share of the words. Past `rows_scan_fits` (some 29,000
    segments) a second launch writes the scan to global scratch first. On
    CPU tensors it runs `stream_concat_plain`, then apply_tail_padding."""
    _check_join(segs, seg_bits)
    if segs.device.type == "cpu":
        out, total = stream_concat_plain(segs, seg_bits, out_words)
        return _padded(out, total, pad_ones)
    return _join(
        "stream_concat", segs, seg_bits, out_words, pad_ones,
        lambda scratch: stream_concat_blocks(
            out_words, _k9_blocks(segs.device, segs.shape[0], scratch)))


def _padded(stream: torch.Tensor, total: torch.Tensor,
            pad_ones: bool | None):
    if pad_ones is None:
        return stream, total
    return apply_tail_padding(stream, total, pad_ones)


@functools.lru_cache(maxsize=None)
def _k9_blocks(device: torch.device, nseg: int, scratch: bool) -> int:
    """K9's most thread blocks: one an SM."""
    with torch.cuda.device(device):
        per_sm = _build.query("concat", "stream_concat_per_sm",
                              (ctypes.c_int, ctypes.c_int), nseg,
                              int(scratch))
    if per_sm < 1:
        raise RuntimeError(f"stream_concat: no thread block for {nseg} "
                           f"segments fits an SM ({per_sm})")
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def chunked_blocks(out_words: int, resident: int) -> int:
    """K10's thread blocks (of 1024 threads): as many as the card holds at
    once (`resident`), but no more than one per 4096 stream words, since
    each block scans every bit count before it writes."""
    return stream_concat_blocks(out_words, resident, 4096)


def stream_concat_chunked(segs: torch.Tensor, seg_bits: torch.Tensor,
                          out_words: int, pad_ones: bool | None = None):
    """K10: the contract of stream_concat (segments [S, SW] int32 from K8
    + bit counts [S] -> (stream [out_words] int32, total bits, a 0-dim
    int64 tensor), the tail padding when pad_ones is True or False), for
    streams past jpegtpu's resident budget.

    On CUDA tensors this is one launch of csrc/concat.cu
    (stream_concat_chunked), K9's body in thread blocks of 1024, as many
    as the card holds at once (chunked_blocks); past `rows_scan_fits`
    (some 29,000 segments) a second launch writes the scan to global
    scratch first. On CPU tensors it runs `stream_concat_chunked_plain`
    in chunks of PLAIN_TILE segments, then apply_tail_padding."""
    _check_join(segs, seg_bits)
    if segs.device.type == "cpu":
        out, total = stream_concat_chunked_plain(segs, seg_bits, out_words,
                                                 PLAIN_TILE)
        return _padded(out, total, pad_ones)
    return _join(
        "stream_concat_chunked", segs, seg_bits, out_words, pad_ones,
        lambda scratch: chunked_blocks(out_words, _chunked_resident(
            segs.device, segs.shape[0], scratch)))


@functools.lru_cache(maxsize=None)
def _chunked_resident(device: torch.device, nseg: int, scratch: bool) -> int:
    """K10's thread blocks the whole card holds at once."""
    with torch.cuda.device(device):
        per_sm = _build.query("concat", "stream_concat_chunked_per_sm",
                              (ctypes.c_int, ctypes.c_int), nseg,
                              int(scratch))
    if per_sm < 1:
        raise RuntimeError(f"stream_concat_chunked: no thread block of "
                           f"{nseg} segments fits an SM ({per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return per_sm * sms


@functools.lru_cache(maxsize=None)
def _smem_optin(device: torch.device) -> int:
    with torch.cuda.device(device):
        return _build.query("concat", "smem_optin", ())


def stream_concat_chunked_plain(segs: torch.Tensor, seg_bits: torch.Tensor,
                                out_words: int, tile: int):
    """Plain PyTorch K10 (any device), the function of jpegtpu's
    concat_raw_chunked: the segments in chunks of `tile`; each chunk's
    stream based at the 128-word row floor of its first segment's offset;
    the chunk streams OR-combined at their base words (their bits are
    disjoint, so the OR is a sum)."""
    nseg, sw = segs.shape
    dev = segs.device
    inc = torch.cumsum(seg_bits, 0, dtype=torch.int64)
    offs = inc - seg_bits
    n_chunks = -(-nseg // tile)
    pad = n_chunks * tile - nseg
    vals = torch.nn.functional.pad(segs.to(torch.int64) & 0xFFFFFFFF,
                                   (0, 0, 0, pad))
    offs = torch.cat([offs, inc[-1:].expand(pad)]).reshape(n_chunks, tile)
    base = (offs[:, 0] >> 12) * LANES  # words
    chunk_words = tile * sw + 2 * LANES
    woffs = (offs - 32 * base[:, None])[..., None] + 32 * torch.arange(
        sw, device=dev)
    chunks = deposit(vals.reshape(n_chunks, -1),
                     torch.full_like(woffs, 32).reshape(n_chunks, -1),
                     woffs.reshape(n_chunks, -1), chunk_words)
    flat = torch.zeros(out_words + chunk_words, dtype=torch.int64, device=dev)
    idx = base[:, None] + torch.arange(chunk_words, device=dev)
    flat.index_add_(0, idx.reshape(-1), chunks.reshape(-1))
    return to_int32(flat[:out_words]), inc[-1]


def fits_vmem(nbh: int, nbw: int, cap: int, ncg: int,
              budget: int | None = None) -> bool:
    """jpegtpu's test (pallas_concat.fits_vmem): whether the resident
    stream buffer of an nbh x nbw grid of streams of cap words (ncg
    column groups of 128) plus two steps of row segments fits `budget`
    (None: VMEM_BUDGET)."""
    budget = VMEM_BUDGET if budget is None else budget
    sr = cap + 1
    out_rows = -(-(nbh * nbw * cap) // LANES) + sr + 3
    step_bytes = ncg * SUBLANES * sr * LANES * 4
    return out_rows * LANES * 4 + 2 * step_bytes <= budget


def chunk_plan(cap: int, ncg: int, budget: int | None = None) -> int:
    """jpegtpu's chunk size (pallas_concat.chunk_plan): row groups per
    worst-case VMEM chunk, 0 when even one does not fit (its tree
    fallback). K10 on the card has no chunks; this only names jpegtpu's
    mode."""
    budget = VMEM_BUDGET if budget is None else budget
    sr = cap + 1
    step_bytes = ncg * SUBLANES * sr * LANES * 4
    avail = budget - 2 * step_bytes
    rows_per_rg = SUBLANES * ncg * cap
    return max((avail // (LANES * 4) - (sr + 4)) // rows_per_rg, 0)


def concat_mode(nbh: int, nbw: int, cap: int, ncg: int) -> str:
    """jpegtpu's concat for this geometry (pallas_concat.concat_mode):
    "pallas-resident", "pallas-chunked" or "treepack-fallback". The port
    runs K9 for the first and K10 for the other two."""
    if fits_vmem(nbh, nbw, cap, ncg):
        return "pallas-resident"
    if chunk_plan(cap, ncg) >= 1:
        return "pallas-chunked"
    return "treepack-fallback"


def column_groups(nbw: int) -> int:
    """jpegtpu's ncg for a grid nbw streams wide: 128-stream column groups
    (its transform tiles are 1024 pixels, 128 blocks, wide)."""
    return -(-nbw // LANES)


def image_offsets(seg_bits: torch.Tensor, segs_per_image: int):
    """Plain torch prefix sums of K11's plain version: seg_bits [S] ->
    (each segment's bit offset inside its image [S] int64, each image's
    total bits [B] int64, before tail padding). One flat scan over every
    segment, minus each image's base. (The kernel scans each image's bit
    counts itself, in shared memory.)"""
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


ROWS_THREADS = 256  # K11's thread block (csrc/concat.cu kStreamThreads)


def rows_tile_words(segs_per_image: int, n_images: int, slab_words: int,
                    sms: int) -> int:
    """Slab words per K11 thread block: 4096 for every 512 segments of an
    image (each block scans its image's bit counts, so its words should
    outweigh that scan), halved down to 1024 while the grid would hold
    fewer than two blocks per SM."""
    tile = 4096 * -(-segs_per_image // 512)
    while (tile > 4 * ROWS_THREADS
           and n_images * -(-slab_words // tile) < 2 * sms):
        tile //= 2
    return tile


def rows_scan_fits(segs_per_image: int, smem_bytes: int) -> bool:
    """Whether K11 keeps an image's scan (an int64 per segment, beside
    the kernel's static 256 B) in smem_bytes of shared memory; past that
    it writes the scans to global scratch first, a second launch."""
    return segs_per_image * 8 + 256 <= smem_bytes


def stream_concat_rows(segs: torch.Tensor, seg_bits: torch.Tensor,
                       segs_per_image: int, slab_words: int,
                       pad_ones: bool = True):
    """K11: segments [S, SW] int32 + bit counts [S], S = B * segs_per_image
    in scan order, image after image -> (streams [B, slab_words] int32,
    total bits [B] int64 with the tail padding): image i's stream is its
    segments back to back, its final partial byte padded with 1s (T.81)
    or left 0s, and its total rounded up to the byte. Segment words past
    a segment's bits are zero, as K8 writes them.

    On CUDA tensors this launches csrc/concat.cu (stream_concat_rows: one
    launch writes every slab word once and each total, its scans inside;
    two for an image past `rows_scan_fits`); on CPU tensors it runs
    `stream_concat_rows_plain`."""
    _check_rows(segs, seg_bits, segs_per_image)
    if segs.device.type == "cpu":
        return stream_concat_rows_plain(segs, seg_bits, segs_per_image,
                                        slab_words, pad_ones)
    _build.require_cuda(segs, "segs", torch.int32)
    _build.require_cuda(seg_bits, "seg_bits", torch.int32)
    dev = segs.device
    nseg, sw = segs.shape
    n_images = nseg // segs_per_image
    out = torch.empty((n_images, slab_words), dtype=torch.int32, device=dev)
    totals = torch.empty((n_images,), dtype=torch.int64, device=dev)
    scratch = (None if rows_scan_fits(segs_per_image, _smem_optin(dev))
               else torch.empty((nseg,), dtype=torch.int64, device=dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch(
        "concat", "stream_concat_rows", (P, P, P, I, I, I, L, I, P, L, P),
        segs.data_ptr(), seg_bits.data_ptr(),
        None if scratch is None else scratch.data_ptr(), nseg, sw,
        segs_per_image,
        rows_tile_words(segs_per_image, n_images, slab_words, sms),
        int(pad_ones), out.data_ptr(), slab_words, totals.data_ptr(),
        device=dev,
    )
    return out, totals


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
                  nbw: int, rung_words: int | None = None,
                  pad_ones: bool | None = None):
    """Per-block streams [cap, nb] + bits [nb] of an nbh x nbw grid in scan
    order -> (scan stream int32, total bits 0-dim int64, both with the
    tail padding when pad_ones is True or False): K8, then K9 where the
    grid's concat_mode is "pallas-resident", else K10. The mode is
    jpegtpu's at rung_words words per stream, the capacity ladder's rung
    (None: cap), which is more than cap where the kernels run at
    pipeline.kernel_cap."""
    cap, nb = words.shape
    segs, seg_bits = merge_rows(words, bits, nbh, nbw)
    resident = concat_mode(nbh, nbw, rung_words or cap,
                           column_groups(nbw)) == "pallas-resident"
    join = stream_concat if resident else stream_concat_chunked
    return join(segs, seg_bits, stream_words(nb, cap), pad_ones)


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


def segment_width(nbw: int) -> int:
    """K8's segment width for rows of nbw blocks (or MCUs) cut into
    segments of their own images (a batch) or restart segments:
    jpegtpu's slot width (batch._slot_geom), the power of two >= 16 that
    holds a row of <= 64, else 128."""
    ws = SEGMENT_WIDTHS[0]
    while ws < nbw:
        ws *= 2
    return min(ws, LANES)


def encode_segments(words: torch.Tensor, bits: torch.Tensor, seg_len: int,
                    pad_ones: bool):
    """S independent byte-aligned segments of seg_len streams each, in one
    pass (the concat half of jpegtpu's entropy.device.
    encode_segments_device): per-block or per-MCU streams [C, S * seg_len]
    + bits, whose DC chains the caller already reset at every segment ->
    (streams [S, seg_len * C] int32, total bits [S] int64 with each
    segment's tail padding). Each segment is one row of seg_len streams,
    so a segment need not hold whole block rows: K8 at segment_width, then
    K11."""
    n = words.shape[1]
    if n % seg_len:
        raise ValueError(f"{n} streams do not split into segments of "
                         f"{seg_len}")
    s = n // seg_len
    return concat_segments(words, bits, s, seg_len, s,
                           segment_width(seg_len), pad_ones)


def stitch_plan(s: int, seg128: int, cap: int) -> int:
    """Segments per chunk of jpegtpu's VMEM-resident restart stitch, or 0
    where it is infeasible (jpegtpu.entropy.pallas_concat.stitch_plan),
    for s segments of seg128 streams (a multiple of 128) of cap words.
    Where it is 0 jpegtpu's sharded encodes leave the stitched route for
    the per-segment one; K12 has no such limit, so the plan decides only
    the route (parallel.sharding.sharded_stitch_plan)."""
    sr = cap + 1
    avail = VMEM_BUDGET - 2 * SUBLANES * sr * LANES * 4

    def chunk_bytes(spc: int) -> int:
        return (-(-(spc * seg128 * cap) // LANES) + sr + 4) * LANES * 4

    if chunk_bytes(1) > avail:
        return 0
    n_chunks = 1
    while -(-s // n_chunks) > 1 and chunk_bytes(-(-s // n_chunks)) > avail:
        n_chunks += 1
    spc = -(-s // n_chunks)
    return spc if chunk_bytes(spc) <= avail else 0


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
