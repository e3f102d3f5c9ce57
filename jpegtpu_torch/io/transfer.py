"""Both directions of the host-card boundary: how an encode's images reach
its device (`stage`) and how its scans come back and are stuffed
(`read_segments`, `read_restart_scan`). Every entry point crosses the bus
here and nowhere else.

The way in. Host images go through a ring of two host buffers reused for
the life of the process (pinned for a CUDA device, plain for the CPU):
chunks of whole images are copied into a buffer by a few threads,
edge-padded in place and copied to the device asynchronously, so the host
fills one buffer while the other copies. A buffer is reused only once its
own last copy to the card has completed. Images that are already on the
encode's device (torch tensors) are edge-padded and stacked there by K13
(ops.stage), with no copy across the bus and no host wait.

The way out. The host reads the valid word prefix of each stream in one
copy and stuffs it with the native runtime (numpy where it does not
build), or reads a restart scan's words and segment totals in one copy
and stuffs its segments with RST markers between (entropy.host.
scan_from_words).
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..entropy import host as entropy_host
from ..ops.blocks import COPY_THREADS, copy_into, pad_in_place
from ..ops.stage import stage_images
from ..tracing import count, span

# Bytes of a staging buffer: a chunk is as many whole images as fit, or one
# image where an image is larger (the buffer then grows to it).
_CHUNK_BYTES = 64 << 20


class _Ring:
    """Two host buffers that stage images to their devices (pinned for a
    CUDA device, plain for the CPU), each with the event of its last copy
    to the card, and the threads that fill them. The lock holds one
    stage's chunks at a time."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.buffers = [None, None]
        self.copied = [None, None]
        self.turn = 0
        self.lock = threading.Lock()
        self.copiers = ThreadPoolExecutor(COPY_THREADS)

    def take(self, n: int) -> tuple:
        """(index, its first n bytes) of the next buffer, once its last
        copy to the card has completed."""
        i, self.turn = self.turn, self.turn ^ 1
        event = self.copied[i]
        if event is not None and not event.query():
            count("io.chunk_waits")
            with span("io.upload"):
                event.synchronize()
        if self.buffers[i] is None or self.buffers[i].numel() < n:
            self.buffers[i] = torch.empty(max(n, _CHUNK_BYTES),
                                          dtype=torch.uint8,
                                          pin_memory=self.pinned)
        return i, self.buffers[i][:n]


_rings: dict = {}  # pinned -> the process's _Ring, made on first use
_rings_made = threading.Lock()


def _ring(pinned: bool) -> _Ring:
    with _rings_made:
        if pinned not in _rings:
            _rings[pinned] = _Ring(pinned)
        return _rings[pinned]


def source_image(image, dev: torch.device):
    """Where an encode on `dev` reads an image from: a tensor on dev as it
    is (the on-card route, stage_on_card); a tensor on another device
    copied to dev first (without a host wait where dev is a card); a CPU
    tensor for a card, and a numpy array, as a numpy array (the ring)."""
    if not isinstance(image, torch.Tensor):
        return image
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if image.device == dev:
        return image
    if image.device.type == "cpu":
        return image.numpy()
    return image.to(dev, non_blocking=dev.type == "cuda")


def stage_on_card(images: list, shape: tuple) -> torch.Tensor:
    """The on-card route: images already on the encode's device,
    edge-padded and stacked there by K13 (ops.stage) into one [len(images)
    * ph, pw(, 3)] tensor, with no copy across the bus and no host wait."""
    with span("io.on_card"):
        count("io.on_card_images", len(images))
        return stage_images(images, shape)


def stage(images: list, shape: tuple, dev: torch.device) -> torch.Tensor:
    """The images edge-padded to `shape` ([ph, pw] or [ph, pw, 3]; a 2-D
    image into 3 channels is repeated to each) and stacked on dev as one
    [len(images) * ph, pw(, 3)] uint8 tensor. Host images go through the
    ring (_stage_ring); images already on dev (source_image) are staged
    there by K13 (stage_on_card). A list that holds both stages its host
    images through the ring first and hands their padded rows to K13 with
    the others."""
    images = [source_image(image, dev) for image in images]
    on_card = [isinstance(image, torch.Tensor) for image in images]
    if not any(on_card):
        return _stage_ring(images, shape, dev)
    if not all(on_card):
        rows = iter(_stage_ring([im for im, o in zip(images, on_card)
                                 if not o], shape, dev).split(shape[0]))
        images = [im if o else next(rows) for im, o in zip(images, on_card)]
    return stage_on_card(images, shape)


def _stage_ring(images: list, shape: tuple, dev: torch.device
                ) -> torch.Tensor:
    """stage of host images: through the ring in chunks of whole images.
    For each chunk: wait for its buffer's last copy (io.upload), copy the
    images in by bands of rows on the copying threads (io.stack),
    replicate the edges in place (io.pad), and copy the buffer to dev
    (io.upload; from pinned memory without waiting, on the current
    stream, so the next chunk fills while this one copies, and the
    kernels queued after it on the stream wait for it)."""
    cuda = dev.type == "cuda"
    ring = _ring(cuda)
    ph, size = shape[0], math.prod(shape)
    per = max(1, _CHUNK_BYTES // size)
    out = torch.empty((len(images) * ph, *shape[1:]), dtype=torch.uint8,
                      device=dev)
    with ring.lock:
        for lo in range(0, len(images), per):
            chunk = images[lo:lo + per]
            count("io.chunks")
            i, buf = ring.take(len(chunk) * size)
            slots = buf.view(len(chunk), *shape).numpy()
            with span("io.stack"):
                copy_into(slots, chunk, ring.copiers)
            with span("io.pad"):
                for slot, image in zip(slots, chunk):
                    pad_in_place(slot, *image.shape[:2])
            with span("io.upload"):
                out[lo * ph:(lo + len(chunk)) * ph].copy_(
                    buf.view(-1, *shape[1:]), non_blocking=True)
                if cuda:
                    ring.copied[i] = torch.cuda.Event()
                    ring.copied[i].record(torch.cuda.current_stream(dev))
    return out


def read_segments(streams: torch.Tensor, totals) -> list:
    """Streams [B, W] (int32 words on a device, each stream's bits from
    word 0) and their total bits [B] (padded to the byte) -> one readback
    of the valid word prefix of all of them (io.readback) -> the stuffed
    bytes of each stream (io.stuff)."""
    nwords = (max(totals) + 31) // 32
    with span("io.readback"):
        words = streams[:, :nwords].cpu().numpy().view(np.uint32)
    out = []
    chunks = np.zeros(2, np.int64)  # 8-byte chunks stuffed, those with a 0xFF
    with span("io.stuff"):
        for row, total_bits in zip(words, totals):
            row = row[: (total_bits + 31) // 32]
            if native.available():
                out.append(native.words_to_stuffed(row, total_bits, chunks))
            else:
                raw = np.frombuffer(row.astype(">u4").tobytes(), np.uint8)
                out.append(entropy_host.stuff_bytes(raw[: total_bits // 8]))
        _count_chunks(chunks)
    return out


def read_restart_scan(stream: torch.Tensor, seg_totals: torch.Tensor,
                      total_bits: int, **kwargs) -> bytes:
    """A restart scan's stream (byte-aligned segments back to back, int32
    words on a device), its segment totals in bits and its total bits ->
    one readback of the valid words and the segment totals (io.readback)
    -> the segments stuffed with RST markers between (io.stuff;
    entropy.host.scan_from_words, which takes `kwargs`: rst_phase,
    trailing)."""
    nwords = (total_bits + 31) // 32
    with span("io.readback"):
        host = torch.cat([stream[:nwords], seg_totals]).cpu().numpy()
    chunks = np.zeros(2, np.int64)
    with span("io.stuff"):
        scan = entropy_host.scan_from_words(
            host[:nwords].view(np.uint32), host[nwords:].astype(np.int64) // 8,
            counts=chunks, **kwargs)
        _count_chunks(chunks)
    return scan


def _count_chunks(chunks: np.ndarray) -> None:
    """Book a native stuffer's chunk tally (none from the numpy twin)."""
    if chunks[0]:
        count("io.stuff_chunks", int(chunks[0]))
        count("io.stuff_chunks_slow", int(chunks[1]))
