"""The native stuffer of jpegtpu_torch (native.words_to_stuffed and
native.scan_from_words, jpegtpu_torch/native/bitpack.cpp) against the
numpy twins, and its chunk tally against a count made in numpy.

The stuffer takes a stream 8 bytes a step from its first word boundary
(16 with SSE2: two chunks tested at once), and a chunk that holds a 0xFF
byte a byte at a time; the cases put the 0xFF bytes, the tails and the
word alignments everywhere those paths meet."""
import ctypes
import platform
import subprocess

import numpy as np
import pytest
import torch

from benchmark import content, manifest
from benchmark.reference import encoder
import jpegtpu_torch
from jpegtpu_torch import native, tracing
from jpegtpu_torch.entropy import host
from jpegtpu_torch.io import transfer

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime unavailable (no g++?)")


def _words(raw: np.ndarray, junk: int = 0xA5) -> np.ndarray:
    """Bytes -> host-order uint32 words, MSB first, the last word's bytes
    past the stream filled with `junk` (the stuffer must not read them
    as stream bytes)."""
    padded = np.full(-(-raw.size // 4) * 4, junk, np.uint8)
    padded[:raw.size] = raw
    return padded.view(">u4").astype(np.uint32)


def _chunks(raw: np.ndarray, lo: int = 0, hi: int | None = None) -> list:
    """[chunks, chunks holding a 0xFF] of bytes [lo, hi) of a buffer:
    8-byte chunks from the first multiple of 4 at or past lo."""
    hi = raw.size if hi is None else hi
    first = -(-lo // 4) * 4
    n = max(0, (hi - first) // 8)
    body = raw[first:first + 8 * n].reshape(n, 8)
    return [n, int((body == 0xFF).any(axis=1).sum())]


def _check(raw: np.ndarray, junk: int = 0xA5) -> None:
    counts = np.zeros(2, np.int64)
    got = native.words_to_stuffed(_words(raw, junk), 8 * raw.size, counts)
    assert got == host.stuff_bytes(raw)
    assert counts.tolist() == _chunks(raw)


@pytest.mark.parametrize("total_bits", range(0, 601, 8))
def test_random_streams_match_numpy(total_bits):
    rng = np.random.default_rng(total_bits)
    raw = rng.integers(0, 256, total_bits // 8, dtype=np.uint8)
    _check(raw)
    raw[rng.random(raw.size) < 0.1] = 0xFF
    _check(raw, junk=0xFF)


@pytest.mark.parametrize("nbytes", [1, 7, 8, 15, 16, 17, 24, 1000])
def test_all_ff_streams(nbytes):
    raw = np.full(nbytes, 0xFF, np.uint8)
    _check(raw)
    counts = np.zeros(2, np.int64)
    assert len(native.words_to_stuffed(_words(raw), 8 * nbytes,
                                       counts)) == 2 * nbytes
    assert counts[0] == counts[1] == nbytes // 8


@pytest.mark.parametrize("pos", range(16))
def test_one_ff_at_each_position_of_a_step(pos):
    """A 0xFF at each byte of either chunk of a 16-byte step, in every
    step, and in one step alone."""
    raw = np.arange(1, 81, dtype=np.uint8)
    every = raw.copy()
    every[pos::16] = 0xFF
    _check(every)
    one = raw.copy()
    one[32 + pos] = 0xFF
    _check(one)
    assert _chunks(one) == [10, 1]


@pytest.mark.parametrize("nbytes", range(1, 41))
def test_ff_at_the_last_byte(nbytes):
    raw = np.full(nbytes, 0x5A, np.uint8)
    raw[-1] = 0xFF
    _check(raw)


def test_a_reference_1080p_q75_scan_restuffs_to_its_file():
    """The benchmark reference's scan of one video_1080p_420 frame,
    unstuffed, stuffs back to the file's bytes."""
    cfg = manifest.Bench().config("video_1080p_420")
    image = content.make_pool(cfg["sizes"], 1, 3180000307, "cpu")[0]
    enc = encoder.encode(image, cfg["encode"])
    raw = np.packbits(enc.bits)
    counts = np.zeros(2, np.int64)
    got = native.words_to_stuffed(_words(raw), 8 * raw.size, counts)
    assert got == enc.file[enc.header_len:-2]
    assert counts.tolist() == _chunks(raw)
    assert 0 < counts[1] < counts[0] // 20  # most chunks hold no 0xFF


def _numpy_scan(monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return host.scan_from_words(*args)


@pytest.mark.parametrize("trailing", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_scan_from_words_matches_numpy(seed, trailing, monkeypatch):
    """Segments of odd byte lengths back to back, so most start inside a
    word; RST markers after each (after the last with trailing)."""
    rng = np.random.default_rng(seed)
    seg_bytes = rng.integers(0, 40, 25) | 1
    seg_bytes[::5] = rng.integers(0, 4, 5)  # short and empty segments
    raw = rng.integers(0, 256, int(seg_bytes.sum()), dtype=np.uint8)
    raw[rng.random(raw.size) < 0.08] = 0xFF
    words = _words(raw)
    phase = int(rng.integers(0, 8))
    counts = np.zeros(2, np.int64)
    got = host.scan_from_words(words, seg_bytes, phase, trailing, counts)
    assert got == _numpy_scan(monkeypatch, words, seg_bytes, phase, trailing)
    ends = np.cumsum(seg_bytes)
    want = np.sum([_chunks(raw, lo, hi)
                   for lo, hi in zip(ends - seg_bytes, ends)], axis=0)
    assert counts.tolist() == want.tolist()


def test_the_portable_path_matches_numpy(tmp_path):
    """bitpack.cpp built without SSE2 (its 8-byte path alone, as on a
    host without SSE2) gives the same bytes and tally."""
    if platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("-mno-sse2 is an x86 flag; elsewhere the package's "
                    "own build is the portable path")
    so = str(tmp_path / "libjt_bitpack_swar.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-mno-sse2", "-o", so,
                    native._SRC], check=True)
    lib = ctypes.CDLL(so)
    lib.jt_words_to_stuffed.restype = ctypes.c_size_t
    lib.jt_words_to_stuffed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(11)
    for nbytes in range(0, 120):
        raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
        raw[rng.random(nbytes) < 0.05] = 0xFF
        words = _words(raw)
        out = np.empty(2 * nbytes + 4, np.uint8)
        counts = np.zeros(2, np.int64)
        n = lib.jt_words_to_stuffed(words.ctypes.data, 8 * nbytes,
                                    out.ctypes.data, counts.ctypes.data)
        assert out[:n].tobytes() == host.stuff_bytes(raw)
        assert counts.tolist() == _chunks(raw)


def test_a_tally_must_be_two_int64():
    raw = np.zeros(16, np.uint8)
    for bad in (np.zeros(2, np.int32), np.zeros(3, np.int64),
                np.zeros(4, np.int64)[::2]):
        with pytest.raises(ValueError):
            native.words_to_stuffed(_words(raw), 128, bad)


def test_the_host_finish_counts_chunks(monkeypatch):
    """read_segments books the stuffer's tally while tracing records,
    and its numpy twin (no g++) gives the same bytes."""
    rng = np.random.default_rng(7)
    raws = [rng.integers(0, 256, n, dtype=np.uint8) for n in (0, 13, 64, 301)]
    raws[3][::9] = 0xFF
    width = max(-(-r.size // 4) for r in raws)
    streams = np.zeros((len(raws), width), np.uint32)
    for row, raw in zip(streams, raws):
        words = _words(raw)
        row[:words.size] = words
    totals = [8 * r.size for r in raws]
    streams = torch.from_numpy(streams.view(np.int32))
    with tracing.recording():
        got = transfer.read_segments(streams, totals)
    assert got == [host.stuff_bytes(r) for r in raws]
    want = np.sum([_chunks(r) for r in raws], axis=0).tolist()
    counts = tracing.totals()["counts"]
    assert [counts["io.stuff_chunks"], counts["io.stuff_chunks_slow"]] == want
    monkeypatch.setattr(native, "available", lambda: False)
    assert transfer.read_segments(streams, totals) == got


def test_the_restart_finish_counts_chunks():
    """finish_restart_scan books the tally of its segments, each chunked
    from its first word boundary in the one buffer that holds them back
    to back."""
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (48, 72), dtype=np.uint8)
    cfg = jpegtpu_torch.EncodeConfig(restart_interval=5)
    with tracing.recording():
        f = jpegtpu_torch.encode_grayscale(image, cfg, device="cpu")
    start = f.index(b"\xff\xda")
    start += 2 + int.from_bytes(f[start + 2:start + 4], "big")
    s = np.frombuffer(f[start:-2], np.uint8)
    rst = np.flatnonzero((s[:-1] == 0xFF) & (s[1:] >= 0xD0) & (s[1:] <= 0xD7))
    assert rst.size > 3
    segs = np.split(s, np.ravel(np.c_[rst, rst + 2]))[::2]
    raws = [g[np.r_[True, ~((g[:-1] == 0xFF) & (g[1:] == 0))]] if g.size
            else g for g in segs]
    raw = np.concatenate(raws)
    ends = np.cumsum([r.size for r in raws])
    want = np.sum([_chunks(raw, hi - r.size, hi)
                   for r, hi in zip(raws, ends)], axis=0).tolist()
    counts = tracing.totals()["counts"]
    assert [counts["io.stuff_chunks"], counts["io.stuff_chunks_slow"]] == want
