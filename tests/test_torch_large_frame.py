"""The large-frame path of jpegtpu_torch: the concat decision (K9 where
jpegtpu's stream buffer is VMEM-resident, K10 everywhere else), K10's
plain version against jpegtpu's `concat_raw_chunked` (interpret mode) and
against K9's, and whole encodes routed through K10 against jpegtpu's
bytes. Exact throughout. Small shapes only: 7680 x 4320 enters as pure
geometry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu import pipeline as jpipeline
from jpegtpu.entropy import pallas_concat
from jpegtpu.ops import pallas_transform as pt

import jpegtpu_torch
from jpegtpu_torch import color_pipeline, pipeline
from jpegtpu_torch.entropy import concat

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CAPS = (8, 16, 53)
SHAPES = [(4320, 7680), (3024, 4032), (2160, 3840), (512, 512), (61, 93)]


@pytest.mark.parametrize("h,w", SHAPES)
def test_gray_concat_mode_matches_jpegtpu(h, w):
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    for cap in CAPS:
        assert (pipeline.gray_concat_mode(ph, pw, cap)
                == jpipeline.gray_concat_mode(ph, pw, cap)), cap


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("ss", ["420", "422", "444"])
def test_color_concat_mode_matches_jpegtpu(h, w, ss):
    """jpegtpu's color body asks concat_mode of its chroma-grid geometry
    (color_pipeline._fused_raw_planes) at the MCU streams' E * cap."""
    fy, fx = (2 if ss == "420" else 1), (1 if ss == "444" else 2)
    ph, pw = -(-h // (8 * fy)) * 8 * fy, -(-w // (8 * fx)) * 8 * fx
    mh, mw = ph // fy, pw // fx
    kw = pt.padded_dims_kernel(mh, mw)[1]
    for cap in CAPS:
        want = pallas_concat.concat_mode(mh // 8, mw // 8,
                                         (fy * fx + 2) * cap, kw // pt.TILE_W)
        assert color_pipeline.color_concat_mode(ph, pw, ss, cap) == want, cap


def test_the_8k_frame_and_the_reference_image_split_as_in_jpegtpu():
    """The rows of the port's K9 / K10 split the 8K probe rests on."""
    gray = {cap: pipeline.gray_concat_mode(4320, 7680, cap) for cap in CAPS}
    assert gray == {8: "pallas-chunked", 16: "pallas-chunked",
                    53: "pallas-chunked"}
    c420 = {cap: color_pipeline.color_concat_mode(4320, 7680, "420", cap)
            for cap in CAPS}
    assert c420 == {8: "pallas-chunked", 16: "pallas-chunked",
                    53: "treepack-fallback"}
    assert [pipeline.gray_concat_mode(3024, 4032, c) for c in CAPS] == [
        "pallas-resident", "pallas-resident", "pallas-chunked"]
    assert [color_pipeline.color_concat_mode(3024, 4032, "420", c)
            for c in CAPS] == ["pallas-resident", "pallas-chunked",
                               "pallas-chunked"]
    for cap in (8, 16, 48, 318, 8192):
        for ncg in (1, 4, 8):
            assert concat.chunk_plan(cap, ncg) == pallas_concat.chunk_plan(
                cap, ncg)


CAP = 4
M32 = np.uint64(0xFFFFFFFF)


def _random_streams(rng, g):
    """tests/test_chunked_concat.py's MSB-aligned per-block streams in
    jpegtpu's grid-natural tiling, words masked to their bits."""
    bits = rng.integers(0, CAP * 32 + 1, (g, 8, 128)).astype(np.int32)
    w = rng.integers(0, 2 ** 32, (g, CAP, 8, 128), dtype=np.uint64)
    w = w.astype(np.uint32)
    wm = np.zeros_like(w)
    for j in range(CAP):
        valid = bits > j * 32
        full = bits >= (j + 1) * 32
        part = np.clip(bits - j * 32, 0, 32).astype(np.uint64)
        mask = np.where(full, M32, (M32 << (np.uint64(32) - part)) & M32)
        wm[:, j] = np.where(valid, w[:, j] & mask.astype(np.uint32), 0)
    return wm, bits


@pytest.mark.parametrize(
    "nbh,nbw,ncg,rpc",
    [
        (16, 256, 2, 1),   # every grid step its own chunk
        (16, 256, 2, 2),   # even split
        (24, 384, 3, 3),   # exact single chunk
        (8, 128, 1, 2),    # nrg < rpc: padding path
        (17, 200, 2, 2),   # partial last block row + pad lanes
    ],
)
def test_chunked_plain_matches_jpegtpu(nbh, nbw, ncg, rpc):
    """jpegtpu's chunk of rpc row groups is rpc * 8 * ncg of the port's
    segments; both base it at the row floor of its first offset and OR
    the chunks together, so the whole buffers agree."""
    rng = np.random.default_rng(nbh * 1000 + nbw + rpc)
    wm, bits = _random_streams(rng, -(-nbh // 8) * ncg)
    ref_w, ref_t = pallas_concat.concat_raw_chunked(
        jnp.asarray(wm), jnp.asarray(bits), nbh, nbw, ncg, rpc,
        interpret=True)
    words = np.asarray(pt.raw_to_scan(wm, nbh, nbw, ncg)).view(np.int32)
    nbits = np.asarray(pt.raw_to_scan(bits[:, None], nbh, nbw, ncg))[0]
    segs, seg_bits = concat.merge_rows(torch.from_numpy(words.copy()),
                                       torch.from_numpy(nbits.copy()),
                                       nbh, nbw)
    out_words = concat.stream_words(nbh * nbw, CAP)
    assert out_words == ref_w.shape[0]
    got, total = concat.stream_concat_chunked_plain(segs, seg_bits,
                                                    out_words, rpc * 8 * ncg)
    assert int(total) == int(ref_t)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref_w))


@pytest.mark.parametrize("tile", [1, 2, 3, 7, 64, 1000])
@pytest.mark.parametrize("cap", [2, 8])
def test_chunked_plain_matches_k9_plain(tile, cap):
    rng = np.random.default_rng(tile + cap)
    nbh, nbw = 9, 300  # 3 segments a row, the last ragged
    bits = rng.integers(0, cap * 32 + 1, nbh * nbw).astype(np.int32)
    bits[::7] = 0  # empty blocks
    bits[300:600] = 0  # a row of empty segments
    part = np.clip(bits - 32 * np.arange(cap)[:, None], 0, 32)
    mask = (M32 << (np.uint64(32) - part.astype(np.uint64))) & M32
    words = rng.integers(0, 2 ** 32, (cap, nbh * nbw), dtype=np.uint64)
    words = (words & mask).astype(np.uint32).view(np.int32)
    segs, seg_bits = concat.merge_rows(torch.from_numpy(words),
                                       torch.from_numpy(bits), nbh, nbw)
    n = concat.stream_words(nbh * nbw, cap)
    want, want_total = concat.stream_concat_plain(segs, seg_bits, n)
    got, total = concat.stream_concat_chunked_plain(segs, seg_bits, n, tile)
    assert int(total) == int(want_total)
    assert torch.equal(got, want)
    # the CPU wrapper runs the plain version at its own chunk size
    assert torch.equal(concat.stream_concat_chunked(segs, seg_bits, n)[0],
                       want)


@pytest.fixture
def k10_route(monkeypatch):
    """Shrink the resident budget so small frames take K10's route, and
    count which concat ran."""
    monkeypatch.setattr(concat, "VMEM_BUDGET", 64 << 10)
    calls = {"k9": 0, "k10": 0}
    k9, k10 = concat.stream_concat_plain, concat.stream_concat_chunked_plain

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(concat, "stream_concat_plain", spy("k9", k9))
    monkeypatch.setattr(concat, "stream_concat_chunked_plain",
                        spy("k10", k10))
    return calls


def _image(h, w, color, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx + yy) * (255.0 / (h + w)) + 20 * np.sin(xx / 3.1)
    shape = (h, w, 3) if color else (h, w)
    noise = rng.normal(0, 8.0, shape)
    if color:
        base = base[..., None]
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("dct_dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", ["gray", "420"])
def test_encode_through_k10_matches_jpegtpu(k10_route, kind, dct_dtype):
    """jpegtpu's bytes come from its numpy entropy coder (entropy="host"),
    which its own tests hold equal to its device path; its concat split
    is not stream-visible."""
    color = kind == "420"
    img = _image(200, 264, color, seed=5)
    kw = {"dct_dtype": dct_dtype}
    if color:
        kw["subsampling"] = "420"
        assert color_pipeline.color_concat_mode(208, 272, "420", 8) != (
            "pallas-resident")
        got = jpegtpu_torch.encode_color(
            img, jpegtpu_torch.EncodeConfig(**kw), device="cpu")
        want = jpegtpu.encode_color(
            img, jpegtpu.EncodeConfig(entropy="host", **kw))
    else:
        assert pipeline.gray_concat_mode(200, 264, 8) != "pallas-resident"
        got = jpegtpu_torch.encode_grayscale(
            img, jpegtpu_torch.EncodeConfig(**kw), device="cpu")
        want = jpegtpu.encode_grayscale(
            img, jpegtpu.EncodeConfig(entropy="host", **kw))
    assert k10_route == {"k9": 0, "k10": 1}
    assert got == want
