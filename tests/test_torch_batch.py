"""Batch encode (jpegtpu_torch.batch) on the CPU: every file equal to the
port's single-image encode of its image and to jpegtpu's host coder on
the port's levels; the shared 2-pass tables against jpegtpu's batch
encode (its interpret-mode batch chain, called twice in this file) and
against a numpy oracle built from jpegtpu's host coder. Bytes are
compared exactly."""
import dataclasses

import numpy as np
import pytest

import jpegtpu
from jpegtpu import batch as jbatch
from jpegtpu import tables as jtables
from jpegtpu.entropy import host as jhost
from jpegtpu.io import jfif as jjfif

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, batch, color_pipeline, tracing
from jpegtpu_torch.io import transfer
from jpegtpu_torch.parallel import sharding

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")


def _photo(h, w, seed, rgb=False):
    """Photographic-complexity content (tests/test_tpu_parity.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    chans = [np.clip(base + k * 9 + rng.normal(0, 10, (h, w)), 0, 255)
             for k in range(3 if rgb else 1)]
    return np.stack(chans, -1).astype(np.uint8) if rgb else chans[0].astype(
        np.uint8)


def _noise(h, w, seed, rgb=False):
    shape = (h, w, 3) if rgb else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# Mixed geometries: rows of 15 and 10 blocks (segment width 16), of 32
# (width 32), of 95 (128, ragged) and of 171 (two 128-block segments),
# heights and widths that are not multiples of 8, 2-D and RGB of one
# padded shape (two gray groups, one color group), two images in a group.
MIXED = [
    _photo(64, 120, 1), _photo(48, 250, 2), _photo(40, 760, 3),
    _photo(24, 1366, 4), _photo(61, 77, 5), _photo(64, 120, 6, rgb=True),
    _photo(45, 250, 7), _photo(47, 63, 8, rgb=True), _photo(48, 64, 9),
]


@pytest.mark.parametrize("cfg", [
    EncodeConfig(dct_dtype="int32"), EncodeConfig(),
    EncodeConfig(pad_ones=False, quality=85), EncodeConfig(bitexact=False),
], ids=["int32", "float", "pad0_q85", "not_bitexact"])
def test_gray_batch_matches_single_image(cfg):
    got = batch.encode_grayscale_batch(MIXED, cfg, **CPU)
    assert len(got) == len(MIXED)
    jcfg = jpegtpu.EncodeConfig(**dataclasses.asdict(cfg))
    for image, data in zip(MIXED, got):
        assert data == jpegtpu_torch.encode_grayscale(image, cfg, **CPU)
        zz = jpegtpu_torch.grayscale_coefficients(image, cfg, **CPU)
        assert data == jjfif.assemble(
            image.shape[1], image.shape[0], jcfg,
            jhost.encode_scan(zz, pad_ones=cfg.pad_ones))


@pytest.mark.parametrize("ss", ["420", "422", "444"])
@pytest.mark.parametrize("dct_dtype", ["int32", "float32"])
def test_color_batch_matches_single_image(ss, dct_dtype):
    cfg = EncodeConfig(subsampling=ss, dct_dtype=dct_dtype)
    got = batch.encode_color_batch(MIXED, cfg, **CPU)
    jcfg = jpegtpu.EncodeConfig(**dataclasses.asdict(cfg))
    for image, data in zip(MIXED, got):
        assert data == jpegtpu_torch.encode_color(image, cfg, **CPU)
        zz, sel, comp = jpegtpu_torch.color_coefficients(image, cfg, **CPU)
        assert data == jjfif.assemble(
            image.shape[1], image.shape[0], jcfg,
            jhost.encode_scan(zz, sel.astype(np.int64), comp))


def _two_pass_oracle(levels, shapes, cfg, kinds):
    """Summed host-coder histograms of every image's scan, floored, then
    package-merge, then each image's scan with those tables."""
    freqs = {}
    for zz, sel, comp in levels:
        for k, v in jhost.symbol_frequencies(zz, sel, comp).items():
            freqs[k] = freqs.get(k, 0) + v
    freqs = jtables.floor_frequencies(freqs)
    specs = {k: jtables.optimal_spec(freqs[k])
             for kind in kinds for k in (f"dc_{kind}", f"ac_{kind}")}
    luts = jtables.huffman_luts_from_specs(specs)
    return [jjfif.assemble(w, h, cfg, jhost.encode_scan(
                zz, sel, comp, pad_ones=cfg.pad_ones, luts=luts),
                           huffman_specs=specs)
            for (zz, sel, comp), (h, w) in zip(levels, shapes)]


def test_gray_two_pass_shares_tables_like_jpegtpu():
    images = [_photo(40, 48, 21), _photo(37, 45, 22), _photo(40, 48, 23)]
    kw = dict(dct_dtype="int32", optimize_huffman=True)
    cfg = EncodeConfig(**kw)
    got = batch.encode_grayscale_batch(images, cfg, **CPU)
    assert got == jbatch.encode_grayscale_batch(images,
                                                jpegtpu.EncodeConfig(**kw))
    levels = [(jpegtpu_torch.grayscale_coefficients(im, cfg, **CPU), None,
               None) for im in images]
    assert got == _two_pass_oracle(levels, [im.shape[:2] for im in images],
                                   jpegtpu.EncodeConfig(**kw), ("lum",))
    # shared tables: not the images' own
    assert got[0] != jpegtpu_torch.encode_grayscale(images[0], cfg, **CPU)


def test_color_two_pass_shares_tables_like_jpegtpu():
    """An RGB image and a 2-D one of one padded shape share the four
    tables."""
    images = [_photo(32, 48, 31, rgb=True), _photo(31, 47, 32)]
    kw = dict(dct_dtype="int32", optimize_huffman=True, subsampling="420")
    cfg = EncodeConfig(**kw)
    got = batch.encode_color_batch(images, cfg, **CPU)
    assert got == jbatch.encode_color_batch(images,
                                            jpegtpu.EncodeConfig(**kw))
    levels = [jpegtpu_torch.color_coefficients(im, cfg, **CPU)
              for im in images]
    assert got == _two_pass_oracle(
        [(zz, sel.astype(np.int64), comp) for zz, sel, comp in levels],
        [im.shape[:2] for im in images], jpegtpu.EncodeConfig(**kw),
        ("lum", "chrom"))


@pytest.mark.parametrize("dct_dtype", ["int32", "float32"])
def test_two_pass_past_the_sharing_rule_gets_per_image_tables(dct_dtype):
    """2112 x 16 gray: 264 kernel rows per image, past jpegtpu's 256, so
    each image is encoded with its own 2-pass tables."""
    assert not batch.shares_gray_tables(2112, 16, 8)
    assert batch.shares_gray_tables(2048, 16, 8)
    cfg = EncodeConfig(dct_dtype=dct_dtype, optimize_huffman=True)
    images = [_photo(2112, 16, 41), _photo(2112, 16, 42)]
    got = batch.encode_grayscale_batch(images, cfg, **CPU)
    for image, data in zip(images, got):
        assert data == jpegtpu_torch.encode_grayscale(image, cfg, **CPU)


class _Rungs:
    """Counts the rungs a batch encode tries (calls of K8 + K11)."""

    def __init__(self, monkeypatch):
        self.caps = []
        real = batch.concat_segments

        def spy(words, *args):
            self.caps.append(words.shape[0])
            return real(words, *args)

        monkeypatch.setattr(batch, "concat_segments", spy)


def test_noise_image_climbs_the_ladder_in_a_batch(monkeypatch):
    """A Q100 noise image overflows caps 8 and 16: the whole stack retries
    with the same kernels, and every file still equals its single encode."""
    rungs = _Rungs(monkeypatch)
    cfg = EncodeConfig(quality=100, dct_dtype="int32")
    images = [_photo(32, 40, 51), _noise(32, 40, 52), _photo(32, 40, 53)]
    got = batch.encode_grayscale_batch(images, cfg, **CPU)
    assert rungs.caps == [8, 16, 53]
    for image, data in zip(images, got):
        assert data == jpegtpu_torch.encode_grayscale(image, cfg, **CPU)


@pytest.mark.parametrize("ss,shared_rungs", [("gray", [8, 16]),
                                             ("420", [6 * 8])])
def test_two_pass_overflow_leaves_shared_tables(monkeypatch, ss,
                                                shared_rungs):
    """Shared tables ride rungs 8 and 16 (gray) or 8 alone (color); noise
    that overflows them sends each image to its own 2-pass tables, as in
    jpegtpu."""
    rungs = _Rungs(monkeypatch)
    cfg = EncodeConfig(quality=100, dct_dtype="int32", subsampling=ss,
                       optimize_huffman=True)
    images = [_noise(32, 32, 61, rgb=ss != "gray"),
              _photo(32, 32, 62, rgb=ss != "gray")]
    encode = (batch.encode_grayscale_batch if ss == "gray"
              else batch.encode_color_batch)
    single = (jpegtpu_torch.encode_grayscale if ss == "gray"
              else jpegtpu_torch.encode_color)
    got = encode(images, cfg, **CPU)
    assert rungs.caps == shared_rungs
    for image, data in zip(images, got):
        assert data == single(image, cfg, **CPU)


@pytest.mark.parametrize("kw", [dict(restart_interval=2),
                                dict(entropy="host"),
                                dict(restart_interval=3,
                                     optimize_huffman=True)])
@pytest.mark.parametrize("ss", ["gray", "420"])
def test_restart_and_host_entropy_route_per_image(monkeypatch, kw, ss):
    rungs = _Rungs(monkeypatch)
    cfg = EncodeConfig(subsampling=ss, dct_dtype="int32", **kw)
    images = [_photo(40, 56, 71, rgb=True), _photo(24, 32, 72)]
    if ss == "gray":
        got = batch.encode_grayscale_batch(images, cfg, **CPU)
        want = [jpegtpu_torch.encode_grayscale(im, cfg, **CPU)
                for im in images]
    else:
        got = batch.encode_color_batch(images, cfg, **CPU)
        want = [jpegtpu_torch.encode_color(im, cfg, **CPU) for im in images]
    assert got == want and rungs.caps == []


@pytest.mark.parametrize("color", [True, False], ids=["420", "gray"])
def test_a_batch_stages_through_the_ring_in_chunks(monkeypatch, color):
    """With buffers of two small images, a group of five spans three
    chunks and wraps the ring; an image larger than a buffer is a chunk of
    its own and grows it. The groups hold a 2-D image (into three channels
    for color), sizes that are not whole MCUs, and RGB images. Every file
    equals its single-image encode."""
    if color:  # 20 x 30 pads to 32 x 32 x 3 = 3,072 bytes
        cfg, chunk = EncodeConfig(subsampling="420", dct_dtype="int32"), 6144
        shapes = [(20, 30, 3), (20, 30), (17, 32, 3), (32, 20, 3),
                  (20, 30, 3), (40, 60, 3), (33, 64, 3)]
        encode, single = batch.encode_color_batch, jpegtpu_torch.encode_color
    else:  # 2-D 20 x 30 pads to 24 x 32 = 768 bytes
        cfg, chunk = EncodeConfig(dct_dtype="int32"), 1536
        shapes = [(20, 30), (17, 32), (24, 25), (20, 30), (23, 31),
                  (20, 30, 3), (40, 60), (33, 64)]
        encode = batch.encode_grayscale_batch
        single = jpegtpu_torch.encode_grayscale
    images = [_photo(*s[:2], 90 + i, rgb=len(s) == 3)
              for i, s in enumerate(shapes)]
    monkeypatch.setattr(transfer, "_CHUNK_BYTES", chunk)
    monkeypatch.setattr(transfer, "_rings", {})
    with tracing.recording():
        got = encode(images, cfg, **CPU)
    ring = transfer._rings[False]
    # five small images two a chunk, then one a chunk for each larger
    # one (color: two of 48 x 64 x 3; gray: one RGB 24 x 32 x 3 and two
    # 40 x 64)
    assert tracing.totals()["counts"]["io.chunks"] == (5 if color else 6)
    assert max(b.numel() for b in ring.buffers) == (
        48 * 64 * 3 if color else 40 * 64)
    for image, data in zip(images, got):
        assert data == single(image, cfg, **CPU)
    ring.copiers.shutdown()


_GRAY, _COLOR = EncodeConfig(), EncodeConfig(subsampling="420")
_MESH = dict(mesh=["cpu"] * 2)


@pytest.mark.parametrize("entry", [
    lambda ims: [jpegtpu_torch.encode_grayscale(im, _GRAY, **CPU)
                 for im in ims],
    lambda ims: [jpegtpu_torch.encode_color(im, _COLOR, **CPU) for im in ims],
    lambda ims: batch.encode_grayscale_batch(ims, _GRAY, **CPU),
    lambda ims: batch.encode_color_batch(ims, _COLOR, **CPU),
    lambda ims: jpegtpu_torch.encode_stream_list(ims, _GRAY, **CPU),
    lambda ims: jpegtpu_torch.encode_stream_list(ims, _COLOR, color=True,
                                                 **CPU),
    lambda ims: [sharding.encode_grayscale_sharded(im, _GRAY, **_MESH)
                 for im in ims],
    lambda ims: [color_pipeline.encode_color_sharded(im, _COLOR, **_MESH)
                 for im in ims],
], ids=["single_gray", "single_420", "batch_gray", "batch_420",
        "stream_gray", "stream_420", "sharded_gray", "sharded_420"])
def test_every_entry_crosses_the_bus_through_the_ring(entry):
    """Each entry stages its images through the ring (io.chunks, io.stack,
    io.pad, io.upload) and reads its scans back through one host finish
    (io.readback, io.stuff). The bytes are held by the other tests."""
    images = [_photo(61, 93, 95, rgb=True), _photo(61, 93, 96)]
    with tracing.recording():
        files = entry(images)
    t = tracing.totals()
    assert len(files) == 2 and all(f[:2] == b"\xff\xd8" for f in files)
    assert t["counts"]["io.chunks"] >= 1
    assert {"io.stack", "io.pad", "io.upload", "io.readback",
            "io.stuff"} <= set(t["spans"])


def test_input_order_empty_batch_and_refusals():
    images = [_photo(16, 16, 81), _photo(24, 8, 82), _photo(16, 16, 83)]
    cfg = EncodeConfig(dct_dtype="int32")
    got = batch.encode_grayscale_batch(images, cfg, **CPU)
    assert got == [jpegtpu_torch.encode_grayscale(im, cfg, **CPU)
                   for im in images]
    assert got == batch.encode_grayscale_batch(images[::-1], cfg,
                                               **CPU)[::-1]
    assert batch.encode_grayscale_batch([], **CPU) == []
    assert batch.encode_color_batch([], **CPU) == []
    # a mesh splits the batch across devices and changes no file
    assert batch.encode_grayscale_batch(images, cfg, mesh=["cpu"] * 2,
                                        **CPU) == got
    ccfg = EncodeConfig(subsampling="420", dct_dtype="int32")
    assert batch.encode_color_batch(images, ccfg, mesh=["cpu"] * 3) == \
        batch.encode_color_batch(images, ccfg, **CPU)
    with pytest.raises(ValueError, match="encode_color_batch"):
        batch.encode_grayscale_batch(images, EncodeConfig(subsampling="420"),
                                     **CPU)
    with pytest.raises(ValueError, match="encode_grayscale_batch"):
        batch.encode_color_batch(images, cfg, **CPU)
    with pytest.raises(ValueError, match="uint8"):
        batch.encode_grayscale_batch([images[0].astype(np.int32)], **CPU)
    # stuff="device" (ROADMAP.md M10): a batch stuffs on the host, as in
    # jpegtpu, which ignores the field there
    assert batch.encode_grayscale_batch(
        images, dataclasses.replace(cfg, stuff="device"), **CPU) == got
