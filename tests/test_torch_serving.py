"""Pipelined serving (jpegtpu_torch.serving) on the CPU: every streamed
file equal, in input order, to jpegtpu's serving.encode_stream (one call
into its interpret-mode chain) and to the port's single-image encodes;
4:2:0, a lazy source, the blocking configs, depth 0, and an image that
overflows the first rung. Bytes are compared exactly."""
import numpy as np
import pytest

import jpegtpu
from jpegtpu import serving as jserving

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, pipeline, serving

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")


def _gray(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.clip((xx * 1.3 + yy * 0.7) % 256 + rng.normal(0, 12, (h, w)),
                   0, 255).astype(np.uint8)


def _rgb(h, w, seed):
    return np.stack([_gray(h, w, seed + s) for s in range(3)], axis=-1)


# one shape for jpegtpu's stream (one interpret-mode program), then
# ragged, RGB and narrow images for the port's own
SAME = [_gray(16, 24, s) for s in (1, 2, 3)]
MIXED = SAME + [_gray(37, 50, 4), _rgb(21, 40, 5), _gray(8, 8, 6)]


def test_stream_gray_equals_jpegtpu_stream():
    want = list(jserving.encode_stream(SAME, jpegtpu.EncodeConfig(), depth=2))
    assert serving.encode_stream_list(SAME, depth=2, **CPU) == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_gray_equals_singles_in_order(depth):
    outs = list(serving.encode_stream(MIXED, depth=depth, **CPU))
    assert outs == [jpegtpu_torch.encode_grayscale(im, **CPU)
                    for im in MIXED]


@pytest.mark.parametrize("cfg", [
    EncodeConfig(subsampling="420"),
    EncodeConfig(subsampling="422", dct_dtype="int32", stuff="device"),
], ids=["420", "422_int32_device_stuff"])
def test_stream_color_equals_singles_in_order(cfg):
    imgs = [_rgb(32, 48, 10), _gray(24, 40, 20), _rgb(17, 33, 30)]
    outs = serving.encode_stream_list(imgs, cfg, color=True, depth=2, **CPU)
    assert outs == [jpegtpu_torch.encode_color(im, cfg, **CPU)
                    for im in imgs]


def test_stream_is_lazy_generator():
    """After k outputs, at most k + depth inputs have been pulled."""
    pulled = []

    def src():
        for s in range(6):
            pulled.append(s)
            yield _gray(16, 24, 100 + s)

    it = serving.encode_stream(src(), depth=2, **CPU)
    next(it)
    assert len(pulled) <= 1 + 2


@pytest.mark.parametrize("cfg", [
    EncodeConfig(optimize_huffman=True), EncodeConfig(restart_interval=4),
    EncodeConfig(entropy="host"),
], ids=["2pass", "restart", "host"])
def test_stream_blocking_configs_still_stream_in_order(cfg):
    imgs = [_gray(24, 32, 40), _gray(16, 40, 41)]
    assert serving.encode_stream_list(imgs, cfg, **CPU) == [
        jpegtpu_torch.encode_grayscale(im, cfg, **CPU) for im in imgs]


def test_depth_below_one_and_wrong_config_raise():
    with pytest.raises(ValueError, match="depth"):
        serving.encode_stream_list([SAME[0]], depth=0, **CPU)
    with pytest.raises(ValueError, match="color"):
        serving.encode_stream_list([SAME[0]], EncodeConfig(), color=True,
                                   **CPU)


def test_overflow_falls_back_and_teaches_later_submissions(monkeypatch):
    """A Q100 noise image overflows rung 8: its file is the blocking
    encoder's, its neighbours are untouched, and the blocking ladder's
    record starts the next submission of its site at the rung that fit."""
    cfg = EncodeConfig(quality=100)
    rng = np.random.default_rng(0)
    hot = [rng.integers(0, 256, (40, 72), np.uint8) for _ in range(2)]
    calm = np.full((40, 72), 90, np.uint8)  # fits rung 8 at any quality
    key = (5, 9, cfg, False)  # the blocking encoder's site key
    pipeline._cap_history.pop(key, None)
    caps = []
    real = serving.encode_blocks

    def spy(levels, dcd, huff, cap):
        caps.append(cap)
        return real(levels, dcd, huff, cap)

    monkeypatch.setattr(serving, "encode_blocks", spy)
    imgs = [calm, hot[0], calm, hot[1]]
    outs = serving.encode_stream_list(imgs, cfg, depth=1, **CPU)
    assert outs == [jpegtpu_torch.encode_grayscale(im, cfg, **CPU)
                    for im in imgs]
    fit = pipeline._cap_history[key][0]
    assert fit > 8
    # calm and hot[0] at rung 8; after the fallback, the site's rung
    assert caps == [8, 8, pipeline.kernel_cap(fit),
                    pipeline.kernel_cap(fit)]
    pipeline._cap_history.pop(key, None)
