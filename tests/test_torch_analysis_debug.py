"""Quality analysis (jpegtpu_torch.analysis) and the block report
(jpegtpu_torch.debug) on the CPU, against jpegtpu's: the metrics exactly,
analyze_pair's result, report text and difference figure on the same
files; the block report at several blocks of a ragged image, gray and
RGB, against jpegtpu.debug (the DCT coefficients to 1e-3, the rest
exactly) and against the natural_c goldens; with dct_dtype="int32",
against jpegtpu's int32 levels (jpegtpu's own report is all zeros past
the samples there: its dct_basis() casts the basis to int32)."""
import dataclasses

import numpy as np
import pytest
import torch

from jpegtpu import analysis as janalysis
from jpegtpu import debug as jdebug
from jpegtpu import pipeline as jpipeline
from jpegtpu.config import EncodeConfig as JConfig

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, analysis, debug
from jpegtpu_torch.io import bmp

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")
DCT_ATOL = 1e-3  # coefficients reach 2^11, where a float32 ulp is 2.4e-4


def _image(h, w, seed, rgb=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3.1 + yy * 1.7) % 256
    shape = (h, w, 3) if rgb else (h, w)
    noise = rng.normal(0, 20, shape)
    if rgb:
        base = base[..., None]
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("pair", ["noise", "same", "flat_vs_image"])
def test_metrics_equal_jpegtpu(pair):
    a = _image(37, 52, 1)
    b = {"noise": _image(37, 52, 2), "same": a.copy(),
         "flat_vs_image": np.full_like(a, 128)}[pair]
    for name in ("mse", "psnr", "ssim"):
        assert getattr(analysis, name)(a, b) == getattr(janalysis, name)(a, b)


def test_analyze_pair_report_and_figure_equal_jpegtpu(tmp_path):
    from PIL import Image

    src = str(tmp_path / "in.bmp")
    jpg = str(tmp_path / "in.jpg")
    bmp.write(src, _image(40, 56, 3, rgb=True))
    jpegtpu_torch.encode_file(src, jpg, EncodeConfig(subsampling="420"),
                              **CPU)
    got = analysis.analyze_pair(src, jpg, str(tmp_path / "port.png"))
    want = janalysis.analyze_pair(src, jpg, str(tmp_path / "ref.png"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert analysis.format_report(got) == janalysis.format_report(want)
    figs = [np.asarray(Image.open(tmp_path / f)) for f in ("port.png",
                                                            "ref.png")]
    np.testing.assert_array_equal(*figs)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(quality=90, bitexact=False),
], ids=["default", "q90_true_basis"])
@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_block_report_equals_jpegtpu(rgb, cfg):
    img = _image(20, 27, 4, rgb=rgb)  # 3 x 4 blocks after the edge pad
    for block in (0, 5, 11, -1):
        got = debug.first_block_report(img, EncodeConfig(**cfg), block, **CPU)
        want = jdebug.first_block_report(img, JConfig(**cfg), block)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            if k == "dct":
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=DCT_ATOL)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_block_report_equals_goldens(golden):
    y = golden["y"]
    nbw = y.shape[1] // 8
    for block in (0, 5):
        rep = debug.first_block_report(y, EncodeConfig(), block, **CPU)
        r, c = divmod(block, nbw)
        win = np.s_[8 * r:8 * r + 8, 8 * c:8 * c + 8]
        np.testing.assert_array_equal(rep["y"], y[win])
        np.testing.assert_array_equal(rep["centered"], golden["centered"][win])
        np.testing.assert_array_equal(rep["quant"], golden["quant"][win])
        np.testing.assert_array_equal(rep["zigzag"], golden["zigzag"][block])


def test_block_report_int32_follows_the_encoder():
    img = _image(20, 27, 5)
    levels = jpipeline.grayscale_coefficients(img, JConfig(dct_dtype="int32"))
    for block in (0, 7, 11):
        rep = debug.first_block_report(img, EncodeConfig(dct_dtype="int32"),
                                       block, **CPU)
        np.testing.assert_array_equal(rep["zigzag"], levels[block])
        assert rep["dct"].dtype == np.int32 and rep["dct"].any()
        assert rep["quant"].reshape(64)[jpegtpu_torch.tables.ZIGZAG_ORDER
                                        ].tolist() == levels[block].tolist()


def test_block_report_text_and_default_device():
    rep = debug.first_block_report(_image(16, 16, 6), **CPU)
    assert debug.format_block_report(rep) == jdebug.format_block_report(rep)
    assert "--- zigzag ---" in debug.format_block_report(rep)
    with pytest.raises(IndexError):
        debug.first_block_report(_image(16, 16, 6), block=4, **CPU)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError):
            debug.first_block_report(_image(16, 16, 6))
