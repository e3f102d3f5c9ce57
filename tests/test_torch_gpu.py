"""jpegtpu_torch's CUDA kernels against their plain PyTorch versions on
the card, at small and ragged shapes (chip_smoke.py covers the main
path's 3024 x 4032). Needs a CUDA card; skipped without one. Run on the
card with:  python -m pytest tests/test_torch_gpu.py -m gpu -n0
"""
import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch import tables
from jpegtpu_torch.entropy import concat, pack
from jpegtpu_torch.entropy.device import dc_differences
from jpegtpu_torch.ops import transform

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cap", [8, 16, 53])
@pytest.mark.parametrize("shape", [(8, 8), (200, 1504), (72, 1032)])
@pytest.mark.parametrize("quality", [50, 100])
def test_kernels_match_plain(cuda, shape, cap, quality):
    rng = np.random.default_rng(shape[0] + cap)
    img = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda)
    state = tables.encoder_state(
        jpegtpu_torch.EncodeConfig(quality=quality), cuda)
    nbh, nbw = shape[0] // 8, shape[1] // 8
    for int_mode in (False, True):
        lv = transform.transform(img, state, int_mode)
        assert torch.equal(lv, transform.transform_plain(img, state, int_mode))
    dcd = dc_differences(lv[0])
    words, bits = pack.encode_blocks(lv, dcd, state.huff, cap)
    w_p, b_p = pack.encode_blocks_plain(lv, dcd, state.huff, cap)
    assert torch.equal(bits, b_p) and torch.equal(words, w_p)
    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
    s_p, sb_p = concat.merge_rows_plain(words, bits, nbh, nbw)
    assert torch.equal(segs, s_p) and torch.equal(seg_bits, sb_p)
    n = concat.stream_words(nbh * nbw, cap)
    stream, total = concat.stream_concat(segs, seg_bits, n)
    st_p, tot_p = concat.stream_concat_plain(segs, seg_bits, n)
    assert torch.equal(stream, st_p) and int(total) == int(tot_p)


def test_encode_matches_cpu_in_int32_mode(cuda):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (61, 93), np.uint8)
    for quality in (50, 100):
        cfg = jpegtpu_torch.EncodeConfig(quality=quality, dct_dtype="int32")
        assert jpegtpu_torch.encode_grayscale(img, cfg) == (
            jpegtpu_torch.encode_grayscale(img, cfg, device="cpu"))
