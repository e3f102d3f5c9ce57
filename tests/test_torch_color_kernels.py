"""The color path's kernels, as their plain versions run them on the CPU:
K2 and K3 (jpegtpu_torch.ops.transform) against jpegtpu's unfused chain
(`jpegtpu.ops.color` + `color_pipeline._component_levels`), K5
(jpegtpu_torch.entropy.merge) followed by K8 and K9 against jpegtpu's host
coder on jpegtpu's interleaved levels, the luma DC chain against
`_y_dc_diff_natural`, and the color conversion and subsampling ops."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu import color_pipeline as jcp
from jpegtpu.entropy import host as jhost
from jpegtpu.ops import color as jcolor

import jpegtpu_torch
from jpegtpu_torch import pipeline, tables
from jpegtpu_torch.entropy import merge, pack
from jpegtpu_torch.entropy.device import dc_differences, y_dc_differences
from jpegtpu_torch.ops import color, transform

MODES = ["420", "422", "444"]
FACTORS = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}


def _rgb(ss, nmch, nmcw, seed):
    """Smooth color content plus noise, nmch x nmcw MCUs."""
    fy, fx = FACTORS[ss]
    h, w = 8 * fy * nmch, 8 * fx * nmcw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(xx * (2 + c) + yy * (1 + c)) % 256 + rng.normal(0, 12, (h, w))
             for c in range(3)]
    return np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ss", MODES)
@pytest.mark.parametrize("int_mode", [False, True])
def test_plain_transforms_match_jpegtpu_unfused_chain(ss, int_mode):
    img = _rgb(ss, 5, 7, seed=len(ss) + int_mode)
    kw = {"quality": 75, "subsampling": ss,
          "dct_dtype": "int32" if int_mode else "float32"}
    cfg = jpegtpu.EncodeConfig(**kw)
    zy, zcb, zcr = jcp._component_levels(
        jnp.asarray(np.moveaxis(img, -1, 0)), cfg, None,
        jnp.asarray(cfg.luma_quant.astype(np.float32)),
        jnp.asarray(cfg.chroma_quant.astype(np.float32)))
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(**kw), "cpu")
    rgb = torch.from_numpy(img)
    ly = transform.transform_rgb_y(rgb, state, int_mode)
    lc = transform.transform_rgb_chroma(rgb, state, int_mode, ss)
    assert ly.dtype == lc.dtype == torch.int32
    np.testing.assert_array_equal(ly.T.numpy(), np.asarray(zy))
    np.testing.assert_array_equal(
        lc.T.numpy(), np.concatenate([np.asarray(zcb), np.asarray(zcr)]))


@pytest.mark.parametrize("int_mode", [False, True])
def test_reference_luma_matches_jpegtpu_gray_path(int_mode):
    """K2's kind="y_ref": the reference's (77R+150G+29B)>>8 luma, which
    jpegtpu's grayscale path applies to RGB input."""
    img = _rgb("444", 6, 9, seed=11)
    kw = {"dct_dtype": "int32" if int_mode else "float32"}
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(**kw), "cpu")
    got = transform.transform_rgb_y(torch.from_numpy(img), state, int_mode,
                                    ref_luma=True)
    np.testing.assert_array_equal(
        got.T.numpy(),
        jpegtpu.grayscale_coefficients(img, jpegtpu.EncodeConfig(**kw)))


def test_transforms_reject_misaligned_rgb():
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu")
    with pytest.raises(ValueError):
        transform.transform_rgb_y(torch.zeros((8, 12, 3), dtype=torch.uint8),
                                  state, False)
    with pytest.raises(ValueError):
        transform.transform_rgb_chroma(
            torch.zeros((8, 16, 3), dtype=torch.uint8), state, False, "420")


def _component_streams(zz, ss, nmch, nmcw, cap):
    """jpegtpu's interleaved levels -> the port's per-component levels,
    DC chains and K4 streams (plain versions)."""
    fy, fx = FACTORS[ss]
    ph, pw = 8 * fy * nmch, 8 * fx * nmcw
    gather, _, _ = jcp._scan_layout(ph, pw, ss)
    allz = np.empty_like(zz)
    allz[gather] = zz
    ny = fy * fx * nmch * nmcw
    ly = torch.from_numpy(allz[:ny].T.copy())
    lc = torch.from_numpy(allz[ny:].T.copy())
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu")
    dy = y_dc_differences(ly[0].reshape(fy * nmch, fx * nmcw), ss)
    dc = dc_differences(lc[0].reshape(2, -1)).reshape(-1)
    wy, by = pack.encode_blocks(ly, dy.reshape(-1), state.huff, cap)
    wc, bc = pack.encode_blocks(lc, dc, state.huff_chroma, cap)
    return wy, by, wc, bc


@pytest.mark.parametrize("ss", MODES)
@pytest.mark.parametrize("pad_ones", [True, False])
def test_merge_then_concat_matches_jpegtpu_host_coder(ss, pad_ones):
    nmch, nmcw = 3, 5
    img = _rgb(ss, nmch, nmcw, seed=30 + pad_ones)
    zz, table_sel, comp_id = jcp.color_coefficients(
        img, jpegtpu.EncodeConfig(subsampling=ss, quality=90))
    cap = 16
    wy, by, wc, bc = _component_streams(zz, ss, nmch, nmcw, cap)
    words, bits = merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, ss)
    e = jcp.slots_per_mcu(ss)
    assert words.shape == (e * cap, nmch * nmcw)

    # each MCU holds the sum of its blocks' bits, and zeros past them
    blocks = merge.mcu_luma_blocks(nmch, nmcw, ss)
    want_bits = by[blocks].sum(0) + bc.reshape(2, -1).sum(0)
    assert torch.equal(bits, want_bits.to(torch.int32))
    w = words.numpy().view(np.uint32).astype(np.int64)
    j = np.arange(e * cap)[:, None] * 32
    valid = (bits.numpy()[None, :] - j).clip(0, 32)
    assert not (w & ((1 << (32 - valid)) - 1)).any()

    scan = pipeline.finish_scan(words, bits, torch.tensor(False), nmch,
                                nmcw, pad_ones)
    assert scan == jhost.encode_scan(
        zz, table_sel=table_sel.astype(np.int64), comp_id=comp_id,
        pad_ones=pad_ones)[0]


def test_merge_mcu_clamps_overflowed_blocks():
    """A block past cap words (the encode will retry) contributes at most
    cap * 32 bits, so the MCU frame never overruns."""
    cap, nmch, nmcw = 2, 1, 3
    wy = torch.full((cap, 4 * nmch * nmcw), -1, dtype=torch.int32)
    by = torch.full((4 * nmch * nmcw,), 5 * 32, dtype=torch.int32)
    wc = torch.zeros((cap, 2 * nmch * nmcw), dtype=torch.int32)
    bc = torch.zeros((2 * nmch * nmcw,), dtype=torch.int32)
    words, bits = merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, "420")
    assert bits.tolist() == [4 * cap * 32] * 3
    full = words.numpy().view(np.uint32)
    assert (full[: 4 * cap] == 0xFFFFFFFF).all()
    assert (full[4 * cap:] == 0).all()


def test_merge_mcu_rejects_mismatched_shapes():
    z = torch.zeros((8, 24), dtype=torch.int32)
    with pytest.raises(ValueError):
        merge.merge_mcu(z, z[0], z[:, :12], z[0, :12], 2, 4, "420")


@pytest.mark.parametrize("ss", MODES)
@pytest.mark.parametrize("shape", [(2, 2), (6, 10), (8, 14)])
def test_luma_dc_chain_matches_jpegtpu(ss, shape):
    dc = np.random.default_rng(shape[1]).integers(-500, 500, shape, np.int32)
    want = np.asarray(jcp._y_dc_diff_natural(jnp.asarray(dc), ss))
    got = y_dc_differences(torch.from_numpy(dc), ss)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chroma_dc_chains_are_independent():
    dc = torch.tensor([[4, 6, 1], [-2, 0, 3]], dtype=torch.int32)
    assert dc_differences(dc).tolist() == [[4, 2, -5], [-2, 2, 3]]


@pytest.mark.parametrize("seed", [0, 1])
def test_color_ops_match_jpegtpu(seed):
    rgb = np.random.default_rng(seed).integers(0, 256, (16, 24, 3), np.uint8)
    t = torch.from_numpy(rgb)
    np.testing.assert_array_equal(color.rgb_to_ycbcr(t).numpy(),
                                  np.asarray(jcolor.rgb_to_ycbcr(rgb)))
    chan = rgb[..., 2]
    for (fy, fx), theirs in (((2, 2), jcolor.subsample_420),
                             ((1, 2), jcolor.subsample_422)):
        np.testing.assert_array_equal(
            color.subsample(torch.from_numpy(chan), fy, fx).numpy(),
            np.asarray(theirs(jnp.asarray(chan))))
