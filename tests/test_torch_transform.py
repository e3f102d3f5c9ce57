"""K1 (jpegtpu_torch.ops.transform) against jpegtpu's Pallas transform
(`transform_plane_raw`, interpret mode) and the natural_c goldens."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu import tables as jtables
from jpegtpu.ops import pallas_transform as pt

import jpegtpu_torch
from jpegtpu_torch import tables
from jpegtpu_torch.ops import transform

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)


def _jpegtpu_levels(img, cfg, int_mode):
    """[64, nb] levels of jpegtpu's K1, raster block order."""
    h, w = img.shape
    kh, kw = pt.padded_dims_kernel(h, w)
    padded = np.pad(img, ((0, kh - h), (0, kw - w)))
    q = cfg.luma_quant.astype(np.int32 if int_mode else np.float32)
    raw = pt.transform_plane_raw(
        jnp.asarray(padded), jnp.asarray(q), cfg.bitexact, interpret=True,
        int_mode=int_mode,
    )
    return np.asarray(pt.raw_to_scan(raw, h // 8, w // 8, kw // pt.TILE_W))


@pytest.mark.parametrize("bitexact", [True, False])
@pytest.mark.parametrize("int_mode", [False, True])
@pytest.mark.parametrize("shape", [(64, 1024), (120, 168)])
def test_plain_matches_pallas_transform(shape, int_mode, bitexact):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape, np.uint8)
    cfg = jpegtpu_torch.EncodeConfig(quality=75, bitexact=bitexact)
    state = tables.encoder_state(cfg, "cpu")
    got = transform.transform(torch.from_numpy(img), state, int_mode)
    assert got.dtype == torch.int32 and got.shape == (64, img.size // 64)
    np.testing.assert_array_equal(
        got.numpy(), _jpegtpu_levels(img, cfg, int_mode)
    )


def test_levels_match_goldens(golden):
    """The natural_c tolerance of tests/test_transform.py: mismatches are
    rare, +-1, and sit on a 0.5 rounding boundary of the reference's
    float32 arithmetic."""
    cfg = jpegtpu_torch.EncodeConfig()
    zz = jpegtpu_torch.grayscale_coefficients(golden["y"], cfg, device="cpu")
    ref = golden["zigzag"].astype(np.int32)
    assert zz.shape == ref.shape
    mism = zz != ref
    assert mism.sum() / zz.size < 1e-4
    if mism.any():
        assert np.abs(zz[mism] - ref[mism]).max() == 1
        centered = golden["centered"].astype(np.float64)
        ph, pw = centered.shape
        t = jtables.dct_basis_reference(np.float64)
        b = centered.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,...xy,vy->...uv", t, b, t).reshape(-1, 64)
        q = cfg.luma_quant.reshape(64).astype(np.float64)
        scaled = (f / q)[:, jtables.ZIGZAG_ORDER][mism]
        dist = np.abs(np.abs(scaled - np.trunc(scaled)) - 0.5)
        assert dist.max() < 1e-4


def test_rejects_unaligned_plane():
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(), "cpu")
    with pytest.raises(ValueError):
        transform.transform(torch.zeros((12, 16), dtype=torch.uint8), state,
                            False)
