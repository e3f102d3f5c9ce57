"""Edge cases of K4 and the transforms K1-K3 (tests/kernel_edge_cases.py):
the port's plain twins against jpegtpu on the CPU (K4 against jpegtpu's
host coder, and past its tables against `encode_blocks_pallas` in
interpret mode; K1 against `transform_plane_raw` in interpret mode; K2 and
K3 against jpegtpu's color chain), and, marked gpu, the CUDA kernels
against their twins on the card, word for word and level for level. On
the card:
  python -m pytest tests/test_torch_kernel_edges.py -m gpu --noconftest \\
      -o addopts=""
"""
import types

import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch import pipeline, tables
from jpegtpu_torch.entropy import pack
from jpegtpu_torch.entropy.device import symbol_histograms
from jpegtpu_torch.ops import transform

from kernel_edge_cases import k4_blocks, transform_image
from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CAPS = [1, 8, 53]
NBS = [1, 31, 33, 1000]
# ragged grids: block columns past a tile of 32 (K1, K2) or 16 (K3)
GRAY_SHAPES = [(24, 296), (8, 8), (40, 520)]
COLOR_MCUS = {"420": (3, 19), "422": (2, 17), "444": (2, 37)}


@pytest.fixture
def ref():
    """jpegtpu's modules, imported by the CPU cases alone: the card's
    machine has no JAX."""
    import jax.numpy as jnp

    import jpegtpu
    from jpegtpu import color_pipeline, tables as jtables
    from jpegtpu.entropy import host, pallas_pack
    from jpegtpu.ops import pallas_transform
    return types.SimpleNamespace(
        jnp=jnp, jpegtpu=jpegtpu, jcp=color_pipeline, tables=jtables,
        host=host, pallas_pack=pallas_pack, pt=pallas_transform)


def _annex_k(device="cpu"):
    return tables.encoder_state(jpegtpu_torch.EncodeConfig(), device).huff


def _optimal(zz, dcd, device="cpu"):
    """Optimal tables of these blocks (the 2-pass build): (specs, [192])."""
    lv = torch.from_numpy(zz.T.copy()).to(device)
    specs, (huff,) = pipeline.optimal_tables(
        symbol_histograms(lv, torch.from_numpy(dcd).to(device)), ("lum",),
        device)
    return specs, huff


def _host_streams(ref, zz, dcd, luts):
    """Per-block (value, nbits) streams of jpegtpu's host coder, whose DC
    chain runs over zz[:, 0]: the levels get DC values whose differences
    are dcd."""
    zz = zz.copy()
    zz[:, 0] = np.cumsum(dcd.astype(np.int64))
    symbols, amps, amp_bits, is_dc, block_of = ref.host.symbolize(zz)
    out = [[0, 0] for _ in range(zz.shape[0])]
    for s, a, ab, dc, b in zip(symbols, amps, amp_bits, is_dc, block_of):
        codes, lens = luts["dc_lum" if dc else "ac_lum"]
        n = int(lens[s]) + int(ab)
        out[b][0] = (out[b][0] << n) | (int(codes[s]) << int(ab)) | int(a)
        out[b][1] += n
    return out


def _check_streams(words, bits, streams, cap):
    w = words.numpy().view(np.uint32)
    for i, (val, nbits) in enumerate(streams):
        assert int(bits[i]) == nbits, i
        kept = min(nbits, 32 * cap)
        got = 0
        for j in range(cap):
            got = (got << 32) | int(w[j, i])
        assert got >> (32 * cap - kept) == val >> (nbits - kept), i
        assert got & ((1 << (32 * cap - kept)) - 1) == 0, i  # zero past bits


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("nb", NBS)
def test_plain_k4_edges_match_host_coder(ref, nb, cap):
    zz, dcd = k4_blocks(nb, seed=nb)
    words, bits = pack.encode_blocks(torch.from_numpy(zz.T.copy()),
                                     torch.from_numpy(dcd), _annex_k(), cap)
    assert words.shape == (cap, nb)
    streams = _host_streams(ref, zz, dcd, ref.tables.huffman_luts())
    _check_streams(words, bits, streams, cap)
    if nb > 1:  # block 0 (63 levels of size 10) overflows caps 1 and 8
        assert (int(bits[0]) > 32 * cap) == (cap < 53)


@pytest.mark.parametrize("cap", CAPS)
def test_plain_k4_edges_with_optimal_tables_match_host_coder(ref, cap):
    zz, dcd = k4_blocks(1000, seed=7)
    specs, huff = _optimal(zz, dcd)
    assert int((huff & 63).max()) > 11  # long codes are in play
    words, bits = pack.encode_blocks(torch.from_numpy(zz.T.copy()),
                                     torch.from_numpy(dcd), huff, cap)
    luts = ref.tables.huffman_luts_from_specs(specs)
    _check_streams(words, bits, _host_streams(ref, zz, dcd, luts), cap)


def test_plain_k4_past_the_tables_matches_pallas(ref):
    """DC difference sizes 12-15 and AC sizes 11-15 take entry 0 of their
    class, as jpegtpu's select cascades do."""
    zz, dcd = k4_blocks(40, seed=3, past_table=True)
    w_ref, b_ref, _ = ref.pallas_pack.encode_blocks_pallas(
        ref.jnp.asarray(zz), ref.jnp.asarray(dcd), cap=8, table=0,
        interpret=True)
    words, bits = pack.encode_blocks(torch.from_numpy(zz.T.copy()),
                                     torch.from_numpy(dcd), _annex_k(), 8)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(w_ref))


@pytest.mark.parametrize("cap", [-1, 54, 100])
def test_k4_refuses_caps_past_the_largest_block(cap):
    """Caps run from 0 to MAX_WORDS_PER_BLOCK = 53, the words of the
    longest block the tables make; the pipelines clamp their rungs to it."""
    zz, dcd = k4_blocks(33, seed=1)
    with pytest.raises(ValueError, match=f"cap {cap}"):
        pack.encode_blocks(torch.from_numpy(zz.T.copy()),
                           torch.from_numpy(dcd), _annex_k(), cap)


@pytest.mark.parametrize("int_mode", [False, True])
def test_plain_transform_edges_match_pallas(ref, int_mode):
    img = transform_image(24, 296, seed=1)
    cfg = jpegtpu_torch.EncodeConfig(quality=90)
    state = tables.encoder_state(cfg, "cpu")
    got = transform.transform(torch.from_numpy(img), state, int_mode)
    pt, jnp = ref.pt, ref.jnp
    kh, kw = pt.padded_dims_kernel(*img.shape)
    raw = pt.transform_plane_raw(
        jnp.asarray(np.pad(img, ((0, kh - 24), (0, kw - 296)))),
        jnp.asarray(cfg.luma_quant.astype(np.int32 if int_mode
                                          else np.float32)),
        cfg.bitexact, interpret=True, int_mode=int_mode)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pt.raw_to_scan(raw, 3, 37, kw // pt.TILE_W)))


def test_plain_color_transform_edges_match_jpegtpu(ref):
    """4:2:0; tests/test_torch_color_kernels.py covers 4:2:2 and 4:4:4."""
    nmch, nmcw = COLOR_MCUS["420"]
    img = transform_image(16 * nmch, 16 * nmcw, seed=2, channels=3)
    jnp = ref.jnp
    for int_mode in (False, True):
        kw = {"quality": 90, "subsampling": "420",
              "dct_dtype": "int32" if int_mode else "float32"}
        cfg = ref.jpegtpu.EncodeConfig(**kw)
        zy, zcb, zcr = ref.jcp._component_levels(
            jnp.asarray(np.moveaxis(img, -1, 0)), cfg, None,
            jnp.asarray(cfg.luma_quant.astype(np.float32)),
            jnp.asarray(cfg.chroma_quant.astype(np.float32)))
        state = tables.encoder_state(jpegtpu_torch.EncodeConfig(**kw), "cpu")
        rgb = torch.from_numpy(img)
        np.testing.assert_array_equal(
            transform.transform_rgb_y(rgb, state, int_mode).T.numpy(),
            np.asarray(zy))
        np.testing.assert_array_equal(
            transform.transform_rgb_chroma(rgb, state, int_mode,
                                           "420").T.numpy(),
            np.concatenate([np.asarray(zcb), np.asarray(zcr)]))


# --- the kernels against their plain versions, on the card -----------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("optimal", [False, True])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("nb", NBS)
def test_k4_edges_match_plain(cuda, nb, cap, optimal):
    zz, dcd = k4_blocks(nb, seed=nb + cap, past_table=True)
    huff = _optimal(zz, dcd, cuda)[1] if optimal else _annex_k(cuda)
    lv = torch.from_numpy(zz.T.copy()).to(cuda)
    d = torch.from_numpy(dcd).to(cuda)
    got = pack.encode_blocks(lv, d, huff, cap)
    want = pack.encode_blocks_plain(lv, d, huff, cap)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [-1, 54])
def test_k4_refuses_caps_past_the_largest_block_on_the_card(cuda, cap):
    zz, dcd = k4_blocks(33, seed=1)
    with pytest.raises(ValueError, match=f"cap {cap}"):
        pack.encode_blocks(torch.from_numpy(zz.T.copy()).to(cuda),
                           torch.from_numpy(dcd).to(cuda), _annex_k(cuda),
                           cap)


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """t's copy whose data starts nbytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + nbytes, dtype=t.dtype, device=t.device)
    out = buf[nbytes:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GRAY_SHAPES)
@pytest.mark.parametrize("int_mode", [False, True])
def test_transform_edges_match_plain(cuda, shape, int_mode):
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(quality=90),
                                 cuda)
    plane = torch.from_numpy(transform_image(*shape, seed=shape[1])).to(cuda)
    rgb = torch.from_numpy(
        transform_image(*shape, seed=shape[0], channels=3)).to(cuda)
    for p in (plane, _offset(plane, 8)):  # rows on 16- and 8-byte bounds
        assert torch.equal(transform.transform(p, state, int_mode),
                           transform.transform_plain(p, state, int_mode))
    for x in (rgb, _offset(rgb, 8)):
        for ref in (False, True):
            assert torch.equal(
                transform.transform_rgb_y(x, state, int_mode, ref),
                transform.transform_rgb_y_plain(x, state, int_mode, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("ss", ["420", "422", "444"])
@pytest.mark.parametrize("int_mode", [False, True])
def test_chroma_transform_edges_match_plain(cuda, ss, int_mode):
    nmch, nmcw = COLOR_MCUS[ss]
    fy, fx = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}[ss]
    state = tables.encoder_state(jpegtpu_torch.EncodeConfig(quality=90),
                                 cuda)
    rgb = torch.from_numpy(transform_image(
        8 * fy * nmch, 8 * fx * nmcw, seed=nmcw, channels=3)).to(cuda)
    for x in (rgb, _offset(rgb, 8)):
        assert torch.equal(
            transform.transform_rgb_chroma(x, state, int_mode, ss),
            transform.transform_rgb_chroma_plain(x, state, int_mode, ss))
