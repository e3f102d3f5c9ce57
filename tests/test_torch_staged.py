"""jpegtpu_torch's levels -> scan entry point, encode_scan_device, and the
staged path under it (symbolize_elements64, treepack._fuse_subslots, K7)
against jpegtpu's: the symbol tables, the symbolizers, the fusion, K7's
plain version against `pack_blocks_pallas` (interpret mode), and the
whole entry point over a covering set of its arguments. Exact
throughout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpegtpu.entropy import device as jdevice
from jpegtpu.entropy import pallas_pack, treepack as jtreepack

from jpegtpu_torch.entropy import device, pack, treepack

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)


def _random_levels(nb, seed=0, scale=200.0):
    """tests/test_entropy_device.py's levels: geometric decay, plus an
    all-zero block, a DC-only block and a block ending in a nonzero AC
    after a maximal run (three ZRLs)."""
    rng = np.random.default_rng(seed)
    zz = (rng.standard_normal((nb, 64))
          * np.geomspace(scale, 0.3, 64)[None, :]).astype(np.int32)
    zz[nb // 3] = 0
    zz[nb // 2, 1:] = 0
    if nb > 7:
        zz[7, 1:] = 0
        zz[7, 63] = 99
    return zz


def _dc_diff(zz):
    return np.concatenate([zz[:1, 0], np.diff(zz[:, 0])]).astype(np.int32)


NB = 131
ZZ = _random_levels(NB, seed=NB, scale=6.0)  # <= 187 bits a block
TABLES = (np.arange(NB) % 6 >= 4).astype(np.int64)  # 4:2:0's slot pattern
# an interleaved scan of 2 * NB slots, NB with each table: jpegtpu's
# per-table kernels then have the shapes of the single-table cases, whose
# traces it reuses
ZZ2 = np.concatenate([ZZ, _random_levels(NB, seed=2, scale=6.0)])
TABLES2 = np.concatenate([TABLES, 1 - TABLES])


def test_device_luts_match_jpegtpu():
    for got, want in zip(device._device_luts(), jdevice._device_luts()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.is_contiguous()


SYMBOLIZE = [(0, False, 0), (1, True, 0), ("array", False, 5),
             ("array", True, 0)]


def _args(table_sel, with_dc):
    sel_np = TABLES if table_sel == "array" else table_sel
    sel_t = torch.from_numpy(TABLES) if table_sel == "array" else table_sel
    dcd = _dc_diff(ZZ) if with_dc else None
    return (sel_np, None if dcd is None else jnp.asarray(dcd)), (
        sel_t, None if dcd is None else torch.from_numpy(dcd))


@pytest.mark.parametrize("table_sel,with_dc,seg_len", SYMBOLIZE)
def test_symbolize_elements64_and_fusion_match_jpegtpu(table_sel, with_dc,
                                                       seg_len):
    (jsel, jdc), (tsel, tdc) = _args(table_sel, with_dc)
    jv, jl = jdevice.symbolize_elements64(jnp.asarray(ZZ), jsel, jdc,
                                          seg_len)
    tv, tl = device.symbolize_elements64(torch.from_numpy(ZZ), tsel, tdc,
                                         seg_len)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv, np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for c_out in (2, 3):
        jw, jb = jtreepack._fuse_subslots(jv, jl, c_out)
        tw, tb = treepack._fuse_subslots(tv, tl, c_out)
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("table_sel,with_dc,seg_len", SYMBOLIZE)
def test_symbolize_slots_matches_jpegtpu(table_sel, with_dc, seg_len):
    (jsel, jdc), (tsel, tdc) = _args(table_sel, with_dc)
    jv, jl = jdevice.symbolize_slots(jnp.asarray(ZZ), jsel, jdc, seg_len)
    tv, tl = device.symbolize_slots(torch.from_numpy(ZZ), tsel, tdc, seg_len)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv, np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@functools.lru_cache(maxsize=None)
def _fused_elements():
    """The staged path's K7 input for ZZ, jpegtpu's and the port's."""
    jv, jl = jdevice.symbolize_elements64(jnp.asarray(ZZ))
    tv, tl = device.symbolize_elements64(torch.from_numpy(ZZ))
    return jtreepack._fuse_subslots(jv, jl, 3), treepack._fuse_subslots(
        tv, tl, 3)


@pytest.mark.parametrize("cap", [3, 8, 16])
def test_pack_blocks_plain_matches_jpegtpu(cap):
    (jw, jb), (tw, tb) = _fused_elements()
    want = pallas_pack.pack_blocks_pallas(jw, jb, cap=cap, interpret=True)
    got = pack.pack_blocks(tw, tb, cap)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2])


def test_pack_blocks_counts_every_bit_and_stores_cap_words():
    """A block past cap words keeps its first cap words and its full bit
    count; its overflow flag is set."""
    words_t = torch.zeros((3, 4, 2), dtype=torch.int32)
    words_t[:, :, 0] = -1  # four 96-bit elements of 1s in block 0
    bits_t = torch.zeros((4, 2), dtype=torch.int32)
    bits_t[:, 0] = 96
    bits_t[0, 1] = 5
    words_t[0, 0, 1] = (0b10110 << 27) - (1 << 32)
    words, bits, overflow = pack.pack_blocks(words_t, bits_t, 5)
    assert bits.tolist() == [384, 5] and bool(overflow)
    assert (words[:, 0] == -1).all()
    assert words[:, 1].tolist() == [(0b10110 << 27) - (1 << 32), 0, 0, 0, 0]


@pytest.mark.parametrize("total_bits", [0, 5, 8, 413, 1024, 4096])
def test_stuff_bytes_device_matches_jpegtpu(total_bits):
    """Streams dense in 0xFF bytes (one in the last valid byte, some past
    it), totals inside the stream, at its end and past it."""
    rng = np.random.default_rng(total_bits)
    raw = rng.choice(np.array([0x00, 0x12, 0xFE, 0xFF], np.uint8), 4 * 32)
    raw[min(max(total_bits + 7, 8) // 8, raw.size) - 1] = 0xFF
    words = raw.view(">u4").astype(np.uint32)
    want = jdevice.stuff_bytes_device(jnp.asarray(words),
                                      jnp.int32(total_bits))
    got = device.stuff_bytes_device(torch.from_numpy(words.view(np.int32)),
                                    torch.tensor(total_bits))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1]) == int(want[1])


def _jpegtpu_scan(zz, kw):
    kw = dict(kw)
    if "dc_diff" in kw:
        kw["dc_diff"] = jnp.asarray(kw["dc_diff"])
    return jax.jit(functools.partial(jdevice.encode_scan_device, **kw))(
        jnp.asarray(zz))


SMALL = _random_levels(7, seed=1, scale=1.0)  # <= 46 bits a block
SCAN_CASES = {
    "fused_default_cap": dict(),
    "fused_chroma_cap8_restart_stuffed": dict(table_sel=1, seg_len=7,
                                              capacity_words=NB * 8,
                                              stuff=True),
    "fused_table_array_pad0": dict(table_sel=TABLES2, dc_diff=_dc_diff(ZZ2),
                                   capacity_words=2 * NB * 8,
                                   pad_ones=False),
    "staged_cap2": dict(fused=False, capacity_words=7 * 2),
    "staged_cap2_overflows": dict(fused=False, capacity_words=NB * 2),
    "staged_cap8": dict(fused=False, capacity_words=NB * 8),
    "staged_cap16_restart_stuffed": dict(fused=False, seg_len=7,
                                         capacity_words=NB * 16, stuff=True),
    "staged_cap53_pad0": dict(fused=False, pad_ones=False),
    "staged_table_array": dict(table_sel=TABLES2, capacity_words=2 * NB * 8,
                               stuff=True, pad_ones=False),
    "scatter": dict(packer="scatter"),
    "scatter_table_array_stuffed": dict(packer="scatter", table_sel=TABLES2,
                                        dc_diff=_dc_diff(ZZ2), stuff=True,
                                        pad_ones=False),
}
# jpegtpu's fused multi-table pack compiles one interpret-mode kernel per
# table class (~9 s here); its scatter packer gives the same bytes
# (tests/test_entropy_device.py holds both to its host coder) in ~0.5 s.
ORACLE_PACKER = {"fused_table_array_pad0": "scatter"}


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_encode_scan_device_matches_jpegtpu(name):
    """Words up to the total (stuff=False) or the stuffed bytes
    (stuff=True), the total and the overflow flag; where jpegtpu reports
    an overflow only the flag has to agree."""
    kw = {"stuff": False, **SCAN_CASES[name]}
    zz = (SMALL if kw.get("capacity_words") == 7 * 2
          else ZZ2 if "table_sel" in kw and kw["table_sel"] is TABLES2
          else ZZ)
    want = _jpegtpu_scan(zz, {**kw, "packer": ORACLE_PACKER.get(
        name, kw.get("packer", "tree"))})
    tkw = dict(kw)
    if "dc_diff" in tkw:
        tkw["dc_diff"] = torch.from_numpy(tkw["dc_diff"])
    got = device.encode_scan_device(torch.from_numpy(zz), **tkw)
    assert bool(got[2]) == bool(want[2])
    if name.endswith("overflows"):
        assert bool(got[2])
        return
    assert not bool(got[2])
    n = int(want[1])
    assert int(got[1]) == n
    if kw["stuff"]:
        assert got[0].dtype == torch.uint8
        assert bytes(got[0].numpy()[:n]) == bytes(np.asarray(want[0])[:n])
        assert not got[0][n:].any()
    else:
        nw = (n + 31) // 32
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32)[:nw],
                                      np.asarray(want[0])[:nw])
