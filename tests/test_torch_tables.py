"""jpegtpu_torch tables, config and encoder state against jpegtpu's, and
the port's import boundary (no jax, nothing of jpegtpu)."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu import tables as jtables
from jpegtpu.entropy import device as jdevice
from jpegtpu.entropy import pallas_pack

import jpegtpu_torch
from jpegtpu_torch import tables

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("quality", [1, 50, 85, 100])
def test_quant_tables_match(quality):
    np.testing.assert_array_equal(
        jpegtpu_torch.EncodeConfig(quality=quality).luma_quant,
        jpegtpu.EncodeConfig(quality=quality).luma_quant,
    )


def test_bases_zigzag_and_luts_match():
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(tables.dct_basis(dt), jtables.dct_basis(dt))
        np.testing.assert_array_equal(
            tables.dct_basis_reference(dt), jtables.dct_basis_reference(dt)
        )
    np.testing.assert_array_equal(tables.ZIGZAG_ORDER, jtables.ZIGZAG_ORDER)
    ref = jtables.huffman_luts()
    for key, (codes, lens) in tables.huffman_luts().items():
        np.testing.assert_array_equal(codes, ref[key][0])
        np.testing.assert_array_equal(lens, ref[key][1])


def test_config_fields_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(jpegtpu_torch.EncodeConfig) == fields(jpegtpu.EncodeConfig)


@pytest.mark.parametrize("quality,bitexact", [(50, True), (85, False)])
def test_encoder_state_from_jpegtpu_arrays(quality, bitexact):
    """The state built from jpegtpu's own arrays (both table classes)
    equals the port's."""
    jcfg = jpegtpu.EncodeConfig(quality=quality, bitexact=bitexact)
    basis = (jtables.dct_basis_reference if bitexact else jtables.dct_basis)(
        np.float64
    )
    dc_codes, dc_lens, ac_codes, ac_lens = jdevice._host_luts()
    luts = {f"{cls}_{kind}": (codes[t], lens[t])
            for t, kind in enumerate(("lum", "chrom"))
            for cls, codes, lens in (("dc", dc_codes, dc_lens),
                                     ("ac", ac_codes, ac_lens))}
    got = tables.encoder_state_from_numpy(
        jcfg.luma_quant, jcfg.chroma_quant, basis, luts, device="cpu",
    )
    own = tables.encoder_state(
        jpegtpu_torch.EncodeConfig(quality=quality, bitexact=bitexact), "cpu"
    )
    for a, b in zip(got, own, strict=True):
        assert a.dtype == b.dtype and a.is_contiguous() and b.is_contiguous()
        assert torch.equal(a, b)
    for t, packed in enumerate((own.huff, own.huff_chroma)):
        np.testing.assert_array_equal(
            packed.numpy(),
            pallas_pack.pack_runtime_tables(
                dc_codes[t], dc_lens[t], ac_codes[t], ac_lens[t]
            ),
        )


@pytest.mark.parametrize("quality", [1, 50, 85, 100])
def test_chroma_quant_tables_match(quality):
    cfg = jpegtpu_torch.EncodeConfig(quality=quality, subsampling="420")
    jcfg = jpegtpu.EncodeConfig(quality=quality, subsampling="420")
    np.testing.assert_array_equal(cfg.chroma_quant, jcfg.chroma_quant)
    assert cfg.n_components == jcfg.n_components == 3
    assert jpegtpu_torch.EncodeConfig().n_components == 1


def test_chroma_spec_arrays_match():
    for name in ("STD_CHROMINANCE_QUANT", "STD_DC_CHROMINANCE_BITS",
                 "STD_DC_CHROMINANCE_VALUES", "STD_AC_CHROMINANCE_BITS",
                 "STD_AC_CHROMINANCE_VALUES"):
        np.testing.assert_array_equal(getattr(tables, name),
                                      getattr(jtables, name))
    assert sorted(tables.huffman_luts()) == sorted(jtables.huffman_luts())


def test_import_loads_no_jax_or_jpegtpu():
    code = (
        "import sys, jpegtpu_torch, jpegtpu_torch.pipeline\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'jpegtpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_sources_import_no_jax_or_jpegtpu():
    files = sorted((ROOT / "jpegtpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "jpegtpu"), (
                    f"{path.relative_to(ROOT)} imports {name}"
                )
