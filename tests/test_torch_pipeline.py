"""jpegtpu_torch end to end on the CPU (the kernels' plain versions)
against jpegtpu's encode of the same image and config.

One case holds the port against jpegtpu's device main path (the Pallas
chain, interpret mode); the rest use jpegtpu's host entropy coder, which
jpegtpu's own tests pin to the same bytes, to keep the compile time of
the suite down."""
import numpy as np
import pytest
import torch

import jpegtpu
from jpegtpu import tables as jtables
from jpegtpu.entropy import host as jhost
from jpegtpu.io import bmp as jbmp
from jpegtpu.io import jfif as jjfif

import jpegtpu_torch
from jpegtpu_torch import pipeline, tables
from jpegtpu_torch.entropy import host as entropy_host


def _gray(h, w, seed=0):
    """Photographic-complexity content (tests/test_tpu_parity.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 1.7 + yy * 0.9) % 256 + 25 * np.sin(xx / 2.9) * np.cos(yy / 3.3)
    return np.clip(base + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)


def _spiky(h, w, seed=1):
    """Flat background + isolated spikes: long zero runs, max amplitudes."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128, np.uint8)
    ys = rng.integers(0, h, 160)
    xs = rng.integers(0, w, 160)
    img[ys, xs] = np.where(rng.random(160) < 0.5, 0, 255).astype(np.uint8)
    return img


def _ties():
    """Uniform mid-tones: DC terms on .5 rounding boundaries."""
    return np.tile(np.arange(256, dtype=np.uint8), (64, 1))[:, :192]


def _noise(h, w, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def test_default_config_matches_jpegtpu_device_path():
    img = _gray(120, 168, seed=50)
    assert jpegtpu_torch.encode_grayscale(img, device="cpu") == (
        jpegtpu.encode_grayscale(img)
    )


CASES = {
    "q50": (lambda: _gray(120, 168, seed=50), {}),
    "q85": (lambda: _gray(120, 168, seed=85), {"quality": 85}),
    "zrl_spikes": (lambda: _spiky(128, 160), {}),
    "rounding_ties": (_ties, {}),
    "odd_dims": (lambda: _gray(61, 93, seed=3), {}),
    "odd_dims_pad_zeros": (lambda: _gray(61, 93, seed=4), {"pad_ones": False}),
    "int32": (lambda: _gray(112, 136, seed=21), {"dct_dtype": "int32"}),
    "int32_ortho_basis": (lambda: _gray(64, 80, seed=22),
                          {"dct_dtype": "int32", "bitexact": False}),
    "rgb_input": (lambda: np.stack([_gray(40, 56, s) for s in range(3)], -1),
                  {}),
    "q100_noise_ladder_int32": (lambda: _noise(64, 96),
                                {"quality": 100, "dct_dtype": "int32"}),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("entropy", ["device", "host"])
def test_bytes_match_jpegtpu(name, entropy):
    make, kw = CASES[name]
    img = make()
    want = jpegtpu.encode_grayscale(img, jpegtpu.EncodeConfig(entropy="host", **kw))
    cfg = jpegtpu_torch.EncodeConfig(entropy=entropy, **kw)
    assert jpegtpu_torch.encode_grayscale(img, cfg, device="cpu") == want


def test_golden_streams(golden):
    """The device entropy chain (plain versions) and the host coder, fed
    natural_c's levels, reproduce its entropy stream (0-padded)."""
    zz = golden["zigzag"].astype(np.int32)
    nbh, nbw = int(golden["pad_height"]) // 8, int(golden["pad_width"]) // 8
    cfg = jpegtpu_torch.EncodeConfig(pad_ones=False)
    huff = tables.encoder_state(cfg, "cpu").huff
    want = golden["stream"].tobytes()
    assert pipeline.encode_levels(
        torch.from_numpy(zz.T.copy()), huff, nbh, nbw, cfg) == want
    assert entropy_host.encode_scan(zz, pad_ones=False) == want


def test_int32_matches_numpy_oracle():
    """int32 mode against a numpy int64 recomputation of the levels
    (tests/test_tpu_parity.py's oracle), entropy-coded by jpegtpu."""
    img = _gray(112, 136, seed=21)
    cfg = jpegtpu_torch.EncodeConfig(dct_dtype="int32")
    t8 = np.round(jtables.dct_basis_reference(np.float64) * 2048).astype(np.int64)
    x = img.astype(np.int64) - 128
    nbh, nbw = img.shape[0] // 8, img.shape[1] // 8
    blks = x.reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    y1 = (np.einsum("ux,nxy->nuy", t8, blks) + 1024) >> 11
    f = (np.einsum("nuy,vy->nuv", y1, t8) + 1024) >> 11
    q = cfg.luma_quant.astype(np.int64)
    mag = (2 * np.abs(f) + q) // (2 * q)
    lv = np.where(f < 0, -mag, mag).reshape(-1, 64)[:, jtables.ZIGZAG_ORDER]
    segs = jhost.encode_scan(lv.astype(np.int32), pad_ones=cfg.pad_ones)
    oracle = jjfif.assemble(img.shape[1], img.shape[0],
                            jpegtpu.EncodeConfig(dct_dtype="int32"), segs)
    assert jpegtpu_torch.encode_grayscale(img, cfg, device="cpu") == oracle


def test_ladder_climbs_to_the_top_rung():
    img = _noise(64, 96, seed=6)
    cfg = jpegtpu_torch.EncodeConfig(quality=100, dct_dtype="int32")
    key = (8, 12, cfg, False)
    pipeline._cap_history.pop(key, None)
    assert pipeline.capacity_ladder(cfg, key) == (8, 16, 53)
    jpegtpu_torch.encode_grayscale(img, cfg, device="cpu")
    assert pipeline._cap_history[key][0] == 53
    # the remembered rung starts the next encode there
    assert pipeline.capacity_ladder(cfg, key) == (53,)


def test_coefficients_match_jpegtpu():
    img = _gray(61, 93, seed=8)
    for kw in ({}, {"dct_dtype": "int32"}):
        np.testing.assert_array_equal(
            jpegtpu_torch.grayscale_coefficients(
                img, jpegtpu_torch.EncodeConfig(**kw), device="cpu"),
            jpegtpu.grayscale_coefficients(img, jpegtpu.EncodeConfig(**kw)),
        )


def test_encode_file(tmp_path):
    rgb = np.stack([_gray(50, 70, s) for s in range(3)], -1)
    src = tmp_path / "in.bmp"
    jbmp.write(str(src), rgb)
    n = jpegtpu_torch.encode_file(str(src), str(tmp_path / "port.jpg"),
                                  device="cpu")
    m = jpegtpu.encode_file(str(src), str(tmp_path / "ref.jpg"),
                            jpegtpu.EncodeConfig(entropy="host"))
    assert n == m
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "ref.jpg").read_bytes()


def test_numpy_twins_of_the_native_runtime(monkeypatch, tmp_path):
    """Without g++ the stuffing and BMP pixel pass run in numpy: same bytes."""
    rgb = np.stack([_spiky(40, 48, s) for s in range(3)], -1)
    src = tmp_path / "in.bmp"
    jbmp.write(str(src), rgb)
    cfgs = [jpegtpu_torch.EncodeConfig(entropy=e) for e in ("device", "host")]
    want = [jpegtpu_torch.encode_grayscale(rgb, c, device="cpu") for c in cfgs]
    monkeypatch.setattr(jpegtpu_torch.native, "available", lambda: False)
    assert [jpegtpu_torch.encode_grayscale(rgb, c, device="cpu")
            for c in cfgs] == want
    jpegtpu_torch.encode_file(str(src), str(tmp_path / "out.jpg"),
                              device="cpu")
    assert (tmp_path / "out.jpg").read_bytes() == want[0]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(pipeline.torch.cuda, "is_available", lambda: False)
    img = _gray(16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.encode_grayscale(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        jpegtpu_torch.grayscale_coefficients(img)


@pytest.mark.parametrize("kw,item", [
    ({"subsampling": "420"}, "M2"),
    ({"restart_interval": 4}, "M3"),
    ({"optimize_huffman": True}, "M4"),
    ({"stuff": "device"}, "M10"),
])
def test_unported_configs_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        jpegtpu_torch.encode_grayscale(
            _gray(16, 16), jpegtpu_torch.EncodeConfig(**kw), device="cpu")


def test_rejects_bad_images():
    with pytest.raises(ValueError):
        jpegtpu_torch.encode_grayscale(np.zeros((8, 8), np.float32),
                                       device="cpu")
    with pytest.raises(ValueError):
        jpegtpu_torch.encode_grayscale(np.zeros((8, 8, 4), np.uint8),
                                       device="cpu")
