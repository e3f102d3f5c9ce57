"""The plain reference against the port's CPU path, the comparison on
known faults, and the seeded content."""
from __future__ import annotations

import numpy as np
import pytest

import jpegtpu_torch
from benchmark.content import make_pool, slot_sizes
from benchmark.reference import compare, encoder


def _photo(h, w, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx + yy) * (255.0 / (h + w)) + 20 * np.sin(xx / 3.1) * np.cos(
        yy / 2.7)
    rgb = np.stack([base * 0.9, base, base * 1.1], -1)
    return np.clip(rgb + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h, w, q", [
    (64, 96, 50), (77, 53, 50), (40, 72, 75), (131, 76, 50), (85, 128, 50),
    (128, 192, 90), (35, 61, 30)])
def test_reference_bytes_equal_the_port(h, w, q, monkeypatch):
    """Equal bytes wherever the levels are equal; a level may differ only
    by 1, where the quotient lies within 1e-6 of a half-step, so that the
    port's float32 DCT rounds it the other way."""
    image = _photo(h, w)
    spec = {"quality": q, "subsampling": "420"}
    ref = encoder.encode(image, spec)
    cfg = jpegtpu_torch.EncodeConfig(quality=q, subsampling="420")
    got = jpegtpu_torch.encode_color(image, cfg, device="cpu")
    port = jpegtpu_torch.color_coefficients(image, cfg, device="cpu")[0]
    want = ref.levels.reshape(-1, 64)
    diff = np.argwhere(np.asarray(port) != want)
    counts = compare.compare(got, ref)
    assert (counts.coefficients, counts.off_by_one, counts.off_by_more,
            counts.scan_faults, counts.header_mismatch) == (
        ref.levels.size, len(diff), 0, 0, 0)
    if not len(diff):
        assert got == ref.file
        return
    basis = encoder.dct_basis()
    nudged = []
    for f in (1 - 1e-6, 1 + 1e-6):
        monkeypatch.setattr(encoder, "dct_basis", lambda f=f: basis * f)
        nudged.append(encoder.mcu_levels(image, spec)[0].reshape(-1, 64))
    for b, k in diff:
        assert port[b, k] in (nudged[0][b, k], nudged[1][b, k])


def _ref(h=64, w=96):
    return encoder.encode(_photo(h, w), {"quality": 50, "subsampling": "420"})


def test_a_flipped_level_is_found_and_counted():
    ref = _ref()
    levels = ref.levels.copy()
    levels[5, 2, 7] += 1   # an AC level
    levels[9, 4, 0] -= 1   # a Cb DC level: the next Cb difference moves too
    levels[20, 0, 1] += 3
    other = encoder.encode_levels(levels, ref.slot_comp, 96, 64,
                                  {"quality": 50, "subsampling": "420"})
    counts = compare.compare(other.file, ref)
    assert (counts.off_by_one, counts.off_by_more, counts.scan_faults,
            counts.header_mismatch) == (2, 1, 0, 0)


@pytest.mark.parametrize("fault", ["byte", "truncate", "unstuffed", "eoi",
                                   "header", "marker"])
def test_faults_are_caught(fault):
    ref = _ref()
    data = bytearray(ref.file)
    mid = ref.header_len + (len(data) - ref.header_len) // 2
    if fault == "byte":
        data[mid] ^= 0x24
    elif fault == "truncate":
        del data[mid:-2]
    elif fault == "unstuffed":
        data[mid:mid + 2] = b"\xff\x12"
    elif fault == "eoi":
        data = data[:-2]
    elif fault == "header":
        data[30] ^= 1  # a quantization table entry
    else:
        data[mid:mid] = b"\xff\xd0"  # an RST marker the header never set
    c = compare.compare(bytes(data), ref)
    assert c.scan_faults or c.off_by_more or c.off_by_one or c.header_mismatch


SIZES = [{"height": 16, "width": 24, "share": 2},
         {"height": 13, "width": 7, "share": 1}]


def test_the_seeded_pool_repeats_and_differs():
    a = make_pool(SIZES, 7, 2**33 + 5, "cpu")
    b = make_pool(SIZES, 7, 2**33 + 5, "cpu")
    c = make_pool(SIZES, 7, 2**33 + 6, "cpu")
    assert all(x.dtype == np.uint8 and x.shape[2:] == (3,) for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(a, c))
    assert not np.array_equal(a[0], a[1])
    assert [x.shape for x in make_pool(SIZES[:1], 2, 1, "cpu")] == [
        (16, 24, 3)] * 2


def test_every_seed_gets_the_same_sizes_in_its_own_order():
    one, two = slot_sizes(SIZES, 7, 1), slot_sizes(SIZES, 7, 2)
    assert sorted(one) == sorted(two) == [(13, 7)] * 2 + [(16, 24)] * 5
    assert one == slot_sizes(SIZES, 7, 1) and one != two
