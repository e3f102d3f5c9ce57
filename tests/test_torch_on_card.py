"""Images that are already on the encode's device (torch tensors) on the
CPU: K13's plain twin (ops.stage) against the host route's edge pad, the
four entry points' bytes with tensor input against their numpy input's
(the on-card route, a mixed list, the fallbacks to the single-image
encoders), one file against jpegtpu's, and the route's span and counter.
The CUDA kernel against its twin is in tests/test_torch_gpu.py."""
import dataclasses

import numpy as np
import pytest
import torch

import jpegtpu_torch
from jpegtpu_torch import EncodeConfig, batch, tracing
from jpegtpu_torch.ops import stage
from jpegtpu_torch.ops.blocks import copy_into, pad_in_place

from torch_jax_memory import release_jax_memory  # noqa: F401 (autouse)

CPU = dict(device="cpu")


def _images(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]


def _as_tensor(image: np.ndarray, layout: str) -> torch.Tensor:
    """The image as a CPU tensor of the given memory layout, same values."""
    if layout == "contiguous":
        return torch.from_numpy(image.copy())
    if layout == "planar":  # a decoder's [C, H, W] (or [W, H]) permuted
        if image.ndim == 3:
            planes = np.ascontiguousarray(np.moveaxis(image, -1, 0))
            return torch.from_numpy(planes).permute(1, 2, 0)
        return torch.from_numpy(np.ascontiguousarray(image.T)).T
    # "sliced": a crop of a larger tensor, every other column of it
    h, w = image.shape[:2]
    big = torch.zeros((h + 3, 2 * w + 5, *image.shape[2:]), dtype=torch.uint8)
    big[2:2 + h, 1:1 + 2 * w:2] = torch.from_numpy(image)
    return big[2:2 + h, 1:1 + 2 * w:2]


def _ring_stack(images, shape):
    """The host route's stack: copy_into + pad_in_place, as batch's ring."""
    slots = np.zeros((len(images), *shape), np.uint8)
    copy_into(slots, images)
    for slot, image in zip(slots, images):
        pad_in_place(slot, *image.shape[:2])
    return slots.reshape(-1, *shape[1:])


@pytest.mark.parametrize("layout", ["contiguous", "planar", "sliced"])
@pytest.mark.parametrize("shapes,stack", [
    ([(13, 21), (16, 24), (1, 1)], (16, 24)),               # gray
    ([(13, 21, 3), (9, 24, 3), (16, 17, 3)], (16, 24, 3)),  # RGB
    ([(13, 21), (16, 24, 3), (5, 3)], (16, 24, 3)),         # gray into RGB
    ([(31, 45, 3)], (32, 48, 3)),                           # one odd image
])
def test_the_twin_is_the_host_routes_edge_pad(shapes, stack, layout):
    images = _images(shapes, len(shapes) + len(stack))
    want = _ring_stack(images, stack)
    got = stage.stage_images([_as_tensor(im, layout) for im in images],
                             stack)
    assert got.shape == want.shape and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    for b, image in enumerate(images):  # np.pad's edge mode, image by image
        if len(stack) == 3 and image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        pad = [(0, stack[0] - image.shape[0]), (0, stack[1] - image.shape[1])]
        np.testing.assert_array_equal(
            got.numpy()[b * stack[0]:(b + 1) * stack[0]],
            np.pad(image, pad + [(0, 0)] * (image.ndim - 2), mode="edge"))


@pytest.mark.parametrize("image,stack", [
    (torch.zeros((17, 8), dtype=torch.uint8), (16, 8)),       # too tall
    (torch.zeros((8, 8), dtype=torch.int16), (8, 8)),          # not uint8
    (torch.zeros((8, 8, 3), dtype=torch.uint8), (8, 8)),       # RGB into 1
    (torch.zeros((0, 8), dtype=torch.uint8), (8, 8)),          # empty
    (torch.zeros((8, 8), dtype=torch.uint8), (8, 12)),         # pw % 8
])
def test_the_twin_refuses_what_k13_refuses(image, stack):
    with pytest.raises(ValueError):
        stage.stage_images([image], stack)


# Sizes that are not whole MCUs, 2-D and RGB of one padded shape, two
# groups with two images each.
MIXED = [(37, 53, 3), (20, 30, 3), (37, 53), (31, 47, 3), (20, 30, 3),
         (9, 17, 3)]
CASES = {
    "mixed": (MIXED, {}),
    "mixed_int32_q90": (MIXED, {"dct_dtype": "int32", "quality": 90}),
    "two_pass_shared": ([(32, 48, 3), (31, 47), (30, 40, 3)],
                        {"optimize_huffman": True}),
    "two_pass_per_image": ([(32, 48, 3), (31, 47), (30, 40, 3)],
                           {"optimize_huffman": True, "per_image": True}),
    "restart": ([(37, 53, 3), (20, 30, 3)], {"restart_interval": 2}),
}
ENTRIES = ["encode_color_batch", "encode_grayscale_batch", "encode_color",
           "encode_grayscale"]


def _encode(entry, images, cfg):
    if entry.endswith("_batch"):
        return getattr(jpegtpu_torch, entry)(images, cfg, **CPU)
    return [getattr(jpegtpu_torch, entry)(im, cfg, **CPU) for im in images]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_tensor_input_gives_the_numpy_inputs_bytes(monkeypatch, entry, case):
    """Planar-permuted tensors, and a list that mixes tensors of three
    layouts with numpy arrays, give the files of the numpy images. The
    per-image 2-pass case sends every group to the single-image encoders
    (their rule says the group cannot share tables)."""
    shapes, kw = CASES[case]
    kw = dict(kw)
    if kw.pop("per_image", False):
        monkeypatch.setattr(batch, "color_raw_ok", lambda *a: False)
        monkeypatch.setattr(batch, "shares_gray_tables", lambda *a: False)
    color = entry in ("encode_color_batch", "encode_color")
    cfg = EncodeConfig(subsampling="420" if color else "gray", **kw)
    images = _images(shapes, 5)
    want = _encode(entry, images, cfg)
    planar = [_as_tensor(im, "planar") for im in images]
    assert _encode(entry, planar, cfg) == want
    if entry.endswith("_batch"):
        layouts = ["contiguous", "sliced", None]
        mixed = [im if layouts[i % 3] is None else
                 _as_tensor(im, layouts[i % 3]) for i, im in enumerate(images)]
        assert _encode(entry, mixed, cfg) == want


def test_a_planar_frame_gives_jpegtpus_file():
    """A decoder-style planar frame, permuted, through the batch's on-card
    route, against jpegtpu's encode of the same pixels (its host entropy
    coder: the same bytes as its device chain)."""
    import jpegtpu
    (image,) = _images([(45, 61, 3)], 11)
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(image, -1, 0)))
    cfg = EncodeConfig(subsampling="420", quality=75)
    (got,) = jpegtpu_torch.encode_color_batch([planes.permute(1, 2, 0)], cfg,
                                              **CPU)
    jcfg = jpegtpu.EncodeConfig(**{**dataclasses.asdict(cfg),
                                   "entropy": "host"})
    assert got == jpegtpu.encode_color(image, jcfg)


@pytest.mark.parametrize("entry", ["encode_color_batch", "encode_color"])
def test_the_on_card_route_records_its_span_and_counter(entry):
    images = [_as_tensor(im, "planar")
              for im in _images([(37, 53, 3), (20, 30, 3), (37, 53, 3)], 3)]
    cfg = EncodeConfig(subsampling="420")
    with tracing.recording():
        _encode(entry, images, cfg)
    t = tracing.totals()
    assert t["counts"]["io.on_card_images"] == 3
    assert t["spans"]["io.on_card"]["calls"] == (2 if entry.endswith("_batch")
                                                 else 3)
    assert not {"io.pad", "io.stack", "io.upload"} & set(t["spans"])
    assert "io.chunks" not in t["counts"]


def test_the_numpy_route_is_unchanged_and_a_cpu_tensor_goes_to_it():
    """Numpy input stages through the ring as before; a CPU tensor for a
    card encode is read as numpy (the ring), one on the CPU encode's
    device takes the on-card route."""
    images = _images([(37, 53, 3), (20, 30, 3)], 4)
    with tracing.recording():
        jpegtpu_torch.encode_color_batch(images, EncodeConfig(subsampling="420"),
                                         **CPU)
    t = tracing.totals()
    assert "io.on_card" not in t["spans"] and {"io.stack", "io.pad",
                                               "io.upload"} <= set(t["spans"])
    tensor = torch.from_numpy(images[0])
    source = jpegtpu_torch.io.transfer.source_image
    assert isinstance(source(tensor, torch.device("cuda", 0)), np.ndarray)
    assert source(tensor, torch.device("cpu")) is tensor
    assert source(images[0], torch.device("cpu")) is images[0]


def test_serving_and_sharding_still_take_numpy_alone():
    from jpegtpu_torch import color_pipeline
    from jpegtpu_torch.parallel import sharding
    tensor = torch.zeros((16, 16, 3), dtype=torch.uint8)
    color = EncodeConfig(subsampling="420")
    with pytest.raises(ValueError, match="numpy"):
        jpegtpu_torch.encode_stream_list([tensor], color, color=True, **CPU)
    with pytest.raises(ValueError, match="numpy"):
        sharding.encode_grayscale_sharded(tensor, mesh=["cpu"])
    with pytest.raises(ValueError, match="numpy"):
        color_pipeline.encode_color_sharded(tensor, color, mesh=["cpu"])
