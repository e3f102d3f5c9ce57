"""K13: uint8 images already on a device -> one edge-padded stack, the
input of the transforms (K1, or K2 and K3).

    out[b * ph + y, x, c] = img_b[min(y, h_b - 1), min(x, w_b - 1), c]

for every image b of a group padded to ph x pw: np.pad(mode="edge") of
each image, with a 2-D image into three channels repeated to each, as
the host route's `blocks.copy_into` + `blocks.pad_in_place` stage them.
Images are read in place through their strides, so a decoder's planar
[3, H, W] frame permuted to [H, W, 3] is staged without a copy.

jpegtpu pads on the host before it uploads, so K13 has no TPU
counterpart. On a CUDA device `stage_images` launches csrc/stage.cu once
for every MAX_IMAGES images, with their pointers, sizes and strides in
the launch's parameters (no copy to the card, no host wait); on the CPU
it runs `stage_images_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

MAX_IMAGES = 64  # images one launch's parameter table holds (stage.cu)


class _Image(ctypes.Structure):
    """One entry of K13's table (stage.cu's Image)."""
    _fields_ = [("pixels", ctypes.c_void_p), ("sy", ctypes.c_longlong),
                ("sx", ctypes.c_longlong), ("sc", ctypes.c_longlong),
                ("h", ctypes.c_int), ("w", ctypes.c_int)]


def _check(images: list, shape: tuple) -> torch.device:
    """The images' one device, once each fits K13's contract."""
    ph, pw = shape[:2]
    if len(shape) not in (2, 3) or shape[2:] not in ((), (3,)) or pw % 8:
        raise ValueError(f"expected a stack shape (ph, pw) or (ph, pw, 3) "
                         f"with pw % 8 == 0, got {shape}")
    devs = {im.device for im in images}
    if len(devs) > 1:
        raise ValueError(f"images on several devices: {devs}")
    for im in images:
        h, w = im.shape[:2]
        if im.dtype != torch.uint8 or im.dim() - 2 > len(shape) - 2 or (
                im.dim() == 3 and im.shape[2] != 3):
            raise ValueError(f"cannot stage a {im.dtype} {tuple(im.shape)} "
                             f"image into a {shape} stack")
        if not (0 < h <= ph and 0 < w <= pw):
            raise ValueError(f"a {h} x {w} image does not fit {ph} x {pw}")
    return devs.pop() if devs else torch.device("cpu")


def stage_images(images: list, shape: tuple) -> torch.Tensor:
    """uint8 images [h, w] or [h, w, 3] (any strides), all on one device
    and within shape's ph x pw -> the stack [len(images) * ph, pw(, 3)]
    on that device."""
    dev = _check(images, shape)
    if dev.type != "cuda":
        return stage_images_plain(images, shape)
    ph, pw = shape[:2]
    out = torch.empty((len(images) * ph, *shape[1:]), dtype=torch.uint8,
                      device=dev)
    c = shape[2] if len(shape) == 3 else 1
    P, I = ctypes.c_void_p, ctypes.c_int
    for lo in range(0, len(images), MAX_IMAGES):
        part = images[lo:lo + MAX_IMAGES]
        table = (_Image * len(part))(*[
            _Image(im.data_ptr(), im.stride(0), im.stride(1),
                   im.stride(2) if im.dim() == 3 else 0, *im.shape[:2])
            for im in part])
        _build.launch("stage", "stage_images", (P, I, I, I, I, P), table,
                      len(part), ph, pw, c,
                      out.data_ptr() + lo * ph * pw * c, device=dev)
    return out


def stage_images_plain(images: list, shape: tuple) -> torch.Tensor:
    """Plain PyTorch K13 (any device): the same stack by index_select
    with clamped row and column indices."""
    ph, pw = shape[:2]
    out = torch.empty((len(images) * ph, *shape[1:]), dtype=torch.uint8,
                      device=images[0].device if images else "cpu")
    for b, im in enumerate(images):
        h, w = im.shape[:2]
        ys = torch.arange(ph, device=im.device).clamp_(max=h - 1)
        xs = torch.arange(pw, device=im.device).clamp_(max=w - 1)
        padded = im.index_select(0, ys).index_select(1, xs)
        if len(shape) == 3 and im.dim() == 2:
            padded = padded[..., None]  # repeated to each channel by copy_
        out[b * ph:(b + 1) * ph].copy_(padded)
    return out
