"""K1: pixels -> quantized zigzag levels (counterpart of
`jpegtpu/ops/pallas_transform.py: transform_plane_raw`).

Per 8x8 block: level shift by -128, separable DCT F = T X T^T, division by
the quantization table with round half away from zero, zigzag order.
Float mode keeps the TPU kernel's arithmetic: each DCT pass is a
sequential chain of fused multiply-adds in float32, `s = f / q` is a true
IEEE division, and the level is `(int)(s +/- 0.5)` after a float32 add.
Int32 mode uses the 11-bit fixed-point basis:
  y1 = (T_i X + 2^10) >> 11,  f = (y1 T_i^T + 2^10) >> 11,
  |level| = (2|f| + q) // (2q), sign from f,
exact on every backend.

Levels come out coefficient-major, `[64, nb]` int32 with blocks in raster
order, the layout K4 reads with coalesced loads; `.T` is jpegtpu's
`[nb, 64]` contract. The TPU kernel's [G, 64, 8, 128] tiling, its
block-diagonal bases and its 64x1024 padding exist only for the TPU.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, tables
from .color import level_shift

_ZIGZAG = torch.from_numpy(tables.ZIGZAG_ORDER.astype("int64"))
_HALF = 1 << (tables.INT_FRAC - 1)


def transform(plane: torch.Tensor, state: tables.EncoderState,
              int_mode: bool) -> torch.Tensor:
    """uint8 plane [PH, PW] (multiples of 8) -> levels [64, nb] int32.

    On a CUDA tensor this launches csrc/transform.cu; on a CPU tensor it
    runs `transform_plain`."""
    ph, pw = plane.shape
    if ph % 8 or pw % 8:
        raise ValueError(f"plane dims must be multiples of 8, got {ph}x{pw}")
    if plane.device.type == "cpu":
        return transform_plain(plane, state, int_mode)
    _build.require_cuda(plane, "plane", torch.uint8)
    if plane.data_ptr() % 8:  # the kernel loads 8 pixels at a time
        plane = plane.clone()
    _build.require_cuda(state.quant, "state.quant", torch.int32)
    _build.require_cuda(state.basis, "state.basis", torch.float32)
    _build.require_cuda(state.basis_int, "state.basis_int", torch.int32)
    out = torch.empty((64, (ph // 8) * (pw // 8)), dtype=torch.int32,
                      device=plane.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "transform", "transform", (P, I, I, P, P, P, I, P),
        plane.data_ptr(), ph, pw, state.quant.data_ptr(),
        state.basis.data_ptr(), state.basis_int.data_ptr(), int(int_mode),
        out.data_ptr(), device=plane.device,
    )
    return out


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """[PH, PW] -> [nb, 8, 8] level-shifted int64 samples, raster order."""
    ph, pw = plane.shape
    x = level_shift(plane).to(torch.int64)
    return x.reshape(ph // 8, 8, pw // 8, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)


def transform_plain(plane: torch.Tensor, state: tables.EncoderState,
                    int_mode: bool) -> torch.Tensor:
    """Plain PyTorch K1 (any device), the same function as the kernel.

    The float mode's fused multiply-add chain is computed in float64: a
    product of two float32 values is exact there, so each step rounds
    once to float32, as a float32 FMA does (up to a double rounding
    that has not been observed to move a level)."""
    x = _blocks(plane)
    q = state.quant.to(plane.device)
    if int_mode:
        # broadcast sums, not matmuls: CUDA has no int64 matmul
        t = state.basis_int.to(device=plane.device, dtype=torch.int64)
        y1 = ((t[None, :, :, None] * x[:, None, :, :]).sum(2) + _HALF
              ) >> tables.INT_FRAC  # y1[u, x] = sum_k T[u, k] X[k, x]
        f = ((y1[:, :, None, :] * t[None, None, :, :]).sum(3) + _HALF
             ) >> tables.INT_FRAC  # f[u, v] = sum_k y1[u, k] T[v, k]
        qq = q.to(torch.int64).reshape(8, 8)
        mag = (2 * f.abs() + qq) // (2 * qq)
        lv = torch.where(f < 0, -mag, mag)
    else:
        t = state.basis.to(plane.device).to(torch.float64)
        xf = x.to(torch.float64)
        y = torch.zeros(x.shape, dtype=torch.float32, device=plane.device)
        for k in range(8):  # y[u, x] = sum_k T[u, k] X[k, x], in order
            y = (y.to(torch.float64) + t[None, :, k, None] * xf[:, None, k, :]
                 ).to(torch.float32)
        z = torch.zeros(x.shape, dtype=torch.float32, device=plane.device)
        y64 = y.to(torch.float64)
        for k in range(8):  # z[u, v] = sum_k Y[u, k] T[v, k], in order
            z = (z.to(torch.float64) + y64[:, :, None, k] * t[None, None, :, k]
                 ).to(torch.float32)
        s = z / q.to(torch.float32).reshape(8, 8)
        lv = s + torch.where(s >= 0, 0.5, -0.5).to(torch.float32)
    lv = lv.reshape(-1, 64)[:, _ZIGZAG.to(plane.device)]
    return lv.to(torch.int32).T.contiguous()
