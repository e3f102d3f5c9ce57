"""K1, K2, K3: pixels -> quantized zigzag levels (counterpart of
`jpegtpu/ops/pallas_transform.py`: transform_plane_raw, and the fused
color front ends transform_rgb_y_raw and transform_rgb_chroma_raw).

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

K2 converts interleaved RGB [PH, PW, 3] to luma and K3 to subsampled Cb
and Cr (ops.color's arithmetic) inside the same kernel; their plain
versions convert first and then run K1's plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, tables
from . import color
from .blocks import sampling_factors

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
    # rows are read in 8-byte pieces (16-byte ones where a row's address
    # allows it)
    if plane.data_ptr() % 8:
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


def _check_rgb(rgb: torch.Tensor, mh: int, mw: int) -> None:
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.shape[0] % mh or (
        rgb.shape[1] % mw
    ):
        raise ValueError(f"expected RGB [PH, PW, 3] with PH % {mh} == 0 and "
                         f"PW % {mw} == 0, got {tuple(rgb.shape)}")


def _kernel_inputs(rgb: torch.Tensor, quant: torch.Tensor,
                   state: tables.EncoderState) -> torch.Tensor:
    """Check K2's or K3's inputs; returns rgb 8-byte aligned."""
    _build.require_cuda(rgb, "rgb", torch.uint8)
    _build.require_cuda(quant, "quant", torch.int32)
    _build.require_cuda(state.basis, "state.basis", torch.float32)
    _build.require_cuda(state.basis_int, "state.basis_int", torch.int32)
    # the kernels read rows in 8-byte pieces, 16-byte ones where a row's
    # address allows it
    return rgb.clone() if rgb.data_ptr() % 8 else rgb


def transform_rgb_y(rgb: torch.Tensor, state: tables.EncoderState,
                    int_mode: bool, ref_luma: bool = False) -> torch.Tensor:
    """K2: interleaved RGB [PH, PW, 3] uint8 (multiples of 8) -> luma
    levels [64, nb] int32 with the luminance table. Luma is the JFIF
    16-bit weights, or with ref_luma the reference's (77R+150G+29B)>>8
    (the TPU kernel's kind="y_ref").

    On a CUDA tensor this launches csrc/transform.cu (transform_rgb_y); on
    a CPU tensor it runs `transform_rgb_y_plain`."""
    _check_rgb(rgb, 8, 8)
    if rgb.device.type == "cpu":
        return transform_rgb_y_plain(rgb, state, int_mode, ref_luma)
    rgb = _kernel_inputs(rgb, state.quant, state)
    ph, pw = rgb.shape[:2]
    out = torch.empty((64, (ph // 8) * (pw // 8)), dtype=torch.int32,
                      device=rgb.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "transform", "transform_rgb_y", (P, I, I, P, P, P, I, I, P),
        rgb.data_ptr(), ph, pw, state.quant.data_ptr(),
        state.basis.data_ptr(), state.basis_int.data_ptr(), int(int_mode),
        int(ref_luma), out.data_ptr(), device=rgb.device,
    )
    return out


def transform_rgb_y_plain(rgb: torch.Tensor, state: tables.EncoderState,
                          int_mode: bool, ref_luma: bool = False
                          ) -> torch.Tensor:
    """Plain PyTorch K2 (any device): convert, then K1's plain version."""
    y = (color.rgb_to_y_reference(rgb) if ref_luma
         else color.rgb_to_ycbcr(rgb)[..., 0])
    return transform_plain(y, state, int_mode)


def transform_rgb_chroma(rgb: torch.Tensor, state: tables.EncoderState,
                         int_mode: bool, subsampling: str) -> torch.Tensor:
    """K3: interleaved RGB [PH, PW, 3] uint8 (multiples of the MCU) ->
    chroma levels [64, 2 * nc] int32 with the chrominance table: the nc
    Cb blocks, then the nc Cr blocks, each in raster order over the
    subsampled (MCU) grid.

    On a CUDA tensor this launches csrc/transform.cu
    (transform_rgb_chroma); on a CPU tensor it runs
    `transform_rgb_chroma_plain`."""
    fy, fx = sampling_factors(subsampling)
    _check_rgb(rgb, 8 * fy, 8 * fx)
    if rgb.device.type == "cpu":
        return transform_rgb_chroma_plain(rgb, state, int_mode, subsampling)
    rgb = _kernel_inputs(rgb, state.chroma_quant, state)
    ph, pw = rgb.shape[:2]
    nc = (ph // (8 * fy)) * (pw // (8 * fx))
    out = torch.empty((64, 2 * nc), dtype=torch.int32, device=rgb.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "transform", "transform_rgb_chroma", (P, I, I, I, I, P, P, P, I, P),
        rgb.data_ptr(), ph, pw, fy, fx, state.chroma_quant.data_ptr(),
        state.basis.data_ptr(), state.basis_int.data_ptr(), int(int_mode),
        out.data_ptr(), device=rgb.device,
    )
    return out


def transform_rgb_chroma_plain(rgb: torch.Tensor, state: tables.EncoderState,
                               int_mode: bool, subsampling: str
                               ) -> torch.Tensor:
    """Plain PyTorch K3 (any device): convert, subsample, then K1's plain
    version with the chrominance table."""
    fy, fx = sampling_factors(subsampling)
    ycc = color.rgb_to_ycbcr(rgb)
    chroma = state._replace(quant=state.chroma_quant)
    return torch.cat([
        transform_plain(color.subsample(ycc[..., c], fy, fx), chroma, int_mode)
        for c in (1, 2)
    ], dim=1)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """[PH, PW] -> [nb, 8, 8] level-shifted int64 samples, raster order."""
    ph, pw = plane.shape
    x = color.level_shift(plane).to(torch.int64)
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
