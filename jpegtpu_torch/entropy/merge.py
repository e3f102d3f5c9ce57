"""K5: the color scan's MCU interleave (counterpart of
`jpegtpu/entropy/pallas_pack.py: merge_mcu_natural_pallas`).

Per-block streams of the luma blocks (words [cap, ny], raster order over
the luma grid) and of the chroma blocks (words [cap, 2 * nmcu]: the Cb
blocks, then the Cr blocks, raster order over the MCU grid) -> one stream
per MCU: its fy x fx luma blocks in (dy, dx) order, then Cb, then Cr
(T.81 A.2.3), as words [E * cap, nmcu] (E = fy * fx + 2, words past the
MCU's bits zero) and bit counts [nmcu]. A block's bits count at most
cap * 32: a block past that overflowed and the encode retries at a
larger cap. Words travel as int32 bit patterns (see entropy.pack).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ops.blocks import sampling_factors, slots_per_mcu
from .pack import deposit, to_int32


def mcu_luma_blocks(nmch: int, nmcw: int, subsampling: str,
                    device=None) -> torch.Tensor:
    """[fy * fx, nmcu] raster index of each MCU's luma blocks in scan
    order: (fy * my + dy) * nbw_y + fx * mx + dx."""
    fy, fx = sampling_factors(subsampling)
    my = torch.arange(nmch, device=device)[:, None]
    mx = torch.arange(nmcw, device=device)[None, :]
    return torch.stack([
        ((fy * my + dy) * (fx * nmcw) + fx * mx + dx).reshape(-1)
        for dy in range(fy) for dx in range(fx)
    ])


def merge_mcu(words_y: torch.Tensor, bits_y: torch.Tensor,
              words_c: torch.Tensor, bits_c: torch.Tensor, nmch: int,
              nmcw: int, subsampling: str):
    """-> (words [E * cap, nmcu] int32, bits [nmcu] int32).

    On CUDA tensors this launches csrc/merge.cu; on CPU tensors it runs
    `merge_mcu_plain`."""
    fy, fx = sampling_factors(subsampling)
    cap = words_y.shape[0]
    nmcu = nmch * nmcw
    if (words_y.shape != (cap, fy * fx * nmcu) or bits_y.shape != (
            fy * fx * nmcu,) or words_c.shape != (cap, 2 * nmcu)
            or bits_c.shape != (2 * nmcu,)):
        raise ValueError(
            f"bad shapes for {nmch}x{nmcw} MCUs ({subsampling}): words_y "
            f"{tuple(words_y.shape)}, bits_y {tuple(bits_y.shape)}, words_c "
            f"{tuple(words_c.shape)}, bits_c {tuple(bits_c.shape)}")
    if words_y.device.type == "cpu":
        return merge_mcu_plain(words_y, bits_y, words_c, bits_c, nmch, nmcw,
                               subsampling)
    for t, name in ((words_y, "words_y"), (bits_y, "bits_y"),
                    (words_c, "words_c"), (bits_c, "bits_c")):
        _build.require_cuda(t, name, torch.int32)
    mcap = slots_per_mcu(subsampling) * cap
    out = torch.empty((mcap, nmcu), dtype=torch.int32, device=words_y.device)
    bits = torch.empty((nmcu,), dtype=torch.int32, device=words_y.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "merge", "merge_mcu", (P, P, P, P, I, I, I, I, I, P, P),
        words_y.data_ptr(), bits_y.data_ptr(), words_c.data_ptr(),
        bits_c.data_ptr(), cap, nmch, nmcw, fy, fx, out.data_ptr(),
        bits.data_ptr(), device=words_y.device,
    )
    return out, bits


def merge_mcu_plain(words_y: torch.Tensor, bits_y: torch.Tensor,
                    words_c: torch.Tensor, bits_c: torch.Tensor, nmch: int,
                    nmcw: int, subsampling: str):
    """Plain PyTorch K5 (any device), the same function as the kernel:
    gather each MCU's E streams, then deposit their words at the
    exclusive prefix sums of their bit counts (K4 stores the words past a
    block's bits as zero, so every word may be deposited)."""
    cap = words_y.shape[0]
    nmcu = nmch * nmcw
    dev = words_y.device
    idx = mcu_luma_blocks(nmch, nmcw, subsampling, dev)  # [fy * fx, nmcu]
    w = torch.cat([words_y[:, idx],
                   words_c.reshape(cap, 2, nmcu)], dim=1)  # [cap, E, nmcu]
    b = torch.cat([bits_y[idx], bits_c.reshape(2, nmcu)])  # [E, nmcu]
    b = b.to(torch.int64).clamp(max=cap * 32).T  # [nmcu, E]
    excl = torch.cumsum(b, dim=1) - b
    offs = excl[..., None] + 32 * torch.arange(cap, device=dev)
    vals = (w.to(torch.int64) & 0xFFFFFFFF).permute(2, 1, 0)  # [nmcu, E, cap]
    mcap = slots_per_mcu(subsampling) * cap
    out = deposit(vals.reshape(nmcu, -1),
                  torch.full_like(offs, 32).reshape(nmcu, -1),
                  offs.reshape(nmcu, -1), mcap)
    return to_int32(out.T.contiguous()), b.sum(dim=1).to(torch.int32)
