"""Sub-slot fusion for the staged entropy path (counterpart of
`jpegtpu/entropy/treepack.py`: _place_word and _fuse_subslots).

The K sub-slot codes of each element (entropy.device.symbolize_elements64:
DC prefix, ZRL pairs, the symbol, EOB suffix) merge arithmetically into
one MSB-aligned element of c_out 32-bit words, the input of K7
(entropy.pack.pack_blocks). Plain PyTorch, elementwise, as jpegtpu runs
it in XLA outside any kernel. Values are int64 holding uint32 codes; the
fused words come out as int32 bit patterns (entropy.pack.to_int32).
"""
from __future__ import annotations

import torch

from .pack import to_int32

_MASK32 = 0xFFFFFFFF


def _place_word(v: torch.Tensor, ln: torch.Tensor, end: torch.Tensor,
                j: int) -> torch.Tensor:
    """Contribution of a right-aligned `ln`-bit value ending at bit `end`
    (MSB-relative) to word j of its element frame, as int64 < 2^32."""
    sh = 32 * (j + 1) - end
    left = (v << sh.clamp(0, 31)) & _MASK32
    right = v >> (-sh).clamp(0, 31)
    out = torch.where(sh >= 0, left, right)
    live = (ln > 0) & (sh < 32) & (sh > -ln)
    return torch.where(live, out, 0)


def _fuse_subslots(values: torch.Tensor, lengths: torch.Tensor,
                   c_out: int = 2):
    """Merge the K sub-slots of every element into one c_out-word element.
    The sub-slots' bits must fit c_out words (bits past them are dropped).

    values/lengths: [nb, E, K] (values int64 holding uint32 codes).
    Returns (words_t [c_out, E, nb] int32 bit patterns, bits [E, nb]
    int32)."""
    values = values.to(torch.int64)
    lengths = lengths.to(torch.int64)
    off = torch.zeros_like(lengths[..., 0])
    words = [torch.zeros_like(off) for _ in range(c_out)]
    for i in range(values.shape[-1]):
        v, ln = values[..., i], lengths[..., i]
        end = off + ln
        for j in range(c_out):
            words[j] = words[j] | _place_word(v, ln, end, j)
        off = end
    words_t = torch.stack([w.T for w in words])  # [c_out, E, nb]
    return to_int32(words_t).contiguous(), off.T.to(torch.int32).contiguous()
