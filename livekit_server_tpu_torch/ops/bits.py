"""Bit-packed (track, packet, subscriber) mask helpers.

The egress masks travel as ⌈S/32⌉ int32 words per (track, packet): bit
s%32 of word s//32 is subscriber s, exactly as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def mask_words(num_subscribers: int) -> int:
    """Words on the bit-packed mask minor axis: ⌈S/32⌉."""
    return (num_subscribers + 31) // 32


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[..., S] bool → [..., W] int32 bit words (bit s%32 of word s//32).

    Words are formed in int64 and folded to the int32 bit pattern
    explicitly, so bit 31 lands as the sign bit on every backend."""
    S = mask.shape[-1]
    W = mask_words(S)
    pad = W * 32 - S
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    w = mask.reshape(*mask.shape[:-1], W, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
        32, dtype=torch.int64, device=mask.device
    )
    packed = (w * weights).sum(-1)
    packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)
    return packed.to(torch.int32)


def unpack_bits(words, num_subscribers: int) -> np.ndarray:
    """Host-side inverse of `pack_bits`: [..., W] int32 → [..., S] bool."""
    w = np.asarray(words).astype(np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*w.shape[:-1], -1)[..., :num_subscribers].astype(bool)
