"""Wrap-aware RTP sequence-number / timestamp arithmetic.

Reference parity: pkg/sfu/utils/wraparound.go. As in the JAX package,
uint16/uint32 values live in int32 lanes; all arithmetic is modulo
2^16 / 2^32 with signed wrap-aware distances, and a separate int32 cycle
counter carries absolute totals. int32 tensor arithmetic in torch wraps
in two's complement, like XLA's.

All functions are elementwise over int32 tensors and batch over any
leading axes.
"""

from __future__ import annotations

import torch

MASK16 = 0xFFFF
HALF16 = 0x8000
_SIGN32 = -(1 << 31)


def diff16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed wrap-aware distance a-b for 16-bit sequence numbers, in
    [-32768, 32767]; positive means `a` is newer."""
    return ((a - b + HALF16) & MASK16) - HALF16


def diff32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed wrap-aware distance a-b for 32-bit values (RTP timestamps):
    int32 subtraction wraps to the signed distance directly."""
    return a - b


def add16(a, d):
    """(a + d) mod 2^16."""
    return (a + d) & MASK16


def sub16(a, d):
    """(a - d) mod 2^16."""
    return (a - d) & MASK16


def add32(a, d):
    """(a + d) mod 2^32 in int32 lanes."""
    return a + d


def sub32(a, d):
    """(a - d) mod 2^32 in int32 lanes."""
    return a - d


def is_newer16(a, b):
    return diff16(a, b) > 0


def is_newer32(a, b):
    return diff32(a, b) > 0


def update_highest16(highest, cycles, new):
    """Track the highest 16-bit SN and count wraps; returns
    (new_highest, new_cycles, is_new_highest)."""
    newer = diff16(new, highest) > 0
    wrapped = newer & (new < highest)
    return (
        torch.where(newer, new, highest),
        torch.where(wrapped, cycles + 1, cycles),
        newer,
    )


def _lt_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit a < b on int32 lanes: flipping the sign bit maps
    unsigned order onto signed order."""
    return (a ^ _SIGN32) < (b ^ _SIGN32)


def update_highest32(highest, cycles, new):
    """Track the highest 32-bit TS and count wraps (see update_highest16)."""
    newer = diff32(new, highest) > 0
    wrapped = newer & _lt_u32(new, highest)
    return (
        torch.where(newer, new, highest),
        torch.where(wrapped, cycles + 1, cycles),
        newer,
    )
