"""Small-axis prefix sums.

The JAX package writes `cumsum_small` as a triangular-matrix contraction
because `jnp.cumsum` lowers badly on the TPU. On the GPU and the CPU
`torch.cumsum` is the natural form. Integer inputs give identical
results; float prefixes are folded sequentially, which may differ from
the reference's contraction by a few ulps (the reference documents the
same bound against a sequential cumsum).
"""

from __future__ import annotations

import torch


def cumsum_small(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive prefix sum along a small axis, in the input's dtype."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)
