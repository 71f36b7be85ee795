"""Seeded operands of the port's CUDA kernels, for the card-side tests
(tests/test_torch_kernels*.py). Imports neither jax nor the JAX package,
so those tests also run on a machine with a card and no jax."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.ops import selector


@pytest.fixture
def card():
    """The card, for tests marked `cuda`; they skip where there is none
    (a CUDA kernel has no CPU interpret mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")


def decide_args(dims, seed, dev):
    """`decide_rooms` operands at dims (R, T, K, S)."""
    R, T, K, S = dims
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(-1, 4, (R, T, S))),
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(0, 4, (R, T, S))))
    pkt = (i32(rng.integers(0, 3, (R, T, K))), i32(rng.integers(0, 4, (R, T, K))),
           b(0.3, (R, T, K)), b(0.5, (R, T, K)), b(0.4, (R, T, K)),
           b(0.9, (R, T, K)), i32(rng.integers(40, 1300, (R, T, K))))
    return (state, b(0.5, (R, T)), b(0.6, (R, T)), b(0.7, (R, T, S)), *pkt)


def alloc_args(dims, seed, dev):
    """`allocate_budget_rooms` operands at dims (R, T, K, S)."""
    R, T, K, S = dims
    rng = np.random.default_rng(seed)
    bit = rng.random((R, T, 4, 4)) * 2e6 * (rng.random((R, T, 4, 4)) > 0.3)
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(dev)  # noqa: E731
    return (t(bit, np.float32), t(rng.integers(-1, 4, (R, S, T)), np.int32),
            t(rng.integers(-1, 4, (R, S, T)), np.int32),
            torch.from_numpy(rng.random((R, S, T)) < 0.2).to(dev),
            t(rng.random((R, S)) * 8e6, np.float32))


def page_args(page, seed, dev, n_live: int, mix_n: int = 0, p_valid: float = 0.85):
    """Seeded pooled operands of the live-page kernel: decide operands
    (each packet valid with probability p_valid), mix operands (pcm
    [P, TP, mix_n], levels with ties at the top) and live_rows naming
    n_live distinct pages, padded with a duplicate to a power of two."""
    P, TP, K, SP = page
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(-1, 4, (P, TP, SP))),
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(0, 4, (P, TP, SP))))
    pk = lambda lo, hi: i32(rng.integers(lo, hi, (P, TP, K)))  # noqa: E731
    inp = plane.TickInputs(**dict.fromkeys(plane.TickInputs._fields))._replace(
        layer=pk(-1, 4), temporal=pk(0, 4), keyframe=b(0.3, (P, TP, K)),
        layer_sync=b(0.5, (P, TP, K)), end_frame=b(0.4, (P, TP, K)),
        valid=b(p_valid, (P, TP, K)), size=pk(40, 1300), sn=pk(0, 65536),
        ts=i32(rng.integers(-2**31, 2**31, (P, TP, K), dtype=np.int64)),
        arrival_rtp=pk(0, 1 << 30), begin_pic=b(0.4, (P, TP, K)))
    decide = (state, b(0.4, (P, TP)), b(0.6, (P, TP)), b(0.7, (P, TP, SP)), inp)
    level = rng.random((P, TP)).astype(np.float32)
    level[:, : min(3, TP)] = level[:, -1:]                   # ties at the top
    mix = (torch.from_numpy(rng.standard_normal((P, TP, mix_n)).astype(np.float32) * 0.3).to(dev),
           torch.from_numpy(level).to(dev), b(0.7, (P, TP)),
           i32(rng.integers(-1, TP, (P, SP))),
           torch.from_numpy(rng.uniform(0.5, 1.5, (P, TP)).astype(np.float32)).to(dev))
    live = rng.choice(P, n_live, replace=False)
    nl = 1 << max(n_live - 1, 0).bit_length()
    rows = np.concatenate([live, np.repeat(live[:1], nl - n_live)])
    return decide, mix, i32(rows)


def assert_trees_equal(a, b):
    for x, y in zip(plane.tree_leaves(a), plane.tree_leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)
