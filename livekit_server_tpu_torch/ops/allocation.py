"""Batched forwarder bandwidth-allocation algebra, and the phase-2
allocation of the dense tick.

Reference parity: pkg/sfu/forwarder.go allocation family and
streamallocator.go allocateAllTracks, as formulated by the JAX package's
ops/allocation.py. Per track a [4, 4] (spatial × temporal) bitrate
matrix; layer encoding is flat l = spatial*MAX_TEMPORAL + temporal,
-1 = paused.

`allocate_budget_rooms` is the hand-written CUDA kernel
csrc/budget_rooms.cu on CUDA tensors; on CPU tensors it runs
`allocate_budget_rooms_plain`, the reference's two-pass greedy written
out over (room, subscriber) with the same float32 budget arithmetic in
the same track order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from livekit_server_tpu_torch.ops import cuda

MAX_SPATIAL = 4
MAX_TEMPORAL = 4
NUM_LAYERS = MAX_SPATIAL * MAX_TEMPORAL  # 16 flat layers


def spatial_of(flat: torch.Tensor) -> torch.Tensor:
    return torch.where(flat < 0, -1, torch.div(flat, MAX_TEMPORAL, rounding_mode="floor"))


def temporal_of(flat: torch.Tensor) -> torch.Tensor:
    return torch.where(flat < 0, -1, torch.remainder(flat, MAX_TEMPORAL))


def allowed_mask(bitrates, max_spatial, max_temporal):
    """[..., 4, 4] bool — layers that exist (bitrate > 0) and satisfy the
    subscriber's max-layer settings. max_spatial/max_temporal: [...]."""
    dev = bitrates.device
    s_idx = torch.arange(MAX_SPATIAL, dtype=torch.int32, device=dev)[:, None]
    t_idx = torch.arange(MAX_TEMPORAL, dtype=torch.int32, device=dev)[None, :]
    cap = (s_idx <= max_spatial[..., None, None]) & (t_idx <= max_temporal[..., None, None])
    return (bitrates > 0) & cap


def _flat_idx(device):
    return torch.arange(NUM_LAYERS, dtype=torch.int32, device=device)


def optimal_layer(bitrates, max_spatial, max_temporal):
    """Highest allowed flat layer per element, -1 where none (AllocateOptimal)."""
    mask = allowed_mask(bitrates, max_spatial, max_temporal).flatten(-2)
    return torch.where(mask, _flat_idx(mask.device), -1).amax(-1)


def lowest_layer(bitrates, max_spatial, max_temporal):
    """Lowest allowed flat layer per element, -1 where none."""
    mask = allowed_mask(bitrates, max_spatial, max_temporal).flatten(-2)
    best = torch.where(mask, _flat_idx(mask.device), NUM_LAYERS).amin(-1)
    return torch.where(best >= NUM_LAYERS, -1, best)


def _pick(costs, flat):
    """costs[..., flat] with 0 for flat = -1, as a one-hot select that
    broadcasts costs [..., 16] against flat [...] (exact: one value
    plus zeros)."""
    hit = flat[..., None] == _flat_idx(costs.device)
    return torch.where(hit, costs, 0.0).sum(-1)


def layer_bitrate(bitrates, flat):
    """Bitrate of a flat layer index; 0 for -1. bitrates [..., 4, 4]."""
    return _pick(bitrates.flatten(-2), flat)


def allocate_budget(bitrates, max_spatial, max_temporal, muted, budget):
    """Cooperative constrained allocation across one subscriber's tracks
    (streamallocator.go allocateAllTracks): pass 1 gives every track its
    minimal layer in track order while the budget lasts, pass 2 upgrades
    each granted track in order to the best layer that fits.

    Args (any leading axes, shared by all arguments):
      bitrates [..., T, 4, 4] float32; max_spatial/max_temporal [..., T]
      int32; muted [..., T] bool; budget [...] float32.
    Returns (target_flat [..., T] int32, used [...] float32,
    deficient [..., T] bool)."""
    lo = lowest_layer(bitrates, max_spatial, max_temporal)
    hi = optimal_layer(bitrates, max_spatial, max_temporal)
    lo = torch.where(muted, -1, lo)
    hi = torch.where(muted, -1, hi)
    lo_cost = layer_bitrate(bitrates, lo)
    budget = budget.to(torch.float32)
    T = bitrates.shape[-3]

    bl = budget
    got = []
    for t in range(T):                                           # pass 1
        take = (lo[..., t] >= 0) & (lo_cost[..., t] <= bl)
        bl = torch.where(take, bl - lo_cost[..., t], bl)
        got.append(take)

    b_flat = bitrates.flatten(-2).to(torch.float32)
    mask_flat = allowed_mask(bitrates, max_spatial, max_temporal).flatten(-2)
    idx = _flat_idx(bitrates.device)
    target = []
    for t in range(T):                                           # pass 2
        valid = got[t]
        costs = b_flat[..., t, :]
        avail = torch.where(valid, bl + lo_cost[..., t], 0.0)
        fits = mask_flat[..., t, :] & (costs <= avail[..., None])
        best = torch.where(fits, idx, -1).amax(-1)
        best = torch.where(valid, torch.maximum(best, lo[..., t]), -1)
        cost = _pick(costs, best)
        bl = torch.where(valid, avail - cost, bl)
        target.append(best)
    target = torch.stack(target, dim=-1)
    used = budget - bl
    deficient = (hi >= 0) & (target < hi)
    return target, used, deficient


def allocate_budget_batch(bitrates, max_spatial, max_temporal, muted, budget):
    """One room's allocation for all subscribers: bitrates [T, 4, 4],
    caps/muted [S, T], budget [S]. Returns (target [S, T], used [S],
    deficient [S, T])."""
    return allocate_budget(bitrates[None], max_spatial, max_temporal, muted, budget)


def allocate_budget_rooms_plain(bitrates, max_spatial, max_temporal, muted, budget):
    """Plain PyTorch version of the phase-2 kernel; arguments and results
    as in `allocate_budget_rooms`."""
    return allocate_budget(bitrates[:, None], max_spatial, max_temporal, muted, budget)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda.library("allocate_budget_rooms").budget_rooms_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fits(T: int, S: int) -> bool:
    """Whether one room's tile of the kernel fits the card's shared memory."""
    fn = cuda.library("allocate_budget_rooms").budget_rooms_fits
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return bool(fn(T, S))


def allocate_budget_rooms(bitrates, max_spatial, max_temporal, muted, budget):
    """All rooms' allocation at once.

    Args:
      bitrates      [R, T, 4, 4] float32
      max_spatial   [R, S, T] int32, max_temporal [R, S, T] int32
      muted         [R, S, T] bool
      budget        [R, S] float32
    Returns (target [R, S, T] int32, used [R, S] float32,
    deficient [R, S, T] bool).

    CUDA tensors launch the kernel (and raise if it cannot run); CPU
    tensors take `allocate_budget_rooms_plain`."""
    device = bitrates.device
    if device.type == "cpu":
        return allocate_budget_rooms_plain(bitrates, max_spatial, max_temporal,
                                           muted, budget)
    if device.type != "cuda":
        raise ValueError(f"allocate_budget_rooms: unsupported device {device}")

    R, T = bitrates.shape[:2]
    S = budget.shape[-1]
    if T > 64:
        raise ValueError(f"allocate_budget_rooms: T={T} exceeds the kernel's 64 tracks")
    if not _fits(T, S):
        raise ValueError(f"allocate_budget_rooms: one room at T={T} S={S} exceeds the "
                         "kernel's shared memory")
    cuda.require(bitrates, "bitrates", torch.float32, (R, T, MAX_SPATIAL, MAX_TEMPORAL), device)
    cuda.require(max_spatial, "max_spatial", torch.int32, (R, S, T), device)
    cuda.require(max_temporal, "max_temporal", torch.int32, (R, S, T), device)
    cuda.require(muted, "muted", torch.bool, (R, S, T), device)
    cuda.require(budget, "budget", torch.float32, (R, S), device)

    target = torch.empty((R, S, T), dtype=torch.int32, device=device)
    used = torch.empty((R, S), dtype=torch.float32, device=device)
    deficient = torch.empty((R, S, T), dtype=torch.bool, device=device)
    ptrs = [t.data_ptr() for t in (bitrates, max_spatial, max_temporal, muted,
                                   budget, target, used, deficient)]
    err = _kernel()(*ptrs, R, T, S, cuda.stream_handle(device))
    cuda.check(err, "allocate_budget_rooms")
    cuda.launches["allocate_budget_rooms"] += 1
    return target, used, deficient


def next_higher(bitrates, max_spatial, max_temporal, current_flat):
    """Next layer above current and its incremental cost (AllocateNextHigher).
    Returns (next_flat, delta_bps); next == current where none is higher."""
    mask = allowed_mask(bitrates, max_spatial, max_temporal).flatten(-2)
    idx = _flat_idx(mask.device)
    above = mask & (idx > current_flat[..., None])
    nxt = torch.where(above, idx, NUM_LAYERS).amin(-1)
    has = nxt < NUM_LAYERS
    nxt = torch.where(has, nxt, current_flat)
    delta = torch.where(
        has, layer_bitrate(bitrates, nxt) - layer_bitrate(bitrates, current_flat), 0.0
    )
    return nxt, delta


def distance_to_desired(target_flat, optimal_flat):
    """Layer distance between allocation and optimum (DistanceToDesired)."""
    t = torch.where(target_flat < 0, -1, target_flat)
    o = torch.where(optimal_flat < 0, -1, optimal_flat)
    return (o - t).to(torch.float32) / MAX_TEMPORAL
