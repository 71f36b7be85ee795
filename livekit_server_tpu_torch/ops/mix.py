"""Per-subscriber active-speaker mix (the MCU audio path), plain PyTorch.

Port of `mix_tick` from the JAX package's ops/mix.py: a room-level top-K
speaker gate, self-exclusion and per-track gain folded into one
[R, S, T] weight matrix, applied to decoded PCM and soft-clipped. It is
the plain counterpart of the mix half of the live-page kernel
(ops/paged_kernel.py, csrc/paged_kernel.cu).

The weighted sum over tracks runs in a fixed order, t = 0, 1, ..., each
step one float32 multiply and one add, never a matmul: the CUDA kernel
adds in the same order without fused multiply-adds, so the two agree bit
for bit on the card. (The reference's einsum may group the sum
differently; against it the result is equal within float32 rounding.)
"""

from __future__ import annotations

import torch

MIX_TOP_K = 3  # speakers mixed per subscriber


def mix_weights(level, active, sub_track, gain, top_k: int = MIX_TOP_K):
    """The [R, S, T] float32 include weights: gain[t] where track t is
    among the room's top-k active speakers (ties at the k-th level all
    included; silence is never a speaker) and is not subscriber s's own
    track, else 0."""
    T = level.shape[-1]
    k = min(top_k, T)
    lv = torch.where(active, level, -1.0)
    if k > 0:
        kth = torch.sort(lv, dim=-1).values[:, T - k][:, None]        # [R, 1]
    else:
        kth = torch.full_like(lv[:, :1], float("inf"))
    speak = active & (lv >= torch.clamp(kth, min=0.0))                # [R, T]
    tracks = torch.arange(T, dtype=torch.int32, device=level.device)
    w = speak[:, None, :] & (tracks[None, None, :] != sub_track[:, :, None])
    return w.to(torch.float32) * gain[:, None, :]


def mix_tick(pcm, level, active, sub_track, gain, top_k: int = MIX_TOP_K):
    """Per-subscriber active-speaker mix: [R, S, N] soft-clipped PCM.

    Args: pcm [R, T, N] float32 decoded PCM; level [R, T] float32 linear
    levels; active [R, T] bool; sub_track [R, S] int32 (each
    subscriber's own track, -1 none); gain [R, T] float32."""
    weights = mix_weights(level, active, sub_track, gain, top_k)     # [R, S, T]
    mixed = torch.zeros(weights.shape[:2] + pcm.shape[2:], dtype=torch.float32,
                        device=pcm.device)
    for t in range(pcm.shape[1]):                                    # track order
        mixed = mixed + weights[:, :, t, None] * pcm[:, None, t, :]
    # Soft clip: a 3-speaker sum can exceed full scale.
    return torch.tanh(mixed)
