"""The MCU audio path's device ops, plain PyTorch: G.711 decode and
encode, and the per-subscriber active-speaker mix.

Port of the JAX package's ops/mix.py. `decode_tick` turns [R, T, N]
G.711 µ-law/A-law bytes into float PCM with one table gather per sample
for the whole room batch; `decode_pcm16` scales L16 samples; `encode_ulaw`
turns float PCM back into µ-law bytes by bit math (the exponent from a
threshold ladder, never a float log, so segment boundaries are exact).
Each follows its input's device; the tables are built once per device.
None of these is a Pallas kernel in the reference, and each is exact
integer or exact float work, so plain torch ops are the port.

`mix_tick` is the reference's mix: a room-level top-K
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

import functools

import numpy as np
import torch

from livekit_server_tpu_torch.analysis.registry import device_entry

MIX_TOP_K = 3  # speakers mixed per subscriber


def _ulaw_table() -> np.ndarray:
    """G.711 µ-law byte → linear sample (float32 in [-1, 1))."""
    u = np.arange(256, dtype=np.uint8) ^ 0xFF
    sign = np.where(u & 0x80, -1.0, 1.0)
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = ((mant.astype(np.int32) << 3) + 0x84) << exp
    return (sign * (mag - 0x84) / 32768.0).astype(np.float32)


def _alaw_table() -> np.ndarray:
    """G.711 A-law byte → linear sample (float32 in [-1, 1))."""
    a = np.arange(256, dtype=np.uint8) ^ 0x55
    sign = np.where(a & 0x80, -1.0, 1.0)
    exp = (a >> 4) & 0x07
    mant = (a & 0x0F).astype(np.int32)
    mag = np.where(exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << (exp - 1))
    return (sign * mag / 32768.0).astype(np.float32)


ULAW_TABLE = _ulaw_table()
ALAW_TABLE = _alaw_table()

CODEC_PCM16 = 0
CODEC_PCMU = 1
CODEC_PCMA = 2


@functools.lru_cache(maxsize=None)
def _g711_table(device: torch.device) -> torch.Tensor:
    """[512] float32 on `device`: the µ-law table, then the A-law table."""
    return torch.from_numpy(np.concatenate([ULAW_TABLE, ALAW_TABLE])).to(device)


@device_entry("mix.decode_tick")
def decode_tick(payload_u8: torch.Tensor, codec: torch.Tensor) -> torch.Tensor:
    """[R, T, N] uint8 G.711 bytes and [R, T] codec ids → [R, T, N] float32
    PCM: A-law where codec == CODEC_PCMA, µ-law otherwise, one gather per
    sample from the joined table."""
    alaw = (codec == CODEC_PCMA).to(torch.int64)[:, :, None] << 8
    return _g711_table(payload_u8.device)[payload_u8.to(torch.int64) + alaw]


def decode_pcm16(samples_i16: torch.Tensor) -> torch.Tensor:
    """int16 L16 samples → float32 in [-1, 1)."""
    return samples_i16.to(torch.float32) / 32768.0


def encode_ulaw(pcm: torch.Tensor) -> torch.Tensor:
    """float PCM [-1, 1) → µ-law bytes (RFC G.711), by bit math.

    The magnitude is |x|·32768 truncated toward zero, as the reference's
    astype(int32); a NaN sample counts as 0, as XLA converts it."""
    x = torch.clamp(pcm, -1.0, 1.0 - 1.0 / 32768.0)
    sign = torch.where(x < 0, 0x80, 0).to(torch.int32)
    scaled = torch.nan_to_num(torch.abs(x) * 32768.0, nan=0.0)
    mag = torch.clamp(scaled.to(torch.int32) + 0x84, max=0x7FFF)
    # Exponent = MSB position − 7 (mag ≥ 0x84 ⇒ MSB ∈ [7, 14]).
    exp = torch.zeros_like(mag)
    for b in range(8, 15):
        exp = torch.where(mag >= (1 << b), b - 7, exp)
    mant = (mag >> (exp + 3)) & 0x0F
    return ((sign | (exp << 4) | mant) ^ 0xFF).to(torch.uint8)


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


@device_entry("mix.mix_tick")
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
