"""Byte counts of the hand kernels from their shapes, and the card's peaks.

A kernel's least time is the bytes its launch must move (every operand
read once, every result written once) over the card's peak memory rate
(`peaks.json`). The counts follow the kernels' C interfaces
(csrc/decide_rooms.cu, csrc/budget_rooms.cu) and PERF.md's kernel table
(163.3 MB and 66.7 MB at the north star).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def mask_words(subs: int) -> int:
    return (subs + 31) // 32


def decide_rooms_bytes(R: int, T: int, K: int, S: int) -> int:
    """B1: packets [R, T, K] (spatial, temporal, size int32; keyframe,
    sync, end-of-frame, valid bool), is_svc and is_video [R, T] bool, base
    [R, T, S] bool and the selector state's four [R, T, S] int32 leaves
    in; the send, drop and switch bits [R, T, K, W] int32, need_kf [R, T,
    S] bool, pkts_sent and sent_bytes [R, S] int32, fwd_packets and
    fwd_bytes [R] int32 and the two current-layer leaves out."""
    W = mask_words(S)
    rtk, rts = R * T * K, R * T * S
    read = 3 * 4 * rtk + 4 * rtk + 2 * R * T + rts + 4 * 4 * rts
    write = 3 * 4 * rtk * W + rts + 2 * 4 * R * S + 2 * 4 * R + 2 * 4 * rts
    return read + write


def budget_rooms_bytes(R: int, T: int, S: int) -> int:
    """B2: bitrates [R, T, 4, 4] float32, max_spatial and max_temporal
    [R, S, T] int32, muted [R, S, T] bool, budget [R, S] float32 in; the
    targets [R, S, T] int32, used [R, S] float32 and deficient [R, S, T]
    bool out."""
    rst = R * S * T
    read = 4 * 16 * R * T + 2 * 4 * rst + rst + 4 * R * S
    write = 4 * rst + 4 * R * S + rst
    return read + write


def peak(device_name: str, key: str):
    """The card's published peak `key`; None for a card not in the table."""
    table = json.loads(PEAKS.read_text())
    return table.get(device_name, {}).get(key)


def roofline_pct(nbytes: int, kernel_s: float, device_name: str):
    """100 × (least time by bytes) / measured time; None when the card or
    the kernel's time is unknown."""
    bw = peak(device_name, "hbm_bytes_per_s")
    if bw is None or not kernel_s:
        return None
    return 100.0 * (nbytes / bw) / kernel_s
