"""Batched VP8 payload-descriptor munging: the golden scan.

Reference parity: pkg/sfu/codecmunger/vp8.go (UpdateAndGet :161 —
picture-id 7/15-bit wrap, TL0PICIDX, KEYIDX offset rewriting;
UpdateOffsets on a source switch; VP8State :35-50), as formulated by the
JAX package's ops/vp8.py. As ops/rtpmunger.py, this is the spec the host
munger (runtime/munge.py) is held to; no runtime path calls it. The
packet-axis scan is a Python loop over P. Field widths (15-bit picture
id, 8-bit TL0PICIDX, 5-bit KEYIDX) are held in int32 with explicit masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve

MASK15 = 0x7FFF
MASK8 = 0xFF
MASK5 = 0x1F


def sub15(a, d):
    return (a - d) & MASK15


def add15(a, d):
    return (a + d) & MASK15


def diff15(a, b):
    """Signed wrap-aware 15-bit distance a - b."""
    return ((a - b + 0x4000) & MASK15) - 0x4000


class VP8State(NamedTuple):
    """Per-(track, subscriber) VP8 munger state, fields [..., S]
    int32/bool (vp8.go VP8State)."""

    pid_offset: torch.Tensor     # mod 2^15
    tl0_offset: torch.Tensor     # mod 2^8
    keyidx_offset: torch.Tensor  # mod 2^5
    last_pid: torch.Tensor
    last_tl0: torch.Tensor
    last_keyidx: torch.Tensor
    started: torch.Tensor        # bool


def init_state(num_subscribers: int, device="cuda") -> VP8State:
    device = resolve(device)
    z = lambda: torch.zeros((num_subscribers,), dtype=torch.int32, device=device)  # noqa: E731
    return VP8State(z(), z(), z(), z(), z(), z(),
                    torch.zeros((num_subscribers,), dtype=torch.bool, device=device))


def munge_tick(state: VP8State, pid, tl0, keyidx, begin_pic, pkt_valid,
               forward, drop_pic, switch):
    """One tick of VP8 descriptor munging for one track: vp8.go
    UpdateAndGet per forwarded packet plus dropped-picture accounting
    (`drop_pic` is set on a dropped picture's first packet), per
    subscriber. Packet fields [..., P], masks [..., P, S].

    Returns (new_state, out_pid [..., P, S], out_tl0, out_keyidx)."""
    pid_off, tl0_off, ki_off, last_pid, last_tl0, last_ki, started = state
    outs_pid, outs_tl0, outs_ki = [], [], []
    for k in range(pid.shape[-1]):
        p = pid[..., k, None]
        t0 = tl0[..., k, None]
        ki = keyidx[..., k, None]
        bp = begin_pic[..., k, None]
        valid = pkt_valid[..., k, None]
        fwd = forward[..., k, :] & valid
        drp = drop_pic[..., k, :] & valid & ~fwd & bp
        sw = switch[..., k, :] & fwd

        # Source switch: the picture-id space continues at last + 1
        # (vp8.go UpdateOffsets).
        sw_pid_off = sub15(p, add15(last_pid, 1))
        sw_tl0_off = (t0 - last_tl0 - 1) & MASK8
        sw_ki_off = (ki - last_ki - 1) & MASK5
        fresh = fwd & ~started
        resync = sw & started
        pid_off = torch.where(resync, sw_pid_off, torch.where(fresh, 0, pid_off))
        tl0_off = torch.where(resync, sw_tl0_off, torch.where(fresh, 0, tl0_off))
        ki_off = torch.where(resync, sw_ki_off, torch.where(fresh, 0, ki_off))

        out_pid = sub15(p, pid_off)
        out_tl0 = (t0 - tl0_off) & MASK8
        out_ki = (ki - ki_off) & MASK5
        fwd_bp = fwd & bp
        last_pid = torch.where(fwd_bp, out_pid, last_pid)
        last_tl0 = torch.where(fwd_bp, out_tl0, last_tl0)
        last_ki = torch.where(fwd_bp, out_ki, last_ki)
        # A dropped picture shifts future output picture ids down by one.
        pid_off = torch.where(drp & started, add15(pid_off, 1), pid_off)
        started = started | fwd
        outs_pid.append(out_pid)
        outs_tl0.append(out_tl0)
        outs_ki.append(out_ki)
    new_state = VP8State(pid_off, tl0_off, ki_off, last_pid, last_tl0, last_ki, started)
    stack = lambda xs: torch.stack(xs, dim=-2)  # noqa: E731
    return new_state, stack(outs_pid), stack(outs_tl0), stack(outs_ki)
