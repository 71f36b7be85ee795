"""Batched RTP sequence-number / timestamp munging: the golden scan.

Reference parity: pkg/sfu/rtpmunger.go (UpdateAndGetSnTs :183-271,
SN-gap compaction, PacketDropped, UpdateAndGetPaddingSnTs) and the
source-switch re-anchoring of pkg/sfu/forwarder.go (processSourceSwitch
:1456-1650), as formulated by the JAX package's ops/rtpmunger.py.

No runtime path calls these functions: the forward path rewrites on the
host (runtime/munge.py HostMunger), and this module is the spec that
walker is held to. The reference's `lax.scan` over the packet axis is a
Python loop over P of batched torch ops. Values live in int32 lanes:
out_sn is 16-bit (explicit masks), out_ts 32-bit two's complement (int32
arithmetic wraps). Functions batch over leading axes and follow their
inputs' device.

Shapes (per track): packet fields [..., P], masks [..., P, S], state
fields [..., S].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.ops import seqnum


class MungerState(NamedTuple):
    """Per-(track, subscriber) munger state; fields [..., S] int32/bool
    (the reference's RTPMungerState, rtpmunger.go:53-69)."""

    sn_offset: torch.Tensor  # mod 2^16: out_sn = in_sn - sn_offset
    ts_offset: torch.Tensor  # mod 2^32: out_ts = in_ts - ts_offset
    last_sn: torch.Tensor    # last outgoing 16-bit SN
    last_ts: torch.Tensor    # last outgoing 32-bit TS
    started: torch.Tensor    # bool: offsets are valid
    ts_anchor_aligned: torch.Tensor  # bool: anchored on a common-timeline packet


# A forwarded (non-switch) packet whose output TS would jump by more than
# this re-anchors instead: the input timeline shifted under us.
REANCHOR_TS_THRESH = 900_000  # 10 s @ 90 kHz
FALLBACK_TS_JUMP = 3000       # one frame @ 90 kHz / 30 fps


def init_state(num_subscribers: int, device="cuda") -> MungerState:
    device = resolve(device)
    z = torch.zeros((num_subscribers,), dtype=torch.int32, device=device)
    f = torch.zeros((num_subscribers,), dtype=torch.bool, device=device)
    return MungerState(z, z.clone(), z.clone(), z.clone(), f, f.clone())


def munge_tick(state: MungerState, pkt_sn, pkt_ts, pkt_valid, forward, drop,
               switch, switch_ts_jump):
    """One tick of SN/TS munging for one track: rtpmunger.go
    UpdateAndGetSnTs over each forwarded packet and PacketDropped over
    each dropped one, per subscriber. `switch_ts_jump` [..., P] is the TS
    advance at a switch; -1 means the host already normalized the packet
    onto the track's common timeline, so the offset carries through.

    Returns (new_state, out_sn [..., P, S], out_ts, send)."""
    sn_off, ts_off, last_sn, last_ts, started, aligned = state
    out_sn, out_ts, sends = [], [], []
    for k in range(pkt_sn.shape[-1]):
        sn = pkt_sn[..., k, None]
        ts = pkt_ts[..., k, None]
        valid = pkt_valid[..., k, None]
        jump = switch_ts_jump[..., k, None]
        fwd = forward[..., k, :] & valid
        drp = drop[..., k, :] & valid & ~fwd
        sw = switch[..., k, :] & fwd
        pkt_aligned = jump < 0
        jump_eff = torch.where(pkt_aligned, FALLBACK_TS_JUMP, jump)

        # Source switch: output SN continues at last_sn + 1, TS at
        # last_ts + jump, unless packet and anchor both sit on the
        # SR-normalized common timeline (the offset then maps it exactly).
        sw_sn_off = seqnum.sub16(sn, seqnum.add16(last_sn, 1))
        sw_ts_off = seqnum.sub32(ts, seqnum.add32(last_ts, jump_eff))
        sw_ts_off = torch.where(pkt_aligned & aligned, ts_off, sw_ts_off)
        fresh = fwd & ~started          # first packet: identity mapping
        resync = sw & started
        # Timeline shear guard: a continuing forward whose output TS would
        # leap implausibly far re-anchors with the fallback jump.
        shear = seqnum.sub32(seqnum.sub32(ts, ts_off), last_ts)
        sheared = fwd & ~sw & started & (shear.abs() > REANCHOR_TS_THRESH)
        shear_ts_off = seqnum.sub32(ts, seqnum.add32(last_ts, FALLBACK_TS_JUMP))

        anchor = fresh | resync | sheared
        sn_off = torch.where(resync, sw_sn_off, torch.where(fresh, 0, sn_off))
        ts_off = torch.where(
            sheared, shear_ts_off,
            torch.where(resync, sw_ts_off, torch.where(fresh, 0, ts_off)))
        aligned = torch.where(anchor, pkt_aligned, aligned)

        o_sn = seqnum.sub16(sn, sn_off)
        o_ts = seqnum.sub32(ts, ts_off)
        last_sn = torch.where(fwd, o_sn, last_sn)
        last_ts = torch.where(fwd, o_ts, last_ts)
        # Gap compaction: a dropped current-stream packet shifts future
        # output SNs down by one (the reference's RangeMap exclusion).
        sn_off = torch.where(drp & started, seqnum.add16(sn_off, 1), sn_off)
        started = started | fwd
        out_sn.append(o_sn)
        out_ts.append(o_ts)
        sends.append(fwd)
    new_state = MungerState(sn_off, ts_off, last_sn, last_ts, started, aligned)
    return (new_state, torch.stack(out_sn, dim=-2), torch.stack(out_ts, dim=-2),
            torch.stack(sends, dim=-2))


def padding_tick(state: MungerState, num, max_num: int, ts_advance):
    """Synthesize `num` [..., S] padding packets per subscriber after the
    last sent one (rtpmunger.go UpdateAndGetPaddingSnTs). Padding
    advances the outgoing SN space without a source packet, so the SN
    offset moves back by the count; one burst shares one advanced TS.

    Returns (new_state, pad_sn [..., max_num, S], pad_ts, valid)."""
    ks = torch.arange(max_num, dtype=torch.int32, device=num.device)[:, None]
    valid = (ks < num[..., None, :]) & state.started[..., None, :]
    pad_sn = seqnum.add16(state.last_sn[..., None, :], ks + 1)
    pad_ts = seqnum.add32(state.last_ts, ts_advance)[..., None, :].expand(pad_sn.shape)
    n = torch.where(state.started, num, 0)
    new_state = state._replace(
        sn_offset=seqnum.sub16(state.sn_offset, n),
        last_sn=torch.where(n > 0, seqnum.add16(state.last_sn, n), state.last_sn),
        last_ts=torch.where(n > 0, seqnum.add32(state.last_ts, ts_advance),
                            state.last_ts),
    )
    return new_state, pad_sn, pad_ts.contiguous(), valid
