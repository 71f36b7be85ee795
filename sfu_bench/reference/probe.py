"""The reference's probe controller: how many padding packets each
subscriber gets this tick, and on which track.

The semantics of pkg/sfu/streamallocator/probe_controller.go, batched
over every (room, subscriber): an idle subscriber whose allocation is
deficient, on a channel not congested, after its cooldown, with a live
video track to carry padding, starts a probe towards 1.5× its committed
rate (at least +200 kbps) for 400 ms; a probe ends on congestion (backoff
3 s, doubling to 8×), on an estimate within 5 % of its goal (settle 2 s,
backoff reset) or when its time runs out (backoff). While it runs, the
gap between goal and committed rate is filled with 255-byte padding
packets, at most PAD_MAX a tick. The padding rides the first published,
unmuted video track the subscriber is subscribed to.

Plain numpy; imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import tick

IDLE, PROBING = 0, 1
PAD_BYTES = 255
PROBE_MS = 400
SETTLE_MS = 2000
BACKOFF_MS = 3000
BACKOFF_CAP = 8.0
GOAL_SCALE = 1.5
GOAL_STEP_BPS = 200_000.0
SUCCESS_SHARE = 0.95


class ProbeState(NamedTuple):
    """[R, S] per (room, subscriber)."""

    state: np.ndarray            # int8: IDLE or PROBING
    goal: np.ndarray             # float64 bps
    end_ms: np.ndarray           # int64
    next_allowed_ms: np.ndarray  # int64
    backoff: np.ndarray          # float64 multiplier


def init(rooms: int, subs: int) -> ProbeState:
    return ProbeState(np.zeros((rooms, subs), np.int8), np.zeros((rooms, subs)),
                      np.zeros((rooms, subs), np.int64), np.zeros((rooms, subs), np.int64),
                      np.ones((rooms, subs)))


def pad_track(meta, ctrl) -> np.ndarray:
    """[R, S] int32: the first live video track each subscriber is
    subscribed to, -1 where none (numpy TrackMeta / SubControl)."""
    live = (np.asarray(meta.is_video) & np.asarray(meta.published)
            & ~np.asarray(meta.pub_muted))
    cand = live[:, :, None] & np.asarray(ctrl.subscribed, bool)          # [R, T, S]
    T = cand.shape[1]
    first = np.where(cand, np.arange(T)[None, :, None], T).min(axis=1)  # [R, S]
    return np.where(first < T, first, -1).astype(np.int32)


def step(ps: ProbeState, now_ms: int, committed, congested, deficient, estimate,
         estimate_valid, track, tick_ms: int):
    """One tick: (new state, pad_num [R, S] int32). `committed`,
    `congested`, `deficient`: the previous tick's outputs; `estimate`,
    `estimate_valid`: this tick's staged reports; `track`: `pad_track`."""
    state, goal = ps.state.copy(), ps.goal.copy()
    end_ms, nxt, backoff = ps.end_ms.copy(), ps.next_allowed_ms.copy(), ps.backoff.copy()
    committed = np.asarray(committed, np.float32)       # the allocator's float32 rates
    congested = np.asarray(congested, bool)
    est = np.asarray(estimate, np.float32).astype(np.float64)
    was = state == PROBING
    aborted = was & congested
    answered = was & ~aborted & np.asarray(estimate_valid, bool) & (est >= goal * SUCCESS_SHARE)
    timed_out = was & ~aborted & ~answered & (now_ms >= end_ms)
    backs = aborted | timed_out
    # Order matters as in the controller: the backoff a failure waits is
    # the multiplier before it doubles.
    nxt = np.where(backs, now_ms + (BACKOFF_MS * backoff).astype(np.int64), nxt)
    nxt = np.where(answered, now_ms + SETTLE_MS, nxt)
    backoff = np.where(backs, np.minimum(backoff * 2, BACKOFF_CAP), backoff)
    backoff = np.where(answered, 1.0, backoff)
    state = np.where(aborted | answered | timed_out, IDLE, state).astype(np.int8)
    begin = ((state == IDLE) & np.asarray(deficient, bool) & ~congested
             & (now_ms >= nxt) & (np.asarray(track) >= 0))
    # The goal is figured in the rates' float32, and kept in float64.
    goal = np.where(begin, np.maximum(committed * np.float32(GOAL_SCALE),
                                      committed + np.float32(GOAL_STEP_BPS)), goal)
    end_ms = np.where(begin, now_ms + PROBE_MS, end_ms)
    state = np.where(begin, PROBING, state).astype(np.int8)
    gap = np.where(state == PROBING, goal - committed.astype(np.float64), 0.0)
    n = np.ceil(gap * (tick_ms / 1000.0) / 8.0 / PAD_BYTES)
    pad = np.clip(n, 0, tick.PAD_MAX).astype(np.int32)
    return ProbeState(state, goal, end_ms, nxt, backoff), pad
