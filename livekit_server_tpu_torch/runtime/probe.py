"""Host BWE probe controller: padding-based bandwidth discovery.

Reference parity: pkg/sfu/streamallocator/probe_controller.go:33-295 (probe
initiation rules, goal computation, settle/backoff timing) and
prober.go:143-600 (cluster pacing), with the padding packets themselves
synthesized by the host munger (runtime/munge.py HostMunger.padding — the
WritePaddingRTP analog, downtrack.go:764-859). A copy of the JAX
package's runtime/probe.py.

Batched re-design: the reference runs one prober goroutine per
participant; here the whole node's probe state machine is a handful of
numpy arrays over [R, S] advanced once per tick on the host (it's control
logic on ~10 Hz cadence — the device does the per-packet work). Outputs
feed TickInputs.pad_num / pad_track; results come back through the BWE
estimate samples the probed client reports (REMB/TWCC).

State machine per (room, subscriber):
  IDLE    --deficient & clear channel & cooldown elapsed-->  PROBING
  PROBING --estimate >= goal-->       IDLE (success; short settle)
  PROBING --congested-->              IDLE (abort; exponential backoff)
  PROBING --duration exceeded-->      IDLE (no answer; backoff)
"""

from __future__ import annotations

import numpy as np

from livekit_server_tpu_torch.models import plane

IDLE, PROBING = 0, 1

PAD_BYTES = 255             # payload bytes per padding packet (max RTP pad run)
PROBE_DURATION_MS = 400     # how long one probe cluster runs
SETTLE_MS = 2_000           # wait after success before probing again
BACKOFF_BASE_MS = 3_000     # first wait after an aborted/unanswered probe
BACKOFF_MAX = 8.0           # exponential cap (probe_controller.go doubling)
GOAL_FACTOR = 1.5           # probe to 1.5× committed…
GOAL_MIN_STEP = 200_000.0   # …or at least +200 kbps


class ProbeController:
    """Vectorized probe scheduling over every (room, subscriber)."""

    def __init__(self, dims: plane.PlaneDims, tick_ms: int):
        R, S = dims.rooms, dims.subs
        self.tick_ms = tick_ms
        self.state = np.zeros((R, S), np.int8)
        self.goal = np.zeros((R, S), np.float64)
        self.end_ms = np.zeros((R, S), np.int64)
        self.next_allowed_ms = np.zeros((R, S), np.int64)
        self.backoff = np.ones((R, S), np.float64)
        self.stats = {"started": 0, "succeeded": 0, "aborted": 0, "expired": 0}

    def update(
        self,
        now_ms: int,
        committed: np.ndarray,       # [R, S] float — allocator budget (bwe)
        congested: np.ndarray,       # [R, S] bool — last tick's congestion
        deficient: np.ndarray,       # [R, S] bool — allocation under-served
        estimate: np.ndarray,        # [R, S] float — staged estimate samples
        estimate_valid: np.ndarray,  # [R, S] bool
        pad_track: np.ndarray,       # [R, S] int — downtrack for padding (-1 none)
    ) -> np.ndarray:
        """Advance the state machine; returns pad_num [R, S] int32 for this
        tick (0 where not probing)."""
        probing = self.state == PROBING

        # Abort: congestion during a probe means the channel answered "no".
        abort = probing & congested
        if abort.any():
            self.state[abort] = IDLE
            self.next_allowed_ms[abort] = now_ms + (
                BACKOFF_BASE_MS * self.backoff[abort]
            ).astype(np.int64)
            self.backoff[abort] = np.minimum(self.backoff[abort] * 2, BACKOFF_MAX)
            self.stats["aborted"] += int(abort.sum())

        # Success: a fresh estimate sample at (or near) the goal.
        succ = probing & ~abort & estimate_valid & (estimate >= self.goal * 0.95)
        if succ.any():
            self.state[succ] = IDLE
            self.next_allowed_ms[succ] = now_ms + SETTLE_MS
            self.backoff[succ] = 1.0
            self.stats["succeeded"] += int(succ.sum())

        # Unanswered: the cluster ran its course without the estimate moving.
        expired = probing & ~abort & ~succ & (now_ms >= self.end_ms)
        if expired.any():
            self.state[expired] = IDLE
            self.next_allowed_ms[expired] = now_ms + (
                BACKOFF_BASE_MS * self.backoff[expired]
            ).astype(np.int64)
            self.backoff[expired] = np.minimum(self.backoff[expired] * 2, BACKOFF_MAX)
            self.stats["expired"] += int(expired.sum())

        # Initiate: under-served allocation on a clear channel, cooldown
        # elapsed, and a video downtrack available to carry the padding.
        start = (
            (self.state == IDLE)
            & deficient
            & ~congested
            & (now_ms >= self.next_allowed_ms)
            & (pad_track >= 0)
        )
        if start.any():
            self.goal[start] = np.maximum(
                committed[start] * GOAL_FACTOR, committed[start] + GOAL_MIN_STEP
            )
            self.end_ms[start] = now_ms + PROBE_DURATION_MS
            self.state[start] = PROBING
            self.stats["started"] += int(start.sum())

        # Padding volume: fill the (goal − committed) gap this tick.
        probing = self.state == PROBING
        extra_bps = np.where(probing, self.goal - committed, 0.0)
        n = np.ceil(extra_bps * (self.tick_ms / 1000.0) / 8.0 / PAD_BYTES)
        return np.clip(n, 0, plane.PAD_MAX).astype(np.int32)

    def clear_room(self, room: int) -> None:
        self.state[room] = IDLE
        self.backoff[room] = 1.0
        self.next_allowed_ms[room] = 0
