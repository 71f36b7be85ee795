"""Dynacast: pause simulcast layers nobody is watching.

Reference parity: pkg/rtc/dynacastmanager.go:35-264 + dynacastquality.go —
aggregate every subscriber's desired max quality per track, notify the
publisher to stop encoding unused layers (subscribed_quality_update
signal), with debounced downgrades (dynacastPauseDelay) so brief
subscriber churn doesn't flap the encoder.

Batched-plane twist: desired state already lives in the ctrl.max_spatial host
mirror, so aggregation is a masked max over the subscriber axis of the
control tensors — no per-subscriber bookkeeping objects.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

DOWNGRADE_DELAY_S = 5.0  # dynacastPauseDelay (dynacastmanager.go)


@dataclass
class DynacastState:
    """Per-track last-signaled max quality + pending downgrade timer."""

    last_sent: dict[str, int] = field(default_factory=dict)      # sid → quality
    pending_down: dict[str, tuple[int, float]] = field(default_factory=dict)


def compute_max_quality(
    subscribed: np.ndarray,    # [T, S] bool (room slice of ctrl.subscribed)
    sub_muted: np.ndarray,     # [T, S] bool
    max_spatial: np.ndarray,   # [T, S] int32
) -> np.ndarray:
    """Per-track max desired spatial layer over active subscribers; -1 when
    nobody subscribes (⇒ publisher may pause the track entirely)."""
    active = subscribed & ~sub_muted
    desired = np.where(active, max_spatial, -1)
    return desired.max(axis=-1)


def reconcile(
    state: DynacastState,
    room,
    now: float | None = None,
) -> list[tuple[object, str, int]]:
    """Compare aggregated desire against what was last signaled; returns
    [(publisher, track_sid, max_quality)] to notify. Upgrades fire
    immediately; downgrades wait DOWNGRADE_DELAY_S (dynacastquality.go
    debounce)."""
    now = time.time() if now is None else now
    row = room.slots.row
    rt = room.runtime
    sub = room.runtime.ctrl.subscribed[row]
    mut = room.runtime.ctrl.sub_muted[row]
    cap = room.runtime.ctrl.max_spatial[row]
    maxq = compute_max_quality(sub, mut, cap)

    notify = []
    for sid, (publisher, track) in room.tracks.items():
        if not track.is_video:
            continue
        q = int(maxq[track.track_col])
        last = state.last_sent.get(sid)
        if last is None or q > last:
            state.pending_down.pop(sid, None)
            state.last_sent[sid] = q
            notify.append((publisher, sid, q))
        elif q < last:
            pend = state.pending_down.get(sid)
            if pend is None:
                state.pending_down[sid] = (q, now)
            elif pend[0] != q:
                state.pending_down[sid] = (q, min(pend[1], now))
            elif now - pend[1] >= DOWNGRADE_DELAY_S:
                state.pending_down.pop(sid, None)
                state.last_sent[sid] = q
                notify.append((publisher, sid, q))
        else:
            state.pending_down.pop(sid, None)
    # Drop state for unpublished tracks.
    gone = set(state.last_sent) - set(room.tracks)
    for sid in gone:
        state.last_sent.pop(sid, None)
        state.pending_down.pop(sid, None)
    return notify
