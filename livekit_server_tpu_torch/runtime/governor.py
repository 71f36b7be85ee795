"""OverloadGovernor: closed-loop load shedding for the media plane.

Port of the JAX package's runtime/governor.py (same ladder, thresholds
and sensors). The reference SFU degrades under pressure instead of missing pacing
deadlines — its stream allocator pauses and downgrades simulcast layers
(streamallocator.go), and LimitConfig gates node admission. This runtime
concentrates the node in one device step per tick, so overload shows up
as tick-deadline lateness, pipeline stalls, and ingest slab overflow —
the sensor suite the pipelined serving loop already exports. The
governor closes the loop from those sensors to a monotonic ladder of
degradation levels, each mapped to an existing actuator:

  L0  healthy — no intervention
  L1  clamp spatial layer caps, highest layers first (the dirty-row
      ctrl-upload path applies an *effective* cap at upload time; the
      host mirrors keep every subscriber's desired caps, so snapshots,
      failover, and recovery are exact)
  L2  police per-(room, track) ingress with token buckets — video only,
      so greedy publishers shed before polite ones and audio rides
      through untouched (IngestBuffer.set_policer)
  L3  pause non-pinned video subscriptions; audio and signaling stay
      live (effective sub_muted mask, same upload-time seam as L1)
  L4  reject new room creates, joins, and track publishes with explicit
      signal responses (RoomManager admission consults should_admit)

Sensors are evaluated once per completed tick (PlaneRuntime._complete →
on_tick): deadline lateness, work ratio (tick work time / tick period),
new pipeline stalls, and new ingest *capacity* drops. Policed drops are
deliberately excluded — intentional shedding must not read as pressure,
which is the point of the dropped_capacity / dropped_policed split.

Recovery walks the ladder DOWN one level at a time with hysteresis:
distinct enter/exit work-ratio thresholds plus a dwell time (consecutive
calm ticks) per step, so an oscillating load cannot flap the governor.
The PlaneSupervisor watchdog treats a governed plane (level > 0) as
"overloaded but making progress" and extends its stall deadline — load
must shed, not trigger a restart storm that makes the overload worse.
"""

from __future__ import annotations

from collections import deque

from livekit_server_tpu_torch.models import plane
from livekit_server_tpu_torch.runtime.trace import EV_GOV_LEVEL
from livekit_server_tpu_torch.utils.logger import Logger

# Ladder levels (monotonic; each includes every actuator below it).
L_HEALTHY = 0
L_CLAMP = 1      # drop the top spatial layer(s)
L_POLICE = 2     # + token-bucket video ingress policing, base layer only
L_PAUSE = 3      # + pause non-pinned video subscriptions
L_REJECT = 4     # + reject new rooms / joins / publishes
L_MAX = L_REJECT


class OverloadGovernor:
    """One governor per runtime; attach via `runtime.governor` (RoomManager
    does this when config.limits.governor_enabled, the default)."""

    def __init__(
        self,
        runtime,
        *,
        enter_pressure: float = 0.85,
        exit_pressure: float = 0.55,
        escalate_ticks: int = 20,
        dwell_ticks: int = 150,
        ingress_pps: float = 400.0,
        ingress_burst: float = 100.0,
        log: Logger | None = None,
    ):
        self.runtime = runtime
        self.enter_pressure = enter_pressure
        self.exit_pressure = exit_pressure
        self.escalate_ticks = max(1, int(escalate_ticks))
        self.dwell_ticks = max(1, int(dwell_ticks))
        self.ingress_pps = ingress_pps
        self.ingress_burst = ingress_burst
        self.log = log or Logger()
        self.level = L_HEALTHY
        self.ticks = 0
        self.escalations = 0         # lifetime up-transitions (telemetry)
        self.transition_count = 0
        # Recent transition records for /debug/overload.
        self.transitions: deque = deque(maxlen=64)
        # Admission rejections by kind ("room" / "join" / "publish");
        # RoomManager increments via note_rejection at each refusal.
        self.rejected: dict[str, int] = {}
        # Node drain (service/migration.py): while held, the node sits at
        # L_MAX and the sensor loop neither escalates nor recovers — a
        # draining node must keep rejecting admissions no matter how calm
        # its (emptying) plane looks.
        self.drain_hold = False
        self._hot = 0                # consecutive pressured ticks
        self._calm = 0               # consecutive relaxed ticks
        self._stalls_seen = runtime.stats.get("pipeline_stalls", 0)
        self._cap_drops_seen = runtime.ingest.dropped_capacity

    @classmethod
    def from_config(cls, runtime, limits, log: Logger | None = None):
        """Construct from config.LimitsConfig (the governor_* keys)."""
        return cls(
            runtime,
            enter_pressure=limits.governor_enter_pressure,
            exit_pressure=limits.governor_exit_pressure,
            escalate_ticks=limits.governor_escalate_ticks,
            dwell_ticks=limits.governor_dwell_ticks,
            ingress_pps=limits.governor_ingress_pps,
            ingress_burst=limits.governor_ingress_burst,
            log=log,
        )

    # -- sensors ----------------------------------------------------------
    def on_tick(self, rec: dict) -> None:
        """One completed tick's verdict (PlaneRuntime._complete passes the
        recent_ticks record it just appended). Three-way classification:
        pressured (any overload sensor fires), relaxed (everything under
        the exit threshold — the hysteresis band), or the middle band,
        which resets BOTH streaks: not bad enough to escalate, not calm
        enough to count toward dwell."""
        if self.drain_hold:
            self.ticks += 1
            return
        rt = self.runtime
        stalls = rt.stats.get("pipeline_stalls", 0)
        cap_drops = rt.ingest.dropped_capacity
        d_stalls = stalls - self._stalls_seen
        d_caps = cap_drops - self._cap_drops_seen
        self._stalls_seen = stalls
        self._cap_drops_seen = cap_drops
        work = rec.get("total_ms", 0.0) / max(float(rt.tick_ms), 1e-3)
        late = bool(rec.get("late"))
        self.ticks += 1
        pressured = (
            late or d_stalls > 0 or d_caps > 0 or work >= self.enter_pressure
        )
        relaxed = (
            not late and d_stalls == 0 and d_caps == 0
            and work <= self.exit_pressure
        )
        if pressured:
            self._calm = 0
            self._hot += 1
            if self._hot >= self.escalate_ticks and self.level < L_MAX:
                why = []
                if late:
                    why.append("late")
                if d_stalls > 0:
                    why.append(f"stalls+{d_stalls}")
                if d_caps > 0:
                    why.append(f"cap_drops+{d_caps}")
                if work >= self.enter_pressure:
                    why.append(f"work={work:.2f}")
                self._set_level(self.level + 1, " ".join(why))
                # One step per full streak: the next rung needs another
                # escalate_ticks of sustained pressure, so a single bad
                # burst cannot ride the ladder straight to L_MAX.
                self._hot = 0
        elif relaxed:
            self._hot = 0
            self._calm += 1
            if self._calm >= self.dwell_ticks and self.level > L_HEALTHY:
                self._set_level(self.level - 1, "recovered (dwell elapsed)")
                # Symmetric: each downward step earns its own full dwell.
                self._calm = 0
        else:
            self._hot = 0
            self._calm = 0

    # -- actuators --------------------------------------------------------
    def _set_level(self, new: int, reason: str = "") -> None:
        """Move one ladder step and apply the new level's actuator set.
        Levels are cumulative, so the actuators are recomputed absolutely
        from `new` rather than toggled incrementally — a restart-restored
        governor lands in a consistent state either way."""
        old = self.level
        if new == old:
            return
        self.level = new
        rt = self.runtime
        if new >= L_POLICE:
            spatial_cap = 0                        # base layer only
        elif new >= L_CLAMP:
            spatial_cap = max(0, plane.MAX_LAYERS - 2)  # shed top layer
        else:
            spatial_cap = plane.MAX_LAYERS - 1     # no clamp
        rt.set_shed(spatial_cap=spatial_cap, pause_video=new >= L_PAUSE)
        if new >= L_POLICE:
            rt.ingest.set_policer(
                self.ingress_pps, self.ingress_burst,
                is_video=rt.meta.is_video,
            )
        else:
            rt.ingest.clear_policer()
        self.transition_count += 1
        if new > old:
            self.escalations += 1
        self.transitions.append(
            {"tick": self.ticks, "from": old, "to": new, "reason": reason}
        )
        bb = getattr(rt, "blackbox", None)
        if bb is not None:
            # Node-lane black-box event (cold path: level transitions).
            bb.emit(bb.NODE, EV_GOV_LEVEL, float(old), float(new))
        log = self.log.warn if new > old else self.log.info
        log("overload governor level change", level=new, was=old, reason=reason)

    # -- admission (L4) ---------------------------------------------------
    def should_admit(self, kind: str) -> bool:
        """Node admission gate for new work ('room' / 'join' / 'publish')
        and failover adoption ('restore'). Existing sessions — including
        resumes — are never evicted by the governor; only NEW load is
        refused, and only at L4. A 'restore' is NOT new load: the fleet
        already admitted that room and its participants before their node
        died, so the transient ladder never refuses it — on a busy fleet
        an L4 gate here would orphan rooms permanently, exactly when a
        flash crowd makes the survivors late. Restores still stop on
        drain_hold (this node is leaving) and on hard plane headroom.

        Room admission is additionally keyed on REAL plane headroom, not
        row count: `occupancy()["admittable_rooms"]` folds in the page
        pool on a paged runtime (free pages / min room footprint), so a
        fragmented or page-exhausted pool refuses rooms even while room
        rows remain — and a dense runtime degrades to the row check."""
        if self.drain_hold:
            return False
        if kind != "restore" and self.level >= L_REJECT:
            return False
        if kind in ("room", "restore"):
            occ = self.runtime.occupancy()
            if occ.get("admittable_rooms", 1) <= 0:
                return False
        return True

    def note_rejection(self, kind: str) -> None:
        self.rejected[kind] = self.rejected.get(kind, 0) + 1

    # -- drain hold (node drain, service/migration.py) --------------------
    def hold_max(self, reason: str = "node draining") -> None:
        """Pin the ladder at L_MAX and freeze the sensor loop: every
        admission is refused until release_hold(). In practice a drain
        ends in process shutdown and the hold is never released."""
        self.drain_hold = True
        if self.level < L_MAX:
            self._set_level(L_MAX, reason)

    def release_hold(self) -> None:
        self.drain_hold = False

    # -- visibility -------------------------------------------------------
    def snapshot(self) -> dict:
        """Full governor state for /debug/overload."""
        ing = self.runtime.ingest
        return {
            "level": self.level,
            "drain_hold": self.drain_hold,
            "ticks": self.ticks,
            "hot_streak": self._hot,
            "calm_streak": self._calm,
            "escalations": self.escalations,
            "transition_count": self.transition_count,
            "transitions": list(self.transitions),
            "rejected": dict(self.rejected),
            "dropped_capacity": ing.dropped_capacity,
            "dropped_fault": ing.dropped_fault,
            "dropped_policed": ing.dropped_policed,
            "thresholds": {
                "enter_pressure": self.enter_pressure,
                "exit_pressure": self.exit_pressure,
                "escalate_ticks": self.escalate_ticks,
                "dwell_ticks": self.dwell_ticks,
                "ingress_pps": self.ingress_pps,
                "ingress_burst": self.ingress_burst,
            },
        }

    def stats_dict(self) -> dict:
        """Light per-tick stats for the telemetry gauges (the full
        snapshot builds lists; this stays allocation-cheap)."""
        ing = self.runtime.ingest
        return {
            "level": self.level,
            "drain_hold": self.drain_hold,
            "escalations": self.escalations,
            "transitions_total": self.transition_count,
            "dropped_capacity": ing.dropped_capacity,
            "dropped_fault": ing.dropped_fault,
            "dropped_policed": ing.dropped_policed,
            "rejected": dict(self.rejected),
        }
