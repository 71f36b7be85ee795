"""Deterministic fleet-scale traffic twin.

Port of the JAX package's runtime/traffic_twin.py. Each node is the
port's node stack (service/stack.py) on `device` ("cuda" by default; an
error without a card, `device="cpu"` for the plain path): no HTTP port,
no UDP or TCP media port unless wire probes ask for one (then a UDP
transport on an ephemeral loopback port), so a node needs no aiohttp,
msgpack or PyYAML.

    python -m livekit_server_tpu_torch.runtime.traffic_twin --smoke --device cpu
    python -m livekit_server_tpu_torch.runtime.traffic_twin [--seed 20] [--ticks 120]
        [--nodes 2] [--loads 0.5,1.0,2.0,4.0] [--device cuda]

Every robustness plane in this repo — governor ladder, integrity repair,
live migration, epoch-fenced fleet ownership — was grown against a
handful of rooms with seeded point faults. The twin closes the gap to
production-shaped load: a **scenario DSL** (a dataclass timeline of
churn segments and incident events, all derived from ONE seed) is
expanded into an explicit event timeline, then replayed against real
servers — room manager → governor → pager → plane runtime → egress,
with the migration/fleet planes across a multi-node TCP bus — while the
SLO envelope is measured per offered-load step.

Determinism contract
--------------------
`build_timeline(scenario, offered_load)` is a pure function of
(scenario, offered_load): two runs at the same seed produce
byte-identical timelines (`timeline_bytes`). The replay drives VIRTUAL
time — each node's serving loop is paused and the twin calls
`step_once()` per scenario tick — and the governor is configured so only
deterministic sensors (capacity-drop deltas) classify ticks, so the
counter-derived SLOs (`SLOReport.deterministic_dict()`) are identical
across same-seed runs. Wall-clock SLOs (wire p99 via the flight
recorder) are reported alongside but excluded from that subset; they
depend on the host, not the seed.

Traffic shape
-------------
* diurnal join/leave churn: Poisson arrivals whose rate is modulated by
  a sinusoid per `ChurnSegment`;
* power-law room sizes: weighted size classes, default 80/15/5
  (tiny/medium/large) with a heavier tail available via `SizeClass`;
* regional skew: rooms land on a region sampled from `Scenario.regions`
  weights; each region maps onto one fleet node;
* codec mix: a fraction of rooms publish video (vp8 / vp9-svc mix), the
  rest are audio-only opus.

Incident catalog
----------------
* ``flash_crowd``  — regional cut followed by a reinvite/reconnect
  storm: every live session in the region resumes (reconnect=True swaps
  signal sinks without re-admission) while an arrival burst of NEW joins
  at `magnitude`× the base rate hits the same nodes and a seeded ingest
  flood (FaultInjector flood_mult) drives the governor up its ladder.
* ``regional_cut`` — all sessions in the region drop at `at`; at
  `at+ticks` the survivors' clients come back as a reconnect storm of
  fresh joins.
* ``rolling_drain`` — one node enters drain (migration orchestrator
  `drain_node()`): every room migrates off exactly once under active
  churn; joins routed at it are refused with reason ``draining``.

SLO envelope (per offered-load step)
------------------------------------
admission rate (+ denial reasons), audio continuity for probe
subscribers (unique contiguous munged SNs, exactly-once on the wire),
governor rung residency (fraction of node-ticks per ladder level),
time-to-recover per incident (ticks from incident end until every
governor is back at L0), and wire p99 from the flight recorder when
wire probes are enabled. `capacity_curve()` sweeps ≥4 offered-load
multipliers and reports the curve for the bench summary line.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from dataclasses import dataclass, field, asdict

import numpy as np

from livekit_server_tpu_torch.device import resolve

INCIDENT_KINDS = ("flash_crowd", "regional_cut", "rolling_drain")


class ScenarioError(ValueError):
    """A scenario that cannot be expanded into a timeline."""


# ---------------------------------------------------------------------------
# scenario DSL
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SizeClass:
    """One rung of the room-size power law."""

    weight: float          # relative probability mass
    lo: int                # participants, inclusive
    hi: int                # participants, inclusive


#: 80/15/5: most rooms are 1:1-ish, a few are medium, a handful are big.
DEFAULT_SIZES = (
    SizeClass(0.80, 1, 2),
    SizeClass(0.15, 3, 8),
    SizeClass(0.05, 9, 30),
)

#: Heavier tail for stress sweeps: the big rooms get bigger and likelier.
HEAVY_TAIL_SIZES = (
    SizeClass(0.70, 1, 2),
    SizeClass(0.20, 3, 10),
    SizeClass(0.10, 12, 50),
)


@dataclass(frozen=True)
class ChurnSegment:
    """A span of ticks with one arrival/departure regime."""

    ticks: int
    join_rate: float               # expected room arrivals per tick @ load 1.0
    leave_rate: float = 0.0        # per-live-room leave probability per tick
    diurnal_amplitude: float = 0.0  # 0..1 sinusoidal modulation of join_rate
    diurnal_period: int = 0         # ticks per diurnal cycle; 0 = flat


@dataclass(frozen=True)
class Incident:
    """A scripted incident anchored to the scenario clock."""

    kind: str                      # one of INCIDENT_KINDS
    at: int                        # start tick
    ticks: int                     # duration
    region: str = ""               # "" = first region
    magnitude: float = 4.0         # flood multiplier / storm burst scale


@dataclass(frozen=True)
class Scenario:
    """The whole run, reproducible from `seed` alone."""

    seed: int = 20
    segments: tuple[ChurnSegment, ...] = (
        ChurnSegment(ticks=120, join_rate=0.5, leave_rate=0.01,
                     diurnal_amplitude=0.5, diurnal_period=60),
    )
    incidents: tuple[Incident, ...] = ()
    regions: tuple[tuple[str, float], ...] = (
        ("us-east", 0.5), ("eu", 0.3), ("ap", 0.2),
    )
    sizes: tuple[SizeClass, ...] = DEFAULT_SIZES
    video_room_frac: float = 0.4   # codec mix: P(room publishes video)
    video_codecs: tuple[tuple[str, float], ...] = (
        ("vp8", 0.7), ("vp9-svc", 0.3),
    )

    @property
    def total_ticks(self) -> int:
        return sum(s.ticks for s in self.segments)

    @classmethod
    def micro(cls, seed: int = 20) -> "Scenario":
        """~2-second end-to-end smoke shape: one segment, one incident."""
        return cls(
            seed=seed,
            segments=(ChurnSegment(ticks=30, join_rate=0.6, leave_rate=0.02,
                                   diurnal_amplitude=0.3, diurnal_period=20),),
            incidents=(Incident("flash_crowd", at=10, ticks=8,
                                region="us-east", magnitude=4.0),),
            regions=(("us-east", 0.7), ("eu", 0.3)),
        )

    @classmethod
    def standard(cls, seed: int = 20, ticks: int = 120) -> "Scenario":
        """The bench shape: diurnal churn + flash crowd + rolling drain."""
        third = max(ticks // 3, 10)
        return cls(
            seed=seed,
            segments=(
                ChurnSegment(ticks=ticks, join_rate=0.8, leave_rate=0.015,
                             diurnal_amplitude=0.6, diurnal_period=ticks // 2),
            ),
            incidents=(
                Incident("flash_crowd", at=third, ticks=third // 2,
                         region="us-east", magnitude=4.0),
                Incident("rolling_drain", at=2 * third,
                         ticks=max(third // 2, 8), region="eu"),
            ),
        )


def validate_scenario(sc: Scenario) -> None:
    """Raise ScenarioError on a shape the expander cannot honor."""
    if not sc.segments:
        raise ScenarioError("scenario needs at least one churn segment")
    for seg in sc.segments:
        if seg.ticks <= 0:
            raise ScenarioError(f"segment ticks must be positive, got {seg.ticks}")
        if seg.join_rate < 0 or not 0.0 <= seg.leave_rate <= 1.0:
            raise ScenarioError("join_rate must be >= 0 and leave_rate in [0, 1]")
        if not 0.0 <= seg.diurnal_amplitude <= 1.0:
            raise ScenarioError("diurnal_amplitude must be in [0, 1]")
        if seg.diurnal_amplitude > 0 and seg.diurnal_period <= 0:
            raise ScenarioError("diurnal_period must be positive when modulated")
    if not sc.regions or abs(sum(w for _, w in sc.regions) - 1.0) > 1e-6:
        raise ScenarioError("region weights must sum to 1")
    if not sc.sizes or any(s.weight <= 0 or s.lo <= 0 or s.hi < s.lo
                           for s in sc.sizes):
        raise ScenarioError("size classes need positive weights and lo <= hi")
    if not 0.0 <= sc.video_room_frac <= 1.0:
        raise ScenarioError("video_room_frac must be in [0, 1]")
    names = {n for n, _ in sc.regions}
    total = sc.total_ticks
    for inc in sc.incidents:
        if inc.kind not in INCIDENT_KINDS:
            raise ScenarioError(
                f"unknown incident kind {inc.kind!r} "
                f"(known: {', '.join(INCIDENT_KINDS)})"
            )
        if not 0 <= inc.at < total or inc.ticks <= 0:
            raise ScenarioError(
                f"incident {inc.kind} at tick {inc.at} x{inc.ticks} falls "
                f"outside the {total}-tick scenario"
            )
        if inc.region and inc.region not in names:
            raise ScenarioError(f"incident region {inc.region!r} not in scenario")
        if inc.magnitude <= 0:
            raise ScenarioError("incident magnitude must be positive")


# ---------------------------------------------------------------------------
# timeline expansion (pure, seeded)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TwinEvent:
    """One expanded timeline entry. The canonical serialization of the
    event tuple IS the determinism contract (`timeline_bytes`)."""

    tick: int
    kind: str                  # join | leave | reconnect | incident_begin | incident_end
    room: str = ""
    region: str = ""
    participants: int = 0
    video: bool = False
    codec: str = ""
    incident: str = ""
    magnitude: float = 0.0


def _weighted(rng: np.random.Generator, pairs) -> str:
    names = [n for n, _ in pairs]
    weights = np.asarray([w for _, w in pairs], np.float64)
    return names[int(rng.choice(len(names), p=weights / weights.sum()))]


def build_timeline(
    sc: Scenario, offered_load: float = 1.0
) -> tuple[TwinEvent, ...]:
    """Expand a scenario into the explicit seeded event timeline.

    Pure in (scenario, offered_load): one `np.random.Generator` seeded
    from both drives every draw, events are emitted in a single
    deterministic pass, and nothing here reads a clock.
    """
    validate_scenario(sc)
    if offered_load <= 0:
        raise ScenarioError(f"offered_load must be positive, got {offered_load}")
    rng = np.random.default_rng([sc.seed, int(round(offered_load * 1000))])
    size_w = np.asarray([s.weight for s in sc.sizes], np.float64)
    size_w /= size_w.sum()

    events: list[TwinEvent] = []
    live: dict[str, TwinEvent] = {}    # room -> its join event (insertion order)
    room_no = 0

    def sample_room(tick: int, kind: str = "join") -> TwinEvent:
        nonlocal room_no
        cls = sc.sizes[int(rng.choice(len(sc.sizes), p=size_w))]
        video = bool(rng.random() < sc.video_room_frac)
        ev = TwinEvent(
            tick=tick, kind=kind, room=f"r{room_no:05d}",
            region=_weighted(rng, sc.regions),
            participants=int(rng.integers(cls.lo, cls.hi + 1)),
            video=video,
            codec=_weighted(rng, sc.video_codecs) if video else "opus",
        )
        room_no += 1
        return ev

    def burst_join(tick: int, region: str) -> TwinEvent:
        nonlocal room_no
        cls = sc.sizes[int(rng.choice(len(sc.sizes), p=size_w))]
        video = bool(rng.random() < sc.video_room_frac)
        ev = TwinEvent(
            tick=tick, kind="join", room=f"r{room_no:05d}", region=region,
            participants=int(rng.integers(cls.lo, cls.hi + 1)),
            video=video,
            codec=_weighted(rng, sc.video_codecs) if video else "opus",
        )
        room_no += 1
        return ev

    incidents = sorted(sc.incidents, key=lambda i: (i.at, i.kind))
    inc_region = {
        inc: (inc.region or sc.regions[0][0]) for inc in incidents
    }
    cut_rooms: dict[Incident, list[TwinEvent]] = {}

    tick = 0
    for seg in sc.segments:
        for _ in range(seg.ticks):
            # -- incident begins/ends anchored to this tick ---------------
            for inc in incidents:
                region = inc_region[inc]
                if inc.at == tick:
                    events.append(TwinEvent(
                        tick=tick, kind="incident_begin", incident=inc.kind,
                        region=region, magnitude=inc.magnitude,
                    ))
                    if inc.kind == "flash_crowd":
                        # The reinvite storm: every live session in the
                        # region resumes, spread across the window with
                        # seeded jitter (utils/backoff full-jitter analog).
                        for ev in [e for e in live.values()
                                   if e.region == region]:
                            events.append(TwinEvent(
                                tick=tick + int(rng.integers(0, max(inc.ticks // 2, 1))),
                                kind="reconnect", room=ev.room, region=region,
                                participants=ev.participants, video=ev.video,
                                codec=ev.codec,
                            ))
                    elif inc.kind == "regional_cut":
                        # Cut: the region's rooms drop now; their users
                        # come back as a storm of fresh joins at heal.
                        cut = [e for e in live.values() if e.region == region]
                        cut_rooms[inc] = cut
                        for ev in cut:
                            events.append(TwinEvent(
                                tick=tick, kind="leave", room=ev.room,
                                region=region,
                            ))
                            live.pop(ev.room, None)
                if inc.at + inc.ticks == tick:
                    events.append(TwinEvent(
                        tick=tick, kind="incident_end", incident=inc.kind,
                        region=region, magnitude=inc.magnitude,
                    ))
                    if inc.kind == "regional_cut":
                        for old in cut_rooms.get(inc, []):
                            ev = burst_join(
                                tick + int(rng.integers(0, 3)), region
                            )
                            events.append(ev)
                            live[ev.room] = ev
                # Flash-crowd window: arrival burst of NEW joins on top of
                # the base churn, magnitude x the segment rate.
                if (inc.kind == "flash_crowd"
                        and inc.at <= tick < inc.at + inc.ticks):
                    extra = rng.poisson(
                        inc.magnitude * seg.join_rate * offered_load
                    )
                    for _ in range(int(extra)):
                        ev = burst_join(tick, region)
                        events.append(ev)
                        live[ev.room] = ev

            # -- base churn ----------------------------------------------
            rate = seg.join_rate * offered_load
            if seg.diurnal_amplitude > 0:
                rate *= 1.0 + seg.diurnal_amplitude * math.sin(
                    2.0 * math.pi * tick / seg.diurnal_period
                )
            for _ in range(int(rng.poisson(max(rate, 0.0)))):
                ev = sample_room(tick)
                events.append(ev)
                live[ev.room] = ev
            if seg.leave_rate > 0 and live:
                # One vectorized draw over the (insertion-ordered) live
                # set keeps the pass O(rooms) and the order deterministic.
                names = list(live.keys())
                gone = np.nonzero(rng.random(len(names)) < seg.leave_rate)[0]
                for i in gone:
                    ev = live.pop(names[int(i)])
                    events.append(TwinEvent(
                        tick=tick, kind="leave", room=ev.room, region=ev.region,
                    ))
            tick += 1

    events.sort(key=lambda e: e.tick)   # stable: same-tick order preserved
    return tuple(events)


def timeline_bytes(events: tuple[TwinEvent, ...]) -> bytes:
    """Canonical serialization — the byte-identity determinism target."""
    return "\n".join(
        json.dumps(asdict(e), sort_keys=True, separators=(",", ":"))
        for e in events
    ).encode()


# ---------------------------------------------------------------------------
# SLO report
# ---------------------------------------------------------------------------

@dataclass
class SLOReport:
    """The measured SLO envelope of one twin run at one offered load."""

    offered_load: float = 1.0
    ticks: int = 0
    joins_offered: int = 0
    joins_admitted: int = 0
    denial_reasons: dict = field(default_factory=dict)
    rooms_peak: int = 0
    audio_expected: int = 0
    audio_received: int = 0
    audio_gaps: int = 0
    dup_wire_packets: int = 0
    rung_residency: dict = field(default_factory=dict)   # "L0".."L4" -> frac
    recovery_ticks: dict = field(default_factory=dict)   # incident -> ticks
    migrations: int = 0
    wire_p99_ms: float | None = None    # wall-clock; excluded from the
    wall_s: float = 0.0                 # deterministic subset below

    @property
    def admission_rate(self) -> float:
        return (self.joins_admitted / self.joins_offered
                if self.joins_offered else 1.0)

    @property
    def audio_continuity(self) -> float:
        return (self.audio_received / self.audio_expected
                if self.audio_expected else 1.0)

    def deterministic_dict(self) -> dict:
        """The counter-derived SLOs that must be identical across
        same-seed runs (no wall-clock terms)."""
        return {
            "offered_load": self.offered_load,
            "ticks": self.ticks,
            "joins_offered": self.joins_offered,
            "joins_admitted": self.joins_admitted,
            "admission_rate": round(self.admission_rate, 6),
            "denial_reasons": dict(sorted(self.denial_reasons.items())),
            "rooms_peak": self.rooms_peak,
            "audio_expected": self.audio_expected,
            "audio_received": self.audio_received,
            "audio_continuity": round(self.audio_continuity, 6),
            "audio_gaps": self.audio_gaps,
            "dup_wire_packets": self.dup_wire_packets,
            "rung_residency": {k: round(v, 6) for k, v in
                               sorted(self.rung_residency.items())},
            "recovery_ticks": dict(sorted(self.recovery_ticks.items())),
            "migrations": self.migrations,
        }

    def to_dict(self) -> dict:
        d = self.deterministic_dict()
        d["wire_p99_ms"] = self.wire_p99_ms
        d["wall_s"] = round(self.wall_s, 2)
        return d


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class _Probe:
    """Plane-level instrumentation of one admitted room: real tracks +
    one subscriber column, SN-contiguity bookkeeping across nodes (a
    migrated room keeps its probe — continuity must hold through the
    handoff)."""

    __slots__ = ("room", "video", "participants", "next_sn", "pushed",
                 "got", "base_sn")

    def __init__(self, room: str, video: bool, participants: int):
        self.room = room
        self.video = video
        self.participants = max(participants, 1)
        self.base_sn = 1000
        self.next_sn = self.base_sn
        self.pushed = 0
        self.got: list[int] = []


class TrafficTwin:
    """Replays a scenario timeline against a live single- or multi-node
    stack in virtual time and measures the SLO envelope."""

    def __init__(
        self,
        scenario: Scenario,
        *,
        nodes: int = 1,
        plane: dict | None = None,
        probe_every: int = 2,
        wire_probes: int = 0,
        flood_all_nodes: bool = True,
        settle_spins: int = 12,
        log=None,
        device="cuda",
    ):
        validate_scenario(scenario)
        if nodes < 1:
            raise ScenarioError("twin needs at least one node")
        self.device = resolve(device)
        self.scenario = scenario
        self.nodes = nodes
        self.plane = {"rooms": 16, "tracks_per_room": 4, "pkts_per_track": 8,
                      "subs_per_room": 4, "tick_ms": 10} | (plane or {})
        self.probe_every = max(probe_every, 1)
        self.wire_probes = wire_probes
        self.flood_all_nodes = flood_all_nodes
        self.settle_spins = settle_spins
        self.log = log or (lambda *_: None)
        self.debug: dict = {}   # filled by run(): drill-assertable state

    # -- cluster plumbing --------------------------------------------------

    def _make_config(self):
        from livekit_server_tpu_torch.config.config import load_config

        doc = {
            "keys": {"twinkey": "twinsecret"},
            "bind_addresses": ["127.0.0.1"],
            "plane": dict(self.plane),
            # No media port: nodes bind nothing a neighbour could take
            # first (wire probes attach an ephemeral UDP transport).
            "rtc": {"udp_port": 0, "tcp_port": 0},
            "room": {"empty_timeout_s": 600},
            # Virtual time: only the deterministic sensors (capacity-drop
            # deltas) classify ticks; wall-clock pressure pushed out of
            # reach, policer transparent (test_overload's flood recipe).
            "limits": {
                "governor_enabled": True,
                "governor_enter_pressure": 1e9,
                "governor_exit_pressure": 1e8,
                "governor_escalate_ticks": 3,
                "governor_dwell_ticks": 8,
                "governor_ingress_pps": 1e6,
                "governor_ingress_burst": 1e6,
            },
            # The watchdog reads wall-clock tick cadence; the twin steps
            # virtual time, so supervision must sit out.
            "supervisor": {"enabled": False},
        }
        if self.nodes > 1:
            doc["kv"] = {"lease_ttl_s": 0.8, "failover_interval_s": 0.4,
                         "stats_interval_s": 0.2}
            # fence_grace must stay under lease_ttl + failover_interval
            # and at most 2 x lease_ttl (config invariant).
            doc["fleet"] = {"fence_grace_s": 1.1}
        return load_config(base=doc, env={})

    async def _start_cluster(self, bus_srv, servers: list) -> None:
        """Start the nodes into `servers` as (stack, injector) pairs (the
        caller's `finally` stops whatever started, a failed start
        included), on a BusServer `bus_srv` when there are several."""
        from livekit_server_tpu_torch.runtime.faultinject import (
            FaultInjector,
            FaultSpec,
        )
        from livekit_server_tpu_torch.service.stack import create_stack

        if bus_srv is not None:
            await bus_srv.start("127.0.0.1", 0)
        for i in range(self.nodes):
            bus = None
            if bus_srv is not None:
                from livekit_server_tpu_torch.routing.tcpbus import TCPBusClient

                bus = await TCPBusClient.connect("127.0.0.1", bus_srv.port)
            srv = create_stack(self._make_config(), bus=bus, device=self.device)
            inj = FaultInjector(FaultSpec(
                seed=self.scenario.seed + i, flood_mult=1.0,
            ))
            servers.append((srv, inj))
            await srv.start()
            rt = srv.room_manager.runtime
            # Pause the serving loop: the twin owns virtual time and the
            # step_once() contract forbids interleaving with it.
            await rt.stop()
            rt.fault = inj
            rt.ingest.fault = inj
            if self.wire_probes:
                from livekit_server_tpu_torch.runtime.udp import start_udp_transport

                rm = srv.room_manager
                rm.attach_udp(await start_udp_transport(
                    rt.ingest, "127.0.0.1", 0, crypto=rm.crypto,
                    require_encryption=rm.config.rtc.require_encryption,
                    nack_resolver=rt.resolve_nacks,
                ))

    @staticmethod
    async def _settle(spins: int) -> None:
        """Let ready callbacks (session tasks, bus IO) run between
        virtual ticks without advancing wall-clock timers."""
        for _ in range(spins):
            await asyncio.sleep(0)

    # -- the replay --------------------------------------------------------

    async def run(self, offered_load: float = 1.0) -> SLOReport:
        from livekit_server_tpu_torch.routing.messagechannel import MessageChannel
        from livekit_server_tpu_torch.routing.tcpbus import BusServer
        from livekit_server_tpu_torch.runtime.governor import L_HEALTHY
        from livekit_server_tpu_torch.runtime.ingest import PacketIn

        events = build_timeline(self.scenario, offered_load)
        by_tick: dict[int, list[TwinEvent]] = {}
        for ev in events:
            by_tick.setdefault(ev.tick, []).append(ev)

        t0 = time.perf_counter()
        bus_srv = BusServer() if self.nodes > 1 else None
        servers: list = []
        rep = SLOReport(offered_load=offered_load,
                        ticks=self.scenario.total_ticks)
        region_node = {
            name: i % self.nodes
            for i, (name, _) in enumerate(self.scenario.regions)
        }
        sessions: dict[str, tuple] = {}     # room -> (node, req, resp, task)
        probes: dict[str, _Probe] = {}
        # (node, row) -> probe room, rebound on every (re)admission so a
        # recycled row or a migrated room keeps attributing correctly.
        row_probe: dict[tuple[int, int], str] = {}
        wire_seen: dict[tuple, int] = {}    # (room, track, sub, sn) -> count
        drain_task: asyncio.Task | None = None
        drain_ticks = 0
        step_ms: list[list[float]] = [[] for _ in range(self.nodes)]
        level_ticks: dict[int, int] = {}
        pending_recovery: dict[str, int] = {}   # incident -> end tick
        probe_count = 0

        def collector(node_idx: int):
            def on_tick(res):
                for p in res.egress:
                    room = row_probe.get((node_idx, p.room))
                    if room is None:
                        continue
                    key = (room, p.track, p.sub, p.sn)
                    wire_seen[key] = wire_seen.get(key, 0) + 1
                    if p.track == 0 and p.sub == 1:
                        pr = probes.get(room)
                        if pr is not None:
                            pr.got.append(p.sn)
            return on_tick

        wire_socks = []
        try:
            await self._start_cluster(bus_srv, servers)
            for i, (srv, _) in enumerate(servers):
                srv.room_manager.runtime.on_tick(collector(i))

            async def attempt_join(ev: TwinEvent, reconnect: bool) -> None:
                nonlocal probe_count
                node_idx = region_node.get(ev.region, 0)
                srv, _ = servers[node_idx]
                rm = srv.room_manager
                req, resp = MessageChannel(), MessageChannel()
                init = {"identity": f"{ev.room}-p0"}
                if reconnect:
                    init["reconnect"] = True
                old = sessions.pop(ev.room, None)
                task = asyncio.ensure_future(
                    rm.start_session(ev.room, init, req, resp)
                )
                sessions[ev.room] = (node_idx, req, resp, task)
                rep.joins_offered += 1
                await self._settle(self.settle_spins)
                if old is not None:
                    # The storm resumed the session (sink swap + epoch
                    # bump); the dead connection's channel closing later
                    # must be a stale-teardown no-op, which the settle
                    # above guarantees ordering for.
                    old[1].close()
                # Probe selection is eager but arming is lazy: over a real
                # TCP bus the room may not be visible yet when the settle
                # window closes (store round-trips), so the per-tick
                # ownership scan arms the probe the moment the room
                # appears — and re-arms it if a migration moves it.
                room = rm.rooms.get(ev.room)
                if ev.room not in probes and probe_count % self.probe_every == 0:
                    probes[ev.room] = _Probe(ev.room, ev.video,
                                             ev.participants)
                if room is not None and ev.room in probes:
                    self._arm_probe(srv, room, probes[ev.room], node_idx,
                                    row_probe, wire_socks)
                probe_count += 1

            async def do_leave(ev: TwinEvent) -> None:
                ses = sessions.pop(ev.room, None)
                if ses is not None:
                    _node_idx, req, _resp, _task = ses
                    req.close()
                    await self._settle(4)
                    # Delete wherever the room lives NOW — a migration
                    # may have moved it off the node that admitted it.
                    for srv, _ in servers:
                        if ev.room in srv.room_manager.rooms:
                            await srv.room_manager.delete_room(ev.room)
                probes.pop(ev.room, None)

            for tick in range(self.scenario.total_ticks):
                for ev in by_tick.get(tick, ()):  # timeline order
                    if ev.kind == "join":
                        await attempt_join(ev, reconnect=False)
                    elif ev.kind == "reconnect":
                        if ev.room in sessions:
                            await attempt_join(ev, reconnect=True)
                    elif ev.kind == "leave":
                        await do_leave(ev)
                    elif ev.kind == "incident_begin":
                        self.log(f"twin: incident {ev.incident} begins @ {tick}")
                        if ev.incident == "flash_crowd":
                            targets = (servers if self.flood_all_nodes else
                                       [servers[region_node.get(ev.region, 0)]])
                            for _, inj in targets:
                                inj.spec.flood_mult = ev.magnitude
                        elif ev.incident == "rolling_drain":
                            node_idx = region_node.get(ev.region, 0)
                            mig = servers[node_idx][0].room_manager.migration
                            if mig is not None and self.nodes > 1:
                                drain_task = asyncio.ensure_future(
                                    mig.drain_node()
                                )
                    elif ev.kind == "incident_end":
                        if ev.incident == "flash_crowd":
                            for _, inj in servers:
                                inj.spec.flood_mult = 1.0
                        pending_recovery[ev.incident] = tick

                # Probe media for this virtual tick: one audio packet per
                # probe room (+ participant-scaled video for video rooms).
                now = time.perf_counter()
                for room, pr in probes.items():
                    if room not in sessions:
                        continue
                    # Ownership scan, not the session's original node: a
                    # drain can migrate the room mid-run, and the probe
                    # (media push + wire accounting) must follow it to
                    # the survivor or the exactly-once check goes blind
                    # at the handoff.
                    owner = next(
                        ((i, srv, srv.room_manager.rooms[room])
                         for i, (srv, _) in enumerate(servers)
                         if room in srv.room_manager.rooms),
                        None,
                    )
                    if owner is None:
                        continue
                    node_idx, srv, r = owner
                    rm = srv.room_manager
                    if row_probe.get((node_idx, r.slots.row)) != room:
                        self._arm_probe(srv, r, pr, node_idx, row_probe,
                                        wire_socks)
                    rm.runtime.ingest.push(PacketIn(
                        room=r.slots.row, track=0, sn=pr.next_sn,
                        ts=960 * (pr.next_sn - pr.base_sn), size=40,
                        payload=b"a",
                    ), t_rx=now)
                    pr.next_sn += 1
                    pr.pushed += 1
                    if pr.video:
                        for j in range(min(pr.participants, 3)):
                            rm.runtime.ingest.push(PacketIn(
                                room=r.slots.row, track=1,
                                sn=50_000 + pr.pushed * 4 + j,
                                ts=3000 * pr.pushed, size=400, payload=b"v",
                                keyframe=True, layer_sync=True,
                                begin_pic=True, marker=True,
                            ), t_rx=now)

                for i, (srv, _) in enumerate(servers):
                    rt = srv.room_manager.runtime
                    s0 = time.perf_counter()
                    await rt.step_once()
                    step_ms[i].append((time.perf_counter() - s0) * 1e3)
                    gov = srv.room_manager.governor
                    lvl = gov.level if gov is not None else 0
                    level_ticks[lvl] = level_ticks.get(lvl, 0) + 1
                await self._settle(4)

                # Recovery clock: ticks from incident end until every
                # governor is back at L0.
                done = []
                for inc, end_tick in pending_recovery.items():
                    # A drain-held governor is pinned at L4 by design for
                    # the node's remaining life — it can't "recover" and
                    # must not mask the fleet's recovery clock.
                    if all((srv.room_manager.governor is None
                            or srv.room_manager.governor.drain_hold
                            or srv.room_manager.governor.level == L_HEALTHY)
                           for srv, _ in servers):
                        rep.recovery_ticks[inc] = tick - end_tick
                        done.append(inc)
                for inc in done:
                    pending_recovery.pop(inc)

                rep.rooms_peak = max(
                    rep.rooms_peak,
                    sum(len(srv.room_manager.rooms) for srv, _ in servers),
                )

            if drain_task is not None:
                # Keep virtual time flowing while the drain finishes: the
                # migration protocol may need plane ticks on both ends to
                # flush before it commits.
                for _ in range(200):
                    if drain_task.done():
                        break
                    for srv, _ in servers:
                        await srv.room_manager.runtime.step_once()
                    drain_ticks += 1
                    await self._settle(8)
                await asyncio.wait_for(drain_task, timeout=30)
            # A few settle ticks so in-flight egress (bridged packets,
            # final fan-out) lands before the books close.
            for _ in range(3):
                for srv, _ in servers:
                    await srv.room_manager.runtime.step_once()
                await self._settle(4)
            for inc, _end in pending_recovery.items():
                rep.recovery_ticks.setdefault(inc, -1)   # never recovered

            # -- close the books ------------------------------------------
            for srv, _ in servers:
                rm = srv.room_manager
                for reason, n in getattr(
                    rm, "admission_denied_reasons", {}
                ).items():
                    rep.denial_reasons[reason] = (
                        rep.denial_reasons.get(reason, 0) + n
                    )
                if rm.migration is not None:
                    rep.migrations += rm.migration.stats.get("commits", 0)
            denied = sum(rep.denial_reasons.values())
            rep.joins_admitted = max(rep.joins_offered - denied, 0)

            for pr in probes.values():
                rep.audio_expected += pr.pushed
                uniq = sorted(set(pr.got))
                rep.audio_received += len(uniq)
                rep.audio_gaps += sum(
                    1 for a, b in zip(uniq, uniq[1:]) if b - a != 1
                )
            rep.dup_wire_packets = sum(
                n - 1 for n in wire_seen.values() if n > 1
            )
            total_lvl = sum(level_ticks.values()) or 1
            rep.rung_residency = {
                f"L{lvl}": n / total_lvl for lvl, n in level_ticks.items()
            }
            if self.wire_probes:
                probes_p99 = [
                    srv.room_manager.udp.fwd_latency.summary()
                    for srv, _ in servers
                    if srv.room_manager.udp is not None
                ]
                samples = [(s["p99_ms"], s["n"]) for s in probes_p99 if s["n"]]
                if samples:
                    rep.wire_p99_ms = max(p for p, _ in samples)
            # Cross-plane drill snapshot, captured before teardown: the
            # tier-1 drills assert on ladder order, migration accounting,
            # and where load landed — state the servers take with them.
            self.debug = {
                "governor_transitions": [
                    [dict(t) for t in srv.room_manager.governor.transitions]
                    if srv.room_manager.governor is not None else []
                    for srv, _ in servers
                ],
                "migration_stats": [
                    dict(srv.room_manager.migration.stats)
                    if srv.room_manager.migration is not None else {}
                    for srv, _ in servers
                ],
                "rooms_final": [
                    sorted(srv.room_manager.rooms) for srv, _ in servers
                ],
                "denied_by_node": [
                    dict(getattr(srv.room_manager,
                                 "admission_denied_reasons", {}))
                    for srv, _ in servers
                ],
                # What the card phase reads beside the SLOs: each node's
                # completed steps (its warm step included) and wall ms of
                # each scenario tick's step_once, the ticks the drain ran
                # past the scenario, and each node's tick-span ring.
                "steps": [srv.room_manager.runtime.stats["ticks"]
                          for srv, _ in servers],
                "step_ms": step_ms,
                "drain_ticks": drain_ticks,
                "trace": [srv.room_manager.runtime.trace.snapshot()
                          if srv.room_manager.runtime.trace is not None else []
                          for srv, _ in servers],
                # build-ledger entries since each node's warm-up watermark
                # (runtime/compile_ledger.py): 0 in steady state
                "post_warm_builds": [srv.room_manager.runtime.post_warm_builds
                                     for srv, _ in servers],
            }
            rep.wall_s = time.perf_counter() - t0
            return rep
        finally:
            # Drain sessions while the bus is still alive: a worker whose
            # teardown does store ops against a closed bus spends the
            # retry policy's full budget timing out.
            for _n, req, _resp, _task in list(sessions.values()):
                try:
                    req.close()
                except Exception:  # noqa: BLE001
                    pass
            live = [t for *_x, t in sessions.values() if not t.done()]
            if live:
                await asyncio.wait(live, timeout=5)
                for t in live:
                    if not t.done():
                        t.cancel()
            for s in wire_socks:
                try:
                    s.close()
                except OSError:
                    pass
            for srv, _ in servers:
                try:
                    await srv.stop(force=True)
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
                bus = getattr(srv.router, "bus", None)
                if bus is not None:
                    # No reconnect loop outlives the run (a sweep runs
                    # several clusters in one event loop).
                    await bus.close()
            if bus_srv is not None:
                bus_srv.close()

    def _arm_probe(self, srv, room, pr: _Probe, node_idx: int,
                   row_probe: dict, wire_socks: list) -> None:
        """Attach plane tracks/subscription + optional wire sink for one
        probe room on whichever node currently owns it."""
        rt = srv.room_manager.runtime
        row = room.slots.row
        rt.set_track(row, 0, published=True, is_video=False)
        rt.set_subscription(row, 0, 1, subscribed=True)
        if pr.video:
            rt.set_track(row, 1, published=True, is_video=True)
            rt.set_subscription(row, 1, 1, subscribed=True)
        row_probe[(node_idx, row)] = pr.room
        udp = srv.room_manager.udp
        if (self.wire_probes and udp is not None
                and len(wire_socks) < self.wire_probes):
            import socket

            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            s.setblocking(False)
            udp.register_subscriber(row, 1, s.getsockname())
            wire_socks.append(s)


# ---------------------------------------------------------------------------
# capacity curve (the bench entrypoint)
# ---------------------------------------------------------------------------

async def capacity_curve(
    scenario: Scenario,
    loads: tuple[float, ...] = (0.5, 1.0, 2.0, 4.0),
    *,
    nodes: int = 2,
    plane: dict | None = None,
    wire_probes: int = 0,
    log=None,
    on_step=None,
    on_run=None,
    device="cuda",
) -> dict:
    """Run the scenario at each offered-load multiplier (fresh cluster per
    step — no state bleed between points) on `device` and report the
    capacity/SLO curve for the bench summary. `on_step(partial_steps)`
    fires after each load so a caller under a deadline can emit
    incrementally; `on_run(twin, report)` after each run, with the twin's
    `debug` (per-node state) filled."""
    if len(loads) < 4:
        raise ScenarioError("capacity curve needs >= 4 offered-load steps")
    steps = []
    for load in loads:
        twin = TrafficTwin(scenario, nodes=nodes, plane=plane,
                           wire_probes=wire_probes, log=log, device=device)
        rep = await twin.run(load)
        if on_run:
            on_run(twin, rep)
        steps.append(rep.to_dict())
        if log:
            log(f"twin: load x{load}: admission "
                f"{rep.admission_rate:.3f}, continuity "
                f"{rep.audio_continuity:.3f}, residency {rep.rung_residency}")
        if on_step:
            on_step(list(steps))
    knee = next(
        (s["offered_load"] for s in steps if s["admission_rate"] < 0.999),
        None,
    )
    return {
        "seed": scenario.seed,
        "loads": list(loads),
        "steps": steps,
        "capacity_knee_load": knee,
    }


def run_micro_smoke(seed: int = 20, device="cuda") -> dict:
    """The ~2-second end-to-end micro-scenario (`--smoke`): single node,
    tiny pool, one churn segment, one flash-crowd incident, on
    `device`."""
    sc = Scenario.micro(seed)
    twin = TrafficTwin(
        sc, nodes=1,
        plane={"rooms": 8, "tracks_per_room": 4, "pkts_per_track": 8,
               "subs_per_room": 4, "tick_ms": 10},
        probe_every=2, device=device,
    )
    rep = asyncio.run(twin.run(1.0))
    out = rep.to_dict()
    out["ok"] = (
        rep.audio_gaps == 0
        and rep.dup_wire_packets == 0
        and rep.joins_admitted > 0
    )
    return out


def scenario_from_config(twin_cfg) -> Scenario:
    """Build the bench scenario from the `twin.*` config block (so the
    knobs in config-sample.yaml are load-bearing, not decorative)."""
    sc = Scenario.standard(seed=twin_cfg.seed, ticks=twin_cfg.ticks)
    sc = Scenario(
        seed=sc.seed, segments=sc.segments, incidents=sc.incidents,
        regions=sc.regions, sizes=sc.sizes,
        video_room_frac=twin_cfg.video_room_frac,
        video_codecs=sc.video_codecs,
    )
    validate_scenario(sc)
    return sc


def main(argv=None) -> int:
    """The twin's CLI: `--smoke` runs the micro-scenario, otherwise the
    capacity curve of `Scenario.standard` over `--loads`, on `--device`.

    Prints progress to stderr and exactly one JSON object line to stdout
    LAST (after each load step, a partial line of the steps so far), the
    shape `bench.absorb_twin_json` reads: a reader keeps the final
    `{`-prefixed stdout line.
    """
    import argparse
    import sys

    ap = argparse.ArgumentParser(prog="traffic_twin")
    ap.add_argument("--smoke", action="store_true",
                    help="run the ~2s micro-scenario once and exit")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--loads", type=str, default="0.5,1.0,2.0,4.0")
    ap.add_argument("--wire-probes", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the nodes' plane device (cpu for the plain path)")
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    if args.smoke:
        out = run_micro_smoke(seed=args.seed, device=args.device)
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1

    loads = tuple(float(x) for x in args.loads.split(",") if x.strip())
    sc = Scenario.standard(seed=args.seed, ticks=args.ticks)
    validate_scenario(sc)

    def on_step(partial):
        # Incremental emission: a deadline kill loses at most the load
        # step in flight (the bench keeps the last complete JSON line).
        print(json.dumps({"seed": sc.seed, "loads": list(loads),
                          "steps": partial, "partial": True}), flush=True)

    curve = asyncio.run(capacity_curve(
        sc, loads, nodes=args.nodes,
        plane={"rooms": 16, "tracks_per_room": 4, "pkts_per_track": 8,
               "subs_per_room": 4, "tick_ms": 10},
        wire_probes=args.wire_probes, log=log, on_step=on_step,
        device=args.device,
    ))
    print(json.dumps(curve), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
