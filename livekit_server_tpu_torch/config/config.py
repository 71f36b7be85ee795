"""Typed config schema with YAML/env/CLI merging.

Reference parity: pkg/config/config.go:57-946. The reference's notable
mechanism — CLI flags generated from the YAML schema via reflection so
every key is settable by flag or env (GenerateCLIFlags,
cmd/server/main.go:126-135) — is reproduced here over dataclasses:
`generate_cli_flags` walks the schema and registers `--rtc.tick-ms`-style
flags; env vars use `LIVEKIT_`-prefixed upper-snake paths; strict mode
rejects unknown YAML keys (main.go:197-200).

Media-plane section: `plane` (tick sizing, tensor capacities, mesh) —
the knobs of the batched media plane that replace the reference's
per-goroutine tuning.

A copy of the JAX package's config/config.py, same schema and same
defaults. `yaml` is imported only by the YAML loader, so `Config()` and
its validation load where PyYAML is not installed. `UNPORTED` lists the
subsystems the port does not carry yet; RoomManager refuses a config
that enables one of them (`check_ported`), and `port_overlay()` is the
setting that turns each of them off.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Callable, get_args, get_origin


class ConfigError(Exception):
    pass


@dataclass
class RegionConfig:
    name: str = ""
    lat: float = 0.0
    lon: float = 0.0


@dataclass
class NodeSelectorConfig:
    """pkg/routing/selector — room placement policy."""

    kind: str = "any"            # any | cpuload | sysload | regionaware
    sort_by: str = "random"      # random | sysload | cpuload | rooms
    cpu_load_limit: float = 0.9  # cpuload.go CPULoadLimit
    sysload_limit: float = 0.9   # sysload.go
    regions: list[RegionConfig] = field(default_factory=list)


@dataclass
class AudioConfig:
    """pkg/config/config.go AudioConfig — active speaker tuning."""

    active_level: int = 35
    min_percentile: int = 40
    update_interval_ms: int = 500
    smooth_intervals: int = 2


@dataclass
class BWEConfig:
    """CongestionControlConfig (config.go) — stream allocator tuning."""

    enabled: bool = True
    allow_pause: bool = False
    nack_ratio_threshold: float = 0.08
    nack_window_min_packets: int = 10
    estimate_required_downgrades: int = 3
    min_channel_capacity: float = 100_000.0
    probe_interval_ms: int = 5000
    # Send-side delay-based estimation over transport-wide feedback (the
    # TWCC seat; transport.go cc.BandwidthEstimator). Off ⇒ allocation
    # budgets come only from client-volunteered estimate samples.
    send_side_bwe: bool = True


@dataclass
class RTCConfig:
    """pkg/config RTCConfig — transport + media-plane edges."""

    udp_port: int = 7882
    # "" = burst each tick; "no-queue" spreads sendmmsg chunks across
    # half the tick (pkg/sfu/pacer seat — shaping without a queue).
    pacer: str = ""
    tcp_port: int = 7881
    require_encryption: bool = True   # drop cleartext media datagrams; the
                                      # sealed AEAD wire (runtime/crypto.py)
                                      # is the DTLS-SRTP seat
    port_range_start: int = 50000
    port_range_end: int = 60000
    use_external_ip: bool = False
    node_ip: str = ""
    stun_servers: list[str] = field(default_factory=list)
    pli_throttle_ms: int = 500         # PLIThrottleConfig
    congestion_control: BWEConfig = field(default_factory=BWEConfig)


@dataclass
class RoomConfig:
    """pkg/config RoomConfig."""

    auto_create: bool = True
    empty_timeout_s: int = 300
    departure_timeout_s: int = 20
    max_participants: int = 0
    enabled_codecs: list[str] = field(
        default_factory=lambda: [
            "audio/opus",
            "audio/red",
            "video/vp8",
            "video/h264",
            "video/vp9",
            "video/av1",
        ]
    )
    max_metadata_size: int = 0
    playout_delay_min_ms: int = 0
    playout_delay_max_ms: int = 0


@dataclass
class LimitsConfig:
    """config.go LimitConfig — node admission limits, plus the overload
    governor (runtime/governor.py) that closes the loop from tick
    telemetry to load shedding. Admission limits default to 0 =
    unlimited; the governor defaults ON (L4 still only engages under
    sustained measured overload)."""

    num_tracks: int = 0          # 0 = unlimited
    bytes_per_sec: float = 0.0
    subscription_limit_video: int = 0
    subscription_limit_audio: int = 0
    max_rooms: int = 0
    # Node-level ingress packet rate: joins/publishes are refused while
    # the measured rate (router stats heartbeat) exceeds this. 0 = off.
    packets_per_sec: float = 0.0
    # Overload governor: degradation ladder L1 clamp spatial layers →
    # L2 police video ingress → L3 pause non-pinned video → L4 reject
    # new work. Escalates after `escalate_ticks` consecutive pressured
    # ticks (late / stalled / capacity-dropping / work ratio ≥ enter);
    # de-escalates one level per `dwell_ticks` consecutive calm ticks
    # (work ratio ≤ exit) — enter/exit split + dwell are the hysteresis.
    governor_enabled: bool = True
    governor_enter_pressure: float = 0.85   # work ratio entering overload
    governor_exit_pressure: float = 0.55    # work ratio counting as calm
    governor_escalate_ticks: int = 20
    governor_dwell_ticks: int = 150
    # L2 token buckets: per-(room, track) video packets/sec + burst.
    governor_ingress_pps: float = 400.0
    governor_ingress_burst: float = 100.0


@dataclass
class PlaneConfig:
    """Media-plane sizing (no reference equivalent — replaces goroutine
    tuning like receiver.go lbThreshold with tensor capacities)."""

    tick_ms: int = 10
    rooms: int = 64              # room rows per shard
    tracks_per_room: int = 16
    pkts_per_track: int = 16     # packet slots per track per tick
    subs_per_room: int = 32
    mesh_devices: int = 0        # 0 = all local devices
    donate_state: bool = True
    # Complete each tick's egress before starting the next tick instead of
    # overlapping it with the next device step: ~1 tick lower forward
    # latency, at the cost of the wall budget being the SUM of device +
    # host egress instead of their max. Worth it when both fit the tick.
    low_latency: bool = False
    # Express lane (two-tier latency plane): rooms with at most this many
    # subscribers forward on packet ARRIVAL from the last device selector
    # mirror (≤1-tick-stale, bit-equivalent decisions) instead of waiting
    # for the batched tick — wire latency becomes receive-loop latency.
    # 0 disables the lane; rooms above the bound ride the batched tick.
    # PlaneRuntime.set_express_pin overrides per room in either direction.
    express_max_subs: int = 0
    # Hard cap on rooms simultaneously on the express lane (arrival-path
    # work is per-room; bound it so a flood of small rooms cannot starve
    # the tick loop). Only meaningful when express_max_subs > 0.
    express_max_rooms: int = 16
    # Paged room state (runtime/pager.py): carve device state out of one
    # pooled device buffer in (pager_tpage × pager_spage) track×sub pages
    # per room instead of a dense [rooms, tracks, subs] box, so small
    # rooms stop paying the worst-case footprint. Both page dims must be
    # pow2 divisors of tracks_per_room / subs_per_room (spage also ≤ 32
    # and dividing 32 — the selector's sub bitmask lane). pager_pool_pages
    # sizes the pool (pow2; 0 = rooms × max pages per room, i.e. dense-
    # equivalent capacity — useful for parity runs, pointless in prod).
    pager_enabled: bool = False
    pager_tpage: int = 4
    pager_spage: int = 8
    pager_pool_pages: int = 0
    # Ragged-aware pooled-tick kernel (ops/paged_kernel.py): iterate the
    # LIVE pages only — one kernel block step per mapped page, dead pages
    # never scheduled — fusing the forward decide + stats routing (+ the
    # audio mix) into one pass. "auto" and "on" = the live-extent path
    # (the CUDA kernel on a card, its plain version on the CPU); "off" =
    # stock full-pool tick. The schema also accepts "interpret", the
    # reference's interpreter mode, which the port's runtime refuses.
    paged_kernel: str = "auto"


@dataclass
class EgressConfig:
    """Sharded native egress plane (runtime/egress_plane.py): per-core
    shards of the munge→assemble→seal→send walk, with multicast-shaped
    canonical staging for high-subscriber fan-out."""

    # Worker shards for the native egress/munge walk. 0 = auto
    # (min(8, cpu cores)); 1 pins everything inline on the caller thread.
    shards: int = 0
    # Stage each (room, track, packet) group's canonical datagram once and
    # patch per-subscriber headers from it, instead of re-gathering payload
    # + extensions per subscriber (P3FA-style constrained multicast).
    # Sealing still runs per datagram — each has a unique counter/nonce.
    multicast_seal: bool = True


@dataclass
class KeyValueConfig:
    """Shared KV for multi-node state (the reference's Redis seat,
    redisrouter.go / redisstore.go). kind=memory keeps single-node mode
    dependency-free (the reference's LocalRouter/LocalStore path)."""

    kind: str = "memory"         # memory | tcp (in-repo BusServer)
    address: str = ""            # host:port for kind=tcp
    auth_token: str = ""         # shared secret for the tcp bus (Redis AUTH seat)
    # Node liveness lease (routing/router.py): refreshed with each stats
    # heartbeat; expiry marks the node dead far faster than the 30 s
    # registry staleness window, triggering room failover.
    lease_ttl_s: float = 6.0
    # Cadence of the surviving nodes' dead-pin scan (room failover).
    failover_interval_s: float = 2.0
    # Heartbeat/lease refresh cadence (the stats worker's sleep). Must
    # divide comfortably into lease_ttl_s: the lease survives a couple
    # of missed refreshes, and the fleet plane's fence_grace timeline is
    # quantized by it.
    stats_interval_s: float = 2.0


@dataclass
class SupervisorConfig:
    """Media-plane supervision (runtime/supervisor.py): tick watchdog +
    bounded restart-from-snapshot. Enabled by default — the failure story
    must hold on the default config path."""

    enabled: bool = True
    # Watchdog stall deadline: no tick progress for this long while the
    # serving loop runs ⇒ restart from the last checkpoint.
    tick_deadline_ms: int = 1000
    # Relaxed deadline until the FIRST tick after a (re)start completes:
    # a cold kernel build can block that tick for many seconds, and
    # restarting mid-compile both loses the in-flight tick and abandons
    # a worker thread mid-compilation. Tradeoff: a dispatch that hangs at
    # startup takes this long to catch.
    warmup_deadline_s: float = 30.0
    check_interval_ms: int = 100
    # Full-plane + per-room checkpoint cadence (restart/failover rewind
    # is bounded by this).
    checkpoint_interval_s: float = 2.0
    max_restarts: int = 5            # consecutive, without regaining health
    restart_backoff_base_s: float = 0.1
    restart_backoff_max_s: float = 5.0
    # Stall-deadline multiplier while the overload governor is engaged:
    # "overloaded but making progress" must shed load, not restart.
    overload_grace: float = 5.0


@dataclass
class MigrationConfig:
    """Live room migration plane (service/migration.py): two-phase
    PREPARE/ACK/COMMIT handoff over the bus with rollback, freeze-window
    packet bridging, and governed node drain. Needs a shared bus
    (kv.kind=tcp or an injected MemoryBus) — single-node memory mode
    constructs no orchestrator."""

    enabled: bool = True
    # TTL of the `room_snapshot:` key written by the NON-orchestrated
    # handoff path (handoff_room) — how long an unpinned snapshot waits
    # for some node's get_or_create_room to adopt it.
    snapshot_ttl_s: float = 120.0
    # Source-side wait for the target's ACK/NACK per PREPARE attempt.
    # Each timed-out epoch is aborted before the retry re-sends.
    ack_timeout_s: float = 2.0
    # PREPARE retries per target candidate (utils.backoff.retry_async).
    retry_attempts: int = 3
    retry_backoff_base_s: float = 0.1
    retry_backoff_max_s: float = 1.0
    # Rooms migrated concurrently during a node drain.
    drain_concurrency: int = 4
    # Target-side: an adoption whose COMMIT never arrives (source died,
    # bus severed mid-handoff) is released after this long — the device
    # row must not leak.
    adopt_ttl_s: float = 10.0
    # Freeze-window bridge bound (packets). Audio always wins a slot:
    # at budget the oldest buffered VIDEO packet is evicted first.
    bridge_max_packets: int = 512
    # Packets per BRIDGE bus message when flushing to the target.
    bridge_chunk: int = 64


@dataclass
class FaultInjectConfig:
    """Deterministic fault injection (runtime/faultinject.py). OFF by
    default: the default config path constructs no injector — these knobs
    exist so chaos tests and soak runs share one seeded mechanism."""

    enabled: bool = False
    seed: int = 0
    drop_pct: float = 0.0        # P(drop) per ingest packet
    dup_pct: float = 0.0         # P(duplicate) per ingest packet
    delay_pct: float = 0.0       # P(delay) per ingest packet
    delay_ticks: int = 2         # delayed packets re-enter after N ticks
    stall_every: int = 0         # every Nth device step stalls (0 = never)
    stall_s: float = 0.0
    # Flood mode: offered-load multiplier (extra staged copies per
    # arriving packet; <= 1.0 = off) for reproducible overload.
    flood_mult: float = 1.0
    flood_rooms: list[int] = field(default_factory=list)  # [] = all rooms
    # Silent-data-corruption mode: flip bits in one room's slice of a
    # PlaneState leaf right before the device step at a chosen tick
    # (-1 = never). Drives the integrity detect→quarantine→repair ladder.
    bitflip_tick: int = -1
    bitflip_room: int = 0
    bitflip_leaf: str = "temporal_bytes"   # dotted path into PlaneState
    bitflip_bit: int = 30                  # bit index within each element
    bitflip_count: int = 1                 # elements flipped in the row
    # Damage every Nth serialized checkpoint frame (0 = never): exercises
    # checksum verification + generation fallback on restore.
    corrupt_ckpt_every: int = 0
    # Migration chaos drills (service/migration.py). Target-side:
    # adopt the PREPARE'd room, then go silent — never ACK (the
    # "target died mid-PREPARE" drill; source must time out + roll
    # back, target must reap the row).
    mig_drop_prepare: bool = False
    # Target-side: sleep this long before ACKing — past ack_timeout_s
    # the source has already aborted the epoch, so the late ACK must
    # be ignored by the epoch guard (no double-commit).
    mig_ack_delay_s: float = 0.0
    # Source-side: damage the encoded snapshot inside PREPARE; the
    # target's checksum verification must NACK, source rolls back.
    mig_corrupt_handoff: bool = False
    # Source-side: the first N commit phases raise ConnectionError on
    # their bus ops (the "bus severed mid-handoff" drill).
    mig_sever_handoffs: int = 0
    # Bus-partition drills (BusServer.set_partition via the injector's
    # bus_partition_tick seam). Groups are lists of node ids; group 0
    # keeps the bus, later groups are severed (every KV op errors, every
    # pub/sub push is skipped) — the minority side of a split-brain.
    bus_partition_groups: list = field(default_factory=list)
    # Tick to install the partition at / heal it at (-1 = never).
    bus_partition_tick: int = -1
    bus_heal_at_tick: int = -1
    # (src, dst) node-id pairs whose pushes are held during the
    # partition and delivered IN ORDER on heal — the stale-message-
    # after-heal drill (e.g. a migration COMMIT outliving its epoch).
    bus_asym_pairs: list = field(default_factory=list)


@dataclass
class FleetConfig:
    """Partition-tolerant fleet plane (routing/fleet.py +
    service/fleetplane.py): epoch-fenced room ownership, self-fencing on
    lease loss, elected failover and the load rebalancer."""

    enabled: bool = True
    # A node whose liveness lease goes unrefreshed this long self-fences
    # (mutes egress, freezes checkpoints, denies admissions, quiesces
    # supervisor restarts). Validated against the takeover timeline:
    # must stay BELOW kv.lease_ttl_s + kv.failover_interval_s (fence
    # before any survivor can finish a takeover) and at most
    # 2 x kv.lease_ttl_s (a transient blip must not mute a node long).
    fence_grace_s: float = 6.0
    # TTL of the `fleet_restore:{room}` create-lock electing a failover
    # restorer; a crashed winner's lock lapses after this.
    restore_lock_ttl_s: float = 10.0
    # Load rebalancer (default-off): drain the hottest node via live
    # migration when its plane load exceeds the fleet mean by headroom.
    rebalance_enabled: bool = False
    rebalance_interval_s: float = 10.0
    rebalance_headroom: float = 0.25
    rebalance_max_moves: int = 1


@dataclass
class IntegrityConfig:
    """State-integrity plane (runtime/integrity.py): on-device invariant
    audits on a tick cadence, row-level quarantine + repair from the last
    verified checkpoint, bounded escalation to a supervisor restart."""

    enabled: bool = True
    # Audit every Nth tick: one reduction over the plane state on the
    # device, right after the tick commits; N bounds detection latency to
    # N ticks. Its cost on the card beside the tick it rides on is
    # measured by chip_smoke.py's failure phase (PERF.md).
    audit_every_ticks: int = 16
    # Row-repair attempts per room before escalating to a full plane
    # restart (attempts reset once the room audits clean).
    max_row_repairs: int = 3
    # More rooms than this flagged by ONE audit ⇒ the corruption is not
    # row-local (bad upload, poisoned kernel): skip row repair, restart.
    storm_threshold: int = 4
    # Verified checkpoint generations the supervisor retains; corrupt
    # frames fall back a generation at restore.
    checkpoint_generations: int = 3


@dataclass
class RelayConfig:
    """Embedded media relay (pkg/service/turn.go seat): a separately
    addressable UDP hop for clients whose direct path to rtc.udp_port is
    blocked. Blind forwarding — media stays AEAD-sealed end-to-end."""

    enabled: bool = False
    udp_port: int = 7885
    external_host: str = ""      # address advertised to clients; "" = bind addr
    allocation_ttl_s: int = 30
    max_allocations: int = 4096


@dataclass
class WebHookConfig:
    """config.go WebHookConfig."""

    urls: list[str] = field(default_factory=list)
    api_key: str = ""


@dataclass
class TraceConfig:
    """Flight-recorder tracing plane (runtime/trace.py): per-tick span
    ring, sampled wire-latency attribution, and the per-room black-box
    event recorder. Always-on by design — the defaults are sized for a
    bounded (<2%) tick-time overhead."""

    enabled: bool = True
    ring_ticks: int = 512        # tick-span ring capacity (/debug/trace window)
    sample_every: int = 64       # 1-in-K deterministic packet latency sample
    blackbox_events: int = 64    # per-room black-box ring length


@dataclass
class TwinConfig:
    """Traffic-twin scenario knobs (runtime/traffic_twin.py): the
    deterministic fleet-scale load harness behind `bench.py fleet_twin`
    and `tools/check --twin-smoke`. All randomness derives from `seed`;
    two runs with the same knobs produce byte-identical event timelines
    and identical counter-derived SLO numbers."""

    enabled: bool = False        # opt-in: the twin is a harness, not a serving path
    seed: int = 20
    nodes: int = 2               # fleet size replayed against (>=2 for drain)
    ticks: int = 120             # scenario length in virtual ticks
    # Offered-load multipliers for the capacity/SLO curve (>= 4 steps).
    loads: list[float] = field(default_factory=lambda: [0.5, 1.0, 2.0, 4.0])
    video_room_frac: float = 0.4  # codec mix: P(room publishes video)
    probe_every: int = 2          # every Nth admitted room carries SLO probes
    wire_probes: int = 0          # real UDP probe subscribers (wire p99 feed)


@dataclass
class Config:
    """Top-level server config (pkg/config/config.go Config)."""

    bind_addresses: list[str] = field(default_factory=lambda: ["127.0.0.1"])
    port: int = 7880
    prometheus_port: int = 0
    region: str = ""
    keys: dict[str, str] = field(default_factory=dict)
    log_level: str = "info"
    development: bool = False
    rtc: RTCConfig = field(default_factory=RTCConfig)
    room: RoomConfig = field(default_factory=RoomConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    limits: LimitsConfig = field(default_factory=LimitsConfig)
    node_selector: NodeSelectorConfig = field(default_factory=NodeSelectorConfig)
    plane: PlaneConfig = field(default_factory=PlaneConfig)
    egress: EgressConfig = field(default_factory=EgressConfig)
    kv: KeyValueConfig = field(default_factory=KeyValueConfig)
    relay: RelayConfig = field(default_factory=RelayConfig)
    webhook: WebHookConfig = field(default_factory=WebHookConfig)
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    faults: FaultInjectConfig = field(default_factory=FaultInjectConfig)
    integrity: IntegrityConfig = field(default_factory=IntegrityConfig)
    migration: MigrationConfig = field(default_factory=MigrationConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    twin: TwinConfig = field(default_factory=TwinConfig)


_SCALARS = (int, float, str, bool)


def _merge_into(obj: Any, data: dict, path: str = "") -> None:
    """Strict recursive merge of a dict into a dataclass tree."""
    names = {f.name: f for f in dataclasses.fields(obj)}
    for k, v in data.items():
        key = k.replace("-", "_")
        if key not in names:
            raise ConfigError(f"unknown config key: {path + k}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v, path + k + ".")
        elif isinstance(cur, list) and names[key].type == "list[RegionConfig]":
            setattr(obj, key, [RegionConfig(**r) for r in v])
        else:
            setattr(obj, key, _coerce(cur, v, path + k))


def _coerce(cur: Any, v: Any, path: str) -> Any:
    if isinstance(cur, bool):
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes", "on")
        return bool(v)
    if isinstance(cur, int) and not isinstance(cur, bool):
        return int(v)
    if isinstance(cur, float):
        return float(v)
    if isinstance(cur, str):
        return str(v)
    return v


def _walk_scalars(obj: Any, prefix: str = ""):
    """Yield (dotted_path, field, current_value) for every scalar/list leaf."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        p = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _walk_scalars(v, p + ".")
        else:
            yield p, f, v


def generate_cli_flags(parser, config: Config | None = None) -> None:
    """Register every config leaf as a CLI flag (GenerateCLIFlags analog).

    Dotted paths become flags: plane.tick_ms -> --plane.tick-ms.
    """
    config = config or Config()
    for path, _f, v in _walk_scalars(config):
        flag = "--" + path.replace("_", "-")
        if isinstance(v, bool):
            parser.add_argument(flag, type=str, default=None, metavar="BOOL")
        elif isinstance(v, (int, float)):
            parser.add_argument(flag, type=type(v), default=None)
        elif isinstance(v, str):
            parser.add_argument(flag, type=str, default=None)
        elif isinstance(v, list):
            parser.add_argument(flag, type=str, default=None, metavar="CSV")
        elif isinstance(v, dict):
            parser.add_argument(flag, type=str, default=None, metavar="K:V,K:V")


def _apply_path(cfg: Config, path: str, raw: Any) -> None:
    parts = path.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    cur = getattr(obj, parts[-1])
    if isinstance(cur, list):
        raw = [s for s in str(raw).split(",") if s]
    elif isinstance(cur, dict):
        raw = dict(kv.split(":", 1) for kv in str(raw).split(",") if ":" in kv)
    setattr(obj, parts[-1], _coerce(cur, raw, path))


ENV_PREFIX = "LIVEKIT_"


def load_config(
    yaml_text: str | None = None,
    yaml_path: str | None = None,
    cli_args: Any = None,
    env: dict[str, str] | None = None,
    base: dict | None = None,
) -> Config:
    """YAML < env < CLI precedence (main.go getConfig order). `base`, a
    nested mapping in the YAML's shape, is merged first, under the YAML
    (the port's CLI passes its dev settings and `port_overlay()` here, so
    they need no YAML parser)."""
    cfg = Config()
    if base:
        _merge_into(cfg, base)
    if yaml_path:
        with open(yaml_path) as f:
            yaml_text = f.read()
    if yaml_text:
        import yaml

        data = yaml.safe_load(yaml_text) or {}
        if not isinstance(data, dict):
            raise ConfigError("config root must be a mapping")
        _merge_into(cfg, data)
    env = os.environ if env is None else env
    paths = {p for p, _f, _v in _walk_scalars(cfg)}
    for path in sorted(paths):
        var = ENV_PREFIX + path.replace(".", "_").upper()
        if var in env:
            _apply_path(cfg, path, env[var])
    if cli_args is not None:
        for path in sorted(paths):
            attr = path.replace(".", "_").replace("-", "_")
            # argparse stores --a.b-c under "a.b_c"; normalize both ways.
            for cand in (path, attr, path.replace("_", "-")):
                v = getattr(cli_args, cand, None) if not isinstance(cli_args, dict) else cli_args.get(cand)
                if v is not None:
                    _apply_path(cfg, path, v)
                    break
    _validate(cfg)
    return cfg


def _validate(cfg: Config) -> None:
    if cfg.rtc.pacer not in ("", "no-queue", "leaky-bucket"):
        raise ConfigError(
            "rtc.pacer must be '', 'no-queue' or 'leaky-bucket', "
            f"got {cfg.rtc.pacer!r}"
        )
    if not cfg.development and not cfg.keys:
        raise ConfigError("one or more API keys are required (or set development: true)")
    if cfg.development and not cfg.keys:
        # dev-mode auto keys (main.go:208-246)
        cfg.keys = {"devkey": "secret"}
    p = cfg.plane
    for name in ("tick_ms", "rooms", "tracks_per_room", "pkts_per_track", "subs_per_room"):
        if getattr(p, name) <= 0:
            raise ConfigError(f"plane.{name} must be positive")
    if p.express_max_subs < 0:
        raise ConfigError(
            f"plane.express_max_subs must be >= 0, got {p.express_max_subs}"
        )
    if p.express_max_subs > p.subs_per_room:
        raise ConfigError(
            "plane.express_max_subs must not exceed plane.subs_per_room "
            f"({p.subs_per_room}), got {p.express_max_subs}"
        )
    if p.express_max_rooms <= 0:
        raise ConfigError(
            f"plane.express_max_rooms must be positive, got {p.express_max_rooms}"
        )
    if p.pager_enabled:
        def _pow2(n: int) -> bool:
            return n > 0 and (n & (n - 1)) == 0

        for name, axis in (("pager_tpage", "tracks_per_room"),
                           ("pager_spage", "subs_per_room")):
            v, cap = getattr(p, name), getattr(p, axis)
            if not _pow2(v):
                raise ConfigError(f"plane.{name} must be a power of two, got {v}")
            if cap % v != 0:
                raise ConfigError(
                    f"plane.{name} must divide plane.{axis} ({cap}), got {v}"
                )
        if p.pager_spage > 32 or 32 % p.pager_spage != 0:
            raise ConfigError(
                "plane.pager_spage must divide 32 (selector sub-bitmask "
                f"lane), got {p.pager_spage}"
            )
        if p.pager_pool_pages and not _pow2(p.pager_pool_pages):
            raise ConfigError(
                "plane.pager_pool_pages must be a power of two (or 0 for "
                f"dense-equivalent), got {p.pager_pool_pages}"
            )
        if p.paged_kernel not in ("auto", "on", "off", "interpret"):
            raise ConfigError(
                "plane.paged_kernel must be one of auto|on|off|interpret, "
                f"got {p.paged_kernel!r}"
            )
    eg = cfg.egress
    if not 0 <= eg.shards <= 64:
        raise ConfigError(f"egress.shards must be in [0, 64], got {eg.shards}")
    f = cfg.faults
    for name in ("drop_pct", "dup_pct", "delay_pct"):
        v = getattr(f, name)
        if not 0.0 <= v <= 1.0:
            raise ConfigError(f"faults.{name} must be in [0, 1], got {v}")
    if f.drop_pct + f.dup_pct + f.delay_pct > 1.0:
        raise ConfigError("faults.drop_pct + dup_pct + delay_pct must be <= 1")
    if f.flood_mult < 0.0:
        raise ConfigError(f"faults.flood_mult must be >= 0, got {f.flood_mult}")
    if not 0 <= f.bitflip_bit <= 31:
        raise ConfigError(f"faults.bitflip_bit must be in [0, 31], got {f.bitflip_bit}")
    if f.bitflip_count <= 0:
        raise ConfigError(f"faults.bitflip_count must be positive, got {f.bitflip_count}")
    if f.bitflip_room < 0:
        raise ConfigError(f"faults.bitflip_room must be >= 0, got {f.bitflip_room}")
    if f.corrupt_ckpt_every < 0:
        raise ConfigError(
            f"faults.corrupt_ckpt_every must be >= 0, got {f.corrupt_ckpt_every}"
        )
    if f.mig_ack_delay_s < 0.0:
        raise ConfigError(f"faults.mig_ack_delay_s must be >= 0, got {f.mig_ack_delay_s}")
    if f.mig_sever_handoffs < 0:
        raise ConfigError(
            f"faults.mig_sever_handoffs must be >= 0, got {f.mig_sever_handoffs}"
        )
    integ = cfg.integrity
    for name in ("audit_every_ticks", "max_row_repairs", "storm_threshold",
                 "checkpoint_generations"):
        if getattr(integ, name) <= 0:
            raise ConfigError(f"integrity.{name} must be positive")
    if cfg.supervisor.tick_deadline_ms <= 0:
        raise ConfigError("supervisor.tick_deadline_ms must be positive")
    if cfg.supervisor.overload_grace < 1.0:
        raise ConfigError("supervisor.overload_grace must be >= 1")
    lim = cfg.limits
    if not lim.governor_enter_pressure > lim.governor_exit_pressure:
        raise ConfigError(
            "limits.governor_enter_pressure must exceed governor_exit_pressure "
            "(the hysteresis band)"
        )
    for name in ("governor_escalate_ticks", "governor_dwell_ticks",
                 "governor_ingress_pps", "governor_ingress_burst"):
        if getattr(lim, name) <= 0:
            raise ConfigError(f"limits.{name} must be positive")
    if cfg.kv.lease_ttl_s <= 0:
        raise ConfigError("kv.lease_ttl_s must be positive")
    if cfg.kv.stats_interval_s <= 0:
        raise ConfigError("kv.stats_interval_s must be positive")
    if f.bus_heal_at_tick < -1 or f.bus_partition_tick < -1:
        raise ConfigError(
            "faults.bus_partition_tick/bus_heal_at_tick must be >= -1"
        )
    fleet = cfg.fleet
    if fleet.enabled:
        if fleet.fence_grace_s <= 0:
            raise ConfigError("fleet.fence_grace_s must be positive")
        if fleet.fence_grace_s > 2 * cfg.kv.lease_ttl_s:
            raise ConfigError(
                "fleet.fence_grace_s must be <= 2 x kv.lease_ttl_s "
                "(a blip must not mute a healthy node for long)"
            )
        if fleet.fence_grace_s >= cfg.kv.lease_ttl_s + cfg.kv.failover_interval_s:
            raise ConfigError(
                "fleet.fence_grace_s must be < kv.lease_ttl_s + "
                "kv.failover_interval_s (the minority must fence before "
                "any survivor can complete a takeover)"
            )
    for name in ("restore_lock_ttl_s", "rebalance_interval_s",
                 "rebalance_max_moves"):
        if getattr(fleet, name) <= 0:
            raise ConfigError(f"fleet.{name} must be positive")
    if fleet.rebalance_headroom < 0:
        raise ConfigError("fleet.rebalance_headroom must be >= 0")
    mig = cfg.migration
    for name in ("snapshot_ttl_s", "ack_timeout_s", "retry_attempts",
                 "retry_backoff_base_s", "retry_backoff_max_s",
                 "drain_concurrency", "adopt_ttl_s", "bridge_max_packets",
                 "bridge_chunk"):
        if getattr(mig, name) <= 0:
            raise ConfigError(f"migration.{name} must be positive")
    tr = cfg.trace
    for name in ("ring_ticks", "sample_every", "blackbox_events"):
        if getattr(tr, name) <= 0:
            raise ConfigError(f"trace.{name} must be positive")
    tw = cfg.twin
    for name in ("nodes", "ticks", "probe_every"):
        if getattr(tw, name) <= 0:
            raise ConfigError(f"twin.{name} must be positive")
    if tw.seed < 0:
        raise ConfigError(f"twin.seed must be >= 0, got {tw.seed}")
    if tw.wire_probes < 0:
        raise ConfigError(f"twin.wire_probes must be >= 0, got {tw.wire_probes}")
    if not 0.0 <= tw.video_room_frac <= 1.0:
        raise ConfigError(
            f"twin.video_room_frac must be in [0, 1], got {tw.video_room_frac}"
        )
    if any(float(x) <= 0 for x in tw.loads):
        raise ConfigError("twin.loads must all be positive multipliers")
    if tw.enabled and len(tw.loads) < 4:
        raise ConfigError(
            "twin.loads needs >= 4 offered-load steps for the capacity/SLO "
            f"curve, got {len(tw.loads)}"
        )


# Subsystems the port does not carry yet: (config path, whether a value
# enables it, the value that turns it off, the ROADMAP item that brings
# it). RoomManager refuses a config that enables any of them.
UNPORTED: tuple[tuple[str, Callable[[Any], bool], Any, str], ...] = (
    ("plane.mesh_devices", lambda v: v > 1, 1, "A10 (multi-GPU)"),
)


def _get_path(cfg: Config, path: str) -> Any:
    obj = cfg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def check_ported(cfg: Config) -> None:
    """ConfigError naming the first subsystem `cfg` enables that the port
    does not carry, and the ROADMAP item that brings it."""
    for path, enabled, _off, item in UNPORTED:
        value = _get_path(cfg, path)
        if enabled(value):
            raise ConfigError(
                f"{path}={value!r} enables a subsystem this port does not "
                f"carry yet (ROADMAP {item}); set it to {_off!r}"
            )


def port_overlay() -> dict:
    """The nested config mapping that turns every UNPORTED subsystem off
    (the overlay `serve --dev` puts on the reference's dev config)."""
    out: dict = {}
    for path, _enabled, off, _item in UNPORTED:
        *parents, leaf = path.split(".")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = off
    return out


def apply_port_overlay(cfg: Config) -> Config:
    """`cfg` with every UNPORTED subsystem turned off, in place."""
    _merge_into(cfg, port_overlay())
    return cfg
