"""Deterministic, seedable fault injection for chaos tests and soak runs.

Port of the JAX package's runtime/faultinject.py, the media plane's seams
only. Faults thread in at well-defined seams so the SAME mechanism drives
unit chaos tests and on-card drills (chip_smoke.py's failure phase):

  - packet faults (drop / delay / duplicate / flood) at the ingest
    boundary — IngestBuffer.push consults an attached injector before
    staging, so faulted traffic exercises the identical tick path real
    loss would
  - tick stalls — PlaneRuntime._device_step calls maybe_stall() on the
    worker thread, wedging the tick exactly where a hung device step
    would (what the PlaneSupervisor watchdog exists to catch)
  - silent data corruption — maybe_bitflip flips bits in one room's row
    of a state leaf on the device (what the integrity audit catches)
  - checkpoint corruption — corrupt_ckpt damages encoded frames past
    their header (what checksum verification catches)

  - migration chaos — a target that adopts and goes silent, a late ACK,
    a corrupted PREPARE snapshot, a commit phase whose bus ops fail
    (service/migration.py)
  - bus partitions — sever/heal node groups at the BusServer on the
    tick clock (routing/tcpbus.py set_partition)
  - bus severing — abort a TCPBusClient's transport mid-conversation
    (exercises the retry/backoff/reconnect path in routing/tcpbus.py)
  - node kill — abrupt, non-graceful teardown of a server's cluster
    presence: heartbeats stop, the lease expires, the pin is left behind
    (exactly what a crashed host looks like to the survivors)

Determinism: every probabilistic decision draws from one seeded numpy
Generator in arrival order, so a given (seed, packet sequence) replays
the identical fault pattern, the same as the reference's for the same
seed. All faults default OFF; config (config.faults.*) gates them and the
default config path never constructs an injector.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from livekit_server_tpu_torch.parallel.mesh import Sharded, locate


@dataclass
class FaultSpec:
    """Injection plan (mirrors config.FaultInjectConfig)."""

    seed: int = 0
    drop_pct: float = 0.0     # P(drop) per ingest packet
    dup_pct: float = 0.0      # P(duplicate) per ingest packet
    delay_pct: float = 0.0    # P(delay) per ingest packet
    delay_ticks: int = 2      # held-back packets re-enter after this many ticks
    stall_every: int = 0      # every Nth device step stalls (0 = never)
    stall_s: float = 0.0      # stall duration
    # Flood mode: multiply offered load by staging extra copies of each
    # arriving packet (<= 1.0 disables). Non-integer multipliers add the
    # fractional copy with a seeded draw; integer multipliers draw
    # nothing, keeping the drop/delay/dup sequence alignment identical
    # to a non-flood run with the same seed.
    flood_mult: float = 1.0
    flood_rooms: tuple = ()   # room rows to flood (empty = every room)
    # Silent-data-corruption mode: flip bits in one room's slice of a
    # chosen PlaneState leaf right before the device step at bitflip_tick
    # (-1 = never). Element choice draws from a SEPARATE seeded rng so
    # the packet-fault draw sequence stays alignment-identical to a
    # no-bitflip run with the same seed.
    bitflip_tick: int = -1
    bitflip_room: int = 0
    bitflip_leaf: str = "temporal_bytes"  # dotted path into PlaneState
    bitflip_bit: int = 30     # bit index within each element's word
    bitflip_count: int = 1    # elements flipped in the chosen row
    # Checkpoint corruption: damage every Nth serialized checkpoint frame
    # past its header (0 = never), so restore paths must catch it via
    # checksum verification, not a deserialize crash.
    corrupt_ckpt_every: int = 0
    # Migration chaos drills (service/migration.py seams):
    # target adopts the PREPARE'd room then goes silent — never ACKs.
    mig_drop_prepare: bool = False
    # target sleeps this long before ACKing (late-ACK epoch-guard drill).
    mig_ack_delay_s: float = 0.0
    # source damages the encoded snapshot inside PREPARE (target NACKs).
    mig_corrupt_handoff: bool = False
    # source's first N commit phases fail their bus ops (sever drill).
    mig_sever_handoffs: int = 0
    # Bus-partition drills (BusServer.set_partition seam): node-id groups
    # to sever from each other at bus_partition_tick — group 0 keeps the
    # bus, later groups lose every KV op and pub/sub push (the minority
    # side of a split-brain). Healed at bus_heal_at_tick (-1 = never).
    # bus_asym_pairs lists (src, dst) node-id pairs whose pushes are
    # HELD and delivered in order on heal — the stale-message-after-heal
    # drill (e.g. a migration COMMIT landing after its epoch died).
    bus_partition_groups: tuple = ()
    bus_partition_tick: int = -1
    bus_heal_at_tick: int = -1
    bus_asym_pairs: tuple = ()


@dataclass
class FaultStats:
    dropped: int = 0
    duplicated: int = 0
    delayed: int = 0
    stalls: int = 0
    flooded: int = 0          # extra packet copies staged by flood mode
    bitflips: int = 0         # state elements corrupted by bitflip mode
    ckpt_corrupted: int = 0   # checkpoint frames damaged after encoding
    severed: int = 0
    killed: int = 0
    mig_prepares_swallowed: int = 0  # adoptions that then went silent
    mig_acks_delayed: int = 0        # ACKs slept past the source timeout
    mig_handoffs_corrupted: int = 0  # PREPARE snapshots damaged in flight
    mig_commits_severed: int = 0     # commit phases failed at the bus seam
    partitions: int = 0              # bus partitions installed by the tick seam
    heals: int = 0                   # partitions healed by the tick seam


class FaultInjector:
    """One injector per runtime; attach via `runtime.fault` and
    `runtime.ingest.fault` (RoomManager does both when config enables it)."""

    def __init__(self, spec: FaultSpec | None = None, **overrides: Any):
        spec = spec or FaultSpec()
        if overrides:
            spec = FaultSpec(**{**vars(spec), **overrides})
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        # Separate stream for bitflip element choice: corruption faults
        # must not perturb the packet-fault draw alignment.
        self._sdc_rng = np.random.default_rng(spec.seed ^ 0x5DC5DC)
        self.stats = FaultStats()
        # release_tick → [PacketIn]; drained by take_due() at tick edges.
        self._held: dict[int, list] = {}
        self._step_count = 0
        self._ckpt_count = 0
        self._mig_severed = 0
        self._mig_handoff_count = 0

    @classmethod
    def from_config(cls, cfg) -> "FaultInjector":
        return cls(FaultSpec(
            seed=cfg.seed, drop_pct=cfg.drop_pct, dup_pct=cfg.dup_pct,
            delay_pct=cfg.delay_pct, delay_ticks=cfg.delay_ticks,
            stall_every=cfg.stall_every, stall_s=cfg.stall_s,
            flood_mult=cfg.flood_mult, flood_rooms=tuple(cfg.flood_rooms),
            bitflip_tick=cfg.bitflip_tick, bitflip_room=cfg.bitflip_room,
            bitflip_leaf=cfg.bitflip_leaf, bitflip_bit=cfg.bitflip_bit,
            bitflip_count=cfg.bitflip_count,
            corrupt_ckpt_every=cfg.corrupt_ckpt_every,
            mig_drop_prepare=cfg.mig_drop_prepare,
            mig_ack_delay_s=cfg.mig_ack_delay_s,
            mig_corrupt_handoff=cfg.mig_corrupt_handoff,
            mig_sever_handoffs=cfg.mig_sever_handoffs,
            bus_partition_groups=tuple(tuple(g) for g in cfg.bus_partition_groups),
            bus_partition_tick=cfg.bus_partition_tick,
            bus_heal_at_tick=cfg.bus_heal_at_tick,
            bus_asym_pairs=tuple(tuple(p) for p in cfg.bus_asym_pairs),
        ))

    # -- ingest-boundary packet faults -----------------------------------
    def on_packet(self, pkt, tick_index: int) -> str:
        """Verdict for one arriving packet, drawn in arrival order:
        'drop' (discard), 'delay' (held; re-enters at tick_index +
        delay_ticks), 'dup' (stage twice), or 'pass'. One uniform draw
        per packet keeps the sequence alignment-stable across verdicts."""
        s = self.spec
        u = float(self.rng.random())
        if u < s.drop_pct:
            self.stats.dropped += 1
            return "drop"
        if u < s.drop_pct + s.delay_pct:
            self.stats.delayed += 1
            self._held.setdefault(tick_index + max(1, s.delay_ticks), []).append(pkt)
            return "delay"
        if u < s.drop_pct + s.delay_pct + s.dup_pct:
            self.stats.duplicated += 1
            return "dup"
        return "pass"

    def flood_copies(self, room: int) -> int:
        """Extra copies to stage for one arriving packet in flood mode
        (0 when disabled or the room is excluded). IngestBuffer.push
        calls this once per ORIGINAL packet; a 4.0 multiplier returns 3
        so original + copies = 4x offered load."""
        s = self.spec
        if s.flood_mult <= 1.0:
            return 0
        if s.flood_rooms and room not in s.flood_rooms:
            return 0
        extra = int(s.flood_mult) - 1
        frac = s.flood_mult - int(s.flood_mult)
        if frac > 0.0 and float(self.rng.random()) < frac:
            extra += 1
        self.stats.flooded += extra
        return extra

    def take_due(self, tick_index: int) -> list:
        """Delayed packets whose release tick has arrived (drained by
        IngestBuffer right before each tick's drain)."""
        due: list = []
        for t in sorted(k for k in self._held if k <= tick_index):
            due.extend(self._held.pop(t))
        return due

    # -- tick stalls ------------------------------------------------------
    def maybe_stall(self) -> None:
        """Called from the device-step worker thread: sleeping here wedges
        the tick without blocking the event loop — the watchdog's view is
        identical to a hung device step."""
        self._step_count += 1
        s = self.spec
        if s.stall_every and s.stall_s > 0 and self._step_count % s.stall_every == 0:
            self.stats.stalls += 1
            time.sleep(s.stall_s)

    # -- silent data corruption -------------------------------------------
    def maybe_bitflip(self, state, tick_index: int) -> None:
        """Flip bits in one room's row of the configured leaf of `state`
        (a PlaneState of tensors, or its room shards) at the configured tick, in place on the
        leaf's device — the corruption the integrity audit exists to
        catch. Called from PlaneRuntime._device_step on the worker thread
        right before the step, with state_lock held and the runtime's
        stream current. Flips the same elements and bits as the
        reference for the same seed."""
        s = self.spec
        if s.bitflip_tick < 0 or tick_index != s.bitflip_tick:
            return
        room = s.bitflip_room
        if isinstance(state, Sharded):
            # Room shards: the flip lands in the shard that owns the room.
            state, room = locate(state, room)
        leaf = state
        for part in s.bitflip_leaf.split("."):
            leaf = getattr(leaf, part)
        row = leaf[room].cpu().numpy().copy()
        flat = row.reshape(-1)
        if flat.dtype.itemsize == 4:
            words = flat.view(np.uint32)
            bit = np.uint32(1 << (s.bitflip_bit % 32))
        else:  # bool / int8 leaves: flip within the byte
            words = flat.view(np.uint8)
            bit = np.uint8(1 << (s.bitflip_bit % 8))
        n = min(max(1, s.bitflip_count), words.size)
        idx = self._sdc_rng.choice(words.size, size=n, replace=False)
        words[idx] ^= bit
        if row.dtype == np.bool_:
            row = row.view(np.uint8) != 0
        leaf[room] = torch.from_numpy(row).to(leaf.device)
        self.stats.bitflips += n

    def corrupt_ckpt(self, blob):
        """Damage every Nth encoded checkpoint (bytes or b64 str) at a
        deterministic offset PAST the frame header: the magic/version
        survive, so only CRC verification can catch the damage."""
        s = self.spec
        if s.corrupt_ckpt_every <= 0:
            return blob
        self._ckpt_count += 1
        if self._ckpt_count % s.corrupt_ckpt_every:
            return blob
        self.stats.ckpt_corrupted += 1
        if isinstance(blob, str):
            # b64 text (room checkpoints): the 20-byte header spans the
            # first 28 chars; swap one payload char for a different valid
            # b64 char so decode succeeds but the CRC does not.
            pos = 28 + (self._ckpt_count * 7919) % max(1, len(blob) - 30)
            repl = "A" if blob[pos] != "A" else "B"
            return blob[:pos] + repl + blob[pos + 1:]
        pos = 20 + (self._ckpt_count * 7919) % max(1, len(blob) - 21)
        out = bytearray(blob)
        out[pos] ^= 0xFF
        return bytes(out)

    # -- migration chaos seams (service/migration.py) ---------------------
    def mig_swallow_prepare(self) -> bool:
        """Target seam: True = the PREPARE handler adopted the room but
        must now go silent (no ACK, ever) — to the source this target
        died mid-PREPARE. Exercises the source's timeout rollback and
        the target's adoption reaper (no row leak)."""
        if not self.spec.mig_drop_prepare:
            return False
        self.stats.mig_prepares_swallowed += 1
        return True

    async def mig_delay_ack(self) -> None:
        """Target seam: hold the ACK past the source's timeout so the
        epoch guard gets a genuinely late ACK to ignore."""
        s = self.spec
        if s.mig_ack_delay_s > 0:
            self.stats.mig_acks_delayed += 1
            import asyncio

            await asyncio.sleep(s.mig_ack_delay_s)

    def corrupt_handoff(self, payload: str) -> str:
        """Source seam: damage the encoded snapshot riding in PREPARE the
        same way corrupt_ckpt damages b64 checkpoint frames — header
        intact, one payload char swapped, so only the target's CRC
        verification catches it (⇒ NACK)."""
        if not self.spec.mig_corrupt_handoff:
            return payload
        self.stats.mig_handoffs_corrupted += 1
        self._mig_handoff_count += 1
        pos = 28 + (self._mig_handoff_count * 7919) % max(1, len(payload) - 30)
        repl = "A" if payload[pos] != "A" else "B"
        return payload[:pos] + repl + payload[pos + 1:]

    def mig_sever_commit(self) -> bool:
        """Source seam: True = this commit phase's bus ops must fail
        (the orchestrator raises ConnectionError and rolls back).
        Consumes one of mig_sever_handoffs per handoff attempt."""
        if self._mig_severed >= self.spec.mig_sever_handoffs:
            return False
        self._mig_severed += 1
        self.stats.mig_commits_severed += 1
        return True

    # -- bus-partition drills (routing/tcpbus.py BusServer seam) ----------
    def bus_partition_tick(self, bus_server, tick_index: int) -> None:
        """Deterministic sever/heal on the tick clock: install the
        configured partition at bus_partition_tick, heal it at
        bus_heal_at_tick. Driven by whichever test/bench owns both the
        BusServer and a tick counter; idempotent across repeat calls for
        the same tick."""
        s = self.spec
        if not s.bus_partition_groups:
            return
        if tick_index == s.bus_partition_tick and not bus_server._severed:
            bus_server.set_partition(
                [list(g) for g in s.bus_partition_groups],
                asym_pairs=s.bus_asym_pairs,
            )
            self.stats.partitions += 1
        if (
            s.bus_heal_at_tick >= 0
            and tick_index == s.bus_heal_at_tick
            and (bus_server._severed or bus_server._asym)
        ):
            bus_server.heal_partition()
            self.stats.heals += 1

    # -- infrastructure faults (chaos-test helpers) ----------------------
    def sever_bus(self, client) -> None:
        """Hard-drop a TCPBusClient's socket (no FIN handshake): in-flight
        calls fail, the retry/backoff path re-dials."""
        self.stats.severed += 1
        transport = getattr(client._writer, "transport", None)
        if transport is not None:
            transport.abort()
        else:  # non-asyncio writer (tests with fakes)
            client._writer.close()

    async def kill_node(self, server) -> None:
        """Crash a server the way a dead host looks to the cluster:
        heartbeats and the session worker stop, the runtime halts, the
        bus socket drops — but NOTHING is cleaned up (no hdel, no lease
        delete, no room unpin). Survivors must detect the expired lease
        and take the rooms over."""
        self.stats.killed += 1
        router = server.router
        for attr in ("_stats_task", "_session_task"):
            task = getattr(router, attr, None)
            if task is not None:
                task.cancel()
        stack = getattr(server, "stack", server)
        if getattr(stack, "_stats_task", None) is not None:
            stack._stats_task.cancel()
        sup = getattr(server.room_manager, "supervisor", None)
        if sup is not None:
            await sup.stop()
        await server.room_manager.runtime.stop()
        failover = getattr(server.room_manager, "_failover_task", None)
        if failover is not None:
            failover.cancel()
        fleet = getattr(server.room_manager, "fleet", None)
        if fleet is not None:
            await fleet.stop()
        bus = getattr(router, "bus", None)
        if bus is not None and hasattr(bus, "_writer"):
            bus.closed = True  # suppress the reconnect loop: the node is dead
            self.sever_bus(bus)


def _replace_leaf(tree, path: str, value):
    """Rebuild a NamedTuple tree with the leaf at dotted `path` swapped."""
    parts = path.split(".")

    def rec(node, i: int):
        if i == len(parts) - 1:
            return node._replace(**{parts[i]: value})
        child = getattr(node, parts[i])
        return node._replace(**{parts[i]: rec(child, i + 1)})

    return rec(tree, 0)
