"""Shared helpers of the port's multi-node tests: nodes of the port's
server (create_server on device="cpu") over one bus, in one process.

The config is the reference test config's shape (tests/test_migration.py
make_cfg) with the port's test settings: no fixed media ports and one
egress shard (parallel test workers), and the overload governor off
unless a test turns it on (its ladder reads wall-clock lateness, which a
loaded test host inflates)."""

from __future__ import annotations

import asyncio

from livekit_server_tpu_torch.config import load_config
from livekit_server_tpu_torch.service.server import create_server
from tests.conftest import free_port

API_KEY, API_SECRET = "testkey", "testsecret"


def make_cfg(port: int, **overrides):
    base = {
        "keys": {API_KEY: API_SECRET},
        "port": port,
        "bind_addresses": ["127.0.0.1"],
        "plane": {"rooms": 4, "tracks_per_room": 4, "pkts_per_track": 4,
                  "subs_per_room": 4, "tick_ms": 10},
        # Rooms in these tests are created admin-style (never joined);
        # keep the idle reaper out of the way.
        "room": {"empty_timeout_s": 60},
        "rtc": {"udp_port": 0, "tcp_port": 0},
        "egress": {"shards": 1},
        "limits": {"governor_enabled": False},
        "migration": {"ack_timeout_s": 2.0, "retry_attempts": 2,
                      "retry_backoff_base_s": 0.02,
                      "retry_backoff_max_s": 0.05, "adopt_ttl_s": 2.0},
    }
    for key, val in overrides.items():
        base[key] = ({**base[key], **val}
                     if isinstance(base.get(key), dict) else val)
    return load_config(base=base, env={})


async def start_node(bus, **overrides):
    srv = create_server(make_cfg(free_port(), **overrides), bus=bus, device="cpu")
    await srv.start()
    return srv


async def stop_all(*servers):
    for srv in servers:
        if srv is not None:
            await srv.stop(force=True)


def rows_used(srv) -> int:
    return srv.room_manager.runtime.slots.rooms_used


async def wait_for(cond, timeout=10.0, what="condition"):
    """Poll a condition with a deadline (peer handlers run as spawned
    tasks after the caller's await returns)."""
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, f"timed out: {what}"
        await asyncio.sleep(0.01)


async def pump_until(rt, row, sn, timeout=10.0):
    """Wait for the serving loop to advance the munger lane to `sn`."""
    deadline = asyncio.get_running_loop().time() + timeout
    while int(rt.munger.last_sn[row, 0, 1]) != sn:
        assert asyncio.get_running_loop().time() < deadline, (
            f"lane stuck at {int(rt.munger.last_sn[row, 0, 1])}, want {sn}"
        )
        await asyncio.sleep(0.01)


# -- nodes over a real TCP bus (the counterparts of tests/test_multinode.py)
async def start_bus(token: str = ""):
    from livekit_server_tpu_torch.routing.tcpbus import BusServer

    bus = BusServer(token=token)
    await bus.start("127.0.0.1", 0)
    return bus


def tcp_config(port: int, **plane_overrides):
    """tests/test_service.py make_config's shape with the port's test
    settings (see the module docstring)."""
    plane = {"rooms": 4, "tracks_per_room": 4, "pkts_per_track": 4, "subs_per_room": 4,
             "tick_ms": 10} | plane_overrides
    return load_config(base={
        "keys": {API_KEY: API_SECRET}, "port": port, "bind_addresses": ["127.0.0.1"],
        "plane": plane, "room": {"empty_timeout_s": 2},
        "rtc": {"udp_port": 0, "tcp_port": 0, "require_encryption": False},
        "egress": {"shards": 1}, "limits": {"governor_enabled": False},
    }, env={})


async def start_tcp_node(bus_port: int, **plane_overrides):
    from livekit_server_tpu_torch.routing.tcpbus import TCPBusClient

    client = await TCPBusClient.connect("127.0.0.1", bus_port)
    srv = create_server(tcp_config(free_port(), **plane_overrides), bus=client, device="cpu")
    await srv.start()
    return srv, client


def fleet_config(port: int, extra: dict | None = None):
    """tests/test_multinode.py's drill-speed fleet timings. The no-overlap
    inequalities hold at scale: fence_grace 0.5 ≤ 2×lease_ttl 0.8 and
    0.5 < lease_ttl 0.8 + failover_interval 0.4 — a dark node mutes
    (~0.7 s) strictly before the earliest takeover can finish (~1.2 s)."""
    doc = {
        "keys": {API_KEY: API_SECRET},
        "port": port,
        "bind_addresses": ["127.0.0.1"],
        "plane": {"rooms": 4, "tracks_per_room": 4, "pkts_per_track": 16,
                  "subs_per_room": 4, "tick_ms": 10},
        "rtc": {"udp_port": 0, "tcp_port": 0},
        "egress": {"shards": 1},
        "limits": {"governor_enabled": False},
        "room": {"empty_timeout_s": 60},
        "kv": {"lease_ttl_s": 0.8, "failover_interval_s": 0.4,
               "stats_interval_s": 0.2},
        "fleet": {"fence_grace_s": 0.5, "restore_lock_ttl_s": 2.0},
        "supervisor": {"checkpoint_interval_s": 0.2},
    }
    for section, values in (extra or {}).items():
        doc[section] = {**doc.get(section, {}), **values}
    return load_config(base=doc, env={})


async def start_fleet_node(bus_port: int, extra: dict | None = None):
    from livekit_server_tpu_torch.routing.tcpbus import TCPBusClient

    client = await TCPBusClient.connect("127.0.0.1", bus_port)
    srv = create_server(fleet_config(free_port(), extra=extra), bus=client, device="cpu")
    await srv.start()
    return srv, client


def slot_free(rm, room) -> bool:
    """Whether the room's track-0 staging slots have room for one more
    packet this tick. The drills' pumps send only then, as a paced sender
    would: the port's plain-torch tick on a loaded CPU can outlast many
    pump periods, and a capacity drop (no migration involved) would read
    as a packet the handoff lost. A frozen row always takes the packet
    (its bridge captures it)."""
    ing = rm.runtime.ingest
    row = room.slots.row
    return row in ing.frozen_rows or int(ing._count[row, 0]) < ing.dims.pkts
