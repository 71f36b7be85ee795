"""The port's fleet primitives (routing/fleet.py RoomFence and
LeaseGuard, MemoryBus.cas, the skew-tolerant liveness of routing/node.py,
and the fleet/fault config surface) against the JAX package's: the same
scripted sequence runs in both packages, each over its own MemoryBus, and
every observation (return values, epochs, holders, stats, stored values,
raised fences) is equal. They are the single-process units behind the
split-brain drills (tests/test_torch_failover.py). The expected values
are the reference's tests/test_fleet.py."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import livekit_server_tpu.config as jconfig  # noqa: E402
import livekit_server_tpu.routing.fleet as jfleet  # noqa: E402
import livekit_server_tpu.routing.kv as jkv  # noqa: E402
import livekit_server_tpu.routing.node as jnode  # noqa: E402
import livekit_server_tpu.runtime.faultinject as jfault  # noqa: E402
import livekit_server_tpu_torch.config as pconfig  # noqa: E402
import livekit_server_tpu_torch.routing.fleet as pfleet  # noqa: E402
import livekit_server_tpu_torch.routing.kv as pkv  # noqa: E402
import livekit_server_tpu_torch.routing.node as pnode  # noqa: E402
import livekit_server_tpu_torch.runtime.faultinject as pfault  # noqa: E402

JAX = SimpleNamespace(fleet=jfleet, kv=jkv, node=jnode, config=jconfig, fault=jfault)
PORT = SimpleNamespace(fleet=pfleet, kv=pkv, node=pnode, config=pconfig, fault=pfault)


async def both(scenario):
    """Run `scenario(pkg)` in both packages; its observations must agree."""
    want = await scenario(JAX)
    got = await scenario(PORT)
    assert got == want
    return got


async def _fenced(coro) -> bool:
    """Whether awaiting `coro` raised the package's FencedWriteRejected."""
    try:
        await coro
    except (jfleet.FencedWriteRejected, pfleet.FencedWriteRejected):
        return True
    return False


async def test_cas_semantics_match():
    async def scenario(pkg):
        bus = pkg.kv.MemoryBus()
        out = [await bus.cas("k", None, "a"), await bus.cas("k", None, "b"),
               await bus.get("k"), await bus.cas("k", "stale", "c"),
               await bus.cas("k", "a", "c"), await bus.get("k")]
        await bus.set("t", "a", ttl=0.01)
        time.sleep(0.03)
        out += [await bus.cas("t", "a", "b"), await bus.cas("t", None, "b")]
        return out

    assert await both(scenario) == [True, False, "a", False, True, "c", False, True]


async def test_claim_and_assume_match():
    async def scenario(pkg):
        bus = pkg.kv.MemoryBus()
        a, b = pkg.fleet.RoomFence(bus, "node-a"), pkg.fleet.RoomFence(bus, "node-b")
        out = [await a.claim("r"), a.epoch_of("r"), await b.claim("r"), b.epoch_of("r"),
               await a.read("r"), await b.claim("r"), b.epoch_of("r"), b.stats["claims"]]
        # Two survivors race a takeover from a dead node's record: the
        # epoch CAS admits exactly one.
        dead = pkg.fleet.RoomFence(bus, "node-dead")
        await dead.claim("s")
        key = pkg.fleet.ROOM_EPOCH_PREFIX + "s"
        cur = await bus.get(key)
        out += [await bus.cas(key, cur, '{"e":2,"n":"node-a"}'),
                await bus.cas(key, cur, '{"e":2,"n":"node-b"}')]
        # assume: claims an unclaimed room, never steals, adopts a transfer.
        c, d = pkg.fleet.RoomFence(bus, "node-c"), pkg.fleet.RoomFence(bus, "node-d")
        out += [await c.assume("t"), c.owns("t"), await d.claim("t")]
        c.forget("t")
        out += [await c.assume("t"), c.owns("t"), await d.transfer("t", "node-c"),
                await c.assume("t"), c.epoch_of("t")]
        return out

    got = await both(scenario)
    assert got[:8] == [True, 1, True, 2, (2, "node-b"), True, 2, 1]
    assert got[8:10].count(True) == 1
    assert got[10:] == [True, True, True, False, False, True, True, 3]


async def test_guarded_writes_transfer_and_release_match():
    async def scenario(pkg):
        bus = pkg.kv.MemoryBus()
        a, b = pkg.fleet.RoomFence(bus, "node-a"), pkg.fleet.RoomFence(bus, "node-b")
        lost: list[str] = []
        a.on_lost.append(lost.append)
        out = [await a.claim("r")]
        await a.guarded_set("r", "room_checkpoint:r:gen", "v1", 30.0)
        out.append(await b.claim("r"))                  # takeover while a is dark
        out.append(await _fenced(a.guarded_set("r", "room_checkpoint:r:gen", "v2", 30.0)))
        out += [await bus.get("room_checkpoint:r:gen"), list(lost), a.owns("r"),
                a.stats["writes_fenced"],
                await _fenced(a.guarded_delete("r", "room_checkpoint:r:gen"))]
        src, dst = pkg.fleet.RoomFence(bus, "node-src"), pkg.fleet.RoomFence(bus, "node-dst")
        out += [await src.claim("t"), await src.transfer("t", "node-dst"),
                await src.read("t"), src.owns("t"), await dst.assume("t"),
                await _fenced(src.guarded_set("t", "room_checkpoint:t:gen", "stale"))]
        thief = pkg.fleet.RoomFence(bus, "node-thief")
        src_lost: list[str] = []
        src.on_lost.append(src_lost.append)
        out += [await src.claim("u"), await thief.claim("u"),
                await src.transfer("u", "node-dst"), list(src_lost), await src.read("u")]
        await a.release("v")
        out.append(await a.read("v"))
        out += [await a.claim("w"), await b.claim("w")]
        await a.release("w")
        out.append(await b.read("w"))
        return out

    assert await both(scenario) == [
        True, True, True, "v1", ["r"], False, 1, True,
        True, True, (2, "node-dst"), False, True, True,
        True, True, False, ["u"], (2, "node-thief"),
        (0, ""), True, True, (2, "node-b"),
    ]


async def test_lease_guard_grace_and_blip_match():
    async def scenario(pkg):
        clock = [0.0]
        g = pkg.fleet.LeaseGuard(fence_grace_s=5.0, clock=lambda: clock[0])
        out = [g.observe(True)]
        for t, ok in ((3.0, False), (5.5, False)):
            clock[0] = t
            out.append(g.observe(ok))
        out += [g.fenced, g.fences]
        clock[0] = 9.0
        out += [g.observe(False), g.observe(True), g.fenced]
        g.unfence()
        out += [g.fenced, g.observe(True), g.age()]
        # A blip inside the grace never fences; the grace restarts from
        # the last good refresh.
        clock[0] = 0.0
        h = pkg.fleet.LeaseGuard(fence_grace_s=5.0, clock=lambda: clock[0])
        for t in (1.0, 2.0, 4.9):
            clock[0] = t
            out.append(h.observe(False))
        clock[0] = 5.0
        out.append(h.observe(True))
        clock[0] = 9.0
        out.append(h.observe(False))
        return out

    assert await both(scenario) == [
        "", "", "fence", True, 1, "", "recover", True, False, "", 0.0,
        "", "", "", "", ""]


async def test_liveness_skew_rules_match():
    async def scenario(pkg):
        node = pkg.node
        node.LocalNode._freshness.clear()

        def peer(node_id, **stats):
            return node.LocalNode(node_id=node_id, state=node.NodeState.SERVING,
                                  stats=node.NodeStats(**stats))

        out = []
        p = peer("n1", updated_at=time.time() - 7200.0, mono_at=100.0)
        out.append(p.is_available(max_age=0.5))
        p.stats.mono_at = 101.0
        out.append(p.is_available(max_age=0.5))
        p = peer("n2", updated_at=time.time(), mono_at=100.0)
        out.append(p.is_available(max_age=0.05))
        time.sleep(0.08)
        p.stats.updated_at = time.time()
        out.append(p.is_available(max_age=0.05))
        p = peer("n3", updated_at=time.time() - 1.0 - node.SKEW_ALLOWANCE_S / 2, mono_at=0.0)
        out.append(p.is_available(max_age=1.0))
        p.stats.updated_at = time.time() - 1.0 - node.SKEW_ALLOWANCE_S * 2
        out.append(p.is_available(max_age=1.0))
        p = peer("n4", updated_at=time.time(), mono_at=100.0)
        p.state = node.NodeState.SHUTTING_DOWN
        out.append(p.is_available(max_age=30.0))
        return out

    assert pnode.SKEW_ALLOWANCE_S == jnode.SKEW_ALLOWANCE_S
    assert await both(scenario) == [True, True, True, False, True, False, False]


FLEET_CASES = (
    ({}, None),
    ({"fleet": {"fence_grace_s": 0}}, "fence_grace_s"),
    ({"fleet": {"fence_grace_s": 100.0}}, "fence_grace_s"),
    ({"fleet": {"fence_grace_s": 8.0}, "kv": {"lease_ttl_s": 6.0, "failover_interval_s": 1.0}},
     "fence_grace_s"),
    ({"fleet": {"enabled": False, "fence_grace_s": 100.0}}, None),
    ({"faults": {"enabled": True, "bus_partition_tick": -2}}, "bus_partition_tick"),
)


def _load(pkg, doc):
    """("ok", the fleet timeline) or ("error", message) for `doc`."""
    try:
        if pkg is PORT:
            cfg = pconfig.load_config(base={"development": True, **doc}, env={})
        else:
            cfg = jconfig.load_config(yaml_text=json.dumps({"development": True, **doc}))
    except (jconfig.ConfigError, pconfig.ConfigError) as e:
        return ("error", str(e))
    return ("ok", cfg.fleet.enabled, cfg.fleet.fence_grace_s, cfg.kv.lease_ttl_s,
            cfg.kv.failover_interval_s)


def test_fleet_config_validation_parity():
    """The reference's validation of fleet.fence_grace_s against
    kv.lease_ttl_s and kv.failover_interval_s (and of the partition
    drill's tick), kept in the port's config: the same documents load or
    fail alike, with the same message."""
    for doc, error in FLEET_CASES:
        got, want = _load(PORT, doc), _load(JAX, doc)
        assert got == want, doc
        if error is None:
            assert got[0] == "ok", doc
        else:
            assert got[0] == "error" and error in got[1], doc
    assert _load(PORT, {})[1:] == (True, 6.0, 6.0, 2.0)    # on by default


async def test_fault_partition_config_and_tick_seam_match():
    """faults.bus_* map to the same FaultSpec in both packages, and the
    tick seam installs and heals the partition at the port's BusServer on
    the configured ticks."""
    doc = {"development": True, "faults": {
        "enabled": True, "seed": 7, "bus_partition_groups": [["n0", "n1"], ["n2"]],
        "bus_partition_tick": 50, "bus_heal_at_tick": 200, "bus_asym_pairs": [["n2", "n0"]]}}
    jcfg = jconfig.load_config(yaml_text=json.dumps(doc))
    pcfg = pconfig.load_config(base=doc, env={})
    want = jfault.FaultInjector.from_config(jcfg.faults).spec
    inj = pfault.FaultInjector.from_config(pcfg.faults)
    assert vars(inj.spec) == vars(want)
    assert inj.spec.bus_partition_groups == (("n0", "n1"), ("n2",))
    from livekit_server_tpu_torch.routing.tcpbus import BusServer

    srv = BusServer()
    for tick in (49, 50, 50, 199, 200):
        inj.bus_partition_tick(srv, tick)
    assert inj.stats.partitions == 1 and inj.stats.heals == 1
    assert not srv._severed and not srv._asym
