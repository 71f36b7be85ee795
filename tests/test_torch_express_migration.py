"""An express-tier room migrates with zero loss, in the port and in the
JAX package, on the same traffic (the reference's
tests/test_express.py::test_express_room_migrates_with_zero_loss).

The room is promoted to the express lane on node A, freezes, hands off
two-phase to node B (lane off there) and replays its freeze window on B
with no SN lost or duplicated, while A's tier state (activation, selector
mirror, subscriber words) resets with the row. The drill runs in both
packages and their outcomes must be equal.

Two settings differ from the reference's test, both of the test and not
of the lane: the freeze-window feed runs once, and the JAX nodes get a
5 s migration ack timeout. With the reference's 0.3 s, a cold JAX target
misses the first PREPARE, the source retries, and the reference's hook
feeds the window again on the second adoption, so 104 and 105 arrive
twice (ROADMAP C10). Its own file: servers with live loops, queued after
the timing-sensitive reference files.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.routing import MemoryBus as JBus  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JPacket  # noqa: E402
from livekit_server_tpu_torch.routing import MemoryBus as TBus  # noqa: E402
from livekit_server_tpu_torch.runtime import udp as tudp  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn as TPacket  # noqa: E402
from tests import test_migration as jmig  # noqa: E402
from tests import torch_cluster_fixture as tmig  # noqa: E402
from tests.torch_udp_fixture import client_socket  # noqa: E402


async def drill(pkg: str) -> dict:
    """Run the drill in one package; returns what it observed."""
    if pkg == "jax":
        bus, Packet, h = JBus(), JPacket, jmig
        mig = {"migration": {"ack_timeout_s": 5.0}}
    else:
        bus, Packet, h = TBus(), TPacket, tmig
        mig = {}
    a = b = None
    sub_sock = client_socket()
    try:
        a = await h.start_node(bus, plane={"express_max_subs": 2}, **mig)
        b = await h.start_node(bus, **mig)
        rm_a, rm_b = a.room_manager, b.room_manager
        rt_a, rt_b = rm_a.runtime, rm_b.runtime
        if rm_a.udp is None:        # the port's test nodes open no fixed media port
            rm_a.attach_udp(await tudp.start_udp_transport(rt_a.ingest, "127.0.0.1", 0))
        assert rt_a.express is not None and rt_b.express is None

        room = await rm_a.get_or_create_room("exmig")
        row_a = room.slots.row
        rt_a.set_track(row_a, 0, published=True, is_video=False)
        rt_a.set_subscription(row_a, 0, 1, subscribed=True)
        rm_a.udp.register_subscriber(row_a, 1, sub_sock.getsockname())
        await h.wait_for(lambda: bool(rt_a.express.active[row_a]),
                         what="express promotion on the source")
        for i in range(3):
            rt_a.ingest.push(Packet(room=row_a, track=0, sn=100 + i, ts=0, size=10,
                                    payload=b"x"))
        await h.pump_until(rt_a, row_a, 102)
        express_pkts = rt_a.express.stats["express_pkts"]
        # Express munges at push time: freeze only once the staging window
        # has drained (packets staged at the freeze would be bridged and
        # delivered again on the target, an at-most-once duplicate). The
        # port also bridges the serving loop's staged tick (ROADMAP C5),
        # so there the drain includes it.
        def drained():
            staged = getattr(rt_a, "_staged", None)
            return not (np.asarray(rt_a.ingest.valid[row_a]).any()
                        or (staged is not None and staged.inp.valid[row_a].any()))
        await h.wait_for(drained, what="staging drain before freeze")

        got_b = []
        rt_b.on_tick(lambda res: got_b.extend(
            p.sn for p in res.egress if p.track == 0 and p.sub == 1))
        rm_b.migration.on_adopt.append(
            lambda r: rt_b.set_subscription(r.slots.row, 0, 1, subscribed=True))
        fed = []

        def feed_window(r):
            # Freeze-window arrivals go to the bridge (never the lane) and
            # replay on the target; fed once, whatever the retries.
            if fed:
                return
            fed.append(r)
            for i in range(3, 6):
                rt_a.ingest.push(Packet(room=row_a, track=0, sn=100 + i, ts=0,
                                        size=10, payload=b"w"))
        rm_b.migration.on_adopt.append(feed_window)

        moved = await rm_a.migrate_room("exmig")
        row_b = rm_b.rooms["exmig"].slots.row
        await h.pump_until(rt_b, row_b, 105)
        # The fan-out of the lane's last tick lands after the lane moved.
        await h.wait_for(lambda: len(got_b) >= 3, what="the target's last fan-out")
        lane = rt_a.express
        return {
            "moved": moved,
            "express_pkts_ge_3": express_pkts >= 3,
            "got_b": sorted(got_b),
            "source_active": bool(lane.active.any()),
            "source_desired": bool(lane.desired[row_a]),
            "source_cur_sp_reset": bool((lane.cur_sp[row_a] == -1).all()),
            "source_words_reset": bool((lane.words[row_a] == 0).all()),
            "frozen_rows": sorted(rt_a.ingest.frozen_rows),
            "promotes": lane.stats["promotes"] >= 1,
        }
    finally:
        sub_sock.close()
        await h.stop_all(a, b)


async def test_express_room_migrates_with_zero_loss_in_both():
    ref = await drill("jax")
    port = await drill("port")
    assert port == ref
    assert port == {
        "moved": True, "express_pkts_ge_3": True, "got_b": [103, 104, 105],
        "source_active": False, "source_desired": False,
        "source_cur_sp_reset": True, "source_words_reset": True,
        "frozen_rows": [], "promotes": True,
    }
