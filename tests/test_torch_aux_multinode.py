"""The port's egress/ingress aggregator (service/ioinfo.py) across nodes
and against the reference's.

* The counterpart of tests/test_multinode.py::
  test_egress_records_from_dead_node_reaped: two port nodes on one TCP
  bus adopt an ACTIVE egress a worker reported; once the worker's node is
  gone, each node's reaper fails the record after STALE_ACTIVE_S and
  drops it after ENDED_TTL_S, so ListEgress stays clean cluster-wide.
* The reaper against the JAX package's on the same records and the same
  clock: egresses, ingresses and SIP call receipts in every lifecycle
  state, reaped at the same instants; the records left, their fields and
  the telemetry events equal.
"""

import json
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers.
torch.set_num_threads(1)

from livekit_server_tpu.service import ioinfo as jioinfo  # noqa: E402
from livekit_server_tpu.service.egress import EgressInfo as JEgressInfo  # noqa: E402
from livekit_server_tpu.service.ingress import IngressInfo as JIngressInfo  # noqa: E402
from livekit_server_tpu_torch.service import ioinfo as pioinfo  # noqa: E402
from livekit_server_tpu_torch.service.egress import EgressInfo, EgressStatus  # noqa: E402
from livekit_server_tpu_torch.service.ingress import IngressInfo  # noqa: E402
from tests.torch_cluster_fixture import start_bus, start_tcp_node, wait_for  # noqa: E402


async def test_egress_records_from_dead_node_reaped():
    bus = await start_bus()
    try:
        srv_a, cl_a = await start_tcp_node(bus.port)
        srv_b, cl_b = await start_tcp_node(bus.port)
        try:
            # A worker (lived on some third node) reports an ACTIVE egress;
            # both aggregators adopt it.
            info = {
                "egress_id": "EG_dead", "room_name": "r", "kind": "track",
                "status": int(EgressStatus.ACTIVE), "started_at": 0,
                "ended_at": 0, "error": "", "request": {},
            }
            await cl_a.publish("egress_updates", json.dumps(info))
            await wait_for(lambda: all("EG_dead" in s.ioinfo.egresses for s in (srv_a, srv_b)),
                           what="both aggregators adopting the record")

            # The worker's node dies (no further updates). After the stale
            # window the record is failed...
            now = time.monotonic()
            for srv in (srv_a, srv_b):
                srv.ioinfo.reap(now + srv.ioinfo.STALE_ACTIVE_S + 1)
                rec = srv.ioinfo.egresses["EG_dead"]
                assert rec.status == EgressStatus.FAILED
                assert "lost" in rec.error
                assert [e["event"] for e in srv.telemetry.events][-1] == "egress_ended"
            # ...and after the ended TTL it is gone from every List.
            for srv in (srv_a, srv_b):
                srv.ioinfo.reap(time.monotonic() + srv.ioinfo.ENDED_TTL_S + 1)
                assert "EG_dead" not in srv.ioinfo.egresses
        finally:
            await srv_a.stop()
            await srv_b.stop()
            await cl_a.close()
            await cl_b.close()
    finally:
        bus.close()


def reaper_run(mod, egress_cls, ingress_cls) -> dict:
    """Seed one aggregator with records in every state, stamped at known
    instants, and reap it three times; return what is left and what it
    told telemetry."""
    events = []
    telemetry = SimpleNamespace(notify=lambda ev, **kw: events.append((ev, kw)))
    sip = SimpleNamespace(calls={"SCL_old": {"sip_call_id": "SCL_old"},
                                 "SCL_new": {"sip_call_id": "SCL_new"}})
    svc = mod.IOInfoService(SimpleNamespace(telemetry=telemetry, sip=sip, router=None))
    # The reaper stamps what it fails with the real monotonic clock, so
    # the seeded stamps and the reap instants are taken relative to it.
    t0 = time.monotonic()
    egresses = {"EG_live": 1, "EG_stale": 1, "EG_done": 3, "EG_old_done": 4, "EG_start": 0,
                "EG_limit": 6}
    for i, (eid, status) in enumerate(egresses.items()):
        svc.egresses[eid] = egress_cls.from_dict({
            "egress_id": eid, "room_name": f"r{i}", "kind": "track", "status": status,
            "started_at": 1, "ended_at": 0, "error": "", "request": {}})
    ingresses = {"IN_pub": 2, "IN_stale_pub": 2, "IN_idle": 0, "IN_done": 4, "IN_err": 3}
    for iid, state in ingresses.items():
        svc.ingresses[iid] = ingress_cls.from_dict({"ingress_id": iid, "name": iid,
                                                    "state": state})
    ended, day = mod.IOInfoService.ENDED_TTL_S, mod.IOInfoService.SIP_CALL_TTL_S
    ages = {"EG_live": 100, "EG_stale": 1000, "EG_done": 100, "EG_old_done": ended + 100,
            "EG_start": 1000, "EG_limit": ended + 100, "IN_pub": 100, "IN_stale_pub": 1000,
            "IN_idle": day + 100, "IN_done": ended + 100, "IN_err": 100,
            "SCL_old": day + 100}
    svc._stamp.update({k: t0 - age for k, age in ages.items()})
    left = []
    for now in (t0, t0 + 1.0, t0 + mod.IOInfoService.ENDED_TTL_S):
        svc.reap(now)
        left.append({
            "egress": {k: (int(v.status), v.error) for k, v in sorted(svc.egresses.items())},
            "ingress": {k: (int(v.state), v.error) for k, v in sorted(svc.ingresses.items())},
            "sip": sorted(sip.calls),
        })
    ev = []
    for name, kw in events:
        rec = dict(next(iter(kw.values())))
        rec.pop("ended_at", None)           # wall-clock second of the reap
        ev.append((name, rec))
    return {"left": left, "events": ev}


def test_reaper_matches_the_reference():
    got = reaper_run(pioinfo, EgressInfo, IngressInfo)
    want = reaper_run(jioinfo, JEgressInfo, JIngressInfo)
    assert got == want
    for name in ("REAP_INTERVAL_S", "ENDED_TTL_S", "STALE_ACTIVE_S", "SIP_CALL_TTL_S"):
        assert getattr(pioinfo.IOInfoService, name) == getattr(jioinfo.IOInfoService, name)
    first = got["left"][0]
    assert first["egress"]["EG_stale"] == (int(EgressStatus.FAILED), "egress worker lost")
    assert "EG_old_done" not in first["egress"] and "EG_live" in first["egress"]
    assert first["ingress"]["IN_stale_pub"] == (3, "ingress worker lost")
    assert "IN_idle" in got["left"][-1]["ingress"]      # configurations are durable
    assert first["sip"] == ["SCL_new"]
    assert first["egress"]["EG_start"][0] == int(EgressStatus.FAILED)
    assert "EG_old_done" not in first["egress"] and "EG_limit" not in first["egress"]
    last = got["left"][-1]
    assert last["egress"]["EG_live"][0] == int(EgressStatus.FAILED)
    assert "EG_done" not in last["egress"] and "EG_stale" in last["egress"]
    assert last["sip"] == ["SCL_new"]
    assert [n for n, _ in got["events"]] == ["egress_ended", "egress_ended", "ingress_ended",
                                             "egress_ended", "ingress_ended"]
