"""The port's egress, ingress, SIP and agent services over its real HTTP/WS
server (device="cpu"): the six flows of tests/test_aux_services.py
(egress lifecycle, ingress CRUD, SIP CRUD and dispatch, the agent room-job
flow, a non-agent token refused, egress worker updates over a bus), and
one cross-package test: the same sequence of Twirp requests to a JAX
server and a port server, each on its own MemoryBus with a fake egress
worker, must give equal status codes and equal JSON bodies once the
generated ids and the wall-clock stamps are normalised (see `normalise`).
"""

import asyncio
import contextlib
import json
import re

import aiohttp
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from livekit_server_tpu.config import load_config as jax_load_config  # noqa: E402
from livekit_server_tpu.routing import MemoryBus as JaxMemoryBus  # noqa: E402
from livekit_server_tpu.service.server import create_server as jax_create_server  # noqa: E402
from livekit_server_tpu_torch.auth import AccessToken, VideoGrant  # noqa: E402
from livekit_server_tpu_torch.config import load_config  # noqa: E402
from livekit_server_tpu_torch.config.config import port_overlay  # noqa: E402
from livekit_server_tpu_torch.routing import MemoryBus  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402
from tests.test_torch_service import (  # noqa: E402
    API_KEY,
    API_SECRET,
    SignalClient,
    _free_port,
    running_server,
)
from tests.torch_udp_fixture import until  # noqa: E402


def service_token(**grant_kw) -> str:
    t = AccessToken(API_KEY, API_SECRET)
    t.identity = "svc"
    t.grant = VideoGrant(**grant_kw)
    return t.to_jwt()


def bearer(**grant_kw) -> dict:
    return {"Authorization": f"Bearer {service_token(**grant_kw)}"}


@contextlib.asynccontextmanager
async def bus_server(make):
    """A server built by `make(cfg, bus)` on its own MemoryBus
    (kv.kind external: the multi-node router and store over the bus)."""
    cfg_dict = port_overlay()
    cfg_dict["limits"] = {"governor_enabled": False}
    cfg_dict.setdefault("plane", {}).update(
        rooms=2, tracks_per_room=4, pkts_per_track=4, subs_per_room=4, tick_ms=10)
    cfg_dict.update(keys={API_KEY: API_SECRET}, port=_free_port(),
                    bind_addresses=["127.0.0.1"], rtc={"udp_port": 0, "tcp_port": 0},
                    egress={"shards": 1}, kv={"kind": "external"})
    srv = make(cfg_dict)
    await srv.start()
    try:
        yield srv
    finally:
        await srv.stop(force=True)


def port_bus_server():
    return bus_server(lambda d: create_server(load_config(base=d, env={}), bus=MemoryBus(),
                                              device="cpu"))


async def test_egress_api_lifecycle():
    async with running_server() as server:
        base = f"http://127.0.0.1:{server.port}/twirp/livekit.Egress"
        hdr = bearer(room_record=True)
        async with aiohttp.ClientSession() as s:
            # no worker listening → aborted with explicit error
            async with s.post(f"{base}/StartRoomCompositeEgress", json={"room_name": "r"},
                              headers=hdr) as r:
                info = await r.json()
                assert info["egress_id"].startswith("EG_")
                assert info["status"] == 5  # ABORTED
                assert "no egress workers" in info["error"]
            async with s.post(f"{base}/StopEgress", json={"egress_id": info["egress_id"]},
                              headers=hdr) as r:
                assert r.status == 400      # already ended
            async with s.post(f"{base}/ListEgress", json={"room_name": "r"},
                              headers=hdr) as r:
                assert [e["egress_id"] for e in (await r.json())["items"]] == [
                    info["egress_id"]]
            # permission guard: roomJoin is not roomRecord
            bad = bearer(room_join=True, room="r")
            async with s.post(f"{base}/ListEgress", json={}, headers=bad) as r:
                assert r.status == 403
            async with s.post(f"{base}/ListEgress", json={},
                              headers={"Authorization": "Bearer garbage"}) as r:
                assert r.status == 401


async def test_ingress_api_crud():
    async with running_server() as server:
        base = f"http://127.0.0.1:{server.port}/twirp/livekit.Ingress"
        hdr = bearer(ingress_admin=True)
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{base}/CreateIngress", headers=hdr, json={
                    "name": "stream", "room_name": "live", "participant_identity": "obs",
                    "input_type": 0}) as r:
                info = await r.json()
                assert info["ingress_id"].startswith("IN_")
                assert info["stream_key"].startswith("SK_")
            async with s.post(f"{base}/UpdateIngress", headers=hdr,
                              json={"ingress_id": info["ingress_id"], "room_name": "live2"}) as r:
                assert (await r.json())["room_name"] == "live2"
            async with s.post(f"{base}/ListIngress", json={"room_name": "live2"},
                              headers=hdr) as r:
                assert len((await r.json())["items"]) == 1
            async with s.post(f"{base}/DeleteIngress", json={"ingress_id": info["ingress_id"]},
                              headers=hdr) as r:
                assert r.status == 200
            async with s.post(f"{base}/ListIngress", json={}, headers=hdr) as r:
                assert (await r.json())["items"] == []
            async with s.post(f"{base}/ListIngress", json={},
                              headers=bearer(room_admin=True)) as r:
                assert r.status == 403      # roomAdmin is not ingressAdmin


async def test_sip_api_crud_and_dispatch():
    async with port_bus_server() as server:
        base = f"http://127.0.0.1:{server.port}/twirp/livekit.SIP"
        hdr = bearer(room_admin=True)
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{base}/CreateSIPOutboundTrunk", headers=hdr, json={
                    "name": "pstn", "address": "sip.example.com",
                    "numbers": ["+15550100"]}) as r:
                trunk = await r.json()
                assert trunk["sip_trunk_id"].startswith("ST_")
                assert trunk["kind"] == "outbound"
            async with s.post(f"{base}/CreateSIPDispatchRule", headers=hdr, json={
                    "name": "direct", "trunk_ids": [trunk["sip_trunk_id"]],
                    "rule": {"dispatch_rule_direct": {"room_name": "callroom"}}}) as r:
                rule = await r.json()
                assert rule["sip_dispatch_rule_id"].startswith("SDR_")
            call_req = {"sip_trunk_id": trunk["sip_trunk_id"], "sip_call_to": "+15550123",
                        "room_name": "callroom", "participant_identity": "caller"}
            # outbound call with no SIP worker → 503
            async with s.post(f"{base}/CreateSIPParticipant", json=call_req,
                              headers=hdr) as r:
                assert r.status == 503
            # with a worker on the bus, the dial job dispatches
            jobs = server.router.bus.subscribe("sip_jobs")
            async with s.post(f"{base}/CreateSIPParticipant", json=call_req,
                              headers=hdr) as r:
                call = await r.json()
                assert call["sip_call_id"].startswith("SCL_")
            job = json.loads(await jobs.read(timeout=2))
            assert job["kind"] == "dial" and job["call"]["sip_call_to"] == "+15550123"
            jobs.close()
            # a room-scoped admin token may not manage trunks
            async with s.post(f"{base}/ListSIPTrunk", json={},
                              headers=bearer(room_admin=True, room="callroom")) as r:
                assert r.status == 403
            async with s.post(f"{base}/DeleteSIPTrunk",
                              json={"sip_trunk_id": trunk["sip_trunk_id"]}, headers=hdr) as r:
                assert r.status == 200
            async with s.post(f"{base}/ListSIPTrunk", json={}, headers=hdr) as r:
                assert (await r.json())["items"] == []


async def test_agent_worker_room_job_flow():
    async with running_server() as server:
        async with aiohttp.ClientSession() as s:
            ws = await s.ws_connect(
                f"ws://127.0.0.1:{server.port}/agent?access_token={service_token(agent=True)}")
            await ws.send_str(json.dumps({"register": {"namespace": "default", "job_type": 0}}))
            reg = json.loads((await ws.receive()).data)["registered"]
            assert reg["worker_id"].startswith("AW_")

            # a participant joins → room created → job offered to the worker
            alice = SignalClient(s, server.port)
            await alice.connect("agent-room", "alice")
            offer = json.loads((await asyncio.wait_for(ws.receive(), 3)).data)["job_offer"]
            assert offer["job"]["room_name"] == "agent-room"
            assert offer["job"]["job_type"] == 0
            job_id = offer["job"]["job_id"]

            await ws.send_str(json.dumps({"availability": {"job_id": job_id,
                                                           "available": True}}))
            await until(lambda: server.agents.jobs[job_id].state == "running",
                        "the job running")

            # the agent joins the room with the offered token
            agent = await s.ws_connect(
                f"ws://127.0.0.1:{server.port}/rtc?access_token={offer['token']}")
            for _ in range(5):
                msg = json.loads((await agent.receive()).data)
                if "join" in msg:
                    break
            assert "join" in msg
            await agent.close()

            await ws.send_str(json.dumps({"ping": {}}))
            assert json.loads((await ws.receive()).data) == {"pong": {}}
            await ws.send_str(json.dumps({"job_update": {"job_id": job_id, "state": "done"}}))
            await until(lambda: server.agents.jobs[job_id].state == "done", "the job done")
            await ws.close()
            await alice.close()


async def test_agent_rejects_non_agent_token():
    async with running_server() as server:
        async with aiohttp.ClientSession() as s:
            url = f"http://127.0.0.1:{server.port}/agent?access_token="
            async with s.get(url + service_token(room_join=True, room="x")) as r:
                assert r.status == 401
            async with s.get(url + "garbage") as r:
                assert r.status == 401


async def test_egress_worker_updates_over_bus():
    """Full dispatch → active → ended flow with a fake worker on a bus."""
    async with port_bus_server() as server:
        bus = server.router.bus
        jobs = bus.subscribe("egress_jobs")
        base = f"http://127.0.0.1:{server.port}/twirp/livekit.Egress"
        hdr = bearer(room_record=True)
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{base}/StartWebEgress", json={"room_name": "w"},
                              headers=hdr) as r:
                assert (await r.json())["status"] == 0      # STARTING
            job = json.loads(await jobs.read(timeout=2))
            assert job["kind"] == "start"
            egress = job["egress"]
            for status in (1, 3):                           # ACTIVE, then COMPLETE
                egress["status"] = status
                await bus.publish("egress_updates", json.dumps(egress))
                await until(lambda st=status: server.egress.egresses[
                    egress["egress_id"]].status == st, f"egress status {status}")
            events = [e["event"] for e in server.telemetry.events]
            assert "egress_started" in events and "egress_ended" in events
        jobs.close()


# -- the same requests to both packages' servers -----------------------------

GENERATED = re.compile(r"^(EG|IN|SK|ST|SDR|SCL)_[0-9A-Za-z]+$")
STAMPS = ("started_at", "ended_at")


def normalise(body, seen: dict):
    """Generated ids (EG_, IN_, SK_, ST_, SDR_, SCL_ prefixes) become
    "<prefix>#n", n their order of first appearance in the server's
    sequence, so references between bodies (a rule's trunk_ids) still
    compare; `started_at` and `ended_at` become whether they are set.
    Nothing else is changed."""
    if isinstance(body, dict):
        return {k: (bool(v) if k in STAMPS else normalise(v, seen)) for k, v in body.items()}
    if isinstance(body, list):
        return [normalise(v, seen) for v in body]
    if isinstance(body, str) and GENERATED.match(body):
        return seen.setdefault(body, f"{body.split('_')[0]}#{len(seen)}")
    return body


async def twirp_script(server) -> list:
    """Egress, ingress and SIP calls, good and bad, with a fake egress
    worker on the server's bus; returns (status, normalised body) each."""
    seen: dict = {}
    out = []
    bus = server.router.bus
    root = f"http://127.0.0.1:{server.port}/twirp/livekit."
    rec, ing, adm = bearer(room_record=True), bearer(ingress_admin=True), bearer(room_admin=True)
    async with aiohttp.ClientSession() as s:
        async def call(path, body, hdr):
            async with s.post(root + path, json=body, headers=hdr) as r:
                out.append((path, r.status, normalise(await r.json(), seen)))
                return await r.json()

        aborted = await call("Egress/StartRoomCompositeEgress", {"room_name": "a"}, rec)
        await call("Egress/StopEgress", {"egress_id": aborted["egress_id"]}, rec)     # 400
        jobs = bus.subscribe("egress_jobs")
        started = await call("Egress/StartTrackEgress", {"room_name": "b", "track_id": "TR_x"},
                             rec)
        job = json.loads(await jobs.read(timeout=2))
        out.append(("egress_jobs", job["kind"], normalise(job["egress"], seen)))
        job["egress"]["status"] = 1                                               # ACTIVE
        await bus.publish("egress_updates", json.dumps(job["egress"]))
        await until(lambda: server.egress.egresses[started["egress_id"]].status == 1,
                    "the worker's update")
        await call("Egress/UpdateLayout", {"egress_id": started["egress_id"], "layout": "grid"},
                   rec)
        job = json.loads(await jobs.read(timeout=2))
        out.append(("egress_jobs", job["kind"], normalise(job, seen)))
        await call("Egress/ListEgress", {}, rec)
        await call("Egress/StopEgress", {"egress_id": started["egress_id"]}, rec)
        await call("Egress/StopEgress", {"egress_id": "EG_missing"}, rec)
        await call("Egress/ListEgress", {"room_name": "b"}, rec)
        await call("Egress/NoSuchMethod", {}, rec)
        await call("Egress/ListEgress", {}, adm)                                  # 403
        jobs.close()
        made = await call("Ingress/CreateIngress", {"name": "s", "room_name": "live",
                                                    "input_type": 1, "reusable": True}, ing)
        await call("Ingress/UpdateIngress", {"ingress_id": made["ingress_id"],
                                             "participant_name": "OBS"}, ing)
        await call("Ingress/ListIngress", {"room_name": "live"}, ing)
        await call("Ingress/DeleteIngress", {"ingress_id": made["ingress_id"]}, ing)
        await call("Ingress/DeleteIngress", {"ingress_id": made["ingress_id"]}, ing)  # 404
        await call("Ingress/ListIngress", {}, rec)                                # 403
        trunk = await call("SIP/CreateSIPInboundTrunk", {"name": "in", "numbers": ["+1555"],
                                                         "allowed_addresses": ["10.0.0.1"]}, adm)
        await call("SIP/CreateSIPDispatchRule", {"name": "r", "trunk_ids": [trunk["sip_trunk_id"]],
                                                 "rule": {"dispatch_rule_individual": {
                                                     "room_prefix": "call-"}}}, adm)
        await call("SIP/ListSIPTrunk", {}, adm)
        await call("SIP/ListSIPDispatchRule", {}, adm)
        sip_jobs = bus.subscribe("sip_jobs")
        await call("SIP/CreateSIPParticipant", {"sip_trunk_id": trunk["sip_trunk_id"],
                                                "sip_call_to": "+1666", "room_name": "c"}, adm)
        job = json.loads(await sip_jobs.read(timeout=2))
        out.append(("sip_jobs", job["kind"], normalise(job, seen)))
        sip_jobs.close()
        await call("SIP/CreateSIPParticipant", {"sip_trunk_id": "ST_missing"}, adm)   # 404
        await call("SIP/TransferSIPParticipant", {"room_name": "other"},
                   bearer(room_admin=True, room="c"))                             # 403
        await call("SIP/DeleteSIPTrunk", {"sip_trunk_id": trunk["sip_trunk_id"]}, adm)
        await call("SIP/DeleteSIPDispatchRule", {"sip_dispatch_rule_id": "SDR_x"}, adm)  # 404
    return out


async def test_twirp_answers_match_the_reference_server():
    jax_srv = bus_server(lambda d: jax_create_server(
        jax_load_config(yaml_text=json.dumps(d), env={}), bus=JaxMemoryBus()))
    async with jax_srv as server:
        want = await twirp_script(server)
    async with port_bus_server() as server:
        got = await twirp_script(server)
    assert len(got) == len(want) == 28
    for g, w in zip(got, want):
        assert g == w
    assert {code for _, code, _ in want if isinstance(code, int)} >= {200, 400, 403, 404}
