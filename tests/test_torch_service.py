"""The port's server (livekit_server_tpu_torch.service.server) over real
HTTP + WebSocket with device="cpu": health and validate, token checks,
join/publish/subscribe media over the WS, the RoomService API, /metrics
and /debug, the ConfigError of every subsystem the port does not carry,
`serve` (refused without a card, or without aiohttp; answering GET /
with --device cpu, with the supervisor, the integrity audit and the
governor on and /debug/overload and /debug/integrity answering), and the UDP media wire through the server (sealed RTP
from a publisher's socket to a punched subscriber's). The test client
speaks the reference's wire: JSON signal frames and media frames packed
and read with `msgpack`."""

import asyncio
import base64
import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import aiohttp
import msgpack
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from livekit_server_tpu_torch import cli  # noqa: E402
from livekit_server_tpu_torch.auth import AccessToken, VideoGrant  # noqa: E402
from livekit_server_tpu_torch.config import ConfigError, load_config  # noqa: E402
from livekit_server_tpu_torch.config import config as config_mod  # noqa: E402
from livekit_server_tpu_torch.config.config import UNPORTED, port_overlay  # noqa: E402
from livekit_server_tpu_torch.runtime import udp as udp_mod  # noqa: E402
from livekit_server_tpu_torch.runtime.crypto import MediaCryptoClient  # noqa: E402
from livekit_server_tpu_torch.service.server import connect_bus, create_server  # noqa: E402
from tests.test_native import rtp_packet  # noqa: E402
from tests.torch_udp_fixture import client_socket, drain, until  # noqa: E402

API_KEY, API_SECRET = "testkey", "testsecret"
ROOT = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_config(port: int, **extra):
    """The reference test config's shape, on the port overlay. The
    overload governor is off: its ladder reads wall-clock lateness, and on
    a loaded test host 80 late ticks in a row (under a second at 10 ms)
    would refuse these tests' joins at L4. The tests of the governor turn
    it on (`running_server(governor=True)`)."""
    base = port_overlay()
    base["limits"] = {"governor_enabled": False}
    base.setdefault("plane", {}).update(
        rooms=4, tracks_per_room=4, pkts_per_track=4, subs_per_room=4, tick_ms=10)
    # No fixed media ports (parallel test workers would contend for them)
    # and one egress shard (no worker threads beside other test workers).
    base.update(keys={API_KEY: API_SECRET}, port=port, bind_addresses=["127.0.0.1"],
                room={"empty_timeout_s": 2}, rtc={"udp_port": 0, "tcp_port": 0},
                egress={"shards": 1}, **extra)
    return load_config(base=base, env={})


def token(identity: str, room: str, **grant_kw) -> str:
    t = AccessToken(API_KEY, API_SECRET)
    t.identity = identity
    t.grant = VideoGrant(room_join=True, room=room, **grant_kw)
    return t.to_jwt()


def admin_token(room: str = "") -> str:
    t = AccessToken(API_KEY, API_SECRET)
    t.identity = "admin"
    t.grant = VideoGrant(room_admin=True, room_create=True, room_list=True, room=room)
    return t.to_jwt()


class SignalClient:
    """A reference-wire client: JSON signal TEXT frames, msgpack media."""

    def __init__(self, session: aiohttp.ClientSession, port: int):
        self.session, self.port = session, port
        self.ws = None
        self.signals: list = []
        self.media: list = []
        self._reader: asyncio.Task | None = None

    async def connect(self, room: str, identity: str, query: str = ""):
        self.ws = await self.session.ws_connect(
            f"ws://127.0.0.1:{self.port}/rtc?access_token={token(identity, room)}{query}")
        self._reader = asyncio.ensure_future(self._read())
        return await self.wait_for("join")

    async def _read(self):
        async for msg in self.ws:
            if msg.type == aiohttp.WSMsgType.TEXT:
                self.signals.append(json.loads(msg.data))
            elif msg.type == aiohttp.WSMsgType.BINARY:
                self.media.append(msgpack.unpackb(msg.data, raw=False))

    async def wait_for(self, kind: str, timeout: float = 5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for m in self.signals:
                if kind in m:
                    return m[kind]
            await asyncio.sleep(0.01)
        raise TimeoutError(f"no {kind!r} in {self.signals}")

    async def send_signal(self, kind: str, data: dict):
        await self.ws.send_str(json.dumps({kind: data}))

    async def send_media(self, **frame):
        await self.ws.send_bytes(msgpack.packb(frame))

    async def close(self):
        if self._reader:
            self._reader.cancel()
        if self.ws is not None:
            await self.ws.close()


@contextlib.asynccontextmanager
async def running_server(governor: bool = False):
    cfg = make_config(_free_port())
    cfg.limits.governor_enabled = governor
    srv = create_server(cfg, device="cpu")
    await srv.start()
    try:
        yield srv
    finally:
        await srv.stop(force=True)


async def test_health_validate_and_bad_tokens():
    async with running_server() as server:
        base = f"http://127.0.0.1:{server.port}"
        assert server.room_manager.runtime.device.type == "cpu"
        assert server.room_manager.runtime.warm
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{base}/") as r:
                assert r.status == 200
            async with s.get(f"{base}/rtc/validate?access_token={token('a', 'r')}") as r:
                assert r.status == 200
            async with s.get(f"{base}/rtc/validate?access_token=garbage") as r:
                assert r.status == 401
            async with s.get(f"{base}/rtc") as r:
                assert r.status == 401
            t = AccessToken(API_KEY, API_SECRET)
            t.identity = "x"
            t.grant = VideoGrant(room_list=True)  # no roomJoin
            async with s.get(f"{base}/rtc?access_token={t.to_jwt()}") as r:
                assert r.status == 401


async def test_join_publish_subscribe_media():
    """The single-publisher flow over the wire; bob reads the port's media
    frames with msgpack, and carol takes the binary signal framing."""
    async with running_server() as server:
        async with aiohttp.ClientSession() as s:
            alice, bob, carol = (SignalClient(s, server.port) for _ in range(3))
            join_a = await alice.connect("lobby", "alice")
            assert join_a["participant"]["identity"] == "alice"
            join_b = await bob.connect("lobby", "bob")
            assert [p["identity"] for p in join_b["other_participants"]] == ["alice"]
            carol.ws = await s.ws_connect(
                f"ws://127.0.0.1:{server.port}/rtc?access_token={token('carol', 'lobby')}"
                "&signal=binary")
            while True:    # binary signal frames: 0x00 | [kind id, data]; join is id 0
                msg = await carol.ws.receive(timeout=5)
                assert msg.type == aiohttp.WSMsgType.BINARY and msg.data[0] == 0
                kind_id, data = msgpack.unpackb(msg.data[1:], raw=False)
                if kind_id == 0:
                    break
            assert data["participant"]["identity"] == "carol"
            await carol.ws.close()

            await alice.send_signal("add_track", {"cid": "mic", "type": 0, "name": "mic"})
            track_sid = (await alice.wait_for("track_published"))["track"]["sid"]
            await alice.send_media(cid="mic", sn=99, ts=0, payload=b"bind", audio_level=20,
                                   frame_ms=20)
            await bob.wait_for("track_subscribed")
            for i in range(5):
                await alice.send_media(cid="mic", sn=100 + i, ts=960 * i,
                                       payload=b"opus" + bytes([i]), audio_level=20,
                                       frame_ms=20)
                deadline = time.monotonic() + 8.0
                while not any(m["sn"] == 100 + i for m in bob.media):
                    assert time.monotonic() < deadline, f"sn {100 + i} never delivered"
                    await asyncio.sleep(0.01)
            sns = [m["sn"] for m in bob.media]
            assert [x for x in sns if x >= 100][:5] == [100, 101, 102, 103, 104]
            frame = next(m for m in bob.media if m["sn"] == 100)
            assert set(frame) == {"track_sid", "sn", "ts", "pid", "tl0", "keyidx", "payload"}
            assert frame["payload"] == b"opus\x00" and frame["track_sid"] == track_sid
            assert not alice.media              # never back to the publisher
            server.room_manager.sample_traffic()
            for i in range(5, 40):
                await alice.send_media(cid="mic", sn=100 + i, ts=960 * i, payload=b"x",
                                       audio_level=18, frame_ms=20)
                await asyncio.sleep(0.012)
            spk = await bob.wait_for("speakers_changed", timeout=5)
            assert spk["speakers"][0]["sid"] == join_a["participant"]["sid"]
            rm = server.room_manager
            rm.sample_traffic()
            traffic = rm.participant_traffic(rm.rooms["lobby"])
            assert traffic["alice"]["rx_pps"] > 0 and traffic["bob"]["tx_pps"] > 0
            await alice.close()
            await bob.close()


async def test_room_service_api():
    async with running_server() as server:
        async with aiohttp.ClientSession() as s:
            hdr = {"Authorization": f"Bearer {admin_token('api-room')}"}
            base = f"http://127.0.0.1:{server.port}/twirp/livekit.RoomService"
            async with s.post(f"{base}/CreateRoom", json={"name": "api-room"}, headers=hdr) as r:
                assert r.status == 200 and (await r.json())["name"] == "api-room"
            async with s.post(f"{base}/ListRooms", json={}, headers=hdr) as r:
                assert "api-room" in [x["name"] for x in (await r.json())["rooms"]]
            alice = SignalClient(s, server.port)
            await alice.connect("api-room", "alice")
            async with s.post(f"{base}/ListParticipants", json={"room": "api-room"},
                              headers=hdr) as r:
                assert [p["identity"] for p in (await r.json())["participants"]] == ["alice"]
            async with s.post(f"{base}/UpdateRoomMetadata",
                              json={"room": "api-room", "metadata": "hello"}, headers=hdr) as r:
                assert (await r.json())["metadata"] == "hello"
            await alice.wait_for("room_update")
            async with s.post(f"{base}/RemoveParticipant",
                              json={"room": "api-room", "identity": "alice"}, headers=hdr) as r:
                assert r.status == 200
            await alice.wait_for("leave")
            async with s.post(f"{base}/DeleteRoom", json={"room": "api-room"}, headers=hdr) as r:
                assert r.status == 200
            await alice.close()
            async with s.post(f"{base}/DeleteRoom", json={"room": "x"},
                              headers={"Authorization": f"Bearer {token('u', 'x')}"}) as r:
                assert r.status == 403
            async with s.post(f"{base}/ListParticipants", json={"room": "other-room"},
                              headers=hdr) as r:
                assert r.status == 403


async def test_metrics_and_debug_routes():
    async with running_server() as server:
        base = f"http://127.0.0.1:{server.port}"
        async with aiohttp.ClientSession() as s:
            alice = SignalClient(s, server.port)
            await alice.connect("m", "alice")
            async with s.get(f"{base}/metrics") as r:
                assert "livekit_events_total" in await r.text()
            async with s.get(f"{base}/debug/rooms") as r:
                dbg = await r.json()
                assert dbg["rooms"]["m"]["participants"] == ["alice"]
                assert dbg["plane"]["ticks"] >= 1 and "late_ticks" in dbg["plane"]
            async with s.get(f"{base}/debug/ticks") as r:
                body = await r.json()
                assert "pipeline_stalls" in body["stats"] and body["recent_ticks"]
            async with s.get(f"{base}/debug/pager") as r:
                assert (await r.json())["paged"] is False
            async with s.get(f"{base}/debug/blackbox/m") as r:
                assert [e["event"] for e in (await r.json())["events"]][:2] == [
                    "room_open", "join"]
            async with s.get(f"{base}/debug/trace?ticks=2") as r:
                assert r.status == 200
                assert (await r.json())["traceEvents"]
            async with s.get(f"{base}/debug/compiles") as r:
                assert r.status == 404
            # Single node (kv.kind memory): the multi-node planes are off.
            async with s.get(f"{base}/debug/fleet") as r:
                assert await r.json() == {"enabled": False, "fleet": None}
            async with s.get(f"{base}/debug/migration") as r:
                mig = await r.json()
                assert not mig["enabled"] and mig["frozen_rows"] == []
            await alice.close()


async def test_udp_media_through_the_server():
    """The reference's default media wire through create_server: alice
    announces a UDP track and sends sealed RTP from her socket; bob asks
    for UDP media, punches from his socket and receives the sealed stream
    there (none of it over his WebSocket); /debug/ticks reports the
    forward latency and /debug/egress the transport's datagrams."""
    async with running_server() as server:
        rm = server.room_manager
        udp = await udp_mod.start_udp_transport(
            rm.runtime.ingest, "127.0.0.1", 0, crypto=rm.crypto,
            require_encryption=server.config.rtc.require_encryption,
            nack_resolver=rm.runtime.resolve_nacks)
        rm.attach_udp(udp)          # rtc.udp_port on an ephemeral port
        port = udp.transport.get_extra_info("sockname")[1]
        async with aiohttp.ClientSession() as s:
            alice, bob = SignalClient(s, server.port), SignalClient(s, server.port)
            keys = []
            for c, name in ((alice, "alice"), (bob, "bob")):
                mc = (await c.connect("lobby", name))["media_crypto"]
                keys.append(MediaCryptoClient(mc["key_id"], base64.b64decode(mc["key"])))
            a_key, b_key = keys
            await alice.send_signal("add_track", {"cid": "mic", "type": 0, "name": "mic",
                                                  "transport": "udp"})
            ssrc = (await alice.wait_for("request_response"))["udp_media"]["ssrc"]
            await bob.send_signal("subscription", {"udp": True})
            punch = (await bob.wait_for("request_response"))["udp_punch"]["punch_id"]
            a_sock, b_sock = client_socket(), client_socket()
            b_sock.sendto(b_key.seal(udp_mod.PUNCH_REQ + punch.to_bytes(4, "big")),
                          ("127.0.0.1", port))
            await until(lambda: b_sock.getsockname() in udp.sub_addrs.values(), "the punch")
            await bob.wait_for("track_subscribed")
            got = []

            def media(n: int) -> bool:
                for f in drain(b_sock, media_only=False):
                    d = b_key.open(f)
                    if d is not None and d[:8] != udp_mod.PUNCH_ACK and not 192 <= d[1] <= 223:
                        got.append(d)
                return len(got) >= n

            for i in range(5):
                a_sock.sendto(a_key.seal(rtp_packet(sn=100 + i, ts=960 * i, ssrc=ssrc,
                                                    audio_level=20,
                                                    payload=b"opus" + bytes([i]))),
                              ("127.0.0.1", port))
                await until(lambda i=i: media(i + 1), f"sn {100 + i} at bob's socket")
            assert [int.from_bytes(d[2:4], "big") for d in got] == [100, 101, 102, 103, 104]
            assert [d[-5:] for d in got] == [b"opus" + bytes([i]) for i in range(5)]
            assert not any(m["sn"] >= 100 for m in bob.media)   # not over the WS
            base = f"http://127.0.0.1:{server.port}"
            async with s.get(f"{base}/debug/ticks") as r:
                assert (await r.json())["forward_latency"]["n"] >= 5
            async with s.get(f"{base}/debug/egress") as r:
                assert (await r.json())["tx_total"] >= 5
            await alice.close()
            await bob.close()
            a_sock.close()
            b_sock.close()


def test_unported_subsystems_raise_config_error():
    """Each subsystem the port does not carry, turned on, is refused at
    construction with the ROADMAP item that brings it (none is left: the
    refusal of a listed entry is tested in test_torch_parallel_service);
    the relay and the express lane are carried and build, off by
    default."""
    for path, _enabled, _off, item in UNPORTED:
        section, leaf = path.split(".")
        cfg = make_config(_free_port())
        setattr(getattr(cfg, section), leaf, True)
        with pytest.raises(ConfigError, match=item.split(" ")[0]) as err:
            create_server(cfg, device="cpu")
        assert path in str(err.value)
    # The device mesh is ported (A10): nothing stays refused, and
    # plane.mesh_devices is read by nothing, as in the reference. The
    # relay, the express lane and the UDP/TCP media ports build.
    assert UNPORTED == ()
    cfg = make_config(_free_port())
    cfg.plane.mesh_devices = 8
    assert create_server(cfg, device="cpu").room_manager.runtime._mesh is None
    cfg = make_config(_free_port())
    assert not cfg.relay.enabled and cfg.plane.express_max_subs == 0
    cfg.relay.enabled, cfg.plane.express_max_subs = True, 4
    rm = create_server(cfg, device="cpu").room_manager
    assert rm.runtime.express is not None and rm.runtime.express.max_subs == 4
    cfg = make_config(_free_port())
    cfg.rtc.udp_port, cfg.rtc.tcp_port = 7882, 7881
    assert create_server(cfg, device="cpu").room_manager.udp is None  # opens at start
    # kv.kind tcp dials the bus and fails loudly when it cannot; a kind
    # without a bundled client is refused; memory stays single-node.
    for kind, err in (("tcp", OSError), ("redis", ConfigError)):
        cfg = make_config(_free_port())
        cfg.kv.kind, cfg.kv.address = kind, "127.0.0.1:1"
        with pytest.raises(err):
            asyncio.run(connect_bus(cfg))
    cfg = make_config(_free_port())
    cfg.kv.kind = "tcp"
    with pytest.raises(ConfigError, match="kv.address"):
        asyncio.run(connect_bus(cfg))
    cfg = make_config(_free_port())
    cfg.kv.kind = "memory"
    server = create_server(cfg, device="cpu")
    assert type(server.router).__name__ == "LocalRouter"
    assert type(server.store).__name__ == "LocalStore"
    rm = server.room_manager
    assert rm.migration is None and rm.fleet is None
    # Any other kind, or an injected bus, builds the KV router and store
    # and, on the reference's defaults, the migration and fleet planes.
    cfg = make_config(_free_port())
    cfg.kv.kind = ""
    server = create_server(cfg, device="cpu")
    assert type(server.router).__name__ == "KVRouter"
    assert type(server.store).__name__ == "KVStore"
    rm = server.room_manager
    assert type(rm.migration).__name__ == "MigrationOrchestrator"
    assert type(rm.fleet).__name__ == "FleetPlane"
    assert rm.migration.selector is server.stack.selector
    assert rm.supervisor.room_checkpoint_cb == rm.checkpoint_rooms


def test_serve_refuses_without_a_card_or_aiohttp(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = str(_free_port())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--dev", "--port", port])
    real = cli.importlib.util.find_spec
    monkeypatch.setattr(cli.importlib.util, "find_spec",
                        lambda name, *a: None if name == "aiohttp" else real(name, *a))
    assert cli.main(["serve", "--dev", "--device", "cpu", "--port", port]) == 3
    assert "aiohttp" in capsys.readouterr().err
    # An explicit YAML/flag enabling an unported subsystem is refused too
    # (the shipped list is empty since the mesh was ported: one entry is
    # patched in).
    monkeypatch.setattr(cli.importlib.util, "find_spec", real)
    monkeypatch.setattr(config_mod, "UNPORTED", (
        ("plane.express_max_subs", lambda v: v > 0, 0, "A99 (test entry)"),))
    with pytest.raises(ConfigError, match="plane.express_max_subs"):
        cli.main(["serve", "--dev", "--device", "cpu", "--port", port,
                  "--plane.express-max-subs", "2"])


@contextlib.contextmanager
def _serve_dev_cpu():
    """`python -m livekit_server_tpu_torch serve --dev --device cpu` on a
    free port, answering GET / with 200; yields (base URL, the process's
    stdout lines read so far, as a list the caller may extend after
    exit)."""
    port = _free_port()
    # One intra-op thread, as in this process: the suite runs beside
    # timing-sensitive tests in other workers.
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "livekit_server_tpu_torch", "serve", "--dev", "--device", "cpu",
         "--port", str(port), "--plane.rooms", "4", "--plane.subs-per-room", "4",
         "--rtc.udp-port", "0", "--rtc.tcp-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out: list[str] = []
    try:
        deadline, status = time.monotonic() + 120, None
        while status != 200:
            assert proc.poll() is None, "serve exited"
            assert time.monotonic() < deadline, "no answer on GET /"
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2) as r:
                    status = r.status
            except OSError:
                time.sleep(0.2)
        yield f"http://127.0.0.1:{port}", out
    finally:
        proc.terminate()
        out.append(proc.communicate(timeout=30)[0])


def test_serve_dev_cpu_answers_health():
    """`python -m livekit_server_tpu_torch serve --dev --device cpu`
    prints the overlay, then answers GET / with 200."""
    with _serve_dev_cpu() as (_base, out):
        pass
    text = "".join(out)
    assert "port overlay" in text and "turned off): {}" in text
    assert '"migration"' not in text and '"fleet"' not in text
    assert '"supervisor"' not in text and '"integrity"' not in text


def test_serve_dev_cpu_runs_the_failure_and_overload_plane():
    """`serve --dev --device cpu` runs with the supervisor, the integrity
    audit and the governor on, as the reference's defaults have them, and
    /debug/overload and /debug/integrity answer."""
    def get(url):
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200
            return json.loads(r.read())

    with _serve_dev_cpu() as (base, _out):
        deadline = time.monotonic() + 60
        while (integ := get(f"{base}/debug/integrity"))["integrity"]["audits"] < 1:
            assert time.monotonic() < deadline, "no integrity audit ran"
            time.sleep(0.2)
        overload = get(f"{base}/debug/overload")
    assert integ["config"]["enabled"]
    assert set(integ["restart_causes"]) == {"stall", "integrity"}
    assert integ["integrity"]["audit_every_ticks"] == 16
    assert integ["checksum"]["frames_encoded"] >= 0
    gov = overload["governor"]
    assert gov is not None and 0 <= gov["level"] <= 4
    assert gov["thresholds"]["escalate_ticks"] == 20
    assert overload["limits"]["governor_enabled"] is True
    assert isinstance(overload["supervisor_restarts"], int)
