"""The express lane through RoomManager against the JAX package's: both
packages' RoomManagers, built from the same config with the lane on
(plane.express_max_subs 2), their UDP transports on loopback wired as
each package's server wires them, participants joined through
start_session (p0 publishes VP8 simulcast, p1 Opus, over `transport:
udp`; everyone subscribes over UDP and punches from a socket of its
own), fed the same seeded sealed datagrams and stepped by hand for 20
ticks. One room has three participants (never express); another is
pinned to the batched tier for a few ticks (a demotion, then a
re-promotion). Every datagram each subscriber receives, sealed bytes
and all, is equal in both packages, in order per (destination, SSRC);
so are the lane's counters, promotions and demotions and every munger
lane. `secrets` and the transports' clock are seeded and virtual in
both packages (tests/test_torch_udp_parity.py `install`). Its own file:
one test, one JAX tick compile.
"""

import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.config.config import load_config as jload  # noqa: E402
from livekit_server_tpu.routing import LocalNode as JNode, LocalRouter as JRouter  # noqa: E402
from livekit_server_tpu.routing.messagechannel import MessageChannel as JChannel  # noqa: E402
from livekit_server_tpu.runtime import crypto as jcrypto, udp as judp  # noqa: E402
from livekit_server_tpu.service.roommanager import RoomManager as JManager  # noqa: E402
from livekit_server_tpu.service.store import LocalStore as JStore  # noqa: E402
from livekit_server_tpu_torch.config.config import load_config as tload  # noqa: E402
from livekit_server_tpu_torch.routing import LocalNode as TNode, LocalRouter as TRouter  # noqa: E402
from livekit_server_tpu_torch.routing.messagechannel import MessageChannel as TChannel  # noqa: E402
from livekit_server_tpu_torch.runtime import crypto as tcrypto, udp as tudp  # noqa: E402
from livekit_server_tpu_torch.service.roommanager import RoomManager as TManager  # noqa: E402
from livekit_server_tpu_torch.service.store import LocalStore as TStore  # noqa: E402
from tests.test_native import rtp_packet, vp8_payload  # noqa: E402
from tests.test_torch_udp_parity import Clock, install  # noqa: E402
from tests.torch_udp_fixture import HOST, client_socket, delivered, drain, until  # noqa: E402

SIZES = (2, 2, 3, 2)          # participants per room; room 2 is never express
TICKS = 20
TICK_MS = 50
PIN_ROOM, PIN_TICKS = 3, range(8, 12)
CONFIG = {
    "keys": {"k": "s"},
    "plane": {"rooms": 4, "tracks_per_room": 4, "pkts_per_track": 8, "subs_per_room": 4,
              "tick_ms": TICK_MS, "express_max_subs": 2},
    "rtc": {"udp_port": 0, "tcp_port": 0, "require_encryption": True},
    "room": {"empty_timeout_s": 600},
    "egress": {"shards": 1},
    "limits": {"governor_enabled": False},
    "supervisor": {"enabled": False},
    "integrity": {"enabled": False},
}


def attach_reference(rm, udp, cfg) -> None:
    """The JAX package's server wiring of a started transport
    (livekit_server_tpu/service/server.py, the UDP block of start)."""
    udp.on_pli = rm.handle_pli
    udp.attach_egress_plane(rm.runtime.egress_plane)
    udp.wire_stages = rm.runtime.wire_stages
    udp.attach_express(rm.runtime.express)
    udp.send_side_bwe = cfg.rtc.congestion_control.send_side_bwe
    if cfg.rtc.pacer == "no-queue":
        udp.pacer_spread_ms = cfg.plane.tick_ms / 2.0
    elif cfg.rtc.pacer == "leaky-bucket":
        udp.pacer_mode = "leaky-bucket"
    if cfg.room.playout_delay_max_ms > 0:
        udp.playout_delay = (cfg.room.playout_delay_min_ms, cfg.room.playout_delay_max_ms)
    rm.udp = udp
    for room in rm.rooms.values():
        room.udp = udp


class Node:
    """One package's RoomManager with the lane on, its transport, its
    participants' sessions and sockets."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        if pkg == "jax":
            self.cfg = jload(yaml_text=json.dumps(CONFIG), env={})
            self.rm = JManager(self.cfg, JRouter(JNode()), JStore())
            self.udp_mod, self.crypto_mod, self.channel = judp, jcrypto, JChannel
        else:
            self.cfg = tload(base=CONFIG, env={})
            self.rm = TManager(self.cfg, TRouter(TNode()), TStore(), device="cpu")
            self.udp_mod, self.crypto_mod, self.channel = tudp, tcrypto, TChannel
        self.rt = self.rm.runtime
        self.sessions, self.clients, self.socks = {}, {}, {}
        self.ssrc = {}

    def client(self, session):
        c = self.clients.get(session.key_id)
        if c is None:
            c = self.clients[session.key_id] = self.crypto_mod.MediaCryptoClient(
                session.key_id, session.key)
        return c

    async def start(self) -> None:
        rm, u = self.rm, self.udp_mod
        udp = await u.start_udp_transport(
            self.rt.ingest, HOST, 0, crypto=rm.crypto, require_encryption=True,
            nack_resolver=self.rt.resolve_nacks)
        if self.pkg == "jax":
            attach_reference(rm, udp, self.cfg)
        else:
            rm.attach_udp(udp)
        self.udp = udp
        self.port = udp.transport.get_extra_info("sockname")[1]
        for r, size in enumerate(SIZES):
            for t in range(size):
                req, resp = self.channel(size=4000), self.channel(size=4000)
                init = {"identity": f"p{t}", "name": f"p{t}", "auto_subscribe": True,
                        "grants": {"video": {"roomJoin": True, "room": f"room{r}"}}}
                task = asyncio.ensure_future(rm.start_session(f"room{r}", init, req, resp))
                self.sessions[(r, t)] = (req, task)
                # One at a time: both packages mint keys and SSRCs in one order.
                await until(lambda r=r, t=t: f"room{r}" in rm.rooms
                            and f"p{t}" in rm.rooms[f"room{r}"].participants, "the join")
        rooms = [rm.rooms[f"room{r}"] for r in range(len(SIZES))]
        for t, msg in enumerate((
                {"cid": "v", "name": "v", "type": 1, "mime_type": "video/vp8",
                 "transport": "udp", "layers": [{"quality": q} for q in range(2)]},
                {"cid": "a", "name": "a", "type": 0, "mime_type": "audio/opus",
                 "transport": "udp"})):
            for r, room in enumerate(rooms):
                self.sessions[(r, t)][0].write_message(json.dumps({"add_track": msg}))
                await until(lambda room=room, t=t: len(room.tracks) > t, "the track")
        for ssrc, b in udp.bindings.items():
            self.ssrc[(b.room, b.track, b.layer)] = ssrc
        for r, room in enumerate(rooms):
            for t in range(SIZES[r]):
                self.sessions[(r, t)][0].write_message(json.dumps({"subscription": {"udp": True}}))
                p = room.participants[f"p{t}"]
                await until(lambda r=r, p=p: (r, p.sub_col) in udp._punch_by_sub, "the punch id")
                c = self.client(p.crypto_session)
                sock = self.socks[(r, p.sub_col)] = client_socket()
                base = udp.stats["rx"]
                sock.sendto(c.seal(u.PUNCH_REQ + udp._punch_by_sub[(r, p.sub_col)]
                                   .to_bytes(4, "big")), (HOST, self.port))
                await delivered(udp, 1, base)
        self.pub_sock = client_socket()
        self.pub = {(b.room, b.track): self.client(b.session) for b in udp.bindings.values()}

    async def publish(self, tick: int) -> None:
        rng = np.random.default_rng(tick)
        base = self.udp.stats["rx"]
        n = 0
        for r in range(len(SIZES)):
            for layer in (0, 1):
                d = rtp_packet(sn=(65530 + 1000 * layer + tick) & 0xFFFF, ts=3000 * tick,
                               ssrc=self.ssrc[(r, 0, layer)], pt=96, marker=1,
                               payload=vp8_payload(pid=(32760 + 50 * layer + tick) & 0x7FFF,
                                                   tl0=(250 + tick) & 0xFF, tid=tick % 2,
                                                   ysync=1, keyidx=tick % 32,
                                                   keyframe=tick % 8 == 0)
                               + rng.integers(0, 256, 40 + 60 * layer, dtype=np.uint8).tobytes())
                self.pub_sock.sendto(self.pub[(r, 0)].seal(d), (HOST, self.port))
                n += 1
            d = rtp_packet(sn=500 + tick, ts=960 * tick, ssrc=self.ssrc[(r, 1, 0)],
                           pt=self.udp_mod.OPUS_PT, audio_level=30,
                           payload=rng.integers(0, 256, 30, dtype=np.uint8).tobytes())
            self.pub_sock.sendto(self.pub[(r, 1)].seal(d), (HOST, self.port))
            n += 1
        await delivered(self.udp, n, base)

    def collect(self, out: dict) -> None:
        for (r, s), sock in self.socks.items():
            for f in drain(sock, media_only=False):
                key_id = self.crypto_mod.parse_key_id(f)
                d = self.client(self.rm.crypto.get(key_id)).open(f)
                assert d is not None, "a sealed datagram did not open"
                if d[:8] == self.udp_mod.PUNCH_ACK or 192 <= d[1] <= 223:
                    continue
                out.setdefault(((r, s), int.from_bytes(d[8:12], "big")), []).append(f)

    async def close(self) -> None:
        for req, _task in self.sessions.values():
            req.close()
        await asyncio.wait_for(asyncio.gather(*(t for _, t in self.sessions.values()),
                                              return_exceptions=True), 30)
        await self.rm.stop()
        self.udp.transport.close()
        for sock in (self.pub_sock, *self.socks.values()):
            sock.close()


async def test_express_through_room_manager_matches_reference(monkeypatch):
    clock = Clock()
    install(monkeypatch, judp, jcrypto, clock)
    ref = Node("jax")
    await ref.start()
    install(monkeypatch, tudp, tcrypto, clock)
    port = Node("port")
    await port.start()
    assert ref.ssrc == port.ssrc
    got = {"ref": {}, "port": {}}
    try:
        for tick in range(TICKS):
            clock.ms = float(tick * TICK_MS)
            for node in (ref, port):
                node.rt.set_express_pin(PIN_ROOM, False if tick in PIN_TICKS else None)
                await node.publish(tick)
                await node.rt.step_once()
            await until(lambda: ref.udp.stats["tx"] == port.udp.stats["tx"], "equal tx")
            ref.collect(got["ref"])
            port.collect(got["port"])
            assert np.array_equal(ref.rt.express.active, port.rt.express.active), tick
        assert got["port"].keys() == got["ref"].keys()
        for key, frames in got["ref"].items():
            assert got["port"][key] == frames, f"datagrams to {key} differ"
        jx, tx = ref.rt.express, port.rt.express
        assert {k: int(v) for k, v in jx.stats.items()} == tx.stats
        for name in port.rt.munger.FIELDS:
            assert np.array_equal(getattr(ref.rt.munger, name),
                                  getattr(port.rt.munger, name)), name
        assert tx.stats["promotes"] >= 4 and tx.stats["demotes"] >= 1
        assert tx.stats["express_dgrams"] > 0 and not tx.active[2]
        assert port.udp.stats["tx"] > tx.stats["express_dgrams"]
    finally:
        await ref.close()
        await port.close()
