"""The media relay through the port's whole server, with the express lane
on (the reference's tests/test_relay.py::test_relay_through_full_server).

A publisher and a subscriber that never touch the SFU media port: relay
allocations minted over the signal channel (`request_relay`), a sealed
punch and sealed media both ways through the embedded relay that
RoomManager.start_transports opens beside rtc.udp_port. The server runs
with relay.enabled and plane.express_max_subs=2, both off by default:
the two-party room rides the express lane, and /debug/ticks reports the
lane and its forward latency. Its own file: a server with a live
serving loop, queued after the timing-sensitive reference files.
"""

import asyncio
import base64
import socket

import aiohttp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.runtime.crypto import MediaCryptoClient  # noqa: E402
from livekit_server_tpu_torch.runtime.relay import BIND_ACK, BIND_REQ, RELAY_MAGIC  # noqa: E402
from livekit_server_tpu_torch.runtime.udp import PUNCH_ACK, PUNCH_REQ  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402
from tests.conftest import free_port  # noqa: E402
from tests.test_native import rtp_packet  # noqa: E402
from tests.test_torch_service import SignalClient, _free_port, make_config  # noqa: E402
from tests.torch_udp_fixture import client_socket, drain, until  # noqa: E402


async def test_relay_and_express_through_full_server():
    cfg = make_config(_free_port())
    cfg.rtc.require_encryption = True
    cfg.rtc.udp_port = free_port(socket.SOCK_DGRAM)
    cfg.relay.enabled = True
    cfg.relay.udp_port = free_port(socket.SOCK_DGRAM)
    cfg.plane.express_max_subs = 2
    server = create_server(cfg, device="cpu")
    await server.start()
    socks = {}
    try:
        rm = server.room_manager
        assert rm.media_relay is not None and rm.runtime.express is not None
        relay_addr = ("127.0.0.1", cfg.relay.udp_port)
        async with aiohttp.ClientSession() as s:
            alice, bob = SignalClient(s, server.port), SignalClient(s, server.port)
            crypt = {}
            for who, client in (("a", alice), ("b", bob)):
                mc = (await client.connect("relay-room", who))["media_crypto"]
                crypt[who] = MediaCryptoClient(mc["key_id"], base64.b64decode(mc["key"]))

            async def rr(client, key):
                """The request_response carrying `key`."""
                found = []
                await until(lambda: found.extend(
                    m["request_response"] for m in client.signals
                    if key in m.get("request_response", {})) or found, key)
                return found[0][key]

            for who, client in (("a", alice), ("b", bob)):
                await client.send_signal("request_relay", {})
                info = await rr(client, "relay_info")
                assert (info["host"], info["port"]) == relay_addr
                sk = socks[who] = client_socket()
                sk.sendto(RELAY_MAGIC + bytes([BIND_REQ]) + bytes.fromhex(info["token"]),
                          relay_addr)
                acks = []
                await until(lambda sk=sk: acks.extend(drain(sk, media_only=False)) or acks,
                            "the BIND ack")
                assert acks[0][4] == BIND_ACK

            await alice.send_signal("add_track", {"cid": "mic", "type": 0, "name": "m",
                                                  "transport": "udp"})
            media_info = await rr(alice, "udp_media")
            await bob.wait_for("track_subscribed")
            await bob.send_signal("subscription", {"track_sids": [media_info["track_sid"]],
                                                   "subscribe": True, "udp": True})
            punch = int((await rr(bob, "udp_punch"))["punch_id"])
            socks["b"].sendto(crypt["b"].seal(PUNCH_REQ + punch.to_bytes(4, "big")),
                              relay_addr)
            got = []

            def media(n: int) -> bool:
                for f in drain(socks["b"], media_only=False):
                    d = crypt["b"].open(f)
                    if d is not None and d[:8] != PUNCH_ACK and not 192 <= d[1] <= 223:
                        got.append(d)
                return len(got) >= n

            row = rm.rooms["relay-room"].slots.row
            await until(lambda: bool(rm.runtime.express.active[row]), "express promotion")
            for i in range(20):
                # One packet a tick window: the lane answers at once, and a
                # track stages at most plane.pkts_per_track packets a tick.
                tick = rm.runtime.tick_index
                await until(lambda tick=tick: rm.runtime.tick_index > tick, "the next tick")
                socks["a"].sendto(
                    crypt["a"].seal(rtp_packet(sn=300 + i, ts=960 * i,
                                               ssrc=media_info["ssrc"], audio_level=20,
                                               payload=b"via-relay" + bytes([i]))),
                    relay_addr)
                await until(lambda i=i: media(i + 1), f"sn {300 + i} through the relay")
            assert [int.from_bytes(d[2:4], "big") for d in got] == list(range(300, 320))
            assert [d[-10:] for d in got] == [b"via-relay" + bytes([i]) for i in range(20)]
            st = rm.media_relay.stats
            assert st["binds"] == 2 and st["up_fwd"] >= 21 and st["down_fwd"] >= 20
            assert rm.runtime.express.stats["express_dgrams"] > 0
            async with s.get(f"http://127.0.0.1:{server.port}/debug/ticks") as r:
                body = await r.json()
            assert body["express"]["promotes"] >= 1
            assert body["forward_latency_express"]["n"] > 0
            await alice.close()
            await bob.close()
    finally:
        for sk in socks.values():
            sk.close()
        await server.stop(force=True)
        await asyncio.sleep(0)
