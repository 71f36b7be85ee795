"""The whole slice against the reference: the JAX package's server and the
port's server (device="cpu"), built from the same config (the port
overlay; the relay and the express lane off, as by default; the
supervisor and the integrity audit on, as the reference's defaults have
them; rtc.udp_port 0), each driven over real WebSockets by the same
three-party audio script. Every subscriber must receive the same
(publisher, sn, payload) sequence from both. The overload governor is
off in both: its ladder reads each host's wall-clock lateness, which the
two servers do not share (tests/test_torch_overload*.py hold the ladder
itself against the reference).

One test in its own file: it pays the JAX tick's compile."""

import asyncio
import json
import socket
import time

import aiohttp
import msgpack
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from livekit_server_tpu.auth import AccessToken, VideoGrant  # noqa: E402
from livekit_server_tpu.config import load_config as jax_load_config  # noqa: E402
from livekit_server_tpu.service.server import create_server as jax_create_server  # noqa: E402
from livekit_server_tpu_torch.config import load_config  # noqa: E402
from livekit_server_tpu_torch.config.config import port_overlay  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402

KEY, SECRET = "paritykey", "paritysecret"
PEOPLE = ("alice", "bob", "carol")
ROUNDS = 6


def _config_dict() -> dict:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    base = port_overlay()
    base["limits"] = {"governor_enabled": False}
    base.setdefault("plane", {}).update(
        rooms=2, tracks_per_room=4, pkts_per_track=4, subs_per_room=4, tick_ms=10)
    base.update(keys={KEY: SECRET}, port=port, bind_addresses=["127.0.0.1"],
                rtc={"udp_port": 0, "tcp_port": 0}, egress={"shards": 1})
    return base


def _token(identity: str) -> str:
    t = AccessToken(KEY, SECRET)
    t.identity = identity
    t.grant = VideoGrant(room_join=True, room="trio")
    return t.to_jwt()


async def _wait(cond, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.01)


async def _script(server) -> dict[str, list[tuple[int, int, bytes]]]:
    """Three participants publish one Opus track each; every packet is
    sent alone and awaited at both other subscribers before the next."""
    signals = {p: [] for p in PEOPLE}
    media = {p: [] for p in PEOPLE}
    async with aiohttp.ClientSession() as s:
        ws = {}

        async def read(p):
            async for msg in ws[p]:
                if msg.type == aiohttp.WSMsgType.TEXT:
                    signals[p].append(json.loads(msg.data))
                elif msg.type == aiohttp.WSMsgType.BINARY:
                    media[p].append(msgpack.unpackb(msg.data, raw=False))

        readers = []
        for p in PEOPLE:
            ws[p] = await s.ws_connect(
                f"ws://127.0.0.1:{server.port}/rtc?access_token={_token(p)}")
            readers.append(asyncio.ensure_future(read(p)))
            await _wait(lambda p=p: any("join" in m for m in signals[p]), f"{p} join")
        order = {}
        for i, p in enumerate(PEOPLE):
            await ws[p].send_str(json.dumps({"add_track": {"cid": "mic", "type": 0,
                                                           "name": "mic"}}))
            await _wait(lambda p=p: any("track_published" in m for m in signals[p]),
                        f"{p} track_published")
            sid = next(m["track_published"]["track"]["sid"] for m in signals[p]
                       if "track_published" in m)
            order[sid] = i

        def got(p, sn):
            return sum(1 for q in PEOPLE if q != p
                       for f in media[q] if f["payload"] == f"{p}{sn}".encode())

        for sn in range(99, 100 + ROUNDS):    # sn 99 binds the track
            for p in PEOPLE:
                await ws[p].send_bytes(msgpack.packb({
                    "cid": "mic", "sn": sn, "ts": 960 * sn, "payload": f"{p}{sn}".encode(),
                    "audio_level": 30, "frame_ms": 20}))
                await _wait(lambda p=p, sn=sn: got(p, sn) == 2, f"{p} sn {sn}")
        for w in ws.values():
            await w.close()
        for r in readers:
            r.cancel()
    return {p: [(order[f["track_sid"]], f["sn"], f["payload"]) for f in media[p]]
            for p in PEOPLE}


async def test_port_server_matches_reference_server():
    base = _config_dict()
    jax_server = jax_create_server(jax_load_config(yaml_text=json.dumps(base), env={}))
    await jax_server.start()
    try:
        want = await _script(jax_server)
    finally:
        await jax_server.stop(force=True)
    port_server = create_server(load_config(base=base, env={}), device="cpu")
    await port_server.start()
    try:
        got = await _script(port_server)
    finally:
        await port_server.stop(force=True)
    for p in PEOPLE:
        assert got[p] == want[p], p
        # Both other publishers' packets, the bind frame included, each once.
        assert len({order for order, _, _ in want[p]}) == 2
        assert len(want[p]) == 2 * (ROUNDS + 1)
