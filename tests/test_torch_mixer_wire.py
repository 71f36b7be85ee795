"""The MCU seat through the port's server (create_server, device="cpu")
and its UDP transport on loopback, media sealed as the reference node
seals it (the port's counterparts of tests/test_mixer.py's wire tests;
skips without libopus):

* two publishers send distinct tones as sealed Opus RTP; a publisher that
  opted in with `subscription {"audio_mix": true}` receives ONE mixed
  Opus stream carrying the other's tone and not their own, and a
  listener receives both tones; the frame clock runs from the
  transport's send path, as on a serving node;
* the signal opt-in sets the lane's self-exclusion to the publisher's
  own track column, the opt-out and the participant's leave tear the
  lane down;
* an opt-out on a node that mixes nothing does not build a mixer.
"""

import asyncio
import base64

import aiohttp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.interop import opus  # noqa: E402
from livekit_server_tpu_torch.runtime import udp as udp_mod  # noqa: E402
from livekit_server_tpu_torch.runtime.crypto import MediaCryptoClient  # noqa: E402
from tests.test_torch_service import SignalClient, running_server  # noqa: E402
from tests.torch_udp_fixture import client_socket, drain, until  # noqa: E402

pytestmark = pytest.mark.skipif(not opus.available(), reason="libopus not present")


def tone(freq: float, frame: int) -> np.ndarray:
    t = (np.arange(960) + frame * 960) / 48000.0
    return (np.sin(2 * np.pi * freq * t) * 9000).astype(np.int16)


def rtp(ssrc: int, sn: int, ts: int, payload: bytes) -> bytes:
    return (bytes([0x80, 111]) + (sn & 0xFFFF).to_bytes(2, "big")
            + (ts & 0xFFFFFFFF).to_bytes(4, "big") + ssrc.to_bytes(4, "big") + payload)


def spectrum_peaks(pcm: np.ndarray, freqs) -> dict:
    mag = np.abs(np.fft.rfft(pcm.astype(float)))
    f = np.fft.rfftfreq(len(pcm), 1 / 48000.0)
    noise = np.median(mag) + 1e-9
    return {q: float(mag[(f > q - 60) & (f < q + 60)].max() / noise) for q in freqs}


async def attach_transport(server):
    rm = server.room_manager
    udp = await udp_mod.start_udp_transport(
        rm.runtime.ingest, "127.0.0.1", 0, crypto=rm.crypto,
        require_encryption=server.config.rtc.require_encryption,
        nack_resolver=rm.runtime.resolve_nacks)
    rm.attach_udp(udp)
    return udp, udp.transport.get_extra_info("sockname")[1]


class Peer:
    """A signal client with its own media socket and media key."""

    def __init__(self, session, server, udp, port):
        self.sig = SignalClient(session, server.port)
        self.udp, self.port = udp, port
        self.sock = client_socket()

    async def join(self, room: str, identity: str):
        mc = (await self.sig.connect(room, identity))["media_crypto"]
        self.key = MediaCryptoClient(mc["key_id"], base64.b64decode(mc["key"]))

    async def publish_mic(self) -> int:
        await self.sig.send_signal("add_track", {"cid": "mic", "type": 0, "name": "mic",
                                                 "transport": "udp"})
        self.sig.signals.clear()
        return (await self.sig.wait_for("request_response"))["udp_media"]["ssrc"]

    async def subscribe_udp(self, **extra):
        self.sig.signals.clear()
        await self.sig.send_signal("subscription", {"udp": True, **extra})
        punch = (await self.sig.wait_for("request_response"))["udp_punch"]["punch_id"]
        self.sock.sendto(self.key.seal(udp_mod.PUNCH_REQ + punch.to_bytes(4, "big")),
                         ("127.0.0.1", self.port))
        await until(lambda: self.sock.getsockname() in self.udp.sub_addrs.values(),
                    "the punch")

    def send(self, data: bytes):
        self.sock.sendto(self.key.seal(data), ("127.0.0.1", self.port))

    def opened(self) -> list[bytes]:
        out = []
        for f in drain(self.sock, media_only=False):
            d = self.key.open(f)
            if d is not None and d[:8] != udp_mod.PUNCH_ACK and not 192 <= d[1] <= 223:
                out.append(d)
        return out

    async def close(self):
        await self.sig.close()
        self.sock.close()


async def test_mixer_end_to_end_two_tones_and_self_exclusion():
    async with running_server() as server:
        udp, port = await attach_transport(server)
        async with aiohttp.ClientSession() as s:
            a, b, lis = (Peer(s, server, udp, port) for _ in range(3))
            for peer, name in ((a, "alice"), (b, "bob"), (lis, "carol")):
                await peer.join("mix", name)
            ssrc_a, ssrc_b = await a.publish_mic(), await b.publish_mic()
            # B publishes and mixes (never hears B); carol only listens.
            await b.subscribe_udp(audio_mix=True)
            await lis.subscribe_udp(audio_mix=True)
            mixer = udp.audio_mixer
            assert mixer is not None and mixer.device.type == "cpu"
            room = server.room_manager.rooms["mix"]
            row = room.slots.row
            lanes = mixer.rooms[row].subs
            b_part = room.participants["bob"]
            assert lanes[b_part.sub_col].exclude_track == next(
                t.track_col for t in b_part.published.values())
            mixed_ssrc = {peer: lanes[room.participants[n].sub_col].ssrc
                          for peer, n in ((b, "bob"), (lis, "carol"))}
            enc_a, enc_b = opus.OpusEncoder(), opus.OpusEncoder()
            dec = {b: opus.OpusDecoder(), lis: opus.OpusDecoder()}
            pcm = {b: [], lis: []}

            def collect():
                for peer in (b, lis):
                    for d in peer.opened():
                        if int.from_bytes(d[8:12], "big") == mixed_ssrc[peer]:
                            assert d[1] & 0x7F == 111
                            pcm[peer].append(dec[peer].decode(d[12:]))

            # 20 ms frames until both hold 20 mixed frames (a loaded host
            # ticks the frame clock late; the stream keeps going meanwhile).
            frame = 0
            while frame < 40 or min(map(len, pcm.values())) <= 20:
                assert frame < 1500, [len(v) for v in pcm.values()]
                a.send(rtp(ssrc_a, 100 + frame, 960 * frame, enc_a.encode(tone(440.0, frame))))
                b.send(rtp(ssrc_b, 200 + frame, 960 * frame, enc_b.encode(tone(1320.0, frame))))
                await asyncio.sleep(0.02)
                collect()
                frame += 1
            assert mixer.stats["frames_mixed"] > 10, mixer.debug_summary()
            tail_l = np.concatenate(pcm[lis][len(pcm[lis]) // 2:])
            tail_b = np.concatenate(pcm[b][len(pcm[b]) // 2:])
            pk_l = spectrum_peaks(tail_l, [440.0, 1320.0])
            pk_b = spectrum_peaks(tail_b, [440.0, 1320.0])
            assert pk_l[440.0] > 20 and pk_l[1320.0] > 20, pk_l
            assert pk_b[440.0] > 20, pk_b
            assert pk_b[1320.0] < pk_b[440.0] / 4, pk_b
            for peer in (a, b, lis):
                await peer.close()


async def test_mixer_signal_opt_in_and_teardown():
    async with running_server() as server:
        udp, port = await attach_transport(server)
        async with aiohttp.ClientSession() as s:
            alice = Peer(s, server, udp, port)
            await alice.join("mix", "alice")
            await alice.publish_mic()
            await alice.sig.send_signal("subscription", {"track_sids": [], "audio_mix": True})
            await until(lambda: udp.audio_mixer is not None, "the mixer")
            room = server.room_manager.rooms["mix"]
            p = room.participants["alice"]
            own = next(t.track_col for t in p.published.values())
            rm = udp.audio_mixer.rooms[room.slots.row]
            assert rm.subs[p.sub_col].exclude_track == own
            await alice.sig.send_signal("subscription", {"track_sids": [], "audio_mix": False})
            await until(lambda: room.slots.row not in udp.audio_mixer.rooms, "the opt-out")
            # Opt in again, then leave: the lane goes with the subscriber.
            await alice.sig.send_signal("subscription", {"track_sids": [], "audio_mix": True})
            await until(lambda: room.slots.row in udp.audio_mixer.rooms, "the opt-in")
            row = room.slots.row
            await alice.close()
            await until(lambda: row not in udp.audio_mixer.rooms, "the lane torn down on leave")


async def test_mixer_opt_out_does_not_instantiate():
    async with running_server() as server:
        udp, port = await attach_transport(server)
        async with aiohttp.ClientSession() as s:
            bob = Peer(s, server, udp, port)
            await bob.join("mix3", "bob")
            await bob.sig.send_signal("subscription", {"track_sids": [], "audio_mix": False})
            # Signals are handled in order: the pong follows the opt-out.
            await bob.sig.send_signal("ping", {"timestamp": 1})
            await bob.sig.wait_for("pong")
            assert udp.audio_mixer is None
            await bob.close()
