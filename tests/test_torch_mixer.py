"""The MCU seat (runtime/mixer.py) against the JAX package's on the same
seeded Opus frames (skips without libopus, as tests/test_mixer.py does):

* both packages' AudioMixers over the same stub transport, on the host
  path (device_mix_min_rooms 99) and on the batched device path (1): the
  emitted packets byte-identical across the packages and across the
  paths, the stats equal;
* from DEVICE_MIX_MIN_ROOMS (64) rooms up the port takes the device path
  on its own and emits what the host path emits;
* `_device_mix` against the JAX package's at a small padded shape, and
  both against the numpy int32 sum with self-exclusion: bit-equal;
* self-exclusion across publish order, release_track and release_room,
  the reference's test_mixer_exclusion_tracks_publish_order_and_release
  sequence through both packages' rooms and signal handlers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import livekit_server_tpu.runtime.mixer as jmixer  # noqa: E402
from livekit_server_tpu_torch.interop import opus  # noqa: E402
from livekit_server_tpu_torch.runtime import mixer  # noqa: E402

pytestmark = pytest.mark.skipif(not opus.available(), reason="libopus not present")

SEED = 12


class StubTransport:
    """Just enough UDPMediaTransport surface for AudioMixer: ssrc mint,
    subscriber address book, and the _sendto chokepoint (captured)."""

    def __init__(self):
        self.sent = []
        self.sub_addrs = {}
        self.sub_sessions = {}
        self.stats = {"tx": 0}
        self._ssrc = 100

    def _new_ssrc(self):
        self._ssrc += 1
        return self._ssrc

    def _sendto(self, data, addr, session):
        self.sent.append((addr, data))


def seeded_frames(rooms: int, tracks: int, frames: int) -> dict:
    """Opus packets of seeded tones + noise per (room, track), encoded
    once so both packages' mixers decode the very same bytes."""
    rng = np.random.default_rng(SEED)
    out = {}
    for room in range(rooms):
        for track in range(tracks):
            enc = opus.OpusEncoder()
            f, amp = rng.uniform(150, 2500), rng.uniform(2000, 12000)
            pkts = []
            for k in range(frames):
                t = (np.arange(960) + k * 960) / 48000.0
                pcm = amp * np.sin(2 * np.pi * f * t) + rng.normal(0, 300, 960)
                pkts.append(enc.encode(np.clip(pcm, -32768, 32767).astype(np.int16)))
            out[(room, track)] = pkts
            enc.close()
    return out


def drive(make_mixer, rooms: int, tracks: int, frames: int, min_rooms: int | None):
    """Every room: sub 0 excludes track 0, sub 1 hears all, sub 2 excludes
    the last track (its only-own-voice frames are skipped when the others
    are silent); track 1 of odd rooms stops after 2 frames (PLC, then
    the TTL)."""
    pkts = seeded_frames(rooms, tracks, frames)
    t = StubTransport()
    m = make_mixer(t)
    if min_rooms is not None:
        m.device_mix_min_rooms = min_rooms
    for room in range(rooms):
        for sub, excl in ((0, 0), (1, -1), (2, tracks - 1)):
            t.sub_addrs[(room, sub)] = ("127.0.0.1", 4000 + room * 8 + sub)
            m.enable_sub(room, sub, exclude_track=excl)
    now = 100.0
    for k in range(frames):
        for (room, track), seq in pkts.items():
            if track == 1 and room % 2 and k >= 2:
                continue
            m.push(room, track, 960 * k, seq[k])
            m.rooms[room].tracks[track].last_seen = now
        m.tick(now)
        now += 0.02
    stats = dict(m.stats)
    m.close()
    return t.sent, stats


@pytest.mark.parametrize("min_rooms", [99, 1], ids=["host_path", "device_path"])
def test_mixer_packets_match_reference(min_rooms):
    got, gst = drive(lambda t: mixer.AudioMixer(t, device="cpu"), 3, 3, 8, min_rooms)
    want, wst = drive(jmixer.AudioMixer, 3, 3, 8, min_rooms)
    assert gst == wst
    assert gst["device_mix_frames"] == (8 if min_rooms == 1 else 0)
    assert gst["packets_out"] == len(got) > 3 * 2 * 8
    assert got == want
    # Across the paths too: the batching is a layout decision, not audio.
    other, _ = drive(lambda t: mixer.AudioMixer(t, device="cpu"), 3, 3, 8,
                     1 if min_rooms == 99 else 99)
    assert got == other


def test_device_path_taken_from_64_rooms():
    assert mixer.DEVICE_MIX_MIN_ROOMS == jmixer.DEVICE_MIX_MIN_ROOMS == 64
    assert (mixer.ACTIVE_TTL_S, mixer.PLC_MAX_FRAMES, mixer.OPUS_PT) == (
        jmixer.ACTIVE_TTL_S, jmixer.PLC_MAX_FRAMES, jmixer.OPUS_PT)
    got, gst = drive(lambda t: mixer.AudioMixer(t, device="cpu"), 64, 2, 3, None)
    host, hst = drive(lambda t: mixer.AudioMixer(t, device="cpu"), 64, 2, 3, 65)
    assert gst["device_mix_frames"] == 3 and hst["device_mix_frames"] == 0
    assert got == host


def host_mix(pcm, present, exclude) -> np.ndarray:
    """The host path's arithmetic: int32 sum of present tracks minus the
    subscriber's own, per room and subscriber."""
    R, T, N = pcm.shape
    out = np.zeros((R, exclude.shape[1], N), np.int64)
    for r in range(R):
        total = pcm[r][present[r]].astype(np.int64).sum(axis=0)
        for s in range(exclude.shape[1]):
            e = exclude[r, s]
            out[r, s] = total - (pcm[r, e] if e < T and present[r, e] else 0)
    return out


def test_device_mix_bit_equal_to_reference_and_host_sum():
    rng = np.random.default_rng(SEED)
    R, T, S, N = 5, 4, 4, 960
    pcm = rng.integers(-32768, 32768, (R, T, N)).astype(np.float32)
    pcm[0] = 32767.0                       # every track at full scale: clips
    present = rng.random((R, T)) < 0.8
    present[1] = False                     # a silent room
    exclude = rng.integers(0, T + 1, (R, S)).astype(np.int32)
    got = mixer._device_mix(torch.from_numpy(pcm), torch.from_numpy(present),
                            torch.from_numpy(exclude)).numpy()
    want = np.asarray(jmixer._device_mix(T, S, N)(
        jnp.asarray(pcm), jnp.asarray(present), jnp.asarray(exclude)))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got.astype(np.int64), host_mix(pcm, present, exclude))
    i16 = lambda x: np.clip(np.rint(x), -32768, 32767).astype(np.int16)  # noqa: E731
    assert np.array_equal(i16(got), np.clip(host_mix(pcm, present, exclude), -32768, 32767))


async def exclusion_sequence(pkg, runtime, transport, enc) -> list:
    """tests/test_mixer.py::test_mixer_exclusion_tracks_publish_order_and_
    release through one package's Room and signal handler, with a second
    opted-in participant; the mixer's rooms after each step."""
    room = pkg.rtc.Room("mix2", runtime)
    room.udp = transport
    p, q = (pkg.rtc.Participant(who, room, response_sink=pkg.channel(size=500))
            for who in ("alice", "bob"))
    room.join(p)
    room.join(q)
    seen = []

    def snap():
        seen.append({r: (sorted(rm.tracks), {s: lane.exclude_track
                                             for s, lane in rm.subs.items()})
                     for r, rm in transport.audio_mixer.rooms.items()})

    def signal(who, kind, data):
        pkg.rtc.handle_participant_signal(room, who, pkg.request(kind, data))

    # Opt in BEFORE publishing the mic (normal client ordering).
    signal(p, "subscription", {"track_sids": [], "audio_mix": True})
    signal(q, "subscription", {"track_sids": [], "audio_mix": True})
    snap()
    signal(p, "add_track", {"cid": "mic", "type": 0, "name": "mic"})
    track = p.publish_pending("mic")
    snap()
    # Bob excludes alice's column too (a stale exclusion the release scrubs).
    transport.audio_mixer.enable_sub(room.slots.row, q.sub_col, exclude_track=track.track_col)
    transport.audio_mixer.push(room.slots.row, track.track_col, 0, enc)
    snap()
    p.unpublish_track(track.info.sid)
    snap()
    # Republish: the new column becomes alice's exclusion again.
    signal(p, "add_track", {"cid": "mic2", "type": 0, "name": "mic"})
    p.publish_pending("mic2")
    snap()
    signal(q, "subscription", {"track_sids": [], "audio_mix": False})
    snap()
    transport.release_room(room.slots.row)
    snap()
    return seen


async def test_self_exclusion_across_publish_order_and_release():
    from types import SimpleNamespace

    import livekit_server_tpu.rtc as jrtc
    import livekit_server_tpu_torch.rtc as prtc
    from livekit_server_tpu.models import plane as jplane
    from livekit_server_tpu.protocol.signal import SignalRequest as JRequest
    from livekit_server_tpu.routing import MessageChannel as JChannel
    from livekit_server_tpu.runtime import PlaneRuntime as JRuntime
    from livekit_server_tpu.runtime.udp import start_udp_transport as jstart
    from livekit_server_tpu_torch.models import plane
    from livekit_server_tpu_torch.protocol.signal import SignalRequest
    from livekit_server_tpu_torch.routing import MessageChannel
    from livekit_server_tpu_torch.runtime import PlaneRuntime
    from livekit_server_tpu_torch.runtime.udp import start_udp_transport

    jax_pkg = SimpleNamespace(rtc=jrtc, request=JRequest, channel=JChannel, start=jstart,
                              runtime=lambda: JRuntime(jplane.PlaneDims(2, 3, 8, 4), tick_ms=10))
    port_pkg = SimpleNamespace(rtc=prtc, request=SignalRequest, channel=MessageChannel,
                               start=start_udp_transport,
                               runtime=lambda: PlaneRuntime(plane.PlaneDims(2, 3, 8, 4),
                                                            tick_ms=10, device="cpu"))
    enc = opus.OpusEncoder().encode(np.zeros(960, np.int16))
    out = []
    for pkg in (jax_pkg, port_pkg):
        rt = pkg.runtime()
        transport = await pkg.start(rt.ingest, "127.0.0.1", 0)
        if pkg is port_pkg:
            transport.mixer_device = "cpu"      # what RoomManager.attach_udp sets
        try:
            out.append(await exclusion_sequence(pkg, rt, transport, enc))
        finally:
            if transport.audio_mixer is not None:
                transport.audio_mixer.close()
            transport.transport.close()
            await rt.stop()
    want, got = out
    assert got == want
    before, published, fed, released, republished, bob_out, closed = got
    row = next(iter(before))
    assert before[row][1] == {0: -1, 1: -1}                  # opt-in before publish
    mic = published[row][1][0]
    assert mic >= 0 and fed[row][0] == [mic]                 # alice's column, its lane
    assert released[row] == ([], {0: -1, 1: -1})             # lane and exclusions scrubbed
    assert republished[row][1][0] >= 0
    assert bob_out[row][1] == {0: republished[row][1][0]}
    assert closed == {}
