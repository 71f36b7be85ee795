"""The port's rtc layer (Room, Participant, signal handling) over its
PlaneRuntime(device="cpu") against the JAX package's over the JAX
PlaneRuntime: one seeded script of joins, publishes, subscriptions,
mute/unmute, layer caps, a leave and media, stepped with step_once and
dispatched as RoomManager._dispatch_tick does, must give

- the same signal responses per participant, once the random sids are
  mapped by order of appearance and the wall-clock fields dropped; float
  fields (quality scores, speaker levels) within plane.float_tolerance;
- the same egress per tick and subscriber: track, sn, ts, pid, tl0,
  keyidx and payload exact.

The room layer reads a clock (PLI throttle, dynacast debounce); both
packages get the same virtual clock, advanced one tick per step. The
paged plane's run is tests/test_torch_rtc_paged.py (a 1-test file: its
JAX paged compile is the heaviest here, and such files queue last under
`--dist loadfile`)."""

import json
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import livekit_server_tpu.rtc.dynacast as jdynacast  # noqa: E402
import livekit_server_tpu.rtc.room as jroom  # noqa: E402
import livekit_server_tpu_torch.rtc.dynacast as tdynacast  # noqa: E402
import livekit_server_tpu_torch.rtc.room as troom  # noqa: E402
from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.protocol import signal as jsignal  # noqa: E402
from livekit_server_tpu.routing.messagechannel import MessageChannel as JChannel  # noqa: E402
from livekit_server_tpu.rtc import (  # noqa: E402
    Participant as JParticipant, Room as JRoom, handle_participant_signal as jhandle,
)
from livekit_server_tpu.runtime import PlaneRuntime as JRuntime  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JPacket  # noqa: E402
from livekit_server_tpu_torch.models import plane as tplane  # noqa: E402
from livekit_server_tpu_torch.protocol import signal as tsignal  # noqa: E402
from livekit_server_tpu_torch.routing.messagechannel import MessageChannel as TChannel  # noqa: E402
from livekit_server_tpu_torch.rtc import (  # noqa: E402
    Participant as TParticipant, Room as TRoom, handle_participant_signal as thandle,
)
from livekit_server_tpu_torch.runtime import PlaneRuntime as TRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn as TPacket  # noqa: E402

TICK_MS = 20
TICKS = 60           # the quality window closes at tick 49 (1000 / TICK_MS)
DIMS = (2, 4, 4, 4)
JAX = types.SimpleNamespace(Room=JRoom, Participant=JParticipant, Channel=JChannel,
                            handle=jhandle, Packet=JPacket, signal=jsignal,
                            room_mod=jroom, dynacast_mod=jdynacast)
PORT = types.SimpleNamespace(Room=TRoom, Participant=TParticipant, Channel=TChannel,
                             handle=thandle, Packet=TPacket, signal=tsignal,
                             room_mod=troom, dynacast_mod=tdynacast)
SID = re.compile(r"^(RM|PA|TR|ND|CO)_[A-Za-z0-9]{12}$")
WALL_CLOCK_KEYS = {"joined_at", "creation_time", "timestamp"}
# Signal floats derive from these output leaves.
FLOAT_TOL = max(tplane.float_tolerance("track_mos"), tplane.float_tolerance("track_bps"))


class VirtualClock:
    """time.time / time.monotonic for the rtc modules: one tick per step."""

    def __init__(self):
        self.t = 1_000_000.0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


def _script_media(rng, tick: int):
    """The tick's packets: (track name, fields). Alice's and Carol's Opus,
    one packet a tick with a seeded level; Bob's VP9-SVC picture, three
    spatial layers, a keyframe every 30 ticks."""
    out = [("a1", dict(sn=1000 + tick, ts=960 * tick, size=0, frame_ms=20,
                       audio_level=int(rng.integers(0, 128))))]
    if tick >= 3:
        out.append(("c1", dict(sn=50000 + tick, ts=5000 + 960 * tick, size=0, frame_ms=20,
                               audio_level=int(rng.integers(0, 128)))))
    for s in range(3):
        key = tick % 30 == 0
        out.append(("b1", dict(sn=(65530 + 3 * tick + s) & 0xFFFF, ts=3000 * tick, size=0,
                               layer=s, temporal=tick % 2, keyframe=key, layer_sync=key,
                               begin_pic=s == 0, marker=s == 2, pid=tick & 0x7FFF,
                               tl0=(tick // 2) & 0xFF, keyidx=tick // 30, frame_ms=33)))
    for _, f in out:
        f["payload"] = rng.integers(0, 256, int(rng.integers(20, 200)), dtype=np.uint8).tobytes()
        f["size"] = len(f["payload"])
    return out


def _dispatch(room, res) -> None:
    """RoomManager._dispatch_tick's room fan-out for one room."""
    for row, speakers in res.speakers.items():
        if row == room.slots.row:
            room.handle_speakers(speakers)
    seen = set()
    for row, col, _sub in res.need_keyframe:
        if row == room.slots.row and col not in seen:
            seen.add(col)
            room.handle_keyframe_request(col)
    if res.quality_window_closed and res.track_quality is not None:
        r = room.slots.row
        room.handle_quality(res.track_quality[r], res.track_mos[r], res.sub_quality[r])
        room.reconcile_dynacast()
        room.update_stream_states(res.target_layers[r])


async def _run(pkg, rt, monkeypatch):
    clock = VirtualClock()
    for mod in (pkg.room_mod, pkg.dynacast_mod):
        monkeypatch.setattr(mod, "time", clock)
    rng = np.random.default_rng(5)
    room = pkg.Room("parity", rt)
    sinks, people = {}, {}

    def join(identity):
        sinks[identity] = pkg.Channel(size=2000)
        p = pkg.Participant(identity, room, response_sink=sinks[identity])
        people[identity] = p
        p.send("join", room.join(p))

    def signal(identity, kind, data):
        pkg.handle(room, people[identity], pkg.signal.SignalRequest(kind, data))

    def sid(cid):
        return next(t.info.sid for p in people.values() for t in p.published.values()
                    if t.cid == cid)

    cols = {}

    def publish(identity, cid, video):
        signal(identity, "add_track", {
            "cid": cid, "name": cid, "type": int(video),
            "mime_type": "video/vp9" if video else "audio/opus",
            "layers": [{"quality": q, "width": 320 << q, "height": 180 << q}
                       for q in range(3)] if video else []})
        cols[cid] = people[identity].publish_pending(cid).track_col

    egress = []
    for tick in range(TICKS):
        if tick == 0:
            join("alice")
            join("bob")
            publish("alice", "a1", False)
            publish("bob", "b1", True)
        elif tick == 2:
            join("carol")
        elif tick == 3:
            publish("carol", "c1", False)
        elif tick == 8:
            signal("carol", "subscription", {"track_sids": [sid("b1")], "subscribe": False})
        elif tick == 16:
            signal("carol", "subscription", {"track_sids": [sid("b1")], "subscribe": True})
        elif tick == 12:
            signal("alice", "mute", {"sid": sid("a1"), "muted": True})
        elif tick == 20:
            signal("alice", "mute", {"sid": sid("a1"), "muted": False})
        elif tick == 24:
            signal("alice", "track_setting", {"track_sids": [sid("b1")], "quality": 0})
        elif tick == 40:
            signal("alice", "track_setting", {"track_sids": [sid("b1")], "quality": 2,
                                              "fps": 15})
        elif tick == 30:
            signal("bob", "track_setting", {"track_sids": [sid("a1")], "disabled": True})
        elif tick == 36:
            signal("bob", "track_setting", {"track_sids": [sid("a1")], "disabled": False})
        elif tick == 44:
            signal("carol", "leave", {})
        for cid, f in _script_media(rng, tick):
            if cid in cols and not (cid == "c1" and tick >= 44):
                rt.ingest.push(pkg.Packet(room=room.slots.row, track=cols[cid], **f))
        res = await rt.step_once()
        _dispatch(room, res)
        names = {col: cid for cid, col in cols.items()}
        egress.append(sorted(
            (room.sub_index[p.sub].identity, names[p.track], p.sn, p.ts, p.pid, p.tl0,
             p.keyidx, p.payload)
            for p in res.egress if p.sub in room.sub_index))
        clock.t += TICK_MS / 1000.0
    signals = {}
    for identity, sink in sinks.items():
        msgs = []
        while not sink._q.empty():
            raw = sink._q.get_nowait()
            if isinstance(raw, str):
                msgs.append(json.loads(raw))
        signals[identity] = msgs
    return signals, egress


def _normalize(obj, ids: dict):
    if isinstance(obj, dict):
        return {k: _normalize(v, ids) for k, v in obj.items() if k not in WALL_CLOCK_KEYS}
    if isinstance(obj, list):
        return [_normalize(v, ids) for v in obj]
    if isinstance(obj, str) and SID.match(obj):
        return ids.setdefault(obj, f"{obj[:3]}{len(ids)}")
    return obj


def _assert_close(a, b, path="") -> None:
    if isinstance(a, float) or isinstance(b, float):
        rtol, atol = FLOAT_TOL
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), path
        assert abs(a - b) <= atol + rtol * abs(b), f"{path}: {a} vs {b}"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), f"{path}: {a} vs {b}"
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), f"{path}: {a} vs {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _compare(jax_run, port_run) -> None:
    (jsig, jeg), (tsig, teg) = jax_run, port_run
    assert len(jeg) == len(teg) == TICKS
    for tick, (a, b) in enumerate(zip(jeg, teg)):
        assert a == b, f"tick {tick}: egress differs"
    assert sum(len(e) for e in teg) > 100
    assert jsig.keys() == tsig.keys()
    jids, tids = {}, {}
    for identity in jsig:
        a = _normalize(jsig[identity], jids)
        b = _normalize(tsig[identity], tids)
        assert [next(iter(m)) for m in a] == [next(iter(m)) for m in b], identity
        _assert_close(b, a, identity)
    kinds = {next(iter(m)) for msgs in tsig.values() for m in msgs}
    assert {"join", "track_published", "speakers_changed", "connection_quality",
            "mute"} <= kinds, kinds


async def test_rtc_layer_matches_reference_dense(monkeypatch):
    jrt = JRuntime(jplane.PlaneDims(*DIMS), tick_ms=TICK_MS)
    trt = TRuntime(tplane.PlaneDims(*DIMS), tick_ms=TICK_MS, egress_shards=1, device="cpu")
    _compare(await _run(JAX, jrt, monkeypatch), await _run(PORT, trt, monkeypatch))


def test_port_room_refuses_relay_and_reflects_sdp():
    """The port answers request_relay with the reference's no-relay reply
    and reflects an SDP offer (no UDP transport, as in the reference
    without one)."""
    rt = TRuntime(tplane.PlaneDims(*DIMS), tick_ms=TICK_MS, egress_shards=1, device="cpu")
    room = TRoom("r", rt)
    sink = TChannel()
    p = TParticipant("x", room, response_sink=sink)
    room.join(p)
    thandle(room, p, tsignal.SignalRequest("request_relay", {}))
    thandle(room, p, tsignal.SignalRequest("offer", {"sdp": "v=0 a=ice-ufrag:x"}))
    msgs = [json.loads(sink._q.get_nowait()) for _ in range(sink._q.qsize())]
    assert {"request_response": {"relay_info": None}} in msgs
    assert {"answer": {"type": "answer", "sdp": "v=0 a=ice-ufrag:x"}} in msgs
