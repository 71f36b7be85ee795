"""The port's express lane (livekit_server_tpu_torch/runtime/express.py),
held to the cases of the JAX package's tests/test_express.py.

The load-bearing claim is bit-equivalence: an express room's wire output
(SN/TS/VP8 descriptor rewrites, payload bytes, marker) is identical to
what the batched tick produces for the same packets. The rest pins the
seams the lane honours exactly like the batched tier: governor shedding,
integrity quarantine, migration freeze, NACK replay and the fast-path /
slow-path subscriber split, and the paged runtime's hooks. Runtimes run
on the CPU (device="cpu"), stepped by hand. The UDP wire and the
cross-package wire comparison are in tests/test_torch_express_wire.py,
the migration drill in both packages in
tests/test_torch_express_migration.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.config.config import ConfigError  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402
from tests.conftest import free_port  # noqa: E402
from tests.torch_cluster_fixture import make_cfg  # noqa: E402

DIMS = plane.PlaneDims(rooms=2, tracks=2, pkts=4, subs=4)


def runtime(**kw) -> PlaneRuntime:
    return PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu", **kw)


def tap_express(rt):
    """A sender hook that materializes every express entry into plain
    dicts (payload bytes copied out of the live slab at send time, when a
    real sender reads them)."""
    out = []

    def sender(cols):
        for i in range(len(cols)):
            off, ln = int(cols.pay_off[i]), int(cols.pay_len[i])
            out.append({
                "room": int(cols.rooms[i]), "track": int(cols.tracks[i]),
                "sub": int(cols.subs[i]),
                "sn": int(cols.sn[i]) & 0xFFFF,
                "ts": int(cols.ts[i]) & 0xFFFFFFFF,
                "pid": int(cols.pid[i]), "tl0": int(cols.tl0[i]),
                "keyidx": int(cols.keyidx[i]),
                "payload": bytes(cols.slab[off:off + ln]),
                "marker": bool(cols.marker[i]),
            })
        return len(cols)

    rt.express.sender = sender
    return out


def ekey(e: dict):
    return (e["room"], e["track"], e["sub"], e["sn"], e["ts"], e["pid"],
            e["tl0"], e["keyidx"], e["payload"], e["marker"])


def pkey(p):
    return (p.room, p.track, p.sub, p.sn, p.ts, p.pid, p.tl0, p.keyidx,
            p.payload, p.marker)


def push_av(rt, w: int) -> None:
    """One video (layer 2 = default target, keyframe on w=0) + one audio
    packet for window w, the same bytes on every runtime under test."""
    rt.ingest.push(PacketIn(
        room=0, track=0, sn=500 + w, ts=3000 * w, size=60,
        payload=b"vid-%d-payload" % w, marker=True, layer=2, temporal=0,
        keyframe=(w == 0), layer_sync=(w == 0), begin_pic=True,
        pid=700 + w, tl0=w, keyidx=w % 32))
    rt.ingest.push(PacketIn(
        room=0, track=1, sn=100 + w, ts=960 * w, size=20,
        payload=b"aud-%d" % w, audio_level=30))


def setup_av(rt) -> None:
    rt.set_track(0, 0, published=True, is_video=True)
    rt.set_track(0, 1, published=True, is_video=False)
    for s in (1, 2):
        rt.set_subscription(0, 0, s, subscribed=True)
        rt.set_subscription(0, 1, s, subscribed=True)


def push_audio(rt, sn: int, payload: bytes = b"x") -> None:
    rt.ingest.push(PacketIn(room=0, track=0, sn=sn, ts=0, size=len(payload),
                            payload=payload))


async def promoted_audio_room(**kw):
    """An audio room with subscriber 1, promoted after two windows."""
    rt = runtime(express_max_subs=2, **kw)
    rt.set_track(0, 0, published=True, is_video=False)
    rt.set_subscription(0, 0, 1, subscribed=True)
    ex = tap_express(rt)
    for w in range(2):
        push_audio(rt, 100 + w)
        await rt.step_once()
    assert rt.express.active[0]
    return rt, ex


async def test_express_wire_output_byte_identical_to_batched():
    """The same packets through an express-tier runtime and a batched-only
    one give the identical multiset of wire tuples per subscriber, and the
    munger lanes end at the same point (one sequencing space)."""
    rt_ex, rt_ba = runtime(express_max_subs=2), runtime()
    setup_av(rt_ex)
    setup_av(rt_ba)
    ex_entries = tap_express(rt_ex)
    out_ex, out_ba = [], []
    for w in range(6):
        push_av(rt_ex, w)
        push_av(rt_ba, w)
        res_ex = await rt_ex.step_once()
        res_ba = await rt_ba.step_once()
        out_ex.extend(pkey(p) for p in res_ex.egress if not p.padding)
        out_ba.extend(pkey(p) for p in res_ba.egress if not p.padding)
    assert rt_ex.express.active[0], "room never promoted"
    assert rt_ex.express.stats["promotes"] >= 1
    assert ex_entries, "express tier never carried a packet"
    assert len(out_ba) == 24        # 6 windows × 2 tracks × 2 subs
    assert sorted(out_ex + [ekey(e) for e in ex_entries]) == sorted(out_ba)
    for name in rt_ba.munger.FIELDS:
        assert np.array_equal(getattr(rt_ex.munger, name), getattr(rt_ba.munger, name)), name
    assert rt_ex.stats["express_mirrors"] >= 5


async def test_paged_runtime_express_matches_batched():
    """The paged runtime carries the same hooks (its selector mirror is
    read back to logical form): the lane's output plus the batched
    fan-out equal a lane-off paged runtime's, lanes included."""
    dims = paged.PagedDims(rooms=2, tracks=2, pkts=4, subs=4, tpage=2, spage=4, pool_pages=4)

    def paged_rt(**kw):
        rt = PagedPlaneRuntime(dims, tick_ms=10, paged_kernel="on", egress_shards=1,
                               device="cpu", **kw)
        s = rt.slots.alloc_room("r0")
        for t in ("v", "a"):
            s.alloc_track(t)
        for p in ("p0", "p1", "p2"):
            s.alloc_sub(p)
        setup_av(rt)
        return rt

    rt_ex, rt_ba = paged_rt(express_max_subs=2), paged_rt()
    ex_entries = tap_express(rt_ex)
    out_ex, out_ba = [], []
    for w in range(6):
        push_av(rt_ex, w)
        push_av(rt_ba, w)
        out_ex.extend(pkey(p) for p in (await rt_ex.step_once()).egress if not p.padding)
        out_ba.extend(pkey(p) for p in (await rt_ba.step_once()).egress if not p.padding)
    assert rt_ex.express.stats["promotes"] >= 1 and ex_entries
    assert sorted(out_ex + [ekey(e) for e in ex_entries]) == sorted(out_ba)
    for name in rt_ba.munger.FIELDS:
        assert np.array_equal(getattr(rt_ex.munger, name), getattr(rt_ba.munger, name)), name


async def test_promote_shed_demote_audio_continuity():
    """Audio continuity across the tier lifecycle: batched warm-up,
    promotion takeover, governor L3 shed, demotion back to batched —
    every SN exactly once, in order, for every subscriber."""
    rt = runtime(express_max_subs=2)
    rt.set_track(0, 0, published=True, is_video=False)
    for s in (1, 2):
        rt.set_subscription(0, 0, s, subscribed=True)
    ex = tap_express(rt)
    got = {1: [], 2: []}
    express_sns = set()
    sn = 100

    async def run_windows(n):
        nonlocal sn
        for _ in range(n):
            mark = len(ex)
            push_audio(rt, sn)
            res = await rt.step_once()
            got_now = [(p.sub, p.sn) for p in res.egress if not p.padding and p.track == 0]
            for sub, s_n in got_now:
                got[sub].append(s_n)
            for e in ex[mark:]:
                got[e["sub"]].append(e["sn"])
                express_sns.add(e["sn"])
            sn += 1

    await run_windows(2)                 # batched; the 2nd boundary promotes
    assert rt.express.active[0]
    await run_windows(3)                 # express steady state
    rt.set_shed(pause_video=True)        # overload: audio is never shed
    await run_windows(2)
    rt.set_shed(pause_video=False)
    rt.set_express_pin(0, False)         # force back to batched
    await run_windows(2)
    assert not rt.express.active[0]
    for s in (1, 2):
        assert got[s] == list(range(100, sn)), f"sub {s} lost or reordered"
    assert express_sns, "express tier never carried audio"
    assert rt.express.stats["promotes"] >= 1
    assert rt.express.stats["demotes"] >= 1


async def test_governor_shed_mutes_express_video_audio_flows():
    """set_shed(pause_video=True) binds on the express tier at the next
    retier as it binds the batched upload: video stops, audio flows."""
    rt = runtime(express_max_subs=2)
    rt.set_track(0, 0, published=True, is_video=True)
    rt.set_track(0, 1, published=True, is_video=False)
    rt.set_subscription(0, 0, 1, subscribed=True)
    rt.set_subscription(0, 1, 1, subscribed=True)
    ex = tap_express(rt)

    async def window(w):
        push_av(rt, w)
        return await rt.step_once()

    await window(0)
    await window(1)
    assert rt.express.active[0]
    mark = len(ex)
    await window(2)
    assert {e["track"] for e in ex[mark:]} == {0, 1}
    rt.set_shed(pause_video=True)
    await rt.step_once()                 # the boundary rebuilds the express base
    mark = len(ex)
    res = await window(3)
    tracks = {e["track"] for e in ex[mark:]}
    assert tracks == {1}, f"video must shed on the express tier, got {tracks}"
    assert not any(p.track == 0 and not p.padding for p in res.egress)


class StubIntegrity:
    """The quarantine surface the runtime and lane read, without the
    audit: a mutable `quarantined` set and the hooks the tick calls."""

    def __init__(self):
        self.quarantined = set()
        self._pending_repair = set()

    def maybe_audit(self, tick_index):
        pass

    async def process(self):
        pass


async def test_quarantine_blocks_express_mid_window():
    """A quarantine landing mid-window stops on-arrival sends at once, and
    the batched fan-out masks the room the same tick."""
    rt = runtime(express_max_subs=2)
    rt.integrity = StubIntegrity()
    rt.set_track(0, 0, published=True, is_video=False)
    rt.set_subscription(0, 0, 1, subscribed=True)
    ex = tap_express(rt)
    for w in range(2):
        push_audio(rt, 100 + w)
        await rt.step_once()
    assert rt.express.active[0]
    mark = len(ex)
    push_audio(rt, 102)
    assert len(ex) > mark, "express should be flowing before the quarantine"

    rt.integrity.quarantined.add(0)
    mark, n0 = len(ex), rt.express.stats["express_pkts"]
    push_audio(rt, 103)
    assert len(ex) == mark, "a quarantined room must not express-send"
    assert rt.express.stats["express_pkts"] == n0
    res = await rt.step_once()
    assert not any(p.room == 0 and not p.padding for p in res.egress)

    rt.integrity.quarantined.clear()
    await rt.step_once()                 # the boundary drops the quarantine mute
    mark = len(ex)
    push_audio(rt, 104)
    assert len(ex) > mark, "express should resume after the quarantine lifts"
    await rt.step_once()


async def test_freeze_demotes_and_clear_room_resets():
    """A frozen row demotes at the next boundary (its packets go to the
    bridge sink), re-promotion after the unfreeze waits for a fresh
    device mirror, and clear_room leaves no tier state behind."""
    rt, ex = await promoted_audio_room()
    bridged = []
    rt.ingest.frozen_rows.add(0)
    rt.ingest.freeze_sinks[0] = bridged.append
    await rt.step_once()
    assert not rt.express.active[0] and not rt.express.desired[0]
    mark = len(ex)
    push_audio(rt, 102)
    assert len(ex) == mark, "nothing may express past the freeze snapshot"
    assert len(bridged) == 1 and bridged[0].sn == 102

    rt.ingest.frozen_rows.discard(0)
    rt.ingest.freeze_sinks.pop(0)
    await rt.step_once()                 # eligible again, but the mirror is stale
    assert not rt.express.active[0], "re-promotion must wait for a fresh mirror"
    await rt.step_once()
    assert rt.express.active[0]

    rt.clear_room(0)
    lane = rt.express
    assert not lane.active[0] and not lane.desired[0] and not lane.mirror_ok[0]
    assert lane.pin[0] == 0
    assert (lane.cur_sp[0] == -1).all() and (lane.tgt_sp[0] == -1).all()
    assert (lane.words[0] == 0).all() and not lane.express_subs[0].any()


async def test_nack_replay_covers_express_sends():
    """An express send is NACK-replayable like a batched one: the
    window's express log lands in the replay ring at the boundary, keyed
    by the munged SN, payload bytes intact."""
    rt, ex = await promoted_audio_room()
    mark = len(ex)
    push_audio(rt, 102, b"express-pay")
    assert len(ex) == mark + 1
    entry = ex[mark]
    await rt.step_once()                 # log → replay ring
    reps = rt.resolve_nacks(0, 1, 0, [entry["sn"]])
    assert len(reps) == 1
    assert reps[0].sn == entry["sn"]
    assert reps[0].payload == b"express-pay"


async def test_sub_provider_splits_tiers_disjoint_and_complete():
    """Only the provider's fast-path subscribers ride the lane; the rest
    keep the batched tick. Union complete, intersection empty."""
    rt = runtime(express_max_subs=2)
    rt.set_track(0, 0, published=True, is_video=False)
    for s in (1, 2):
        rt.set_subscription(0, 0, s, subscribed=True)
    fast = np.zeros((DIMS.rooms, DIMS.subs), bool)
    fast[0, 1] = True
    rt.express.sub_provider = lambda: fast
    ex = tap_express(rt)
    for w in range(2):
        push_audio(rt, 100 + w)
        await rt.step_once()
    assert rt.express.active[0]
    assert rt.express.express_subs[0, 1] and not rt.express.express_subs[0, 2]
    mark = len(ex)
    push_audio(rt, 102, b"y")
    res = await rt.step_once()
    ex_subs = {e["sub"] for e in ex[mark:] if e["sn"] == 102}
    ba_subs = {p.sub for p in res.egress if not p.padding and p.sn == 102}
    assert ex_subs == {1} and ba_subs == {2}


def test_express_config_validation():
    """The reference's config checks, and the lane off by default."""
    with pytest.raises(ConfigError, match="express_max_subs"):
        make_cfg(free_port(), plane={"express_max_subs": 8})   # > subs_per_room
    with pytest.raises(ConfigError, match="express_max_subs"):
        make_cfg(free_port(), plane={"express_max_subs": -1})
    with pytest.raises(ConfigError, match="express_max_rooms"):
        make_cfg(free_port(), plane={"express_max_subs": 2, "express_max_rooms": 0})
    cfg = make_cfg(free_port())
    assert cfg.plane.express_max_subs == 0 and cfg.plane.express_max_rooms == 16
    assert runtime().express is None
