"""Checkpoints across the two packages: the LKCK frame codec (round trip,
tamper, version), full-plane snapshot frames encoded by either package
restored into the other (dense and paged, the paged one in logical form),
and row snapshots, `repair_room_row` and `restore_room` (with the page
grid grown to the incoming room's tracks) matching the JAX package's
after the same ticks. Restores copy: every integer, bool and float leaf
of a restored state equals the snapshot it came from bit for bit; states
that ticked in both packages are held to each other with integers and
bools equal and floats within `plane.float_tolerance`. And the seeded
silent-data-corruption drill of tests/test_integrity.py in both packages:
a bitflip in room 0's BWE ring cursor at tick 5, caught by the audit
(cadence 4) at tick 8, quarantined and repaired from the checksummed
checkpoint while rooms 1 and 2 never drop an audio tick — the port
walking the same ladder tick for tick, with the same flipped elements.

One file: the JAX runtimes here share two tick compiles (dense, paged)."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

from livekit_server_tpu.models import paged as jpaged  # noqa: E402
from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import FaultInjector as JaxInjector  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JaxRuntime  # noqa: E402
from livekit_server_tpu.runtime.faultinject import FaultSpec as JaxSpec  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JaxPacket  # noqa: E402
from livekit_server_tpu.runtime.integrity import IntegrityMonitor as JaxMonitor  # noqa: E402
from livekit_server_tpu.runtime.paged_runtime import PagedPlaneRuntime as JaxPaged  # noqa: E402
from livekit_server_tpu.utils import checksum as jchecksum  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.ops import bwe  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.faultinject import FaultInjector, FaultSpec  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.integrity import IntegrityMonitor  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.utils import checksum  # noqa: E402
from livekit_server_tpu_torch.utils.checksum import ChecksumError  # noqa: E402

DIMS = plane.PlaneDims(rooms=3, tracks=4, pkts=4, subs=4)
NAMES = plane.leaf_names(plane.init_state(DIMS, device="cpu"))


def _dense_pair():
    ref = JaxRuntime(jplane.PlaneDims(*DIMS), tick_ms=10)
    port = PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")
    for rt in (ref, port):
        for room in range(DIMS.rooms):
            rt.set_track(room, 0, published=True, is_video=False)
            rt.set_track(room, 1, published=True, is_video=True, is_svc=room == 1)
            for sub in (1, 2):
                rt.set_subscription(room, 0, sub, subscribed=True)
                rt.set_subscription(room, 1, sub, subscribed=True)
    return ref, port


async def _tick(pair, i: int) -> None:
    for rt, packet_cls in zip(pair, (JaxPacket, PacketIn)):
        for room in range(DIMS.rooms):
            rt.ingest.push(packet_cls(room=room, track=0, sn=(1000 + i) & 0xFFFF,
                                      ts=960 * i, size=50, payload=b"a",
                                      audio_level=40 + room))
            rt.ingest.push(packet_cls(room=room, track=1, sn=(7000 + i) & 0xFFFF,
                                      ts=3000 * i, size=900, payload=b"v" * 900,
                                      keyframe=i == 0, layer_sync=True, begin_pic=True,
                                      marker=True))
            rt.ingest.push_feedback(room, 1, estimate=2e6 + 1e5 * i)
        await rt.step_once()


def _jax_leaves(state) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _assert_exact(got: list, want: list, where: str) -> None:
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), (where, i)


def test_frame_round_trip_across_packages():
    payload = b"media-plane checkpoint bytes" * 7
    for enc, dec in ((checksum, jchecksum), (jchecksum, checksum), (checksum, checksum)):
        frame = enc.encode_frame(payload, flags=3)
        assert frame[:4] == b"LKCK" and len(frame) == checksum.HEADER_SIZE + len(payload)
        assert dec.decode_frame(frame) == payload
        assert dec.decode_frame_b64(enc.encode_frame_b64(payload)) == payload
    assert checksum.encode_frame(payload) == jchecksum.encode_frame(payload)


def test_frame_tamper_detected():
    fails0 = checksum.CodecStats.verify_failures
    flipped = bytearray(checksum.encode_frame(b"x" * 100))
    flipped[checksum.HEADER_SIZE + 11] ^= 0x01
    bad = (bytes(flipped),                                       # CRC mismatch
           checksum.encode_frame(b"abc")[:-1],                   # short
           b"NOPE" + checksum.encode_frame(b"abc")[4:],          # magic
           b"\x00" * 5)                                          # truncated header
    for frame in bad:
        with pytest.raises(ChecksumError):
            checksum.decode_frame(frame)
        with pytest.raises(jchecksum.ChecksumError):
            jchecksum.decode_frame(frame)
    with pytest.raises(ChecksumError):
        checksum.decode_frame_b64("!!! not base64 !!!")
    assert checksum.CodecStats.verify_failures == fails0 + 5


def test_frame_unknown_version_rejected():
    frame = checksum.encode_frame(b"abc")
    bad = frame[:4] + b"\x00\x63" + frame[6:]
    with pytest.raises(ChecksumError, match="version"):
        checksum.decode_frame(bad)
    with pytest.raises(jchecksum.ChecksumError):
        jchecksum.decode_frame(bad)


async def test_dense_snapshot_frames_restore_across_packages():
    ref, port = _dense_pair()
    for i in range(4):
        await _tick((ref, port), i)
    fx.assert_leaves_match(plane.state_to_numpy(port.state), _jax_leaves(ref.state),
                           NAMES, "after 4 ticks")
    jsnap, psnap = ref.snapshot(), port.snapshot()
    jblob, pblob = ref.encode_snapshot(jsnap), port.encode_snapshot(psnap)
    # JAX frame → port, port frame → JAX: every leaf bit-equal to the
    # snapshot it came from, munger and tick index included.
    port.restore(port.decode_snapshot(jblob))
    ref.restore(ref.decode_snapshot(pblob))
    _assert_exact(plane.state_to_numpy(port.state), jsnap["arrays"], "JAX frame in the port")
    _assert_exact(_jax_leaves(ref.state), psnap["arrays"], "port frame in JAX")
    _assert_exact(port.munger.snapshot(), jsnap["munger"], "munger")
    assert port.tick_index == ref.tick_index == 4
    # Both continue from the swapped states: the next tick still agrees.
    ref.restore(ref.decode_snapshot(jblob))
    await _tick((ref, port), 4)
    fx.assert_leaves_match(plane.state_to_numpy(port.state), _jax_leaves(ref.state),
                           NAMES, "the tick after the restore")


async def test_dense_room_rows_repair_and_restore_match_reference():
    ref, port = _dense_pair()
    for i in range(3):
        await _tick((ref, port), i)
    jrow, prow = ref.snapshot_room(1), port.snapshot_room(1)
    assert len(prow["arrays"]) == len(jrow["arrays"])
    fx.assert_leaves_match(prow["arrays"][:len(NAMES)], jrow["arrays"][:len(NAMES)],
                           NAMES, "room 1 snapshot")
    _assert_exact(prow["arrays"][len(NAMES):], jrow["arrays"][len(NAMES):], "room 1 munger")
    _assert_exact(port.decode_room_snapshot(port.encode_room_snapshot(prow))["arrays"],
                  prow["arrays"], "room frame")
    jfull, pfull = ref.snapshot(), port.snapshot()
    for i in range(3, 5):
        await _tick((ref, port), i)
    # Repair room 0 from the tick-3 checkpoint; restore room 1's snapshot
    # into row 2 (another node's handoff: the JAX package's frame into the
    # port, the port's into JAX).
    ref.repair_room_row(0, ref.row_snapshot_from_full(jfull, 0))
    port.repair_room_row(0, port.row_snapshot_from_full(pfull, 0))
    ref.restore_room(2, ref.decode_room_snapshot(port.encode_room_snapshot(prow)))
    port.restore_room(2, port.decode_room_snapshot(ref.encode_room_snapshot(jrow)))
    fx.assert_leaves_match(plane.state_to_numpy(port.state), _jax_leaves(ref.state),
                           NAMES, "after repair and restore")
    for a, b in zip((*port.meta, *port.ctrl), (*ref.meta, *ref.ctrl)):
        assert np.array_equal(a, b)
    assert port._dirty_rows == ref._dirty_rows == {0, 2}
    await _tick((ref, port), 5)
    fx.assert_leaves_match(plane.state_to_numpy(port.state), _jax_leaves(ref.state),
                           NAMES, "the tick after")


def test_restore_rejects_mismatched_snapshots():
    port = PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")
    row = port.row_snapshot_from_full(port.snapshot(), 0)
    with pytest.raises(ValueError, match="plane versions differ"):
        port.repair_room_row(0, {"arrays": row["arrays"][:-1]})
    with pytest.raises(ValueError, match="row shape"):
        port.repair_room_row(0, {"arrays": [np.zeros((9, 9, 9), bool)] + row["arrays"][1:]})
    bad = list(row["arrays"])
    bad[NAMES.index("temporal_bytes")] = bad[NAMES.index("temporal_bytes")].astype(np.complex64)
    with pytest.raises(ValueError, match="dtype"):
        port.restore_room(0, {"arrays": bad})
    other = PlaneRuntime(plane.PlaneDims(4, 4, 4, 4), tick_ms=10, egress_shards=1,
                         device="cpu")
    with pytest.raises(ValueError, match="dims mismatch"):
        port.restore(other.snapshot())
    with pytest.raises(ValueError, match="versions differ"):
        port.restore({"tick_index": 0, "arrays": []})
    port.repair_room_row(0, row)              # a good row is still accepted


PAGED_ROOMS = [("a", 1, 2), ("b", 4, 8), ("c", 2, 5)]


def _paged_pair():
    ref = JaxPaged(jpaged.PagedDims(**fx.DIMS), tick_ms=10, paged_kernel="on")
    port = PagedPlaneRuntime(paged.PagedDims(**fx.DIMS), tick_ms=10, egress_shards=1,
                             device="cpu", paged_kernel="on")
    for rt in (ref, port):
        for name, tracks, subs in PAGED_ROOMS:
            s = rt.slots.alloc_room(name)
            for i in range(tracks):
                s.alloc_track(f"t{i}")
            for i in range(subs):
                s.alloc_sub(f"p{i}")
        rt.set_track(0, 0, published=True, is_video=True)
        rt.set_subscription(0, 0, 1, subscribed=True)
        rt.set_track(1, 0, published=True, is_video=True)
        rt.set_track(1, 3, published=True, is_video=False)
        for sub in range(8):
            rt.set_subscription(1, 0, sub, subscribed=True)
        rt.set_subscription(1, 3, 2, subscribed=True)
    return ref, port


async def _paged_tick(pair, i: int) -> None:
    for rt, packet_cls in zip(pair, (JaxPacket, PacketIn)):
        for room, track, base in ((0, 0, 100), (1, 0, 500), (1, 3, 900)):
            rt.ingest.push(packet_cls(room=room, track=track, sn=(base + i) & 0xFFFF,
                                      ts=960 * i, size=120, payload=b"x" * 120,
                                      keyframe=i == 0, audio_level=35))
        await rt.step_once()


def _logical(rt) -> list[np.ndarray]:
    state = rt._to_logical_state()
    return (plane.tree_leaves(state) if isinstance(rt, PagedPlaneRuntime)
            else _jax_leaves(state))


async def test_paged_snapshot_frames_restore_across_packages():
    ref, port = _paged_pair()
    for i in range(3):
        await _paged_tick((ref, port), i)
    jsnap, psnap = ref.snapshot(), port.snapshot()
    fx.assert_leaves_match(psnap["arrays"], jsnap["arrays"], NAMES, "logical snapshot")
    # A paged frame is a logical one: it restores into the other package's
    # paged runtime, and into a dense runtime of the same logical dims.
    port.restore(port.decode_snapshot(ref.encode_snapshot(jsnap)))
    ref.restore(ref.decode_snapshot(port.encode_snapshot(psnap)))
    _assert_exact(_logical(port), jsnap["arrays"], "JAX paged frame in the port")
    _assert_exact(_logical(ref), psnap["arrays"], "port paged frame in JAX")
    dense = PlaneRuntime(plane.PlaneDims(fx.DIMS["rooms"], fx.DIMS["tracks"],
                                         fx.DIMS["pkts"], fx.DIMS["subs"]),
                         tick_ms=10, egress_shards=1, device="cpu")
    dense.restore(dense.decode_snapshot(port.encode_snapshot(psnap)))
    _assert_exact(plane.state_to_numpy(dense.state), psnap["arrays"], "paged frame, dense")
    await _paged_tick((ref, port), 3)
    fx.assert_leaves_match(_logical(port), _logical(ref), NAMES, "the tick after")


async def test_paged_rows_repair_and_restore_match_reference():
    ref, port = _paged_pair()
    for i in range(3):
        await _paged_tick((ref, port), i)
    jfull, pfull = ref.snapshot(), port.snapshot()
    jrow, prow = ref.snapshot_room(1), port.snapshot_room(1)
    fx.assert_leaves_match(prow["arrays"][:len(NAMES)], jrow["arrays"][:len(NAMES)],
                           NAMES, "room 1 snapshot")
    await _paged_tick((ref, port), 3)
    ref.repair_room_row(1, ref.row_snapshot_from_full(jfull, 1))
    port.repair_room_row(1, port.row_snapshot_from_full(pfull, 1))
    # Room "a" (row 0) owns one track page; room 1's snapshot publishes
    # track 3, so the restore grows row 0's grid to two track pages.
    ref.restore_room(0, ref.decode_room_snapshot(port.encode_room_snapshot(prow)))
    port.restore_room(0, port.decode_room_snapshot(ref.encode_room_snapshot(jrow)))
    assert port.pager.extent(0) == ref.pager.extent(0)
    assert np.array_equal(port.pager.pg_room, ref.pager.pg_room)
    fx.assert_leaves_match(_logical(port), _logical(ref), NAMES, "after repair and restore")
    for a, b in zip((*port.meta, *port.ctrl), (*ref.meta, *ref.ctrl)):
        assert np.array_equal(a, b)
    await _paged_tick((ref, port), 4)
    fx.assert_leaves_match(_logical(port), _logical(ref), NAMES, "the tick after")


async def _bitflip_scenario(port: bool) -> dict:
    if port:
        rt = PlaneRuntime(plane.PlaneDims(3, 4, 4, 4), tick_ms=10, egress_shards=1,
                          device="cpu")
        packet, monitor, injector, spec = PacketIn, IntegrityMonitor, FaultInjector, FaultSpec
    else:
        rt = JaxRuntime(jplane.PlaneDims(3, 4, 4, 4), tick_ms=10)
        packet, monitor, injector, spec = JaxPacket, JaxMonitor, JaxInjector, JaxSpec
    for room in range(3):
        rt.set_track(room, 0, published=True, is_video=False)
        rt.set_subscription(room, 0, 1, subscribed=True)

    def push(i):
        for room in range(3):
            rt.ingest.push(packet(room=room, track=0, sn=(1000 + i) & 0xFFFF, ts=960 * i,
                                  size=50, payload=b"a"))

    for i in range(2):
        push(i)
        await rt.step_once()
    blob = rt.encode_snapshot(rt.snapshot())     # checksummed at rest
    mon = monitor(rt, audit_every_ticks=4, max_row_repairs=3, storm_threshold=4)
    mon.snapshot_provider = lambda: rt.decode_snapshot(blob)
    escalations: list[str] = []
    mon.escalate_cb = escalations.append
    rt.integrity = mon
    rt.fault = injector(spec(seed=7, bitflip_tick=5, bitflip_room=0,
                             bitflip_leaf="bwe_state.ring_pos", bitflip_bit=30,
                             bitflip_count=2))
    witness_ok, detection_tick, repair_tick, quarantined_seen = True, None, None, False
    egress = []
    for i in range(2, 14):
        push(i)
        res = await rt.step_once()
        if {p.room for p in res.egress} < {1, 2}:
            witness_ok = False
        egress.append(sorted((p.room, p.sub, p.sn) for p in res.egress))
        quarantined_seen = quarantined_seen or mon.rows_quarantined > 0
        if detection_tick is None and mon.violations_total:
            detection_tick = mon.last_audit_tick
        if repair_tick is None and mon.rows_repaired:
            repair_tick = res.tick_index
    return {
        "bitflips": rt.fault.stats.bitflips, "detection_tick": detection_tick,
        "repair_tick": repair_tick, "quarantined_seen": quarantined_seen,
        "repaired": mon.rows_repaired, "escalations": len(escalations),
        "quarantined_now": sorted(mon.quarantined), "witness_ok": witness_ok,
        "ring_max": int(np.asarray(rt.state.bwe_state.ring_pos).max()),
        "rule_hits": dict(mon.rule_violations), "egress": egress,
    }


async def test_bitflip_drill_walks_the_reference_ladder():
    want = await _bitflip_scenario(port=False)
    got = await _bitflip_scenario(port=True)
    assert got == want
    assert got["bitflips"] == 2 and got["detection_tick"] == 8
    assert got["quarantined_seen"] and got["repaired"] == 1 and got["repair_tick"] == 8
    assert got["escalations"] == 0 and got["quarantined_now"] == [] and got["witness_ok"]
    assert got["ring_max"] < bwe.WINDOW and got["rule_hits"]["bounds"] >= 1
    assert await _bitflip_scenario(port=True) == got          # seeded: deterministic
