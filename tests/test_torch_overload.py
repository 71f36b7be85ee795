"""The port's overload governor, ingest policer and fault injector
(device="cpu") against the JAX package's, on the same inputs and seeds:
the governor's level sequence and transitions over the same tick
records, the effective control tensors at every ladder level, the
policer's scalar and batch paths, the ingest drop split, the injector's
verdict sequences (drop / delay / duplicate / flood, checkpoint damage,
bitflip element choice), and seeded faulted traffic drained tick by tick
through both packages' IngestBuffers with the same staged tensors."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.config.config import LimitsConfig as JaxLimits  # noqa: E402
from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JaxRuntime  # noqa: E402
from livekit_server_tpu.runtime import faultinject as jfault  # noqa: E402
from livekit_server_tpu.runtime import governor as jgov  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JaxPacket  # noqa: E402
from livekit_server_tpu_torch.config.config import FaultInjectConfig, LimitsConfig  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime import faultinject, governor  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402

DIMS = plane.PlaneDims(rooms=2, tracks=4, pkts=4, subs=4)
# Tick verdicts (tick_ms=10): pressured, calm, and the hysteresis band.
HOT = {"total_ms": 20.0, "late": True}
CALM = {"total_ms": 1.0, "late": False}
MID = {"total_ms": 7.0, "late": False}


def _pair():
    ref = JaxRuntime(jplane.PlaneDims(*DIMS), tick_ms=10)
    port = PlaneRuntime(DIMS, tick_ms=10, egress_shards=1, device="cpu")
    for rt in (ref, port):
        rt.set_track(0, 0, published=True, is_video=True)
        rt.set_track(0, 1, published=True, is_video=False)
        rt.set_track(1, 2, published=True, is_video=True)
        for sub in range(DIMS.subs):
            for track in (0, 1):
                rt.set_subscription(0, track, sub, subscribed=True)
            rt.set_subscription(1, 2, sub, subscribed=True)
        rt.set_layer_caps(0, 0, 1, max_spatial=2, max_temporal=2)
    return ref, port


def _governors(**kw):
    ref, port = _pair()
    return (ref, jgov.OverloadGovernor(ref, **kw)), (port, governor.OverloadGovernor(port, **kw))


def _feed(govs, records, stalls=None, cap_drops=None) -> list[list[int]]:
    """The same tick records into both governors; per-tick levels."""
    levels = [[], []]
    for i, rec in enumerate(records):
        for j, (rt, gov) in enumerate(govs):
            rt.governor = gov
            if stalls is not None:
                rt.stats["pipeline_stalls"] = int(stalls[i])
            if cap_drops is not None:
                rt.ingest.dropped_capacity = int(cap_drops[i])
            gov.on_tick(dict(rec))
            levels[j].append(gov.level)
    return levels


def test_ladder_level_sequences_match_reference():
    govs = _governors(escalate_ticks=3, dwell_ticks=5)
    records = [HOT] * 42 + [CALM] * 20 + ([HOT, HOT, CALM, CALM] * 5) + (
        [HOT] * 4 + [MID]) * 4
    levels = _feed(govs, records)
    assert levels[0] == levels[1]
    assert levels[1][41] == governor.L_MAX and levels[1][61] == 0 and levels[1][-1] == 4
    (_, jg), (_, pg) = govs
    assert list(pg.transitions) == list(jg.transitions)
    assert (pg.escalations, pg.transition_count) == (jg.escalations, jg.transition_count)
    # Seeded sensor streams: work ratio, lateness, stall and capacity-drop
    # counters, through the same ladder.
    rng = np.random.default_rng(7)
    n = 600
    records = [{"total_ms": float(rng.choice([0.5, 4.0, 6.0, 9.0, 30.0])),
                "late": bool(rng.random() < 0.3)} for _ in range(n)]
    stalls = np.cumsum(rng.random(n) < 0.05)
    cap_drops = np.cumsum((rng.random(n) < 0.05) * rng.integers(1, 9, n))
    govs = _governors(escalate_ticks=4, dwell_ticks=6)
    levels = _feed(govs, records, stalls, cap_drops)
    assert levels[0] == levels[1] and len(set(levels[1])) > 2
    assert list(govs[1][1].transitions) == list(govs[0][1].transitions)
    assert govs[1][1].snapshot() == govs[0][1].snapshot()


def test_from_config_maps_limit_keys():
    keys = dict(governor_enter_pressure=0.9, governor_exit_pressure=0.4,
                governor_escalate_ticks=7, governor_dwell_ticks=9,
                governor_ingress_pps=123.0, governor_ingress_burst=45.0)
    ref, port = _pair()
    jg = jgov.OverloadGovernor.from_config(ref, JaxLimits(**keys))
    pg = governor.OverloadGovernor.from_config(port, LimitsConfig(**keys))
    assert pg.snapshot()["thresholds"] == jg.snapshot()["thresholds"]
    assert (pg.enter_pressure, pg.escalate_ticks, pg.ingress_pps) == (0.9, 7, 123.0)


def test_effective_ctrl_and_actuators_per_level_match_reference():
    (ref, jg), (port, pg) = _governors(ingress_pps=50.0, ingress_burst=10.0)
    ref.governor, port.governor = jg, pg
    for rt in (ref, port):
        rt.set_pinned(1, 2, 3, True)
    for level in (1, 2, 3, 4, 3, 0):
        jg._set_level(level, "test")
        pg._set_level(level, "test")
        want, got = ref._effective_ctrl(), port._effective_ctrl()
        for a, b in zip(got, want):
            assert np.array_equal(a, b), level
        assert (port.shed_spatial_cap, port.shed_pause_video) == (
            ref.shed_spatial_cap, ref.shed_pause_video)
        assert port.ingest._police_rate == ref.ingest._police_rate
        assert (port.ingest._police_video is port.meta.is_video) == (
            ref.ingest._police_video is ref.meta.is_video)
        assert [pg.should_admit(k) for k in ("room", "join", "publish", "restore")] == [
            jg.should_admit(k) for k in ("room", "join", "publish", "restore")]
    assert port._effective_ctrl() is port.ctrl        # overlay fully out of the way
    assert port._dirty_rows == ref._dirty_rows        # the pin dirtied its row


def _push_scalar(rt, packet_cls, tracks, sn0=0):
    return [rt.ingest.push(packet_cls(room=0, track=int(t), sn=sn0 + i, ts=0, size=10,
                                      payload=b"p"))
            for i, t in enumerate(tracks)]


def _push_batch(rt, tracks, sn0=0):
    n = len(tracks)
    z = np.zeros(n, np.int64)
    f = np.zeros(n, bool)
    return rt.ingest.push_batch(
        z, np.asarray(tracks, np.int64), z, np.arange(sn0, sn0 + n, dtype=np.int64), z, f,
        z, f, f, f, f, z, z, z, np.full(n, 10, np.int64), np.full(n, 20, np.int64),
        np.full(n, 127, np.int64), z, np.arange(n, dtype=np.int64), np.ones(n, np.int64),
        b"p" * n)


def test_policer_scalar_and_batch_paths_match_reference():
    # Video track 0, audio track 1: 6 video and 2 audio arrivals against a
    # burst of 3, then a refill of 2 tokens at the drain.
    tracks = [0, 0, 0, 1, 0, 0, 1, 0]
    results = []
    for batch in (False, True):
        ref, port = _pair()
        for rt in (ref, port):
            rt.ingest.set_policer(200.0, 3.0, is_video=rt.meta.is_video)
        if batch:
            staged = [_push_batch(ref, tracks), _push_batch(port, tracks)]
        else:
            staged = [sum(_push_scalar(ref, JaxPacket, tracks)),
                      sum(_push_scalar(port, PacketIn, tracks))]
        assert staged[0] == staged[1] == 5
        for rt in (ref, port):
            rt.ingest.drain()
        again = [_push_scalar(ref, JaxPacket, [0, 0, 0], 50),
                 _push_scalar(port, PacketIn, [0, 0, 0], 50)]
        assert again[0] == again[1] == [True, True, False]
        for a, b in ((ref.ingest, port.ingest),):
            assert (b.dropped_policed, b.dropped_capacity, b.dropped_fault) == (
                a.dropped_policed, a.dropped_capacity, a.dropped_fault)
            assert np.array_equal(b.rx_pkts, a.rx_pkts)
            assert np.array_equal(b._police_tokens, a._police_tokens)
        results.append((port.ingest.dropped_policed, port.ingest.rx_pkts.copy()))
    # The batch path polices exactly as the scalar path does.
    assert results[0][0] == results[1][0] == 4
    assert np.array_equal(results[0][1], results[1][1])
    for rt in (ref, port):
        rt.ingest.clear_policer()
    assert all(_push_scalar(port, PacketIn, [0, 0, 0, 0], 90)[:1])


def test_ingest_drop_split_matches_reference():
    ref, port = _pair()
    for rt, packet_cls in ((ref, JaxPacket), (port, PacketIn)):
        _push_scalar(rt, packet_cls, [0] * 6)                  # K=4: 2 capacity drops
        rt.ingest.fault = (jfault if rt is ref else faultinject).FaultInjector(
            seed=0, drop_pct=1.0)
        assert not rt.ingest.push(packet_cls(room=0, track=0, sn=50, ts=0, size=10))
    for a, b in ((ref.ingest, port.ingest),):
        assert (b.dropped_capacity, b.dropped_fault, b.dropped_policed, b.dropped) == (
            a.dropped_capacity, a.dropped_fault, a.dropped_policed, a.dropped) == (2, 1, 0, 3)
        assert np.array_equal(b.rx_pkts, a.rx_pkts) and int(b.rx_pkts[0, 0]) == 7


def test_injector_verdicts_match_reference_for_the_same_seed():
    for spec in (dict(seed=11, drop_pct=0.1, delay_pct=0.2, dup_pct=0.15),
                 dict(seed=12, drop_pct=0.3, flood_mult=2.5, flood_rooms=(0,)),
                 dict(seed=13, dup_pct=0.5, corrupt_ckpt_every=2)):
        a = jfault.FaultInjector(jfault.FaultSpec(**spec))
        b = faultinject.FaultInjector(faultinject.FaultSpec(**spec))
        for i in range(300):
            assert b.on_packet(i, i // 7) == a.on_packet(i, i // 7)
            assert b.flood_copies(i % 2) == a.flood_copies(i % 2)
        for t in range(0, 50, 3):
            assert b.take_due(t) == a.take_due(t)
        blob, text = bytes(range(256)) * 4, "QUJD" * 60
        for _ in range(4):
            assert b.corrupt_ckpt(blob) == a.corrupt_ckpt(blob)
            assert b.corrupt_ckpt(text) == a.corrupt_ckpt(text)
        assert vars(b.stats).items() <= vars(a.stats).items()


def test_stall_cadence_and_bitflip_choice_match_reference():
    a = jfault.FaultInjector(jfault.FaultSpec(stall_every=3, stall_s=0.001))
    b = faultinject.FaultInjector(faultinject.FaultSpec(stall_every=3, stall_s=0.001))
    for _ in range(10):
        a.maybe_stall()
        b.maybe_stall()
    assert a.stats.stalls == b.stats.stalls == 3
    for leaf, bit in (("temporal_bytes", 30), ("bwe_state.ring_pos", 30),
                      ("ctrl.subscribed", 0), ("sel.current_spatial", 7)):
        ref, port = _pair()
        spec = dict(seed=5, bitflip_tick=2, bitflip_room=1, bitflip_leaf=leaf,
                    bitflip_bit=bit, bitflip_count=3)
        a = jfault.FaultInjector(jfault.FaultSpec(**spec))
        b = faultinject.FaultInjector(faultinject.FaultSpec(**spec))
        for tick in (1, 2, 3):
            a.maybe_bitflip(ref, tick)
            b.maybe_bitflip(port.state, tick)
        assert a.stats.bitflips == b.stats.bitflips == 3
        for got, want in zip(plane.state_to_numpy(port.state), jax.tree.leaves(ref.state)):
            assert np.array_equal(got, np.asarray(want)), leaf


def test_config_refuses_migration_and_bus_drills():
    """The migration and bus drills are ported: from_config takes them into
    the spec exactly as the reference's does (it refused them before the
    multi-node plane was ported)."""
    for name, value in (("mig_drop_prepare", True), ("mig_ack_delay_s", 1.0),
                        ("mig_corrupt_handoff", True), ("mig_sever_handoffs", 2),
                        ("bus_partition_groups", [[1], [2]]), ("bus_partition_tick", 3),
                        ("bus_heal_at_tick", 4), ("bus_asym_pairs", [["a", "b"]])):
        cfg = FaultInjectConfig(enabled=True)
        setattr(cfg, name, value)
        got = faultinject.FaultInjector.from_config(cfg).spec
        want = jfault.FaultInjector.from_config(cfg).spec
        assert vars(got) == vars(want), name
    inj = faultinject.FaultInjector.from_config(
        FaultInjectConfig(enabled=True, seed=4, drop_pct=0.25, flood_rooms=[1]))
    assert inj.spec.drop_pct == 0.25 and inj.spec.flood_rooms == (1,)


async def test_faulted_traffic_drains_like_reference():
    """Seeded drop / delay / duplicate over 12 ticks of two rooms' audio
    and video: both packages stage the same tensors each tick, delayed
    packets re-entering at their release tick."""
    ref, port = _pair()
    spec = dict(seed=21, drop_pct=0.1, delay_pct=0.2, dup_pct=0.1, delay_ticks=2)
    ref.ingest.fault = jfault.FaultInjector(jfault.FaultSpec(**spec))
    port.ingest.fault = faultinject.FaultInjector(faultinject.FaultSpec(**spec))
    rng = np.random.default_rng(3)
    for tick in range(12):
        arrivals = [(int(r), int(t)) for r, t in zip(rng.integers(0, 2, 6),
                                                     rng.choice([0, 1, 2], 6))]
        for rt, packet_cls in ((ref, JaxPacket), (port, PacketIn)):
            for i, (room, track) in enumerate(arrivals):
                rt.ingest.push(packet_cls(room=room, track=track, sn=tick * 10 + i,
                                          ts=tick * 960, size=20 + i, payload=bytes([i])))
        want, _ = ref.ingest.drain(tick_index=tick)
        got, _ = port.ingest.drain(tick_index=tick)
        for name in ("sn", "ts", "size", "valid"):
            assert np.array_equal(getattr(got, name), np.asarray(getattr(want, name))), (
                tick, name)
    a, b = ref.ingest, port.ingest
    assert (b.dropped_fault, b.dupes, int(b.rx_pkts.sum())) == (
        a.dropped_fault, a.dupes, int(a.rx_pkts.sum()))
    assert vars(port.ingest.fault.stats).items() <= vars(ref.ingest.fault.stats).items()
    assert b.fault.stats.delayed > 0 and b.fault.stats.dropped > 0
