"""The port's PlaneRuntime (livekit_server_tpu_torch, device="cpu") against
the JAX PlaneRuntime: the same packets pushed through IngestBuffer.push
for several ticks must give the same egress columns (rooms, tracks, subs,
sn, ts, pid, tl0, keyidx) and the same per-tick signals."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import PlaneRuntime as JaxRuntime  # noqa: E402
from livekit_server_tpu.runtime.ingest import PacketIn as JaxPacket  # noqa: E402
from livekit_server_tpu_torch.models import plane as tplane  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402

DIMS = (2, 4, 6, 5)
COLUMNS = ("rooms", "tracks", "subs", "sn", "ts", "pid", "tl0", "keyidx", "ks")
# (room, track) → (is_video, is_svc, publishing sub)
TRACKS = {(0, 0): (True, False, 0), (0, 1): (False, False, 1),
          (1, 0): (True, True, 2), (1, 1): (False, False, 0),
          (1, 2): (True, False, 3)}


def _setup(rt):
    for (r, t), (video, svc, pub) in TRACKS.items():
        rt.set_track(r, t, published=True, is_video=video, is_svc=svc, pub_sub=pub)
        for s in range(DIMS[3]):
            if s != pub:
                rt.set_subscription(r, t, s, subscribed=True, sub_muted=(r, t, s) == (0, 1, 4))
    rt.set_layer_caps(0, 0, 2, max_spatial=1, max_temporal=1)
    rt.set_layer_caps(1, 0, 3, max_spatial=0)


def _packets(rng, tick):
    """One tick of packets: simulcast layers cycling, SVC layers, audio
    with levels, keyframes at ticks 0 and 8, a reordered and a duplicated
    packet now and then."""
    out = []
    for (r, t), (video, svc, _pub) in TRACKS.items():
        n = 5 if video else 1
        for k in range(n):
            sn = (1000 * (r + 1) + 7 * t + tick * n + k) & 0xFFFF
            layer = k % 3 if video else 0
            out.append(dict(
                room=r, track=t, sn=sn, ts=(90_000 * t + tick * 3000) & 0xFFFFFFFF,
                size=int(rng.integers(60, 1200)), payload=bytes(rng.integers(0, 256, 20, np.uint8)),
                marker=k == n - 1, layer=layer, temporal=k % 2 if video else 0,
                keyframe=video and tick in (0, 8) and k < 3,
                layer_sync=video and k % 2 == 0, begin_pic=k < 3,
                pid=(tick + 40 * t) & 0x7FFF, tl0=tick & 0xFF, keyidx=tick & 0x1F,
                frame_ms=0 if video else 20,
                audio_level=127 if video else int(rng.integers(10, 90)),
                arrival_rtp=(tick * 3000 + int(rng.integers(0, 90))) & 0xFFFFFFFF,
            ))
    if tick % 4 == 2:
        out[0], out[1] = out[1], out[0]
        out.append(dict(out[2]))
    return out


async def test_runtime_egress_matches_reference():
    dims = jplane.PlaneDims(*DIMS)
    ref = JaxRuntime(dims, tick_ms=10)
    port = PlaneRuntime(tplane.PlaneDims(*DIMS), tick_ms=10, device="cpu")
    try:
        _setup(ref)
        _setup(port)
        rng = np.random.default_rng(0)
        sent = 0
        for tick in range(14):
            for pkt in _packets(rng, tick):
                ref.ingest.push(JaxPacket(**pkt))
                port.ingest.push(PacketIn(**pkt))
            for r in range(DIMS[0]):
                for s in range(DIMS[3]):
                    est = 2e6 if tick < 6 else 4e5
                    ref.ingest.push_feedback(r, s, estimate=est, nacks=tick % 3)
                    port.ingest.push_feedback(r, s, estimate=est, nacks=tick % 3)
            want = await ref.step_once()
            got = await port.step_once()
            order_w = np.lexsort([getattr(want.egress_batch, c) for c in COLUMNS[::-1]])
            order_g = np.lexsort([getattr(got.egress_batch, c) for c in COLUMNS[::-1]])
            for col in COLUMNS:
                w = np.asarray(getattr(want.egress_batch, col))[order_w]
                g = np.asarray(getattr(got.egress_batch, col))[order_g]
                assert np.array_equal(g, w), (tick, col)
            assert got.fwd_packets == want.fwd_packets
            assert got.fwd_bytes == want.fwd_bytes
            assert got.need_keyframe == want.need_keyframe
            assert got.congested == want.congested
            assert [p.sn for p in got.padding] == [p.sn for p in want.padding]
            assert got.speakers.keys() == want.speakers.keys()
            sent += len(got.egress_batch)
        assert sent > 0
        # NACK replay resolves from the same host ring on both sides.
        r, s, t = 0, 1, 0
        sns = list(np.asarray(got.egress_batch.sn)[
            (got.egress_batch.rooms == r) & (got.egress_batch.subs == s)
            & (got.egress_batch.tracks == t)])
        assert [p.sn for p in port.resolve_nacks(r, s, t, sns)] == \
            [p.sn for p in ref.resolve_nacks(r, s, t, sns)]
    finally:
        await ref.stop()
