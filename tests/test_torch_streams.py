"""Parity of the port's per-stream state (rtpstats, streamtracker, audio
levels and speaker ranking) with the JAX reference over seeded multi-tick
sequences. Tolerances as stated in test_torch_ops.py: integers and bools
exact, floats within rtol=atol=1e-6."""

import functools

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.ops import (  # noqa: E402
    audio as jaudio,
    rtpstats as jrtp,
    streamtracker as jtrk,
)
from livekit_server_tpu_torch.ops import (  # noqa: E402
    audio as taudio,
    rtpstats as trtp,
    streamtracker as tstrk,
)
from tests.test_torch_ops import assert_tree_match, both  # noqa: E402


def _stream_ticks(rng, N, K, ticks):
    sn0 = rng.integers(0, 1 << 16, N)
    ts0 = rng.integers(0, 1 << 32, N, dtype=np.int64)
    for i in range(ticks):
        order = np.sort(rng.integers(0, 3 * K, (N, K)), axis=1)
        order[:, ::3] = rng.integers(0, 3 * K, (N, (K + 2) // 3))   # reorders / dups
        sn = ((sn0[:, None] + i * 3 * K + order) & 0xFFFF).astype(np.int32)
        ts = ((ts0[:, None] + (i * 3 * K + order) * 960) & 0xFFFFFFFF).astype(np.int64)
        arr = (ts + rng.integers(0, 3000, (N, K))) & 0xFFFFFFFF
        yield (sn, ts.astype(np.uint32).view(np.int32),
               rng.integers(40, 1300, (N, K)).astype(np.int32),
               arr.astype(np.uint32).view(np.int32), rng.random((N, K)) < 0.85)


def test_rtpstats_update_and_report():
    """SN wrap, reordering and duplicates over several ticks, then a
    receiver report (jitter, loss fraction, extended SN)."""
    rng = np.random.default_rng(3)
    N, K = 12, 6
    j_state = jrtp.init_state(N)
    j_update = jax.jit(jrtp.update_tick)
    t_state = trtp.init_state(N, device="cpu")
    for fields in _stream_ticks(rng, N, K, 6):
        j, t = both(*fields)
        j_state = j_update(j_state, *j[:4], j[4])
        t_state = trtp.update_tick(t_state, *t[:4], t[4])
        assert_tree_match(t_state, j_state)
    assert_tree_match(trtp.receiver_report(t_state), jrtp.receiver_report(j_state))
    assert_tree_match(trtp.cumulative_lost(t_state), jrtp.cumulative_lost(j_state))


def test_streamtracker_cycles():
    """LIVE/STOPPED transitions, bitrate and fps EMAs across cycles,
    including a silent stream going STOPPED."""
    rng = np.random.default_rng(4)
    N = 9
    j_state, t_state = jtrk.init_state(N), tstrk.init_state(N, device="cpu")
    j_update = jax.jit(functools.partial(jtrk.update_tick, params=jtrk.TrackerParams()))
    for i in range(60):
        pkts = rng.integers(0, 4, N).astype(np.int32)
        pkts[:3] = 0 if i > 20 else pkts[:3]
        byts = (pkts * rng.integers(200, 1200, N)).astype(np.int32)
        frames = rng.integers(0, 2, N).astype(np.int32)
        j, t = both(pkts, byts, frames, np.int32(50))
        jr = j_update(j_state, pkts=j[0], byts=j[1], tick_ms=j[3], frames=j[2])
        tr = tstrk.update_tick(t_state, tstrk.TrackerParams(), t[0], t[1], t[3],
                               frames=t[2])
        assert_tree_match(tr, jr)
        j_state, t_state = jr[0], tr[0]


def test_audio_observe_windows():
    """Window accumulation, seeding after silence and EMA smoothing."""
    rng = np.random.default_rng(5)
    T, P = 6, 4
    j_state, t_state = jaudio.init_state(T), taudio.init_state(T, device="cpu")
    j_update = jax.jit(functools.partial(jaudio.observe_tick, params=jaudio.AudioLevelParams()))
    for i in range(50):
        levels = rng.integers(0, 128, (T, P)).astype(np.int32)
        levels[0] = 20 + (i // 13) * 30
        frame_ms = np.full((T, P), 20, np.int32)
        valid = rng.random((T, P)) < 0.8
        j, t = both(levels, frame_ms, valid, np.int32(50))
        jr = j_update(j_state, levels=j[0], frame_ms=j[1], valid=j[2], tick_ms=j[3])
        tr = taudio.observe_tick(t_state, taudio.AudioLevelParams(), *t)
        assert_tree_match(tr, jr)
        j_state, t_state = jr[0], tr[0]


def test_level_to_linear():
    x = np.linspace(0.0, 127.0, 301).astype(np.float32)
    j, t = both(x)
    assert_tree_match(taudio.level_to_linear(t[0]), jaudio.level_to_linear(j[0]))


@pytest.mark.parametrize("case", ["ties_at_zero", "all_tied", "distinct"])
def test_top_speakers_tie_rule(case):
    """Ties keep the lower track index first, as jax.lax.top_k does."""
    rng = np.random.default_rng(6)
    lv = np.zeros((5, 8), np.float32)
    if case == "ties_at_zero":
        lv[:, 3] = 0.5
        lv[2, 6] = 0.5
    elif case == "all_tied":
        lv[:] = 0.25
    else:
        lv = rng.random((5, 8)).astype(np.float32)
    j, t = both(lv)
    for k in (1, 3, 8):
        assert_tree_match(taudio.top_speakers(t[0], k), jaudio.top_speakers(j[0], k))
