"""Parity of the port's congestion control and its neighbours (loss- and
delay-based BWE, pacer, RED planning, connection quality) with the JAX
reference over seeded multi-tick sequences. Tolerances as stated in
test_torch_ops.py: integers and bools exact, floats within
rtol=atol=1e-6."""

import functools

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.ops import (  # noqa: E402
    bwe as jbwe,
    pacer as jpacer,
    quality as jquality,
    red as jred,
)
from livekit_server_tpu_torch.ops import (  # noqa: E402
    bwe as tbwe,
    pacer as tpacer,
    quality as tquality,
    red as tred,
)
from tests.test_torch_ops import assert_tree_match, both  # noqa: E402


def test_bwe_loss_and_trend():
    """Estimate ring + trend, NACK-ratio congestion, stale-sample expiry
    and committed-capacity hold over a falling then recovering channel."""
    rng = np.random.default_rng(7)
    S = 10
    j_update = jax.jit(functools.partial(jbwe.update_tick, params=jbwe.BWEParams()))
    j_state, t_state = jbwe.init_state(S), tbwe.init_state(S, device="cpu")
    for i in range(80):
        base = 3e6 if i < 30 else (1e6 if i < 55 else 4e6)
        est = (base * rng.normal(1.0, 0.05, S)).astype(np.float32)
        valid = rng.random(S) < (0.9 if i < 25 else 0.0)
        sent = rng.integers(0, 30, S).astype(np.float32)
        nacks = (sent * rng.random(S) * (0.3 if 20 < i < 40 else 0.02)).astype(np.float32)
        j, t = both(est, valid, sent, nacks)
        jr = j_update(j_state, estimate=j[0], estimate_valid=j[1], pkts_sent=j[2],
                      nacks=j[3])
        tr = tbwe.update_tick(t_state, tbwe.BWEParams(), *t)
        assert_tree_match(tr, jr)
        j_state, t_state = jr[0], tr[0]


def test_bwe_delay_estimator():
    """Overuse/underuse AIMD, silent-client starvation decay and the
    active latch of the TWCC delay estimator."""
    rng = np.random.default_rng(8)
    S = 10
    j_state, t_state = jbwe.delay_init_state(S), tbwe.delay_init_state(S, device="cpu")
    j_update = jax.jit(functools.partial(jbwe.delay_update_tick,
                                         params=jbwe.DelayBWEParams()))
    enabled = rng.random(S) < 0.7
    for i in range(90):
        delay = rng.normal(2.0 if 20 < i < 40 else -0.5, 1.0, S).astype(np.float32)
        recv = rng.uniform(5e5, 5e6, S).astype(np.float32)
        valid = rng.random(S) < (0.6 if i < 30 else 0.0)
        sent = rng.integers(0, 5, S).astype(np.float32)
        j, t = both(delay, recv, valid, enabled, sent, np.int32(10))
        jr = j_update(j_state, fb_delay_ms=j[0], fb_recv_bps=j[1], fb_valid=j[2],
                      fb_enabled=j[3], pkts_sent=j[4], tick_ms=j[5])
        tr = tbwe.delay_update_tick(t_state, tbwe.DelayBWEParams(), *t)
        assert_tree_match(tr, jr)
        j_state, t_state = jr[0], tr[0]


def test_pacer_bucket():
    rng = np.random.default_rng(9)
    S = 10
    j_state, t_state = jpacer.init_state(S), tpacer.init_state(S, device="cpu")
    # Eager on the JAX side: a jitted XLA fuses the bucket's multiply-adds
    # into FMA, and the cancellation in tokens - allowed then turns that
    # ulp into ~5e-4 bytes on ~1e4-byte buckets.
    for i in range(40):
        enq = rng.integers(0, 40000, S).astype(np.float32)
        rate = rng.uniform(3e4, 8e6, S).astype(np.float32)
        j, t = both(enq, rate, np.int32(10))
        jr = jpacer.update_tick(j_state, jpacer.PacerParams(), *j)
        tr = tpacer.update_tick(t_state, tpacer.PacerParams(), *t)
        assert_tree_match(tr, jr)
        j_state, t_state = jr[0], tr[0]


def test_red_encode_plan():
    """Candidates from this tick and from history, TS-offset and
    block-length limits, SN adjacency, across ticks."""
    rng = np.random.default_rng(10)
    T, K = 5, 6
    j_state, t_state = jred.init_state(T), tred.init_state(T, device="cpu")
    j_update = jax.jit(jred.encode_plan_tick)
    sn0 = rng.integers(0, 1 << 16, T)
    for i in range(8):
        valid = rng.random((T, K)) < 0.7
        sn = ((sn0[:, None] + i * K + np.arange(K)) & 0xFFFF).astype(np.int32)
        ts = (sn.astype(np.int64) * rng.choice([960, 20000], (T, 1))).astype(np.int32)
        length = rng.integers(60, 1200, (T, K)).astype(np.int32)
        j, t = both(sn, ts, length, valid)
        jr = j_update(j_state, *j)
        tr = tred.encode_plan_tick(t_state, *t)
        assert_tree_match(tr, jr)
        j_state, t_state = jr[0], tr[0]


def test_quality_scoring():
    rng = np.random.default_rng(11)
    n = 200
    loss = rng.uniform(0, 40, n).astype(np.float32)
    rtt = rng.uniform(0, 600, n).astype(np.float32)
    jit = rng.uniform(0, 80, n).astype(np.float32)
    has = rng.random(n) < 0.9
    defc = rng.random(n) < 0.3
    j, t = both(loss, rtt, jit, has, defc)
    assert_tree_match(tquality.connection_quality(*t), jquality.connection_quality(*j))
    assert_tree_match(tquality.r_factor(t[0], t[1], t[2], t[4]),
                      jquality.r_factor(j[0], j[1], j[2], j[4]))
    q = rng.integers(0, 4, (20, 6)).astype(np.int32)
    mask = rng.random((20, 6)) < 0.6
    jq, tq = both(q, mask)
    assert_tree_match(tquality.aggregate_min(*tq), jquality.aggregate_min(*jq))
