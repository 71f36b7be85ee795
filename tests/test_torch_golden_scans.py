"""The port's golden scans (ops/rtpmunger.py, ops/vp8.py, ops/svc.py
`dd_select_tick`) against the JAX package's, and the port's host munger
held to the port's scans.

Seeded numpy inputs go through both packages' functions for several
ticks, the state carried from tick to tick: packet numbers near the
16-bit SN, 15-bit picture-id and 8-bit TL0PICIDX wraps, dropped packets
(gap compaction), source switches with and without the common-timeline
flag, timeline shears past REANCHOR_TS_THRESH, padding runs, and, for
the dependency-descriptor selector, target changes, pauses, switch
indications and frame-number gaps (chain breaks). Every output and state
leaf is an integer or a bool and must be bit-equal.

The host munger (runtime/munge.py) is then held to the port's scans as
tests/test_host_munge.py holds the reference's to the reference's: the
lane walk (`apply_lanes`, the plain path of the batched fan-out), the
express lane's `apply_arrivals` and `padding`, over randomized
multi-tick (room, track) planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu.ops import rtpmunger as jmunger  # noqa: E402
from livekit_server_tpu.ops import svc as jsvc  # noqa: E402
from livekit_server_tpu.ops import vp8 as jvp8  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.ops import rtpmunger, svc, vp8  # noqa: E402
from livekit_server_tpu_torch.runtime.munge import HostMunger  # noqa: E402

P, S, TICKS = 6, 5, 8


def i32(x) -> np.ndarray:
    """Unsigned values (uint16/uint32 numbers) as their int32 bit pattern."""
    return np.asarray(x, np.int64).astype(np.uint32).view(np.int32)


def tt(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_equal_tree(port, ref, what: str) -> None:
    for name, a, b in zip(port._fields, port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{what}.{name}")


def random_munger_state(rng, lead=()):
    shape = lead + (S,)
    return (i32(rng.integers(0, 1 << 16, shape)), i32(rng.integers(0, 1 << 32, shape)),
            i32(rng.integers(0, 1 << 16, shape)), i32(rng.integers(0, 1 << 32, shape)),
            rng.random(shape) < 0.6, rng.random(shape) < 0.5)


def random_munge_tick(rng, tick: int, lead=()):
    """One tick of packets: SNs climbing through the 16-bit wrap, TS with
    occasional shears, drops, switches, aligned and unaligned jumps."""
    shape = lead + (P,)
    sn = (65530 + tick * P + np.arange(P) + rng.integers(0, 3, shape)) & 0xFFFF
    ts = rng.integers(0, 1 << 32, lead + (1,)) + 3000 * np.arange(P)
    ts = np.where(rng.random(shape) < 0.15, ts + 2_000_000, ts)     # shear
    valid = rng.random(shape) < 0.9
    fwd = rng.random(shape + (S,)) < 0.6
    drop = (rng.random(shape + (S,)) < 0.3) & ~fwd
    switch = (rng.random(shape + (S,)) < 0.2) & fwd
    jump = np.where(rng.random(shape) < 0.4, -1, rng.integers(0, 9000, shape))
    return i32(sn), i32(ts), valid, fwd, drop, switch, i32(jump)


def test_munge_tick_bit_equal_to_reference():
    rng = np.random.default_rng(1)
    state0 = random_munger_state(rng)
    jstate = jmunger.MungerState(*(jnp.asarray(x) for x in state0))
    tstate = rtpmunger.MungerState(*(tt(x) for x in state0))
    jtick = jax.jit(jmunger.munge_tick)
    for tick in range(TICKS):
        args = random_munge_tick(rng, tick)
        jstate, j_sn, j_ts, j_send = jtick(jstate, *args)
        tstate, t_sn, t_ts, t_send = rtpmunger.munge_tick(tstate, *(tt(a) for a in args))
        for name, a, b in (("out_sn", t_sn, j_sn), ("out_ts", t_ts, j_ts),
                           ("send", t_send, j_send)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{tick} {name}")
        assert_equal_tree(tstate, jstate, f"tick {tick} state")
    assert (np.asarray(jstate.sn_offset) > 0).any() and tstate.started.any()


def test_munge_tick_wraps_sn_space_and_compacts_gaps():
    """The reference's hand cases in one run: identity through the 2^16
    wrap, a drop compacting the next SN, a switch continuing at last + 1."""
    st = rtpmunger.init_state(1, device="cpu")
    ones = lambda n: torch.ones((n, 1), dtype=torch.bool)  # noqa: E731
    zeros = lambda n: torch.zeros((n, 1), dtype=torch.bool)  # noqa: E731
    st, sn, _, _ = rtpmunger.munge_tick(
        st, torch.tensor([65534, 65535, 0, 1], dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
        ones(4), zeros(4), zeros(4), torch.zeros(4, dtype=torch.int32))
    assert sn[:, 0].tolist() == [65534, 65535, 0, 1] and int(st.last_sn[0]) == 1
    st, sn, _, send = rtpmunger.munge_tick(
        st, torch.tensor([2, 3, 4], dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
        torch.ones(3, dtype=torch.bool), torch.tensor([[1], [0], [1]]).bool(),
        torch.tensor([[0], [1], [0]]).bool(), zeros(3), torch.zeros(3, dtype=torch.int32))
    assert sn[send].tolist() == [2, 3] and int(st.sn_offset[0]) == 1
    st, sn, ts, _ = rtpmunger.munge_tick(
        st, torch.tensor([9000], dtype=torch.int32), torch.tensor([5000], dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), ones(1), zeros(1), ones(1),
        torch.tensor([3000], dtype=torch.int32))
    assert int(sn[0, 0]) == 4 and int(ts[0, 0]) == 3000


def test_padding_tick_bit_equal_to_reference():
    rng = np.random.default_rng(2)
    state0 = random_munger_state(rng)
    jstate = jmunger.MungerState(*(jnp.asarray(x) for x in state0))
    tstate = rtpmunger.MungerState(*(tt(x) for x in state0))
    for _ in range(3):
        num = rng.integers(0, 5, S).astype(np.int32)
        adv = rng.integers(0, 1 << 31, S).astype(np.int32)
        jstate, j_sn, j_ts, j_valid = jmunger.padding_tick(jstate, jnp.asarray(num), 4,
                                                           jnp.asarray(adv))
        tstate, t_sn, t_ts, t_valid = rtpmunger.padding_tick(tstate, tt(num), 4, tt(adv))
        for a, b in ((t_sn, j_sn), (t_ts, j_ts), (t_valid, j_valid)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_equal_tree(tstate, jstate, "padding state")


def test_vp8_munge_tick_bit_equal_to_reference():
    """Picture ids climb through the 15-bit wrap, TL0PICIDX through the
    8-bit one, KEYIDX through 5 bits; dropped pictures and switches."""
    rng = np.random.default_rng(3)
    z = lambda hi: rng.integers(0, hi, S).astype(np.int32)  # noqa: E731
    state0 = (z(1 << 15), z(256), z(32), z(1 << 15), z(256), z(32), rng.random(S) < 0.5)
    jstate = jvp8.VP8State(*(jnp.asarray(x) for x in state0))
    tstate = vp8.VP8State(*(tt(x) for x in state0))
    jtick = jax.jit(jvp8.munge_tick)
    for tick in range(TICKS):
        pid = ((32760 + tick * P + np.arange(P)) & 0x7FFF).astype(np.int32)
        tl0 = ((250 + tick + np.arange(P) // 2) & 0xFF).astype(np.int32)
        ki = ((28 + tick) & 0x1F) * np.ones(P, np.int32)
        begin = rng.random(P) < 0.5
        valid = rng.random(P) < 0.9
        fwd = rng.random((P, S)) < 0.6
        drop = (rng.random((P, S)) < 0.3) & ~fwd
        switch = (rng.random((P, S)) < 0.2) & fwd
        args = (pid, tl0, ki, begin, valid, fwd, drop, switch)
        jstate, *jout = jtick(jstate, *args)
        tstate, *tout = vp8.munge_tick(tstate, *(tt(a) for a in args))
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"tick {tick}")
        assert_equal_tree(tstate, jstate, f"tick {tick} vp8 state")
    a, b = np.array([5, 32765], np.int32), np.array([32760, 10], np.int32)
    for f, jf in ((vp8.sub15, jvp8.sub15), (vp8.add15, jvp8.add15), (vp8.diff15, jvp8.diff15)):
        np.testing.assert_array_equal(f(tt(a), tt(b)).numpy(), np.asarray(jf(a, b)))


def test_dd_select_tick_bit_equal_to_reference():
    """Decode-target selection: switches at indications and keyframes,
    pauses (target -1), target changes by set_target and frame gaps that
    break the chain."""
    rng = np.random.default_rng(4)
    jstate = jsvc.init_dd_state(S, target_dt=2)
    tstate = svc.init_dd_state(S, target_dt=2, device="cpu")
    jtick = jax.jit(jsvc.dd_select_tick)
    frame = 0
    breaks = 0
    for tick in range(TICKS):
        if tick in (3, 6):
            target = rng.integers(-1, 4, S).astype(np.int32)
            jstate = jsvc.set_target(jstate, jnp.asarray(target))
            tstate = svc.set_target(tstate, tt(target))
        dti = rng.integers(0, 16, P).astype(np.int32)
        sw = rng.integers(0, 16, P).astype(np.int32)
        frames = frame + np.cumsum(rng.integers(1, 3, P)).astype(np.int32)
        frame = int(frames[-1])
        kf = rng.random(P) < 0.1
        valid = rng.random(P) < 0.9
        args = (dti, sw, frames, kf, valid)
        jstate, *jout = jtick(jstate, *args)
        tstate, *tout = svc.dd_select_tick(tstate, *(tt(a) for a in args))
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"tick {tick}")
        assert_equal_tree(tstate, jstate, f"tick {tick} dd state")
        breaks += int(tout[-1].sum())
    assert breaks > 0, "no chain break exercised"


def random_plane_tick(rng, R, T, K, S_):
    sn = rng.integers(0, 1 << 16, (R, T, K))
    ts = rng.integers(0, 1 << 32, (R, T, K))
    pid = rng.integers(0, 1 << 15, (R, T, K))
    tl0 = rng.integers(0, 256, (R, T, K))
    ki = rng.integers(0, 32, (R, T, K))
    begin = rng.random((R, T, K)) < 0.5
    valid = rng.random((R, T, K)) < 0.85
    jump = np.where(rng.random((R, T, K)) < 0.3, -1, 3000)
    fwd = rng.random((R, T, K, S_)) < 0.6
    drop = (rng.random((R, T, K, S_)) < 0.2) & ~fwd
    switch = (rng.random((R, T, K, S_)) < 0.15) & fwd
    return sn, ts, jump, pid, tl0, ki, begin, valid, fwd, drop, switch


def scan_plane(mstate, vstate, tick):
    """One tick through the port's scans over leading (room, track) axes."""
    sn, ts, jump, pid, tl0, ki, begin, valid, fwd, drop, switch = tick
    mstate, o_sn, o_ts, send = rtpmunger.munge_tick(
        mstate, tt(i32(sn)), tt(i32(ts)), tt(valid), tt(fwd), tt(drop), tt(switch),
        tt(i32(jump)))
    vstate, o_pid, o_tl0, o_ki = vp8.munge_tick(
        vstate, tt(i32(pid)), tt(i32(tl0)), tt(i32(ki)), tt(begin), tt(valid), tt(fwd),
        tt(drop), tt(switch))
    outs = (send.numpy(), o_sn.numpy().astype(np.int64) & 0xFFFF,
            o_ts.numpy().astype(np.int64) & 0xFFFFFFFF, o_pid.numpy() & 0x7FFF,
            o_tl0.numpy() & 0xFF, o_ki.numpy() & 0x1F)
    return mstate, vstate, outs


def plane_states(R, T, S_):
    tile = lambda st: type(st)(*(x.expand(R, T, S_).clone() for x in st))  # noqa: E731
    return (tile(rtpmunger.init_state(S_, device="cpu")),
            tile(vp8.init_state(S_, device="cpu")))


def assert_host_state(host, mstate, vstate):
    u = lambda x, m: x.numpy().astype(np.int64) & m  # noqa: E731
    for name, ref in (("sn_offset", u(mstate.sn_offset, 0xFFFF)),
                      ("ts_offset", u(mstate.ts_offset, 0xFFFFFFFF)),
                      ("last_sn", u(mstate.last_sn, 0xFFFF)),
                      ("last_ts", u(mstate.last_ts, 0xFFFFFFFF)),
                      ("started", mstate.started.numpy()),
                      ("aligned", mstate.ts_anchor_aligned.numpy()),
                      ("pid_offset", u(vstate.pid_offset, 0x7FFF)),
                      ("tl0_offset", u(vstate.tl0_offset, 0xFF)),
                      ("ki_offset", u(vstate.keyidx_offset, 0x1F)),
                      ("last_pid", u(vstate.last_pid, 0x7FFF)),
                      ("last_tl0", u(vstate.last_tl0, 0xFF)),
                      ("last_ki", u(vstate.last_keyidx, 0x1F)),
                      ("v_started", vstate.started.numpy())):
        np.testing.assert_array_equal(getattr(host, name), ref, err_msg=name)


def test_host_munger_lane_walk_matches_port_scans():
    """The batched fan-out's plain walk over every (room, track, sub) lane
    equals the scans, outputs and state, over six random ticks."""
    R, T, K, S_ = 2, 3, 4, 5
    rng = np.random.default_rng(42)
    host = HostMunger(plane.PlaneDims(R, T, K, S_))
    mstate, vstate = plane_states(R, T, S_)
    rr, tt_, ss = (a.reshape(-1) for a in np.meshgrid(
        np.arange(R), np.arange(T), np.arange(S_), indexing="ij"))
    for _ in range(6):
        tick = random_plane_tick(rng, R, T, K, S_)
        mstate, vstate, (send, r_sn, r_ts, r_pid, r_tl0, r_ki) = scan_plane(mstate, vstate, tick)
        sn, ts, jump, pid, tl0, ki, begin, valid, fwd, drop, switch = tick
        lane = lambda m: m[rr, tt_, :, ss]  # noqa: E731  [N, K]
        outs = host.apply_lanes(rr, tt_, ss, sn, ts, jump, pid, tl0, ki, begin, valid,
                                lane(fwd), lane(drop), lane(switch))
        send_l = lane(send)
        assert (send_l == (lane(fwd) & valid[rr, tt_])).all()
        for h, r in zip(outs, (r_sn, r_ts, r_pid, r_tl0, r_ki)):
            np.testing.assert_array_equal(h[send_l], lane(r)[send_l])
    assert_host_state(host, mstate, vstate)


def test_host_munger_apply_arrivals_matches_port_scans():
    """The express lane's walk over gathered (room, track) lanes, one
    receive batch at a time, equals the scans on the same packets."""
    R, T, S_ = 3, 2, 4
    rng = np.random.default_rng(7)
    host = HostMunger(plane.PlaneDims(R, T, 4, S_))
    mstate, vstate = plane_states(R, T, S_)
    for _ in range(5):
        Kb = int(rng.integers(1, 4))
        tick = random_plane_tick(rng, R, T, Kb, S_)
        mstate, vstate, (send, r_sn, r_ts, r_pid, r_tl0, r_ki) = scan_plane(mstate, vstate, tick)
        sn, ts, jump, pid, tl0, ki, begin, valid, fwd, drop, switch = tick
        gr, gt = (a.reshape(-1) for a in np.meshgrid(np.arange(R), np.arange(T), indexing="ij"))
        g = lambda a: a[gr, gt]  # noqa: E731
        outs = host.apply_arrivals(gr, gt, g(sn), g(ts), g(jump), g(pid), g(tl0), g(ki),
                                   g(begin), g(valid), g(fwd), g(drop), g(switch))
        sent = g(send)
        for h, r in zip(outs, (r_sn, r_ts, r_pid, r_tl0, r_ki)):
            np.testing.assert_array_equal(h[sent], g(r)[sent])
            assert not h[~sent].any()
    assert_host_state(host, mstate, vstate)


def test_host_padding_matches_port_padding_tick():
    R, T, K, S_ = 1, 2, 3, 4
    rng = np.random.default_rng(9)
    host = HostMunger(plane.PlaneDims(R, T, K, S_))
    mstate, vstate = plane_states(R, T, S_)
    tick = list(random_plane_tick(rng, R, T, K, S_))
    tick[7] = np.ones_like(tick[7])        # every packet valid and forwarded
    tick[8] = np.ones_like(tick[8])
    tick[9] = np.zeros_like(tick[9])
    tick[10] = np.zeros_like(tick[10])
    mstate, vstate, _ = scan_plane(mstate, vstate, tick)
    rr, tt_, ss = (a.reshape(-1) for a in np.meshgrid(
        np.arange(R), np.arange(T), np.arange(S_), indexing="ij"))
    lane = lambda m: m[rr, tt_, :, ss]  # noqa: E731
    host.apply_lanes(rr, tt_, ss, *tick[:8], lane(tick[8]), lane(tick[9]), lane(tick[10]))
    pad_num = np.zeros((R, S_), np.int32)
    pad_track = np.full((R, S_), -1, np.int32)
    pad_num[0, 1], pad_track[0, 1] = 3, 1
    pads = host.padding(pad_num, pad_track, ts_advance=900)
    num = torch.zeros((R, T, S_), dtype=torch.int32)
    num[0, 1, 1] = 3
    mstate, pad_sn, pad_ts, valid = rtpmunger.padding_tick(
        mstate, num, 4, torch.full((R, T, S_), 900, dtype=torch.int32))
    v = valid[0, 1, :, 1]
    assert [p[3] for p in pads] == pad_sn[0, 1, :, 1][v].tolist()
    assert [p[4] for p in pads] == (pad_ts[0, 1, :, 1][v].numpy().astype(np.int64)
                                    & 0xFFFFFFFF).tolist()
    assert_host_state(host, mstate, vstate)
